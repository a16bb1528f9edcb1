"""The FSDP × TP training placement (port of ``repro/launch/sharding.py``):
where each parameter, AdamW moment and batch row of a training mesh
(``launch.mesh.make_training_mesh``) lives, and this rank's blocks.

A placement spec is a tuple with one entry per tensor dim: ``None``
(whole on every rank), a mesh dim's name, or a tuple of the data dims
``("pod", "data")`` taken together (outermost first). The rules are the
reference's, divisibility tests included:

* MoE expert tensors (nb, E, D, F) shard E over ``model`` when the
  layer's ``MoESpec.shard`` is ``"expert"`` and ``model`` divides E, else
  F (the last dim) when it divides; under FSDP dim 2 over the data dims
  when they divide it.
* The embedding, (V, D) or (K, V, D), shards the vocabulary over
  ``model`` and, under FSDP, D over the data dims.
* Every other leaf of two or more dims shards its last dim over
  ``model`` and, under FSDP, its second-to-last over the data dims. The
  (nb, D) norms therefore get their block axis over the data dims when
  they divide nb: the rule as written.
* Leaves of one dim are replicated.

Each rank stores the contiguous block of every leaf at its coordinates
(:func:`shard_tree`); :func:`gather_tree` puts the whole leaves back,
exactly. :class:`TrainPlacement` holds a mesh's rules as one rank
applies them: its blocks of a tree, the gathers at use, the data dims'
sums, and who counts a replicated block once.

The reference's ``cache_specs``, ``to_shaped`` and ``shardings_of``
serve its dry run (ROADMAP queue 1, item 12) and are not carried over.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.launch.collectives import (Axis, gather_at_use,
                                            gather_blocks, sum_over,
                                            take_block)
from repro_torch.launch.mesh import (data_axes, data_size, mesh_sizes,
                                     model_size)
from repro_torch.training.optimizer import AdamWState


def _data_entry(mesh):
    """The data dims as a spec entry: ``"data"``, or ``("pod", "data")``."""
    dax = data_axes(mesh)
    return dax[0] if len(dax) == 1 else dax


def param_specs(cfg: ArchConfig, mesh, fsdp: bool) -> dict:
    """``{key: spec}`` for every key of ``params.param_specs(cfg)`` on
    ``mesh`` (a ``DeviceMesh`` or a ``launch.mesh.AbstractMesh``), by the
    module docstring's rules."""
    from repro_torch.params import param_specs as shapes

    msize, dsize, dax = model_size(mesh), data_size(mesh), _data_entry(mesh)
    expert_shard = {f"p{i}": ls.ffn.shard for i, ls in enumerate(cfg.pattern)
                    if isinstance(ls.ffn, MoESpec)}
    specs = {}
    for name, (shape, _) in shapes(cfg).items():
        nd = len(shape)
        spec = [None] * nd
        if nd == 4 and name.startswith("blocks/"):  # (nb, E, D, F)
            if expert_shard.get(name.split("/")[1]) == "expert" \
                    and shape[1] % msize == 0:
                spec[1] = "model"
            elif shape[3] % msize == 0:
                spec[3] = "model"
            if fsdp and shape[2] % dsize == 0:
                spec[2] = dax
        elif name.startswith("embed"):
            if shape[-2] % msize == 0:
                spec[-2] = "model"
            if fsdp and shape[-1] % dsize == 0:
                spec[-1] = dax
        elif nd >= 2:
            if shape[-1] % msize == 0:
                spec[-1] = "model"
            if fsdp and shape[-2] % dsize == 0:
                spec[-2] = dax
        specs[name] = tuple(spec)
    return specs


def opt_state_specs(param_spec_tree: dict) -> AdamWState:
    """AdamW's moments placed as their parameters; the count replicated."""
    return AdamWState(param_spec_tree, param_spec_tree, ())


def batch_specs(mesh, batch: int):
    """The spec entry of a batch's leading dim: the data dims when they
    divide ``batch``, else ``None`` (every data rank takes every row)."""
    return _data_entry(mesh) if batch % data_size(mesh) == 0 else None


# ------------------------------------------------------------ the blocks


def entry_dims(entry) -> tuple:
    """A spec entry's mesh dims, outermost first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_axes(mesh) -> dict:
    """``{dim name: launch.collectives.Axis}`` of this rank on ``mesh``."""
    return {name: Axis(name, mesh.get_local_rank(name), size,
                       mesh.get_group(name))
            for name, size in mesh_sizes(mesh).items()}


def _cut_dims(spec, axes: dict) -> tuple:
    """``(tensor dim, axes, is_data)`` of each dim a spec cuts over more
    than one rank."""
    out = []
    for dim, entry in enumerate(spec):
        ax = tuple(axes[n] for n in entry_dims(entry) if axes[n].size > 1)
        if ax:
            out.append((dim, ax, "model" not in entry_dims(entry)))
    return tuple(out)


def _map(fn, tree, specs):
    if isinstance(tree, AdamWState):
        if not isinstance(specs, AdamWState):
            specs = opt_state_specs(specs)
        return AdamWState(_map(fn, tree.mu, specs.mu),
                          _map(fn, tree.nu, specs.nu), tree.count)
    return {k: fn(t, specs[k]) for k, t in tree.items()}


def shard_tree(tree, specs, mesh):
    """This rank's contiguous block of every leaf of ``tree`` (a flat
    parameter dict, or an ``AdamWState`` whose moments are placed as the
    parameters of ``specs``): a new tensor where the leaf is cut, so the
    whole leaf can be freed, else the leaf itself."""
    axes = mesh_axes(mesh)

    def cut(t, spec):
        block = t
        for dim, ax, _ in _cut_dims(spec, axes):
            block = take_block(block, dim, ax)
        return t if block is t else block.clone()

    return _map(cut, tree, specs)


def gather_tree(shards, specs, mesh):
    """The whole leaves of :func:`shard_tree`'s blocks, every rank's
    concatenated in place: the same bits as the leaves that were cut."""
    axes = mesh_axes(mesh)

    def whole(t, spec):
        for dim, ax, _ in _cut_dims(spec, axes):
            t = gather_blocks(t, dim, ax)
        return t

    return _map(whole, shards, specs)


class TrainPlacement:
    """A training mesh's rules (FSDP on, as the reference's launcher sets
    them) as one rank applies them.

    ``placement.gather(key, shard, block=None, rows_split=True)`` gives
    the whole leaf (or block ``block`` of a stacked leaf) from this rank's
    block, differentiably: its backward sums over the data dims when the
    data ranks trained on different rows (``rows_split``) and keeps the
    rank's block (``launch.collectives.gather_at_use``). A leaf that is
    whole on this rank and needs no sum is returned itself, so on a mesh
    of one nothing is added to the graph.
    """

    def __init__(self, cfg: ArchConfig, mesh):
        self.mesh = mesh
        self.specs = param_specs(cfg, mesh, fsdp=True)  # as the launcher
        self.axes = mesh_axes(mesh)
        self.data = tuple(self.axes[n] for n in data_axes(mesh)
                          if self.axes[n].size > 1)
        self._cuts = {k: _cut_dims(s, self.axes)
                      for k, s in self.specs.items()}

    def shard(self, tree):
        """This rank's blocks of ``tree``, a flat parameter dict or an
        ``AdamWState`` (:func:`shard_tree` by these rules)."""
        return shard_tree(tree, self.specs, self.mesh)

    def whole(self, tree):
        """The whole leaves of this rank's blocks (:func:`gather_tree`);
        every rank must call."""
        return gather_tree(tree, self.specs, self.mesh)

    def rows_split(self, batch: int) -> bool:
        """Whether the data ranks take their own rows of a microbatch of
        ``batch`` rows (``batch_specs``): else each takes every row."""
        return bool(self.data) and batch_specs(self.mesh, batch) is not None

    def batch_rows(self, t, batch: int):
        """This rank's rows of a microbatch leaf of ``batch`` rows."""
        return take_block(t, 0, self.data) if self.rows_split(batch) else t

    def gather(self, key: str, shard, block: int | None = None,
               rows_split: bool = True):
        cuts = self._cuts[key]
        data = self.data if rows_split else ()
        if block is not None and not (cuts and cuts[0][0] == 0):
            shard, cuts = shard[block], tuple(
                (dim - 1, ax, d) for dim, ax, d in cuts)
            block = None
        if not cuts and not data:
            full = shard
        else:
            full = gather_at_use(shard, cuts, data)
        # a stacked leaf cut along its block axis (the (nb, D) norms):
        # gathered whole, then its block
        return full if block is None else full[block]

    def counts(self, key: str) -> bool:
        """Whether this rank adds ``key``'s block to a sum over every rank:
        only the replica at index 0 of each mesh dim the leaf is not cut
        along does, so each block counts once."""
        used = {n for entry in self.specs[key] for n in entry_dims(entry)}
        return all(ax.index == 0 for n, ax in self.axes.items()
                   if n not in used)

    def sum_all(self, t):
        """``t`` summed over every rank of the mesh."""
        return sum_over(t, [ax for ax in self.axes.values() if ax.size > 1])

    def sum_data(self, t):
        """``t`` summed over the data dims."""
        return sum_over(t, self.data)

    def resident_bytes(self, tree) -> int:
        """Bytes of ``tree``'s tensors on this rank: a dict's, or an
        ``AdamWState``'s two moments (its step count aside)."""
        if isinstance(tree, AdamWState):
            return self.resident_bytes(tree.mu) + self.resident_bytes(tree.nu)
        return sum(t.numel() * t.element_size() for t in tree.values())

    def share_bytes(self, shapes: dict) -> int:
        """The rule's share of ``{key: shape}`` of f32 leaves on this rank:
        each leaf's bytes over the ranks it is cut across."""
        return sum(4 * math.prod(shape) // math.prod(
            a.size for _, ax, _ in self._cuts[k] for a in ax)
            for k, shape in shapes.items())
