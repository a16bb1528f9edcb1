"""Mixture-of-experts layer (port of ``repro/models/moe.py:41-105``): a
softmax router in f32, top-k, the capacity rule, the routed experts'
gated SiLU MLPs, a shared expert, and the Switch-style auxiliary loss.

The function is the reference's: the same choices (``jax.lax.top_k``'s
order, ties to the lower expert index), the same ranks (a running count
over the flat (token, choice) order of each token group), the same drops
(a pair ranked at ``cap`` or above), the same combine (each pair's output
times its gate value in x's dtype, summed over the k choices). Only its
evaluation differs: the reference scatters the kept pairs into a dense
(E, cap, D) buffer and multiplies every expert over every row of it,
where the port groups the kept pairs by expert and runs each expert that
has rows over those rows alone, every product through
``layers.matmul`` (int8 weight codes reach kernel K7). The buffer is never
built: on qwen2-moe-a2.7b it would be 15 times the routed work and read
all 60 experts' weights every step.

Grouping needs each expert's row count on the host: one device-to-host
read a layer (``STATS["host_syncs"]``). Each pair's output goes to its
own row of a (T·k, D) buffer (dropped pairs stay exact zeros) through a
copy with unique indices, then the k rows of a token are summed: no
atomics, so a run repeats its bits on the card.

On a training mesh (``launch.sharding``) the layer sees only this rank's
rows of the microbatch (``data=``, the sharded train step's data dims):
the token groups of the capacity rule are then each rank's own when their
count is a multiple of the data size, and otherwise the rows of every
data rank are gathered so that the rule runs over the whole microbatch,
as the reference's over its global batch. Either way ``f_e`` and ``p_e``
cover the whole microbatch before the loss's product.
:func:`moe_layer_ep` is the reference's expert-parallel layer: each data
rank routes its own tokens at its own capacity, and the loss is the mean
of the ranks' losses.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantizedTensor
from repro_torch.models.layers import matmul, mlp_layer

# counters over every moe_layer call (set them to 0 before a run and read
# them after): calls, host reads of the per-expert counts, (token, choice)
# pairs routed, pairs dropped by the capacity rule, and experts run (one
# gated MLP over an expert's kept rows: its weights are read)
STATS = dict.fromkeys(("calls", "host_syncs", "pairs", "dropped",
                       "experts"), 0)
# calls under ``uncounted()`` (a block's recompute in the backward pass
# under ``RuntimeOpts.remat``) leave STATS as they are
_UNCOUNTED = [0]


def reset_stats() -> None:
    STATS.update(dict.fromkeys(STATS, 0))


@contextlib.contextmanager
def uncounted():
    """Calls inside this context are not counted in ``STATS``."""
    _UNCOUNTED[0] += 1
    try:
        yield
    finally:
        _UNCOUNTED[0] -= 1


def capacity(tokens: int, spec, capacity_factor: float) -> int:
    """Rows an expert takes from a group of ``tokens`` tokens: all of them
    when ``capacity_factor <= 0`` (dropless), else ``max(1,
    int(tokens·k/E·cf))``, truncated toward zero as the reference's
    ``int()`` does."""
    if capacity_factor <= 0:
        return tokens
    return max(1, int(tokens * spec.top_k / spec.num_experts
                      * capacity_factor))


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by the lower index first (a stable
    sort; ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def expert_weight(w, i: int, num_experts: int):
    """Expert ``i``'s (d_in, d_out) matrix of a block's stacked expert
    weight: a dense (E, d_in, d_out) tensor's slice, or rows ``i·d_in`` to
    ``(i + 1)·d_in`` of a :class:`QuantizedTensor` holding (E·d_in, d_out)
    codes with one scale row shared by every expert (the split edge's
    layout, ``split_engine.quantize_front_blocks``): a contiguous view of
    the codes and the whole scale row, no copy."""
    if not isinstance(w, QuantizedTensor):
        return w[i]
    rows = w.codes.shape[0] // num_experts
    codes = w.codes[i * rows:(i + 1) * rows]
    return QuantizedTensor(codes, w.scale, w.bits, tuple(codes.shape))


def _groups(groups: int, t: int) -> int:
    """The reference's token groups for ``t`` tokens: at most ``t``, and
    1 when they do not divide ``t``."""
    groups = max(1, min(groups, t))
    return 1 if t % groups else groups


def _routed(params, xt: torch.Tensor, spec, capacity_factor: float,
            groups: int):
    """The routed experts over xt (T, D) in ``groups`` groups of
    consecutive tokens: (y (T, D) without the shared expert, f_e (E,),
    p_e (E,)), the loss's terms averaged over the groups."""
    t, d = xt.shape
    e, k = spec.num_experts, spec.top_k
    tg = t // groups
    cap = capacity(tg, spec, capacity_factor)

    logits = matmul(xt.float(), params["w_router"])  # (T, E) f32
    probs = torch.softmax(logits, dim=-1)
    gate, sel = top_k(probs, k)
    if spec.renormalize:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # rank of each (token, choice) pair within its expert, in the flat
    # order of its group
    oh = F.one_hot(sel.reshape(groups, tg * k), e)  # (groups, tg·k, E)
    ranks = ((torch.cumsum(oh, dim=1) * oh).sum(-1) - 1).reshape(-1)
    sel_flat = sel.reshape(-1)
    # kept pairs sorted by expert (stable: flat order within an expert);
    # a dropped pair's key E sorts it past every kept one
    key = torch.where(ranks < cap, sel_flat, torch.full_like(sel_flat, e))
    counts = torch.bincount(key, minlength=e + 1).tolist()  # host read
    order = torch.sort(key, stable=True).indices
    kept = t * k - counts[e]

    y = torch.zeros((t * k, d), dtype=xt.dtype, device=xt.device)
    if kept:
        pairs = order[:kept]
        rows = xt.index_select(0, pairs // k)
        out = torch.empty((kept, d), dtype=xt.dtype, device=xt.device)
        start = 0
        for i, n in enumerate(counts[:e]):
            if not n:
                continue
            w = {name: expert_weight(params[name], i, e)
                 for name in ("w_gate", "w_up", "w_down")}
            out[start:start + n] = mlp_layer(w, rows[start:start + n],
                                             "silu")
            start += n
        g = gate.reshape(-1).index_select(0, pairs).to(xt.dtype)
        y.index_copy_(0, pairs, out * g[:, None])
    y = y.reshape(t, k, d).sum(dim=1)

    f_e = F.one_hot(sel, e).sum(1).float().reshape(groups, tg, e).mean(1)
    p_e = probs.reshape(groups, tg, e).mean(1)
    if groups > 1:
        f_e, p_e = f_e.mean(0), p_e.mean(0)
    else:
        f_e, p_e = f_e[0], p_e[0]

    if not _UNCOUNTED[0]:
        STATS["calls"] += 1
        STATS["host_syncs"] += 1
        STATS["pairs"] += t * k
        STATS["dropped"] += t * k - kept
        STATS["experts"] += sum(1 for n in counts[:e] if n)
    return y, f_e, p_e


def _aux(f_e, p_e, spec) -> torch.Tensor:
    """The Switch-style load-balance loss, ``E · Σ f_e p_e / k``."""
    return spec.num_experts * torch.sum(f_e * p_e) / spec.top_k


def moe_layer(params, x: torch.Tensor, spec, capacity_factor: float = 1.25,
              groups: int = 1, data=None):
    """x (B, S, D) → (out (B, S, D), aux loss, a 0-d f32 tensor), as the
    reference's ``moe_layer``. ``groups`` > 1 applies the capacity rule
    and the loss's means per group of T / groups consecutive tokens (1
    when it does not divide T); every row of x is routed, pad rows too.

    ``data`` (a tuple of ``launch.collectives.Axis``, set by the sharded
    train step through ``forward_train(data=)``) says that x holds only
    this rank's block of rows of a microbatch split over those dims; the
    result is then the rank's rows of the reference's layer over the
    whole microbatch, and its loss the whole microbatch's (the module
    docstring)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    if data:
        from repro_torch.launch.collectives import (block_index, data_mean,
                                                    gather_rows, scale_grad,
                                                    take_block)

        n = block_index(data)[1]
        g = _groups(groups, b * s * n)
        if g % n == 0:  # whole groups on every rank
            y, f_e, p_e = _routed(params, xt, spec, capacity_factor, g // n)
            aux = _aux(data_mean(f_e, data), data_mean(p_e, data), spec)
        else:  # one rule over every rank's rows
            y_all, f_e, p_e = _routed(params, gather_rows(xt, data), spec,
                                      capacity_factor, g)
            y = take_block(y_all, 0, data)
            # each data rank adds the whole loss to its own: its gradient
            # is shared among them
            aux = scale_grad(_aux(f_e, p_e, spec), n)
    else:
        y, f_e, p_e = _routed(params, xt, spec, capacity_factor,
                              _groups(groups, b * s))
        aux = _aux(f_e, p_e, spec)
    if "shared" in params:
        y = y + mlp_layer(params["shared"], xt, "silu")
    return y.reshape(b, s, d), aux


def moe_layer_ep(params, x: torch.Tensor, spec, data_axes: tuple,
                 capacity_factor: float = 1.25, fsdp: bool = True,
                 mesh=None):
    """The reference's expert-parallel layer (``moe_layer_ep``, its
    dispatch inside each data shard under ``shard_map``), one data rank
    a call: x (B / data size, S, D) is this rank's rows of the batch (its
    block over ``data_axes``, dims of ``mesh``). The rank routes its own
    tokens, with its own capacity ``capacity(B / data size · S)``, so
    drops are the rank's own. Returns (this rank's output rows, the mean
    over the data ranks of each rank's own loss): not the grouped
    :func:`moe_layer`'s loss, which averages ``f_e`` and ``p_e`` first.

    Under ``fsdp`` the expert and shared weights are this rank's block
    over ``data_axes`` along D (``w_gate``/``w_up`` dim 1, ``w_down`` dim
    2, the shared expert's dim 0), gathered at use; their gradient, and
    the router's, is summed over the data ranks. ``mesh`` defaults to a
    ``(world, 1)`` training mesh over the default process group, which
    must be initialized (``RuntimeError`` otherwise)."""
    from repro_torch.launch.collectives import data_mean, gather_at_use
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.launch.sharding import mesh_axes

    if mesh is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_available() \
            and dist.is_initialized() else 0
        mesh = make_training_mesh((world, 1))
    axes = mesh_axes(mesh)
    unknown = set(data_axes) - set(axes)
    if unknown:
        raise ValueError(f"data_axes {sorted(unknown)} are not dims of the "
                         f"mesh {tuple(axes)}")
    data = tuple(axes[n] for n in data_axes if axes[n].size > 1)

    def at_use(t, dim=None):
        cuts = ((dim, data, True),) if fsdp and dim is not None and data \
            else ()
        return gather_at_use(t, cuts, data) if data else t

    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    w = {"w_router": at_use(params["w_router"]),
         "w_gate": at_use(params["w_gate"], 1),
         "w_up": at_use(params["w_up"], 1),
         "w_down": at_use(params["w_down"], 2)}
    y, f_e, p_e = _routed(w, xt, spec, capacity_factor, 1)
    if params.get("shared") is not None:
        shared = {k: at_use(v, 0) for k, v in params["shared"].items()}
        y = y + mlp_layer(shared, xt, "silu")
    aux = _aux(f_e, p_e, spec)
    if data:
        aux = data_mean(aux, data)
    return y.reshape(b, s, d), aux
