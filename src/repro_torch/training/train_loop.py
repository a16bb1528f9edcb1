"""The training loop (port of ``repro/training/train_loop.py``): the loss,
the train step with microbatch accumulation, and a single-device driver.

A step takes the gradients of :func:`loss_fn` through autograd
(``forward_train``, with each block recomputed in the backward pass under
``RuntimeOpts.remat``). With ``accum_steps`` > 1 the batch is cut into
that many microbatches along its first axis, run in order, their gradients
summed into f32 buffers and divided by ``accum_steps``, as are the loss,
the cross entropy and the auxiliary loss; then one AdamW update.

On a training mesh (``make_train_step(mesh=)``, ``launch.sharding``) each
rank stores only its block of every parameter and AdamW moment. The
global batch is cut into microbatches first, as the reference cuts it,
and then each rank takes its rows of each microbatch over the data dims
(all of them when the data size does not divide the microbatch). The
forward gathers each leaf at its use; the backward sums every gradient
over the data dims and keeps the rank's block; the cross entropy divides
by the whole microbatch's mask count, so the summed gradient and the
loss are the reference's; AdamW runs on the blocks, with the gradients'
norm summed over the ranks. On a mesh of one, no collective runs and the
step is the unsharded step's, bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, to_device
from repro_torch.models.transformer import RuntimeOpts, forward_train
from repro_torch.params import init_params
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_init, adamw_update)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  loss_mask: torch.Tensor, placement=None) -> torch.Tensor:
    """Masked next-token cross entropy in f32. On a codebook config the
    labels carry a trailing K axis and the logits are (..., K, V): each
    position's K losses are averaged first.

    With ``placement`` (``launch.sharding.TrainPlacement``) the rows are
    this rank's block of a microbatch split over the data dims: the mask
    count is summed over them, and the result is this rank's share, whose
    sum over the data ranks is the whole microbatch's loss."""
    lp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    while nll.dim() > loss_mask.dim():  # the codebook axis
        nll = nll.mean(dim=-1)
    count = loss_mask.sum()
    if placement is not None:
        count = placement.sum_data(count)
    denom = torch.clamp(count, min=1.0)
    return torch.sum(nll * loss_mask) / denom


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, opts: RuntimeOpts,
            aux_weight: float = 0.01, placement=None, gather=None):
    """(ce + aux_weight · aux, (ce, aux)) of ``batch`` (``tokens``,
    ``labels``, ``loss_mask`` and, on the vision stub, ``patches``).
    ``gather`` feeds ``forward_train``. ``placement`` says that the rows
    are this rank's block of the microbatch over its data dims: the MoE
    layers and ``cross_entropy`` see them so (ce is then this rank's
    share)."""
    logits, aux = forward_train(
        params, cfg, batch["tokens"], batch.get("patches"), opts,
        gather=gather, data=None if placement is None else placement.data)
    ce = cross_entropy(logits, batch["labels"], batch["loss_mask"],
                       placement)
    return ce + aux_weight * aux, (ce, aux)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    accum_steps: int = 1  # microbatches a step
    aux_weight: float = 0.01
    batch_pre_split: bool = False  # batch already (accum, micro, ...)


def _split_microbatches(batch: dict, accum: int) -> dict:
    return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
            for k, v in batch.items() if v is not None}


def make_train_step(cfg: ArchConfig, tc: TrainConfig, opts: RuntimeOpts,
                    mesh=None):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: new tensors, the inputs unchanged. ``metrics`` holds 0-d
    f32 tensors ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``.

    With ``mesh`` (``launch.mesh.make_training_mesh``) ``params`` and
    ``opt_state`` are this rank's blocks under the reference's FSDP × TP
    rules (``launch.sharding.TrainPlacement(cfg, mesh).shard``),
    ``batch`` is the whole global batch on every rank, the step returns
    the rank's new blocks, and every rank gets the same metrics: the
    whole batch's (the module docstring)."""
    place = None
    if mesh is not None:
        from repro_torch.launch.sharding import TrainPlacement

        place = TrainPlacement(cfg, mesh)

    def grad_fn(params, batch, split=False):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        kw = {}
        if place is not None:
            kw = dict(gather=functools.partial(place.gather,
                                               rows_split=split),
                      placement=place if split else None)
        with torch.enable_grad():
            loss, (ce, aux) = loss_fn(leaves, cfg, batch, opts,
                                      tc.aux_weight, **kw)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        # a leaf the batch does not reach (the vision projector without
        # patches) gets zeros, as jax.grad gives it
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        if split:  # this rank's share of ce: the whole microbatch's
            ce = place.sum_data(ce.detach())
            loss = ce + tc.aux_weight * aux.detach()
        return loss.detach(), ce.detach(), aux.detach(), grads

    def rows(batch: dict, n: int) -> dict:
        """This rank's rows of a microbatch of ``n`` rows (all of it
        without a mesh)."""
        if place is None:
            return batch
        return {k: place.batch_rows(v, n) for k, v in batch.items()}

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        if tc.accum_steps == 1:
            n = batch["tokens"].shape[0]
            split = place is not None and place.rows_split(n)
            loss, ce, aux, grads = grad_fn(params, rows(batch, n), split)
        else:
            micro = (batch if tc.batch_pre_split
                     else _split_microbatches(batch, tc.accum_steps))
            n = micro["tokens"].shape[1]
            split = place is not None and place.rows_split(n)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            sums = None
            for i in range(tc.accum_steps):
                l, c, a, g = grad_fn(params, rows(
                    {k: v[i] for k, v in micro.items()}, n), split)
                for k, gk in g.items():
                    grads[k] += gk
                del g
                s = torch.stack([l, c, a])
                sums = s if sums is None else sums + s
            n = torch.tensor(float(tc.accum_steps), device=sums.device)
            grads = {k: gk / n for k, gk in grads.items()}
            loss, ce, aux = sums / n
        new_params, new_state, om = adamw_update(tc.optimizer, grads,
                                                 opt_state, params, place)
        return new_params, new_state, {"loss": loss, "ce": ce, "aux": aux,
                                       **om}

    return train_step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     dtype=torch.float32, device=None):
    """(parameters drawn from ``generator``, which lives on ``device``;
    their zero AdamW state). ``device`` defaults to the card."""
    device = resolve_device(device)
    params = init_params(cfg, generator, dtype, device)
    return params, adamw_init(params)


def train(cfg: ArchConfig, loader, tc: TrainConfig, opts: RuntimeOpts,
          generator: torch.Generator | None = None, log_every: int = 20,
          params: dict | None = None, opt_state: AdamWState | None = None,
          device=None, on_step=None, mesh=None):
    """Train over ``loader``'s numpy batches on ``device`` (default: the
    card): (params, opt_state, history). Without ``params`` it starts from
    :func:`init_train_state` with ``generator`` (default: seed 0 on the
    device). ``history`` holds each step's metrics as floats, with
    ``host_ms``, the step's host-clock time up to its metrics' readback.
    ``on_step(i, metrics)``, if given, runs after step i's readback.

    With ``mesh`` every rank calls this with the same loader: ``params``
    and ``opt_state``, given or returned, are this rank's blocks (the
    whole initial state is drawn on every rank and cut), and each step is
    :func:`make_train_step`'s over the mesh."""
    device = resolve_device(device)
    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        params, opt_state = init_train_state(cfg, generator, device=device)
        if mesh is not None:
            from repro_torch.launch.sharding import TrainPlacement

            place = TrainPlacement(cfg, mesh)
            params, opt_state = place.shard(params), place.shard(opt_state)
    step_fn = make_train_step(cfg, tc, opts, mesh=mesh)
    history = []
    for i, batch in enumerate(loader):
        t0 = time.perf_counter()
        batch = {k: to_device(v, device) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        row = {k: float(v) for k, v in metrics.items()}
        row["host_ms"] = (time.perf_counter() - t0) * 1e3
        history.append(row)
        if on_step is not None:
            on_step(i, row)
        if i % log_every == 0:
            print(f"step {i:5d} loss {row['loss']:.4f} ce {row['ce']:.4f} "
                  f"lr {row['lr']:.2e}")
    return params, opt_state, history
