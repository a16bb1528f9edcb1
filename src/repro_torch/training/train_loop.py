"""The training loop (port of ``repro/training/train_loop.py``): the loss,
the train step with microbatch accumulation, and a single-device driver.

A step takes the gradients of :func:`loss_fn` through autograd
(``forward_train``, with each block recomputed in the backward pass under
``RuntimeOpts.remat``). With ``accum_steps`` > 1 the batch is cut into
that many microbatches along its first axis, run in order, their gradients
summed into f32 buffers and divided by ``accum_steps``, as are the loss,
the cross entropy and the auxiliary loss; then one AdamW update.
"""

from __future__ import annotations

import dataclasses
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
                  loss_mask: torch.Tensor) -> torch.Tensor:
    """Masked next-token cross entropy in f32. On a codebook config the
    labels carry a trailing K axis and the logits are (..., K, V): each
    position's K losses are averaged first."""
    lp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    while nll.dim() > loss_mask.dim():  # the codebook axis
        nll = nll.mean(dim=-1)
    denom = torch.clamp(loss_mask.sum(), min=1.0)
    return torch.sum(nll * loss_mask) / denom


def loss_fn(params: dict, cfg: ArchConfig, batch: dict, opts: RuntimeOpts,
            aux_weight: float = 0.01):
    """(ce + aux_weight · aux, (ce, aux)) of ``batch`` (``tokens``,
    ``labels``, ``loss_mask`` and, on the vision stub, ``patches``)."""
    logits, aux = forward_train(params, cfg, batch["tokens"],
                                batch.get("patches"), opts)
    ce = cross_entropy(logits, batch["labels"], batch["loss_mask"])
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


def make_train_step(cfg: ArchConfig, tc: TrainConfig, opts: RuntimeOpts):
    """``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: new tensors, the inputs unchanged. ``metrics`` holds 0-d
    f32 tensors ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``."""

    def grad_fn(params, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            loss, (ce, aux) = loss_fn(leaves, cfg, batch, opts,
                                      tc.aux_weight)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        # a leaf the batch does not reach (the vision projector without
        # patches) gets zeros, as jax.grad gives it
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        return loss.detach(), ce.detach(), aux.detach(), grads

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        if tc.accum_steps == 1:
            loss, ce, aux, grads = grad_fn(params, batch)
        else:
            micro = (batch if tc.batch_pre_split
                     else _split_microbatches(batch, tc.accum_steps))
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            sums = None
            for i in range(tc.accum_steps):
                l, c, a, g = grad_fn(params, {k: v[i]
                                              for k, v in micro.items()})
                for k, gk in g.items():
                    grads[k] += gk
                del g
                s = torch.stack([l, c, a])
                sums = s if sums is None else sums + s
            n = torch.tensor(float(tc.accum_steps), device=sums.device)
            grads = {k: gk / n for k, gk in grads.items()}
            loss, ce, aux = sums / n
        new_params, new_state, om = adamw_update(tc.optimizer, grads,
                                                 opt_state, params)
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
          device=None, on_step=None):
    """Train over ``loader``'s numpy batches on ``device`` (default: the
    card): (params, opt_state, history). Without ``params`` it starts from
    :func:`init_train_state` with ``generator`` (default: seed 0 on the
    device). ``history`` holds each step's metrics as floats, with
    ``host_ms``, the step's host-clock time up to its metrics' readback.
    ``on_step(i, metrics)``, if given, runs after step i's readback."""
    device = resolve_device(device)
    if params is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        params, opt_state = init_train_state(cfg, generator, device=device)
    step_fn = make_train_step(cfg, tc, opts)
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
