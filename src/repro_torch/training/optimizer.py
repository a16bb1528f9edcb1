"""AdamW and its learning-rate schedule (port of
``repro/training/optimizer.py``), over the port's flat parameter dict.

The arithmetic is the reference's, in its order: clip the gradients by
their global norm, count + 1, the schedule at the new count in f32, f32
moments, the bias corrections, the decoupled weight decay inside the step,
and the cast back to each parameter's dtype. ``torch.optim.AdamW`` orders
its decay and rounding otherwise, so it is not used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    """f32 first and second moments keyed as the parameters, and the step
    count, a 0-d int32 tensor."""

    mu: dict
    nu: dict
    count: torch.Tensor


def adamw_init(params: dict) -> AdamWState:
    """Zero moments in f32 on each parameter's device, count 0."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}

    device = next(iter(params.values())).device
    return AdamWState(zeros(), zeros(),
                      torch.zeros((), dtype=torch.int32, device=device))


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then a cosine decay to ``min_lr_ratio · lr``, in f32
    as the reference computes it (a 0-d f32 tensor on ``step``'s
    device). Divisors are tensors, so that no backend turns a division
    into a product with a rounded reciprocal."""
    step = torch.as_tensor(step).to(torch.float32)

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=step.device)

    warm = step / const(max(cfg.warmup_steps, 1))
    frac = ((step - cfg.warmup_steps)
            / const(max(cfg.total_steps - cfg.warmup_steps, 1))).clamp(0.0,
                                                                       1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: dict, placement=None) -> torch.Tensor:
    """√(Σ ‖leaf‖²) in f32, the leaves summed in sorted key order (the
    reference's pytree leaf order).

    With ``placement`` (``launch.sharding.TrainPlacement``) the leaves are
    this rank's blocks: each rank sums the squares of the blocks it
    counts (one replica of each, ``placement.counts``), and the sums are
    added over every rank, so every rank gets the norm of the whole
    tree."""
    total = None
    for k in sorted(tree):
        if placement is not None and not placement.counts(k):
            continue
        sq = torch.sum(torch.square(tree[k].float()))
        total = sq if total is None else total + sq
    if placement is not None:
        if total is None:
            total = torch.zeros((), dtype=torch.float32,
                                device=next(iter(tree.values())).device)
        total = placement.sum_all(total)
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float, placement=None):
    """(grads scaled by ``min(1, max_norm / norm)``, in f32, as the
    reference's f32 scale promotes them; the norm before clipping).
    ``placement``: as :func:`global_norm`."""
    norm = global_norm(grads, placement)
    # a tensor divides: ``float / tensor`` is a reciprocal times the float
    num = torch.tensor(max_norm, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(num / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: dict, placement=None):
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}), each
    a new tensor; the inputs are not written. With ``placement`` the
    tensors are a rank's blocks: only the norm crosses ranks
    (:func:`global_norm`), the rest is elementwise on the blocks."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, placement)
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, count.float())
    bc2 = 1 - torch.pow(b2, count.float())
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = b1 * state.mu[k] + (1 - b1) * g
        v = b2 * state.nu[k] + (1 - b2) * g * g
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        new_p[k] = (p.float() - lr * step).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return new_p, AdamWState(new_m, new_v, count), {"grad_norm": gnorm,
                                                    "lr": lr}
