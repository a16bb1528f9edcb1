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

Expert parallelism (the reference's ``moe_layer_ep`` under
``shard_map``) belongs to the sharded deployment and is not ported.
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


def moe_layer(params, x: torch.Tensor, spec, capacity_factor: float = 1.25,
              groups: int = 1):
    """x (B, S, D) → (out (B, S, D), aux loss, a 0-d f32 tensor), as the
    reference's ``moe_layer``. ``groups`` > 1 applies the capacity rule
    and the loss's means per group of T / groups consecutive tokens (1
    when it does not divide T); every row of x is routed, pad rows too."""
    b, s, d = x.shape
    t = b * s
    e, k = spec.num_experts, spec.top_k
    groups = max(1, min(groups, t))
    if t % groups:
        groups = 1
    tg = t // groups
    cap = capacity(tg, spec, capacity_factor)
    xt = x.reshape(t, d)

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

    y = torch.zeros((t * k, d), dtype=x.dtype, device=x.device)
    if kept:
        pairs = order[:kept]
        rows = xt.index_select(0, pairs // k)
        out = torch.empty((kept, d), dtype=x.dtype, device=x.device)
        start = 0
        for i, n in enumerate(counts[:e]):
            if not n:
                continue
            w = {name: expert_weight(params[name], i, e)
                 for name in ("w_gate", "w_up", "w_down")}
            out[start:start + n] = mlp_layer(w, rows[start:start + n],
                                             "silu")
            start += n
        g = gate.reshape(-1).index_select(0, pairs).to(x.dtype)
        y.index_copy_(0, pairs, out * g[:, None])
    y = y.reshape(t, k, d).sum(dim=1)

    f_e = F.one_hot(sel, e).sum(1).float().reshape(groups, tg, e).mean(1)
    p_e = probs.reshape(groups, tg, e).mean(1)
    if groups > 1:
        f_e, p_e = f_e.mean(0), p_e.mean(0)
    else:
        f_e, p_e = f_e[0], p_e[0]
    if "shared" in params:
        y = y + mlp_layer(params["shared"], xt, "silu")
    aux = e * torch.sum(f_e * p_e) / k

    if not _UNCOUNTED[0]:
        STATS["calls"] += 1
        STATS["host_syncs"] += 1
        STATS["pairs"] += t * k
        STATS["dropped"] += t * k - kept
        STATS["experts"] += sum(1 for n in counts[:e] if n)
    return y.reshape(b, s, d), aux


def moe_layer_ep(*args, **kwargs):
    """The reference's expert-parallel dispatch under ``shard_map``."""
    raise NotImplementedError(
        "expert-parallel MoE (moe_layer_ep) is not ported (ROADMAP queue 1, "
        "item 8, the sharded deployment)")
