"""Stage-boundary payload codec: TS then TAB-Q (paper §2.3, the Fig. 3
pipeline; port of ``repro/core/payload.py``).

Payload accounting is the paper's: T_above is CSR-accounted, T_below is
per-token adaptive bits plus a per-token scale, zero and bit-width
sideband. ``entropy_bound_bits`` gives the Shannon bound of an rANS pass
over the codes (the analytical stand-in for the paper's DietGPU stage).
``encode_decode_ste`` puts the codec inside a training graph: its forward
is the codec's round trip, its gradient the identity.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tabq import TabQResult, tabq, tabq_fixed
from repro_torch.core.ts import SparseAbove, reconstruct, ts_encode


@dataclasses.dataclass
class Payload:
    """What crosses the split boundary."""

    below: TabQResult
    above: SparseAbove

    def payload_bits(self, widths: torch.Tensor | None = None) -> int:
        """Measured payload bits (reads counts back to the host; ``widths``,
        a host copy of the per-token bit widths, spares their readback)."""
        return self.below.payload_bits(widths) + self.above.csr_bytes() * 8


def encode(t: torch.Tensor, *, tau: float = 5.0, delta: float = 0.2,
           max_bits: int = 8, capacity: int | None = None,
           fixed_bits: int | None = None) -> Payload:
    """TS then TAB-Q. ``t``: (tokens, D) f32. ``fixed_bits`` bypasses the
    adaptive search (Algorithm 2's budget-dictated fallback)."""
    tokens, d = t.shape
    capacity = capacity if capacity is not None else max(16, tokens * d // 1024)
    below, above = ts_encode(t, tau, capacity)
    if fixed_bits is not None:
        q = tabq_fixed(below, fixed_bits)
    else:
        q = tabq(below, max_bits=max_bits, delta=delta)
    return Payload(q, above)


def decode(p: Payload) -> torch.Tensor:
    """Eq. (7): dequantize T_below, reinstate T_above."""
    return reconstruct(p.below.dequantize(), p.above)


class _StraightThrough(torch.autograd.Function):
    """Forward: the codec's round trip (TS then TAB-Q, and back); on the
    card K6 and K5. Backward: the upstream gradient, unchanged."""

    @staticmethod
    def forward(ctx, t, kw):
        out = decode(encode(t.detach(), **kw))
        # the reference's t + stop_gradient(out - t): the same f32 rounding
        return t + (out - t)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def encode_decode_ste(t: torch.Tensor, **kw) -> torch.Tensor:
    """Straight-through encode→decode of ``t`` (tokens, D) f32, with
    :func:`encode`'s keywords: the round trip's values, the identity's
    gradient."""
    return _StraightThrough.apply(t, kw)


def entropy_bound_bits(q: TabQResult, n_bins: int = 256) -> float:
    """Shannon bound in bits for an rANS pass over the magnitude codes,
    plus the per-token sideband."""
    codes = q.codes.reshape(-1).long().clamp(0, n_bins - 1)
    hist = torch.bincount(codes, minlength=n_bins).double()
    p = hist / max(float(hist.sum()), 1.0)
    nz = p[p > 0]
    h = float(-(nz * torch.log2(nz)).sum())
    return h * codes.shape[0] + q.bits.shape[0] * (64 + 8)
