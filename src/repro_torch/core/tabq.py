"""TAB-Q, Token-wise Adaptive Bit integer Quantization, paper Algorithm 1
(port of ``repro/core/tabq.py``).

Per token: split sign and magnitude (one bit reserved for the sign),
quantize |T| at the top level Q̄-1 to reference codes T̂₀, then walk the
levels down and keep the last Q whose distortion

    δ = mean | round(T̂₀ / 2^(Q̄-Q)) - T̂ |

stays within Δ. Each level is one launch of kernel K5
(``kernels.ops.tabq_quantize``), which returns the level's codes rebased
per token to [0, Q_max], its scale, its rebased zero and the sign. δ needs
the codes before the rebase; their floor ``round(T_min/s + ceil(T_min/s))``
is recomputed here from the token's min |T| and K5's own scale with the
same f32 operations, so the codes, scales, zeros and chosen bit widths are
bit-identical to the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import aiq_dequant
from repro_torch.kernels import ops
from repro_torch.kernels.tabq_quantize import reciprocal

MIN_BITS = 2


@dataclasses.dataclass
class TabQResult:
    """Per-token adaptively quantized tensor.

    codes : (tokens, D) int8 magnitude codes, rebased per token to
            [0, Q_max] (the wire representation)
    sign  : (tokens, D) int8 in {-1, 0, +1}: the reserved sign bit
    scale : (tokens, 1) f32 per-token scale
    zero  : (tokens, 1) f32 per-token zero point (absorbs the rebase)
    bits  : (tokens,) int32 chosen bit width, sign bit included
    """

    codes: torch.Tensor
    sign: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: torch.Tensor

    def dequantize(self) -> torch.Tensor:
        return aiq_dequant(self.codes, self.scale, self.zero) * self.sign

    def payload_bits(self) -> int:
        """Exact payload accounting: D·Q_token bits per token (sign bit
        included) + 64 bits a token for (scale, zero) + 8 for the bit-width
        byte. Reads the bit widths back to the host."""
        d = self.codes.shape[-1]
        return int(self.bits.sum()) * d + self.bits.shape[0] * (64 + 8)


def _level(t: torch.Tensor, t_min: torch.Tensor, bits: int):
    """AIQ of |t| at ``bits`` magnitude bits through K5: (rebased codes,
    scale, rebased zero, sign, the codes before the rebase as f32)."""
    codes, s, zero, sign = ops.tabq_quantize(t, bits)
    z = torch.ceil(t_min / s)
    c_lo = torch.round(t_min / s + z)
    return codes, s, zero, sign, codes.float() + c_lo


def tabq(t: torch.Tensor, max_bits: int = 8, delta: float = 0.2) -> TabQResult:
    """Algorithm 1 over tokens. ``t``: (tokens, D) f32; ``max_bits`` = Q̄
    (sign bit included, at most 8: the codes ride int8); ``delta`` = Δ."""
    if max_bits > 8:
        raise ValueError(f"max_bits {max_bits} > 8: the codes ride int8")
    q_ref = max_bits - 1  # one bit reserved for the sign
    t_min = t.abs().amin(dim=-1, keepdim=True)
    codes, scale, zero, sign, codes0 = _level(t, t_min, q_ref)
    bits = torch.full(t.shape[:-1], q_ref, dtype=torch.int32, device=t.device)
    # the mean over D as the reference's jit computes it: times 1/D
    # rounded to f32
    inv_n = torch.full((), reciprocal(t.shape[-1]), dtype=torch.float32,
                       device=t.device)
    delta_t = torch.tensor(delta, dtype=torch.float32, device=t.device)
    # walk the levels down: a token takes a level while every level so far
    # kept δ ≤ Δ (the reference's cumprod of admissible levels)
    alive = torch.ones(t.shape[:-1], dtype=torch.bool, device=t.device)
    for q in range(q_ref - 1, MIN_BITS - 1, -1):
        c, s, zr, _, c_abs = _level(t, t_min, q)
        shift = float(2 ** (q_ref - q))  # a power of two: exact
        d_q = (torch.round(codes0 / shift) - c_abs).abs().sum(dim=-1) * inv_n
        alive = alive & (d_q <= delta_t)
        take = alive[..., None]
        codes = torch.where(take, c, codes)
        scale = torch.where(take, s, scale)
        zero = torch.where(take, zr, zero)
        bits = torch.where(alive, q, bits)
    return TabQResult(codes, sign, scale, zero, bits + 1)


def tabq_fixed(t: torch.Tensor, bits: int) -> TabQResult:
    """Non-adaptive token-wise quantization at a fixed bit width (the
    Algorithm 2 fallback when a payload budget dictates the level): one
    K5 launch at ``bits - 1`` magnitude bits."""
    codes, s, zero, sign = ops.tabq_quantize(t, bits - 1)
    return TabQResult(codes, sign, s, zero,
                      torch.full(t.shape[:-1], bits, dtype=torch.int32,
                                 device=t.device))
