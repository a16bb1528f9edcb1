"""TAB-Q, Token-wise Adaptive Bit integer Quantization, paper Algorithm 1
(port of ``repro/core/tabq.py``).

Per token: split sign and magnitude (one bit reserved for the sign),
quantize |T| at the top level Q̄-1 to reference codes T̂₀, then walk the
levels down and keep the last Q whose distortion

    δ = mean | round(T̂₀ / 2^(Q̄-Q)) - T̂ |

stays within Δ. The whole walk is one launch of kernel K5's adaptive entry
(``kernels.ops.tabq_adaptive``; on the CPU its plain version, the walk one
level at a time), which returns the chosen level's codes rebased per token
to [0, Q_max], its scale, its rebased zero, the sign and the bit width,
bit-identical to the reference's. The fixed-width fallback is one launch of
K5 at its level (``kernels.ops.tabq_quantize``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.quant import aiq_dequant
from repro_torch.kernels import ops


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

    def payload_bits(self, widths: torch.Tensor | None = None) -> int:
        """Exact payload accounting: D·Q_token bits per token (sign bit
        included) + 64 bits a token for (scale, zero) + 8 for the bit-width
        byte. ``widths``: a host copy of ``bits`` the caller already holds;
        without it the widths are read back to the host."""
        if widths is None:
            widths = self.bits.cpu()
        d = self.codes.shape[-1]
        return int(widths.sum()) * d + widths.shape[0] * (64 + 8)


def tabq(t: torch.Tensor, max_bits: int = 8, delta: float = 0.2) -> TabQResult:
    """Algorithm 1 over tokens. ``t``: (tokens, D) f32; ``max_bits`` = Q̄
    (sign bit included, 2 to 8: the codes ride int8); ``delta`` = Δ."""
    if not 2 <= max_bits <= 8:
        raise ValueError(f"max_bits {max_bits} not in [2, 8]: one bit is the "
                         f"sign and the codes ride int8")
    codes, sign, scale, zero, bits = ops.tabq_adaptive(t, max_bits, delta)
    return TabQResult(codes, sign, scale, zero, bits)


def tabq_fixed(t: torch.Tensor, bits: int) -> TabQResult:
    """Non-adaptive token-wise quantization at a fixed bit width (the
    Algorithm 2 fallback when a payload budget dictates the level): one
    K5 launch at ``bits - 1`` magnitude bits."""
    codes, s, zero, sign = ops.tabq_quantize(t, bits - 1)
    return TabQResult(codes, sign, s, zero,
                      torch.full(t.shape[:-1], bits, dtype=torch.int32,
                                 device=t.device))
