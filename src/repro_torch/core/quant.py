"""Integer quantization primitives, paper §2.3.2 Eq. 5-6 (port of
``repro/core/quant.py``: AIQ and the symmetric per-channel weight
quantizer OPSC uses).

AIQ keeps the paper's convention ``Q_max = 2^(Q-1) - 1`` (one bit is
reserved for the sign in TAB-Q, so AIQ quantizes magnitudes). Every
function does the reference's f32 operations in the reference's order
(IEEE division, rounding half to even), so codes and scales are
bit-identical to the JAX package's on the same input. A divisor is always
a tensor: PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, which rounds differently.

Not ported yet (ROADMAP queue 1, item 10, what the split path left out):
the group-wise quantizer, int4 packing and the Table 3 baselines
(SmoothQuant-, OmniQuant- and Atom-lite).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_EPS = 1e-8


def qmax_for_bits(bits) -> float:
    """Paper Eq. (6): Q_max = 2^(Q-1) - 1."""
    return float(2 ** (int(bits) - 1) - 1)


def aiq(t: torch.Tensor, bits: int, dim: int | None = None):
    """Asymmetric integer quantization of ``t`` (f32) at ``bits`` bits,
    Eq. (5)-(6):

      s = (T_max - T_min) / Q_max,  z = ceil(T_min / s),
      T_hat = round(T / s + z)   (so dequant = (T_hat - z) * s).

    ``dim``: reduction axis for min/max (None = the whole tensor, -1 =
    per token for (tokens, features)). Codes are clipped to
    [round(T_min/s + z), that + Q_max]. Returns (codes as f32 integers,
    scale, zero)."""
    if dim is None:
        t_min, t_max = t.amin(), t.amax()
    else:
        t_min = t.amin(dim=dim, keepdim=True)
        t_max = t.amax(dim=dim, keepdim=True)
    qmax = qmax_for_bits(bits)
    s = (t_max - t_min) / torch.full_like(t_max, max(qmax, 1.0))
    s = torch.where(s.abs() < _EPS, torch.full_like(s, _EPS), s)
    z = torch.ceil(t_min / s)
    codes = torch.round(t / s + z)
    c_lo = torch.round(t_min / s + z)
    codes = torch.minimum(torch.maximum(codes, c_lo), c_lo + qmax)
    return codes, s, z


def aiq_dequant(codes: torch.Tensor, s: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """Eq. (7) dense part: (T_hat - z) * s."""
    return (codes.float() - z) * s


@dataclasses.dataclass
class QuantizedTensor:
    """An int-quantized tensor: int8 codes (int32 above 8 bits) and f32
    scales broadcastable against them. Indexing takes the leading axis
    of both, so a stacked (nb, d_in, d_out) weight gives block ``i``'s
    (d_in, d_out) codes with their scales, as a plain tensor leaf would."""

    codes: torch.Tensor
    scale: torch.Tensor
    bits: int
    shape: tuple

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.codes.float() * self.scale).to(dtype)

    @property
    def nbytes(self) -> int:
        """Bytes at ``bits`` bits per code, plus the f32 scales."""
        return math.prod(self.shape) * self.bits // 8 + self.scale.numel() * 4

    def __getitem__(self, i) -> "QuantizedTensor":
        codes = self.codes[i]
        scale = self.scale[i] if self.scale.dim() else self.scale
        return QuantizedTensor(codes, scale, self.bits, tuple(codes.shape))


def quantize_sym(w: torch.Tensor, bits: int,
                 dim: int | None = -1) -> QuantizedTensor:
    """Symmetric per-channel quantization: codes in [-(2^(b-1)-1),
    2^(b-1)-1], ``scale = max(amax, eps) / qmax`` over ``dim`` (None =
    the whole tensor). Computed in ``w``'s dtype, as the reference does
    (a bf16 weight gets bf16 scales, stored as f32)."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = w.abs().amax() if dim is None \
        else w.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / torch.full_like(amax, qmax)
    carrier = torch.int8 if bits <= 8 else torch.int32
    codes = torch.clamp(torch.round(w / scale), -qmax, qmax).to(carrier)
    return QuantizedTensor(codes, scale.float(), bits, tuple(w.shape))
