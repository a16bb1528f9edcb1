"""Integer quantization primitives, paper §2.3.2 Eq. 5-6 (port of
``repro/core/quant.py``): AIQ, the symmetric per-channel weight quantizer
OPSC uses, the group-wise quantizer, int4 packing, and the lite baselines
of Table 3 (SmoothQuant, OmniQuant, Atom), which are offline weight
transforms with fake-quant semantics, as in the reference.

AIQ keeps the paper's convention ``Q_max = 2^(Q-1) - 1`` (one bit is
reserved for the sign in TAB-Q, so AIQ quantizes magnitudes). Every
function does the reference's f32 operations in the reference's order
(IEEE division, rounding half to even), so codes and scales are
bit-identical to the JAX package's on the same input. A divisor is always
a tensor: PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, which rounds differently.

The reference's quirks are kept: ``quantize_groupwise`` returns one scale
a row (its group's, repeated), in the weight's dtype; 4-bit codes live in
an int8 carrier, and codes above 8 bits in int32.
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
    """An int-quantized tensor: int8 codes (int32 above 8 bits; the split
    edge stores those as int16) and f32 scales broadcastable against them. Indexing takes the leading axis
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


def quantize_groupwise(w: torch.Tensor, bits: int,
                       group: int = 128) -> QuantizedTensor:
    """Group-wise symmetric quantization along dim 0 (in-features), as
    Atom: each ``group`` consecutive input channels of ``w`` (in, out)
    share a scale; the in-dim is padded with zeros to a whole group. Codes
    int8 (in, out); the scale (in, out) repeats each group's row over its
    rows (the reference's broadcast form), in ``w``'s dtype."""
    din, dout = w.shape
    pad = (-din) % group
    g = torch.nn.functional.pad(w, (0, 0, 0, pad)).reshape(-1, group, dout)
    qmax = float(2 ** (bits - 1) - 1)
    amax = g.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / torch.full_like(amax, qmax)
    codes = torch.clamp(torch.round(g / scale), -qmax, qmax)
    codes = codes.reshape(din + pad, dout)[:din].to(torch.int8)
    scale_c = scale[:, 0][: (din + group - 1) // group]  # (groups, out)
    return QuantizedTensor(codes, scale_c.repeat_interleave(group, 0)[:din],
                           bits, (din, dout))


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 values (range [-7, 7]) two to a byte, the first of
    each pair in the low nibble: uint8 of length ceil(n / 2)."""
    flat = codes.reshape(-1)
    if flat.shape[0] % 2:
        flat = torch.nn.functional.pad(flat, (0, 1))
    lo = flat[0::2].to(torch.int32) & 0xF
    hi = (flat[1::2].to(torch.int32) & 0xF) << 4
    return (lo | hi).to(torch.uint8)


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: the first ``n`` values, int8."""
    p = packed.to(torch.int32)
    vals = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(-1)[:n]
    vals = torch.where(vals >= 8, vals - 16, vals)  # 4-bit two's complement
    return vals.to(torch.int8)


def smoothquant_lite(w: torch.Tensor, act_absmax: torch.Tensor, bits_w: int,
                     alpha: float = 0.5):
    """SmoothQuant: migrate activation outliers into the weight (in, out)
    by the per-input-channel smoothing ``s_j = absmax_act_j^alpha /
    absmax_w_j^(1 - alpha)``, then quantize ``w * s`` per tensor. Returns
    (:class:`QuantizedTensor` of W·s, s). The two powers are taken in f64
    and rounded to ``w``'s dtype, so each is the correctly rounded f32
    power; the reference's f32 power (XLA's, on the CPU libm's ``powf``)
    is within one ulp of it, and ``s`` within two of the reference's."""
    w_absmax = torch.clamp(w.abs().amax(dim=1), min=_EPS)
    num = (torch.clamp(act_absmax, min=_EPS).double() ** alpha).to(w.dtype)
    den = (w_absmax.double() ** (1.0 - alpha)).to(w.dtype)
    s = torch.clamp(num / den, min=_EPS)
    return quantize_sym(w * s[:, None], bits_w, dim=None), s


def omniquant_lite(w: torch.Tensor, bits: int,
                   clip_grid=(1.0, 0.9, 0.8, 0.7, 0.6)) -> QuantizedTensor:
    """OmniQuant-lite: per output row of ``w``, the clipping ratio of
    ``clip_grid`` whose codes give the least mean squared error (the first
    ratio on a tie); int8 codes, scales (rows, 1) in ``w``'s dtype."""
    qmax = float(2 ** (bits - 1) - 1)
    best = None
    for c in clip_grid:
        amax = w.abs().amax(dim=-1, keepdim=True) * c
        scale = torch.clamp(amax, min=_EPS) / torch.full_like(amax, qmax)
        codes = torch.clamp(torch.round(w / scale), -qmax, qmax)
        diff = codes * scale - w
        err = (diff * diff).mean(dim=-1, keepdim=True)
        if best is None:
            best = (err, codes, scale)
            continue
        berr, bcodes, bscale = best
        take = err < berr
        best = (torch.where(take, err, berr), torch.where(take, codes, bcodes),
                torch.where(take, scale, bscale))
    _, codes, scale = best
    return QuantizedTensor(codes.to(torch.int8), scale, bits, tuple(w.shape))


def atom_lite(w: torch.Tensor, bits_low: int = 4,
              outlier_frac: float = 1 / 128, group: int = 128):
    """Atom-lite: the input channels (rows of ``w``) of the largest L1
    norms, ``max(1, int(in · outlier_frac))`` of them and every row tied
    with the last, stay in int8 (one scale a row); the rest are
    quantized group-wise at ``bits_low``. Returns (low
    :class:`QuantizedTensor` with the outlier rows zeroed, outlier
    :class:`QuantizedTensor` with the others zeroed, outlier row mask)."""
    din = w.shape[0]
    n_out = max(1, int(din * outlier_frac))
    norms = w.abs().sum(dim=1)
    thresh = torch.sort(norms).values[-n_out]
    mask = norms >= thresh
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    w_low = torch.where(mask[:, None], zero, w)
    w_out = torch.where(mask[:, None], w, zero)
    return (quantize_groupwise(w_low, bits_low, group),
            quantize_sym(w_out, 8, dim=-1), mask)


def dequant_atom(q_low: QuantizedTensor, q_out: QuantizedTensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The Atom-lite weight back in f32: outlier rows from ``q_out``, the
    rest from ``q_low``."""
    return torch.where(mask[:, None], q_out.dequantize(), q_low.dequantize())
