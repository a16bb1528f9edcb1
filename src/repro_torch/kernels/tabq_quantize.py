"""Per-token asymmetric magnitude quantization (TAB-Q's inner step, paper
Eq. 5-6) and TAB-Q's whole level walk (paper Algorithm 1): the CUDA
kernels' wrappers, their launch counts and their plain PyTorch versions.

The kernel (``csrc/tabq_quantize.cu``) replaces the Pallas TPU kernel
``repro/kernels/tabq_kernel.py::tabq_quantize``. It computes what that
kernel computes:

  x      (T, D)  f32 or bf16
  codes  (T, D)  int8   |x| at ``bits`` bits, rebased per token to
                        [0, 2^(bits-1)-1]
  scale  (T, 1)  f32    zero (T, 1) f32 (absorbs the rebase)
  sign   (T, D)  int8   in {-1, 0, 1}

The scale is (max|x| - min|x|) times 1/max(qmax, 1) rounded to f32: the
reference computes it under jit with qmax a constant (``core.tabq``, and
the Pallas kernel), where XLA turns the division into that product. So at
``bits`` = q it gives the codes, scales and zeros of the reference's
``tabq``/``tabq_fixed`` levels bit for bit (``core.quant.aiq`` called with
a traced ``bits`` divides, and its scale can differ in the last bit):
``core.tabq.tabq_fixed`` calls it once. Unlike the TPU kernel it takes any
T (no ``block_t``).

:func:`tabq_adaptive` (``tabq_adaptive_kernel``, the same source) is
``core.tabq.tabq`` in one launch: per token the top level's codes, then
each lower level down to ``MIN_BITS`` while every level so far keeps the
distortion δ within Δ, and the chosen level's outputs and bit width. Its
plain version, :func:`tabq_adaptive_ref`, is that walk over
:func:`tabq_quantize_ref`, one level a call; both give the same bits
(δ's sum is of integer-valued f32s, exact in any order below 2^24).

What bounds it on an H100: it reads x once (twice in practice, the second
time from cache) and writes codes and sign once, a few operations a byte:
device-memory bytes, and at a decode payload's T = 1 the launch: the
adaptive kernel spends one launch where the walk spent one a level and a
dozen small PyTorch operations around each.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

MIN_BITS = 2  # the lowest TAB-Q level (magnitude bits)
# the adaptive kernel keeps |x| and the top level's codes of a token in
# shared memory: 8 bytes a value, within 226 KB
MAX_ADAPTIVE_D = (227 * 1024 - 1024) // 8


def reciprocal(qmax: float) -> float:
    """1 / max(qmax, 1) rounded to f32, the factor the scale takes."""
    return float(np.float32(1.0) / np.float32(max(qmax, 1.0)))


def tabq_quantize_ref(x: torch.Tensor, bits: int):
    """Plain PyTorch version (``repro/kernels/ref.py::tabq_quantize_ref``),
    the kernel's f32 operations in its order. Returns (codes, scale, zero,
    sign)."""
    sign = torch.sign(x).to(torch.int8)
    mag = x.float().abs()
    qmax = float(2 ** (bits - 1) - 1)
    t_min = mag.amin(dim=-1, keepdim=True)
    t_max = mag.amax(dim=-1, keepdim=True)
    s = torch.clamp((t_max - t_min) * torch.full_like(t_max, reciprocal(qmax)),
                    min=1e-8)
    z = torch.ceil(t_min / s)
    codes = torch.round(mag / s + z)
    c_lo = torch.round(t_min / s + z)
    codes = torch.minimum(torch.maximum(codes, c_lo), c_lo + qmax)
    return (codes - c_lo).to(torch.int8), s, z - c_lo, sign


def _check_x(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; x is on "
                         f"{x.device} (use kernels.ops for CPU tensors)")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


@functools.cache
def _launcher():
    fn = build.load("tabq_quantize").tabq_quantize_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def tabq_quantize(x: torch.Tensor, bits: int):
    """Launch the CUDA kernel on the current stream (shapes in the module
    docstring). Raises on any input the kernel does not take; there is no
    fallback. Adds one to ``tabq_quantize.launches`` per launch."""
    _check_x("tabq_quantize", x)
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8] (int8 codes), got {bits}")
    t, d = x.shape
    codes = torch.empty((t, d), dtype=torch.int8, device=x.device)
    sign = torch.empty((t, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                          codes.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                          sign.data_ptr(), t, d, bits,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tabq_quantize kernel launch failed: CUDA error "
                           f"{err}")
    tabq_quantize.launches += 1
    return codes, scale, zero, sign


tabq_quantize.launches = 0


def tabq_adaptive_ref(x: torch.Tensor, max_bits: int, delta: float,
                      level=tabq_quantize_ref):
    """Plain PyTorch version of :func:`tabq_adaptive`: TAB-Q's level walk
    (``repro/core/tabq.py::tabq``), one ``level`` call (K5's plain version,
    or its kernel) a level. δ needs each level's codes before the rebase;
    their floor ``round(T_min/s + ceil(T_min/s))`` is recomputed from the
    token's min |x| and the level's own scale with K5's f32 operations.
    Returns (codes, sign, scale, zero, bits), bits (T,) int32 with the sign
    bit."""
    q_ref = max_bits - 1  # one bit reserved for the sign
    t_min = x.abs().amin(dim=-1, keepdim=True)

    def run(bits):
        codes, s, zero, sign = level(x, bits)
        z = torch.ceil(t_min / s)
        c_lo = torch.round(t_min / s + z)
        return codes, s, zero, sign, codes.float() + c_lo

    codes, scale, zero, sign, codes0 = run(q_ref)
    bits = torch.full(x.shape[:-1], q_ref, dtype=torch.int32, device=x.device)
    # the mean over D as the reference's jit computes it: times 1/D
    # rounded to f32
    inv_n = torch.full((), reciprocal(x.shape[-1]), dtype=torch.float32,
                       device=x.device)
    delta_t = torch.tensor(delta, dtype=torch.float32, device=x.device)
    # walk the levels down: a token takes a level while every level so far
    # kept δ ≤ Δ (the reference's cumprod of admissible levels)
    alive = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    for q in range(q_ref - 1, MIN_BITS - 1, -1):
        c, s, zr, _, c_abs = run(q)
        shift = float(2 ** (q_ref - q))  # a power of two: exact
        d_q = (torch.round(codes0 / shift) - c_abs).abs().sum(dim=-1) * inv_n
        alive = alive & (d_q <= delta_t)
        take = alive[..., None]
        codes = torch.where(take, c, codes)
        scale = torch.where(take, s, scale)
        zero = torch.where(take, zr, zero)
        bits = torch.where(alive, q, bits)
    return codes, sign, scale, zero, bits + 1


@functools.cache
def _adaptive_launcher():
    fn = build.load("tabq_quantize").tabq_adaptive_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, p, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def tabq_adaptive(x: torch.Tensor, max_bits: int, delta: float):
    """Launch the adaptive kernel on the current stream: TAB-Q of each row
    of x (T, D) f32 or bf16 with ``max_bits`` = Q̄ in [2, 8] (sign bit
    included) and ``delta`` = Δ, one launch for all levels. Returns (codes,
    sign, scale, zero, bits) as :func:`tabq_adaptive_ref`. Raises on any
    input the kernel does not take; there is no fallback. Adds one to
    ``tabq_adaptive.launches`` per launch."""
    _check_x("tabq_adaptive", x)
    if not 2 <= max_bits <= 8:
        raise ValueError(f"max_bits must be in [2, 8] (int8 codes, one sign "
                         f"bit), got {max_bits}")
    t, d = x.shape
    if d > MAX_ADAPTIVE_D:
        raise ValueError(f"tabq_adaptive keeps a token in shared memory: D "
                         f"<= {MAX_ADAPTIVE_D}, got {d}")
    codes = torch.empty((t, d), dtype=torch.int8, device=x.device)
    sign = torch.empty((t, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    zero = torch.empty((t, 1), dtype=torch.float32, device=x.device)
    bits = torch.empty((t,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _adaptive_launcher()(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scale.data_ptr(), zero.data_ptr(), sign.data_ptr(),
            bits.data_ptr(), t, d, max_bits, delta,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tabq_adaptive kernel launch failed: CUDA error "
                           f"{err}")
    tabq_adaptive.launches += 1
    return codes, sign, scale, zero, bits


tabq_adaptive.launches = 0
