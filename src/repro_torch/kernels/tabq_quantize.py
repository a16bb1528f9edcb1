"""Per-token asymmetric magnitude quantization (TAB-Q's inner step, paper
Eq. 5-6): the CUDA kernel's wrapper, its launch count and its plain
PyTorch version.

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
``core.tabq`` calls it once per TAB-Q level. Unlike the TPU kernel it takes
any T (no ``block_t``).

What bounds it on an H100: it reads x once (twice in practice, the second
time from cache) and writes codes and sign once, a few operations a byte:
device-memory bytes, and at a decode payload's T = 1 the launch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build


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
    if x.device.type != "cuda":
        raise ValueError(f"tabq_quantize launches a CUDA kernel; x is on "
                         f"{x.device} (use kernels.ops for CPU tensors)")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
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
