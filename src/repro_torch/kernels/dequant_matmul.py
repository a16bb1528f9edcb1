"""Int8-weight matrix product (the OPSC front segment's projections): the
CUDA kernel's wrapper, its launch count and its plain PyTorch version.

The kernel (``csrc/dequant_matmul.cu``) replaces the Pallas TPU kernel
``repro/kernels/dequant_matmul.py::dequant_matmul``:

  x      (M, K)  f32 or bf16
  codes  (K, N)  int8   symmetric weight codes
  scale  (N,)    f32    one scale per output channel
  out    (M, N)  f32    (x @ codes) * scale, summed in f32

The dequantized weights never exist in device memory. Unlike the TPU
kernel it takes any M, N, K. ``models.layers.matmul`` routes every
projection whose weight is a ``core.quant.QuantizedTensor`` here: the
edge segment of ``serving.split_engine.SplitEngine``.

What bounds it on an H100: at M = 1 (a decode step) reading the K·N code
bytes (device-memory bytes); at a prefill's M of a hundred or more the
2·M·K·N operations, on the CUDA cores in this version. For M ≤ 4 the
kernel is a split-K GEMV; the wrapper picks the K split so that about two
blocks run on each SM, and allocates the (splits, M, N) f32 workspace the
kernel's fixed-order reduction reads.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

GEMV_MAX_M = 4  # at most this many rows of x take the split-K GEMV
MIN_SPLIT_ROWS = 128  # rows of codes a GEMV K range holds at least


def dequant_matmul_ref(x: torch.Tensor, codes: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro/kernels/ref.py::dequant_matmul_ref``):
    (x @ codes) * scale in f32."""
    return (x.float() @ codes.float()) * scale


@functools.cache
def _launcher():
    fn = build.load("dequant_matmul").dequant_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemv_plan(m: int, n: int, k: int, vec: int, sms: int) -> tuple:
    """(rows of x a block, K ranges) of the GEMV for an (m, k) x (k, n)
    product: enough K ranges for about two blocks an SM, each at least
    ``MIN_SPLIT_ROWS`` rows of codes."""
    mt = 1 if m == 1 else GEMV_MAX_M
    blocks = -(-n // (32 * vec)) * -(-m // mt)
    splits = max(1, min(-(-2 * sms // blocks), k // MIN_SPLIT_ROWS))
    chunk = -(-k // splits)
    return mt, -(-k // chunk)


def dequant_matmul(x: torch.Tensor, codes: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (shapes in the module
    docstring). Raises on any input the kernel does not take; there is no
    fallback. Adds one to ``dequant_matmul.launches`` per call."""
    if x.device.type != "cuda":
        raise ValueError(f"dequant_matmul launches a CUDA kernel; x is on "
                         f"{x.device} (use kernels.ops for CPU tensors)")
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[0] \
            or min(x.shape) < 1 or codes.shape[1] < 1:
        raise ValueError(f"need x (M, K) and codes (K, N), got "
                         f"{tuple(x.shape)} and {tuple(codes.shape)}")
    m, k = x.shape
    n = codes.shape[1]
    want = {"x": (x, (torch.float32, torch.bfloat16), (m, k)),
            "codes": (codes, (torch.int8,), (k, n)),
            "scale": (scale, (torch.float32,), (n,))}
    for name, (t, dtypes, shape) in want.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    vec = 8 if n % 8 == 0 and codes.data_ptr() % 8 == 0 else 1
    mt, splits, partial = 0, 1, None
    if m <= GEMV_MAX_M:
        mt, splits = gemv_plan(m, n, k, vec, _sm_count(x.device.index or 0))
        if splits > 1:
            partial = torch.empty((splits, m, n), dtype=torch.float32,
                                  device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
            scale.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), m, n, k, vec,
            mt, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    dequant_matmul.launches += 1
    return out


dequant_matmul.launches = 0
