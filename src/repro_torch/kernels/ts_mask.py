"""Threshold split (TS, paper Eq. 4): the CUDA kernel's wrapper, its launch
count and its plain PyTorch version.

The kernel (``csrc/ts_mask.cu``) replaces the Pallas TPU kernel
``repro/kernels/ts_mask.py::ts_mask``:

  x       (T, D)  f32 or bf16
  below   (T, D)  f32    x where |x| < tau, else +0
  mask    (T, D)  uint8  |x| >= tau (in f32, tau as an f32)
  counts  (T, 1)  int32  entries of each row with |x| >= tau

The TPU kernel counts per tile of ``block_t`` rows and needs T to divide
by it; here a tile is one row, so any T works, and the outlier count is
``counts.sum()`` either way. ``core.ts.ts_encode`` calls it once per
payload.

What bounds it on an H100: one read of x and one write of ``below`` and
``mask``, one compare a value: device-memory bytes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def ts_mask_ref(x: torch.Tensor, tau: float):
    """Plain PyTorch version (``repro/kernels/ref.py::ts_mask_ref``, with
    per-row counts). Returns (below, mask, counts)."""
    xf = x.float()
    mask = xf.abs() >= torch.tensor(tau, dtype=torch.float32, device=x.device)
    below = torch.where(mask, 0.0, xf)
    return below, mask.to(torch.uint8), mask.sum(dim=-1, keepdim=True,
                                                 dtype=torch.int32)


@functools.cache
def _launcher():
    fn = build.load("ts_mask").ts_mask_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_float, p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def ts_mask(x: torch.Tensor, tau: float):
    """Launch the CUDA kernel on the current stream (shapes in the module
    docstring). Raises on any input the kernel does not take; there is no
    fallback. Adds one to ``ts_mask.launches`` per launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ts_mask launches a CUDA kernel; x is on "
                         f"{x.device} (use kernels.ops for CPU tensors)")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    t, d = x.shape
    below = torch.empty((t, d), dtype=torch.float32, device=x.device)
    mask = torch.empty((t, d), dtype=torch.uint8, device=x.device)
    counts = torch.empty((t, 1), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                          float(tau), below.data_ptr(), mask.data_ptr(),
                          counts.data_ptr(), t, d,
                          torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ts_mask kernel launch failed: CUDA error {err}")
    ts_mask.launches += 1
    return below, mask, counts


ts_mask.launches = 0
