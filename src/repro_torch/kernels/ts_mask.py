"""Threshold splitting (TS, paper Eq. 4) with the reference's
fixed-capacity carrier: the CUDA kernel's wrapper, its launch count and
its plain PyTorch versions.

The kernel (``csrc/ts_mask.cu``, ``ts_encode_kernel``) replaces the Pallas
TPU kernel ``repro/kernels/ts_mask.py::ts_mask`` and the top-capacity
selection around it: it computes ``core.ts.ts_encode`` (the reference's
``repro/core/ts.py::ts_encode``) in one launch a payload.

  x        (T, D)  f32 or bf16, compared as f32 with tau as an f32
  below    (T, D)  f32    x, with +0 at the entries kept in the carrier
  values   (C,)    f32    the carrier: x at the kept entries, else 0
  indices  (C,)    int64  their flat indices, else -1
  count    ()      int32  entries with |x| >= tau, uncapped

Its contract is its plain version's, :func:`ts_encode_ref` (a stable
descending sort of |x|, the top C taken): entries rank by |x| descending,
then flat index ascending, NaN above every magnitude. The carrier holds
the top min(count + NaNs, C) entries that are NaN or have |x| >= tau, in
that order, then (-1, 0) slots; a NaN takes its slot as (-1, 0) and stays
in ``below``, as do the entries past the capacity.

:func:`ts_mask_ref` is the plain version of the TPU kernel's own dense
pass (below, mask and per-row counts), which ``ts_encode_ref`` starts
from and the tests hold against the Pallas kernel.

What bounds it on an H100: one read of x, one write of ``below`` and the
carrier: device-memory bytes. At a decode payload (T = 1) the launch, the
ticket protocol's round trips and the last block's chain of steps set its
time; the last block's work grows with the entries above tau, not with
T * D.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tickets import scratch

# the kernel's state: 64-bit words of its tickets over its candidates, its
# count of NaNs, and the OR of its keys and of their complements
STATE_WORDS = 8
# the largest T * D the kernel takes (``kMaxN``: flat indices are int32)
MAX_N = 2**31 - 1 - 4096


def ts_mask_ref(x: torch.Tensor, tau: float):
    """Plain PyTorch version of the TPU kernel's pass
    (``repro/kernels/ref.py::ts_mask_ref``, with per-row counts). Returns
    (below, mask, counts)."""
    xf = x.float()
    mask = xf.abs() >= torch.tensor(tau, dtype=torch.float32, device=x.device)
    below = torch.where(mask, 0.0, xf)
    return below, mask.to(torch.uint8), mask.sum(dim=-1, keepdim=True,
                                                 dtype=torch.int32)


def ts_encode_ref(x: torch.Tensor, tau: float, capacity: int):
    """Plain PyTorch version of the kernel: x (T, D) → (below (T, D) f32,
    values (C,) f32, indices (C,) int64, count () int32). Keeps the
    ``capacity`` largest-magnitude entries with |x| ≥ τ; on ties the lower
    flat index comes first. Makes no host sync."""
    below, mask, counts = ts_mask_ref(x, tau)
    flat = x.reshape(-1).float()
    mask = mask.reshape(-1).bool()
    # a stable descending sort orders equal magnitudes by index, as
    # jax.lax.top_k does (torch.topk does not), which decides both the
    # carrier's order and, past capacity, which entries it keeps
    top_mag, top_idx = torch.sort(flat.abs(), descending=True, stable=True)
    top_mag, top_idx = top_mag[:capacity], top_idx[:capacity]
    valid = top_mag >= torch.tensor(tau, dtype=top_mag.dtype,
                                    device=top_mag.device)
    idx = torch.where(valid, top_idx, -1)
    vals = torch.where(valid, flat[top_idx], 0.0)
    kept = torch.zeros_like(mask).scatter_(0, top_idx, valid)
    # the pass zeroed every entry above τ; those past capacity go back
    below = torch.where(mask & ~kept, flat, below.reshape(-1))
    return below.reshape(x.shape), vals, idx, counts.sum().to(torch.int32)


def workspace_floats(n: int, capacity: int) -> int:
    """The f32 words of workspace a call takes: the candidates' 8-byte keys
    and S's past its first chunk."""
    return 2 * (n + min(capacity, n))


@functools.cache
def _launcher():
    fn = build.load("ts_mask").ts_encode_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_float, ctypes.c_longlong, i, p, p, p, p,
                   p, p, p]
    fn.restype = ctypes.c_int
    return fn


def ts_encode(x: torch.Tensor, tau: float, capacity: int):
    """Launch the CUDA kernel on the current stream: x (T, D) → (below,
    values, indices, count) as in the module docstring, with the contract
    of :func:`ts_encode_ref`, bit for bit. Its state and workspace come
    from ``kernels.tickets.scratch`` (the stream's, or a captured call's
    own); no host sync. Raises on any input the kernel does not take;
    there is no fallback. Adds one to ``ts_encode.launches`` per launch."""
    if x.device.type != "cuda":
        raise ValueError(f"ts_encode launches a CUDA kernel; x is on "
                         f"{x.device} (use kernels.ops for CPU tensors)")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"x must be (T, D), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.numel()
    if n > MAX_N:
        raise ValueError(f"x has {n} entries, more than {MAX_N}")
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    dev = x.device
    below = torch.empty(x.shape, dtype=torch.float32, device=dev)
    values = torch.empty(capacity, dtype=torch.float32, device=dev)
    indices = torch.empty(capacity, dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        state, work = scratch(dev, stream, STATE_WORDS,
                              workspace_floats(n, capacity))
        err = _launcher()(
            x.data_ptr(), int(x.dtype == torch.bfloat16), float(tau), n,
            capacity, below.data_ptr(), values.data_ptr(),
            indices.data_ptr(), count.data_ptr(), state.data_ptr(),
            work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ts_encode kernel launch failed: CUDA error "
                           f"{err}")
    ts_encode.launches += 1
    return below, values, indices, count


ts_encode.launches = 0
