"""Prefill attention THROUGH the paged int8 KV pool: the CUDA kernel's
wrapper, its launch count, and its plain PyTorch version.

The kernel (``csrc/paged_prefill_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/paged_prefill_attention.py::paged_prefill_attention``
(continuation chunks and shared-prefix forks). Each query attends two key
groups in one softmax:

  * HISTORY: its row's pool pages, dequantized, masked to stored positions
    ``0 <= pos < start[r]`` (and ``pos <= q_pos``). The pool is the
    post-update pool, so this call's own tokens are in the pages too; the
    ``start`` bound keeps them from being counted twice;
  * FRESH: the call's own k/v at full precision (widened to f32), causal by
    ``q_pos``.

Operands take the model's own layout, so no transpose is launched:

  q            (R, S, K, G, hd)  bf16/f32 (the (R, S, H, hd) queries)
  k/v_codes    (P, K, page, hd)  int8     k/v_scale (P, K, page) f32
  pool_pos     (P, page)         int32
  block_table  (R, nb)           int32
  q_pos        (R, S)            int32    per-token positions (-1 = pad)
  start        (R,)              int32    first in-call position
                                          (:func:`first_call_position`)
  k/v_fresh    (R, S, K, hd)     q's dtype
  out          (R, S, K, G, hd)  f32

A query with no valid key (a pad column, an inactive row) gives EXACT
zeros. History is walked only over logical slots below
``min(start, max q_pos + 1)``: page ``b`` holds positions
``[b·page, (b+1)·page)``.

What bounds it on an H100: ``4·hd`` flops per (query row, valid key),
each needed history page read once per row, the f32 output written once.
:func:`route` picks the kernel from q's dtype, hd, S and alignment before
the launch:

  * ``"tensor_cores"`` (bf16 q, the main path): Q·Kᵀ and P·V on the bf16
    tensor cores (int8 codes and bf16 operands are exact there), 64 query
    rows a block, key tiles through a two-stage ``cp.async`` ring; P
    carried as hi + lo bf16. A serving chunk is then bound by its bytes;
  * ``"cuda_cores"`` (f32 q, and any shape the first does not take): f32
    FMAs on the CUDA cores, 32 query rows a block; bound by operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.kernels.paged_decode_attention import (check_on_card,
                                                        check_pool,
                                                        gather_pages)

NO_CALL_POSITION = 2 ** 30  # start of a row with no in-call token
TC_HEAD_DIMS = (32, 64, 128, 256)  # the tensor-core kernel's templates
TC_MAX_S = 32768  # its fresh-tile mask covers this many tokens a row
ROUTES = ("tensor_cores", "cuda_cores")


def first_call_position(q_pos: torch.Tensor) -> torch.Tensor:
    """``start`` (R,) int32 from per-token positions (R, S): each row's
    first in-call position, ``2^30`` for a fully padded row (which every
    mask then neutralizes)."""
    return torch.where(q_pos >= 0, q_pos,
                       NO_CALL_POSITION).amin(dim=1).to(torch.int32)


def paged_prefill_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                                pool_pos, block_table, q_pos, start,
                                k_fresh, v_fresh):
    """Plain PyTorch version (``repro/kernels/ref.py::
    paged_prefill_attention_ref`` in the model's layout): gather the pool
    dense, dequantize, append the fresh keys, mask, softmax; a query with no
    valid key gives zeros. Returns (R, S, K, G, hd) f32."""
    hd = q.shape[-1]
    k_hist = gather_pages(k_codes, block_table).float() \
        * gather_pages(k_scale, block_table)[..., None]  # (R, K, Sp, hd)
    v_hist = gather_pages(v_codes, block_table).float() \
        * gather_pages(v_scale, block_table)[..., None]
    hist_pos = gather_pages(pool_pos, block_table)  # (R, Sp)
    k_all = torch.cat([k_hist, k_fresh.float().transpose(1, 2)], dim=2)
    v_all = torch.cat([v_hist, v_fresh.float().transpose(1, 2)], dim=2)
    ok_hist = (hist_pos >= 0) & (hist_pos < start[:, None])
    kv_pos = torch.cat([torch.where(ok_hist, hist_pos, -1), q_pos], dim=1)
    s = torch.einsum("rskgd,rked->rskge", q.float() / (hd ** 0.5), k_all)
    valid = (kv_pos[:, None, :] >= 0) & (
        kv_pos[:, None, :] <= q_pos[:, :, None])  # (R, S, Skv)
    s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
    out = torch.einsum("rskge,rked->rskgd", torch.softmax(s, dim=-1), v_all)
    return torch.where(valid.any(dim=-1)[:, :, None, None, None], out, 0.0)


@functools.cache
def _launcher():
    fn = build.load("paged_prefill_attention").paged_prefill_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_float, p, p, p, p, p, p, p, p, p, p, p,
                   i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tc_launcher():
    lib = build.load("paged_prefill_attention")
    fn = lib.paged_prefill_attention_tc_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_float, p, p, p, p, p, p, p, p, p, p, p,
                   i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def route(dtype: torch.dtype, hd: int, s: int, *addresses: int) -> str:
    """The kernel a call takes (one of ``ROUTES``) from q's dtype, the head
    dim, the tokens a row and the base addresses of q, the codes and the
    fresh k/v: by shape, not a fallback (a launch that fails raises)."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and s <= TC_MAX_S \
            and all(a % 16 == 0 for a in addresses):
        return "tensor_cores"
    return "cuda_cores"


def _check(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
           q_pos, start, k_fresh, v_fresh):
    if q.dim() != 5 or q.dtype not in (torch.float32, torch.bfloat16) \
            or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (R, S, K, G, hd) f32 or "
                         f"bf16 tensor, got {tuple(q.shape)} {q.dtype}")
    r, s, kh, _, hd = q.shape
    check_pool(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
               r, kh, hd)
    want = {"q_pos": (q_pos, torch.int32, (r, s)),
            "start": (start, torch.int32, (r,)),
            "k_fresh": (k_fresh, q.dtype, (r, s, kh, hd)),
            "v_fresh": (v_fresh, q.dtype, (r, s, kh, hd))}
    for name, (t, dtype, shape) in want.items():
        if not isinstance(t, torch.Tensor) or t.device != q.device \
                or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape} on q's device")
    check_on_card("paged_prefill_attention", q)


def paged_prefill_attention(q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                            block_table, q_pos, start, k_fresh, v_fresh):
    """Launch the CUDA kernel on the current stream (see the module
    docstring for shapes). Raises on any input the kernel does not take;
    there is no fallback. Adds one to ``paged_prefill_attention.launches``
    per launch and to the route's count in ``paged_prefill_attention.
    route_launches``."""
    _check(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
           q_pos, start, k_fresh, v_fresh)
    r, s, kh, g, hd = q.shape
    out = torch.empty((r, s, kh, g, hd), dtype=torch.float32,
                      device=q.device)
    way = route(q.dtype, hd, s, q.data_ptr(), k_codes.data_ptr(),
                v_codes.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr())
    rest = (1.0 / hd ** 0.5, k_codes.data_ptr(), k_scale.data_ptr(),
            v_codes.data_ptr(), v_scale.data_ptr(), pool_pos.data_ptr(),
            block_table.data_ptr(), q_pos.data_ptr(), start.data_ptr(),
            k_fresh.data_ptr(), v_fresh.data_ptr(), out.data_ptr(), r, s, kh,
            g, hd, k_codes.shape[2], block_table.shape[1],
            torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        if way == "tensor_cores":
            err = _tc_launcher()(q.data_ptr(), *rest)
        else:
            err = _launcher()(q.data_ptr(), int(q.dtype == torch.bfloat16),
                              *rest)
    if err != 0:
        raise RuntimeError(f"paged_prefill_attention kernel launch failed "
                           f"({way}): CUDA error {err}")
    paged_prefill_attention.launches += 1
    paged_prefill_attention.route_launches[way] += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.route_launches = dict.fromkeys(ROUTES, 0)
