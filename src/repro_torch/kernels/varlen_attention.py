"""Token-packed VARLEN attention through the paged int8 KV pool: the CUDA
kernel's wrapper, its launch count, ``segment_start`` and the plain
PyTorch version.

The kernel (``csrc/varlen_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/varlen_attention.py::varlen_attention``, which carries the
scheduler's packed tick: ONE flat batch of ``T`` token rows, each carrying
its request's slot id (its block-table row) and absolute position, so
decode tokens (length-1 segments) and prefill chunks share one call. Each
row attends two key groups in one softmax:

  * HISTORY: its own slot's pool pages, dequantized, masked to stored
    positions ``0 <= pos < start[slot]`` (the pool is post-update: this
    call's tokens are in it too, and the bound keeps them from counting
    twice);
  * FRESH: the call's own k/v at full precision (widened to f32) under a
    block-diagonal causal mask: key ``c`` counts for row ``r`` when both
    carry the same slot id (>= 0) and ``0 <= q_pos[c] <= q_pos[r]``.

Operands keep the reference's layout:

  q            (K, T, G, hd)     bf16/f32; strides over (K, T) are free,
                                 (G, hd) contiguous (a transposed view of
                                 the model's (T, H, hd) queries)
  k/v_codes    (P, K, page, hd)  int8     k/v_scale (P, K, page) f32
  pool_pos     (P, page)         int32
  block_table  (R, nb)           int32
  q_pos        (T,)              int32    per-token positions (-1 = pad)
  tok_slot     (T,)              int32    per-token slot ids (-1 = pad)
  start        (R,)              int32    :func:`segment_start`
  k/v_fresh    (K, T, hd)        q's dtype; strides over (K, T) free
  out          (K, T, G, hd)     f32, laid out as q is

A row with slot -1, or with no valid key, gives EXACT zeros. Slot ids
must be below R.

What bounds it on an H100: ``4·hd`` flops per (query row, valid key)
against each needed history page read once. A row needs only its own
slot's keys (the TPU kernel sets every row against every page of every
slot). :func:`route` picks the kernel from q's dtype, hd, T and alignment
before the launch:

  * ``"tensor_cores"`` (bf16 q, the main path): a work list built on the
    device (:func:`segment_rows`; the packed step builds it once per tick
    in ``layers.packed_layout``) orders the buffer's rows by slot. A
    segment of several rows (a prefill chunk) runs K3's tensor-core
    arithmetic in tiles of 64 of its query rows, reading its history once
    a tile; a one-row segment (a decode row) walks its history on the CUDA
    cores in splits of ``DECODE_SPLIT`` keys over several blocks, merged
    in a fixed order by a second kernel. Bound by the history's bytes at
    the serving tick. The grid depends on shapes only, and nothing is read
    back to the host;
  * ``"cuda_cores"`` (f32 q, and any shape the first does not take): one
    block takes 32 query rows of one kv-head and ONE slot among them and
    walks that slot's history and the fresh-key tiles holding its keys,
    f32 on the CUDA cores; bound by operations.
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
from repro_torch.kernels.paged_prefill_attention import (NO_CALL_POSITION,
                                                         TC_HEAD_DIMS)

TC_MAX_T = 32768  # the tensor-core kernel's fresh-tile mask covers T rows
# history keys of a decode split, by head dim (the tensor-core route)
DECODE_SPLIT = {32: 256, 64: 256, 128: 256, 256: 128}
ROUTES = ("tensor_cores", "cuda_cores")


def segment_start(q_pos: torch.Tensor, tok_slot: torch.Tensor,
                  num_slots: int) -> torch.Tensor:
    """``start`` (R,) int32 from the flat per-token operands: each slot's
    FIRST in-call position, ``2^30`` for a slot with no token in the call
    (which every mask then neutralizes). Computed on the tensors' device
    (no host sync). Pads (slot or position -1) and slot ids past
    ``num_slots`` change nothing, as the reference's dropped scatter."""
    q_pos = q_pos.reshape(-1).to(torch.int32)
    sl = tok_slot.reshape(-1).to(torch.int64)
    ok = (sl >= 0) & (sl < num_slots) & (q_pos >= 0)
    vals = torch.where(ok, q_pos, NO_CALL_POSITION)
    out = torch.full((num_slots,), NO_CALL_POSITION, dtype=torch.int32,
                     device=q_pos.device)
    return out.scatter_reduce(0, torch.where(ok, sl, 0), vals, "amin")


def segment_rows(tok_slot: torch.Tensor, num_slots: int) -> torch.Tensor:
    """The tensor-core route's work list, (T + 2·(R + 1),) int32 on
    ``tok_slot``'s device (no host sync): the buffer's rows ordered by slot,
    each segment's rows in buffer order (a segment need not be
    contiguous), pads and slot ids outside [0, R) last as slot R; then
    each slot's first index into that order, then its row count."""
    sl = tok_slot.reshape(-1).to(torch.int64)
    t = sl.numel()
    key = torch.where((sl >= 0) & (sl < num_slots), sl, num_slots)
    # one key a row, unique (slot, then place in the buffer), so any sort
    # keeps a segment's rows in buffer order
    order = torch.sort(key * t + torch.arange(t, device=sl.device)).values % t
    count = torch.zeros(num_slots + 1, dtype=torch.int64,
                        device=sl.device).scatter_add_(
        0, key, torch.ones_like(key))
    first = torch.cumsum(count, 0) - count
    return torch.cat([order, first, count]).to(torch.int32)


def route(dtype: torch.dtype, hd: int, t: int, *alignments: int) -> str:
    """The kernel a call takes (one of ``ROUTES``) from q's dtype, the head
    dim, the buffer's T rows, and the byte addresses and strides the
    tensor-core kernel reads 16 bytes at a time (q's and the codes' and
    fresh k/v's bases, q's and the fresh k/v's (K, T) strides): by shape,
    not a fallback (a launch that fails raises)."""
    if dtype == torch.bfloat16 and hd in TC_HEAD_DIMS and t <= TC_MAX_T \
            and all(a % 16 == 0 for a in alignments):
        return "tensor_cores"
    return "cuda_cores"


def varlen_attention_ref(q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                         block_table, q_pos, tok_slot, start, k_fresh,
                         v_fresh):
    """Plain PyTorch version (``repro/kernels/ref.py::varlen_attention_ref``
    in one softmax over every slot's history and the fresh keys): scores
    against every slot's gathered, dequantized pages, a history key
    counting only for rows of its own slot below ``start[slot]``, and the
    fresh keys under the block-diagonal causal mask; a row with no valid
    key gives zeros. The oracle gathers each ROW's slot history, (T, K,
    nb·page, hd) floats; scoring every slot instead keeps the operands at
    (R, K, nb·page, hd), which the main path's shape needs. Returns
    (K, T, G, hd) f32."""
    kh, t, g, hd = q.shape
    r = block_table.shape[0]
    k_hist = gather_pages(k_codes, block_table).float() \
        * gather_pages(k_scale, block_table)[..., None]  # (R, K, Sp, hd)
    v_hist = gather_pages(v_codes, block_table).float() \
        * gather_pages(v_scale, block_table)[..., None]
    hist_pos = gather_pages(pool_pos, block_table)  # (R, Sp)
    sp = hist_pos.shape[1]
    ok_hist = (hist_pos >= 0) & (hist_pos < start[:, None])  # (R, Sp)
    own = tok_slot[:, None] == torch.arange(r, device=q.device)  # (T, R)
    valid_hist = own[:, :, None] & ok_hist[None]  # (T, R, Sp)
    valid_fresh = ((tok_slot[None, :] == tok_slot[:, None])
                   & (tok_slot[None, :] >= 0) & (q_pos[None, :] >= 0)
                   & (q_pos[None, :] <= q_pos[:, None]))  # (T, T)
    valid = torch.cat([valid_hist.reshape(t, r * sp), valid_fresh], dim=1)
    k_all = torch.cat([k_hist.transpose(0, 1).reshape(kh, r * sp, hd),
                       k_fresh.float()], dim=1)  # (K, R·Sp + T, hd)
    v_all = torch.cat([v_hist.transpose(0, 1).reshape(kh, r * sp, hd),
                       v_fresh.float()], dim=1)
    s = torch.einsum("ktgd,ked->ktge", q.float() / (hd ** 0.5), k_all)
    s = torch.where(valid[None, :, None, :], s, NEG_INF)
    out = torch.einsum("ktge,ked->ktgd", torch.softmax(s, dim=-1), v_all)
    return torch.where(valid.any(dim=-1)[None, :, None, None], out, 0.0)


@functools.cache
def _launcher():
    fn = build.load("varlen_attention").varlen_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, i, ctypes.c_float, ll, ll, p, p, p, p, p, p, p, p, p,
                   p, p, ll, ll, p, ll, ll, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tc_launcher():
    fn = build.load("varlen_attention").varlen_attention_tc_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ctypes.c_float, ll, ll, p, p, p, p, p, p, p, p, p, p,
                   p, ll, ll, p, ll, ll, p, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
           q_pos, tok_slot, start, k_fresh, v_fresh):
    if q.dim() != 4 or q.dtype not in (torch.float32, torch.bfloat16) \
            or q.stride(3) != 1 \
            or (q.shape[2] > 1 and q.stride(2) != q.shape[3]):
        raise ValueError(f"q must be a (K, T, G, hd) f32 or bf16 tensor with "
                         f"(G, hd) contiguous, got {tuple(q.shape)} "
                         f"{q.dtype} strides {q.stride()}")
    kh, t, _, hd = q.shape
    r = block_table.shape[0] if block_table.dim() == 2 else -1
    check_pool(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
               r, kh, hd)
    want = {"q_pos": (q_pos, torch.int32, (t,)),
            "tok_slot": (tok_slot, torch.int32, (t,)),
            "start": (start, torch.int32, (r,))}
    for name, (x, dtype, shape) in want.items():
        if not isinstance(x, torch.Tensor) or x.device != q.device \
                or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape} on q's device")
    for name, x in (("k_fresh", k_fresh), ("v_fresh", v_fresh)):
        if not isinstance(x, torch.Tensor) or x.device != q.device \
                or x.dtype != q.dtype or tuple(x.shape) != (kh, t, hd) \
                or x.stride(2) != 1:
            raise ValueError(f"{name} must be a (K, T, hd) = {(kh, t, hd)} "
                             f"tensor of q's dtype on q's device with hd "
                             f"contiguous")
    if k_fresh.stride() != v_fresh.stride():
        raise ValueError("k_fresh and v_fresh must share strides")
    check_on_card("varlen_attention", q)


def varlen_attention(q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                     block_table, q_pos, tok_slot, start, k_fresh, v_fresh,
                     rows=None):
    """Launch the CUDA kernel on the current stream (see the module
    docstring for shapes). ``rows`` is :func:`segment_rows`'s work list,
    built here on the device when not given. Raises on any input the kernel
    does not take; there is no fallback. Adds one to
    ``varlen_attention.launches`` per call and to the route's count in
    ``varlen_attention.route_launches``."""
    _check(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
           q_pos, tok_slot, start, k_fresh, v_fresh)
    kh, t, g, hd = q.shape
    r = block_table.shape[0]
    # laid out as q is (preserve_format keeps a dense view's strides)
    out = torch.empty_like(q, dtype=torch.float32)
    el = q.element_size()
    way = route(q.dtype, hd, t, q.data_ptr(), k_codes.data_ptr(),
                v_codes.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr(),
                q.stride(0) * el, q.stride(1) * el, k_fresh.stride(0) * el,
                k_fresh.stride(1) * el)
    if way == "tensor_cores":
        if rows is None:
            rows = segment_rows(tok_slot, r)
        elif not isinstance(rows, torch.Tensor) or rows.device != q.device \
                or rows.dtype != torch.int32 \
                or tuple(rows.shape) != (t + 2 * (r + 1),) \
                or not rows.is_contiguous():
            raise ValueError(f"rows must be segment_rows' contiguous int32 "
                             f"({t + 2 * (r + 1)},) work list on q's device")
        splits = -(-block_table.shape[1] * k_codes.shape[2]
                   // DECODE_SPLIT[hd])
        part = torch.empty((r * splits * kh * g * (hd + 2),),
                           dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            err = _tc_launcher()(
                q.data_ptr(), 1.0 / hd ** 0.5, q.stride(0), q.stride(1),
                k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
                v_scale.data_ptr(), pool_pos.data_ptr(),
                block_table.data_ptr(), q_pos.data_ptr(), start.data_ptr(),
                rows.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr(),
                k_fresh.stride(0), k_fresh.stride(1), out.data_ptr(),
                out.stride(0), out.stride(1), part.data_ptr(), t, kh, g, hd,
                k_codes.shape[2], block_table.shape[1], r, splits,
                torch.cuda.current_stream(q.device).cuda_stream)
        _count(way, err)
        return out
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5,
            q.stride(0), q.stride(1), k_codes.data_ptr(), k_scale.data_ptr(),
            v_codes.data_ptr(), v_scale.data_ptr(), pool_pos.data_ptr(),
            block_table.data_ptr(), q_pos.data_ptr(), tok_slot.data_ptr(),
            start.data_ptr(), k_fresh.data_ptr(), v_fresh.data_ptr(),
            k_fresh.stride(0), k_fresh.stride(1), out.data_ptr(),
            out.stride(0), out.stride(1), t, kh, g, hd, k_codes.shape[2],
            block_table.shape[1], block_table.shape[0],
            torch.cuda.current_stream(q.device).cuda_stream)
    _count(way, err)
    return out


def _count(way: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"varlen_attention kernel launch failed ({way}): "
                           f"CUDA error {err}")
    varlen_attention.launches += 1
    varlen_attention.route_launches[way] += 1


varlen_attention.launches = 0
varlen_attention.route_launches = dict.fromkeys(ROUTES, 0)
