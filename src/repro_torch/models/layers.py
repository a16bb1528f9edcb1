"""Model building blocks (port of ``repro/models/layers.py``): RMSNorm,
rotary embeddings (M-RoPE's per-axis bands too), the sinusoidal absolute
embedding, the KV caches and their int8 writes (sliding-window layers into
a ring), position-masked prefill attention with windows and logit soft
caps, int8-KV decode attention through the CUDA kernels (dense and paged),
prefill attention through the paged pool (or the pool gathered dense),
token-packed varlen attention, the attention layer (with QK-norm) and the
(gated) MLP.

Caches come in three layouts, as in the reference:
  * fp (bf16/f32): token-major (B, S, K, hd), read by ``chunked_attention``;
  * int8-quantized: kv-head-major (B, K, S, hd) codes + per-(token, head)
    f32 scales (B, K, S), the layout the decode kernel streams;
  * paged (:class:`PagedKVCache`): one layer's view of the shared pool,
    page-major (P, K, page, hd) codes addressed through block tables.

Shapes: activations (B, S, D); q/k/v (B, S, H|K, hd). Weights keep the
reference's ``x @ W`` layout, W (d_in, d_out); a weight held as int8 or int16
codes with per-output-channel scales (``core.quant.QuantizedTensor``, the
split engine's edge segment) goes through the integer-weight kernel K7
(:func:`matmul`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import ops

NEG_INF = -1e30


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for x (..., d_in). A dense ``w`` (d_in, d_out) is a plain
    product; a :class:`QuantizedTensor` of codes (d_in, d_out) with one
    scale per output column (int8 codes up to 8 bits, int16 from 9 to 15)
    goes through ``kernels.ops.dequant_matmul`` (K7 on the card, its plain
    version on the CPU), summed in f32 and cast back to x's dtype. The
    dequantized weight is never built."""
    if not isinstance(w, QuantizedTensor):
        return x @ w
    k, n = w.codes.shape
    out = ops.dequant_matmul(x.reshape(-1, k).contiguous(), w.codes,
                             w.scale.reshape(n))
    return out.to(x.dtype).reshape(*x.shape[:-1], n)


# ---------------------------------------------------------------------------
# Norms and position encodings
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32, multiplied by ``w``, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rope_table(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions (..., S) → (cos, sin) of shape (..., S, dim//2), f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_tables(positions_thw: torch.Tensor, dim: int, sections: tuple,
                 theta: float = 10000.0):
    """Qwen2-VL's M-RoPE (the reference's ``mrope_tables``):
    ``positions_thw`` (3, B, S) temporal, height and width ids;
    ``sections`` splits the dim//2 frequencies into one band an axis, e.g.
    (16, 24, 24). Returns (cos, sin) (B, S, dim//2) f32, band a taking its
    angles from axis a's ids."""
    assert sum(sections) == dim // 2
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions_thw.device) / dim
    freqs = 1.0 / (theta ** exps)
    cos, sin, start = [], [], 0
    for axis, sec in enumerate(sections):
        ang = positions_thw[axis].float()[..., None] \
            * freqs[start:start + sec]
        cos.append(torch.cos(ang))
        sin.append(torch.sin(ang))
        start += sec
    return torch.cat(cos, -1), torch.cat(sin, -1)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """The classic absolute embedding (MusicGen): positions (...) →
    (..., dim) f32, sines then cosines of ``dim // 2`` frequencies
    ``10000^(-i / (dim // 2))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd//2) or (S, hd//2). Rotates the
    two halves of each head (not interleaved pairs), in f32."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1).to(dt)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """One attention layer's cache. ``k``/``v`` are fp tensors in
    token-major (B, S, K, hd) layout, or int8 codes in kv-head-major
    (B, K, S, hd) layout with per-(token, head) scales (B, K, S). ``pos``
    (B, S) int32 holds the absolute position stored in each slot, -1 for
    an empty one."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None
    v_scale: torch.Tensor | None
    pos: torch.Tensor

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


@dataclasses.dataclass
class PagedKVCache:
    """One layer's view of the shared paged KV pool
    (``serving.kv_pool.PagedKVPool`` owns allocation):

      k / v        (P, K, page, hd) int8    k/v_scale (P, K, page) f32
      pos          (P, page) int32          (-1 = empty slot)
      block_table  (R, nb) int32            page ids of each call row; 0 is
                                            the reserved trash page

    The leaves are views into the pool's tensors, so a write through this
    cache (:func:`paged_cache_update`) lands in the pool IN PLACE; the
    reference's functional pool instead returns new arrays."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor
    pos: torch.Tensor
    block_table: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[-2]


def init_cache(batch: int, size: int, kv_heads: int, head_dim: int,
               dtype=torch.bfloat16, quantized: bool = False,
               device=None) -> KVCache:
    pos = torch.full((batch, size), -1, dtype=torch.int32, device=device)
    if quantized:  # kv-head-major kernel layout
        shape = (batch, kv_heads, size, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            pos=pos)
    shape = (batch, size, kv_heads, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), None, None,
                   pos)


def _quantize_kv(x: torch.Tensor):
    """Symmetric int8 per (token, head) over the last axis. Divides by the
    scale (not by multiplying with its reciprocal) and rounds half to even,
    so the codes and scales are bit-identical to the reference's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos, window: int | None = None) -> KVCache:
    """Write ``k_new``/``v_new`` (B, S_new, K, hd) at absolute positions
    ``pos .. pos + S_new - 1`` (``pos`` an int or a 0-d int32 tensor on the
    cache's device, so a decode loop never reads it back to the host).

    Unlike the reference, which returns a new cache, this writes the
    cache's tensors IN PLACE (``index_copy_``) and returns the same cache.
    Quantized caches are written in the kernel's kv-head-major layout, the
    slot axis being 2 instead of 1.

    With ``window`` the cache is a ring of ``size = min(window, slots)``
    slots: position p lands at slot ``p % size``, and a write of ``size``
    tokens or more keeps only its last ``size``. Slots past ``size`` (the
    quantized cache's block padding) are never written and keep pos = -1,
    so the ring holds exactly the positions ``(p - size, p]`` after a write
    that ends at p."""
    s_new = k_new.shape[1]
    size = cache.pos.shape[1]
    if window is not None:
        size = min(window, size)
        if s_new >= size:  # only the last ``size`` tokens survive
            k_new, v_new = k_new[:, s_new - size:], v_new[:, s_new - size:]
            pos = pos + (s_new - size)
            s_new = size
    abs_pos = torch.arange(s_new, dtype=torch.int64,
                           device=cache.pos.device) + pos
    idx = abs_pos if window is None else abs_pos % size
    if cache.quantized:
        kc, ks = _quantize_kv(k_new)  # (B, S_new, K, hd), (B, S_new, K, 1)
        vc, vs = _quantize_kv(v_new)
        cache.k.index_copy_(2, idx, kc.transpose(1, 2))
        cache.v.index_copy_(2, idx, vc.transpose(1, 2))
        cache.k_scale.index_copy_(2, idx, ks[..., 0].transpose(1, 2))
        cache.v_scale.index_copy_(2, idx, vs[..., 0].transpose(1, 2))
    else:
        cache.k.index_copy_(1, idx, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, idx, v_new.to(cache.v.dtype))
    b = cache.pos.shape[0]
    cache.pos.index_copy_(1, idx, abs_pos.to(torch.int32).expand(b, s_new))
    return cache


def paged_cache_update(cache: PagedKVCache, k_new: torch.Tensor,
                       v_new: torch.Tensor, positions: torch.Tensor,
                       slots: torch.Tensor | None = None) -> None:
    """Scatter ``k_new``/``v_new`` (R, S_new, K, hd) into the shared pool IN
    PLACE (the reference returns a new pool).

    ``positions`` (R, S_new) int32 are each token's absolute position. A
    token lands at page ``block_table[r, p // page]``, slot ``p % page``.
    Pads (negative positions), positions past the table's reach and
    positions whose table entry is still 0 (page not yet allocated) go to
    the trash page 0, slot 0, with ``pos = -1``: those duplicate writes
    race, which is harmless because every one stores ``pos = -1``, and no
    valid token ever lands on page 0. Codes and scales are
    :func:`_quantize_kv`'s, bit-identical to the reference's.

    ``slots`` (R, S_new) int32 switches to the SEGMENT-AWARE scatter of the
    packed tick: each token's block-table row is its own slot id rather
    than its batch row (the packed call's batch is one flat row whose
    tokens span many requests); a token with slot -1 is a pad."""
    page = cache.page_size
    nbt = cache.block_table.shape[1]
    valid = (positions >= 0) & (positions < nbt * page)
    page_idx = torch.where(valid, positions // page, 0).long()
    if slots is None:
        pages = torch.gather(cache.block_table, 1, page_idx)
    else:
        valid = valid & (slots >= 0)
        pages = cache.block_table[slots.clamp(min=0).long(), page_idx]
    pages = torch.where(valid, pages, 0)
    valid = valid & (pages != 0)
    pr = pages.reshape(-1).long()
    sl = torch.where(valid, positions % page, 0).reshape(-1).long()
    kc, ks = _quantize_kv(k_new)  # (R, S_new, K, hd), (R, S_new, K, 1)
    vc, vs = _quantize_kv(v_new)
    n, kh = pr.shape[0], k_new.shape[2]
    # (P, K, page, ...) viewed as (P, page, K, ...): (page, slot) index
    # pairs then select (N, K, ...) values, the reference's buf[pr, :, sl]
    cache.k.transpose(1, 2).index_put_((pr, sl), kc.reshape(n, kh, -1))
    cache.v.transpose(1, 2).index_put_((pr, sl), vc.reshape(n, kh, -1))
    cache.k_scale.transpose(1, 2).index_put_((pr, sl), ks.reshape(n, kh))
    cache.v_scale.transpose(1, 2).index_put_((pr, sl), vs.reshape(n, kh))
    cache.pos.index_put_((pr, sl), torch.where(valid, positions,
                                               -1).reshape(-1).to(torch.int32))


# ---------------------------------------------------------------------------
# Prefill attention (plain PyTorch, online softmax over KV chunks)
# ---------------------------------------------------------------------------


def soft_cap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    """``cap · tanh(scores / cap)``, the logit soft cap (gemma2); None
    leaves the scores as they are."""
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def chunked_attention(q, k, v, q_pos, kv_pos, *, window: int | None = None,
                      softcap: float | None = None, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Causal, position-masked attention (the reference's
    ``chunked_attention``): q (B, Sq, H, hd), k/v (B, Skv, K, hd), q_pos
    (B, Sq), kv_pos (B, Skv) with -1 = invalid. A key is attended when
    ``0 <= kv_pos <= q_pos`` and, with ``window``, ``kv_pos > q_pos -
    window``; ``softcap`` caps the scaled scores (:func:`soft_cap`) before
    the mask. Query chunks of ``q_chunk`` walk key chunks of ``kv_chunk``
    with an online softmax, so no (Sq, Skv) score tensor larger than one
    chunk pair exists. Scores and sums are f32; the result has q's dtype.
    Query head ``h`` reads kv-head ``h // G``. A query with no valid key
    gets the uniform average of the Skv values (the reference's chunked
    walk pads the keys to whole chunks and averages over those pads too;
    dense prefill never has such a query)."""
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = (q * (1.0 / math.sqrt(hd))).float().reshape(b, sq, kh, g, hd)
    out = torch.empty((b, sq, kh, g, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, q_chunk):
        qb = qf[:, q0:q0 + q_chunk]  # (B, qc, K, G, hd)
        qp = q_pos[:, q0:q0 + q_chunk]
        qc = qb.shape[1]
        m = torch.full((b, kh, g, qc), NEG_INF, device=q.device)
        l = torch.zeros((b, kh, g, qc), device=q.device)
        acc = torch.zeros((b, kh, g, qc, hd), device=q.device)
        for k0 in range(0, skv, kv_chunk):
            kb = k[:, k0:k0 + kv_chunk].float()
            vb = v[:, k0:k0 + kv_chunk].float()
            kp = kv_pos[:, k0:k0 + kv_chunk][:, None, None, None, :]
            s = soft_cap(torch.einsum("bqkgd,bckd->bkgqc", qb, kb), softcap)
            qpc = qp[:, None, None, :, None]
            mask = (kp >= 0) & (kp <= qpc)
            if window is not None:
                mask &= kp > qpc - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqc,bckd->bkgqd",
                                                       p, vb)
            m = m_new
        res = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, K, G, qc, hd)
        out[:, q0:q0 + qc] = res.permute(0, 3, 1, 2, 4)
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Quantized-cache decode attention (the CUDA kernel)
# ---------------------------------------------------------------------------


def quantized_decode_attention(q, cache: KVCache, spec, q_positions, pos, *,
                               q_chunk: int = 1024, kv_chunk: int = 1024):
    """Decode-time attention over the kv-head-major int8 cache. A
    single-token query of a layer without a logit soft cap streams the
    codes through the decode kernel (``kernels.ops.decode_attention``: the
    CUDA kernel on the card, its plain version on the CPU). Sliding-window
    layers take it too: their ring holds only positions inside the window,
    so the kernel's position mask is the window's, and every ring slot lies
    below ``q_pos`` once it has wrapped (the kernel's slot contract).
    Soft-capped layers (gemma2) and longer queries dequantize the cache and
    take ``chunked_attention`` with the layer's window and cap, as the
    reference does."""
    b, s, h, hd = q.shape
    kh = cache.k.shape[1]
    if s == 1 and spec.attn_softcap is None:
        qh = q[:, 0].reshape(b, kh, h // kh, hd)
        out = ops.decode_attention(qh, cache.k, cache.k_scale, cache.v,
                                   cache.v_scale, cache.pos, pos)
        return out.reshape(b, 1, h, hd).to(q.dtype)
    k = (cache.k.float() * cache.k_scale[..., None]).transpose(1, 2)
    v = (cache.v.float() * cache.v_scale[..., None]).transpose(1, 2)
    return chunked_attention(q, k, v, q_positions, cache.pos,
                             window=spec.sliding_window,
                             softcap=spec.attn_softcap, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)


def _gather_dense_kv(cache: PagedKVCache):
    """The pool gathered dense through the block table and dequantized
    (the reference's ``_gather_dense_kv``): (k, v) (R, S_pool, K, hd) f32
    token-major, and kv_pos (R, S_pool)."""
    bt = cache.block_table
    kd, vd = ops.gather_pages(cache.k, bt), ops.gather_pages(cache.v, bt)
    ks = ops.gather_pages(cache.k_scale, bt)  # (R, K, Sp)
    vs = ops.gather_pages(cache.v_scale, bt)
    k = (kd.float() * ks[..., None]).transpose(1, 2)
    v = (vd.float() * vs[..., None]).transpose(1, 2)
    return k, v, ops.gather_pages(cache.pos, bt)


def paged_prefill_attention(q, cache: PagedKVCache, k_fresh, v_fresh, spec,
                            q_positions, *, q_chunk: int = 1024,
                            kv_chunk: int = 1024, use_kernel: bool = True):
    """Prefill attention THROUGH the paged pool (continuation chunks and
    shared-prefix forks): each row attends its pool history, masked to
    stored positions below its first in-call position, plus the call's
    fresh k/v (R, S, K, hd) at full precision, causally by ``q_positions``
    (R, S). ``cache`` is the post-update pool. q (R, S, H, hd) is read in
    place as (R, S, K, G, hd) by ``kernels.ops.paged_prefill_attention``
    (the CUDA kernel on the card, its plain version on the CPU).

    A soft-capped or windowed layer, or ``use_kernel=False``
    (``RuntimeOpts.paged_prefill_kernel``), takes the reference's
    dense-gather route instead: the pool gathered dense and dequantized
    (:func:`_gather_dense_kv`), the fresh keys appended, then
    :func:`chunked_attention` with the layer's window and cap. Only the
    option or the layer's spec chooses that route, never a kernel's
    failure."""
    if use_kernel and spec.attn_softcap is None \
            and spec.sliding_window is None:
        b, s, h, hd = q.shape
        kh = cache.k.shape[1]
        out = ops.paged_prefill_attention(
            q.reshape(b, s, kh, h // kh, hd), cache.k, cache.k_scale,
            cache.v, cache.v_scale, cache.pos, cache.block_table,
            q_positions, k_fresh, v_fresh)
        return out.reshape(b, s, h, hd).to(q.dtype)
    k_hist, v_hist, hist_pos = _gather_dense_kv(cache)
    start = ops.first_call_position(q_positions)  # (R,) history bound
    hist_pos = torch.where(hist_pos < start[:, None], hist_pos, -1)
    k = torch.cat([k_hist, k_fresh.float()], dim=1)
    v = torch.cat([v_hist, v_fresh.float()], dim=1)
    kv_pos = torch.cat([hist_pos, q_positions.to(hist_pos.dtype)], dim=1)
    return chunked_attention(q, k, v, q_positions, kv_pos,
                             window=spec.sliding_window,
                             softcap=spec.attn_softcap, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)


def paged_decode_attention_layer(q, cache: PagedKVCache, spec, q_positions,
                                 *, q_chunk: int = 1024,
                                 kv_chunk: int = 1024):
    """Decode-time attention through the paged pool, ``cache`` being the
    post-update pool: every key, the call's own included, is read back
    from the pool's int8 codes (``kernels.ops.paged_decode_attention``,
    kernel K2 on the card, its plain version on the CPU).

    ``q`` (R, S, H, hd) and ``q_positions`` (R, S): each (row, column) is
    one K2 query row with causal bound ``q_positions[r, j]`` over row r's
    block-table row. With S = 1 that is the decode step; with S > 1 it is
    the speculative verify, whose column j reads exactly what the j-th of
    S sequential decode steps reads (the burst was written first, and
    quantization is per token). A bound of -1 (a free slot, a left pad)
    gives zeros. The reference gathers the pool dense for S > 1 and runs
    ``chunked_attention``; K2 reads each row's pages once per column.
    A soft-capped layer takes the reference's dense-gather route at any
    S: the pool gathered dense (:func:`_gather_dense_kv`), then
    :func:`chunked_attention` with the layer's cap."""
    b, s, h, hd = q.shape
    if spec.attn_softcap is not None:
        k, v, kv_pos = _gather_dense_kv(cache)
        return chunked_attention(q, k, v, q_positions, kv_pos,
                                 window=spec.sliding_window,
                                 softcap=spec.attn_softcap, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk)
    kh = cache.k.shape[1]
    bt = cache.block_table
    if s > 1:
        bt = bt.repeat_interleave(s, dim=0)
    out = ops.paged_decode_attention(
        q.reshape(b * s, kh, h // kh, hd).contiguous(), cache.k,
        cache.k_scale, cache.v, cache.v_scale, cache.pos, bt,
        q_positions.reshape(-1).to(torch.int32).contiguous())
    return out.reshape(b, s, h, hd).to(q.dtype)


class PackedLayout(NamedTuple):
    """The layout of a packed step's flat buffer, built once per step by
    :func:`packed_layout` and read by every layer."""

    slots: torch.Tensor  # (1, T) int32: each token's slot, -1 for a pad
    start: torch.Tensor  # (R,) int32: each slot's first in-call position
    quant_rows: torch.Tensor | None  # (D,) int: rows whose fresh k/v
    #                                  take the int8 round trip
    rows: torch.Tensor  # (T + 2(R + 1),) int32: the varlen kernel's work
    #                     list (kernels.ops.segment_rows)


def packed_layout(positions: torch.Tensor, slots: torch.Tensor,
                  num_slots: int, quant_rows=None) -> PackedLayout:
    """A packed step's :class:`PackedLayout` from its (1, T) ``positions``
    and ``slots`` over ``num_slots`` block-table rows (computed on their
    device, no host sync) and the buffer rows ``quant_rows`` (D,) whose
    fresh k/v a layer attends through the int8 round trip (None or empty:
    none)."""
    slots = slots.to(torch.int32)
    return PackedLayout(slots, ops.segment_start(positions, slots,
                                                 num_slots), quant_rows,
                        ops.segment_rows(slots, num_slots))


def varlen_attention_layer(q, cache: PagedKVCache, k_fresh, v_fresh, spec,
                           q_positions, packed: PackedLayout, *,
                           use_kernel: bool = True):
    """Token-packed VARLEN attention through the pool, the packed tick's
    route: ONE flat batch (batch dim 1) whose tokens span many requests,
    q (1, T, H, hd), per-token ``q_positions`` (1, T) and the buffer's
    ``packed`` layout, the call's fresh k/v (1, T, K, hd). Each token
    attends its own slot's pool history (stored positions below the slot's
    first in-call position) and the causally ordered fresh keys of its own
    segment; pad rows (slot -1) give exact zeros. ``cache`` is the
    post-update pool. The operands go to ``kernels.ops.varlen_attention``
    (the CUDA kernel on the card, its plain version on the CPU) as
    (K, T, ...) views of the model's tensors, and the result comes back as
    a view too: nothing is transposed in memory. ``use_kernel=False``
    (``RuntimeOpts.paged_prefill_kernel``) takes the kernel's plain
    version on any device, as the reference takes its dense oracle.
    Softcapped and windowed layers have no varlen route (the reference
    refuses them too)."""
    if spec.attn_softcap is not None or spec.sliding_window is not None:
        raise NotImplementedError(
            "the token-packed varlen path requires kernel-eligible "
            "attention (no softcap, no sliding window)")
    b, t, h, hd = q.shape
    kh = cache.k.shape[1]
    qk = q.reshape(t, kh, h // kh, hd).transpose(0, 1)  # (K, T, G, hd)
    kf = k_fresh.reshape(t, kh, hd).transpose(0, 1)  # (K, T, hd)
    vf = v_fresh.reshape(t, kh, hd).transpose(0, 1)
    args = (qk, cache.k, cache.k_scale, cache.v, cache.v_scale, cache.pos,
            cache.block_table, q_positions.reshape(-1).to(torch.int32),
            packed.slots.reshape(-1), packed.start, kf, vf)
    out = ops.varlen_attention(*args, packed.rows) if use_kernel \
        else ops.varlen_attention_plain(*args)
    return out.transpose(0, 1).reshape(b, t, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention layer and MLP
# ---------------------------------------------------------------------------


def _dequant_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``x`` (1, T, K, hd) with its ``rows`` replaced by their int8 round
    trip (:func:`_quantize_kv`, then dequantized)."""
    codes, scale = _quantize_kv(x[0].index_select(0, rows))
    return x[0].index_copy(0, rows, (codes.float() * scale).to(x.dtype))[None]


def attention_layer(params, x: torch.Tensor, spec, *, rope_cs,
                    cache: KVCache | PagedKVCache | None, pos, q_positions,
                    q_chunk: int = 1024, kv_chunk: int = 1024,
                    decode: bool = False, attend_cache: bool = False,
                    packed: PackedLayout | None = None,
                    prefill_kernel: bool = True):
    """One attention layer (the reference's dense and paged branches).
    During prefill the cache is written and attention runs over the fresh
    k/v; with ``decode=True`` attention reads the cache (for S > 1, the
    speculative verify, every column reads it back, the call's own keys
    included). A paged cache is written at the per-token ``q_positions``;
    with ``attend_cache=True`` a
    paged prefill also attends the pool's history
    (:func:`paged_prefill_attention`); with a ``packed`` layout the call
    is one flat token-packed batch (B = 1), written through the
    segment-aware scatter and attended through
    :func:`varlen_attention_layer`. ``prefill_kernel=False``
    (``RuntimeOpts.paged_prefill_kernel``) sends the paged prefill and the
    packed call to their plain routes (the dense gather, K4's plain
    version); a soft-capped layer gathers the pool dense for its paged
    prefill and decode whatever the option.

    The layout's ``quant_rows`` (the reference's ``quant_fresh`` mask, as
    row indices) name rows whose fresh k/v are attended through the int8
    quantize→dequantize round trip: the values the pool write just stored
    for them, so a packed decode token attends its OWN key as a sequential
    decode step reads it back from the pool. Only those rows are
    quantized; the pool write always uses the original k/v. Returns
    (output, cache)."""
    b, s, _ = x.shape
    h, kh, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
    q = matmul(x, params["wq"]).reshape(b, s, h, hd)
    k = matmul(x, params["wk"]).reshape(b, s, kh, hd)
    v = matmul(x, params["wv"]).reshape(b, s, kh, hd)
    if spec.qk_norm:  # qwen3: RMSNorm over each head, before RoPE
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if rope_cs is not None:
        cos, sin = rope_cs
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if isinstance(cache, PagedKVCache):
        paged_cache_update(cache, k, v, q_positions,
                           slots=None if packed is None else packed.slots)
        if packed is not None:
            k_att, v_att = k, v
            rows = packed.quant_rows
            if rows is not None and rows.numel():
                k_att, v_att = (_dequant_rows(t, rows) for t in (k, v))
            out = varlen_attention_layer(q, cache, k_att, v_att, spec,
                                         q_positions, packed,
                                         use_kernel=prefill_kernel)
        elif decode:
            out = paged_decode_attention_layer(q, cache, spec, q_positions,
                                               q_chunk=q_chunk,
                                               kv_chunk=kv_chunk)
        elif attend_cache:
            out = paged_prefill_attention(q, cache, k, v, spec, q_positions,
                                          q_chunk=q_chunk, kv_chunk=kv_chunk,
                                          use_kernel=prefill_kernel)
        else:
            out = chunked_attention(q, k, v, q_positions, q_positions,
                                    window=spec.sliding_window,
                                    softcap=spec.attn_softcap,
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)
        return matmul(out.reshape(b, s, h * hd), params["wo"]), cache
    attn_kw = dict(window=spec.sliding_window, softcap=spec.attn_softcap,
                   q_chunk=q_chunk, kv_chunk=kv_chunk)
    if cache is not None:
        cache = cache_update(cache, k, v, pos, spec.sliding_window)
    if cache is not None and decode:
        if cache.quantized:
            out = quantized_decode_attention(q, cache, spec, q_positions, pos,
                                             q_chunk=q_chunk,
                                             kv_chunk=kv_chunk)
        else:
            out = chunked_attention(q, cache.k, cache.v, q_positions,
                                    cache.pos, **attn_kw)
    else:
        # prefill attends the fresh k/v under the window mask: a ring
        # cannot serve early queries their own window
        out = chunked_attention(q, k, v, q_positions, q_positions,
                                **attn_kw)
    return matmul(out.reshape(b, s, h * hd), params["wo"]), cache


def mlp_layer(params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """The (gated) MLP: ``act(x W_gate) · x W_up`` (or ``act(x W_up)``
    without a gate), then ``W_down``. GELU is the tanh approximation, as
    the reference's ``jax.nn.gelu`` computes it by default."""
    act = {"silu": F.silu,
           "gelu": functools.partial(F.gelu, approximate="tanh")}[activation]
    up = matmul(x, params["w_up"])
    if "w_gate" in params:
        up = act(matmul(x, params["w_gate"])) * up
    else:
        up = act(up)
    return matmul(up, params["w_down"])
