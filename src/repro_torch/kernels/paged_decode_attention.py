"""Decode attention over the PAGED int8 KV pool: the CUDA kernel's wrapper,
its launch count, and its plain PyTorch version.

The kernel (``csrc/paged_decode_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/paged_decode_attention.py::paged_decode_attention``.
It computes what that kernel computes:

  q            (R, K, G, hd)     bf16/f32, one query token per row
  k/v_codes    (P, K, page, hd)  int8     k/v_scale (P, K, page) f32
  pool_pos     (P, page)         int32    (-1 = empty slot)
  block_table  (R, nb)           int32    page ids; unused entries name the
                                          trash page 0 (all pos = -1)
  q_pos        (R,)              int32    each row's causal bound (-1 = a
                                          free decode slot)
  out          (R, K, G, hd)     f32

A key is attended when ``0 <= pos <= q_pos[r]``. Unlike the dense decode
kernel (K1), a row with no valid key (a free slot: all-trash table,
``q_pos = -1``) gives EXACT zeros, as the TPU kernel's ``seen`` guard does.

Page ``b`` of a row holds positions ``[b·page, (b+1)·page)`` (the pool's
write rule, ``models.layers.paged_cache_update``), so the kernel walks only
pages ``0 .. q_pos // page``; the TPU kernel walks all ``nb`` entries, and
the extra ones hold only masked slots.

What bounds it on an H100: one call reads the codes and scales of the pages
its rows need, ``Σ_r pages_r · K · page · (2·hd + 8)`` bytes plus their
positions, against ``4·K·G·hd`` flops per key, so at small G it is bound by
device-memory bytes. Two kernels; :func:`route` picks one from shapes
alone and ``paged_decode_attention.route_launches`` counts it:

* ``"single_pass"``, a table that fits one split (``nb · page <=
  SPLIT[hd]``): one block a (kv-head, row, head group) walks the row's
  pages in one pass straight from the pool, with nothing to stage.
* ``"split"``, a longer table: a long row is split over blocks
  (flash-decoding). A unit of work is one row, one split of ``SPLIT[hd]``
  logical slots and one kv-head with up to four of its query heads; it
  stages its split's codes in shared memory by ``cp.async`` at once and
  dequantizes them in registers. A row that needs one split is walked by
  its first unit in one pass, as by the single-pass kernel (decided on the
  card from ``q_pos``). A row of several splits has each unit write its
  softmax state to a workspace (``torch.empty``) and take a ticket
  (``kernels.tickets``); the unit that takes the row's last merges the
  splits in split order. So a call is one device launch, and a run repeats
  its bits. :func:`grid` and :func:`unit_slots` are that plan in Python:
  the grid depends on shapes only, so a call replays from a CUDA graph.

No dequantized copy of the pool is written. ``paged_decode_attention.
launches`` counts calls.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.kernels.tickets import tickets

TRASH_PAGE = 0  # page id the pool reserves for masked and pad entries
MAX_PAGE = 64
# logical slots a unit of the kernel walks, by head dim (``Split<HD>::KEYS``
# in the source: a split's codes, scales and positions, 68 KB at hd 128,
# sit in shared memory at once)
SPLIT = {32: 256, 64: 256, 128: 256, 256: 128}
HEAD_DIMS = tuple(SPLIT)  # the source's instantiations
GROUP = 4  # query heads of one kv-head a unit carries at most
ROUTES = ("single_pass", "split")


def splits(nb: int, page: int, keys: int) -> int:
    """Splits of ``keys`` logical slots (``SPLIT[hd]``) that cover a row's
    ``nb · page``."""
    return -(-nb * page // keys)


def grid(r: int, kh: int, g: int, hd: int, page: int, nb: int) -> tuple:
    """The split kernel's grid: (kv-heads × head groups, rows, splits),
    from shapes alone. Groups are 1 or 2 heads when G is, else 4."""
    gc = g if g <= 2 else GROUP
    return kh * -(-g // gc), r, splits(nb, page, SPLIT[hd])


def unit_slots(q_pos: int, index: int, keys: int, page: int,
               nb: int) -> range:
    """The logical slots the unit of split ``index`` (of ``keys`` slots
    each) walks for a row with causal bound ``q_pos``: the row's whole
    pages ``0 .. q_pos // page`` (within the table) cut into splits; empty
    past them."""
    n = 0 if q_pos < 0 else min(q_pos // page + 1, nb) * page
    k0 = index * keys
    return range(k0, max(k0, min(n, k0 + keys)))


def gather_pages(pool_leaf: torch.Tensor, block_table: torch.Tensor):
    """A request's pages gathered from the pool into dense per-request
    layout (``repro/kernels/ref.py::gather_pages_ref``): pool_leaf
    (P, K, page, ...) or (P, page), block_table (R, nb) → (R, K, nb·page,
    ...) or (R, nb·page), in block-table order."""
    g = pool_leaf[block_table.long()]  # (R, nb, K, page, ...) or (R, nb, page)
    if pool_leaf.dim() == 2:
        return g.reshape(g.shape[0], -1)
    g = g.movedim(2, 1)  # (R, K, nb, page, ...)
    return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])


def paged_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                               pool_pos, block_table, q_pos):
    """Plain PyTorch version: gather every row's pages dense, dequantize,
    mask, softmax; a row with no valid key gives zeros. Returns
    (R, K, G, hd) f32."""
    hd = q.shape[-1]
    k = gather_pages(k_codes, block_table).float() \
        * gather_pages(k_scale, block_table)[..., None]
    v = gather_pages(v_codes, block_table).float() \
        * gather_pages(v_scale, block_table)[..., None]
    kv_pos = gather_pages(pool_pos, block_table)  # (R, nb·page)
    s = torch.einsum("rkgd,rksd->rkgs", q.float(), k) / (hd ** 0.5)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    out = torch.einsum("rkgs,rksd->rkgd", torch.softmax(s, dim=-1), v)
    seen = valid.any(dim=-1)[:, None, None, None]
    return torch.where(seen, out, 0.0)


@functools.cache
def _launcher():
    fn = build.load("paged_decode_attention").paged_decode_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_float, p, p, p, p, p, p, p, p, p, p,
                   i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def route(hd: int, page: int, nb: int) -> str:
    """The kernel a call takes (one of ``ROUTES``) from the head dim and the
    table's width in slots: by shape, not a fallback (a launch that fails
    raises). A table that fits one split takes the single-pass kernel."""
    return "single_pass" if nb * page <= SPLIT[hd] else "split"


def check_pool(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
               r: int, kh: int, hd: int) -> None:
    """Raise unless the pool leaves and the block table have the shapes,
    types, device and layout the paged kernels read."""
    p = k_codes.shape[0] if k_codes.dim() == 4 else -1
    page = k_codes.shape[2] if k_codes.dim() == 4 else -1
    nb = block_table.shape[1] if block_table.dim() == 2 else -1
    want = {"k_codes": (k_codes, torch.int8, (p, kh, page, hd)),
            "v_codes": (v_codes, torch.int8, (p, kh, page, hd)),
            "k_scale": (k_scale, torch.float32, (p, kh, page)),
            "v_scale": (v_scale, torch.float32, (p, kh, page)),
            "pool_pos": (pool_pos, torch.int32, (p, page)),
            "block_table": (block_table, torch.int32, (r, nb))}
    for name, (t, dtype, shape) in want.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p < 1 or nb < 1 or not 1 <= page <= MAX_PAGE:
        raise ValueError(f"need >= 1 page and block-table entry, and a page "
                         f"of 1 to {MAX_PAGE} slots; got P={p}, nb={nb}, "
                         f"page={page}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for t in (k_codes, v_codes):
        if t.data_ptr() % 16:
            raise ValueError("int8 codes must be 16-byte aligned")


def check_on_card(name: str, q) -> None:
    """Raise unless ``q`` lies on a CUDA device: a kernel wrapper never
    runs its plain version (``kernels.ops`` sends CPU tensors there)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; q is on "
                         f"{q.device} (use kernels.ops for CPU tensors)")


def _check(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
           q_pos):
    if q.dim() != 4 or q.dtype not in (torch.float32, torch.bfloat16) \
            or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (R, K, G, hd) f32 or bf16 "
                         f"tensor, got {tuple(q.shape)} {q.dtype}")
    r, kh, _, hd = q.shape
    check_pool(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
               r, kh, hd)
    if not isinstance(q_pos, torch.Tensor) or q_pos.device != q.device \
            or q_pos.dtype != torch.int32 or tuple(q_pos.shape) != (r,) \
            or not q_pos.is_contiguous():
        raise ValueError("q_pos must be a contiguous (R,) int32 tensor on "
                         "q's device")
    check_on_card("paged_decode_attention", q)


def paged_decode_attention(q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                           block_table, q_pos):
    """Launch the CUDA kernel :func:`route` picks on the current stream (see
    the module docstring for shapes). Raises on any input the kernels do not
    take; there is no fallback. Adds one to ``paged_decode_attention.
    launches`` and to the route's count in ``paged_decode_attention.
    route_launches`` per call."""
    _check(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
           q_pos)
    way = route(q.shape[-1], k_codes.shape[2], block_table.shape[1])
    out = launch_route(way, q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                       block_table, q_pos)
    paged_decode_attention.launches += 1
    paged_decode_attention.route_launches[way] += 1
    return out


def launch_route(way: str, q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                 block_table, q_pos):
    """Launch the kernel of route ``way`` (one of ``ROUTES``; each takes
    every shape) on checked inputs and return its (R, K, G, hd) f32 output,
    counting nothing: :func:`paged_decode_attention` is the entry point;
    this lets a caller time one route against the other."""
    if way not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {way!r}")
    r, kh, g, hd = q.shape
    page, nb = k_codes.shape[2], block_table.shape[1]
    heads, _, n_split = grid(r, kh, g, hd, page, nb)
    out = torch.empty((r, kh, g, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part = ticket = None
    if way == "split" and n_split > 1:
        # each unit's (hd values), then its (max, sum), for the merge
        part = torch.empty((r * n_split * kh * g * (hd + 2),),
                           dtype=torch.float32, device=q.device)
        ticket = tickets(q.device, stream, r * heads)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), int(q.dtype == torch.bfloat16),
            math.log2(math.e) / hd ** 0.5,
            k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
            v_scale.data_ptr(), pool_pos.data_ptr(), block_table.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(), r, kh, g, hd,
            page, nb, n_split, int(way == "single_pass"), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"({way}): CUDA error {err}")
    return out


paged_decode_attention.launches = 0
paged_decode_attention.route_launches = dict.fromkeys(ROUTES, 0)
