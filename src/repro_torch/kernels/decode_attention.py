"""Decode attention over an int8-quantized KV cache: the CUDA kernel's
wrapper, its launch count, its unit plan and its plain PyTorch version.

The kernel (``csrc/decode_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention``. It computes what
that kernel computes:

  q        (B, K, G, hd)   bf16/f32
  k_codes  (B, K, S, hd)   int8      k_scale (B, K, S)   f32
  v_codes  (B, K, S, hd)   int8      v_scale (B, K, S)   f32
  kv_pos   (B, S)          int32     (-1 = empty slot)
  q_pos    int32 tensor, () or (B,) (absolute position, causal bound)
  out      (B, K, G, hd)   f32

A slot is attended when ``0 <= kv_pos <= q_pos``; masked scores are
``-1e30``, so a row with no valid slot gets the uniform average of its
``v``. The TPU kernel pads S up to whole blocks and counts those pad slots
in that average; the port does not pad (callers allocate caches at
:func:`padded_cache_len`, where the two agree).

**The slot contract.** Every valid slot of a row lies in ``0 ..
min(q_pos, S - 1)``, and the kernel reads only those; the TPU kernel walks
all S slots, and the rest are masked there and weigh exactly 0. The dense
cache (``models.layers.cache_update``) keeps it two ways:

* a full layer writes position p at slot p, so slot t holds t or -1;
* a sliding-window layer's ring of ``W = min(window, slots) <= S`` slots
  writes p at slot ``p % W``. Before it wraps, slot t holds t. Once it
  has wrapped, q_pos >= W, so every ring slot lies below q_pos; slots
  ``W .. S - 1`` (block padding) hold -1; and every ring slot holds a
  position in ``(q_pos - W, q_pos]``, so the kernel's position mask is the
  window's mask.

A caller that put position p anywhere else (a left-padded batch) would
lose it from the kernel's sum.

What bounds it on an H100: one call reads the codes and scales of the slots
its rows need, ``Σ_b min(q_pos_b + 1, S) · K · (2·hd + 8)`` bytes plus
their positions, against ``4·K·G·hd`` flops a slot, so it is bound by
device-memory bytes.

Head dim 120 runs the hd-128 lanes over rows 120 bytes apart (q's tail
set to zero; ``decode_attention.cu``'s header).

``decode_split_kernel`` (flash-decoding): a row is cut into units of
:func:`unit_keys` consecutive slots, each with one kv-head and up to four
of its query heads. The grid, :func:`grid`, depends on shapes only, so a
call replays from a CUDA graph; a unit past its row's ``q_pos`` exits at
once (:func:`unit_slots`). A live unit stages its slots' codes, scales and
positions in shared memory by ``cp.async`` at once, computes the scores,
one max, then the values weighted by 2^(score − max) (base 2). A row of
one unit writes its output; in a longer row each unit writes its softmax
state to a workspace and takes a ticket (``kernels.tickets``), and the
unit that takes the row's last merges the units in unit order: one device
launch a call, and a run repeats its bits. A row where no unit saw a valid
slot gets the uniform average of v over all S slots from the merging unit
(a slow branch no serving path reaches). No dequantized copy of the cache
is written. ``decode_attention.launches`` counts calls.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.tickets import scratch

NEG_INF = -1e30
BLOCK_S = 512  # block size of the TPU kernel's sequence axis; sizes caches
HEAD_DIMS = (32, 64, 120, 128, 256)
GROUP = 4  # query heads of one kv-head a unit carries at most
WARPS = 8  # of a block: a step walks WARPS · 32 / ⌈hd / 16⌉ slots


def padded_cache_len(s: int) -> int:
    """The dense cache's length for ``s`` slots: ``s`` itself up to one
    ``BLOCK_S`` block, else rounded up to whole blocks. Pad slots carry
    ``kv_pos = -1``."""
    if s <= BLOCK_S:
        return s
    return -(-s // BLOCK_S) * BLOCK_S


def decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos):
    """Plain PyTorch version (``repro/kernels/ref.py::decode_attention_ref``):
    dequantize the whole cache, mask, softmax. ``q_pos`` is a scalar or
    (B,). Returns (B, K, G, hd) f32."""
    hd = q.shape[-1]
    k = k_codes.float() * k_scale[..., None]
    v = v_codes.float() * v_scale[..., None]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(), k) / (hd ** 0.5)
    q_pos = torch.as_tensor(q_pos, device=q.device).reshape(-1)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", p, v)


def unit_keys(hd: int) -> int:
    """The slots of a unit at head dim ``hd`` (``unit_keys`` in the
    source): 256, 128 at hd 256, whole block steps whose codes, scales and
    positions stage within 69 KB of shared memory (64.5 KB at hd 120, 66 at
    hd 128). On an H100 the fastest
    of 32 to 256 at llama2-7b's three decode shapes (every slot of 1,024
    live at B 4, 192 at B 2, 160 at B 1), where a row of one unit needs no
    merge (``python -m repro_torch.kernels.decode_probe --only k1``)."""
    return 128 if hd == 256 else 256


def grid(b: int, kh: int, g: int, s: int, keys: int) -> tuple:
    """The split kernel's grid for units of ``keys`` slots: (kv-heads ×
    head groups, rows, units), from shapes alone. Groups are 1 or 2 heads
    when G is, else 4."""
    gc = g if g <= 2 else GROUP
    return kh * -(-g // gc), b, -(-s // keys)


def unit_slots(q_pos: int, index: int, keys: int, s: int) -> range:
    """The slots unit ``index`` (of ``keys`` slots) walks for a row with
    causal bound ``q_pos``: the row's slots ``0 .. q_pos`` (within the
    cache; the slot contract) cut into units; empty past them."""
    n = 0 if q_pos < 0 else min(q_pos + 1, s)
    k0 = index * keys
    return range(k0, max(k0, min(n, k0 + keys)))


@functools.cache
def _launcher():
    fn = build.load("decode_attention").decode_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_float, p, p, p, p, p, p, i, p, p, p,
                   i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _plan(b: int, kh: int, g: int, hd: int, s: int) -> tuple:
    """(units a row, workspace f32, tickets, the query's scale) of a call's
    shape, worked out once per shape: each unit's (hd values), then its
    (max, sum), for the merge, and a ticket a (row, kv-head, head group);
    neither where a row is one unit."""
    heads, _, units = grid(b, kh, g, s, unit_keys(hd))
    scale = math.log2(math.e) / hd ** 0.5
    if units == 1:
        return units, 0, 0, scale
    return units, b * units * kh * g * (hd + 2), b * heads, scale


_Q_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention launches a CUDA kernel; q is on "
                         f"{q.device} (use kernels.ops for CPU tensors)")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, K, G, hd), got {tuple(q.shape)}")
    b, kh, g, hd = q.shape
    s = k_codes.shape[2] if k_codes.dim() == 4 else -1
    dev = q.device
    for name, t, dtypes, shape in (
            ("q", q, _Q_DTYPES, (b, kh, g, hd)),
            ("k_codes", k_codes, (torch.int8,), (b, kh, s, hd)),
            ("v_codes", v_codes, (torch.int8,), (b, kh, s, hd)),
            ("k_scale", k_scale, (torch.float32,), (b, kh, s)),
            ("v_scale", v_scale, (torch.float32,), (b, kh, s)),
            ("kv_pos", kv_pos, (torch.int32,), (b, s))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
        if t.shape != shape or s < 1:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if (k_codes.data_ptr() | v_codes.data_ptr()) % 16:
        raise ValueError("int8 codes must be 16-byte aligned")
    if not isinstance(q_pos, torch.Tensor) or q_pos.device != dev \
            or q_pos.dtype != torch.int32 or q_pos.numel() not in (1, b) \
            or q_pos.dim() > 1 or not q_pos.is_contiguous():
        raise ValueError("q_pos must be a contiguous int32 tensor of shape "
                         "(), (1,) or (B,) on q's device")


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos):
    """Launch the CUDA kernel on the current stream (see the module
    docstring for shapes and the slot contract). Raises on any input the
    kernel does not take; there is no fallback. Adds one to
    ``decode_attention.launches`` per call."""
    _check(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos)
    b, kh, g, hd = q.shape
    s = k_codes.shape[2]
    units, n_part, n_tickets, scale = _plan(b, kh, g, hd, s)
    out = torch.empty((b, kh, g, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        part = ticket = None
        if units > 1:
            ticket, part = scratch(q.device, stream, n_tickets, n_part)
        err = _launcher()(
            q.data_ptr(), int(q.dtype == torch.bfloat16), scale,
            k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
            v_scale.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
            0 if q_pos.numel() == 1 else 1, out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if ticket is None else ticket.data_ptr(),
            b, kh, g, s, hd, units, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
