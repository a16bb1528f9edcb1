"""Decode attention over an int8-quantized KV cache: the CUDA kernel's
wrapper, its launch count, and its plain PyTorch version.

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

What bounds it on an H100: one call reads every code and scale once,
``B·K·S·(2·hd + 8) + B·S·4`` bytes, against ``4·B·K·G·S·hd`` flops, so it is
bound by device-memory bytes (about 10 µs at B=4, K=32, S=1024, hd=128 on
an H100 SXM). The kernel streams the int8 codes once with 16-byte loads and
dequantizes them in registers; it never writes a dequantized copy.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
BLOCK_S = 512  # block size of the TPU kernel's sequence axis; sizes caches
HEAD_DIMS = (32, 64, 128, 256)


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


@functools.cache
def _launcher():
    fn = build.load("decode_attention").decode_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, ctypes.c_float, p, p, p, p, p, p, i, p,
                   i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention launches a CUDA kernel; q is on "
                         f"{q.device} (use kernels.ops for CPU tensors)")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, K, G, hd), got {tuple(q.shape)}")
    b, kh, g, hd = q.shape
    s = k_codes.shape[2] if k_codes.dim() == 4 else -1
    want = {"q": (q, (torch.float32, torch.bfloat16), (b, kh, g, hd)),
            "k_codes": (k_codes, (torch.int8,), (b, kh, s, hd)),
            "v_codes": (v_codes, (torch.int8,), (b, kh, s, hd)),
            "k_scale": (k_scale, (torch.float32,), (b, kh, s)),
            "v_scale": (v_scale, (torch.float32,), (b, kh, s)),
            "kv_pos": (kv_pos, (torch.int32,), (b, s))}
    for name, (t, dtypes, shape) in want.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape or s < 1:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for t in (k_codes, v_codes):
        if t.data_ptr() % 16:
            raise ValueError("int8 codes must be 16-byte aligned")
    if not isinstance(q_pos, torch.Tensor) or q_pos.device != q.device \
            or q_pos.dtype != torch.int32 or q_pos.numel() not in (1, b) \
            or q_pos.dim() > 1 or not q_pos.is_contiguous():
        raise ValueError("q_pos must be a contiguous int32 tensor of shape "
                         "(), (1,) or (B,) on q's device")


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos):
    """Launch the CUDA kernel on the current stream (see the module
    docstring for shapes). Raises on any input the kernel does not take;
    there is no fallback. Adds one to ``decode_attention.launches`` per
    launch."""
    _check(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos)
    b, kh, g, hd = q.shape
    out = torch.empty((b, kh, g, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5,
            k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
            v_scale.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
            0 if q_pos.numel() == 1 else 1, out.data_ptr(),
            b, kh, g, k_codes.shape[2], hd,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
