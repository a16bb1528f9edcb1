"""Public kernel entry points: a CPU tensor goes to the kernel's plain
PyTorch version, a CUDA tensor to the kernel (which raises on anything it
does not take; there is no fallback)."""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _da


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos):
    """Int8-KV decode attention, q (B, K, G, hd) → (B, K, G, hd) f32; see
    :mod:`repro_torch.kernels.decode_attention`."""
    if q.device.type == "cpu":
        return _da.decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                                        kv_pos, q_pos)
    return _da.decode_attention(q, k_codes, k_scale, v_codes, v_scale,
                                kv_pos, q_pos)
