"""Public kernel entry points: a CPU tensor goes to the kernel's plain
PyTorch version, a CUDA tensor to the kernel (which raises on anything it
does not take; there is no fallback)."""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dequant_matmul as _dm
from repro_torch.kernels import paged_decode_attention as _pda
from repro_torch.kernels import paged_prefill_attention as _ppa
from repro_torch.kernels import tabq_quantize as _tq
from repro_torch.kernels import ts_mask as _ts
from repro_torch.kernels import varlen_attention as _va


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, kv_pos, q_pos):
    """Int8-KV decode attention, q (B, K, G, hd) → (B, K, G, hd) f32; see
    :mod:`repro_torch.kernels.decode_attention`.

    The slot contract: every valid slot of a row lies in ``0 .. min(q_pos,
    S - 1)``, as the dense cache and its sliding-window rings write them.
    The kernel reads only those slots, while the plain version masks all
    S, so a cache that puts a position elsewhere (a left-padded batch) gets
    answers on the card that differ from the CPU's."""
    if q.device.type == "cpu":
        return _da.decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                                        kv_pos, q_pos)
    return _da.decode_attention(q, k_codes, k_scale, v_codes, v_scale,
                                kv_pos, q_pos)


def paged_decode_attention(q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                           block_table, q_pos):
    """Decode attention through the paged pool, q (R, K, G, hd) → (R, K, G,
    hd) f32; see :mod:`repro_torch.kernels.paged_decode_attention`."""
    fn = _pda.paged_decode_attention_ref if q.device.type == "cpu" \
        else _pda.paged_decode_attention
    return fn(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
              q_pos)


def paged_prefill_attention(q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                            block_table, q_pos, k_fresh, v_fresh):
    """Prefill attention through the paged pool, q (R, S, K, G, hd) →
    (R, S, K, G, hd) f32; see :mod:`repro_torch.kernels.
    paged_prefill_attention`. ``start`` is derived from ``q_pos`` here, on
    the device, so the kernel and its callers never disagree on it."""
    start = _ppa.first_call_position(q_pos)
    fn = _ppa.paged_prefill_attention_ref if q.device.type == "cpu" \
        else _ppa.paged_prefill_attention
    return fn(q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
              q_pos, start, k_fresh, v_fresh)


def varlen_attention(q, k_codes, k_scale, v_codes, v_scale, pool_pos,
                     block_table, q_pos, tok_slot, start, k_fresh, v_fresh,
                     rows=None):
    """Token-packed varlen attention through the paged pool, one flat batch
    q (K, T, G, hd) → (K, T, G, hd) f32; see :mod:`repro_torch.kernels.
    varlen_attention`. ``start`` is :func:`segment_start`'s and ``rows``
    :func:`segment_rows`', which the packed step computes once per tick for
    all of its layers (the kernel builds ``rows`` itself when not given)."""
    args = (q, k_codes, k_scale, v_codes, v_scale, pool_pos, block_table,
            q_pos, tok_slot, start, k_fresh, v_fresh)
    if q.device.type == "cpu":
        return _va.varlen_attention_ref(*args)
    return _va.varlen_attention(*args, rows)


# K4's plain version on any device: the packed tick's route only under
# RuntimeOpts(paged_prefill_kernel=False), as the reference takes its dense
# oracle there; never a stand-in for a kernel that failed
varlen_attention_plain = _va.varlen_attention_ref
segment_start = _va.segment_start
segment_rows = _va.segment_rows
gather_pages = _pda.gather_pages
first_call_position = _ppa.first_call_position


def tabq_quantize(x, bits: int):
    """Per-token asymmetric quantization of |x| (T, D) at ``bits`` bits →
    (codes, scale, zero, sign); see :mod:`repro_torch.kernels.
    tabq_quantize`."""
    fn = _tq.tabq_quantize_ref if x.device.type == "cpu" \
        else _tq.tabq_quantize
    return fn(x, bits)


def tabq_adaptive(x, max_bits: int, delta: float):
    """TAB-Q (Algorithm 1) of x (T, D) in one call → (codes, sign, scale,
    zero, bits); see :mod:`repro_torch.kernels.tabq_quantize`."""
    fn = _tq.tabq_adaptive_ref if x.device.type == "cpu" \
        else _tq.tabq_adaptive
    return fn(x, max_bits, delta)


def ts_encode(x, tau: float, capacity: int):
    """Threshold split of x (T, D) with a ``capacity``-slot carrier →
    (below, values, indices, count); see :mod:`repro_torch.kernels.
    ts_mask`."""
    fn = _ts.ts_encode_ref if x.device.type == "cpu" else _ts.ts_encode
    return fn(x, tau, capacity)


def dequant_matmul(x, codes, scale):
    """x (M, K) times int8 codes (K, N) with per-output-channel scales →
    (M, N) f32; see :mod:`repro_torch.kernels.dequant_matmul`."""
    fn = _dm.dequant_matmul_ref if x.device.type == "cpu" \
        else _dm.dequant_matmul
    return fn(x, codes, scale)
