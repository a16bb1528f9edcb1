"""OPSC, One-Point Split Compression, paper §2.1-2.2 Eq. 1-3 (port of
``repro/core/opsc.py``): the analytical memory and payload models, and the
weight quantization that realizes OPSC's front segment.

Conventions (the paper's Table 1):
  w       current token index / sequence length generated so far
  ℓ (ell) split layer: layers 1..ℓ on the edge, ℓ+1..L in the cloud
  Q^w     {Q_w1 front, Q_w2 back} weight bits
  Q^a     {Q_a1 front, Q_a2 back} activation (KV-cache / payload) bits
  I_kv    1: transmit the KV cache, 0: transmit only the hidden state
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OPSCConfig:
    split_layer: int  # ℓ_w
    qw_front: int = 4  # Q_w1
    qw_back: int = 16  # Q_w2 (the cloud keeps high precision)
    qa_front: int = 4  # Q_a1
    qa_back: int = 16  # Q_a2
    i_kv: int = 1
    tau: float = 5.0  # TS threshold (paper default)
    delta: float = 0.2  # TAB-Q distortion tolerance (paper default)
    max_act_bits: int = 8  # Q̄_a


# ---------------------------------------------------------------------------
# Eq. (1): weight memory of the two segments
# ---------------------------------------------------------------------------


def weight_memory_bytes(layer_param_counts, ell: int, qw_front: int,
                        qw_back: int) -> int:
    """M(ℓ_w, Q^w) = Σ_{i≤ℓ} B_w(i;Q_w1) + Σ_{j>ℓ} B_w(j;Q_w2) [bytes].
    ``layer_param_counts``: per-layer parameter counts, len L."""
    front = sum(layer_param_counts[:ell]) * qw_front
    back = sum(layer_param_counts[ell:]) * qw_back
    return (front + back) // 8


def edge_weight_memory_bytes(layer_param_counts, ell: int, qw_front: int,
                             embed_params: int = 0) -> int:
    """Bytes the edge device holds: front segment + embedding table."""
    return (sum(layer_param_counts[:ell]) + embed_params) * qw_front // 8


# ---------------------------------------------------------------------------
# Eq. (2): KV-cache memory as the sequence grows
# ---------------------------------------------------------------------------


def activation_bits_per_layer(num_layers: int, ell: int, qa_front: int,
                              qa_back: int) -> list:
    """Q_{a,k} per the paper: Q_a1 for k < ℓ, Q_a2 for k ≥ ℓ."""
    return [qa_front if k < ell else qa_back for k in range(num_layers)]


def kv_cache_bytes(w: int, ell: int, num_layers: int, heads_dim: int,
                   qa_front: int, qa_back: int) -> int:
    """B_kv(w, ℓ; Q^a), Eq. (2), in bytes. ``heads_dim`` is the cached
    width (kv_heads · head_dim under GQA):

      2·Σ_{k<ℓ} T_w·Q_{a,k}  +  2·Σ_{k≥ℓ} T_{w-1}·Q_{a,k}  +  H·D·Q_{a,ℓ}

    with T_w = w·H·D."""
    qa = activation_bits_per_layer(num_layers, ell, qa_front, qa_back)
    t_w = w * heads_dim
    t_wm1 = (w - 1) * heads_dim
    bits = 2 * sum(t_w * qa[k] for k in range(ell))
    bits += 2 * sum(t_wm1 * qa[k] for k in range(ell, num_layers))
    bits += heads_dim * qa[min(ell, num_layers - 1)]
    return bits // 8


def kv_cache_bytes_shared(w_prefix: int, request_ws, ell: int,
                          num_layers: int, heads_dim: int,
                          qa_front: int, qa_back: int) -> int:
    """Eq. (2) under prefix sharing [bytes]: the ``w_prefix``-token prefix
    is resident once and each request of total length ``w_r`` adds its
    marginal bytes, B_kv(w_prefix) + Σ_r [B_kv(w_r) - B_kv(w_prefix)]."""
    base = kv_cache_bytes(w_prefix, ell, num_layers, heads_dim,
                          qa_front, qa_back) if w_prefix > 0 else 0
    total = base
    for w in request_ws:
        if w < w_prefix:
            raise ValueError(f"request length {w} < shared prefix {w_prefix}")
        total += kv_cache_bytes(w, ell, num_layers, heads_dim,
                                qa_front, qa_back) - base
    return total


def ssm_state_bytes(num_ssm_layers: int, state_elems: int, qa_bits: int) -> int:
    """Degenerate Eq. (2) for SSM/hybrid layers: a fixed-size recurrent
    state, constant in w."""
    return num_ssm_layers * state_elems * qa_bits // 8


# ---------------------------------------------------------------------------
# Eq. (3): intermediate payload crossing the split
# ---------------------------------------------------------------------------


def payload_bytes(w: int, ell: int, num_layers: int, heads_dim: int,
                  hidden_dim: int, qa_front: int, qa_back: int,
                  i_kv: int) -> int:
    """B_io(w, ℓ, I_kv; Q^a), Eq. (3) [bytes]: I_kv = 1 ships the KV cache
    (B_kv), I_kv = 0 only the split-layer hidden state at Q_{a,ℓ} bits."""
    if i_kv:
        return kv_cache_bytes(w, ell, num_layers, heads_dim, qa_front, qa_back)
    qa = activation_bits_per_layer(num_layers, ell, qa_front, qa_back)
    return w * hidden_dim * qa[min(ell, num_layers - 1)] // 8


# ---------------------------------------------------------------------------
# OPSC applied to the port's flat parameter dict (front blocks quantized)
# ---------------------------------------------------------------------------


def quantize_front_params(params: dict, split_layer: int, qw_front: int,
                          num_blocks: int, pattern_len: int = 1) -> dict:
    """Fake-quantize the front (edge) segment of a flat parameter dict
    (``repro_torch.params``): the leading ``split_layer // pattern_len``
    blocks of every stacked ``blocks/...`` leaf of two or more dims are
    quantized symmetrically at ``qw_front`` bits (one scale per block and
    output element over the flattened rest) and dequantized back to the
    leaf's dtype, as the reference does for accuracy evaluation. Returns a
    new dict; the input is not modified."""
    import torch

    from repro_torch.core.quant import quantize_sym

    front = min(num_blocks, max(0, split_layer // max(pattern_len, 1)))
    if front == 0:
        return params
    out = dict(params)
    for key, x in params.items():
        if not key.startswith("blocks/") or x.dim() < 2 \
                or x.shape[0] != num_blocks:
            continue
        head = x[:front]
        fq = quantize_sym(head.reshape(front, -1), qw_front, dim=-1)
        out[key] = torch.cat([fq.dequantize(x.dtype).reshape(head.shape),
                              x[front:]])
    return out
