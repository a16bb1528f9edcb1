"""OPSC's memory model, Eq. (2) of the paper (the port's own copy of the
two functions of ``repro/core/opsc.py`` that the paged pool's accounting
reads; the rest of OPSC arrives with the split path)."""

from __future__ import annotations


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
