"""Unified split/quantization optimization (paper §2.4.1, Eq. 8); a copy
of ``repro/core/split_optimizer.py``, which is plain Python.

Enumerates (ℓ_w, Q^w, Q^a) over discrete candidate sets, keeps configurations
satisfying the accuracy bound (8b) and the memory bound (8c), and returns the
one maximizing total activation precision Ψ(Q^a) = Σ_k Q_{a,k}.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

from repro_torch.core.opsc import (OPSCConfig, activation_bits_per_layer,
                             edge_weight_memory_bytes, kv_cache_bytes)


@dataclasses.dataclass
class SplitSearchSpace:
    split_layers: Sequence[int]
    qw_bits: Sequence[int] = (4, 8, 16)
    qa_bits: Sequence[int] = (2, 4, 8, 16)


@dataclasses.dataclass
class SplitSolution:
    config: OPSCConfig
    psi: int  # Ψ(Q^a)
    memory_bytes: int
    accuracy: float


def psi(num_layers: int, ell: int, qa_front: int, qa_back: int) -> int:
    """Ψ(Q^a) = Σ_k Q_{a,k}."""
    return sum(activation_bits_per_layer(num_layers, ell, qa_front, qa_back))


def optimize_split(
    *,
    num_layers: int,
    layer_param_counts: Sequence[int],
    embed_params: int,
    kv_heads_dim: int,
    max_tokens: int,  # W̄ — fixed per §2.4.1 ("the edge must fit the full length")
    memory_budget_bytes: int,  # M
    accuracy_fn: Callable[[OPSCConfig], float],  # A(ℓ, Q^w, Q^a)
    base_accuracy: float,  # A_base
    accuracy_drop: float,  # A_Δ
    space: SplitSearchSpace | None = None,
) -> SplitSolution | None:
    """Solve Eq. (8) by enumeration (the paper's prescribed approach).

    ``accuracy_fn`` evaluates a candidate configuration (on the validation
    vehicle); callers may memoize it — the loop visits each (ℓ, Q^w, Q^a)
    once, cheapest-to-check constraints first (memory before accuracy)."""
    space = space or SplitSearchSpace(split_layers=range(1, num_layers))
    best: SplitSolution | None = None
    for ell, qw1, qw2, qa1, qa2 in itertools.product(
        space.split_layers, space.qw_bits, space.qw_bits, space.qa_bits, space.qa_bits
    ):
        cfg = OPSCConfig(split_layer=ell, qw_front=qw1, qw_back=qw2,
                         qa_front=qa1, qa_back=qa2)
        # (8c): edge weights + KV cache at the maximum sequence length W̄
        mem = edge_weight_memory_bytes(layer_param_counts, ell, qw1, embed_params)
        mem += kv_cache_bytes(max_tokens, ell, num_layers, kv_heads_dim, qa1, qa2)
        if mem > memory_budget_bytes:
            continue
        cand_psi = psi(num_layers, ell, qa1, qa2)
        if best is not None and cand_psi <= best.psi:
            continue  # cannot improve Ψ — skip the (expensive) accuracy check
        acc = accuracy_fn(cfg)
        if acc < base_accuracy - accuracy_drop:  # (8b)
            continue
        best = SplitSolution(cfg, cand_psi, mem, acc)
    return best
