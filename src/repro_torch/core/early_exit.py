"""Early-exit controller under delay constraints (paper Algorithm 2); a
copy of ``repro/core/early_exit.py``, which is plain Python.

A host-side control loop, faithful to Algorithm 2's escalation ladder for
each generated token:

  1. try shipping at the memory-optimal precision Q̄^a;
  2. if L_t > D → apply TAB-Q payload compression;
  3. still over → drop the KV cache from the payload (I_kv ← 0) and ship the
     compressed hidden state only;
  4. still over → reduce the token count (generate fewer tokens) — early exit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.channel import LatencyModel, worst_case_latency
from repro_torch.core.opsc import OPSCConfig, payload_bytes


@dataclasses.dataclass
class EarlyExitDecision:
    w: int  # tokens actually generated
    i_kv: int  # final KV-transmission switch
    compressed: bool  # whether TAB-Q compression was engaged
    latency_s: float  # modeled worst-case total latency
    exited_early: bool


@dataclasses.dataclass
class EarlyExitController:
    """Algorithm 2. ``payload_bits_fn(w, i_kv, compressed)`` returns the
    modeled payload size in bits (TS+TAB-Q accounting when compressed)."""

    opsc: OPSCConfig
    latency: LatencyModel
    deadline_s: float  # D
    num_layers: int
    payload_bits_fn: Callable[[int, int, bool], float]

    def _lat(self, w: int, i_kv: int, compressed: bool) -> float:
        bits = self.payload_bits_fn(w, i_kv, compressed)
        return self.latency.total_latency(w, self.opsc.split_layer, bits)

    def decide(self, w_max: int) -> EarlyExitDecision:
        """Run Algorithm 2 for a target of ``w_max`` tokens."""
        i_kv = self.opsc.i_kv
        # line 9-10: uncompressed at the chosen precision
        lat = self._lat(w_max, i_kv, compressed=False)
        if lat <= self.deadline_s:
            return EarlyExitDecision(w_max, i_kv, False, lat, False)
        # line 11-14: engage TAB-Q compression
        lat = self._lat(w_max, i_kv, compressed=True)
        if lat <= self.deadline_s:
            return EarlyExitDecision(w_max, i_kv, True, lat, False)
        # line 16-18: drop the KV cache from the payload
        i_kv = 0
        lat = self._lat(w_max, i_kv, compressed=True)
        if lat <= self.deadline_s:
            return EarlyExitDecision(w_max, i_kv, True, lat, False)
        # line 19-24: reduce token count until the deadline holds
        w = w_max
        while w > 1 and lat > self.deadline_s:
            w -= 1
            lat = self._lat(w, i_kv, compressed=True)
        return EarlyExitDecision(w, i_kv, True, lat, True)


def solve_depth_objective(latency: LatencyModel, payload_bits_fn,
                          deadline_s: float, w_max: int, num_layers: int,
                          i_kv: int = 1, compressed: bool = True):
    """Paper Eq. (12): maximize the inference depth w·ℓ subject to
    L_t(w, ℓ) ≤ D — solved by enumeration over the (w, ℓ) grid (both sets are
    small and discrete; the paper prescribes direct search).

    ``payload_bits_fn(w, ell, i_kv, compressed)`` → payload bits at (w, ℓ).
    Returns (w*, ℓ*, latency_s) or None if even (1, 1) violates D."""
    best = None
    for ell in range(1, num_layers + 1):
        # L_t is monotone in w at fixed ℓ → binary search the largest w
        def lat_at(w):
            bits = payload_bits_fn(w, ell, i_kv, compressed)
            return (latency.compute_per_token_s * ell
                    + worst_case_latency(bits, latency.rate, latency.channel))

        lo, hi = 0, w_max
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if lat_at(mid) <= deadline_s:
                lo = mid
            else:
                hi = mid - 1
        if lo >= 1 and (best is None or lo * ell > best[0] * best[1]):
            best = (lo, ell, lat_at(lo))
    return best


def default_payload_bits_fn(opsc: OPSCConfig, num_layers: int, kv_heads_dim: int,
                            hidden_dim: int, compression_ratio: float = 4.0):
    """Analytical payload model: Eq. (3) bytes, divided by the measured
    TS+TAB-Q compression ratio when compression is engaged."""

    def fn(w: int, i_kv: int, compressed: bool) -> float:
        raw = payload_bytes(w, opsc.split_layer, num_layers, kv_heads_dim,
                            hidden_dim, opsc.qa_front, opsc.qa_back, i_kv) * 8.0
        return raw / compression_ratio if compressed else raw

    return fn
