"""ε-outage wireless channel model (paper §2.4.2, Eq. 9-10, 13); a copy
of ``repro/core/channel.py``, which is plain math with numpy. In the
split engine it models the edge→cloud uplink.

  P_o(R)          = 1 - exp(-(2^{R/W} - 1)/γ)                  (Eq. 10)
  L_ε(D_tx; R)    = D_tx / R · ⌈ln ε / ln P_o(R)⌉              (Eq. 9)
  g(R)            = ln(1/P_o(R)) / R,  R* = argmin g(R)        (Eq. 13)

Units: R in bits/s, W in Hz, D_tx in bits, latency in seconds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    bandwidth_hz: float = 10e6  # W  (paper: 10 MHz)
    snr: float = 10.0  # γ  (paper: 10)
    epsilon: float = 1e-3  # ε  (paper: 0.001)
    r_min: float = 1e5  # feasible rate interval [R_, R̄] (bits/s)
    r_max: float = 200e6


def outage_probability(rate: float, cfg: ChannelConfig) -> float:
    """Eq. (10)."""
    snr_needed = 2.0 ** (rate / cfg.bandwidth_hz) - 1.0
    return 1.0 - math.exp(-snr_needed / cfg.snr)


def worst_case_latency(d_tx_bits: float, rate: float, cfg: ChannelConfig) -> float:
    """Eq. (9): worst-case latency to deliver ``d_tx_bits`` at outage ε.

    The ceil term is the number of (re)transmissions needed so the residual
    failure probability drops below ε."""
    p_o = outage_probability(rate, cfg)
    p_o = min(max(p_o, 1e-300), 1.0 - 1e-12)
    n_tx = math.ceil(math.log(cfg.epsilon) / math.log(p_o))
    return d_tx_bits / rate * max(n_tx, 1)


def g(rate: float, cfg: ChannelConfig) -> float:
    """Eq. (13) objective: ln(1/P_o(R)) / R — maximize to minimize latency.

    (Minimizing worst-case latency D/R·ln ε/ln P_o = D·ln(1/ε) / (R·ln(1/P_o))
    ⇔ maximizing R·ln(1/P_o(R)); the paper states it as minimizing
    g(R) = ln(1/P_o(R))/R with the reciprocal objective — we follow the
    latency-minimizing direction and expose both.)"""
    p_o = outage_probability(rate, cfg)
    p_o = min(max(p_o, 1e-300), 1.0 - 1e-12)
    return math.log(1.0 / p_o) / rate


def optimal_rate(cfg: ChannelConfig, n_grid: int = 4096) -> float:
    """Eq. (13): 1-D grid search for R* minimizing worst-case latency."""
    rates = np.geomspace(cfg.r_min, cfg.r_max, n_grid)
    lat = np.array([worst_case_latency(1.0, r, cfg) for r in rates])
    return float(rates[int(np.argmin(lat))])


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Eq. (11): L_t = L_c(w) + L_ε(B_io, R) — total per-token edge latency."""

    channel: ChannelConfig
    rate: float  # R* from optimal_rate
    compute_per_token_s: float  # profiled local per-layer-per-token seconds

    def total_latency(self, w: int, ell: int, payload_bits: float) -> float:
        l_c = self.compute_per_token_s * ell  # local compute up to layer ℓ
        return l_c + worst_case_latency(payload_bits, self.rate, self.channel)
