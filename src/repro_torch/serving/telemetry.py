"""Serving telemetry (port of ``repro/serving/telemetry.py``): so far only
the streaming :class:`Histogram` that ``LLMServer.metrics()`` summarizes
with. The ``Tracer`` and its exporters are not ported yet.

Percentiles are streaming via a DDSketch-style log-bucketed histogram:
bounded relative error (default 1%), O(log range) memory, no sample
retention.
"""

from __future__ import annotations

import math


class Histogram:
    """Streaming histogram with bounded RELATIVE quantile error.

    DDSketch-style log-spaced buckets: a value ``v > 0`` lands in bucket
    ``ceil(log_gamma(v))`` with ``gamma = (1 + rel_err) / (1 - rel_err)``,
    so any reported quantile is within ``rel_err`` (relatively) of the
    true one. Non-positive values collapse into one exact zero bucket.
    Count/sum/min/max are exact.
    """

    def __init__(self, rel_err: float = 0.01):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = rel_err
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._lg = math.log(self._gamma)
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._zero = 0  # values <= 0 (exact bucket)
        self._buckets: dict = {}  # key -> count, value ~ gamma**key

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v <= 0.0:
            self._zero += 1
            return
        key = math.ceil(math.log(v) / self._lg)
        self._buckets[key] = self._buckets.get(key, 0) + 1

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def percentile(self, q: float) -> float | None:
        """The q-quantile (``q`` in [0, 1]) within the sketch's relative
        error, clamped to the exact observed [min, max]."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if q == 0.0:
            return self.min  # exact extremes, not bucket midpoints
        if q == 1.0:
            return self.max
        rank = q * (self.count - 1)
        if rank < self._zero:
            # all values in the zero bucket are <= 0; min is exact
            return min(self.min, 0.0)
        cum = self._zero
        for key in sorted(self._buckets):
            cum += self._buckets[key]
            if cum > rank:
                # bucket midpoint: 2 * gamma^key / (gamma + 1) is the
                # value whose relative distance to both bucket edges
                # is exactly rel_err
                v = 2.0 * self._gamma ** key / (self._gamma + 1.0)
                return max(self.min, min(self.max, v))
        return self.max

    def summary(self) -> dict:
        """{count, sum, mean, min, max, p50, p95, p99} (empty → count 0)."""
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min, "max": self.max,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}
