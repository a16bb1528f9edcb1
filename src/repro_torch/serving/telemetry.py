"""Serving telemetry (port of ``repro/serving/telemetry.py``):
request-lifecycle spans, per-tick timeline records, and a registry of
counters, gauges and histograms with streaming percentiles.

One :class:`Tracer` is threaded (``telemetry=``, default ``None``) through
the serving front ends:

  * ``serving.scheduler.Scheduler``: every tick (any ``tick_mode``) lands a
    :class:`TickRecord` (wall time, mode, live and pad token counts, new
    step-call shapes against shapes seen before, pool pages, queue depth)
    and each request's lifecycle lands as spans and instants: ``queued →
    prefill chunk(s) → first_token → decode → preempt/swap_out/swap_resume
    → finish``, each with its tick id and reason;
  * ``serving.engine.Engine``: one ``fused_generate`` span per call, with
    batch and token counters;
  * ``serving.split_engine.SplitEngine``: ``edge`` and ``cloud`` spans per
    segment (prefill and every decode step or round), an ``uplink`` event
    per payload, and TAB-Q's bit widths as a histogram, mirroring
    ``SplitStats`` into the registry.

Pure Python, no torch: with ``telemetry=None`` no Tracer method is called
(every site is guarded), and a Tracer never reads a device value, so
outputs are bit-identical with telemetry on or off. Where a span must
cover device work, the CALLER synchronizes the device's current stream
before stamping its end, and only when a tracer is attached.

Exporters: :meth:`Tracer.export_chrome_trace` (Chrome trace-event JSON for
Perfetto or ``chrome://tracing``: a ``ticks`` track, a ``queue`` track, a
track per scheduler slot and per engine, the flat metrics under
``repro_metrics``), :meth:`Tracer.metrics_dict` (the flat ``{name:
value}`` dict that ``LLMServer.metrics()`` merges; histograms expand to
``name.p50`` / ``name.p95`` / ... keys); ``tools/trace_report.py``
summarizes and validates an exported trace.

Clock: ``time.perf_counter`` by default (the clock ``serving.api`` stamps
``RequestMetrics`` with), injectable for tests. Percentiles are streaming
via a DDSketch-style log-bucketed histogram: bounded relative error
(default 1%), O(log range) memory, no sample retention.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time


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


class MetricsRegistry:
    """Named counters (monotonic), gauges (last value), and histograms
    (streaming percentiles). ``flat()`` renders everything as one
    ``{name: number}`` dict — histograms expand to dotted sub-keys."""

    def __init__(self):
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.record(value)

    def flat(self) -> dict:
        out: dict = {}
        out.update(self.counters)
        out.update(self.gauges)
        for name, h in self.histograms.items():
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        return out


# ------------------------------------------------------------------- spans


@dataclasses.dataclass
class Span:
    """One duration on one track. ``end`` is None while the span is open;
    ``attrs`` carries reasons / tick ids / token counts."""

    name: str
    track: str
    start: float
    end: float | None = None
    rid: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float | None:
        return None if self.end is None else self.end - self.start


@dataclasses.dataclass
class TickRecord:
    """One scheduler tick's timeline entry."""

    tick: int
    start: float
    wall_s: float
    mode: str  # "packed" | "chunked" | "wave"
    tokens: int  # live tokens the tick's step calls carried
    pad_tokens: int | None  # buffer pad rows (packed mode; None otherwise)
    # step-call shapes first seen this tick (the reference's compiles; the
    # shapes a CUDA graph would capture once each)
    new_compiles: int
    shape_hits: int  # dispatches that reused an already-seen shape
    pages_in_use: int
    pages_shared: int
    swap_bytes: int
    queue_depth: int
    active_slots: int
    prefilling_slots: int


# ------------------------------------------------------------------ tracer


class Tracer:
    """Collects spans, instant events, tick records, and metrics from the
    serving layer. One instance per server/scheduler; share one across
    backends to get a single merged trace.

    Request-lifecycle helpers (``request_submitted`` ... ``request_
    finished``) encapsulate the span bookkeeping so the scheduler's
    instrumentation stays one guarded line per site; the generic
    ``span_begin`` / ``span_end`` / ``add_span`` / ``event`` API is
    available for everything else.
    """

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.t0 = clock()
        self.spans: list = []  # closed AND open spans, begin order
        self.events: list = []  # (name, t, track, rid, attrs) instants
        self.ticks: list = []
        self.metrics = MetricsRegistry()
        self.ttft_ticks: dict = {}  # rid -> ticks submit → first token
        self._open: dict = {}  # key -> Span
        self._submit_t: dict = {}  # rid -> submit time
        self._first_t: dict = {}  # rid -> first-token time
        self._tick_open: tuple | None = None  # (tick, t_start, mode)
        self._tick_compiles = 0
        self._tick_hits = 0
        self.current_tick: int | None = None

    def now(self) -> float:
        return self.clock()

    # -------------------------------------------------------- generic API

    def span_begin(self, key, name: str, track: str, rid: int | None = None,
                   **attrs) -> Span:
        """Open a span under ``key`` (any hashable); re-opening a live key
        closes the old span first (never silently drops one)."""
        if key in self._open:
            self.span_end(key)
        if self.current_tick is not None:
            attrs.setdefault("tick", self.current_tick)
        sp = Span(name, track, self.now(), rid=rid, attrs=attrs)
        self._open[key] = sp
        self.spans.append(sp)
        return sp

    def span_end(self, key, **attrs) -> Span | None:
        """Close the span opened under ``key`` (no-op for unknown keys —
        lifecycle paths may legitimately close a span twice, e.g. abort
        racing evict)."""
        sp = self._open.pop(key, None)
        if sp is None:
            return None
        sp.end = self.now()
        if self.current_tick is not None:
            attrs.setdefault("end_tick", self.current_tick)
        sp.attrs.update(attrs)
        return sp

    def add_span(self, name: str, start: float, end: float, track: str,
                 rid: int | None = None, **attrs) -> Span:
        """Record an already-timed duration (caller holds t0/t1)."""
        if self.current_tick is not None:
            attrs.setdefault("tick", self.current_tick)
        sp = Span(name, track, start, end, rid=rid, attrs=attrs)
        self.spans.append(sp)
        return sp

    def event(self, name: str, track: str = "ticks", rid: int | None = None,
              t: float | None = None, **attrs) -> None:
        """Record an instant event (Chrome ``ph: "i"``)."""
        if self.current_tick is not None:
            attrs.setdefault("tick", self.current_tick)
        self.events.append((name, self.now() if t is None else t, track,
                            rid, attrs))

    # -------------------------------------------------- request lifecycle

    def request_submitted(self, rid: int) -> None:
        self._submit_t[rid] = self.now()
        self.metrics.count("requests.submitted")
        self.span_begin(("queued", rid), "queued", "queue", rid=rid)

    def request_admitted(self, rid: int, slot: int,
                         resumed: bool = False) -> None:
        self.span_end(("queued", rid), slot=slot, resumed=resumed)
        self.metrics.count("requests.admitted")
        if resumed:
            self.metrics.count("requests.resumed")

    def request_requeued(self, rid: int, reason: str) -> None:
        """Back to the queue (preemption): a fresh ``queued`` span opens
        with the reason attached."""
        self.span_begin(("queued", rid), "queued", "queue", rid=rid,
                        requeued=True, reason=reason)

    def first_token(self, rid: int, track: str,
                    ttft_ticks: int | None = None) -> None:
        t = self.now()
        self._first_t.setdefault(rid, t)
        if ttft_ticks is not None:
            self.ttft_ticks.setdefault(rid, int(ttft_ticks))
        self.event("first_token", track=track, rid=rid, t=t)
        sub = self._submit_t.get(rid)
        if sub is not None:
            self.metrics.observe("ttft_s", t - sub)

    def decode_begin(self, rid: int, track: str) -> None:
        """Open the request's decode-residency span — idempotent, so the
        per-tick decode paths can call it unconditionally."""
        if ("decode", rid) not in self._open:
            self.span_begin(("decode", rid), "decode", track, rid=rid)

    def request_finished(self, rid: int, track: str, reason: str,
                         n_tokens: int) -> None:
        t = self.now()
        self.span_end(("queued", rid), outcome=reason)  # aborted-in-queue
        self.span_end(("decode", rid), outcome=reason)
        self.event("finish", track=track, rid=rid, t=t, reason=reason,
                   tokens=n_tokens)
        self.metrics.count("requests.finished")
        self.metrics.count(f"requests.finish_reason.{reason}")
        sub = self._submit_t.pop(rid, None)
        first = self._first_t.pop(rid, None)
        if sub is not None:
            self.metrics.observe("e2e_s", t - sub)
        if first is not None and n_tokens > 1:
            self.metrics.observe("tpot_s", (t - first) / (n_tokens - 1))

    # ---------------------------------------------------------- tick API

    def tick_begin(self, tick: int, mode: str) -> None:
        self._tick_open = (int(tick), self.now(), mode)
        self.current_tick = int(tick)
        self._tick_compiles = 0
        self._tick_hits = 0

    def shape_dispatch(self, new: bool) -> None:
        """One step call this tick; ``new``: the first call of its shape
        (``Scheduler._register_shape``)."""
        if new:
            self._tick_compiles += 1
            self.metrics.count("compile.shapes")
            if self._tick_open is not None:
                self.event("compile", track="ticks",
                           tick=self._tick_open[0])
        else:
            self._tick_hits += 1
        self.metrics.count("compile.dispatches")

    def tick_end(self, *, tokens: int = 0, pad_tokens: int | None = None,
                 pages_in_use: int = 0, pages_shared: int = 0,
                 swap_bytes: int = 0, queue_depth: int = 0,
                 active_slots: int = 0, prefilling_slots: int = 0) -> None:
        if self._tick_open is None:
            return
        tick, t_start, mode = self._tick_open
        self._tick_open = None
        self.current_tick = None
        wall = self.now() - t_start
        rec = TickRecord(tick, t_start, wall, mode, int(tokens),
                         None if pad_tokens is None else int(pad_tokens),
                         self._tick_compiles, self._tick_hits,
                         int(pages_in_use), int(pages_shared),
                         int(swap_bytes), int(queue_depth),
                         int(active_slots), int(prefilling_slots))
        self.ticks.append(rec)
        m = self.metrics
        m.observe("tick.wall_s", wall)
        m.count("tick.count")
        m.count("tick.tokens", rec.tokens)
        if rec.pad_tokens is not None:
            m.count("tick.pad_tokens", rec.pad_tokens)
        m.gauge("pool.pages_in_use", rec.pages_in_use)
        m.gauge("pool.pages_shared", rec.pages_shared)
        m.gauge("pool.swap_bytes", rec.swap_bytes)
        m.gauge("queue.depth", rec.queue_depth)
        m.observe("queue.depth_per_tick", rec.queue_depth)
        m.observe("pool.pages_in_use_per_tick", rec.pages_in_use)

    # ----------------------------------------------------------- exporters

    def metrics_dict(self) -> dict:
        """The flat metrics dict (counters + gauges + histogram
        summaries) — ``LLMServer.metrics()`` and benchmark artifacts."""
        return self.metrics.flat()

    def _us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def export_chrome_trace(self, path: str | None = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable). Tracks become
        threads of one process: tid 0 is the ``ticks`` track, tid 1 the
        ``queue`` track, ``slot<i>`` tracks follow in slot order, then
        any remaining tracks in first-seen order. Spans still open at
        export time are emitted closed at the export instant with
        ``"open": true``. The flat metrics dict rides along under the
        top-level ``repro_metrics`` key. Returns the trace dict;
        ``path`` additionally writes it as JSON."""
        order = {"ticks": 0, "queue": 1}

        def tid(track: str) -> int:
            if track not in order:
                if track.startswith("slot"):
                    try:  # keep slot tracks contiguous from tid 2
                        order[track] = 2 + int(track[4:])
                    except ValueError:
                        order[track] = 1000 + len(order)
                else:
                    order[track] = 1000 + len(order)
            return order[track]

        now = self.now()
        events: list = []
        for sp in self.spans:
            end = now if sp.end is None else sp.end
            args = dict(sp.attrs)
            if sp.rid is not None:
                args["rid"] = sp.rid
            if sp.end is None:
                args["open"] = True
            events.append({
                "name": sp.name, "ph": "X", "cat": "span", "pid": 0,
                "tid": tid(sp.track), "ts": self._us(sp.start),
                "dur": max(0.0, self._us(end) - self._us(sp.start)),
                "args": args})
        for name, t, track, rid, attrs in self.events:
            args = dict(attrs)
            if rid is not None:
                args["rid"] = rid
            events.append({"name": name, "ph": "i", "cat": "instant",
                           "pid": 0, "tid": tid(track),
                           "ts": self._us(t), "s": "t", "args": args})
        for rec in self.ticks:
            args = dataclasses.asdict(rec)
            del args["start"], args["wall_s"]
            events.append({
                "name": f"tick[{rec.mode}]", "ph": "X", "cat": "tick",
                "pid": 0, "tid": tid("ticks"), "ts": self._us(rec.start),
                "dur": rec.wall_s * 1e6, "args": args})
        meta = [{"name": "process_name", "ph": "M", "pid": 0,
                 "args": {"name": "repro_torch.serving"}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
                  "args": {"name": track}} for track, t in order.items()]
        meta += [{"name": "thread_sort_index", "ph": "M", "pid": 0,
                  "tid": t, "args": {"sort_index": t}}
                 for track, t in order.items()]
        trace = {"traceEvents": meta + events, "displayTimeUnit": "ms",
                 "repro_metrics": self.metrics_dict()}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace
