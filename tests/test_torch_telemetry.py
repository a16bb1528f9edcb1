"""The port's serving telemetry on the CPU, held against the reference
(``tests/test_telemetry.py``'s cases): the streaming histogram and the
registry give the reference's numbers on the same values; the preemption
workload traced through the reference ``Scheduler`` and through the port's
records the same spans, events, tick records, metric keys and swap bytes;
tracing never changes a stream (fused, paged and split backends); the
disabled path touches no tracer and adds no sync; the Chrome trace
validates with ``tools/trace_report.py``; and ``LLMServer.metrics()`` and
the split engine's wire accounting."""

import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.telemetry import Histogram as JHistogram
from repro.serving.telemetry import MetricsRegistry as JRegistry
from repro.serving.telemetry import TickRecord as JTickRecord
from repro.serving.telemetry import Tracer as JTracer
from repro_torch.configs import get_config
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.sampling import SamplingParams
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import from_jax_params
from repro_torch.serving import (Histogram, MetricsRegistry, Span,
                                 TickRecord, Tracer)
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import scheduler as scheduler_mod
from repro_torch.serving import split_engine as split_mod
from repro_torch.serving.api import FusedBackend, LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import SplitEngine
from tools.trace_report import main as report_main
from tools.trace_report import report, validate

torch.set_num_threads(2)

OPTS = RuntimeOpts(q_chunk=16, kv_chunk=16)
OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
JOPTS_Q = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                         quantized_kv=True, moe_capacity_factor=0.0)
PHASES = ("queued", "prefill", "first_token", "decode", "preempt",
          "swap_resume", "finish")


@pytest.fixture(scope="module")
def tiny_model():
    """The reference tests' model: ``init_params(PRNGKey(0))``, bridged."""
    cfg = get_config("llama2-7b-tiny")
    jparams = JT.init_params(jax_config("llama2-7b-tiny"),
                             jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


# --------------------------------------------------- histogram, registry


def test_histogram_matches_reference():
    """1..10000, a spread of magnitudes and the zero bucket: every summary
    and quantile equals the reference sketch's; the edge cases raise as
    the reference's do."""
    rng = np.random.default_rng(0)
    for values in (np.arange(1, 10001, dtype=np.float64),
                   np.exp(rng.normal(0, 4, 2000)),
                   np.array([0.0, 0.0, 5.0, -1.0, 3.5])):
        h, jh = Histogram(rel_err=0.01), JHistogram(rel_err=0.01)
        for v in values:
            h.record(float(v))
            jh.record(float(v))
        assert h.summary() == jh.summary()
        for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
            assert h.percentile(q) == jh.percentile(q)
    h = Histogram()
    for v in range(1, 10001):
        h.record(float(v))
    for q in (0.10, 0.50, 0.95, 0.99):
        assert h.percentile(q) == pytest.approx(q * 9999 + 1, rel=0.021)
    empty = Histogram()
    assert empty.percentile(0.5) is None and empty.mean is None
    assert empty.summary() == {"count": 0}
    with pytest.raises(ValueError):
        h.percentile(1.5)
    with pytest.raises(ValueError):
        Histogram(rel_err=0.0)


def test_metrics_registry_matches_reference():
    m, jm = MetricsRegistry(), JRegistry()
    for reg in (m, jm):
        reg.count("a")
        reg.count("a", 4)
        reg.gauge("g", 7.5)
        reg.observe("h", 2.0)
        reg.observe("h", 4.0)
    assert m.flat() == jm.flat()
    assert m.flat()["a"] == 5 and m.flat()["h.count"] == 2


def test_open_spans_and_trace_format_match_reference():
    """On an injected clock the port's Chrome trace is the reference's,
    event for event (the process name aside): track ids (ticks 0, queue 1,
    slot<i> 2+i), an open span closed at the export instant, instants,
    tick records, ``displayTimeUnit`` and ``repro_metrics``."""
    traces = []
    for cls in (Tracer, JTracer):
        t = [0.0]
        tr = cls(clock=lambda: t[0])
        tr.request_submitted(1)
        tr.tick_begin(1, "chunked")
        tr.shape_dispatch(True)
        tr.request_admitted(1, 0)
        t[0] = 0.5
        tr.add_span("prefill", 0.0, 0.5, track="slot0", rid=1, tokens=4)
        tr.first_token(1, "slot0", ttft_ticks=1)
        tr.decode_begin(1, "slot0")
        t[0] = 1.0
        tr.tick_end(tokens=5, pages_in_use=2, queue_depth=0,
                    active_slots=1)
        tr.request_submitted(2)
        t[0] = 2.0
        traces.append(tr.export_chrome_trace())
    got, want = traces
    assert got["traceEvents"][0]["args"]["name"] == "repro_torch.serving"
    assert got["traceEvents"][1:] == want["traceEvents"][1:]
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    assert got["repro_metrics"] == want["repro_metrics"]
    spans = [e for e in got["traceEvents"] if e.get("cat") == "span"]
    assert spans[-1]["args"]["open"] is True
    assert spans[-1]["dur"] == pytest.approx(1e6)  # open from 1 s to 2 s
    assert isinstance(Tracer().span_begin("k", "x", "t"), Span)
    assert TickRecord.__annotations__ == JTickRecord.__annotations__


# ------------------------------------------- the traced preemption workload


def _preemption_run(make, tracer, abort_one=True):
    """The reference's preemption workload (lazy growth over a pool too
    small for every worst case: evictions and swap resumes) on the
    scheduler ``make(**kw)`` builds."""
    rng = np.random.default_rng(11)
    jobs = [(6, 8, 1), (5, 9, 0), (4, 8, 0)]  # (prompt, max_new, priority)
    prompts = [rng.integers(0, 256, (n,)) for n, _, _ in jobs]
    sched = make(num_pages=9, page_size=4, max_slots=3, lazy_growth=True,
                 resume="swap", telemetry=tracer)
    rids = [sched.submit(p, mn, priority=pr)
            for p, (_, mn, pr) in zip(prompts, jobs)]
    if abort_one:
        sched.abort(sched.submit(rng.integers(0, 256, (4,)), 6))
    results = sched.run()
    assert sched.stats.preemptions >= 1
    return sched, [results[r] for r in rids]


@pytest.fixture(scope="module")
def traced_runs(tiny_model):
    """The workload traced on the reference and on the port, and on the
    port untraced: ((sched, tracer, streams) x 2, untraced streams)."""
    cfg, jparams, params = tiny_model
    jtr, tr = JTracer(), Tracer()
    jsched, jres = _preemption_run(
        lambda **kw: JaxScheduler(jax_config("llama2-7b-tiny"), jparams,
                                  JOPTS_Q, **kw), jtr)
    port = lambda **kw: Scheduler(cfg, params, OPTS_Q, device="cpu", **kw)
    sched, res = _preemption_run(port, tr)
    _, res_off = _preemption_run(port, None)
    return (jsched, jtr, jres), (sched, tr, res), res_off


def test_traced_workload_matches_reference(traced_runs):
    """Spans (name, track, rid, attributes; timestamps not compared),
    instant events, tick records (token, pad, shape, pool and queue
    counts), metric keys and counters, and the swap bytes are the
    reference's on the same workload."""
    (_, jtr, jres), (sched, tr, res), _ = traced_runs
    for a, b in zip(res, jres):
        np.testing.assert_array_equal(a, np.asarray(b))

    def spans(t):
        return sorted((sp.name, sp.track, sp.rid,
                       json.dumps(sp.attrs, sort_keys=True))
                      for sp in t.spans)

    def events(t):
        return sorted((name, track, rid, json.dumps(attrs, sort_keys=True))
                      for name, _, track, rid, attrs in t.events)

    assert spans(tr) == spans(jtr)
    assert events(tr) == events(jtr)
    fields = ("tick", "mode", "tokens", "pad_tokens", "new_compiles",
              "shape_hits", "pages_in_use", "pages_shared", "swap_bytes",
              "queue_depth", "active_slots", "prefilling_slots")
    assert [tuple(getattr(r, f) for f in fields) for r in tr.ticks] == \
        [tuple(getattr(r, f) for f in fields) for r in jtr.ticks]
    m, jm = tr.metrics_dict(), jtr.metrics_dict()
    assert set(m) == set(jm)
    assert tr.metrics.counters == jtr.metrics.counters
    for name in ("swap_out", "swap_resume"):
        got = sorted(sp.attrs["bytes"] for sp in tr.spans if sp.name == name)
        want = sorted(sp.attrs["bytes"] for sp in jtr.spans
                      if sp.name == name)
        assert got == want and got
    assert tr.ttft_ticks == jtr.ttft_ticks
    assert sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0


def test_span_lifecycle_covers_every_phase(traced_runs):
    """Every lifecycle phase lands; every span closes with a non-negative
    duration; the preempted request's requeued span names its reason;
    ticks are in order and their shape counts sum to the scheduler's."""
    _, (sched, tr, _), _ = traced_runs
    names = {sp.name for sp in tr.spans} | {e[0] for e in tr.events}
    assert set(PHASES) | {"swap_out"} <= names
    assert all(sp.end is not None and sp.duration >= 0.0 for sp in tr.spans)
    requeued = [sp for sp in tr.spans
                if sp.name == "queued" and sp.attrs.get("requeued")]
    assert requeued and requeued[0].attrs["reason"] == "preempt"
    ticks = tr.ticks
    assert [r.tick for r in ticks] == list(range(1, sched._tick + 1))
    assert all(r.wall_s >= 0 and r.mode == "chunked" for r in ticks)
    assert sum(r.new_compiles for r in ticks) == sched.stats.compiled_shapes
    assert ticks[-1].pages_in_use == 0 and ticks[-1].queue_depth == 0
    assert max(r.swap_bytes for r in ticks) > 0
    m = tr.metrics_dict()
    assert m["requests.finish_reason.abort"] == 1
    assert m["tick.count"] == len(ticks)


def test_greedy_streams_identical_with_telemetry_on_and_off(tiny_model,
                                                            traced_runs):
    """Tracing observes and never perturbs: the paged workload's streams,
    a fused server's and a split server's are bit for bit the same with a
    tracer and without."""
    _, (_, _, res_on), res_off = traced_runs
    for a, b in zip(res_on, res_off):
        np.testing.assert_array_equal(a, b)
    cfg, _, params = tiny_model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 5, 7)]
    opsc = OPSCConfig(split_layer=1, qw_front=8, i_kv=1)
    for kw in (dict(backend="fused", cache_len=32),
               dict(backend="split", opsc=opsc, cache_len=32)):
        outs = []
        for telemetry in (None, True):
            srv = LLMServer(cfg, params, OPTS_Q, device="cpu",
                            telemetry=telemetry, **kw)
            rids = [srv.submit(p, SamplingParams(max_tokens=4))
                    for p in prompts]
            got = srv.run()
            outs.append([(got[r].tokens, got[r].finish_reason) for r in rids])
        for (a, ra), (b, rb) in zip(*outs):
            np.testing.assert_array_equal(a, b)
            assert ra == rb


def test_disabled_path_never_touches_tracer_nor_syncs(tiny_model,
                                                      monkeypatch):
    """With ``telemetry=None`` no Tracer method runs (each raises) and no
    stream sync is made (``stream_sync`` and ``torch.cuda.synchronize``
    counted) through a preemption run, a fused and a split generation;
    with a tracer the same runs sync before their spans end."""
    cfg, _, params = tiny_model
    syncs = []
    for mod in (scheduler_mod, engine_mod, split_mod):
        monkeypatch.setattr(mod, "stream_sync",
                            lambda dev: syncs.append(dev))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append("cuda"))

    def drive(tracer):
        sched, _ = _preemption_run(
            lambda **kw: Scheduler(cfg, params, OPTS_Q, device="cpu", **kw),
            tracer, abort_one=False)
        Engine(cfg, params, OPTS_Q, cache_len=32, telemetry=tracer,
               device="cpu").generate(np.arange(4)[None], 3)
        SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=16),
                    opts=OPTS, cache_len=32, telemetry=tracer,
                    device="cpu").generate(np.arange(5)[None], 3,
                                           compress=False)
        return sched

    traced = Tracer()
    drive(traced)
    n_traced = len(syncs)
    assert n_traced > 0 and "cuda" not in syncs

    def boom(self, *a, **k):  # pragma: no cover - must never fire
        raise AssertionError("Tracer touched on the disabled path")

    for name in dir(Tracer):
        if not name.startswith("_"):
            monkeypatch.setattr(Tracer, name, boom)
    syncs.clear()
    sched = drive(None)
    assert sched.telemetry is None and sched._swap.telemetry is None
    assert syncs == []


# ----------------------------------------------------- chrome trace export


def test_chrome_trace_schema_and_report(traced_runs, tmp_path):
    """The port's trace is Chrome trace-event JSON with stable track ids,
    and the unmodified ``tools/trace_report.py`` validates it with all 7
    phases required, in process and from its command line."""
    _, (_, tr, _), _ = traced_runs
    path = tmp_path / "trace.json"
    trace = tr.export_chrome_trace(str(path))
    on_disk = json.loads(path.read_text())
    assert on_disk["displayTimeUnit"] == "ms"
    assert on_disk["repro_metrics"] == pytest.approx(trace["repro_metrics"])
    evs = trace["traceEvents"]
    assert all({"name", "ph", "pid"} <= set(e) for e in evs)
    for e in evs:
        if e["ph"] == "X":
            assert e["ts"] >= 0 and e["dur"] >= 0
    tids = {e["args"]["name"]: e["tid"] for e in evs
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert tids["ticks"] == 0 and tids["queue"] == 1 and tids["slot0"] == 2
    assert validate(trace, require_phases=PHASES, min_spans=5,
                    min_ticks=5) == []
    buf = io.StringIO()
    report(trace, out=buf)
    assert "prefill" in buf.getvalue() and "SLO table" in buf.getvalue()
    assert report_main([str(path), "--require-ticks", "5",
                        "--require-phases", ",".join(PHASES)]) == 0
    assert report_main([str(path), "--require-phases", "warpdrive"]) == 1


# ------------------------------------------------------ server integration


def test_llmserver_metrics_and_ttft_ticks(tiny_model):
    """Paged with a tracer: the tracer's registry merged into
    ``metrics()``, TTFT in ticks from the tracer; fused: tick 1 and a
    ``fused_generate`` span with its counters."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(3)
    srv = LLMServer(cfg, params, OPTS_Q, backend="paged", num_pages=24,
                    page_size=4, max_slots=3, telemetry=True, device="cpu")
    assert isinstance(srv.tracer, Tracer)
    rids = [srv.submit(rng.integers(0, cfg.vocab_size, (n,)),
                       SamplingParams(max_tokens=4)) for n in (5, 7)]
    outs = srv.run()
    m = srv.metrics()
    assert m["requests.submitted"] == 2 and m["requests.finished"] == 2
    assert m["ttft_s.count"] == 2 and m["tick.count"] >= 1
    assert m["requests.retained"] == 2 and m["requests.reason.length"] == 2
    for rid in rids:
        assert outs[rid].metrics.ttft_ticks == srv.tracer.ttft_ticks[rid]
    srv = LLMServer(cfg, params, OPTS_Q, backend="fused", cache_len=32,
                    telemetry=True, device="cpu")
    rid = srv.submit(rng.integers(0, cfg.vocab_size, (5,)),
                     SamplingParams(max_tokens=4))
    assert srv.run()[rid].metrics.ttft_ticks == 1
    assert "fused_generate" in {sp.name for sp in srv.tracer.spans}
    m = srv.metrics()
    assert m["fused.calls"] == 1 and m["fused.tokens"] == 4
    assert m["fused.batch_s.count"] == 1
    with pytest.raises(ValueError, match="telemetry"):
        LLMServer(backend=FusedBackend(cfg, params, OPTS_Q, cache_len=32,
                                       device="cpu"), telemetry=Tracer())


def test_split_backend_telemetry_wire_accounting(tiny_model):
    """Edge and cloud spans for prefill and decode, uplink events whose
    bits sum to ``SplitStats.uplink_bits_measured``, which the
    ``split.uplink_bits_measured`` metric equals, and TAB-Q's widths one
    histogram entry per uplinked token."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(6)
    opsc = OPSCConfig(split_layer=1, qw_front=16, i_kv=1)
    srv = LLMServer(cfg, params, OPTS, backend="split", opsc=opsc,
                    cache_len=32, telemetry=True, device="cpu")
    rid = srv.submit(rng.integers(0, cfg.vocab_size, (6,)),
                     SamplingParams(max_tokens=4))
    out = srv.run()[rid]
    assert out.metrics.ttft_ticks == 1
    tr = srv.tracer
    stages = {sp.attrs.get("stage") for sp in tr.spans
              if sp.track == "split:edge"}
    assert {"prefill", "decode"} <= stages
    uplinks = [e for e in tr.events if e[0] == "uplink"]
    assert sum(e[4]["bits"] for e in uplinks) \
        == out.split_stats.uplink_bits_measured
    m = tr.metrics_dict()
    assert m["split.uplink_bits_measured"] \
        == out.split_stats.uplink_bits_measured
    # 6 prompt tokens, then one a decode step
    assert m["split.tabq_bits.count"] == 6 + out.split_stats.tokens_generated
    assert 1 <= m["split.tabq_bits.min"] <= m["split.tabq_bits.max"] <= 16
    assert m["split.edge_s.count"] >= 2 and m["split.cloud_s.count"] >= 2
    assert m["transport.tabq_uplink.transfers"] == len(uplinks)


def test_pool_swap_bytes_accounting(tiny_model):
    """``swap_bytes`` tracks the bytes parked on the host: export raises
    it, restore and discard return it to zero."""
    cfg, _, _ = tiny_model
    pool = PagedKVPool(cfg, num_pages=8, page_size=4, max_requests=2,
                       device="cpu")
    assert pool.gauges()["swap_bytes"] == 0
    slot = pool.admit(6)
    pool.commit_prefill(slot, 6)
    snap = pool.export_slot(slot)
    nbytes = PagedKVPool.snapshot_bytes(snap)
    assert nbytes > 0 and pool.gauges()["swap_bytes"] == nbytes
    pool.free(slot)
    slot2 = pool.restore_slot(snap)
    assert pool.gauges()["swap_bytes"] == 0
    snap2 = pool.export_slot(slot2)
    assert pool.gauges()["swap_bytes"] == PagedKVPool.snapshot_bytes(snap2)
    pool.discard_snapshot(snap2)
    assert pool.gauges()["swap_bytes"] == 0
