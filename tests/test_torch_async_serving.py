"""The port's async serving front end (``serving.async_engine`` +
``serving.http``) on the CPU, the cases of ``tests/test_async_serving.py``
held against the reference ``Scheduler``'s streams for the same prompts:
concurrent HTTP/SSE streams with automatic prefix detection, a
non-streaming completion and ``/v1/metrics``, a disconnect that frees its
pages, 429 backpressure, SSE framing, draining and aborting shutdown,
bounded admission, the scheduler's thread contracts (single-driver step
guard, lossless concurrent event drains), auto-prefix parity with the
reference's hit and fork counts; and what is new on the port: a failing
tick thread reaches every stream and the caller, and the demo's
deployment and device refusals."""

import argparse
import asyncio
import json
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.core.sampling import SamplingParams
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import from_jax_params
from repro_torch.serving import http as http_mod
from repro_torch.serving.api import LLMServer
from repro_torch.serving.async_engine import (AdmissionError,
                                              AsyncLLMServer,
                                              EngineClosedError)
from repro_torch.serving.http import ServingHTTPServer, SSEParser, sse_frame
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(2)

OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
JOPTS_Q = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                         quantized_kv=True, moe_capacity_factor=0.0)
VOCAB = 256  # llama2-7b-tiny's


def _eight_prompts():
    """Eight prompts, half sharing a 10-token head, and their max_tokens."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, VOCAB, (10,))
    prompts = []
    for i in range(8):
        tail = rng.integers(0, VOCAB, (3 + i % 3,))
        prompts.append(np.concatenate([shared, tail]) if i % 2 == 0
                       else rng.integers(0, VOCAB, (5 + i % 4,)))
    return prompts, [4 + i % 4 for i in range(8)]


def _auto_prompts():
    """Three prompts sharing a 12-token head and one that shares nothing."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, VOCAB, (12,))
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, (2 + i,))])
               for i in range(3)]
    prompts.append(rng.integers(0, VOCAB, (6,)))
    return prompts


NONSTREAM_PROMPT = np.random.default_rng(1).integers(0, VOCAB, (6,))
DRAIN_PROMPTS = [np.random.default_rng(4).integers(0, VOCAB, (5 + i,))
                 for i in range(2)]


@pytest.fixture(scope="module")
def tiny_model():
    """The reference tests' model: ``init_params(PRNGKey(0))``, bridged."""
    cfg = get_config("llama2-7b-tiny")
    jparams = JT.init_params(jax_config("llama2-7b-tiny"),
                             jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def reference(tiny_model):
    """One reference ``Scheduler(auto_prefix=True)`` (32 pages of 4, 4
    slots), fed in three drains: the auto-prefix prompts (its hit and fork
    counts), the eight HTTP prompts (their hits), then the rest; the
    greedy streams of every prompt, keyed by the prompt's bytes."""
    _, jparams, _ = tiny_model
    sched = JaxScheduler(jax_config("llama2-7b-tiny"), jparams, JOPTS_Q,
                         num_pages=32, page_size=4, max_slots=4,
                         auto_prefix=True)
    eight, eight_tokens = _eight_prompts()
    streams, counts = {}, {}
    batches = (("auto", _auto_prompts(), [4] * 4),
               ("eight", eight, eight_tokens),
               ("rest", [NONSTREAM_PROMPT] + DRAIN_PROMPTS, [5, 6, 6]))
    for name, prompts, max_tokens in batches:
        hits, forks = (sched.stats.auto_prefix_hits,
                       sched.stats.prefix_forks)
        rids = [sched.submit(p, mt) for p, mt in zip(prompts, max_tokens)]
        results = sched.run()
        for rid, p in zip(rids, prompts):
            streams[p.tobytes()] = np.asarray(results[rid][p.size:])
        counts[name] = (sched.stats.auto_prefix_hits - hits,
                        sched.stats.prefix_forks - forks)
    return streams, counts


def _want(reference, prompt):
    return reference[0][np.asarray(prompt).tobytes()]


def _paged(cfg, params, **kw):
    kw.setdefault("num_pages", 32)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_slots", 3)
    return LLMServer(cfg, params, OPTS_Q, backend="paged", device="cpu",
                     **kw)


def _run(coro, timeout=60.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# ------------------------------------------------- raw HTTP test client


async def _open(host, port, method, path, body=None):
    reader, writer = await asyncio.open_connection(host, port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    status = await reader.readline()
    code = int(status.split()[1])
    headers = {}
    while (h := await reader.readline()) not in (b"\r\n", b"\n", b""):
        k, _, v = h.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    return reader, writer, code, headers


async def _request_json(host, port, method, path, body=None):
    reader, writer, code, headers = await _open(host, port, method, path,
                                                body)
    raw = await reader.read()  # Connection: close — EOF-terminated
    writer.close()
    return code, headers, json.loads(raw) if raw else None


async def _stream_completion(host, port, body):
    """POST a streaming completion; (code, headers, the SSE payloads up to
    and including "[DONE]")."""
    reader, writer, code, headers = await _open(
        host, port, "POST", "/v1/completions", dict(body, stream=True))
    msgs, parser = [], SSEParser()
    if code == 200:
        while True:
            chunk = await reader.read(4096)
            if not chunk:
                break
            msgs += parser.feed(chunk)
            if msgs and msgs[-1] == "[DONE]":
                break
    writer.close()
    return code, headers, msgs


def _tokens_of(msgs):
    return [m["token"] for m in msgs
            if m != "[DONE]" and not m.get("finished")]


async def _boot(cfg, params, *, max_queue_depth=64, **server_kw):
    engine = AsyncLLMServer(_paged(cfg, params, **server_kw),
                            max_queue_depth=max_queue_depth)
    http = ServingHTTPServer(engine)
    await http.start()
    return http, engine


# ------------------------------------------- concurrent HTTP bit-parity


def test_eight_concurrent_http_streams_match_reference(tiny_model,
                                                       reference):
    """Eight concurrent clients over real HTTP, with auto_prefix on, stream
    the reference scheduler's greedy tokens; the finish metadata survives
    SSE; detection attaches as many requests as the reference's; no page
    is left in use."""
    cfg, _, params = tiny_model
    prompts, max_tokens = _eight_prompts()

    async def go():
        http, engine = await _boot(cfg, params, auto_prefix=True)
        try:
            outs = await asyncio.gather(*[
                _stream_completion(http.host, http.port,
                                   {"prompt": p.tolist(), "max_tokens": mt})
                for p, mt in zip(prompts, max_tokens)])
        finally:
            await http.stop()
        return outs, engine

    outs, engine = _run(go())
    for (code, _, msgs), p in zip(outs, prompts):
        assert code == 200
        np.testing.assert_array_equal(_tokens_of(msgs), _want(reference, p))
        fin = [m for m in msgs if m != "[DONE]" and m.get("finished")]
        assert len(fin) == 1 and fin[0]["finish_reason"] == "length"
        assert msgs[-1] == "[DONE]"
        assert all(np.isfinite(m["logprob"]) for m in msgs
                   if m != "[DONE]" and not m.get("finished"))
    sched = engine.server.backend.scheduler
    # one hit a shared-head prompt after the first, in any arrival order
    assert sched.stats.auto_prefix_hits == reference[1]["eight"][0] == 3
    assert sched.pool.gauges()["pages_in_use"] == 0


def test_nonstream_completion_and_metrics_endpoint(tiny_model, reference):
    cfg, _, params = tiny_model
    p = NONSTREAM_PROMPT

    async def go():
        http, _ = await _boot(cfg, params)
        try:
            code, _, body = await _request_json(
                http.host, http.port, "POST", "/v1/completions",
                {"prompt": p.tolist(), "max_tokens": 5})
            hcode, _, health = await _request_json(
                http.host, http.port, "GET", "/healthz")
            mcode, _, metrics = await _request_json(
                http.host, http.port, "GET", "/v1/metrics")
            ncode, _, _ = await _request_json(
                http.host, http.port, "GET", "/nope")
            bcode, _, bad = await _request_json(
                http.host, http.port, "POST", "/v1/completions",
                {"prompt": "not a list"})
        finally:
            await http.stop()
        return code, body, hcode, health, mcode, metrics, ncode, bcode, bad

    (code, body, hcode, health, mcode, metrics, ncode, bcode,
     bad) = _run(go())
    assert code == 200 and hcode == 200 and mcode == 200 and ncode == 404
    assert bcode == 400 and "prompt" in bad["error"]
    np.testing.assert_array_equal(body["tokens"], _want(reference, p))
    assert body["finish_reason"] == "length"
    assert len(body["logprobs"]) == len(body["tokens"])
    assert body["metrics"]["ttft_s"] > 0 and body["metrics"]["e2e_s"] > 0
    assert health["status"] == "ok"
    # the tick-thread-stamped SLO surface, correct with telemetry=None
    assert metrics["requests.e2e_s.count"] == 1
    assert metrics["requests.tpot_s.count"] == 1
    assert metrics["requests.ttft_s.p50"] > 0
    assert metrics["requests.reason.length"] == 1


# ------------------------------------------------- disconnect → no leak


def test_midstream_disconnect_frees_pool_pages(tiny_model):
    """A client that vanishes after one token aborts its request and
    leaves no page in use once the scheduler settles."""
    cfg, _, params = tiny_model
    p = np.random.default_rng(2).integers(0, cfg.vocab_size, (8,))

    async def go():
        http, engine = await _boot(cfg, params)
        try:
            reader, writer, code, _ = await _open(
                http.host, http.port, "POST", "/v1/completions",
                {"prompt": p.tolist(), "max_tokens": 32, "stream": True})
            assert code == 200
            parser, got = SSEParser(), []
            while not got:  # first token arrived ⇒ request holds pages
                got += parser.feed(await reader.read(4096))
            writer.close()  # hang up mid-stream, no abort RPC
            await writer.wait_closed()
            sched = engine.server.backend.scheduler
            for _ in range(500):
                if not engine.server.pending and \
                        sched.pool.gauges()["pages_in_use"] == 0:
                    break
                await asyncio.sleep(0.01)
            gauges = sched.pool.gauges()
            out = await engine.result(next(iter(engine.server.outputs())))
        finally:
            await http.stop()
        return gauges, out

    gauges, out = _run(go())
    assert gauges["pages_in_use"] == 0 and gauges["pages_shared"] == 0
    assert out.finish_reason == "abort"
    assert out.metrics.e2e_s is not None  # aborts are stamped too


# ---------------------------------------------------- 429 backpressure


def test_backpressure_returns_429(tiny_model):
    """max_slots=1, max_queue_depth=1: A streams (holds the slot), B
    queues, C bounces with 429 and Retry-After."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(3)
    pa, pb, pc = (rng.integers(0, cfg.vocab_size, (5,)) for _ in range(3))

    async def go():
        http, engine = await _boot(cfg, params, max_slots=1,
                                   max_queue_depth=1)
        try:
            ra, wa, code_a, _ = await _open(
                http.host, http.port, "POST", "/v1/completions",
                {"prompt": pa.tolist(), "max_tokens": 24, "stream": True})
            assert code_a == 200
            parser, got = SSEParser(), []
            while not got:  # A is admitted and decoding
                got += parser.feed(await ra.read(4096))
            b_task = asyncio.ensure_future(_request_json(
                http.host, http.port, "POST", "/v1/completions",
                {"prompt": pb.tolist(), "max_tokens": 2}))
            for _ in range(500):  # B accepted → scheduler queue depth 1
                _, _, health = await _request_json(
                    http.host, http.port, "GET", "/healthz")
                if health["queue_depth"] >= 1:
                    break
                await asyncio.sleep(0.01)
            assert health["queue_depth"] == 1
            code_c, headers_c, body_c = await _request_json(
                http.host, http.port, "POST", "/v1/completions",
                {"prompt": pc.tolist(), "max_tokens": 2})
            while got[-1] != "[DONE]":  # drain A; the slot frees for B
                got += parser.feed(await ra.read(4096))
            wa.close()
            code_b, _, body_b = await b_task
        finally:
            await http.stop()
        return code_c, headers_c, body_c, code_b, body_b

    code_c, headers_c, body_c, code_b, body_b = _run(go())
    assert code_c == 429
    assert headers_c.get("retry-after") == "1"
    assert "admission queue full" in body_c["error"]
    assert code_b == 200 and len(body_b["tokens"]) == 2


# --------------------------------------------------------- SSE framing


def test_sse_framing_round_trips():
    msgs = [{"rid": 7, "index": i, "token": i * 3, "logprob": -0.25 * i}
            for i in range(5)]
    msgs.append({"rid": 7, "index": 5, "token": -1, "finished": True,
                 "finish_reason": "stop"})
    wire = b"".join(sse_frame(m) for m in msgs) + http_mod.SSE_DONE
    # every chunking of the byte stream decodes to the same payloads
    for size in (1, 2, 3, 7, len(wire)):
        parser, got = SSEParser(), []
        for i in range(0, len(wire), size):
            got += parser.feed(wire[i: i + size])
        assert got == msgs + ["[DONE]"]


# ----------------------------------------------------------- shutdown


async def _collect(engine, rid):
    return [ev async for ev in engine.stream(rid)]


def test_graceful_shutdown_drains_inflight(tiny_model, reference):
    cfg, _, params = tiny_model

    async def go():
        engine = AsyncLLMServer(_paged(cfg, params))
        rids = [await engine.submit(p, SamplingParams(max_tokens=6))
                for p in DRAIN_PROMPTS]
        streams = [asyncio.ensure_future(_collect(engine, r)) for r in rids]
        await engine.shutdown(drain=True)  # must NOT cut the streams
        events = await asyncio.gather(*streams)
        with pytest.raises(EngineClosedError) as ei:
            await engine.submit(DRAIN_PROMPTS[0],
                                SamplingParams(max_tokens=2))
        metrics = await engine.metrics()  # read inline after shutdown
        return events, ei.value, metrics

    events, err, metrics = _run(go())
    for evs, p in zip(events, DRAIN_PROMPTS):
        assert evs[-1].finished and evs[-1].finish_reason == "length"
        np.testing.assert_array_equal([e.token for e in evs[:-1]],
                                      _want(reference, p))
    assert "shut down" in str(err)
    assert metrics["requests.reason.length"] == 2


def test_shutdown_now_aborts_inflight(tiny_model):
    cfg, _, params = tiny_model
    p = np.random.default_rng(5).integers(0, cfg.vocab_size, (6,))

    async def go():
        engine = AsyncLLMServer(_paged(cfg, params))
        rid = await engine.submit(p, SamplingParams(max_tokens=64))
        agen = engine.stream(rid)
        first = await agen.__anext__()  # admitted and producing
        await engine.shutdown(drain=False)
        evs = [ev async for ev in agen]  # the abort marker still flushes
        out = await engine.result(rid)
        return first, evs, out, engine

    first, evs, out, engine = _run(go())
    assert not first.finished
    assert evs[-1].finished and evs[-1].finish_reason == "abort"
    assert out.finish_reason == "abort"
    assert engine.server.backend.scheduler.pool.pages_in_use == 0
    assert not engine._thread.is_alive()


def test_admission_error_direct(tiny_model):
    """Bounded admission at the engine API (no HTTP): the check and the
    submit are atomic on the tick thread."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(6)

    async def go():
        engine = AsyncLLMServer(_paged(cfg, params, max_slots=1),
                                max_queue_depth=1)
        r1 = await engine.submit(rng.integers(0, 64, (5,)),
                                 SamplingParams(max_tokens=16))
        agen = engine.stream(r1)
        await agen.__anext__()  # r1 admitted: slot busy, queue empty
        await engine.submit(rng.integers(0, 64, (5,)),
                            SamplingParams(max_tokens=2))  # queues
        with pytest.raises(AdmissionError):
            await engine.submit(rng.integers(0, 64, (5,)),
                                SamplingParams(max_tokens=2))
        async for _ in agen:
            pass
        await engine.shutdown()

    _run(go())


def test_tick_thread_failure_reaches_streams_and_caller(tiny_model,
                                                        monkeypatch):
    """An exception inside the tick thread (here a step that fails on the
    third tick, standing in for a kernel that fails to launch) reaches
    every open stream and a waiting ``result`` as itself, a later submit
    as ``EngineClosedError`` chained to it, and ``shutdown`` re-raises it:
    nothing retries or carries on."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(8)
    srv = _paged(cfg, params)
    step, ticks = srv.backend.step, []

    def failing_step():
        ticks.append(threading.current_thread().name)
        if len(ticks) == 3:
            raise RuntimeError("kernel launch failed")
        return step()

    monkeypatch.setattr(srv.backend, "step", failing_step)

    async def go():
        engine = AsyncLLMServer(srv)
        rids = [await engine.submit(rng.integers(0, 64, (5,)),
                                    SamplingParams(max_tokens=16))
                for _ in range(2)]
        got = []
        for rid in rids:
            with pytest.raises(RuntimeError, match="kernel launch") as ei:
                await _collect(engine, rid)
            got.append(ei.value)
        with pytest.raises(RuntimeError, match="kernel launch"):
            await engine.result(rids[0])
        with pytest.raises(EngineClosedError) as closed:
            await engine.submit(rng.integers(0, 64, (5,)))
        with pytest.raises(RuntimeError, match="kernel launch"):
            await engine.shutdown()
        return got, closed.value, engine

    got, closed, engine = _run(go())
    assert got[0] is got[1] is engine.error
    assert closed.__cause__ is engine.error
    assert set(ticks) == {"asyncllm-tick"}


# ------------------------------------------- scheduler thread contracts


def test_step_guard_rejects_second_driver(tiny_model):
    """Scheduler.step() is single-driver: a second thread calling step()
    mid-tick gets a RuntimeError, not a silent data race."""
    cfg, _, params = tiny_model
    sched = Scheduler(cfg, params, OPTS_Q, num_pages=8, page_size=4,
                      max_slots=2, device="cpu")
    sched.submit(np.arange(4, dtype=np.int32), 2)
    assert sched._step_guard.acquire(blocking=False)  # a tick in flight
    try:
        with pytest.raises(RuntimeError, match="single-driver"):
            sched.step()
    finally:
        sched._step_guard.release()
    sched.run()  # guard released: normal drive still works
    assert sched.pool.pages_in_use == 0


def test_concurrent_event_drain_loses_nothing(tiny_model):
    """drain_events() swaps under the emit lock: a producer hammering
    _emit_event from another thread never loses an event."""
    cfg, _, params = tiny_model
    sched = Scheduler(cfg, params, OPTS_Q, num_pages=8, page_size=4,
                      max_slots=2, device="cpu")
    n = 20000
    done = threading.Event()

    def produce():
        for i in range(n):
            sched._emit_event(1, i, i % 64, -0.5)
        done.set()

    t = threading.Thread(target=produce)
    t.start()
    got = []
    while not (done.is_set() and not sched._events):
        got += sched.drain_events()
    t.join(timeout=30)
    assert not t.is_alive()
    got += sched.drain_events()
    assert [e[1] for e in got] == list(range(n))


# ------------------------------------------------- auto prefix detection


def test_auto_prefix_detection_parity_and_forks(tiny_model, reference):
    """auto_prefix=True: prompts sharing a long head share pages with NO
    explicit prefix_key, stream the plain scheduler's and the reference's
    tokens, and attach and fork exactly as often as the reference's."""
    cfg, _, params = tiny_model
    prompts = _auto_prompts()

    def drain(**kw):
        sched = Scheduler(cfg, params, OPTS_Q, num_pages=32, page_size=4,
                          max_slots=4, device="cpu", **kw)
        rids = [sched.submit(p, 4) for p in prompts]
        results = sched.run()
        return [results[r] for r in rids], sched

    plain, _ = drain()
    auto, sched = drain(auto_prefix=True)
    for a, b, p in zip(plain, auto, prompts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b[p.size:], _want(reference, p))
    hits, forks = reference[1]["auto"]
    assert sched.stats.auto_prefix_hits == hits >= 2
    assert sched.stats.prefix_forks == forks >= 1
    assert sched.pool.pages_in_use == 0 and not sched._auto_keys


# ------------------------------------------------------------ the demo


def test_demo_server_builds_and_refuses_what_is_not_ported():
    """``python -m repro_torch.serving.http``'s server: the tiny paged demo
    on ``--device cpu`` answers a completion, fused and disaggregated
    (the same tokens, the second through the page stream); the sharded
    deployment raises naming its ROADMAP item; the default device raises
    without a card."""
    args = dict(config="llama2-7b", vocab=64, seed=0, num_pages=16,
                max_slots=2, auto_prefix=True, backend="paged",
                deployment="fused", device="cpu")
    srv = http_mod._build_server(argparse.Namespace(**args))
    rid = srv.submit([1, 2, 3], SamplingParams(max_tokens=3))
    fused = srv.run()[rid].tokens
    assert len(fused) == 3
    assert srv.backend.scheduler.auto_prefix
    srv = http_mod._build_server(argparse.Namespace(
        **dict(args, deployment="disaggregated")))
    rid = srv.submit([1, 2, 3], SamplingParams(max_tokens=3))
    np.testing.assert_array_equal(srv.run()[rid].tokens, fused)
    ds = srv.backend.scheduler
    assert ds.prefill.auto_prefix and ds.transport.transfers == 1
    with pytest.raises(NotImplementedError, match="item 8"):
        http_mod._build_server(argparse.Namespace(
            **dict(args, deployment="sharded")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            http_mod._build_server(argparse.Namespace(
                **dict(args, device=None)))
    http_mod.build_serving_kernels(torch.device("cpu"))  # nothing to build
