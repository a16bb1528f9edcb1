"""The port's paged serving path on the CPU: the continuous-batching
``Scheduler`` streams token for token equal to the port's own ``Engine``
(mid-stream admission, multi-chunk prompts, prefix sharing, EOS,
single-token requests, backpressure, wave mode, the adaptive chunk
ladder), the impossible request failing loudly, seeded paged == seeded
fused, one greedy run against the reference ``Scheduler`` on bridged
weights, ``LLMServer(backend="paged")`` stop / abort / release / streaming
order, and the refusals of what is not ported yet (mirroring
``tests/test_scheduler.py``, ``test_chunked_prefill.py`` and
``test_serving_api.py``)."""

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
from repro_torch.serving.api import LLMServer, PagedBackend
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import PoolExhaustedError
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.telemetry import Tracer

torch.set_num_threads(2)

OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
JOPTS_Q = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                         quantized_kv=True, moe_capacity_factor=0.0)
# logprobs across frameworks: f32 log-softmax of logits that agree to ~1e-5
LP_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_model():
    """The reference tests' model: ``init_params(PRNGKey(0))``, bridged."""
    cfg = get_config("llama2-7b-tiny")
    jparams = JT.init_params(jax_config("llama2-7b-tiny"),
                             jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


def _sched(cfg, params, **kw):
    return Scheduler(cfg, params, OPTS_Q, device="cpu", **kw)


def _paged(cfg, params, **kw):
    kw.setdefault("num_pages", 24)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_slots", 3)
    return LLMServer(cfg, params, OPTS_Q, backend="paged", device="cpu", **kw)


def _engine_tokens(cfg, params, prompt, max_new, cache_len=32):
    return Engine(cfg, params, OPTS_Q, cache_len=cache_len,
                  device="cpu").generate(prompt[None], max_new).tokens[0]


def _assert_engine(cfg, params, results, rids, prompts, max_new,
                   cache_len=32):
    for rid, p, mn in zip(rids, prompts, max_new):
        np.testing.assert_array_equal(
            results[rid], _engine_tokens(cfg, params, p, mn, cache_len))


# --------------------------------------------- scheduler against Engine


def test_scheduler_matches_engine_with_midstream_admission(tiny_model):
    """5 ragged requests through 3 slots of one pool: admission and
    eviction mid-stream, greedy tokens identical to the per-request
    Engine, and the pool fully reclaimed."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(0)
    jobs = [(5, 6), (8, 3), (3, 9), (6, 4), (2, 7)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n, _ in jobs]
    sched = _sched(cfg, params, num_pages=24, page_size=4, max_slots=3)
    rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, jobs)]
    results = sched.run()
    assert sched.stats.admitted == 5 and sched.stats.evicted == 5
    assert sched.stats.prefills >= 2  # admitted in waves, not one batch
    _assert_engine(cfg, params, results, rids, prompts, [m for _, m in jobs])
    assert sched.pool.pages_in_use == 0 and not sched.pool.active.any()
    assert sched.pool.occupancy() == 0.0
    assert sched.stats.peak_occupancy > 0 and sched.stats.peak_eq2_bytes > 0


def test_chunked_scheduler_matches_engine_multi_chunk(tiny_model):
    """Prompts of 3-5 chunks go in piecewise, later chunks attending the
    earlier ones through the pool (K3's plain version here), while other
    requests decode; greedy outputs identical to the Engine, one call
    shape per step kind."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(21)
    jobs = [(18, 5), (9, 4), (4, 6), (14, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n, _ in jobs]
    sched = _sched(cfg, params, num_pages=32, page_size=4, max_slots=2,
                   prefill_chunk=4)
    rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, jobs)]
    results = sched.run()
    assert sched.stats.prefill_chunks >= 5 + 3 + 1 + 4
    assert sched.stats.ttft_ticks[rids[0]] >= 5
    assert sched.stats.shared_prefill_calls >= 4  # continuation chunks
    _assert_engine(cfg, params, results, rids, prompts, [m for _, m in jobs])
    assert sched.stats.compiled_shapes == 3  # chunk, chunk_shared, decode


def test_chunked_scheduler_decodes_while_long_prompt_admits(tiny_model):
    """A decoding request emits a token every tick while a long prompt is
    admitted chunk by chunk."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(23)
    short = rng.integers(0, cfg.vocab_size, (3,))
    long = rng.integers(0, cfg.vocab_size, (16,))
    sched = _sched(cfg, params, num_pages=32, page_size=4, max_slots=2,
                   prefill_chunk=4)
    r_short, r_long = sched.submit(short, 10), sched.submit(long, 2)
    progress, last = 0, 0
    while sched.step():
        st = next((s for s in sched.slots
                   if s is not None and s.req.rid == r_short), None)
        if st is not None and len(st.generated) > last:
            last, progress = len(st.generated), progress + 1
    assert progress >= 4
    _assert_engine(cfg, params, sched.results, [r_short, r_long],
                   [short, long], [10, 2])


@pytest.mark.parametrize("chunk,seed,jobs", [
    (256, 7, [(3, 3), (2, 4), (4, 2), (3, 3)]),  # forks prefill in one go
    (4, 31, [(6, 3), (2, 4), (5, 3)]),  # forks and creator chunk
])
def test_prefix_sharing_matches_engine_and_saves_pool_bytes(tiny_model, chunk,
                                                            seed, jobs):
    """Requests attached to a shared 10-token prefix (page 4: a partial
    boundary page, so copy-on-write runs) give the Engine's tokens, with a
    lower physical peak than the same work without sharing; the drained
    pool is fully reclaimed."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab_size, (10,))
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, (n,))])
               for n, _ in jobs]

    def serve(shared):
        sched = _sched(cfg, params, num_pages=32, page_size=4, max_slots=2,
                       prefill_chunk=chunk)
        # only the key's first submit declares the length
        rids = [sched.submit(p, mn, prefix_key="sys" if shared else None,
                             prefix_len=10 if i == 0 else None)
                for i, (p, (_, mn)) in enumerate(zip(prompts, jobs))]
        return sched, rids, sched.run()

    sched, rids, results = serve(True)
    base, _, base_results = serve(False)
    _assert_engine(cfg, params, results, rids, prompts, [m for _, m in jobs])
    _assert_engine(cfg, params, base_results, rids, prompts,
                   [m for _, m in jobs])
    assert sched.stats.prefix_forks >= 2
    assert sched.stats.peak_shared_pages > 0
    assert sched.stats.peak_pool_bytes < base.stats.peak_pool_bytes
    assert sched.pool.pages_in_use == 0 and not sched.pool.refcount.any()


def test_scheduler_backpressure_queues_oversized_wave(tiny_model):
    """A pool that holds one request at a time still serves them all."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (8,)) for _ in range(3)]
    sched = _sched(cfg, params, num_pages=7, page_size=4, max_slots=2)
    rids = [sched.submit(p, 3) for p in prompts]
    results = sched.run()
    assert sched.stats.prefills >= 2
    assert sched.stats.peak_occupancy == 1.0
    _assert_engine(cfg, params, results, rids, prompts, [3, 3, 3])


def test_scheduler_eos_and_single_token_requests(tiny_model):
    """An EOS token truncates the result and frees the slot; a one-token
    request finishes on its prefill logits without a decode step."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (5,))
    free_run = _engine_tokens(cfg, params, prompt, 6)
    eos = int(free_run[5 + 2])
    sched = _sched(cfg, params, num_pages=16, page_size=4, max_slots=2)
    rid = sched.submit(prompt, 6, eos_id=eos)
    got = sched.run()[rid]
    assert got[-1] == eos and got.size == 5 + 3
    np.testing.assert_array_equal(got, free_run[: 5 + 3])
    assert sched.finish_reasons[rid] == "stop"
    p = np.random.default_rng(4).integers(0, cfg.vocab_size, (6,))
    sched = _sched(cfg, params, num_pages=16, page_size=4, max_slots=2)
    rid = sched.submit(p, 1)
    np.testing.assert_array_equal(sched.run()[rid],
                                  _engine_tokens(cfg, params, p, 1))
    assert sched.stats.steps == 0


def test_scheduler_impossible_request_and_bad_submits_fail_loudly(tiny_model):
    cfg, _, params = tiny_model
    rng = np.random.default_rng(5)
    sched = _sched(cfg, params, num_pages=4, page_size=4, max_slots=2)
    sched.submit(rng.integers(0, cfg.vocab_size, (10,)), 8)  # needs 18
    with pytest.raises(PoolExhaustedError, match="never be admitted"):
        sched.run()
    sched = _sched(cfg, params, num_pages=16, page_size=4, max_slots=2)
    a = rng.integers(0, cfg.vocab_size, (8,))
    b = a.copy()
    b[2] = (b[2] + 1) % cfg.vocab_size
    sched.submit(a, 2, prefix_key="k", prefix_len=6)
    with pytest.raises(ValueError, match="does not match"):
        sched.submit(b, 2, prefix_key="k", prefix_len=6)
    with pytest.raises(ValueError, match="not both"):
        sched.submit(a, 4, sampling=SamplingParams(max_tokens=4))
    with pytest.raises(ValueError, match="max_new_tokens or sampling"):
        sched.submit(a)


def test_wave_mode_matches_engine_and_compiles_per_bucket(tiny_model):
    """``tick_mode="wave"``: the same outputs, one prefill shape per
    (R_adm, S_pad) bucket, against chunked mode's fixed shapes."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(41)
    jobs = [(3, 3), (9, 3), (17, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n, _ in jobs]

    def serve(mode):
        sched = _sched(cfg, params, num_pages=32, page_size=4, max_slots=1,
                       tick_mode=mode, prefill_chunk=8)
        rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, jobs)]
        return sched, rids, sched.run()

    wave, wrids, wres = serve("wave")
    chunk, crids, cres = serve("chunked")
    _assert_engine(cfg, params, wres, wrids, prompts, [3, 3, 3])
    _assert_engine(cfg, params, cres, crids, prompts, [3, 3, 3])
    assert wave.stats.compiled_shapes >= 4
    assert chunk.stats.compiled_shapes <= 3
    assert chunk.stats.prefill_chunks == 1 + 2 + 3


def test_adaptive_chunk_ladder_matches_engine_and_adapts(tiny_model):
    """``prefill_chunk`` as a ladder: outputs equal the Engine's while the
    chunk moves (large while prefill-heavy, small once decode dominates);
    a decoding ``latency_hint="interactive"`` request pulls the smallest
    rung."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(7)
    long_p = rng.integers(0, cfg.vocab_size, (24,))
    shorts = [rng.integers(0, cfg.vocab_size, (4,)) for _ in range(2)]
    sched = _sched(cfg, params, num_pages=24, page_size=4, max_slots=3,
                   prefill_chunk=(2, 4, 8))
    rids = [sched.submit(long_p, 4)] + [sched.submit(p, 8) for p in shorts]
    results = sched.run()
    _assert_engine(cfg, params, results, rids, [long_p] + shorts, [4, 8, 8],
                   cache_len=64)
    picks = sched.stats.auto_chunks
    assert 8 in picks and 2 in picks, picks
    rng = np.random.default_rng(8)
    short = rng.integers(0, cfg.vocab_size, (3,))
    long_p = rng.integers(0, cfg.vocab_size, (16,))

    def serve(hint):
        sched = _sched(cfg, params, num_pages=24, page_size=4, max_slots=2,
                       prefill_chunk=(2, 4, 8))
        sched.submit(short, sampling=SamplingParams(max_tokens=10,
                                                    latency_hint=hint))
        sched.submit(long_p, 3)
        sched.run()
        return sched.stats.auto_chunks

    assert 2 in serve("interactive")
    assert 2 not in serve("balanced")


# ------------------------------------------- against the reference path


def test_greedy_streams_and_logprobs_match_reference_scheduler(tiny_model):
    """The port's Scheduler against the reference Scheduler on the same
    bridged weights: multi-chunk prompts, a shared-prefix fork and
    mid-stream admission give the same tokens, with logprobs within
    cross-framework f32 tolerance."""
    cfg, jparams, params = tiny_model
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, cfg.vocab_size, (9,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (18, 9, 4)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                     (n,))]) for n in (5, 2)]
    max_new = [5, 4, 6, 3, 4]
    kw = dict(num_pages=40, page_size=4, max_slots=2, prefill_chunk=4)
    runs = []
    for sched in (JaxScheduler(jax_config("llama2-7b-tiny"), jparams,
                               JOPTS_Q, **kw), _sched(cfg, params, **kw)):
        rids = [sched.submit(p, mn, prefix_key="sys" if i >= 3 else None,
                             prefix_len=9 if i == 3 else None)
                for i, (p, mn) in enumerate(zip(prompts, max_new))]
        results = sched.run()
        events = sorted((e[0], e[1], e[2], e[3]) for e in
                        sched.drain_events())
        runs.append(([results[r] for r in rids], events, sched.stats))
    (want, want_ev, want_st), (got, got_ev, got_st) = runs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [e[:3] for e in got_ev] == [e[:3] for e in want_ev]
    np.testing.assert_allclose([e[3] for e in got_ev],
                               [e[3] for e in want_ev], **LP_TOL)
    assert got_st.prefix_forks == want_st.prefix_forks >= 1
    assert got_st.steps == want_st.steps
    assert got_st.prefill_chunks == want_st.prefill_chunks


# -------------------------------------------- LLMServer(backend="paged")


def test_default_backend_is_paged_and_matches_engine(tiny_model):
    cfg, _, params = tiny_model
    p = np.random.default_rng(0).integers(0, cfg.vocab_size, (6,))
    srv = LLMServer(cfg, params, OPTS_Q, device="cpu", num_pages=24,
                    page_size=4, max_slots=3)
    assert isinstance(srv.backend, PagedBackend)
    rid = srv.submit(p, SamplingParams(max_tokens=5))
    np.testing.assert_array_equal(srv.run()[rid].full_tokens,
                                  _engine_tokens(cfg, params, p, 5))
    assert srv.queue_depth == 0


def test_seeded_sampling_parity_paged_vs_fused(tiny_model):
    """The same per-request seeds give the same tokens on the paged and the
    fused backend: a row's draws depend on its seed and its own generation
    index, never on its batch."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 8, 3)]
    sps = [SamplingParams(max_tokens=6, temperature=0.9, seed=7),
           SamplingParams(max_tokens=5, temperature=1.2, top_k=4, seed=11),
           SamplingParams(max_tokens=7, temperature=0.8, top_p=0.85, seed=13),
           ]
    fused = LLMServer(cfg, params, OPTS_Q, backend="fused", cache_len=32,
                      device="cpu")
    want = []
    for p, sp in zip(prompts, sps):  # one request per fused run
        rid = fused.submit(p, sp)
        want.append(fused.run()[rid].full_tokens)
    srv = _paged(cfg, params)
    rids = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
    outs = srv.run()
    for rid, w in zip(rids, want):
        np.testing.assert_array_equal(outs[rid].full_tokens, w)
    assert srv.backend.scheduler.stats.compiled_shapes == 2  # chunk, decode


def test_stop_token_finishes_midstream_paged(tiny_model):
    cfg, _, params = tiny_model
    p = np.random.default_rng(3).integers(0, cfg.vocab_size, (5,))
    free = _engine_tokens(cfg, params, p, 8)
    stop = int(free[5 + 3])
    srv = _paged(cfg, params)
    rid = srv.submit(p, SamplingParams(max_tokens=8, stop_token_ids=(stop,)))
    events = list(srv.stream())
    out = srv.outputs()[rid]
    assert out.finish_reason == "stop"
    assert out.tokens[-1] == stop and out.tokens.shape[0] == 4
    np.testing.assert_array_equal(out.full_tokens, free[: 5 + 4])
    assert len([e for e in events if not e.finished]) == 4
    assert srv.metrics()["requests.reason.stop"] == 1


def test_abort_queued_mid_prefill_and_decoding_paged(tiny_model):
    """abort() wherever the request is: queued (it never runs),
    mid-prefill (its chunks stop) and decoding (cut mid-stream); the
    co-tenant still matches the Engine and the pool fully reclaims."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(4)
    a = rng.integers(0, cfg.vocab_size, (5,))
    b = rng.integers(0, cfg.vocab_size, (5,))
    long = rng.integers(0, cfg.vocab_size, (16,))
    queued = rng.integers(0, cfg.vocab_size, (4,))
    srv = _paged(cfg, params, max_slots=3, prefill_chunk=4)
    ra = srv.submit(a, SamplingParams(max_tokens=10))
    rb = srv.submit(b, SamplingParams(max_tokens=6))
    rl = srv.submit(long, SamplingParams(max_tokens=4))
    rq = srv.submit(queued, SamplingParams(max_tokens=3))
    assert srv.queue_depth == 4
    assert srv.abort(rq)  # still queued
    sched = srv.backend.scheduler
    aborted = set()
    for ev in srv.stream():
        if ev.rid == ra and not ev.finished and ev.index >= 1 \
                and ra not in aborted:
            assert srv.abort(ra)  # decoding
            aborted.add(ra)
        st = next((s for s in sched.slots
                   if s is not None and s.req.rid == rl), None)
        if st is not None and st.prefilling and 0 < st.prefilled \
                and rl not in aborted:
            assert srv.abort(rl)  # mid-prefill
            aborted.add(rl)
    outs = srv.outputs()
    assert aborted == {ra, rl}
    assert outs[rq].finish_reason == "abort" and outs[rq].tokens.size == 0
    assert outs[rl].finish_reason == "abort" and outs[rl].tokens.size == 0
    assert outs[ra].finish_reason == "abort"
    assert 1 <= outs[ra].tokens.shape[0] < 10
    np.testing.assert_array_equal(outs[rb].full_tokens,
                                  _engine_tokens(cfg, params, b, 6))
    assert sched.stats.aborted == 3
    assert sched.pool.pages_in_use == 0 and not sched.pool.refcount.any()
    assert not srv.abort(ra)  # finished results are not retracted


def test_streaming_order_and_release_paged(tiny_model):
    """Per request, events arrive in position order 0, 1, 2, ...; requests
    interleave; each ends with one finish marker; ``release`` drops a
    finished request's retained state, including the scheduler's."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (4,)) for _ in range(3)]
    srv = _paged(cfg, params)
    rids = [srv.submit(p, SamplingParams(max_tokens=5, seed=i))
            for i, p in enumerate(prompts)]
    assert not srv.release(rids[0])  # not finished yet
    events = list(srv.stream())
    seen = {r: [] for r in rids}
    for ev in events:
        if not ev.finished:
            seen[ev.rid].append(ev.index)
    assert all(seen[r] == list(range(5)) for r in rids)
    order = [ev.rid for ev in events if not ev.finished]
    assert any(order[i] != order[i + 1] for i in range(len(order) - 1))
    fins = [ev for ev in events if ev.finished]
    assert sorted(ev.rid for ev in fins) == sorted(rids)
    assert all(ev.token == -1 and ev.finish_reason == "length"
               for ev in fins)
    assert srv.metrics()["requests.ttft_ticks.count"] == 3
    assert srv.release(rids[0])
    assert rids[0] not in srv.outputs()
    assert rids[0] not in srv.backend.scheduler.results
    assert not srv.release(rids[0])


# ------------------------------------------------------------- refusals


# the packed tick, token_budget and lazy growth are ported now (their
# tests are in tests/test_torch_packed.py), and so are speculation,
# auto_prefix and telemetry: their cases now check that the keyword serves
# (tests/test_torch_speculation.py, test_torch_async_serving.py and
# test_torch_telemetry.py hold them to the reference); mesh= is ported too
# (tests/test_torch_sharded.py), and its case checks that what is not a
# mesh is refused; the cases keep their ids
@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(speculate_k=2), None, id="kw3-6.3"),
    pytest.param(dict(auto_prefix=True, auto_prefix_min=4), None,
                 id="kw4-6.4"),
    pytest.param(dict(mesh=object()), "not a mesh", id="kw5-item 9"),
    pytest.param(dict(telemetry=True), None, id="kw6-item 7")])
def test_scheduler_refuses_what_is_not_ported(tiny_model, kw, item):
    cfg, _, params = tiny_model
    if item is None:  # ported: it serves, with the Engine's tokens
        tracer = Tracer() if kw.get("telemetry") else None
        if tracer is not None:
            kw = dict(telemetry=tracer)
        rng = np.random.default_rng(7)
        p = np.tile(rng.integers(0, cfg.vocab_size, (3,)), 3)
        # a second prompt sharing p's first 8 tokens (auto_prefix finds it)
        q = np.concatenate([p[:8], (p[8:9] + 1) % cfg.vocab_size, p[:1]])
        sched = _sched(cfg, params, num_pages=16, page_size=4, max_slots=2,
                       **kw)
        rids = [sched.submit(x, 5) for x in (p, q)]
        results = sched.run()
        for rid, x in zip(rids, (p, q)):
            np.testing.assert_array_equal(results[rid],
                                          _engine_tokens(cfg, params, x, 5))
        assert sched.pool.pages_in_use == 0
        if "speculate_k" in kw:
            assert sched.stats.spec_rounds > 0
            with pytest.raises(ValueError, match="speculate_k"):
                _sched(cfg, params, speculate_k=-1)
        if "auto_prefix" in kw:
            assert sched.stats.auto_prefix_hits == 1
            assert sched.stats.prefix_forks == 1
        if tracer is not None:
            assert len(tracer.ticks) == sched._tick
            assert tracer.metrics_dict()["requests.finished"] == 2
        return
    assert item == "not a mesh"
    with pytest.raises(TypeError, match="DeviceMesh"):
        _sched(cfg, params, **kw)


def test_paged_backend_refuses_unported_deployments(tiny_model):
    """``"sharded"`` without an initialized process group raises saying so
    (it serves over one in tests/test_torch_sharded.py);
    ``"disaggregated"`` serves the Engine's tokens through its two
    replicas; an unknown name is a ``ValueError``."""
    cfg, _, params = tiny_model
    with pytest.raises(RuntimeError,
                       match="initialized default process group"):
        LLMServer(cfg, params, OPTS_Q, deployment="sharded", device="cpu")
    srv = _paged(cfg, params, deployment="disaggregated")
    prompt = np.arange(2, 9, dtype=np.int32)
    rid = srv.submit(prompt, SamplingParams(max_tokens=4))
    np.testing.assert_array_equal(
        srv.run()[rid].tokens,
        _engine_tokens(cfg, params, prompt, 4)[prompt.size:])
    ds = srv.backend.scheduler
    assert ds.transport.transfers == 1
    assert ds.prefill.pool.pages_in_use == ds.decode.pool.pages_in_use == 0
    with pytest.raises(ValueError, match="deployment"):
        LLMServer(cfg, params, OPTS_Q, deployment="mesh", device="cpu")
