"""The port's disaggregated deployment on the CPU (``serving.page_transport``:
``PageStreamTransport``, ``PrefillWorker``, ``DecodeWorker``,
``DisaggregatedScheduler``; ``Scheduler.extract``/``inject``;
``PagedKVPool.adopt_snapshot``), held against the reference's
``DisaggregatedScheduler`` on the reference's own workload
(``tests/test_sharded_serving.py``): the streams equal the reference
facade's and the port's ``Engine`` in its four cells, the events keep
per-request order across the handoff, both pools drain, and the page
stream moves the reference's transfers and bytes, span for span; then a
request that finishes on the prefill replica, the page-size check, the
handoff into a second scheduler mid-decode, the snapshot's byte account
across two pools, a prefix fork behind an extracted creator, and
``LLMServer(deployment="disaggregated")``."""

import json

import jax
import numpy as np
import pytest
import torch
from test_sharded_serving import _drive, _workload

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving.page_transport import \
    DisaggregatedScheduler as JaxDisaggregated
from repro.serving.telemetry import Tracer as JTracer
from repro_torch.configs import get_config
from repro_torch.core.sampling import SamplingParams
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import from_jax_params
from repro_torch.serving import DisaggregatedScheduler
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import PagedKVPool
from repro_torch.serving.scheduler import _GREEDY, Scheduler
from repro_torch.serving.telemetry import Tracer

torch.set_num_threads(2)

OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
JOPTS_Q = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                         quantized_kv=True, moe_capacity_factor=0.0)
# the reference test's facade: 24 pages of 4 tokens, 3 slots, lazy growth
FACADE = dict(num_pages=24, page_size=4, max_slots=3, lazy_growth=True)
CELLS = [("packed", 0), ("packed", 2), ("chunked", 2), ("wave", 0)]
CELL_IDS = ["packed-k0", "packed-k2", "chunked-k2", "wave-k0"]


@pytest.fixture(scope="module")
def tiny_model():
    """The reference tests' model: ``init_params(PRNGKey(0))``, bridged."""
    cfg = get_config("llama2-7b").tiny()
    jparams = JT.init_params(jax_config("llama2-7b").tiny(),
                             jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def oracle(tiny_model):
    """The port's per-request greedy ``Engine``, memoized."""
    cfg, _, params = tiny_model
    eng = Engine(cfg, params, OPTS_Q, cache_len=64, device="cpu")
    cache = {}

    def get(prompt, max_new):
        key = (prompt.tobytes(), max_new)
        if key not in cache:
            cache[key] = eng.generate(prompt[None], max_new).tokens[0]
        return cache[key]

    return get


def _facade(cfg, params, mode, k, tracer, **kw):
    return DisaggregatedScheduler(cfg, params, OPTS_Q, telemetry=tracer,
                                  tick_mode=mode, device="cpu",
                                  decode_kwargs={"speculate_k": k},
                                  **dict(FACADE, **kw))


@pytest.fixture(scope="module")
def cell_runs(tiny_model):
    """Each cell's workload (``_workload(seed=11, n_jobs=5)``) through the
    reference facade and the port's, both traced, memoized by cell:
    (jobs, (facade, tracer, rids, events) for the reference, then the
    port)."""
    cfg, jparams, params = tiny_model
    jcfg = jax_config("llama2-7b").tiny()
    runs = {}

    def get(mode, k):
        if (mode, k) not in runs:
            jobs = _workload(jcfg, seed=11, n_jobs=5)
            out = [jobs]
            for make, tracer in (
                    (lambda tr: JaxDisaggregated(
                        jcfg, jparams, JOPTS_Q, telemetry=tr,
                        tick_mode=mode, decode_kwargs={"speculate_k": k},
                        **FACADE), JTracer()),
                    (lambda tr: _facade(cfg, params, mode, k, tr),
                     Tracer())):
                ds = make(tracer)
                rids = _drive(ds, jobs)
                out.append((ds, tracer, rids, ds.drain_events()))
            runs[mode, k] = tuple(out)
        return runs[mode, k]

    return get


@pytest.mark.parametrize("mode,k", CELLS, ids=CELL_IDS)
def test_disaggregated_streams_match_reference_and_engine(cell_runs, oracle,
                                                          mode, k):
    """The port's facade gives the reference facade's and the Engine's
    tokens; its events keep per-request index order across the handoff;
    both pools drain to no page and no swap bytes; the page stream moves
    the reference's transfers and bytes, and its spans and metrics account
    every byte; every rid has its TTFT in the merged stats."""
    jobs, (jds, _, jrids, _), (ds, tr, rids, events) = cell_runs(mode, k)
    seen = {}
    for rid, idx, _, lp in events:
        assert idx == seen.get(rid, -1) + 1, f"rid {rid} out of order"
        seen[rid] = idx
        assert np.isfinite(lp)
    for j, (prompt, max_new, _) in enumerate(jobs):
        got = ds.results[rids[j]]
        np.testing.assert_array_equal(got, np.asarray(jds.results[jrids[j]]))
        np.testing.assert_array_equal(got, oracle(prompt, max_new))
        assert seen[rids[j]] == len(got) - len(prompt) - 1
    for sched in (ds.prefill, ds.decode):
        assert sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0
    assert ds.transport.transfers == jds.transport.transfers > 0
    assert ds.transport.bytes_moved == jds.transport.bytes_moved
    multi = sum(1 for _, max_new, _ in jobs if max_new > 1)
    assert ds.transport.transfers == multi * len(ds.prefill.cfg.pattern)
    spans = [sp for sp in tr.spans if sp.name == "page_stream"]
    assert sum(sp.attrs["bytes"] for sp in spans) == ds.transport.bytes_moved
    m = tr.metrics_dict()
    assert m["transport.page_stream.total_bytes"] == ds.transport.bytes_moved
    assert set(rids.values()) <= set(ds.stats.ttft_ticks)
    assert ds.stats.ttft_ticks == jds.stats.ttft_ticks
    # the decode replica restored every streamed request from its snapshot
    assert ds.decode._swap.transfers == ds.transport.transfers
    if k:
        assert ds.decode.stats.spec_rounds > 0
        assert ds.prefill.speculate_k == 0


def test_page_stream_trace_matches_reference(cell_runs):
    """On one cell the Tracer's ``page_stream`` spans (name, track, rid,
    layer, tokens, bytes), the prefill replica's ``extract`` events and
    the ``transport.page_stream.*`` metrics are the reference's."""
    _, (_, jtr, _, _), (_, tr, _, _) = cell_runs("packed", 0)

    def spans(t):
        return sorted((sp.name, sp.track, sp.rid, sp.attrs["layer"],
                       sp.attrs["tokens"], sp.attrs["bytes"],
                       sp.attrs["transport"])
                      for sp in t.spans if sp.name == "page_stream")

    def extracts(t):
        return sorted((track, rid, json.dumps(attrs, sort_keys=True))
                      for name, _, track, rid, attrs in t.events
                      if name == "extract")

    assert spans(tr) == spans(jtr) and spans(tr)
    assert extracts(tr) == extracts(jtr) and extracts(tr)

    def stream_metrics(t):
        return {k: v for k, v in t.metrics_dict().items()
                if k.startswith("transport.page_stream.")}

    assert stream_metrics(tr) == stream_metrics(jtr)
    assert stream_metrics(tr)["transport.page_stream.transfers"] == \
        len(spans(tr))


def test_single_token_request_finishes_on_prefill_replica(tiny_model,
                                                          oracle):
    """max_new_tokens 1: nothing to decode, nothing crosses the stream."""
    cfg, _, params = tiny_model
    ds = _facade(cfg, params, "packed", 0, None)
    prompt = np.arange(1, 7, dtype=np.int32)
    rid = ds.submit(prompt, 1)
    res = ds.run()
    np.testing.assert_array_equal(res[rid], oracle(prompt, 1))
    assert ds.transport.transfers == 0 and ds.transport.bytes_moved == 0
    assert rid in ds.prefill.results and rid not in ds.decode.results


def test_mismatched_page_size_rejected(tiny_model):
    cfg, _, params = tiny_model
    with pytest.raises(ValueError, match="page_size"):
        DisaggregatedScheduler(cfg, params, OPTS_Q, num_pages=16,
                               page_size=4, max_slots=2, device="cpu",
                               decode_kwargs={"page_size": 8})


def test_extract_and_inject_resume_bit_identically(tiny_model):
    """``extract`` of a queued rid is None; a seeded request extracted
    mid-decode and injected into a second scheduler finishes with the
    uninterrupted run's tokens and logprobs, and the freed slot's
    sampling row is greedy again."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (9, 6)]
    sp = [SamplingParams(max_tokens=8, temperature=0.8, top_k=20, seed=3),
          SamplingParams(max_tokens=7)]

    def sched():
        return Scheduler(cfg, params, OPTS_Q, num_pages=24, page_size=4,
                         max_slots=1, device="cpu")

    whole = sched()
    wr = [whole.submit(p, sampling=s) for p, s in zip(prompts, sp)]
    want = whole.run()
    want_lp = {}
    for rid, idx, _, lp in whole.drain_events():
        want_lp.setdefault(rid, []).append(lp)

    first, second = sched(), sched()
    rids = [first.submit(p, sampling=s) for p, s in zip(prompts, sp)]
    for _ in range(3):
        first.step()
    assert first.extract(rids[1]) is None  # queued behind the one slot
    assert first.extract(12345) is None
    slot = next(i for i, st in enumerate(first.slots) if st is not None)
    assert first._op_temp[slot] == np.float32(0.8)
    req = first.extract(rids[0])
    assert req is not None and 0 < len(req.generated) < 8
    assert req.snapshot["length"] == len(prompts[0]) + len(req.generated) - 1
    assert first.slots[slot] is None
    assert (first._op_seed[slot], first._op_temp[slot], first._op_topk[slot],
            first._op_topp[slot]) == (_GREEDY.seed, np.float32(0.0),
                                      _GREEDY.top_k, np.float32(1.0))
    assert not first._op_bias[slot].any()
    assert first.pool.swap_bytes == PagedKVPool.snapshot_bytes(req.snapshot)
    second.pool.adopt_snapshot(req.snapshot)
    first.pool.discard_snapshot(req.snapshot)
    second.inject(req)
    got = second.run()
    got_first = first.run()
    np.testing.assert_array_equal(got[rids[0]], want[wr[0]])
    np.testing.assert_array_equal(got_first[rids[1]], want[wr[1]])
    lps = {}
    for sched_ in (first, second):
        for rid, idx, _, lp in sched_.drain_events():
            lps.setdefault(rid, {})[idx] = lp
    np.testing.assert_array_equal(
        [lps[rids[0]][i] for i in range(8)], want_lp[wr[0]])
    for s in (first, second):
        assert s.pool.pages_in_use == 0 and s.pool.swap_bytes == 0


def test_snapshot_bytes_move_between_pools(tiny_model):
    """One pool's export, adopted by a second and discarded by the first,
    is restored there: both accounts balance to zero, and the restored
    pages hold the exported codes, scales and positions."""
    cfg, _, _ = tiny_model
    a, b = (PagedKVPool(cfg, num_pages=8, page_size=4, max_requests=2,
                        device="cpu") for _ in range(2))
    slot = a.admit(6)
    a.commit_prefill(slot, 6)
    gen = torch.Generator().manual_seed(0)
    a.k.copy_(torch.randint(-127, 128, a.k.shape, generator=gen,
                            dtype=torch.int8))
    a.k_scale.uniform_(0.01, 0.02, generator=gen)
    pages = torch.as_tensor(a.block_tables[slot][:2], dtype=torch.long)
    a.pos[:, pages] = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    snap = a.export_slot(slot)
    nbytes = PagedKVPool.snapshot_bytes(snap)
    assert a.swap_bytes == nbytes > 0 and b.swap_bytes == 0
    b.adopt_snapshot(snap)
    a.discard_snapshot(snap)
    assert a.swap_bytes == 0 and b.swap_bytes == nbytes
    got = b.restore_slot(snap)
    assert b.swap_bytes == 0
    got_pages = torch.as_tensor(b.block_tables[got][:2], dtype=torch.long)
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        np.testing.assert_array_equal(getattr(a, name)[:, pages].numpy(),
                                      getattr(b, name)[:, got_pages].numpy())
    with pytest.raises(AssertionError, match="twice"):
        a.discard_snapshot(snap)


def test_fork_attaches_after_its_creator_was_extracted(tiny_model, oracle):
    """A prefix creator extracted to the decode replica leaves its pinned
    prefix on the prefill replica: the fork queued behind it attaches
    there. Each snapshot carries every page its request reads, so nothing
    is shared on the decode side; both streams are the Engine's."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(9)
    head = rng.integers(0, cfg.vocab_size, (8,))
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab_size, (n,))])
               for n in (3, 5)]
    ds = DisaggregatedScheduler(cfg, params, OPTS_Q, num_pages=24,
                                page_size=4, device="cpu",
                                prefill_kwargs={"max_slots": 1},
                                decode_kwargs={"max_slots": 2})
    rids = [ds.submit(p, 5, prefix_key="head", prefix_len=8)
            for p in prompts]
    res = ds.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(res[rid], oracle(p, 5))
    assert ds.prefill.stats.prefix_forks == 1
    assert ds.decode.stats.prefix_forks == 0
    assert ds.decode.stats.peak_shared_pages == 0
    assert ds.transport.transfers == 2
    for s in (ds.prefill, ds.decode):
        assert s.pool.pages_in_use == 0 and s.pool.swap_bytes == 0


def test_llm_server_serves_disaggregated(tiny_model, oracle):
    """``LLMServer(deployment="disaggregated")`` streams the Engine's
    tokens; ``queue_depth`` sums both replicas' queues; ``release()``
    drops a result from whichever replica holds it; ``stats`` merge."""
    cfg, _, params = tiny_model
    srv = LLMServer(cfg, params, OPTS_Q, backend="paged",
                    deployment="disaggregated", device="cpu",
                    tick_mode="packed", prefill_kwargs={"max_slots": 1},
                    **dict(FACADE, max_slots=2))
    ds = srv.backend.scheduler
    assert isinstance(ds, DisaggregatedScheduler)
    assert srv.backend.device == ds.device == torch.device("cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (7, 5, 6)]
    rids = [srv.submit(p, SamplingParams(max_tokens=n))
            for p, n in zip(prompts, (4, 1, 5))]
    assert srv.queue_depth == 3
    # a request already handed over waits in the decode replica's queue
    ds.prefill.step()
    handed = ds.workers[0].harvest()
    assert len(handed) == 1
    for req in handed:
        req.snapshot = ds.transport.send(ds.prefill.pool, ds.decode.pool,
                                         req.snapshot, rid=req.rid)
        ds.workers[1].accept(req)
    assert len(ds.prefill.queue) == 2 and len(ds.decode.queue) == 1
    assert srv.queue_depth == 3
    outs = srv.run()
    for rid, p, n in zip(rids, prompts, (4, 1, 5)):
        np.testing.assert_array_equal(outs[rid].tokens,
                                      oracle(p, n)[len(p):])
        assert outs[rid].finish_reason == "length"
        assert outs[rid].metrics.ttft_ticks is not None
    assert rids[1] in ds.prefill.results and rids[0] in ds.decode.results
    st = ds.stats
    assert st.evicted == ds.prefill.stats.evicted + ds.decode.stats.evicted
    assert st.evicted == 3
    assert st.peak_occupancy == max(ds.prefill.stats.peak_occupancy,
                                    ds.decode.stats.peak_occupancy)
    for rid in rids:
        assert srv.release(rid)
    assert not ds.prefill.results and not ds.decode.results
    assert not ds.prefill.finish_reasons and not ds.decode.finish_reasons
    # the sharded deployment needs a process group (it serves over one in
    # tests/test_torch_sharded.py)
    with pytest.raises(RuntimeError,
                       match="initialized default process group"):
        LLMServer(cfg, params, OPTS_Q, deployment="sharded", device="cpu")
