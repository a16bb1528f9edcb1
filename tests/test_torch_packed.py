"""The port's packed tick and lazy growth with preemption on the CPU: the
token-packed ``Scheduler(tick_mode="packed")`` streams token for token
equal to the port's ``Engine`` and chunked tick through one call shape
with exact token accounting, keeps decoding while a long prompt admits,
gives the reference packed scheduler's streams and logprobs, and streams
through ``LLMServer``; lazy growth preempts the lowest-priority request and
resumes it by swap or refill on the packed and the chunked tick with the
``Engine``'s tokens; the pool's ``export_slot`` / ``restore_slot`` round
trip is bit-identical, and a random walk with preemption leaves the port's
pool and the reference's in the same state (mirroring
``tests/test_varlen_packed.py``, ``test_chunked_prefill.py``,
``test_scheduler.py`` and ``test_kv_pool.py``)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro.serving import kv_pool as JP
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.core.sampling import SamplingParams
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import from_jax_params
from repro_torch.serving import kv_pool as TP
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.page_transport import HostSwapTransport
from repro_torch.serving.scheduler import Scheduler

torch.set_num_threads(2)

OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
# the reference scheduler's packed tick through its dense oracle route
# (``paged_prefill_kernel=False``): the same function as its Pallas kernel
# (held against each other in tests/test_varlen_packed.py), without the
# interpret-mode cost per layer and tick
JOPTS_ORACLE = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                              quantized_kv=True, moe_capacity_factor=0.0,
                              paged_prefill_kernel=False)
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


def _engine_tokens(cfg, params, prompt, max_new, cache_len=32):
    return Engine(cfg, params, OPTS_Q, cache_len=cache_len,
                  device="cpu").generate(prompt[None], max_new).tokens[0]


# ------------------------------------------------------ the packed tick


def test_packed_scheduler_matches_engine_and_chunked(tiny_model):
    """Prompts of 3 to 5 chunks, more requests than slots: the packed tick
    gives the Engine's tokens and the chunked tick's, bit for bit, through
    ONE call shape; every prompt token is carried once, plus one decode
    row per generated token but the first (it rides the last prefill row)
    and the last (sampled, never fed back)."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(21)
    jobs = [(18, 5), (9, 4), (4, 6), (14, 3)]
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n, _ in jobs]

    def serve(**kw):
        sched = _sched(cfg, params, num_pages=32, page_size=4, max_slots=2,
                       prefill_chunk=4, **kw)
        rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, jobs)]
        res = sched.run()
        return sched, [res[r] for r in rids]

    packed, pres = serve(tick_mode="packed")
    chunked, cres = serve(tick_mode="chunked")
    for p, (_, mn), got_p, got_c in zip(prompts, jobs, pres, cres):
        want = _engine_tokens(cfg, params, p, mn)
        np.testing.assert_array_equal(got_p, want)
        np.testing.assert_array_equal(got_c, want)
    st = packed.stats
    assert st.compiled_shapes == 1 < chunked.stats.compiled_shapes
    assert packed.token_budget == 4 + 2
    assert st.packed_ticks > 0 and st.steps > 0
    assert st.packed_tokens == (sum(n for n, _ in jobs)
                                + sum(m - 1 for _, m in jobs))
    assert st.packed_tokens + st.packed_pad_tokens == \
        st.packed_ticks * packed.token_budget
    assert st.prefill_tokens == sum(n for n, _ in jobs)
    assert packed.pool.pages_in_use == 0 and not packed.pool.refcount.any()


def test_packed_decodes_while_long_prompt_admits(tiny_model):
    """The Sarathi property survives packing: a decoding request emits a
    token every packed tick while a long prompt's chunks share the
    buffer."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(23)
    short = rng.integers(0, cfg.vocab_size, (3,))
    long = rng.integers(0, cfg.vocab_size, (16,))
    sched = _sched(cfg, params, num_pages=32, page_size=4, max_slots=2,
                   prefill_chunk=4, tick_mode="packed")
    r_short, r_long = sched.submit(short, 10), sched.submit(long, 2)
    progress, last = 0, 0
    while sched.step():
        st = next((s for s in sched.slots
                   if s is not None and s.req.rid == r_short), None)
        if st is not None and len(st.generated) > last:
            last, progress = len(st.generated), progress + 1
    assert progress >= 4
    np.testing.assert_array_equal(sched.results[r_short],
                                  _engine_tokens(cfg, params, short, 10))
    np.testing.assert_array_equal(sched.results[r_long],
                                  _engine_tokens(cfg, params, long, 2))


def test_packed_token_budget_is_clamped(tiny_model):
    """``token_budget`` covers every decoding slot plus one prefill row."""
    cfg, _, params = tiny_model
    sched = _sched(cfg, params, num_pages=16, page_size=4, max_slots=3,
                   tick_mode="packed", token_budget=2)
    assert sched.token_budget == 4
    rng = np.random.default_rng(25)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (5, 3, 6)]
    rids = [sched.submit(p, 4) for p in prompts]
    res = sched.run()
    for rid, p in zip(rids, prompts):
        np.testing.assert_array_equal(res[rid],
                                      _engine_tokens(cfg, params, p, 4))
    assert sched.stats.compiled_shapes == 1


def test_packed_streams_and_logprobs_match_reference_scheduler(tiny_model):
    """The port's packed Scheduler against the reference's on the same
    bridged weights and traffic (multi-chunk prompts, a shared-prefix fork,
    mid-stream admission): the same tokens and event order, logprobs
    within cross-framework f32 tolerance, the same tick accounting."""
    cfg, jparams, params = tiny_model
    rng = np.random.default_rng(27)
    prefix = rng.integers(0, cfg.vocab_size, (9,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (18, 9, 4)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                     (n,))]) for n in (5, 2)]
    max_new = [5, 4, 6, 3, 4]
    kw = dict(num_pages=40, page_size=4, max_slots=2, prefill_chunk=4,
              tick_mode="packed")
    runs = []
    for sched in (JaxScheduler(jax_config("llama2-7b-tiny"), jparams,
                               JOPTS_ORACLE, **kw), _sched(cfg, params, **kw)):
        rids = [sched.submit(p, mn, prefix_key="sys" if i >= 3 else None,
                             prefix_len=9 if i == 3 else None)
                for i, (p, mn) in enumerate(zip(prompts, max_new))]
        results = sched.run()
        events = sched.drain_events()
        runs.append(([results[r] for r in rids], events, sched.stats))
    (want, want_ev, want_st), (got, got_ev, got_st) = runs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [e[:3] for e in got_ev] == [e[:3] for e in want_ev]
    np.testing.assert_allclose([e[3] for e in got_ev],
                               [e[3] for e in want_ev], **LP_TOL)
    for name in ("packed_ticks", "packed_tokens", "packed_pad_tokens",
                 "prefix_forks", "steps", "compiled_shapes"):
        assert getattr(got_st, name) == getattr(want_st, name), name


def test_llm_server_packed_streams_events(tiny_model):
    """``LLMServer(backend="paged", tick_mode="packed")``: token events in
    position order per request, one finish marker each, the Engine's
    tokens, finite logprobs."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(43)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (6, 11, 3)]
    srv = LLMServer(cfg, params, OPTS_Q, backend="paged", device="cpu",
                    num_pages=24, page_size=4, max_slots=2, prefill_chunk=4,
                    tick_mode="packed")
    assert srv.backend.scheduler.tick_mode == "packed"
    rids = [srv.submit(p, SamplingParams(max_tokens=5)) for p in prompts]
    seen = {r: [] for r in rids}
    finished = []
    for ev in srv.stream():
        if ev.finished:
            assert ev.logprob is None and ev.finish_reason == "length"
            finished.append(ev.rid)
        else:
            assert ev.index == len(seen[ev.rid])
            assert np.isfinite(ev.logprob) and ev.logprob <= 0.0
            seen[ev.rid].append(ev.token)
    assert sorted(finished) == sorted(rids)
    for rid, p in zip(rids, prompts):
        want = _engine_tokens(cfg, params, p, 5)
        np.testing.assert_array_equal(seen[rid], want[len(p):])
    assert srv.backend.scheduler.stats.compiled_shapes == 1


# ------------------------------------------------ lazy growth, preemption


@pytest.mark.parametrize("resume", ["swap", "refill"])
@pytest.mark.parametrize("tick_mode", ["packed", "chunked"])
def test_preemption_roundtrip_matches_engine(tiny_model, tick_mode, resume):
    """A mid-prefill slot evicted by a decoding neighbour's growth resumes
    its pieces where it left off (swap) or re-prefills (refill), on the
    packed and the chunked tick, and both requests give the Engine's
    tokens (``test_varlen_packed.py:213``, ``test_chunked_prefill.py:217``).
    Nothing leaks: pages, refcounts, swap bytes."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(29)
    a = rng.integers(0, cfg.vocab_size, (5,))  # decodes and grows
    b = rng.integers(0, cfg.vocab_size, (24,))  # mid-prefill victim
    sched = _sched(cfg, params, num_pages=10, page_size=4, max_slots=2,
                   prefill_chunk=4, lazy_growth=True, resume=resume,
                   preempt_cooldown=1, tick_mode=tick_mode)
    ra = sched.submit(a, 10, priority=1)
    rb = sched.submit(b, 3, priority=0)
    results = sched.run()
    st = sched.stats
    assert st.preemptions >= 1
    assert st.ttft_ticks[rb] > 6  # it waited out its eviction
    np.testing.assert_array_equal(results[ra],
                                  _engine_tokens(cfg, params, a, 10))
    np.testing.assert_array_equal(results[rb],
                                  _engine_tokens(cfg, params, b, 3))
    assert sched.pool.pages_in_use == 0 and not sched.pool.refcount.any()
    assert sched.pool.swap_bytes == 0
    assert (st.peak_swap_bytes > 0) == (resume == "swap")
    if tick_mode == "packed":
        assert st.compiled_shapes == 1


@pytest.mark.parametrize("resume", ["swap", "refill"])
def test_lazy_decode_preemption_matches_engine(tiny_model, resume):
    """Three requests whose prompts fit but whose worst cases do not
    (``test_scheduler.py``'s lazy-growth case) on the packed tick:
    preemption while decoding, every stream the Engine's."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(11)
    jobs = [(6, 8, 1), (5, 9, 0), (4, 8, 0)]  # (prompt, max_new, priority)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n, _, _ in jobs]
    sched = _sched(cfg, params, num_pages=9, page_size=4, max_slots=3,
                   lazy_growth=True, resume=resume, tick_mode="packed")
    rids = [sched.submit(p, mn, priority=pr)
            for p, (_, mn, pr) in zip(prompts, jobs)]
    results = sched.run()
    assert sched.stats.preemptions >= 1
    for rid, p, (_, mn, _) in zip(rids, prompts, jobs):
        np.testing.assert_array_equal(results[rid],
                                      _engine_tokens(cfg, params, p, mn))
    assert sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0


def test_preemption_victim_is_lowest_priority(tiny_model):
    """The priority-0 request is evicted and resumed; the priority-1
    request admitted with it never is (``test_scheduler.py:196``)."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(13)
    hi = rng.integers(0, cfg.vocab_size, (5,))
    lo = rng.integers(0, cfg.vocab_size, (5,))
    sched = _sched(cfg, params, num_pages=6, page_size=4, max_slots=2,
                   lazy_growth=True, tick_mode="packed")
    rid_hi = sched.submit(hi, 8, priority=1)
    rid_lo = sched.submit(lo, 8, priority=0)
    victims = []
    orig = sched._preempt_one

    def watch(requester):
        before = {st.req.rid for st in sched.slots if st is not None}
        out = orig(requester)
        after = {st.req.rid for st in sched.slots if st is not None}
        victims.extend(before - after)
        return out

    sched._preempt_one = watch
    results = sched.run()
    assert sched.stats.preemptions >= 1 and victims
    assert set(victims) == {rid_lo}
    np.testing.assert_array_equal(results[rid_hi],
                                  _engine_tokens(cfg, params, hi, 8))
    np.testing.assert_array_equal(results[rid_lo],
                                  _engine_tokens(cfg, params, lo, 8))


def test_lazy_admission_takes_prompt_pages_and_abort_drops_swap(tiny_model):
    """Lazy admission reserves the prompt and one token, not the worst
    case; aborting a swapped-out request releases its snapshot bytes."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(15)
    sched = _sched(cfg, params, num_pages=6, page_size=4, max_slots=2,
                   lazy_growth=True, tick_mode="packed")
    hi = sched.submit(rng.integers(0, cfg.vocab_size, (5,)), 8, priority=1)
    lo = sched.submit(rng.integers(0, cfg.vocab_size, (5,)), 8, priority=0)
    sched.step()
    # 5 prompt tokens + 1 of headroom: 2 pages each, not the 4 of 13 tokens
    assert sched.pool.pages_in_use == 4
    while not sched.stats.preemptions:
        sched.step()
    queued = [r for r in sched.queue if r.rid == lo]
    assert queued and queued[0].snapshot is not None
    assert sched.pool.swap_bytes == \
        sched.pool.snapshot_bytes(queued[0].snapshot) > 0
    assert sched.abort(lo)
    assert sched.pool.swap_bytes == 0 and sched.finish_reasons[lo] == "abort"
    sched.run()
    assert sched.finish_reasons[hi] == "length"
    assert sched.pool.pages_in_use == 0


def test_lazy_pool_too_small_fails_loudly(tiny_model):
    """A request whose growth cannot fit even alone raises instead of
    preempting itself forever."""
    cfg, _, params = tiny_model
    sched = _sched(cfg, params, num_pages=3, page_size=4, max_slots=1,
                   lazy_growth=True, tick_mode="packed")
    sched.submit(np.arange(5) % cfg.vocab_size, 8)
    with pytest.raises(TP.PoolExhaustedError, match="cannot grow"):
        sched.run()


@pytest.mark.parametrize("resume", ["swap", "refill"])
def test_packed_preempts_a_request_admitted_this_tick(tiny_model, resume):
    """Equal priorities: the queue head is admitted into the last free pages
    in the very tick a decoding slot crosses a page boundary. The growth
    runs before any prefill piece, so the victim (the newest admission) has
    written nothing; it goes back to the queue without a snapshot and both
    requests still give the Engine's tokens."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(45)
    a = rng.integers(0, cfg.vocab_size, (4,))
    b = rng.integers(0, cfg.vocab_size, (4,))
    # 4 usable pages: a takes 2 (4 + 1 tokens) and needs its 3rd on tick 6
    # (position 8); b, submitted then, takes the other 2 in that tick
    sched = _sched(cfg, params, num_pages=5, page_size=4, max_slots=2,
                   lazy_growth=True, resume=resume, tick_mode="packed")
    ra = sched.submit(a, 10)
    for _ in range(5):
        sched.step()
    assert int(sched.pool.lengths[0]) == 8 and sched.pool.free_pages == 2
    rb = sched.submit(b, 3)
    sched.step()
    assert sched.stats.preemptions == 1
    assert sched.queue[0].rid == rb and sched.queue[0].snapshot is None
    results = sched.run()
    np.testing.assert_array_equal(results[ra],
                                  _engine_tokens(cfg, params, a, 10))
    np.testing.assert_array_equal(results[rb],
                                  _engine_tokens(cfg, params, b, 3))
    assert sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0


@pytest.mark.parametrize("resume", ["swap", "refill"])
@pytest.mark.parametrize("tick_mode", ["packed", "chunked"])
def test_preempted_prefix_creator_resumes_and_forks(tiny_model, tick_mode,
                                                    resume):
    """A prefix creator evicted mid-prefix, before its prefix is pinned,
    comes back (from its snapshot, or by re-prefill as the creator anew)
    instead of waiting for itself; the fork queued behind it attaches to the
    prefix, and all three requests give the Engine's tokens."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(29)
    a = rng.integers(0, cfg.vocab_size, (5,))  # decodes and grows
    b = rng.integers(0, cfg.vocab_size, (24,))  # creator, evicted at 16-18
    f = np.concatenate([b[:22], rng.integers(0, cfg.vocab_size, (3,))])
    sched = _sched(cfg, params, num_pages=10, page_size=4, max_slots=2,
                   prefill_chunk=4, lazy_growth=True, resume=resume,
                   tick_mode=tick_mode)
    ra = sched.submit(a, 10, priority=1)
    rb = sched.submit(b, 3, priority=0, prefix_key="sys", prefix_len=22)
    rf = sched.submit(f, 3, priority=0, prefix_key="sys")
    results = sched.run()
    assert sched.stats.preemptions >= 1 and sched.stats.prefix_forks == 1
    for rid, p, n in ((ra, a, 10), (rb, b, 3), (rf, f, 3)):
        np.testing.assert_array_equal(results[rid],
                                      _engine_tokens(cfg, params, p, n))
    assert sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0


def _swap_storm(cfg, params, tick_mode, cooldown):
    """One high-priority long-runner crossing a page boundary every other
    tick, a low-priority victim, and a stream of short requests whose
    evictions keep reopening just enough room for the victim to come back
    (``test_chunked_prefill.py:275``). Every stream is the Engine's;
    returns the preemption count."""
    rng = np.random.default_rng(37)
    sched = _sched(cfg, params, num_pages=12, page_size=2, max_slots=3,
                   lazy_growth=True, preempt_cooldown=cooldown,
                   tick_mode=tick_mode)
    jobs = [(rng.integers(0, cfg.vocab_size, (4,)), 14, 2),  # grower
            (rng.integers(0, cfg.vocab_size, (4,)), 14, 0)]  # victim
    jobs += [(rng.integers(0, cfg.vocab_size, (3,)), 2, 1) for _ in range(6)]
    rids = [sched.submit(p, mn, priority=pr) for p, mn, pr in jobs]
    results = sched.run()
    for rid, (p, mn, _) in zip(rids, jobs):
        np.testing.assert_array_equal(
            results[rid], _engine_tokens(cfg, params, p, mn, cache_len=64))
    return sched.stats.preemptions


@pytest.mark.parametrize("tick_mode", ["packed", "chunked"])
def test_anti_thrash_cooldown_damps_swap_storm(tiny_model, tick_mode):
    """Without a cooldown the victim re-admits as soon as room reopens and
    is evicted again at the grower's next page boundary; a cooldown of a few
    ticks lets the grower drain first and cuts the preemptions, with the
    same tokens (``test_chunked_prefill.py:296``)."""
    cfg, _, params = tiny_model
    storm = _swap_storm(cfg, params, tick_mode, cooldown=0)
    calm = _swap_storm(cfg, params, tick_mode, cooldown=4)
    assert storm >= 2, "the workload must provoke repeated preemption"
    assert calm < storm


# ------------------------------------------------------ pool swap round trip


def test_export_free_restore_is_bit_identical():
    """``export_slot`` → ``free`` → ``restore_slot``: the slot's pages come
    back with the same codes, scales and positions (on other pages), the
    snapshot's bytes are accounted while it is out, and the transport
    counts them."""
    rng = np.random.default_rng(3)
    pool = TP.PagedKVPool(get_config("llama2-7b-tiny"), num_pages=12,
                          page_size=4, max_requests=3, device="cpu")
    for leaf in (pool.k, pool.v):
        leaf.copy_(torch.from_numpy(rng.integers(-127, 128, leaf.shape,
                                                 dtype=np.int8)))
    for leaf in (pool.k_scale, pool.v_scale):
        leaf.copy_(torch.from_numpy(rng.uniform(
            1e-3, 2e-2, leaf.shape).astype(np.float32)))
    other = pool.admit(3)
    slot = pool.admit(10, reserve_tokens=13)
    pool.commit_prefill(slot, 10)
    for t in range(10):
        pool.pos[:, pool.block_tables[slot, t // 4], t % 4] = t
    before = pool.gather_dense(slot)
    swap = HostSwapTransport()
    snap = swap.swap_out(pool, slot, n_tokens=10)
    assert pool.swap_bytes == pool.snapshot_bytes(snap) == swap.bytes_moved
    pool.free(slot)
    pool.admit(4)  # the freed pages go to someone else first
    new = swap.swap_in(pool, snap, reserve_tokens=12)
    assert pool.swap_bytes == 0 and swap.transfers == 2
    assert int(pool.lengths[new]) == 10
    after = pool.gather_dense(new)
    n = 3 * 4  # the three written pages
    for i, (b, a) in enumerate(zip(before, after)):
        cut = (slice(None), slice(0, n)) if i == 4 \
            else (slice(None), slice(None), slice(0, n))
        np.testing.assert_array_equal(a[cut].numpy(), b[cut].numpy())
    assert int(np.count_nonzero(pool.block_tables[new])) == 3
    pool.free(other)


def _host_state(pool):
    return (pool.block_tables.copy(), pool.refcount.copy(),
            pool.lengths.copy(), pool.active.copy(), list(pool._free),
            pool.swap_bytes)


def test_random_walk_with_preemption_matches_reference_pool():
    """A seeded random walk of admit, fork, append, preempt (export and
    free), restore and free on the port's pool and the reference's: the
    same block tables, refcounts, lengths, free lists and swap bytes after
    every operation (after ``test_kv_pool.py:483``)."""
    rng = np.random.default_rng(4242)
    kw = dict(num_pages=20, page_size=4, max_requests=4)
    ref = JP.PagedKVPool(jax_config("llama2-7b-tiny"), **kw)
    port = TP.PagedKVPool(get_config("llama2-7b-tiny"), device="cpu", **kw)
    handles, swapped = [], []  # (ref, port) pairs
    for _ in range(250):
        op = int(rng.integers(0, 6))
        active = [int(s) for s in np.flatnonzero(port.active)]
        outcome = []
        for pool, side in ((ref, 0), (port, 1)):
            try:
                if op == 0:
                    n = int(rng.integers(1, 13)) if side == 0 else n
                    live = [i for i, h in enumerate(handles)
                            if not h[1].released]
                    if side == 0:
                        pick = (live[int(rng.integers(len(live)))]
                                if live and rng.random() < 0.4 else None)
                    h = None if pick is None else handles[pick][side]
                    need = n if h is None else h.n_tokens + n
                    pool.admit(need, reserve_tokens=need + 2, prefix=h)
                elif op == 1 and active:
                    s = active[int(rng.integers(len(active)))] \
                        if side == 0 else s
                    ln = int(pool.lengths[s])
                    if ln >= 2:
                        k = int(rng.integers(1, ln)) if side == 0 else k
                        h = pool.share_prefix(s, k)
                        if side == 0:
                            hpair = [h]
                        else:
                            handles.append((hpair[0], h))
                elif op == 2 and active:
                    s = active[int(rng.integers(len(active)))] \
                        if side == 0 else s
                    k = int(rng.integers(1, 4)) if side == 0 else k
                    pool.append(s, k)
                elif op == 3 and active:  # preempt
                    s = active[int(rng.integers(len(active)))] \
                        if side == 0 else s
                    ln = int(pool.lengths[s])
                    if ln >= 1:
                        snap = pool.export_slot(s, n_tokens=ln)
                        pool.free(s)
                        if side == 0:
                            spair = [snap]
                        else:
                            swapped.append((spair[0], snap))
                elif op == 4 and swapped:
                    i = int(rng.integers(len(swapped))) if side == 0 else i
                    extra = int(rng.integers(0, 3)) if side == 0 else extra
                    snap = swapped[i][side]
                    pool.restore_slot(snap, reserve_tokens=snap["length"]
                                      + extra)
                    if side == 1:
                        swapped.pop(i)
                elif op == 5 and active:
                    s = active[int(rng.integers(len(active)))] \
                        if side == 0 else s
                    pool.free(s)
                outcome.append(None)
            except (JP.PoolExhaustedError, TP.PoolExhaustedError):
                outcome.append("exhausted")
                if op == 1 and side == 0:
                    hpair = [None]
        assert outcome[0] == outcome[1], op
        for a, b in zip(_host_state(port), _host_state(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for snap_ref, snap_port in swapped:
        ref.discard_snapshot(snap_ref)
        port.discard_snapshot(snap_port)
    assert port.swap_bytes == ref.swap_bytes == 0
