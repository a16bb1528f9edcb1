"""The port's speculative decoding on the CPU, against the JAX package on
bridged tiny weights and against the port's own non-speculative paths:

  * ``core.sampling.speculative_verify``: greedy rows exactly the
    reference's; a round without drafts and the bonus token after a full
    burst bit for bit the port's ``sample_tokens``; non-greedy rows held by
    distribution with the port's own draws (the reference's
    ``tests/test_speculative_sampling.py``);
  * ``PagedKVPool.truncate``: the same admits, writes, appends, forks and
    truncates on the reference pool and the port's leave equal state; a
    rollback into a shared page raises and changes nothing;
  * verify attention through the pool and ``transformer.paged_verify_step``
    against the reference's, and against S sequential
    ``paged_decode_step`` calls of the port;
  * the speculative ``Scheduler`` (wave, chunked and packed ticks, the
    per-request cap, rollback, a swap snapshot after a speculative append)
    against the reference scheduler's streams and ``spec_*`` counts and
    the port's ``Engine``;
  * split-boundary speculation (``SplitEngine.generate(speculate_k=)``) on
    the dense cloud, the paged cloud and the stateless I_kv = 0 cloud
    against the reference ``SplitEngine``'s tokens and ``SplitStats``, and
    against the port's own per-token loop;
  * ``LLMServer``'s multi-token events on the paged, fused and split
    backends (``tests/test_serving_api.py``).

Run: ``python -m pytest -q tests/test_torch_speculation.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import sampling as JS
from repro.core.opsc import OPSCConfig as JOPSC
from repro.models import transformer as JT
from repro.serving import kv_pool as JP
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.split_engine import SplitEngine as JaxSplitEngine
from repro_torch.configs import get_config
from repro_torch.core import sampling as TS
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.sampling import SamplingParams
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import from_jax_params
from repro_torch.serving import kv_pool as TP
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Scheduler, _prompt_lookup_draft
from repro_torch.serving.split_engine import SplitEngine
from test_torch_kv_pool import _filled, _Twin

torch.set_num_threads(2)

OPTS = RuntimeOpts(q_chunk=16, kv_chunk=16)
OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
JOPTS = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                       moe_capacity_factor=0.0)
JOPTS_Q = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                         quantized_kv=True, moe_capacity_factor=0.0)
# the reference scheduler with its chunk attention on the dense oracle
# route (the same function as its Pallas kernel, without interpret mode)
JOPTS_ORACLE = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                              quantized_kv=True, moe_capacity_factor=0.0,
                              paged_prefill_kernel=False)
# logits of the model across frameworks (the paged kernels' tolerance)
TOL = dict(rtol=2e-4, atol=2e-4)
# logprobs across frameworks: f32 log-softmax of logits that agree to ~1e-5
LP_TOL = dict(rtol=1e-4, atol=1e-4)
SPLIT_STATS = ("tokens_generated", "uplink_bits_measured", "uplink_bits_eq3",
               "latency_s", "early_exits", "kv_dropped_steps",
               "uplink_bits_paged", "cloud_pool_bytes_peak",
               "shared_prefix_pages", "uplink_round_trips", "spec_rounds",
               "spec_drafted", "spec_accepted")


@pytest.fixture(scope="module")
def tiny_model():
    """The reference tests' model: ``init_params(PRNGKey(0))``, bridged."""
    cfg = get_config("llama2-7b-tiny")
    jparams = JT.init_params(jax_config("llama2-7b-tiny"),
                             jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


# ---------------------------------------------------- speculative_verify


def _port_ops(params):
    return TS.sampling_operands(params)


def _verify(draft, draft_len, logits, params, t0):
    """The port's ``speculative_verify`` on host arrays → numpy."""
    r = len(params)
    seeds, temp, tk, tp = _port_ops(params)
    out, n, lps = TS.speculative_verify(
        torch.as_tensor(np.asarray(draft, np.int64).reshape(r, -1)),
        torch.as_tensor(np.asarray(draft_len, np.int64).reshape(r)),
        torch.as_tensor(np.asarray(logits, np.float32)), seeds,
        torch.as_tensor(np.asarray(t0, np.int64).reshape(r)), temp, tk, tp)
    return out.numpy(), n.numpy(), lps.numpy()


def _jax_verify(draft, draft_len, logits, params, t0):
    o = JS.sampling_operands(params)
    r = len(params)
    out, n, lps = jax.jit(JS.speculative_verify)(
        jnp.asarray(draft, jnp.int32).reshape(r, -1),
        jnp.asarray(draft_len, jnp.int32).reshape(r),
        jnp.asarray(logits, jnp.float32), jnp.asarray(o["keys"]),
        jnp.asarray(t0, jnp.int32).reshape(r), jnp.asarray(o["temperature"]),
        jnp.asarray(o["top_k"]), jnp.asarray(o["top_p"]))
    return np.asarray(out), np.asarray(n), np.asarray(lps)


def _rand_logits(r, k1, v, seed=0, scale=2.0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(r, k1, v)).astype(np.float32) * scale


def _freqs(tokens, v):
    return np.bincount(np.asarray(tokens).reshape(-1), minlength=v) \
        / tokens.size


def test_greedy_rows_equal_the_reference():
    """Greedy rows (temperature 0, or top_k 1 at any temperature): ``out``
    and ``n_out`` equal the reference's, logprobs within 1e-5; a full
    match accepts every draft, a break at j accepts j."""
    logits = _rand_logits(5, 4, 16, seed=1)
    am = logits.argmax(-1)
    draft = np.zeros((5, 3), np.int64)
    draft[0] = am[0, :3]  # all three accepted, then the bonus
    draft[1] = [am[1, 0], (am[1, 1] + 1) % 16, am[1, 2]]  # breaks at 1
    draft[2] = [(am[2, 0] + 1) % 16, am[2, 1], am[2, 2]]  # breaks at 0
    draft[3] = am[3, :3]  # draft_len 1: only one draft counts
    draft[4] = am[4, :3]
    params = [SamplingParams()] * 4 + [
        SamplingParams(top_k=1, temperature=1.5, seed=9)]
    dlen = [3, 3, 3, 1, 3]
    out, n, lps = _verify(draft, dlen, logits, params, [0, 2, 5, 1, 0])
    jout, jn, jlps = _jax_verify(draft, dlen, logits, params,
                                 [0, 2, 5, 1, 0])
    np.testing.assert_array_equal(n, [4, 2, 1, 2, 4])
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, am)
    np.testing.assert_allclose(lps, jlps, rtol=0, atol=1e-5)


def test_greedy_emission_is_draft_independent():
    """Different drafts over the same logits emit prefixes of the same
    argmax chain: a bad draft costs acceptance length only."""
    logits = _rand_logits(2, 5, 32, seed=2)
    am = logits.argmax(-1)
    rng = np.random.default_rng(3)
    params = [SamplingParams(), SamplingParams(top_k=1, temperature=1.5,
                                               seed=9)]
    for _ in range(4):
        draft = rng.integers(0, 32, (2, 4))
        out, n, _ = _verify(draft, [4, 4], logits, params, [0, 0])
        for r in range(2):
            np.testing.assert_array_equal(out[r, : n[r]], am[r, : n[r]])


def test_draft_len_zero_is_sample_tokens_bit_for_bit():
    """A round with no drafts emits EXACTLY the token ``sample_tokens``
    draws at the same generation index, greedy and seeded rows alike."""
    params = [SamplingParams(), SamplingParams(temperature=0.9, seed=5),
              SamplingParams(temperature=1.3, top_k=7, seed=6),
              SamplingParams(temperature=0.7, top_p=0.8, seed=7)]
    logits = _rand_logits(4, 1, 64, seed=4)
    seeds, temp, tk, tp = _port_ops(params)
    for t in (0, 3, 17):
        out, n, _ = _verify(np.zeros((4, 0)), [0] * 4, logits, params,
                            [t] * 4)
        want = TS.sample_tokens(torch.as_tensor(logits[:, 0]), seeds,
                                torch.full((4,), t), temp, tk, tp).numpy()
        np.testing.assert_array_equal(n, [1] * 4)
        np.testing.assert_array_equal(out[:, 0], want)


def test_bonus_token_after_full_burst_is_sample_tokens_bit_for_bit():
    """Drafts the target gives probability 1 are always accepted; the
    bonus token at column ``draft_len`` is then drawn with the bits
    ``sample_tokens`` uses at generation index ``t0 + draft_len``."""
    r, kd, v = 64, 3, 40
    rng = np.random.default_rng(21)
    logits = rng.normal(size=(r, kd + 1, v)).astype(np.float32)
    draft = rng.integers(0, v, (r, kd))
    for j in range(kd):  # a certain draft: p(draft) is exactly 1 in f32
        logits[np.arange(r), j, draft[:, j]] += 200.0
    params = [SamplingParams(temperature=0.5 + (s % 4) * 0.3,
                             top_k=(0, 5)[s % 2], top_p=(1.0, 0.9)[s % 3 > 0],
                             seed=100 + s) for s in range(r)]
    t0 = rng.integers(0, 50, (r,))
    out, n, _ = _verify(draft, [kd] * r, logits, params, t0)
    seeds, temp, tk, tp = _port_ops(params)
    want = TS.sample_tokens(torch.as_tensor(logits[:, kd]), seeds,
                            torch.as_tensor(t0 + kd), temp, tk, tp).numpy()
    np.testing.assert_array_equal(n, [kd + 1] * r)
    np.testing.assert_array_equal(out[:, :kd], draft)
    np.testing.assert_array_equal(out[:, kd], want)


def test_logprobs_are_the_raw_verify_logprobs():
    logits = _rand_logits(2, 3, 16, seed=8)
    draft = logits.argmax(-1)[:, :2]
    params = [SamplingParams(), SamplingParams(temperature=0.8, seed=3)]
    out, _, lps = _verify(draft, [2, 2], logits, params, [0, 0])
    want = TS.token_logprobs(torch.as_tensor(logits.reshape(-1, 16)),
                             torch.as_tensor(out.reshape(-1))).numpy()
    np.testing.assert_allclose(lps.reshape(-1), want, rtol=1e-6)


def test_rejected_first_position_keeps_the_target_distribution():
    """The first emitted token's law under speculation (accept a
    high-probability draft, else the residual) equals the target and plain
    ``sample_tokens`` draws from the same logits, over R seeds: L1 within
    0.08 of the analytic target and 0.10 of the plain draws (about five
    standard deviations of a 4,000-sample estimate over 12 tokens)."""
    v, r = 12, 4000
    rng = np.random.default_rng(11)
    row = (rng.normal(size=(v,)) * 1.5).astype(np.float32)
    logits = np.broadcast_to(row, (r, 2, v)).copy()
    params = [SamplingParams(temperature=1.0, seed=s) for s in range(r)]
    draft = np.full((r, 1), int(row.argmax()))
    out, n, _ = _verify(draft, [1] * r, logits, params, [0] * r)
    assert np.all(n >= 1)
    spec = _freqs(out[:, 0], v)
    seeds, temp, tk, tp = _port_ops(params)
    base = TS.sample_tokens(torch.as_tensor(logits[:, 0]), seeds,
                            torch.zeros(r, dtype=torch.int64), temp, tk,
                            tp).numpy()
    target = np.exp(row - row.max())
    target /= target.sum()
    assert np.abs(spec - target).sum() < 0.08
    assert np.abs(spec - _freqs(base, v)).sum() < 0.10


def test_acceptance_probability_is_the_target_mass_of_the_draft():
    """A mid-mass draft is emitted with probability p(draft) (the residual
    never draws it), within 0.04 over 4,000 seeds (about five standard
    deviations)."""
    v, r = 10, 4000
    rng = np.random.default_rng(13)
    row = (rng.normal(size=(v,)) * 1.2).astype(np.float32)
    logits = np.broadcast_to(row, (r, 2, v)).copy()
    d = int(np.argsort(row)[-2])
    params = [SamplingParams(temperature=1.0, seed=s) for s in range(r)]
    out, n, _ = _verify(np.full((r, 1), d), [1] * r, logits, params, [0] * r)
    p = np.exp(row - row.max())
    p /= p.sum()
    accepted = n == 2
    assert abs(accepted.mean() - p[d]) < 0.04
    # a rejected position never emits the draft: the residual excludes it
    assert not np.any(out[~accepted, 0] == d)
    assert np.array_equal(out[accepted, 0], np.full(accepted.sum(), d))


def test_accept_draws_are_independent_of_the_token_draw():
    """The accept draw has a stream of its own: among seeds whose plain
    draw at this index IS the draft, the draft is still accepted with
    probability p(draft), not always (within 0.06 over the ~1,500 such
    seeds, about five standard deviations)."""
    v, r = 8, 6000
    rng = np.random.default_rng(17)
    row = (rng.normal(size=(v,)) * 0.8).astype(np.float32)
    logits = np.broadcast_to(row, (r, 2, v)).copy()
    d = int(np.argsort(row)[-1])
    params = [SamplingParams(temperature=1.0, seed=s) for s in range(r)]
    _, n, _ = _verify(np.full((r, 1), d), [1] * r, logits, params, [0] * r)
    seeds, temp, tk, tp = _port_ops(params)
    plain = TS.sample_tokens(torch.as_tensor(logits[:, 0]), seeds,
                             torch.zeros(r, dtype=torch.int64), temp, tk,
                             tp).numpy()
    p = np.exp(row - row.max())
    p /= p.sum()
    same = plain == d
    assert same.sum() > 1000
    assert abs((n[same] == 2).mean() - p[d]) < 0.06


def test_top_k_top_p_speculation_stays_in_support():
    """Accepted and corrected tokens of top-k and top-p rows never leave
    the filtered support."""
    v, r, kd = 16, 512, 2
    logits = _rand_logits(r, kd + 1, v, seed=17, scale=1.0)
    params = [SamplingParams(temperature=1.1, top_k=4, seed=s)
              if s % 2 else SamplingParams(temperature=0.9, top_p=0.5,
                                           seed=s) for s in range(r)]
    rng = np.random.default_rng(19)
    draft = rng.integers(0, v, (r, kd))
    out, n, _ = _verify(draft, [kd] * r, logits, params, [0] * r)
    topk = np.argsort(logits, axis=-1)[..., -4:]
    for row in range(r):
        for j in range(n[row]):
            if row % 2:
                assert out[row, j] in topk[row, j]
            else:
                z = logits[row, j] / 0.9
                pz = np.exp(z - z.max())
                pz /= pz.sum()
                order = np.argsort(-z)
                cum = np.cumsum(pz[order]) - pz[order]
                assert out[row, j] in set(order[cum < 0.5]) | {order[0]}


def test_prompt_lookup_draft_equals_the_reference():
    from repro.serving.scheduler import \
        _prompt_lookup_draft as jax_lookup

    rng = np.random.default_rng(5)
    for _ in range(40):
        ctx = rng.integers(0, 5, (int(rng.integers(0, 14)),))
        for k in (0, 1, 3):
            np.testing.assert_array_equal(_prompt_lookup_draft(ctx, k),
                                          jax_lookup(ctx, k))


# ---------------------------------------------------------------- truncate


def test_truncate_matches_the_reference_pool():
    """Admits, writes, speculative appends, truncates of the rejected tail
    and forks on both pools: host and device state equal after every
    step; the scrubbed positions are -1 and the pages stay allocated."""
    rng = np.random.default_rng(31)
    twin = _Twin(num_pages=24, page_size=4, max_requests=3)
    a = _filled(twin, 6, rng, reserve_tokens=16)
    b = _filled(twin, 9, rng)
    h = twin.share_prefix(a, 4)
    c = _filled(twin, 7, rng, prefix=h)
    twin.check()
    for slot, burst, keep in ((a, 4, 2), (b, 3, 1), (c, 5, 3), (a, 2, 2),
                              (b, 4, 4), (c, 2, 0)):
        lo = int(twin.port.lengths[slot])
        twin.append(slot, burst)
        twin.write(slot, lo, lo + burst, rng)
        pages = int(np.count_nonzero(twin.port.block_tables[slot]))
        twin.truncate(slot, lo + keep)
        twin.check()
        assert int(twin.port.lengths[slot]) == lo + keep
        assert int(np.count_nonzero(twin.port.block_tables[slot])) == pages
        held = twin.port.gather_dense(slot)[4]
        assert int(held.max()) == lo + keep - 1
    twin.truncate(b, int(twin.port.lengths[b]))  # a no-op
    twin.check()
    for s in (a, b, c):
        twin.free(s)
    twin.release_prefix(h)
    twin.check()
    assert twin.port.pages_in_use == 0


def test_truncate_into_a_shared_page_raises_and_changes_nothing():
    rng = np.random.default_rng(32)
    twin = _Twin(num_pages=16, page_size=4, max_requests=2)
    a = _filled(twin, 10, rng)
    twin.share_prefix(a, 8)
    twin.check()
    before = (twin.port.lengths.copy(), twin.port.pos.clone())
    for new_len in (3, 7):  # inside the shared pages
        with pytest.raises(ValueError):
            twin.truncate(a, new_len)
    with pytest.raises(ValueError):
        twin.truncate(a, 0)
    with pytest.raises(ValueError):
        twin.truncate(a, 11)
    np.testing.assert_array_equal(twin.port.lengths, before[0])
    assert torch.equal(twin.port.pos, before[1])
    twin.truncate(a, 9)  # the exclusively owned boundary page: allowed
    twin.check()


# ------------------------------------------------- verify through the pool


def _verify_inputs(cfg, rng, lens, burst, s):
    """Prompts of ``lens`` tokens and a right-aligned (R, S) verify burst of
    ``burst[r]`` tokens a row from position ``lens[r]``: (prompts,
    tokens, positions)."""
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    tokens = np.zeros((len(lens), s), np.int64)
    posn = np.full((len(lens), s), -1, np.int32)
    for r, (n, k) in enumerate(zip(lens, burst)):
        tokens[r, s - k:] = rng.integers(0, cfg.vocab_size, (k,))
        posn[r, s - k:] = np.arange(n, n + k)
    return prompts, tokens, posn


def _prefilled_port_pool(cfg, params, prompts, s):
    pool = TP.PagedKVPool(cfg, num_pages=24, page_size=4,
                          max_requests=len(prompts), device="cpu")
    smax = max(len(p) for p in prompts)
    tokens = np.zeros((len(prompts), smax), np.int64)
    posn = np.full((len(prompts), smax), -1, np.int32)
    for r, p in enumerate(prompts):
        pool.admit(len(p), reserve_tokens=len(p) + s)
        tokens[r, smax - len(p):] = p
        posn[r, smax - len(p):] = np.arange(len(p))
    with torch.inference_mode():
        TT.paged_prefill(params, cfg, torch.as_tensor(tokens),
                         pool.device_caches(), torch.as_tensor(posn), OPTS_Q)
    return pool, tokens, posn


def test_paged_verify_step_matches_reference_and_sequential_decode(
        tiny_model):
    """Rows of 6, 9 and 3 prompt tokens verify bursts of 4, 2 and 1 tokens
    (right-aligned, S = 4): the logits equal the reference's
    ``paged_verify_step`` on the same pool within ``TOL``, and each column
    equals the port's own sequential ``paged_decode_step`` at that
    position within 1e-5, argmax equal."""
    cfg, jparams, params = tiny_model
    jcfg = jax_config("llama2-7b-tiny")
    rng = np.random.default_rng(41)
    lens, burst, s = (6, 9, 3), (4, 2, 1), 4
    prompts, tokens, posn = _verify_inputs(cfg, rng, lens, burst, s)

    pool, ptoks, pposn = _prefilled_port_pool(cfg, params, prompts, s)
    with torch.inference_mode():
        got, _ = TT.paged_verify_step(params, cfg, torch.as_tensor(tokens),
                                      pool.device_caches(),
                                      torch.as_tensor(posn), OPTS_Q)
    got = got.numpy()

    jpool = JP.PagedKVPool(jcfg, num_pages=24, page_size=4,
                           max_requests=len(prompts))
    for p in prompts:
        jpool.admit(len(p), reserve_tokens=len(p) + s)
    _, caches = JT.paged_prefill(jparams, jcfg, jnp.asarray(ptoks),
                                 jpool.device_caches(), jnp.asarray(pposn),
                                 JOPTS_Q)
    jpool.update_from(caches)
    want, _ = JT.paged_verify_step(jparams, jcfg, jnp.asarray(tokens),
                                   jpool.device_caches(), jnp.asarray(posn),
                                   JOPTS_Q)
    want = np.asarray(want)
    live = posn >= 0
    np.testing.assert_allclose(got[live], want[live], **TOL)

    seq_pool, _, _ = _prefilled_port_pool(cfg, params, prompts, s)
    for j in range(s):
        with torch.inference_mode():
            step, _ = TT.paged_decode_step(
                params, cfg, torch.as_tensor(tokens[:, j:j + 1]),
                seq_pool.device_caches(), torch.as_tensor(posn[:, j]),
                OPTS_Q)
        for r in range(len(lens)):
            if posn[r, j] < 0:
                continue
            np.testing.assert_allclose(got[r, j], step[r].numpy(), rtol=0,
                                       atol=1e-5)
            assert got[r, j].argmax() == int(step[r].argmax())


# --------------------------------------------------------------- scheduler


def _repetitive_prompts(cfg, n=4, seed=7):
    """The reference's prompts with a repeating 3-gram, so prompt lookup
    proposes drafts."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, cfg.vocab_size, (3,)), 4)[:9]
            .astype(np.int32) for _ in range(n)]


def _serve_pair(tiny_model, mode, prompts, max_new, k):
    """The same requests through the reference scheduler and the port's:
    [(streams, stats, scheduler, events)] for each."""
    cfg, jparams, params = tiny_model
    kw = dict(num_pages=32, page_size=4, max_slots=3, tick_mode=mode,
              speculate_k=k)
    out = []
    for sched in (JaxScheduler(jax_config("llama2-7b-tiny"), jparams,
                               JOPTS_ORACLE, **kw),
                  Scheduler(cfg, params, OPTS_Q, device="cpu", **kw)):
        rids = [sched.submit(pr, max_new) for pr in prompts]
        res = sched.run()
        out.append(([res[r] for r in rids], sched.stats, sched,
                    sched.drain_events()))
    return out


def _engine_tokens(cfg, params, prompt, max_new):
    return Engine(cfg, params, OPTS_Q, cache_len=32,
                  device="cpu").generate(prompt[None], max_new).tokens[0]


def _same_spec_counts(got, want):
    for f in ("spec_rounds", "spec_drafted", "spec_accepted", "steps"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("mode", ["packed", "chunked", "wave"])
def test_speculative_scheduler_matches_engine(tiny_model, mode):
    """``speculate_k`` never changes a greedy stream: each equals the
    reference scheduler's and the port's ``Engine``'s in every tick mode,
    with the reference's ``spec_*`` counts and decode steps, fewer steps
    than the k = 0 run, events in index order with finite logprobs, and
    the pool drained."""
    cfg, _, params = tiny_model
    prompts = _repetitive_prompts(cfg)
    (want, wst, _, _), (got, st, sched, events) = _serve_pair(
        tiny_model, mode, prompts, 6, 3)
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _engine_tokens(cfg, params, p, 6))
    _same_spec_counts(st, wst)
    base = Scheduler(cfg, params, OPTS_Q, num_pages=32, page_size=4,
                     max_slots=3, tick_mode=mode, device="cpu")
    for p in prompts:
        base.submit(p, 6)
    base.run()
    assert st.steps < base.stats.steps
    assert st.spec_rounds > 0 and st.spec_drafted >= st.spec_accepted > 0
    assert st.acceptance_rate == wst.acceptance_rate
    assert 0.0 < st.acceptance_rate <= 1.0
    seen = {}
    for rid, idx, tok, lp in events:
        assert idx == seen.get(rid, -1) + 1 and np.isfinite(lp)
        seen[rid] = idx
    assert sched.pool.pages_in_use == 0
    if mode == "packed":
        # the decoding slots ride the verify call, not the packed buffer
        assert {sh[0] for sh in sched._shapes} == {"packed", "verify"}


def test_speculative_per_request_cap(tiny_model):
    """``SamplingParams(speculate_k=1)`` caps a request's burst at one
    draft under a scheduler-wide k of 3; the stream and the counts equal
    the reference's."""
    cfg, _, params = tiny_model
    p = _repetitive_prompts(cfg, n=1)[0]
    sp = SamplingParams(max_tokens=6, speculate_k=1)
    jsp = JS.SamplingParams(max_tokens=6, speculate_k=1)
    cfg_j = jax_config("llama2-7b-tiny")
    _, jparams, _ = tiny_model
    jsched = JaxScheduler(cfg_j, jparams, JOPTS_ORACLE, num_pages=32,
                          page_size=4, max_slots=3, tick_mode="chunked",
                          speculate_k=3)
    jrid = jsched.submit(p, sampling=jsp)
    want = jsched.run()[jrid]
    sched = Scheduler(cfg, params, OPTS_Q, num_pages=32, page_size=4,
                      max_slots=3, tick_mode="chunked", speculate_k=3,
                      device="cpu")
    rid = sched.submit(p, sampling=sp)
    got = sched.run()[rid]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _engine_tokens(cfg, params, p, 6))
    _same_spec_counts(sched.stats, jsched.stats)
    assert 0 < sched.stats.spec_drafted <= sched.stats.spec_rounds


@pytest.mark.parametrize("seed,n,max_new", [(11, 3, 7), (28, 3, 8)],
                         ids=["reference", "rejections"])
def test_speculative_rejection_rolls_back_exactly(tiny_model, seed, n,
                                                  max_new):
    """The reference test's inputs (seed 11), and inputs on which the
    random-init model rejects drafts (seed 28): streams equal the reference
    scheduler's and the ``Engine``'s, the counts equal the reference's,
    every rejected tail is truncated, and the pool drains."""
    cfg, _, params = tiny_model
    prompts = _repetitive_prompts(cfg, n=n, seed=seed)
    (want, wst, _, _), (got, st, sched, _) = _serve_pair(
        tiny_model, "chunked", prompts, max_new, 3)
    for p, g, w in zip(prompts, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, _engine_tokens(cfg, params, p,
                                                        max_new))
    _same_spec_counts(st, wst)
    if seed == 28:
        assert st.spec_accepted < st.spec_drafted  # rollbacks happened
    assert sched.pool.pages_in_use == 0
    assert not sched.pool.refcount.any()


@pytest.mark.parametrize("k", [0, 3])
def test_swap_snapshot_excludes_speculative_append(tiny_model, k):
    """Slot 0 appends its tick (with k = 3, the whole draft burst), then
    slot 1's growth exhausts the pool and preempts slot 0: its snapshot
    must hold only WRITTEN positions, or the restored request carries a
    hole. Both streams equal the ``Engine``'s and the reference's."""
    cfg, jparams, params = tiny_model
    rng = np.random.default_rng(0)
    a = rng.integers(0, cfg.vocab_size, (5,))
    b = rng.integers(0, cfg.vocab_size, (5,))
    kw = dict(num_pages=6, page_size=4, max_slots=2, lazy_growth=True,
              resume="swap", speculate_k=k)
    jsched = JaxScheduler(jax_config("llama2-7b-tiny"), jparams, JOPTS_ORACLE,
                          **kw)
    jr = [jsched.submit(a, 8, priority=0), jsched.submit(b, 8, priority=1)]
    jres = jsched.run()
    sched = Scheduler(cfg, params, OPTS_Q, device="cpu", **kw)
    r = [sched.submit(a, 8, priority=0), sched.submit(b, 8, priority=1)]
    res = sched.run()
    assert sched.stats.preemptions >= 1
    assert sched.stats.preemptions == jsched.stats.preemptions
    for rid, jrid, p in zip(r, jr, (a, b)):
        np.testing.assert_array_equal(res[rid], jres[jrid])
        np.testing.assert_array_equal(res[rid],
                                      _engine_tokens(cfg, params, p, 8))
    assert sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0


def test_speculative_stop_token_cuts_the_burst(tiny_model):
    """A stop token ends the request where a sequential decode would, also
    inside an accepted burst, whose later tokens are dropped and rolled
    back in the pool."""
    cfg, _, params = tiny_model
    p = _repetitive_prompts(cfg, n=1, seed=7)[0]
    full = _engine_tokens(cfg, params, p, 8)[len(p):]
    stop = int(full[3])
    cut = list(full).index(stop) + 1
    sched = Scheduler(cfg, params, OPTS_Q, num_pages=32, page_size=4,
                      max_slots=2, speculate_k=3, device="cpu")
    rid = sched.submit(p, sampling=SamplingParams(max_tokens=8,
                                                  stop_token_ids=(stop,)))
    got = sched.run()[rid][len(p):]
    np.testing.assert_array_equal(got, full[:cut])
    assert sched.finish_reasons[rid] == "stop"
    assert sched.pool.pages_in_use == 0


# ------------------------------------------------------------ split engine


def _split_prompts(cfg):
    """``tests/test_serving.py::test_split_engine_speculative_matches_per_
    token``'s two repetitive rows."""
    return np.concatenate([
        np.tile(np.random.default_rng(s).integers(0, cfg.vocab_size, (1, 3)),
                (1, 3)) for s in (6, 14)])


@pytest.mark.parametrize("cloud", ["dense", "paged", "ikv0", "deadline"])
def test_split_speculation_matches_reference_and_per_token(tiny_model,
                                                           cloud):
    """The reference test's inputs (compressed uplink, full-precision
    front): the speculative split gives the reference ``SplitEngine``'s
    tokens and every ``SplitStats`` count (whatever the reference gives;
    on random weights it accepts few drafts), and the port's own
    per-token loop's tokens. ``deadline``: the dense cloud under a 2 ms
    deadline that one-token payloads meet and the first 4-token burst
    does not, so the ladder drops the KV cache and then stops, as the
    reference's does: the tokens emitted before the cut are the per-token
    loop's first ones."""
    cfg, jparams, params = tiny_model
    prompts = _split_prompts(cfg)
    kw = {"paged": dict(paged_cloud_kv=True, cloud_pool_pages=32,
                        cloud_page_size=8),
          "deadline": dict(deadline_s=2e-3, compute_per_layer_s=1e-4)
          }.get(cloud, {})
    i_kv = 0 if cloud == "ikv0" else 1
    jeng = JaxSplitEngine(jax_config("llama2-7b-tiny"), jparams,
                          JOPSC(split_layer=1, qw_front=16, i_kv=i_kv),
                          opts=JOPTS, cache_len=64, **kw)
    want, wst = jeng.generate(prompts, 6, compress=True, speculate_k=3)
    eng = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=16,
                                              i_kv=i_kv),
                      opts=OPTS, cache_len=64, device="cpu", **kw)
    got, st = eng.generate(prompts, 6, compress=True, speculate_k=3)
    base, bst = eng.generate(prompts, 6, compress=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base[:, :got.shape[1]])
    assert got.shape == base.shape or cloud == "deadline"
    for f in SPLIT_STATS:
        assert getattr(st, f) == getattr(wst, f), f
    assert st.acceptance_rate == wst.acceptance_rate
    assert st.spec_rounds > 0 or cloud == "deadline"
    assert st.uplink_round_trips <= bst.uplink_round_trips
    if cloud == "deadline":
        assert (st.kv_dropped_steps, st.early_exits) == (1, 1)
        assert (bst.kv_dropped_steps, bst.early_exits) == (0, 0)


def test_split_speculation_with_logprobs_and_sampling(tiny_model):
    """With logprobs, the speculative split's greedy logprobs equal its
    per-token loop's within 1e-5; a seeded non-greedy request runs, its
    tokens in the vocabulary, and ``max_new_tokens`` 1 and 2 take no or
    one draft-free round."""
    cfg, _, params = tiny_model
    prompts = _split_prompts(cfg)
    eng = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=16),
                      opts=OPTS, cache_len=64, device="cpu")
    t0, _, lp0 = eng.generate(prompts, 6, with_logprobs=True)
    t1, st, lp1 = eng.generate(prompts, 6, with_logprobs=True,
                               speculate_k=2)
    np.testing.assert_array_equal(t1, t0)
    np.testing.assert_allclose(lp1, lp0, rtol=0, atol=1e-5)
    sp = SamplingParams(temperature=0.9, top_k=8, seed=3)
    toks, _ = eng.generate(prompts, 6, sampling=sp, speculate_k=3)
    assert toks.shape == (2, 15) and (toks >= 0).all() \
        and (toks < cfg.vocab_size).all()
    for n, rounds in ((1, 0), (2, 1)):
        toks, st = eng.generate(prompts, n, speculate_k=3)
        np.testing.assert_array_equal(toks, t0[:, :9 + n])
        assert st.spec_rounds == rounds and st.spec_drafted == 0


# -------------------------------------------------------------- the API


def test_speculative_multi_token_events_ordered_across_backends(tiny_model):
    """A verify round emits several tokens at once; the API still streams
    them in index order, each with the verify logits' logprob: on the
    paged backend equal to the non-speculative run's within 1e-6 (the
    reference test's bound). The fused backend ignores ``speculate_k``;
    the split backend carries its ``SplitStats``."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(13)
    p = np.tile(rng.integers(0, cfg.vocab_size, (3,)), 3)
    sp = SamplingParams(max_tokens=6, speculate_k=3)

    def stream_tokens(srv, sp_):
        rid = srv.submit(p, sp_)
        return rid, [e for e in srv.stream() if e.rid == rid
                     and not e.finished]

    def paged(**kw):
        return LLMServer(cfg, params, OPTS_Q, backend="paged", device="cpu",
                         num_pages=24, page_size=4, max_slots=3, **kw)

    _, evs0 = stream_tokens(paged(), SamplingParams(max_tokens=6))
    srv = paged(speculate_k=3)
    _, evs = stream_tokens(srv, sp)
    assert srv.backend.scheduler.stats.spec_accepted > 0
    assert [e.index for e in evs] == list(range(6))
    assert [e.token for e in evs] == [e.token for e in evs0]
    np.testing.assert_allclose(
        np.asarray([e.logprob for e in evs], np.float32),
        np.asarray([e.logprob for e in evs0], np.float32), rtol=0, atol=1e-6)

    srv = LLMServer(cfg, params, OPTS_Q, backend="fused", cache_len=32,
                    device="cpu")
    _, evs_f = stream_tokens(srv, sp)
    assert [e.index for e in evs_f] == list(range(6))
    assert [e.token for e in evs_f] == [e.token for e in evs0]

    def split_srv():
        return LLMServer(cfg, params, OPTS, backend="split", device="cpu",
                         opsc=OPSCConfig(split_layer=1, qw_front=16, i_kv=1),
                         compress=False, cache_len=32)

    _, evs_ref = stream_tokens(split_srv(), SamplingParams(max_tokens=6))
    srv = split_srv()
    rid, evs_s = stream_tokens(srv, sp)
    assert [e.index for e in evs_s] == list(range(len(evs_s)))
    assert [e.token for e in evs_s] == [e.token for e in evs_ref]
    assert all(e.logprob is not None and np.isfinite(e.logprob)
               for e in evs_s)
    st = srv.outputs()[rid].split_stats
    assert st.spec_rounds > 0 and st.spec_drafted > 0
    assert st.uplink_round_trips <= len(evs_s)
