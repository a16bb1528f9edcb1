"""The port's split path against the JAX package on bridged tiny weights:
``SplitEngine`` (edge front, TS + TAB-Q uplink, dense or paged cloud,
shared prefix, the stateless I_kv = 0 cloud, the Algorithm 2 ladder) and
``LLMServer(backend="split")``, on the reference cases of
``tests/test_serving.py`` (speculation aside) and
``tests/test_serving_api.py``. Greedy tokens and every ``SplitStats``
count are held equal to the reference's; logprobs within 1e-4. The
uncompressed full-precision split equals the port's own ``Engine`` bit for
bit, seeded sampling included."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.opsc import OPSCConfig as JOPSC
from repro.models import transformer as JT
from repro.serving.split_engine import SplitEngine as JaxSplitEngine
from repro_torch.configs import get_config
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.quant import QuantizedTensor
from repro_torch.core.sampling import SamplingParams
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import from_jax_params
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.split_engine import SplitEngine
from repro_torch.serving.telemetry import Tracer

torch.set_num_threads(2)

OPTS = RuntimeOpts(q_chunk=16, kv_chunk=16)
JOPTS = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                       moe_capacity_factor=0.0)
OPTS_Q = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
# logprobs across frameworks: f32 log-softmax of logits that agree to ~1e-5
LP_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_FIELDS = ("tokens_generated", "uplink_bits_measured", "uplink_bits_eq3",
               "latency_s", "early_exits", "kv_dropped_steps",
               "uplink_bits_paged", "cloud_pool_bytes_peak",
               "shared_prefix_pages", "uplink_round_trips")


@pytest.fixture(scope="module")
def tiny_model():
    cfg = get_config("llama2-7b-tiny")  # 2 layers, pattern length 1
    jparams = JT.init_params(jax_config("llama2-7b-tiny"),
                             jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


def _pair(tiny_model, opsc_kw, prompts, n, gen_kw=None, opts=OPTS,
          **eng_kw):
    """The same split call on the reference and on the port (CPU):
    ((tokens, stats), (tokens, stats))."""
    cfg, jparams, params = tiny_model
    gen_kw = gen_kw or {}
    jopts = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                           moe_capacity_factor=0.0,
                           quantized_kv=opts.quantized_kv)
    want = JaxSplitEngine(jax_config("llama2-7b-tiny"), jparams,
                          JOPSC(split_layer=1, **opsc_kw), opts=jopts,
                          cache_len=64, **eng_kw).generate(prompts, n,
                                                           **gen_kw)
    got = SplitEngine(cfg, params, OPSCConfig(split_layer=1, **opsc_kw),
                      opts=opts, cache_len=64, device="cpu",
                      **eng_kw).generate(prompts, n, **gen_kw)
    return want, got


def _assert_same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    for f in STAT_FIELDS:
        assert getattr(got[1], f) == getattr(want[1], f), f


@pytest.mark.parametrize("opts", [OPTS, OPTS_Q], ids=["bf16kv", "int8kv"])
def test_split_matches_monolithic_uncompressed(tiny_model, opts):
    """No compression and a full-precision front: the split equals the
    port's Engine bit for bit, and the reference split."""
    cfg, _, params = tiny_model
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))
    want, got = _pair(tiny_model, dict(qw_front=16, i_kv=1), prompts, 5,
                      dict(compress=False), opts=opts)
    _assert_same(want, got)
    eng = Engine(cfg, params, opts, cache_len=64, device="cpu")
    np.testing.assert_array_equal(got[0], eng.generate(prompts, 5).tokens)
    assert got[1].uplink_bits_eq3 > 0
    # the uplink transport accounts every payload: the prefill and 4 steps
    split = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=16),
                        opts=opts, cache_len=64, device="cpu")
    _, st = split.generate(prompts, 5, compress=False)
    assert split._uplink.transfers == 1 + st.uplink_round_trips == 5
    assert split._uplink.bytes_moved * 8 == st.uplink_bits_measured


def test_split_seeded_sampling_equals_engine(tiny_model):
    """Per-row sampling params (greedy, seeded top-p, top-k) through the
    uncompressed split give ``Engine``'s streams and logprobs exactly: the
    two share one sampler."""
    cfg, _, params = tiny_model
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 6))
    sps = [SamplingParams(max_tokens=7),
           SamplingParams(max_tokens=7, temperature=0.8, top_p=0.9, seed=7),
           SamplingParams(max_tokens=7, temperature=1.2, top_k=5, seed=3)]
    eng = Engine(cfg, params, OPTS_Q, cache_len=64, device="cpu")
    want = eng.generate_requests(prompts, sps)
    split = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=16),
                        opts=OPTS_Q, cache_len=64, device="cpu")
    toks, _, lps = split.generate(prompts, 7, compress=False, sampling=sps,
                                  with_logprobs=True)
    np.testing.assert_array_equal(toks, want.tokens)
    np.testing.assert_array_equal(lps, want.logprobs)


# logprobs with an int8-code front against the reference's fake-quantized
# one: the products differ in the last bits (code × scale is rounded in the
# reference's weight, not in K7's), and a TAB-Q code on a rounding boundary
# then lands one step apart (a 6-bit level is 1/31 of a token's range)
LP_TOL_QUANT_FRONT = dict(rtol=0, atol=1e-2)


@pytest.mark.parametrize("opsc_kw,lp_tol", [
    (dict(qw_front=16, tau=0.5, max_act_bits=6), LP_TOL),
    (dict(qw_front=8, qa_front=8, tau=2.0, delta=0.05, max_act_bits=8),
     LP_TOL_QUANT_FRONT),
    (dict(qw_front=4), LP_TOL_QUANT_FRONT),  # the paper's defaults
    (dict(qw_front=4, tau=0.5, max_act_bits=6), LP_TOL_QUANT_FRONT),
])
def test_split_compressed_matches_reference(tiny_model, opsc_kw, lp_tol):
    """TS + TAB-Q payloads, with full-precision or int8-code front weights
    (the reference fake-quantizes them): the same tokens, measured bits and
    Eq. 3 bits as the reference, and close logprobs."""
    cfg, _, _ = tiny_model
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 8))
    want, got = _pair(tiny_model, opsc_kw, prompts, 8,
                      dict(compress=True, with_logprobs=True))
    _assert_same(want, got)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **lp_tol)
    assert got[1].uplink_bits_measured > 0


def test_split_ikv0_stateless_cloud(tiny_model):
    """I_kv = 0: the stateless cloud re-run gives the cached path's greedy
    tokens; hidden-only Eq. 3 accounting is far smaller; both as in the
    reference."""
    cfg, _, _ = tiny_model
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 6))
    w1, g1 = _pair(tiny_model, dict(qw_front=16, i_kv=1), prompts, 5,
                   dict(compress=False))
    w0, g0 = _pair(tiny_model, dict(qw_front=16, i_kv=0), prompts, 5,
                   dict(compress=False), opts=OPTS_Q)
    _assert_same(w1, g1)
    np.testing.assert_array_equal(g0[0], g1[0])
    np.testing.assert_array_equal(g0[0], w0[0])
    assert g0[1].uplink_bits_eq3 == w0[1].uplink_bits_eq3
    assert g0[1].uplink_bits_eq3 < g1[1].uplink_bits_eq3


@pytest.mark.parametrize("deadline,per_layer", [(1e-7, 1e-3), (2e-3, 1e-4)])
def test_split_deadline_ladder_matches_reference(tiny_model, deadline,
                                                 per_layer):
    """Algorithm 2 on measured payload bits: the same early exits, dropped
    KV steps and modelled latency as the reference, and a truncated
    generation under the tightest deadline."""
    cfg, _, _ = tiny_model
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 6))
    want, got = _pair(tiny_model, dict(qw_front=16), prompts, 10,
                      dict(compress=True), deadline_s=deadline,
                      compute_per_layer_s=per_layer)
    _assert_same(want, got)
    if deadline < 1e-6:
        assert got[1].early_exits >= 1 and got[0].shape[1] < 16


def test_split_compression_shrinks_uplink(tiny_model):
    cfg, _, _ = tiny_model
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 8))
    kw = dict(qw_front=16, tau=5.0, max_act_bits=6)
    w_raw, g_raw = _pair(tiny_model, kw, prompts, 5, dict(compress=False))
    w_cmp, g_cmp = _pair(tiny_model, kw, prompts, 5, dict(compress=True))
    _assert_same(w_raw, g_raw)
    _assert_same(w_cmp, g_cmp)
    assert g_cmp[1].uplink_bits_measured < g_raw[1].uplink_bits_measured / 2


def test_split_paged_cloud_matches_dense(tiny_model):
    """I_kv = 1 with a paged cloud pool (kernel K2 on decode): the dense
    cloud's tokens, and the reference's page-granular uplink and residency
    counts."""
    cfg, _, params = tiny_model
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    paged = dict(paged_cloud_kv=True, cloud_pool_pages=32, cloud_page_size=8)
    want, got = _pair(tiny_model, dict(qw_front=16, i_kv=1), prompts, 5,
                      dict(compress=False), **paged)
    _assert_same(want, got)
    dense = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=16),
                        opts=OPTS, cache_len=64, device="cpu")
    np.testing.assert_array_equal(got[0], dense.generate(
        prompts, 5, compress=False)[0])
    st = got[1]
    assert st.uplink_bits_paged > 0 and st.cloud_pool_bytes_peak > 0
    assert st.cloud_pool_bytes_peak * 8 <= st.uplink_bits_eq3


def test_split_shared_cloud_prefix(tiny_model):
    """Edge devices sharing a prompt prefix: the cloud pool holds it once
    (K3 reads it on rows 1+), it crosses the uplink once, and every page
    count equals the reference's; mismatched rows are refused."""
    cfg, _, params = tiny_model
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, cfg.vocab_size, (1, 8))
    prompts = np.concatenate([np.repeat(prefix, 3, axis=0),
                              rng.integers(0, cfg.vocab_size, (3, 4))], 1)
    paged = dict(paged_cloud_kv=True, cloud_pool_pages=16, cloud_page_size=8)
    w_plain, g_plain = _pair(tiny_model, dict(qw_front=16, i_kv=1), prompts,
                             5, dict(compress=False), **paged)
    w_sh, g_sh = _pair(tiny_model, dict(qw_front=16, i_kv=1), prompts, 5,
                       dict(compress=False, shared_prefix_len=8), **paged)
    w_cmp, g_cmp = _pair(tiny_model, dict(qw_front=16, i_kv=1), prompts, 5,
                         dict(compress=True, shared_prefix_len=8), **paged)
    for want, got in ((w_plain, g_plain), (w_sh, g_sh), (w_cmp, g_cmp)):
        _assert_same(want, got)
    np.testing.assert_array_equal(g_sh[0], g_plain[0])
    assert g_sh[1].shared_prefix_pages == 1
    assert g_sh[1].cloud_pool_bytes_peak < g_plain[1].cloud_pool_bytes_peak
    assert g_sh[1].uplink_bits_paged < g_plain[1].uplink_bits_paged
    assert g_sh[1].uplink_bits_measured < g_plain[1].uplink_bits_measured

    def build():
        return SplitEngine(cfg, params, OPSCConfig(split_layer=1,
                                                   qw_front=16),
                           opts=OPTS, cache_len=64, device="cpu", **paged)

    bad = prompts.copy()
    bad[1, 2] = (bad[1, 2] + 1) % cfg.vocab_size
    for n in (8, 3):  # a sub-page prefix shares nothing but is validated
        with pytest.raises(ValueError, match="do not share"):
            build().generate(bad, 5, compress=False, shared_prefix_len=n)
    toks, st = build().generate(prompts, 5, compress=False,
                                shared_prefix_len=3)
    assert st.shared_prefix_pages == 0
    np.testing.assert_array_equal(toks, g_plain[0])
    with pytest.raises(ValueError, match="paged_cloud_kv"):
        SplitEngine(cfg, params, OPSCConfig(split_layer=1), opts=OPTS,
                    cache_len=64, device="cpu").generate(
            prompts, 2, shared_prefix_len=8)


def test_split_edge_weights_are_int8_codes(tiny_model):
    """The edge holds int8 codes and per-output-channel scales for its
    seven projections (norms and embedding as they were); at 16 bits it
    holds the bridged weights themselves; from 9 to 15 bits int16 codes,
    which ``edge_weight_bytes`` counts at two bytes a code."""
    cfg, _, params = tiny_model
    eng = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=4),
                      opts=OPTS, device="cpu")
    quant = {k: v for k, v in eng.edge_params.items()
             if isinstance(v, QuantizedTensor)}
    assert len(quant) == 7
    for k, q in quant.items():
        assert q.codes.dtype == torch.int8 and q.codes.shape[0] == 1
        assert int(q.codes.abs().max()) <= 7
        assert q.scale.shape == (1, 1, params[k].shape[-1])
    full = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=16),
                       opts=OPTS, device="cpu")
    assert full.edge_weight_bytes() > 3 * eng.edge_weight_bytes()
    wide = SplitEngine(cfg, params, OPSCConfig(split_layer=1, qw_front=12),
                       opts=OPTS, device="cpu")
    wide_q = {k: v for k, v in wide.edge_params.items()
              if isinstance(v, QuantizedTensor)}
    assert wide_q.keys() == quant.keys()
    for k, q in wide_q.items():
        assert q.codes.dtype == torch.int16
        assert int(q.codes.abs().max()) <= 2047
    extra = sum(q.codes.numel() for q in wide_q.values())
    assert wide.edge_weight_bytes() == eng.edge_weight_bytes() + extra


def test_split_refusals(tiny_model):
    cfg, _, params = tiny_model
    eng = SplitEngine(cfg, params, OPSCConfig(split_layer=1), opts=OPTS,
                      cache_len=16, device="cpu")
    p = np.zeros((1, 8), np.int64)
    # speculation is ported: it runs, and gives the per-token loop's tokens
    # (tests/test_torch_speculation.py holds it to the reference)
    toks, st = eng.generate(p, 4, speculate_k=2)
    np.testing.assert_array_equal(toks, eng.generate(p, 4)[0])
    assert st.spec_rounds > 0
    with pytest.raises(ValueError):
        eng.generate(p, 2, speculate_k=-1)
    with pytest.raises(ValueError, match="cache_len"):
        eng.generate(p, 9)
    # telemetry is ported: a traced engine gives the same tokens
    # (tests/test_torch_telemetry.py holds its accounting)
    tracer = Tracer()
    traced = SplitEngine(cfg, params, OPSCConfig(split_layer=1), opts=OPTS,
                         cache_len=16, device="cpu", telemetry=tracer)
    np.testing.assert_array_equal(traced.generate(p, 4)[0],
                                  eng.generate(p, 4)[0])
    assert {"split:edge", "split:cloud"} <= {sp.track for sp in tracer.spans}


# ------------------------------------------------------- the request API


def test_split_backend_reproduces_split_engine(tiny_model):
    """``SamplingParams()`` defaults through ``LLMServer(backend="split")``
    give the ``SplitEngine`` greedy run bit for bit (the reference's
    ``test_default_params_reproduce_greedy_on_all_backends``), and the
    output carries the call's ``SplitStats``."""
    cfg, jparams, params = tiny_model
    p = np.random.default_rng(0).integers(0, cfg.vocab_size, (6,))
    opsc = OPSCConfig(split_layer=1, qw_front=16, i_kv=1)
    want, _ = JaxSplitEngine(jax_config("llama2-7b-tiny"), jparams,
                             JOPSC(split_layer=1, qw_front=16, i_kv=1),
                             opts=JOPTS, cache_len=32).generate(
        p[None], 5, compress=False)
    srv = LLMServer(cfg, params, OPTS, backend="split", opsc=opsc,
                    compress=False, cache_len=32, device="cpu")
    rid = srv.submit(p, SamplingParams(max_tokens=5))
    out = srv.run()[rid]
    np.testing.assert_array_equal(out.full_tokens, want[0])
    assert out.finish_reason == "length"
    assert out.split_stats is not None
    assert out.split_stats.uplink_bits_eq3 > 0


def test_split_backend_stop_deadline_abort_release(tiny_model):
    cfg, _, params = tiny_model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (6, 5, 7)]

    def server(**kw):
        return LLMServer(cfg, params, OPTS_Q, backend="split",
                         opsc=OPSCConfig(split_layer=1), cache_len=32,
                         device="cpu", **kw)

    srv = server()
    rids = [srv.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
    base = srv.run()
    stop = int(base[rids[0]].tokens[2])
    srv = server()
    r_stop = srv.submit(prompts[0], SamplingParams(max_tokens=6,
                                                   stop_token_ids=(stop,)))
    r_abort = srv.submit(prompts[1], SamplingParams(max_tokens=6))
    r_keep = srv.submit(prompts[2], SamplingParams(max_tokens=6))
    assert srv.abort(r_abort)  # queued: never computes
    events = list(srv.stream())
    outs = srv.outputs()
    cut = list(base[rids[0]].tokens).index(stop) + 1
    assert outs[r_stop].finish_reason == "stop"
    np.testing.assert_array_equal(outs[r_stop].tokens,
                                  base[rids[0]].tokens[:cut])
    assert outs[r_abort].finish_reason == "abort"
    assert len(outs[r_abort].tokens) == 0
    np.testing.assert_array_equal(outs[r_keep].tokens, base[rids[2]].tokens)
    for rid in (r_stop, r_keep):  # events in position order, logprobs set
        idx = [e.index for e in events if e.rid == rid and not e.finished]
        assert idx == list(range(len(outs[rid].tokens)))
        assert all(e.logprob is not None for e in events
                   if e.rid == rid and not e.finished)
    assert srv.release(r_keep) and r_keep not in srv.outputs()

    # the deadline ladder cuts a generation short: reason "deadline"
    srv = server(deadline_s=1e-7, compute_per_layer_s=1e-3)
    rid = srv.submit(prompts[0], SamplingParams(max_tokens=6))
    out = srv.run()[rid]
    assert out.finish_reason == "deadline" and len(out.tokens) < 6
    assert out.split_stats.early_exits == 1
    with pytest.raises(ValueError, match="opsc"):
        LLMServer(cfg, params, OPTS, backend="split", device="cpu")
    # a speculative request (ported): the per-token request's tokens, and
    # its SplitStats count the verify rounds
    srv = server()
    rid = srv.submit(prompts[0], SamplingParams(max_tokens=3, speculate_k=2))
    out = srv.run()[rid]
    np.testing.assert_array_equal(out.tokens, base[rids[0]].tokens[:3])
    assert out.split_stats.spec_rounds > 0
