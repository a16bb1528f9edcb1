"""The mixture-of-experts layer and QK-norm in the port against the JAX
package on bridged weights: ``moe_layer`` on tests/test_numerics.py's grid
and on the two tiny MoE configs (capacity factors, token groups, the
router's renormalisation, a shared expert, drops, a built tie, bf16), the
split edge's expert slices of one code matrix, QK-norm attention,
teacher-forced logits of qwen2-moe-a2.7b and qwen3-moe-235b-a22b tiny,
the fused, chunked, packed and split paths' streams and counts, the
full-width parameter counts, and the refusals that stay."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import MoESpec as JMoESpec
from repro.core.opsc import OPSCConfig as JOPSC
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.split_engine import SplitEngine as JaxSplitEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import MoESpec, SSMSpec
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.sampling import SamplingParams
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax_params, init_params, param_specs
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import (SplitEngine,
                                              quantize_front_blocks)

torch.set_num_threads(2)

# f32 logits across frameworks (tests/test_torch_model.py's tolerance)
REL = 1e-4
# the MoE output of O(1) inputs in f32: the expert products sum in another
# order than the reference's buffer einsum
Y_ATOL = 1e-5
AUX_ATOL = 1e-6
# bf16 outputs, relative to the largest: XLA's bf16 SiLU rounds otherwise
# than PyTorch's (outputs one bf16 step apart, where REL would ask for bit
# equality), and a step is 2^-8 of a value: two steps at the largest
BF16_REL = 1e-2
MOE = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
STAT_FIELDS = ("tokens_generated", "uplink_bits_measured", "uplink_bits_eq3",
               "latency_s", "early_exits", "kv_dropped_steps",
               "uplink_bits_paged", "cloud_pool_bytes_peak",
               "shared_prefix_pages", "uplink_round_trips")
# tests/test_scheduler.py:34's jobs, (prompt length, max new tokens)
JOBS = [(5, 6), (8, 3), (3, 9), (6, 4), (2, 7)]
LP_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _nest(flat):
    """The port's flat ``{a/b: t}`` dict as nested dicts."""
    out: dict = {}
    for key, t in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


_MODELS: dict = {}


def _model(name, dtype="float32"):
    """(reference config, reference params, port config, port params) of
    a tiny config, ``init_params(cfg, PRNGKey(0))`` carried across."""
    if (name, dtype) not in _MODELS:
        cj, ct = jax_config(name).tiny(), get_config(name).tiny()
        pj = JT.init_params(cj, jax.random.PRNGKey(0), getattr(jnp, dtype))
        _MODELS[name, dtype] = (cj, pj, ct, from_jax_params(
            jax.tree.map(np.asarray, pj)))
    return _MODELS[name, dtype]


def _block_ffn(name, dtype="float32"):
    """Block 0's ffn params of a tiny config: (reference dict, port nested
    dict, port spec)."""
    cj, pj, ct, pt = _model(name, dtype)
    jp = jax.tree.map(lambda a: a[0], pj["blocks"]["p0"]["ffn"])
    tp = _nest({k[len("blocks/p0/ffn/"):]: v[0] for k, v in pt.items()
                if k.startswith("blocks/p0/ffn/")})
    return jp, tp, ct.pattern[0].ffn


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ moe_layer


def _grid_params(shared, renormalize):
    spec = dict(num_experts=4, top_k=2, d_ff=16, renormalize=renormalize,
                num_shared=shared)
    jp = JM.init_moe_params(jax.random.PRNGKey(0), 32, JMoESpec(**spec))
    return jp, _nest(from_jax_params(jax.tree.map(np.asarray, jp))), \
        JMoESpec(**spec), MoESpec(**spec)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("renormalize", [True, False],
                         ids=["renorm", "raw"])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [0.0, 0.5, 1.25])
def test_moe_layer_matches_reference_on_the_capacity_grid(cf, groups,
                                                          renormalize,
                                                          shared):
    """tests/test_numerics.py's MoE (4 experts, top-2, D 32, d_ff 16) on
    x (4, 8, 32): y within 1e-5 and the auxiliary loss within 1e-6 of the
    reference's at every capacity factor and group count; dropless calls
    drop nothing and cf 0.5 drops pairs (T·k/E·cf = 4 rows an expert of
    16 wanted on average)."""
    jp, tp, js, ts = _grid_params(shared, renormalize)
    x = np.random.default_rng(1).normal(size=(4, 8, 32)).astype(np.float32)
    yj, aj = JM.moe_layer(jp, jnp.asarray(x), js, cf, groups)
    TM.reset_stats()
    yt, at = TM.moe_layer(tp, torch.as_tensor(x), ts, cf, groups)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=Y_ATOL)
    assert abs(float(at) - float(aj)) <= AUX_ATOL
    assert TM.STATS["calls"] == TM.STATS["host_syncs"] == 1
    assert TM.STATS["pairs"] == 4 * 8 * 2
    if cf == 0:
        assert TM.STATS["dropped"] == 0
    if cf == 0.5:
        assert TM.STATS["dropped"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,groups", [(0.0, 1), (0.5, 1), (1.25, 1),
                                       (1.25, 4)])
@pytest.mark.parametrize("name", MOE)
def test_moe_layer_matches_reference_on_the_tiny_configs(name, cf, groups,
                                                         dtype):
    """Block 0's ffn of each tiny config (qwen2-moe: 4 experts top-2 and a
    shared expert, not renormalised; qwen3-moe: top-2 renormalised, no
    shared expert) on x (2, 24, 128): f32 within 1e-5, bf16 within
    BF16_REL of the largest output; the loss within 1e-6."""
    jp, tp, spec = _block_ffn(name, dtype)
    x = np.random.default_rng(5).normal(size=(2, 24, 128)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    yj, aj = JM.moe_layer(jp, xj, spec, cf, groups)
    TM.reset_stats()
    yt, at = TM.moe_layer(tp, _t(np.asarray(xj)), spec, cf, groups)
    assert yt.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=Y_ATOL)
    else:
        assert _rel(yt.float().numpy(), np.asarray(yj, np.float32)) \
            <= BF16_REL
    assert abs(float(at) - float(aj)) <= AUX_ATOL
    if cf == 0:
        assert TM.STATS["dropped"] == 0
    if cf == 0.5:  # cap 6 (12 a group of 48): a quarter of the 24 wanted
        assert TM.STATS["dropped"] > 0


def test_top_k_breaks_ties_toward_the_lower_index():
    """A router whose experts 1 and 2 have equal columns gives every token
    equal probabilities for them: ``top_k`` puts expert 1 first, as
    ``jax.lax.top_k`` does, and the layer, with pairs dropped by the
    capacity rule, equals the reference's."""
    jp, tp, js, ts = _grid_params(0, True)
    w = np.asarray(jp["w_router"]).copy()
    w[:, 2] = w[:, 1]
    jp = dict(jp, w_router=jnp.asarray(w))
    tp = dict(tp, w_router=torch.as_tensor(w))
    x = np.random.default_rng(3).normal(size=(2, 8, 32)).astype(np.float32)
    probs = torch.softmax(torch.as_tensor(x).reshape(16, 32) @ tp["w_router"],
                          -1)
    assert bool((probs[:, 1] == probs[:, 2]).all())
    vals, idx = TM.top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    idx = idx.numpy()
    both = (idx == 1).any(-1) & (idx == 2).any(-1)
    assert np.all(idx[both] == [1, 2])  # the tie at the top, in index order
    only = (idx == 1).any(-1) & ~both  # the tie across the cut: 1 is kept
    assert both.any() and only.any() and not ((idx == 2).any(-1)
                                              & ~both).any()
    yj, aj = JM.moe_layer(jp, jnp.asarray(x), js, 1.25, 1)
    TM.reset_stats()
    yt, at = TM.moe_layer(tp, torch.as_tensor(x), ts, 1.25, 1)
    assert TM.STATS["dropped"] > 0  # cap int(16·2/4·1.25) = 10
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=Y_ATOL)
    assert abs(float(at) - float(aj)) <= AUX_ATOL


def test_capacity_rule_and_group_fallback():
    """``cap``: all of a group when cf <= 0, else max(1, int(T·k/E·cf))
    truncated; a group count that does not divide T falls back to one
    group (the same output as groups = 1)."""
    spec = MoESpec(num_experts=60, top_k=4, d_ff=8)
    assert TM.capacity(128, spec, 1.25) == 10  # qwen2-moe's 128-token prefill
    assert TM.capacity(128, spec, 0.0) == 128
    assert TM.capacity(1, spec, 1.25) == 1  # int(0.083) = 0 → 1
    jp, tp, js, ts = _grid_params(1, False)
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, 10, 32)).astype(np.float32))
    y3, a3 = TM.moe_layer(tp, x, ts, 0.5, 3)  # 3 does not divide 10
    y1, a1 = TM.moe_layer(tp, x, ts, 0.5, 1)
    assert torch.equal(y3, y1) and torch.equal(a3, a1)


def test_expert_slices_of_the_edge_codes_match_the_dequantized_weights():
    """The split edge's expert weight, (E·D, F) int8 codes with one scale
    row shared by the experts: ``expert_weight`` gives expert i's rows as
    a view (no copy), and ``moe_layer`` over the codes equals it over the
    dequantized weights (K7's plain version on the CPU)."""
    _, _, ct, pt = _model("qwen2-moe-a2.7b")
    block = quantize_front_blocks({k: v for k, v in pt.items()
                                   if k.startswith("blocks/")}, 8)
    qt = block["blocks/p0/ffn/w_up"][0]
    e, d, f = pt["blocks/p0/ffn/w_up"].shape[1:]
    assert qt.codes.shape == (e * d, f) and qt.scale.shape == (1, f)
    for i in range(e):
        w = TM.expert_weight(qt, i, e)
        assert w.codes.data_ptr() == qt.codes.data_ptr() + i * d * f
        assert w.codes.is_contiguous() and w.scale is qt.scale
    prefix = "blocks/p0/ffn/"
    flat = {k[len(prefix):]: v[0] for k, v in block.items()
            if k.startswith(prefix)}
    tq = _nest(flat)
    deq = _nest({k: v.dequantize() for k, v in flat.items()})
    deq["w_gate"] = deq["w_gate"].reshape(e, d, f)
    deq["w_up"] = deq["w_up"].reshape(e, d, f)
    deq["w_down"] = deq["w_down"].reshape(e, f, d)
    x = torch.as_tensor(np.random.default_rng(4).normal(
        size=(2, 6, d)).astype(np.float32))
    spec = ct.pattern[0].ffn
    yq, _ = TM.moe_layer(tq, x, spec, 0.0)
    yd, _ = TM.moe_layer(deq, x, spec, 0.0)
    np.testing.assert_allclose(yq.numpy(), yd.numpy(), rtol=0, atol=1e-5)


def test_moe_layer_ep_names_the_sharded_deployment():
    """``moe_layer_ep`` runs on the ranks of a training mesh
    (``tests/test_torch_sharded_train.py``); without a process group it
    raises, naming the call that starts one."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        TM.moe_layer_ep({}, torch.zeros(1, 1, 4), None, ("data",))


# ------------------------------------------------------------- QK-norm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_norm_attention_matches_reference(dtype):
    """qwen3-moe tiny's attention layer (block 0, its q_norm and k_norm
    drawn away from ones) over 24 fresh tokens with RoPE: the norms apply
    per head after the projections and before RoPE, as the reference's."""
    cj, pj, ct, pt = _model("qwen3-moe-235b-a22b", dtype)
    rng = np.random.default_rng(6)
    hd = ct.pattern[0].mixer.head_dim
    jp = jax.tree.map(lambda a: a[0], pj["blocks"]["p0"]["mixer"])
    jp = dict(jp, q_norm=jnp.asarray(rng.uniform(0.5, 1.5, hd),
                                     jp["q_norm"].dtype),
              k_norm=jnp.asarray(rng.uniform(0.5, 1.5, hd),
                                 jp["k_norm"].dtype))
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    x = rng.normal(size=(2, 24, ct.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    pos = np.tile(np.arange(24, dtype=np.int32), (2, 1))
    spec = ct.pattern[0].mixer
    want, _ = JL.attention_layer(jp, xj, spec,
                                 rope_cs=JT.rope_tables(cj, jnp.asarray(pos)),
                                 cache=None, pos=0,
                                 q_positions=jnp.asarray(pos), q_chunk=16,
                                 kv_chunk=16)
    got, _ = TL.attention_layer(tp, _t(np.asarray(xj)), spec,
                                rope_cs=TT.rope_tables(ct, torch.as_tensor(
                                    pos)),
                                cache=None, pos=0,
                                q_positions=torch.as_tensor(pos), q_chunk=16,
                                kv_chunk=16)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol


# ---------------------------------------------------------------- model


def _bridge_caches(jcaches, cfg):
    """The reference's caches (a tuple over pattern positions, leaves
    stacked over blocks) as the port's per-layer list, bit for bit."""
    out = []
    for blk in range(cfg.num_blocks):
        for pi in range(len(cfg.pattern)):
            c = jcaches[pi]
            leaf = lambda a: None if a is None else _t(np.asarray(a)[blk])  # noqa: E731
            out.append(TL.KVCache(leaf(c.k), leaf(c.v), leaf(c.k_scale),
                                  leaf(c.v_scale), leaf(c.pos)))
    return out


@pytest.mark.parametrize("quantized", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("name", MOE)
def test_teacher_forced_logits_match_reference(name, quantized):
    """A 24-token prefill at B 2 and 8 decode steps fed the same tokens,
    at the reference's default capacity factor (1.25: the 48-token prefill
    drops pairs, a decode step of 2 tokens keeps cap 1): the logits agree
    within REL at every step. With the int8 cache each step starts from
    the reference's caches carried across (tests/test_torch_families.py
    says why)."""
    cj, pj, ct, pt = _model(name)
    toks = np.random.default_rng(0).integers(0, cj.vocab_size,
                                             (2, 32)).astype(np.int32)
    kw = dict(q_chunk=16, kv_chunk=16, quantized_kv=quantized,
              cache_dtype="bfloat16" if quantized else "float32")
    oj, ot = JT.RuntimeOpts(**kw), TT.RuntimeOpts(**kw)
    lj, cjs = JT.prefill(pj, cj, jnp.asarray(toks[:, :24]), None, 32, oj)
    TM.reset_stats()
    lt, cts = TT.prefill(pt, ct, torch.as_tensor(toks[:, :24]), 32, ot)
    assert TM.STATS["dropped"] > 0
    assert _rel(lt.numpy(), lj) <= REL
    for p in range(24, 32):
        if quantized:
            cts = _bridge_caches(cjs, ct)
        lj, cjs = JT.decode_step(pj, cj, jnp.asarray(toks[:, p:p + 1]), cjs,
                                 jnp.int32(p), oj)
        lt, cts = TT.decode_step(pt, ct, torch.as_tensor(toks[:, p:p + 1]),
                                 cts, torch.tensor(p, dtype=torch.int32), ot)
        assert _rel(lt.numpy(), lj) <= REL, p


def _reference_greedy(cj, pj, prompts, n, cache_len):
    """The reference's greedy stream (B, n), dropless, and each step's
    top-1/top-2 margin relative to its largest logit."""
    oj = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                        moe_capacity_factor=0.0)
    logits, caches = JT.prefill(pj, cj, jnp.asarray(prompts), None,
                                cache_len, oj)
    toks, margins = [], []
    for t in range(n):
        lg = np.asarray(logits)
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append((top2[:, 1] - top2[:, 0]) / np.abs(lg).max())
        nxt = lg.argmax(-1).astype(np.int32)
        toks.append(nxt)
        logits, caches = JT.decode_step(pj, cj, jnp.asarray(nxt[:, None]),
                                        caches,
                                        jnp.int32(prompts.shape[1] + t), oj)
    return np.stack(toks, 1), np.stack(margins, 1)


def _assert_margin_rule(got, want, margins):
    """Tokens equal up to and including the first step whose margin is
    within REL (a tie the two frameworks may break apart)."""
    for r in range(want.shape[0]):
        close = np.nonzero(margins[r] <= REL)[0]
        upto = close[0] + 1 if close.size else want.shape[1]
        np.testing.assert_array_equal(got[r, :upto], want[r, :upto])


OPTS_Q = TT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                        moe_capacity_factor=0.0)
JOPTS_Q = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                         quantized_kv=True, moe_capacity_factor=0.0)


@pytest.mark.parametrize("name", MOE)
def test_engine_and_fused_server_streams_match_reference(name):
    """Dropless greedy streams (int8 KV, 12-token prompts, 10 new tokens)
    from the port's ``Engine`` and ``LLMServer(backend="fused")`` against
    the reference's, under the margin rule; the server's equal the
    Engine's."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(9).integers(0, ct.vocab_size, (3, 12))
    n, cache_len = 10, 32
    want, margins = _reference_greedy(cj, pj, prompts, n, cache_len)
    got = Engine(ct, pt, OPTS_Q, cache_len=cache_len,
                 device="cpu").generate(prompts, n).tokens[:, 12:]
    _assert_margin_rule(got, want, margins)
    srv = LLMServer(ct, pt, OPTS_Q, backend="fused", cache_len=cache_len,
                    device="cpu")
    rids = [srv.submit(p, SamplingParams(max_tokens=n)) for p in prompts]
    outs = srv.run()
    np.testing.assert_array_equal(np.stack([outs[r].tokens for r in rids]),
                                  got)


@pytest.mark.parametrize("tick_mode", ["chunked", "packed"])
@pytest.mark.parametrize("name", MOE)
def test_schedulers_match_engine_and_reference_scheduler(name, tick_mode):
    """tests/test_scheduler.py:34's five jobs through three slots of one
    pool (mid-stream admission): the port's streams equal its own
    ``Engine``'s and the reference ``Scheduler``'s, logprobs within 1e-4,
    the same ticks, and every page comes back. (A chunk budget below a
    prompt attends the earlier chunks' int8 codes, where the Engine's
    prefill attends fresh keys: both frameworks' streams then leave the
    Engine's on qwen3-moe tiny.)"""
    cj, pj, ct, pt = _model(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, ct.vocab_size, (n,)) for n, _ in JOBS]
    kw = dict(num_pages=24, page_size=4, max_slots=3, tick_mode=tick_mode)
    runs = []
    for sched in (JaxScheduler(cj, pj, JOPTS_Q, **kw),
                  Scheduler(ct, pt, OPTS_Q, device="cpu", **kw)):
        rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, JOBS)]
        results = sched.run()
        events = sorted((e[0], e[1], e[2], e[3])
                        for e in sched.drain_events())
        runs.append(([results[r] for r in rids], events, sched))
    (want, want_ev, jsched), (got, got_ev, sched) = runs
    eng = Engine(ct, pt, OPTS_Q, cache_len=32, device="cpu")
    for g, w, p, (_, mn) in zip(got, want, prompts, JOBS):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, eng.generate(p[None], mn).tokens[0])
    assert [e[:3] for e in got_ev] == [e[:3] for e in want_ev]
    np.testing.assert_allclose([e[3] for e in got_ev],
                               [e[3] for e in want_ev], **LP_TOL)
    assert sched.stats.steps == jsched.stats.steps
    assert sched.stats.admitted == sched.stats.evicted == 5
    assert sched.pool.pages_in_use == 0


@pytest.mark.parametrize("dropless", [False, True],
                         ids=["cf1.25", "dropless"])
@pytest.mark.parametrize("qw_front", [4, 8])
def test_split_engine_matches_reference(qw_front, dropless):
    """qwen2-moe tiny split at layer 1 (block 0's router, experts and
    shared expert as int8 codes on the edge, TS + TAB-Q uplink, int8 KV):
    the tokens and every ``SplitStats`` count equal the reference's, with
    the split engine's default capacity factor (pairs dropped at prefill)
    and dropless; the edge bytes count the expert codes and the router."""
    cj, pj, ct, pt = _model("qwen2-moe-a2.7b")
    prompts = np.random.default_rng(2).integers(0, ct.vocab_size, (2, 20))
    n = 6
    cf = 0.0 if dropless else 1.25
    jopts = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                           moe_capacity_factor=cf, quantized_kv=True)
    opts = TT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                          moe_capacity_factor=cf)
    want = JaxSplitEngine(cj, pj, JOPSC(split_layer=1, qw_front=qw_front),
                          opts=jopts, cache_len=48).generate(prompts, n)
    TM.reset_stats()
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=1, qw_front=qw_front),
                      opts=opts, cache_len=48, device="cpu")
    got = eng.generate(prompts, n)
    np.testing.assert_array_equal(got[0], want[0])
    for f in STAT_FIELDS:
        assert getattr(got[1], f) == getattr(want[1], f), f
    assert (TM.STATS["dropped"] > 0) == (not dropless)
    f = ct.pattern[0].ffn
    d = ct.d_model
    codes = d * f.num_experts * (1 + 3 * f.d_ff) + 3 * d * f.num_shared * f.d_ff
    m = ct.pattern[0].mixer
    codes += 2 * d * m.num_heads * m.head_dim \
        + 2 * d * m.num_kv_heads * m.head_dim
    scales = 4 * (f.num_experts + 2 * f.d_ff + d  # router, experts
                  + 2 * f.num_shared * f.d_ff + d  # shared expert
                  + m.num_heads * m.head_dim + 2 * m.num_kv_heads
                  * m.head_dim + d)  # attention
    assert eng.edge_weight_bytes() == codes + scales + 2 * 4 * d


# ------------------------------------------------------ sizes, refusals


@pytest.mark.parametrize("name,lo,hi", [
    ("qwen2-moe-a2.7b", 1.1e10, 1.6e10),
    ("qwen3-moe-235b-a22b", 2.0e11, 2.6e11)])
def test_full_width_parameter_counts(name, lo, hi):
    """``param_specs`` at full width, shapes only (nothing allocated): the
    config's own count and the reference's, within
    tests/test_arch_smoke.py's range; the reference's keys and shapes (its
    ``abstract_params``), the router f32."""
    cfg = get_config(name)
    specs = param_specs(cfg)
    n = sum(int(np.prod(shape)) for shape, _ in specs.values())
    assert n == cfg.total_params() == jax_config(name).total_params()
    assert lo <= n <= hi
    want = jax.tree_util.tree_flatten_with_path(
        JT.abstract_params(jax_config(name)))[0]
    want = {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in want}
    assert {k: tuple(s) for k, (s, _) in specs.items()} == want
    assert ("lm_head" in specs) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("name", MOE)
def test_init_params_keeps_the_router_f32_and_draws_each_expert(name):
    """bf16 ``init_params``: the reference's keys, shapes and dtypes (the
    router f32), q_norm and k_norm ones, and each expert's matrix drawn at
    its own scale."""
    cj, _, ct, _ = _model(name, "bfloat16")
    params = init_params(ct, torch.Generator().manual_seed(0),
                         torch.bfloat16)
    ref = from_jax_params(jax.tree.map(np.asarray, JT.init_params(
        cj, jax.random.PRNGKey(0), jnp.bfloat16)))
    assert {k: (v.shape, v.dtype) for k, v in params.items()} == \
        {k: (v.shape, v.dtype) for k, v in ref.items()}
    assert params["blocks/p0/ffn/w_router"].dtype == torch.float32
    for key, (_, scale) in param_specs(ct).items():
        t = params[key].float()
        if scale is None:
            assert bool((t == 1).all()), key
        elif t.dim() == 4:
            std = t.flatten(2).std(-1)
            assert float((std / scale - 1).abs().max()) < 0.1, key


def test_refusals_that_stay_name_item_9():
    """A state-space mixer is now ported: an SSM spec in place of the
    attention (built here from a MoE config) gets the Mamba-2 mixer's
    leaves from ``param_specs`` and a (conv state, SSM state) pair from
    ``init_caches``. M-RoPE and the codebook embedding, the rest of
    ROADMAP queue 1 item 9, are ported now (built as specs here from the
    MoE config): M-RoPE adds no leaf, and four codebooks give a (4, V, D)
    embedding and an untied (D, 4·V) head."""
    cfg = get_config("qwen2-moe-a2.7b").tiny()
    ssm = dataclasses.replace(cfg, pattern=(dataclasses.replace(
        cfg.pattern[0], mixer=SSMSpec(d_inner=256, d_state=16,
                                      head_dim=32)),))
    specs = param_specs(ssm)
    for leaf in ("w_z", "w_x", "w_B", "w_C", "w_dt", "dt_bias", "A_log", "D",
                 "conv_w", "conv_b", "norm", "w_out"):
        assert f"blocks/p0/mixer/{leaf}" in specs, leaf
    assert "blocks/p0/mixer/wq" not in specs
    caches = TT.init_caches(ssm, 1, 8, OPTS_Q)
    assert len(caches) == ssm.num_layers
    conv, state = caches[0]
    assert conv.shape == (1, 3, 256 + 2 * 16)
    assert state.shape == (1, 8, 32, 16) and state.dtype == torch.float32
    base = param_specs(cfg)
    assert param_specs(dataclasses.replace(
        cfg, rope="mrope", mrope_sections=(4, 6, 6))) == base
    codebooks = param_specs(dataclasses.replace(cfg, embed="musicgen",
                                                num_codebooks=4))
    d, v = cfg.d_model, cfg.vocab_size
    assert codebooks["embed"] == ((4, v, d), 0.02)
    assert codebooks["lm_head"] == ((d, 4 * v), 0.02)
    assert {k: x for k, x in codebooks.items()
            if k not in ("embed", "lm_head")} == {
        k: x for k, x in base.items() if k not in ("embed", "lm_head")}