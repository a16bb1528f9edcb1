"""The sliding-window families (gemma2-2b, h2o-danube-3-4b) in the port
against the JAX package on bridged tiny weights: the ring write bit for
bit, the slot contract K1 reads by (a property over windows, padded slot
counts and write sequences), windowed and soft-capped attention, the
int8 decode over a wrapped ring at head dims 32 and 120 against the
Pallas kernel in interpret mode, teacher-forced logits past the window,
the fused and split backends' tokens and ``SplitStats``, the full-width
parameter counts, and the refusals that stay (the paged pool, the packed
tick; ``qk_norm`` is ported now)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as jax_config
from repro.core.opsc import OPSCConfig as JOPSC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.split_engine import SplitEngine as JaxSplitEngine
from repro_torch.configs import get_config
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.sampling import SamplingParams
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import padded_cache_len
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax_params, param_specs
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.split_engine import SplitEngine

torch.set_num_threads(2)

# f32 logits across frameworks (tests/test_torch_model.py's tolerance)
REL = 1e-4
# attention outputs of O(1) across frameworks: f32 sums in another order
ATT = dict(rtol=1e-5, atol=1e-5)
WINDOW = 16  # the tiny configs' window
FAMILIES = ["gemma2-2b", "h2o-danube-3-4b"]
STAT_FIELDS = ("tokens_generated", "uplink_bits_measured", "uplink_bits_eq3",
               "latency_s", "early_exits", "kv_dropped_steps",
               "uplink_bits_paged", "cloud_pool_bytes_peak",
               "shared_prefix_pages", "uplink_round_trips")


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _hd(cfg, hd):
    """``cfg`` with every attention layer at head dim ``hd``."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(ls, mixer=dataclasses.replace(ls.mixer,
                                                          head_dim=hd))
        for ls in cfg.pattern))


def _variant(name):
    """(reference config, port config) of a tiny variant: ``<family>``,
    ``<family>@120`` (head dim 120) or ``<family>x2`` (two blocks)."""
    base = name.removesuffix("@120").removesuffix("x2")
    cj, ct = jax_config(base).tiny(), get_config(base).tiny()
    if name.endswith("@120"):
        cj, ct = _hd(cj, 120), _hd(ct, 120)
    if name.endswith("x2"):
        cj = dataclasses.replace(cj, num_blocks=2)
        ct = dataclasses.replace(ct, num_blocks=2)
    return cj, ct


_MODELS: dict = {}


def _model(name):
    """(reference config, reference params, port config, port params),
    from ``init_params(cfg, PRNGKey(0))`` carried across the bridge."""
    if name not in _MODELS:
        cj, ct = _variant(name)
        pj = JT.init_params(cj, jax.random.PRNGKey(0))
        _MODELS[name] = (cj, pj, ct,
                         from_jax_params(jax.tree.map(np.asarray, pj)))
    return _MODELS[name]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


# ------------------------------------------------------------- the ring


def _caches(b, kh, hd, slots, quantized):
    jc = JL.init_cache(b, slots, kh, hd, dtype=jnp.bfloat16,
                       quantized=quantized)
    tc = TL.init_cache(b, slots, kh, hd, dtype=torch.bfloat16,
                       quantized=quantized)
    return jc, tc


def _assert_cache_equal(tc, jc):
    for f in ("k", "v", "k_scale", "v_scale", "pos"):
        want = getattr(jc, f)
        if want is None:
            assert getattr(tc, f) is None
        else:
            assert torch.equal(getattr(tc, f), _t(want)), f


# (slots, writes): the block-padded ring of tests/test_decode_path.py (24
# slots, window 16, 40 single writes); a prefill shorter than the ring then
# decode writes past it; a prefill longer than the ring then decode writes
RING_CASES = {
    "padded_40_writes": (24, [1] * 40),
    "short_prefill": (16, [10] + [1] * 20),
    "long_prefill": (16, [40] + [1] * 5),
    "padded_long_prefill": (24, [37, 1, 1, 3]),
}


@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_cache_update_matches_reference(case, quantized):
    """``cache_update(window=16)`` writes the reference's ring bit for bit
    after every write (codes, scales, positions; bf16 values): slot
    ``p % 16``, only the last 16 tokens of a longer write, pad slots past
    the window at -1, in both layouts."""
    slots, writes = RING_CASES[case]
    b, kh, hd = 2, 2, 8
    jc, tc = _caches(b, kh, hd, slots, quantized)
    rng = np.random.default_rng(slots + len(writes))
    pos = 0
    for n in writes:
        k = rng.normal(size=(b, n, kh, hd)).astype(np.float32)
        v = rng.normal(size=(b, n, kh, hd)).astype(np.float32)
        jc = JL.cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(pos), window=WINDOW)
        tc = TL.cache_update(tc, _t(k), _t(v),
                             torch.tensor(pos, dtype=torch.int32),
                             window=WINDOW)
        pos += n
        _assert_cache_equal(tc, jc)
    stored = tc.pos[0].numpy()
    assert np.all(stored[WINDOW:] == -1)
    assert sorted(stored[:WINDOW]) == list(range(pos - WINDOW, pos))


@settings(max_examples=15, deadline=None)
@given(window=st.integers(1, 20), pad=st.integers(0, 9),
       writes=st.lists(st.integers(1, 30), min_size=1, max_size=6),
       keys=st.sampled_from([4, 8, 256]))
def test_ring_keeps_the_slot_contract(window, pad, writes, keys):
    """After any write sequence into a ring of ``min(window, S)`` slots
    with ``pad`` slots of block padding, the positions equal the
    reference's, every valid slot lies in ``0 .. min(q_pos, S - 1)`` (q_pos
    the last position written, K1's causal bound), K1's units
    (``unit_slots``) cover every valid slot, and the ring holds exactly
    the positions ``(q_pos - W, q_pos]`` that exist: K1's position mask is
    the window's."""
    s = window + pad
    jc, tc = _caches(1, 1, 4, s, True)
    rng = np.random.default_rng(window * 31 + pad)
    pos = 0
    for n in writes:
        kv = rng.normal(size=(1, n, 1, 4)).astype(np.float32)
        jc = JL.cache_update(jc, jnp.asarray(kv), jnp.asarray(kv),
                             jnp.int32(pos), window=window)
        tc = TL.cache_update(tc, _t(kv), _t(kv), pos, window=window)
        pos += n
    q_pos = pos - 1
    stored = tc.pos[0].numpy()
    np.testing.assert_array_equal(stored, np.asarray(jc.pos[0]))
    valid = np.nonzero(stored >= 0)[0]
    assert valid.max() <= min(q_pos, s - 1)
    units = da.grid(1, 1, 1, s, keys)[2]
    walked = {t for u in range(units) for t in da.unit_slots(q_pos, u, keys,
                                                             s)}
    assert set(valid) <= walked
    w = min(window, s)
    assert sorted(stored[valid]) == list(range(max(0, q_pos - w + 1),
                                               q_pos + 1))


# ------------------------------------------------------------ attention


@pytest.mark.parametrize("qc,kc", [(4, 4), (8, 16), (16, 8), (64, 64)])
@pytest.mark.parametrize("window,softcap", [(None, None), (7, None),
                                            (None, 30.0), (5, 20.0)])
def test_chunked_attention_with_window_and_soft_cap_matches_reference(
        qc, kc, window, softcap):
    """``chunked_attention(window=, softcap=)`` on tests/test_numerics.py's
    grid: the soft cap on the scaled score before the mask, the window
    keeping ``kv_pos > q_pos - window``; GQA 4 on 2."""
    rng = np.random.default_rng(qc * 100 + kc)
    b, s, h, kh, hd = 2, 24, 4, 2, 16
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                window=window, softcap=softcap, q_chunk=qc,
                                kv_chunk=kc)
    got = TL.chunked_attention(*map(_t, (q, k, v, pos, pos)), window=window,
                               softcap=softcap, q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT)


def _wrapped_ring(hd, kh, slots, steps, seed):
    """A quantized ring of WINDOW slots (``slots`` with padding) written by
    a 20-token prefill and ``steps`` single writes, in both frameworks."""
    jc, tc = _caches(2, kh, hd, slots, True)
    rng = np.random.default_rng(seed)
    pos = 0
    for n in [20] + [1] * steps:
        k = rng.normal(size=(2, n, kh, hd)).astype(np.float32)
        v = rng.normal(size=(2, n, kh, hd)).astype(np.float32)
        jc = JL.cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(pos), window=WINDOW)
        TL.cache_update(tc, _t(k), _t(v), pos, window=WINDOW)
        pos += n
    return jc, tc, pos - 1


@pytest.mark.parametrize("hd", [32, 120])
@pytest.mark.parametrize("g", [1, 4])
def test_quantized_decode_over_a_wrapped_ring_matches_pallas_kernel(hd, g):
    """A single-token query over a ring that has wrapped (16 ring slots of
    24, block padding at -1) takes K1's route (``ops.decode_attention``,
    its plain version on the CPU) and agrees with the reference's, whose
    Pallas K1 runs in interpret mode, at head dims 32 and 120 and groups
    1 and 4."""
    kh = 2
    jc, tc, q_pos = _wrapped_ring(hd, kh, 24, 7, seed=hd + g)
    spec = get_config("h2o-danube-3-4b").tiny().pattern[0].mixer
    spec = dataclasses.replace(spec, num_heads=kh * g, num_kv_heads=kh,
                               head_dim=hd)
    q = np.random.default_rng(g).normal(size=(2, 1, kh * g, hd)).astype(
        np.float32)
    want = JL.quantized_decode_attention(jnp.asarray(q), jc, spec, None,
                                         jnp.int32(q_pos))
    calls = []
    real = ops.decode_attention

    def counted(*args):
        calls.append(1)
        return real(*args)

    ops.decode_attention = counted
    try:
        got = TL.quantized_decode_attention(
            _t(q), tc, spec, None, torch.tensor(q_pos, dtype=torch.int32))
    finally:
        ops.decode_attention = real
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_soft_capped_decode_takes_the_plain_route():
    """A soft-capped windowed layer (gemma2's local one) dequantizes its
    wrapped ring into ``chunked_attention`` with its window and cap, as the
    reference does, and never calls K1."""
    jc, tc, q_pos = _wrapped_ring(32, 2, 24, 5, seed=3)
    spec = get_config("gemma2-2b").tiny().pattern[0].mixer
    spec = dataclasses.replace(spec, num_heads=4, num_kv_heads=2)
    q = np.random.default_rng(5).normal(size=(2, 1, 4, 32)).astype(
        np.float32) * 4
    qp = np.full((2, 1), q_pos, np.int32)
    want = JL.quantized_decode_attention(jnp.asarray(q), jc, spec,
                                         jnp.asarray(qp), jnp.int32(q_pos),
                                         q_chunk=16, kv_chunk=16)
    real = ops.decode_attention
    ops.decode_attention = None  # any call would raise
    try:
        got = TL.quantized_decode_attention(
            _t(q), tc, spec, _t(qp), torch.tensor(q_pos, dtype=torch.int32),
            q_chunk=16, kv_chunk=16)
    finally:
        ops.decode_attention = real
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT)


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
@pytest.mark.parametrize("name", ["gemma2-2b", "h2o-danube-3-4b",
                                  "h2o-danube-3-4b@120"])
def test_teacher_forced_logits_past_the_window_match_reference(name,
                                                                quantized):
    """A 40-token prefill (2.5 windows: every ring wraps) and 8 decode
    steps fed the same tokens: the logits agree within REL at every step.
    Holds the rounding order of gemma2's pieces (the tanh GELU, the
    embedding × √d in the embedding's dtype, both soft caps) and the rings.
    Without quantization the cache is f32 and the run is end to end. With
    the int8 cache each decode step starts from the reference's caches,
    carried across bit for bit: the f32 sums of the two frameworks differ
    in their last bits, which moves an int8 code of the prefill one step
    now and then (seen: 2e-4 of the largest logit by the last step on
    llama2-7b tiny too); the prefill's codes are held to the reference's
    within one step."""
    cj, pj, ct, pt = _model(name)
    toks = np.random.default_rng(0).integers(0, cj.vocab_size,
                                             (2, 48)).astype(np.int32)
    kw = dict(q_chunk=16, kv_chunk=16, quantized_kv=quantized,
              cache_dtype="bfloat16" if quantized else "float32")
    oj, ot = JT.RuntimeOpts(**kw), TT.RuntimeOpts(**kw)
    lj, cjs = JT.prefill(pj, cj, jnp.asarray(toks[:, :40]), None, 48, oj)
    lt, cts = TT.prefill(pt, ct, torch.as_tensor(toks[:, :40]), 48, ot)
    assert _rel(lt.numpy(), lj) <= REL
    for got, want in zip(cts, _bridge_caches(cjs, ct)):
        assert torch.equal(got.pos, want.pos)
        if quantized:
            assert int((got.k.int() - want.k.int()).abs().max()) <= 1
    for p in range(40, 48):
        if quantized:
            cts = _bridge_caches(cjs, ct)
        lj, cjs = JT.decode_step(pj, cj, jnp.asarray(toks[:, p:p + 1]), cjs,
                                 jnp.int32(p), oj)
        lt, cts = TT.decode_step(pt, ct, torch.as_tensor(toks[:, p:p + 1]),
                                 cts, torch.tensor(p, dtype=torch.int32), ot)
        assert _rel(lt.numpy(), lj) <= REL, p
    rings = [c for c, ls in zip(cts, ct.pattern * ct.num_blocks)
             if ls.mixer.sliding_window]
    assert rings and all(c.pos.shape[1] == WINDOW for c in rings)


def test_sliding_window_masks_distant_tokens():
    """The port's counterpart of tests/test_arch_smoke.py's: token 0 is
    past every window of the last position, so changing it leaves the last
    logits as they are, and changes those of position 1."""
    _, _, cfg, params = _model("h2o-danube-3-4b")
    rng = np.random.default_rng(3)
    base = rng.integers(0, cfg.vocab_size, (1, 40))
    pert = base.copy()
    pert[0, 0] = (pert[0, 0] + 7) % cfg.vocab_size
    opts = TT.RuntimeOpts(q_chunk=16, kv_chunk=16)
    last = [TT.prefill(params, cfg, torch.as_tensor(t), None, opts)[0]
            for t in (base, pert)]
    np.testing.assert_allclose(last[0].numpy(), last[1].numpy(), rtol=1e-4,
                               atol=1e-4)
    near = [TT.prefill(params, cfg, torch.as_tensor(t[:, :2]), None, opts)[0]
            for t in (base, pert)]
    assert float((near[0] - near[1]).abs().max()) > 1e-4


def _reference_greedy(cj, pj, prompts, n, cache_len):
    """The reference's greedy stream (B, n) through prefill/decode_step,
    and each step's top-1/top-2 margin relative to its largest logit."""
    oj = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
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


@pytest.mark.parametrize("name", FAMILIES)
def test_engine_and_fused_server_streams_match_reference(name):
    """Greedy streams past the window (24-token prompts, 12 new tokens,
    int8 KV) from the port's ``Engine`` and ``LLMServer(backend="fused")``
    against the reference's, under the margin rule."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(9).integers(0, ct.vocab_size, (2, 24))
    n, cache_len = 12, 48
    want, margins = _reference_greedy(cj, pj, prompts, n, cache_len)
    opts = TT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    got = Engine(ct, pt, opts, cache_len=cache_len,
                 device="cpu").generate(prompts, n).tokens[:, 24:]
    _assert_margin_rule(got, want, margins)
    srv = LLMServer(ct, pt, opts, backend="fused", cache_len=cache_len,
                    device="cpu")
    rids = [srv.submit(p, SamplingParams(max_tokens=n)) for p in prompts]
    outs = srv.run()
    served = np.stack([outs[r].tokens for r in rids])
    np.testing.assert_array_equal(served, got)


@pytest.mark.parametrize("name,ell", [("gemma2-2bx2", 2),
                                      ("h2o-danube-3-4b", 1)])
@pytest.mark.parametrize("opsc_kw,gen_kw", [
    (dict(qw_front=16), dict(compress=False)),
    (dict(qw_front=16, tau=0.5, max_act_bits=6), {}),
], ids=["uncompressed", "ts_tabq"])
def test_split_engine_matches_reference(name, ell, opsc_kw, gen_kw):
    """``SplitEngine`` against the reference's on both families (a
    two-block gemma2 tiny split between its blocks, danube tiny at layer
    1; 20-token prompts past the window, int8 KV on both segments): the
    tokens and every ``SplitStats`` count are equal; uncompressed, the
    stream is the port's ``Engine``'s bit for bit."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(2).integers(0, ct.vocab_size, (2, 20))
    n = 6
    jopts = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                           moe_capacity_factor=0.0, quantized_kv=True)
    opts = TT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    want = JaxSplitEngine(cj, pj, JOPSC(split_layer=ell, **opsc_kw),
                          opts=jopts, cache_len=48).generate(prompts, n,
                                                             **gen_kw)
    got = SplitEngine(ct, pt, OPSCConfig(split_layer=ell, **opsc_kw),
                      opts=opts, cache_len=48, device="cpu").generate(
        prompts, n, **gen_kw)
    np.testing.assert_array_equal(got[0], want[0])
    for f in STAT_FIELDS:
        assert getattr(got[1], f) == getattr(want[1], f), f
    if gen_kw.get("compress", True):
        return
    eng = Engine(ct, pt, opts, cache_len=48, device="cpu")
    np.testing.assert_array_equal(got[0], eng.generate(prompts, n).tokens)


# ------------------------------------------------------ sizes, refusals


@pytest.mark.parametrize("name,lo,hi,count", [
    ("gemma2-2b", 2.0e9, 3.5e9, 2_614_222_080),
    ("h2o-danube-3-4b", 3.5e9, 4.5e9, 3_961_839_360)])
def test_full_width_parameter_counts(name, lo, hi, count):
    """``param_specs`` at full width, shapes only (nothing allocated):
    the config's own count, within tests/test_arch_smoke.py's range, and
    gemma2's head is its tied embedding (no ``lm_head``)."""
    cfg = get_config(name)
    specs = param_specs(cfg)
    n = sum(int(np.prod(shape)) for shape, _ in specs.values())
    assert n == cfg.total_params() == jax_config(name).total_params() == count
    assert lo <= n <= hi
    assert ("lm_head" in specs) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("name", FAMILIES)
def test_paged_and_packed_paths_refuse_the_families(name):
    """The default (paged) backend refuses both families with the pool's
    own message, as the reference's pool does; the packed tick's varlen
    route refuses soft caps and windows; speculation over a ring is
    refused on the split engine."""
    _, _, cfg, params = _model(name)
    with pytest.raises(NotImplementedError, match="paged ring-append"):
        LLMServer(cfg, params, TT.RuntimeOpts(quantized_kv=True),
                  device="cpu", num_pages=8, page_size=4, max_slots=2)
    spec = cfg.pattern[0].mixer
    with pytest.raises(NotImplementedError, match="kernel-eligible"):
        TL.varlen_attention_layer(None, None, None, None, spec, None, None)
    eng = SplitEngine(cfg, params, OPSCConfig(split_layer=len(cfg.pattern)),
                      cache_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="ring"):
        eng.generate(np.zeros((1, 4), np.int64), 4, speculate_k=2)


def test_qk_norm_still_names_item_9():
    """QK-norm is ported now (qwen3-moe; tests/test_torch_moe.py holds it
    to the reference): a windowed config with ``qk_norm`` gets q_norm and
    k_norm leaves, and its attention layer applies them (norms of 2 scale
    q and k by 2). The rest of item 9 is ported too: the same config with
    M-RoPE gets the same leaves (M-RoPE adds none), and its rotary tables
    are per row (B, S, hd/2), bands (4, 6, 6) of the three position
    axes."""
    cfg = get_config("h2o-danube-3-4b").tiny()
    spec = dataclasses.replace(cfg.pattern[0].mixer, qk_norm=True)
    qk = dataclasses.replace(cfg, pattern=(dataclasses.replace(
        cfg.pattern[0], mixer=spec),))
    specs = param_specs(qk)
    assert specs["blocks/p0/mixer/q_norm"] == ((2, spec.head_dim), None)
    assert specs["blocks/p0/mixer/k_norm"] == ((2, spec.head_dim), None)
    gen = torch.Generator().manual_seed(0)
    hq, hk = spec.num_heads * spec.head_dim, spec.num_kv_heads * spec.head_dim
    p = {"wq": torch.randn(cfg.d_model, hq, generator=gen),
         "wk": torch.randn(cfg.d_model, hk, generator=gen),
         "wv": torch.randn(cfg.d_model, hk, generator=gen),
         "wo": torch.eye(hq), "q_norm": torch.ones(spec.head_dim),
         "k_norm": torch.ones(spec.head_dim)}
    x = torch.randn(1, 3, cfg.d_model, generator=gen)
    pos = torch.arange(3, dtype=torch.int32)[None]

    def run(params, s):
        return TL.attention_layer(params, x, s, rope_cs=None, cache=None,
                                  pos=0, q_positions=pos)[0]

    twice = dict(p, q_norm=2 * p["q_norm"], k_norm=2 * p["k_norm"])
    assert not torch.allclose(run(p, spec), run(twice, spec))
    plain = dataclasses.replace(spec, qk_norm=False)
    assert not torch.allclose(run(p, spec), run(p, plain))
    mrope = dataclasses.replace(qk, rope="mrope", mrope_sections=(4, 6, 6))
    assert param_specs(mrope) == specs
    cos, sin = TT.rope_tables(mrope, pos.expand(2, 3))
    assert cos.shape == sin.shape == (2, 3, spec.head_dim // 2)


def test_init_caches_size_rings_and_global_caches():
    """gemma2's per-layer caches alternate a ring of min(cache_len, window)
    slots with a global cache of cache_len, both rounded by
    ``padded_cache_len`` when quantized (13 + 13 at full width)."""
    cfg = get_config("gemma2-2b")
    for quantized, ring, glob in ((True, 4096, 4608), (False, 4096, 4352)):
        opts = TT.RuntimeOpts(quantized_kv=quantized)
        meta = torch.device("meta")
        caches = TT.init_caches(cfg, 1, 4352, opts, meta)
        slots = [c.pos.shape[1] for c in caches]
        assert slots == [ring, glob] * 13
        assert glob == (padded_cache_len(4352) if quantized else 4352)
