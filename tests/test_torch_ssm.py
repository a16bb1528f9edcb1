"""The Mamba-2 mixer and the state-space configs in the port against the
JAX package on bridged weights: ``_depthwise_conv``, ``ssd_chunked``
(below, at and past one chunk, with a carried state), ``ssd_decode_step``
and ``ssm_layer``; mamba2-780m tiny and a small jamba-v0.1-52b with the
full period-8 pattern (attention at position 3, MoE at odd positions;
``ArchConfig.tiny()`` keeps only two layer kinds and so no attention
layer): prefill and decode logits, ``Engine`` tokens, ``SplitEngine``
tokens and every ``SplitStats`` count, a bf16 recurrent state; the
chunked prefill against the step recurrence; the parameter leaves; the
refusals (speculation and the paged pool on SSM patterns)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.opsc import OPSCConfig as JOPSC
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.split_engine import SplitEngine as JaxSplitEngine
from repro_torch.configs import get_config
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.sampling import SamplingParams
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.params import (F32_LEAVES, from_jax_params, init_params,
                                param_specs)
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.split_engine import SplitEngine

torch.set_num_threads(2)

# f32 outputs across frameworks: the einsums and the chunk recurrence sum
# in another order (tests/test_torch_model.py's tolerance for logits)
REL = 1e-4
ATOL = 1e-5
STAT_FIELDS = ("tokens_generated", "uplink_bits_measured", "uplink_bits_eq3",
               "latency_s", "early_exits", "kv_dropped_steps",
               "uplink_bits_paged", "cloud_pool_bytes_peak",
               "shared_prefix_pages", "uplink_round_trips")
SSM_CONFIGS = ["mamba2-780m", "jamba-v0.1-52b"]


def small_config(cfg, num_blocks=2):
    """``cfg`` at ``tiny()``'s widths with its whole pattern kept (jamba:
    period 8, attention at position 3): the same function of either
    package's config gives the same config in both."""
    def mixer(m):
        if m.kind == "attn":
            return dataclasses.replace(m, num_heads=4, head_dim=32,
                                       num_kv_heads=min(m.num_kv_heads, 2))
        return dataclasses.replace(m, d_inner=256, d_state=16, head_dim=32,
                                   chunk=8)

    def ffn(f):
        if f is None:
            return None
        if f.kind == "mlp":
            return dataclasses.replace(f, d_ff=256)
        return dataclasses.replace(f, num_experts=4, top_k=2, d_ff=64)

    pattern = tuple(dataclasses.replace(ls, mixer=mixer(ls.mixer),
                                        ffn=ffn(ls.ffn))
                    for ls in cfg.pattern)
    return dataclasses.replace(cfg, name=cfg.name + "-small", d_model=128,
                               vocab_size=256, pattern=pattern,
                               num_blocks=num_blocks)


_MODELS: dict = {}


def _model(name, dtype="float32"):
    """(reference config, reference params, port config, port params):
    mamba2's ``tiny()``, jamba's :func:`small_config`, the reference's
    ``init_params(cfg, PRNGKey(0))`` carried across."""
    if (name, dtype) not in _MODELS:
        if name == "jamba-v0.1-52b":
            cj, ct = small_config(jax_config(name)), small_config(
                get_config(name))
        else:
            cj, ct = jax_config(name).tiny(), get_config(name).tiny()
        pj = JT.init_params(cj, jax.random.PRNGKey(0), getattr(jnp, dtype))
        _MODELS[name, dtype] = (cj, pj, ct, from_jax_params(
            jax.tree.map(np.asarray, pj)))
    return _MODELS[name, dtype]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bridge_caches(jcaches, cfg):
    """The reference's caches (a tuple over pattern positions, leaves
    stacked over blocks) as the port's per-layer list, bit for bit."""
    out = []
    for blk in range(cfg.num_blocks):
        for pi, ls in enumerate(cfg.pattern):
            c = jcaches[pi]
            leaf = lambda a: None if a is None else _t(np.asarray(a)[blk])  # noqa: E731
            if ls.mixer.kind == "ssm":
                out.append((leaf(c[0]), leaf(c[1])))
            else:
                out.append(TL.KVCache(leaf(c.k), leaf(c.v), leaf(c.k_scale),
                                      leaf(c.v_scale), leaf(c.pos)))
    return out


def _opts(quantized=True, **kw):
    kw = dict(q_chunk=16, kv_chunk=16, quantized_kv=quantized,
              moe_capacity_factor=0.0, **kw)
    return JT.RuntimeOpts(remat=False, **kw), TT.RuntimeOpts(**kw)


# ------------------------------------------------------------ the mixer


def _inputs(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "carried"])
@pytest.mark.parametrize("s", [1, 6])
def test_depthwise_conv_matches_reference(s, state):
    """The causal depthwise conv (width 4, 40 channels) with and without
    a carried state: the output and the new state (the last three
    inputs) equal the reference's within ATOL."""
    rng = np.random.default_rng(s)
    xbc, w, b = _inputs(rng, 2, s, 40), _inputs(rng, 4, 40), _inputs(rng, 40)
    st = _inputs(rng, 2, 3, 40) if state else None
    yj, nj = JS._depthwise_conv(jnp.asarray(xbc), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    yt, nt = TS._depthwise_conv(torch.as_tensor(xbc), torch.as_tensor(w),
                                torch.as_tensor(b),
                                None if st is None else torch.as_tensor(st))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def _ssd_inputs(rng, b, s, h, p, n):
    x = _inputs(rng, b, s, h, p)
    dt = np.log1p(np.exp(_inputs(rng, b, s, h)))  # softplus: dt > 0
    a = -np.exp(_inputs(rng, h) * 0.5)
    return x, dt.astype(np.float32), a.astype(np.float32), \
        _inputs(rng, b, s, n), _inputs(rng, b, s, n)


@pytest.mark.parametrize("init", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("s", [5, 8, 21], ids=["below", "equal", "past"])
def test_ssd_chunked_matches_reference(s, init):
    """The chunked SSD at chunk 8 over S below one chunk, exactly one and
    past two (padding, then the inter-chunk recurrence), from zeros and
    from a carried state: y and the final state within ATOL of the
    reference's."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 4, 5
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    st = _inputs(rng, b, h, p, n) if init else None
    yj, fj = JS.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), 8,
                            None if st is None else jnp.asarray(st))
    yt, ft = TS.ssd_chunked(*map(torch.as_tensor, (x, dt, a, bm, cm)), 8,
                            None if st is None else torch.as_tensor(st))
    assert yt.shape == (b, s, h, p) and ft.shape == (b, h, p, n)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=ATOL)


def test_ssd_decode_step_matches_reference_and_the_chunked_form():
    """One recurrence step equals the reference's, and six steps from a
    state equal the chunked SSD over the same six tokens from it."""
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 6, 3, 4, 5
    x, dt, a, bm, cm = _ssd_inputs(rng, b, s, h, p, n)
    st = _inputs(rng, b, h, p, n)
    yj, nj = JS.ssd_decode_step(*map(jnp.asarray, (x[:, 0], dt[:, 0], a,
                                                   bm[:, 0], cm[:, 0], st)))
    yt, nt = TS.ssd_decode_step(*map(torch.as_tensor, (
        x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], st)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=ATOL)
    state, ys = torch.as_tensor(st), []
    for t in range(s):
        y, state = TS.ssd_decode_step(*map(torch.as_tensor, (
            x[:, t], dt[:, t], a, bm[:, t], cm[:, t])), state)
        ys.append(y)
    yc, fc = TS.ssd_chunked(*map(torch.as_tensor, (x, dt, a, bm, cm)), 4,
                            torch.as_tensor(st))
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), yc.numpy(),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(state.numpy(), fc.numpy(), rtol=0, atol=ATOL)


def _block0_mixer(name):
    cj, pj, ct, pt = _model(name)
    jp = jax.tree.map(lambda a: a[0], pj["blocks"]["p0"]["mixer"])
    tp = {k[len("blocks/p0/mixer/"):]: v[0] for k, v in pt.items()
          if k.startswith("blocks/p0/mixer/")}
    return jp, tp, ct.pattern[0].mixer


@pytest.mark.parametrize("decode", [False, True], ids=["prefill", "decode"])
def test_ssm_layer_matches_reference(decode):
    """mamba2 tiny's block-0 mixer on x (2, S, 128): a 13-token prefill
    (two chunks of 8, padded) from zeros, or one decode step from carried
    conv and SSM states; the output and both new states within ATOL of the
    reference's."""
    jp, tp, spec = _block0_mixer("mamba2-780m")
    rng = np.random.default_rng(4)
    s = 1 if decode else 13
    x = _inputs(rng, 2, s, 128)
    conv = _inputs(rng, 2, 3, 256 + 32) if decode else None
    state = _inputs(rng, 2, spec.n_heads, 32, 16) if decode else None
    oj, (cj_, sj) = JS.ssm_layer(jp, jnp.asarray(x), spec,
                                 conv_state=None if conv is None
                                 else jnp.asarray(conv),
                                 ssm_state=None if state is None
                                 else jnp.asarray(state), decode=decode)
    ot, (ct_, st) = TS.ssm_layer(tp, torch.as_tensor(x), spec,
                                 conv_state=None if conv is None
                                 else torch.as_tensor(conv),
                                 ssm_state=None if state is None
                                 else torch.as_tensor(state), decode=decode)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ct_.numpy(), np.asarray(cj_), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=ATOL)


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("quantized", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("name", SSM_CONFIGS)
def test_teacher_forced_logits_match_reference(name, quantized):
    """A 20-token prefill at B 2 and 8 decode steps fed the same tokens
    (mamba2 tiny: 2 SSM layers; the small jamba: 16 layers, 2 of them
    rope-free attention): logits within REL of the reference's at every
    step, and each step's SSM states within REL of their largest. Each step starts from
    the reference's caches carried across (the int8 codes of a key whose
    last bit differs can land a step apart,
    tests/test_torch_families.py)."""
    cj, pj, ct, pt = _model(name)
    toks = np.random.default_rng(0).integers(0, ct.vocab_size,
                                             (2, 28)).astype(np.int32)
    oj, ot = _opts(quantized)
    lj, cjs = JT.prefill(pj, cj, jnp.asarray(toks[:, :20]), None, 28, oj)
    lt, cts = TT.prefill(pt, ct, torch.as_tensor(toks[:, :20]), 28, ot)
    assert _rel(lt.numpy(), lj) <= REL
    for p in range(20, 28):
        want_caches = _bridge_caches(cjs, ct)
        for got, want, ls in zip(cts, want_caches,
                                 ct.pattern * ct.num_blocks):
            if ls.mixer.kind == "ssm":
                assert got[0].dtype == want[0].dtype == torch.bfloat16
                assert _rel(got[1].numpy(), want[1].numpy()) <= REL
        lj, cjs = JT.decode_step(pj, cj, jnp.asarray(toks[:, p:p + 1]),
                                 cjs, jnp.int32(p), oj)
        lt, cts = TT.decode_step(pt, ct, torch.as_tensor(toks[:, p:p + 1]),
                                 want_caches, torch.tensor(p,
                                                           dtype=torch.int32),
                                 ot)
        assert _rel(lt.numpy(), lj) <= REL, p


@pytest.mark.parametrize("name", SSM_CONFIGS)
def test_engine_and_fused_server_streams_match_reference_engine(name):
    """Greedy streams (int8 KV on jamba's attention layers, 12-token
    prompts, 10 new tokens) from the port's ``Engine`` equal the
    reference ``Engine``'s, logprobs within 1e-4 (and 1e-4 of their
    size, tests/test_torch_scheduler.py's tolerance) on mamba2 and 5e-3 on
    jamba, whose int8 keys land a code apart where their f32 values differ
    in the last bit (tests/test_torch_families.py), as the bf16 conv state
    may land a bf16 step apart;
    ``LLMServer(backend="fused")`` gives the Engine's."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(9).integers(0, ct.vocab_size, (3, 12))
    oj, ot = _opts()
    want = JaxEngine(cj, pj, oj, cache_len=32).generate(prompts, 10)
    got = Engine(ct, pt, ot, cache_len=32, device="cpu").generate(prompts, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens[:, :22])
    lp_tol = dict(rtol=1e-4, atol=1e-4 if name == "mamba2-780m" else 5e-3)
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs)[:, :10],
                               **lp_tol)
    srv = LLMServer(ct, pt, ot, backend="fused", cache_len=32, device="cpu")
    rids = [srv.submit(p, SamplingParams(max_tokens=10)) for p in prompts]
    outs = srv.run()
    np.testing.assert_array_equal(np.stack([outs[r].tokens for r in rids]),
                                  got.tokens[:, 12:])


def test_chunked_prefill_equals_the_step_recurrence():
    """The small jamba in f32: a prefill of 20 tokens then 6 decode steps
    against one prefill of all 26 (three chunks of 8 and a padded one):
    each step's logits within REL of the longer prefill's at its column
    (a prefill of that length), and the SSM states alike, relative to
    their largest."""
    _, _, ct, pt = _model("jamba-v0.1-52b")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, ct.vocab_size, (2, 26)))
    ot = TT.RuntimeOpts(q_chunk=16, kv_chunk=16, moe_capacity_factor=0.0,
                        cache_dtype="float32")
    with torch.inference_mode():
        _, caches = TT.prefill(pt, ct, toks[:, :20], 26, ot)
        for p in range(20, 26):
            lt, caches = TT.decode_step(pt, ct, toks[:, p:p + 1], caches, p,
                                        ot)
            want, full = TT.prefill(pt, ct, toks[:, :p + 1], 26, ot)
            assert _rel(lt.numpy(), want.numpy()) <= REL, p
        for got, ref, ls in zip(caches, full, ct.pattern * ct.num_blocks):
            if ls.mixer.kind == "ssm":
                assert _rel(got[0].numpy(), ref[0].numpy()) <= REL
                assert _rel(got[1].numpy(), ref[1].numpy()) <= REL


def test_bf16_state_matches_reference():
    """``ssm_state_dtype="bfloat16"``: mamba2 tiny's recurrent states are
    stored in bf16 (half the f32 bytes), compute stays f32; the Engine's
    tokens equal the reference Engine's with the same option, and a
    bf16-state prefill's logits lie within REL of the reference's."""
    cj, pj, ct, pt = _model("mamba2-780m")
    oj, ot = _opts(ssm_state_dtype="bfloat16")
    caches = TT.init_caches(ct, 2, 32, ot)
    f32 = TT.init_caches(ct, 2, 32, _opts()[1])
    assert caches[0][1].dtype == torch.bfloat16
    assert caches[0][1].nbytes * 2 == f32[0][1].nbytes
    prompts = np.random.default_rng(7).integers(0, ct.vocab_size, (2, 12))
    lj, cjs = JT.prefill(pj, cj, jnp.asarray(prompts), None, 32, oj)
    lt, cts = TT.prefill(pt, ct, torch.as_tensor(prompts), 32, ot)
    assert _rel(lt.numpy(), lj) <= REL
    assert cts[0][1].dtype == torch.bfloat16
    want = JaxEngine(cj, pj, oj, cache_len=32).generate(prompts, 8)
    got = Engine(ct, pt, ot, cache_len=32, device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens[:, :20])


# -------------------------------------------------------- the split path


@pytest.mark.parametrize("name,ell,compress,i_kv", [
    ("mamba2-780m", 1, True, 1), ("mamba2-780m", 1, False, 1),
    ("mamba2-780m", 1, True, 0), ("jamba-v0.1-52b", 8, True, 1),
    ("jamba-v0.1-52b", 8, False, 1)])
def test_split_engine_matches_reference(name, ell, compress, i_kv):
    """The split at ℓ (mamba2 tiny at 1; the small jamba at 8, one whole
    block on the edge: its SSM projections, MoE experts and router as
    int8 codes through K7's plain version, ``conv_w`` as dequantized
    codes), compressed or not, with the cache shipped (I_kv 1) or the
    stateless cloud re-running the SSM history (I_kv 0): the tokens and
    every ``SplitStats`` count equal the reference's; Eq. 3 counts
    d_model on mamba2 (no attention layer)."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(2).integers(0, ct.vocab_size, (2, 20))
    oj, ot = _opts()
    want = JaxSplitEngine(cj, pj, JOPSC(split_layer=ell, i_kv=i_kv),
                          opts=oj, cache_len=48).generate(
        prompts, 6, compress=compress)
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=ell, i_kv=i_kv),
                      opts=ot, cache_len=48, device="cpu")
    got = eng.generate(prompts, 6, compress=compress)
    np.testing.assert_array_equal(got[0], want[0])
    for f in STAT_FIELDS:
        assert getattr(got[1], f) == getattr(want[1], f), f
    codes = eng.edge_params["blocks/p0/mixer/w_x"]
    assert codes.codes.dtype == torch.int8
    assert eng.edge_params["blocks/p0/mixer/conv_w"].codes.shape == \
        (ell // len(ct.pattern), 4, 256 + 32)


# -------------------------------------------------- specs and refusals


@pytest.mark.parametrize("name", SSM_CONFIGS)
def test_param_specs_count_and_leaves(name):
    """``param_specs`` at full width (shapes only) sums to the config's
    own parameter count, which counts two norms a layer (less one a
    layer without an ffn); a mamba2 layer has no ln2 and no ffn leaves;
    ``init_params`` on the small config keeps ``dt_bias``, ``A_log`` and
    ``D`` f32 in a bf16 model, ``dt_bias``, ``A_log`` and ``conv_b``
    zeros, and matches the reference's shapes and dtypes leaf for leaf."""
    cfg = get_config(name)
    specs = param_specs(cfg)
    no_ffn = sum(ls.ffn is None for ls in cfg.pattern) * cfg.num_blocks
    assert sum(int(np.prod(s)) for s, _ in specs.values()) \
        == cfg.total_params() - no_ffn * cfg.d_model
    if name == "mamba2-780m":
        assert not any("ln2" in k or "/ffn/" in k for k in specs)
    cj, pj, ct, _ = _model(name, "bfloat16")
    pt = init_params(ct, torch.Generator().manual_seed(0), torch.bfloat16)
    want = {k: v for k, v in from_jax_params(
        jax.tree.map(np.asarray, pj)).items()}
    assert set(pt) == set(want)
    for k, v in pt.items():
        assert v.shape == want[k].shape and v.dtype == want[k].dtype, k
        if k.endswith(("dt_bias", "A_log", "conv_b")):
            assert not v.any(), k
    assert all(pt[k].dtype == torch.float32 for k in pt
               if k.endswith(F32_LEAVES))


@pytest.mark.parametrize("name", SSM_CONFIGS)
def test_speculation_on_ssm_patterns_is_refused(name):
    """``speculate_k > 0`` on a pattern with a Mamba-2 layer raises
    ``NotImplementedError`` (the reference fails there with an
    AssertionError: the verify burst is a k-token decode call), through
    ``SplitEngine.generate`` and through the split backend's request."""
    _, _, ct, pt = _model(name)
    ell = len(ct.pattern)
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=ell), opts=_opts()[1],
                      cache_len=48, device="cpu")
    prompts = np.zeros((1, 6), np.int64)
    with pytest.raises(NotImplementedError, match="Mamba-2"):
        eng.generate(prompts, 4, speculate_k=2)
    srv = LLMServer(ct, pt, _opts()[1], backend="split",
                    opsc=OPSCConfig(split_layer=ell), cache_len=48,
                    device="cpu")
    srv.submit(prompts[0], SamplingParams(max_tokens=4, speculate_k=2))
    with pytest.raises(NotImplementedError, match="Mamba-2"):
        srv.run()


@pytest.mark.parametrize("name", SSM_CONFIGS)
def test_paged_backend_on_ssm_patterns_is_refused(name):
    """The paged pool covers attention-only patterns, as the reference's
    does: ``LLMServer(backend="paged")`` and a paged split cloud raise
    ``NotImplementedError`` on an SSM pattern."""
    _, _, ct, pt = _model(name)
    with pytest.raises(NotImplementedError, match="attention-only"):
        LLMServer(ct, pt, _opts()[1], backend="paged", num_pages=24,
                  page_size=4, max_slots=2, device="cpu")
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=len(ct.pattern)),
                      opts=_opts()[1], cache_len=48, paged_cloud_kv=True,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        eng.generate(np.zeros((1, 6), np.int64), 4)


@pytest.mark.parametrize("split", [False, True], ids=["engine", "split"])
@pytest.mark.parametrize("name", SSM_CONFIGS)
def test_launcher_serves_the_ssm_configs(name, split, capsys):
    """The launcher serves mamba2 and jamba tiny on the CPU, through the
    Engine and the split engine (jamba with ``--num-blocks 1``)."""
    argv = ["--arch", name, "--tiny", "--batch", "2", "--prompt-len", "10",
            "--new", "4", "--quantized-kv", "--device", "cpu",
            "--num-blocks", "1"]
    serve.main(argv + (["--split", "--qw-front", "4"] if split else []))
    out = capsys.readouterr().out
    assert ("[serve/split]" if split else "[serve]") in out
