"""The vision-stub and audio configs in the port against the JAX package on
bridged weights: qwen2-vl-2b (M-RoPE's three-axis positions, pre-projector
patch embeddings projected into the sequence head, an untied head under
``tie_embeddings=True``) and musicgen-medium (four codebook token streams
summed at the embedding, a (K, V) head, sinusoidal positions), each at
small widths with its full-width query heads a kv head (qwen2-vl G 6,
musicgen G 1): the position tables and the embedding, the parameter
shapes, teacher-forced logits, the ``Engine``'s streams (qwen2-vl with
patches; musicgen's codebooks, greedy and sampled), qwen2-vl's paged
scheduler streams, both split engines' tokens and counts, the launcher
and the refusals; and the paged pool's dense-gather route
(``RuntimeOpts.paged_prefill_kernel=False``, and every soft-capped layer
through the pool)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.opsc import OPSCConfig as JOPSC
from repro.core.sampling import SamplingParams as JSamplingParams
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.split_engine import SplitEngine as JaxSplitEngine
from repro_torch.configs import get_config
from repro_torch.core.opsc import OPSCConfig
from repro_torch.core.sampling import SamplingParams
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax_params, init_params, param_specs
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import SplitEngine

torch.set_num_threads(2)

# f32 logits across frameworks (tests/test_torch_gqa.py's tolerances)
REL = 1e-4
LP_TOL = dict(rtol=1e-4, atol=1e-4)
# position tables and embeddings: f32 sin/cos of the same f32 angles
TABLE_TOL = dict(rtol=1e-5, atol=1e-5)
STAT_FIELDS = ("tokens_generated", "uplink_bits_measured", "uplink_bits_eq3",
               "latency_s", "early_exits", "kv_dropped_steps",
               "uplink_bits_paged", "cloud_pool_bytes_peak",
               "shared_prefix_pages", "uplink_round_trips")
# tests/test_scheduler.py:34's jobs, (prompt length, max new tokens); the
# first prompt is longer than the small qwen2-vl's 8 patch slots
JOBS = [(11, 6), (8, 3), (3, 9), (6, 4), (2, 7)]
NAMES = ["qwen2-vl-2b", "musicgen-medium"]


def small_config(cfg):
    """``cfg.tiny()`` (d_model 128, vocab 256, head dim 32; qwen2-vl's
    M-RoPE sections (4, 6, 6), 8 patch slots of width 64) with the
    full-width query heads a kv head kept: 12 query heads on 2 kv heads for
    qwen2-vl (G 6; ``tiny()`` gives G 2), 4 on 4 for musicgen (G 1). The
    same function of either package's config gives the same config."""
    m = cfg.pattern[0].mixer
    g = m.num_heads // m.num_kv_heads
    tiny = cfg.tiny()
    kv = 2 if g > 1 else 4
    pattern = tuple(dataclasses.replace(ls, mixer=dataclasses.replace(
        ls.mixer, num_heads=g * kv, num_kv_heads=kv)) for ls in tiny.pattern)
    return dataclasses.replace(tiny, name=cfg.name + "-small",
                               pattern=pattern)


_MODELS: dict = {}


def _model(name):
    """(reference config, reference params, port config, port params) of
    the small config, the reference's ``init_params(cfg, PRNGKey(0))``
    carried across."""
    if name not in _MODELS:
        cj, ct = small_config(jax_config(name)), small_config(
            get_config(name))
        pj = JT.init_params(cj, jax.random.PRNGKey(0), jnp.float32)
        _MODELS[name] = (cj, pj, ct, from_jax_params(
            jax.tree.map(np.asarray, pj)))
    return _MODELS[name]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _inputs(cfg, b, s, seed):
    """Prompt tokens (B, S) or (B, S, K) and qwen2-vl's patch embeddings
    (B, num_patches, d_vision) (None on musicgen), from numpy."""
    rng = np.random.default_rng(seed)
    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1 else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    patches = None
    if cfg.embed == "vlm":
        patches = rng.normal(size=(b, cfg.num_patches, cfg.d_vision)) \
            .astype(np.float32)
    return toks, patches


def _bridge_caches(jcaches, cfg):
    """The reference's caches (stacked over blocks) as the port's
    per-layer list, bit for bit."""
    out = []
    for blk in range(cfg.num_blocks):
        for pi in range(len(cfg.pattern)):
            c = jcaches[pi]
            leaf = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
                np.asarray(a)[blk].copy())
            out.append(TL.KVCache(leaf(c.k), leaf(c.v), leaf(c.k_scale),
                                  leaf(c.v_scale), leaf(c.pos)))
    return out


KW = dict(q_chunk=16, kv_chunk=16, quantized_kv=True)
OPTS_Q = TT.RuntimeOpts(**KW)
JOPTS_Q = JT.RuntimeOpts(remat=False, **KW)


# ------------------------------------------------------ positions, embedding


def test_mrope_positions_and_tables_match_reference():
    """M-RoPE ids (3, B, S) and tables over pads (-1), the patch grid and
    text past it, for the full config (1024 patches on a 32 × 32 grid) and
    the small one (8 patches, a 2 × 2 grid the ids wrap around): equal ids,
    tables within TABLE_TOL."""
    for cfg in (get_config("qwen2-vl-2b"),
                small_config(get_config("qwen2-vl-2b"))):
        jcfg = jax_config("qwen2-vl-2b") if cfg.num_patches == 1024 \
            else small_config(jax_config("qwen2-vl-2b"))
        p = cfg.num_patches
        pos = np.array([[-1, -1, 0, 1, 5, p - 1, p, p + 3, 2 * p + 7],
                        [-3, 2, 3, 7, p - 2, p + 1, p + 2, 3 * p, 4 * p]],
                       np.int32)
        want = np.asarray(JT.make_mrope_positions(jcfg, jnp.asarray(pos)))
        got = TT.make_mrope_positions(cfg, torch.as_tensor(pos))
        np.testing.assert_array_equal(got.numpy(), want)
        hd = cfg.pattern[0].mixer.head_dim
        jc, js = JL.mrope_tables(jnp.asarray(want), hd, cfg.mrope_sections,
                                 cfg.rope_theta)
        tc, ts = TL.mrope_tables(got, hd, cfg.mrope_sections, cfg.rope_theta)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TABLE_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TABLE_TOL)
        # the port's whole table path: rope_tables on sequence positions
        rc, rs = TT.rope_tables(cfg, torch.as_tensor(pos))
        np.testing.assert_array_equal(rc.numpy(), tc.numpy())
        np.testing.assert_array_equal(rs.numpy(), ts.numpy())


def test_mrope_on_text_positions_is_rope_shifted():
    """Past the patches all three ids are p - P + √P, so M-RoPE's tables
    there are the plain RoPE table at that shifted position, whatever the
    sections (the property Qwen2-VL's text tokens rely on)."""
    cfg = get_config("qwen2-vl-2b")
    p, grid = cfg.num_patches, math.isqrt(cfg.num_patches)
    hd = cfg.pattern[0].mixer.head_dim
    pos = torch.arange(p, p + 300, dtype=torch.int32)[None]
    mc, ms = TT.rope_tables(cfg, pos)
    rc, rs = TL.rope_table(pos - p + grid, hd, cfg.rope_theta)
    np.testing.assert_array_equal(mc.numpy(), rc.numpy())
    np.testing.assert_array_equal(ms.numpy(), rs.numpy())


def test_sinusoidal_embedding_matches_reference():
    """musicgen's absolute embedding at its width over positions up to
    4095: within 3e-4 of the reference's. The two frameworks' f32 ``exp``
    part by one ulp on some frequencies (72 of musicgen's 768), which moves
    the angle at position p by up to p · 6e-8 rad: 2.4e-4 at 4095. Below
    position 16 the tolerance is TABLE_TOL's."""
    pos = np.array([[0, 1, 2, 17, 511], [1000, 2047, 3000, 4095, 64]],
                   np.int32)
    for dim in (1536, 128):
        want = np.asarray(JL.sinusoidal_embedding(jnp.asarray(pos), dim))
        got = TL.sinusoidal_embedding(torch.as_tensor(pos), dim)
        assert got.shape == (2, 5, dim) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4)
        np.testing.assert_allclose(got[0, :4].numpy(), want[0, :4],
                                   **TABLE_TOL)


@pytest.mark.parametrize("case", ["vlm_patches", "vlm_text", "musicgen"])
def test_embed_inputs_matches_reference(case):
    """``embed_inputs``: qwen2-vl with its patches projected over the first
    8 rows (and without, text only), musicgen's four codebook embeddings
    summed with the sinusoidal term at positions offset by 5; in f32 and
    in bf16 (the codebook sum and the term's cast in the embedding's
    dtype, as the reference)."""
    name = "musicgen-medium" if case == "musicgen" else "qwen2-vl-2b"
    cj, pj, ct, pt = _model(name)
    toks, patches = _inputs(ct, 2, 12, 3)
    if case == "vlm_text":
        patches = None
    pos = np.arange(5, 17, dtype=np.int32)[None].repeat(2, 0)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6),
                         (torch.bfloat16, jnp.bfloat16, 1e-2)):
        pjd = jax.tree.map(lambda a: jnp.asarray(a, jdt), pj)
        ptd = {k: v.to(dt) for k, v in pt.items()}
        want = JT.embed_inputs(cj, pjd, jnp.asarray(toks), None if
                               patches is None else jnp.asarray(patches),
                               jnp.asarray(pos))
        got = TT.embed_inputs(ct, ptd, torch.as_tensor(toks), None if
                              patches is None else torch.as_tensor(patches),
                              torch.as_tensor(pos))
        assert got.dtype == dt and got.shape == (2, 12, ct.d_model)
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol
        if dt == torch.bfloat16 and case != "vlm_patches":
            # no product to reassociate: the same bf16 bits
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_reference_abstract_params(name):
    """Every leaf of the full config's ``param_specs`` has the shape of
    the reference's ``abstract_params`` leaf, and no leaf is missing:
    qwen2-vl's projector (1280, 1536) and its untied (1536, 151936) head
    (its config says ``tie_embeddings=True``; the reference ties only a
    ``"token"`` embedding), musicgen's (4, 2048, 1536) embedding and
    (1536, 8192) head."""
    cfg = get_config(name)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = tuple(v.shape)

    walk(JT.abstract_params(jax_config(name)), "")
    specs = param_specs(cfg)
    assert {k: shape for k, (shape, _) in specs.items()} == flat
    d = cfg.d_model
    if name == "qwen2-vl-2b":
        assert cfg.tie_embeddings
        assert specs["w_proj"] == ((1280, d), 1.0 / math.sqrt(1280))
        assert specs["lm_head"][0] == (d, 151936)
    else:
        assert specs["embed"][0] == (4, 2048, d)
        assert specs["lm_head"][0] == (d, 4 * 2048)


def test_init_params_draws_the_new_leaves():
    """``init_params`` draws the projector and the codebook embedding at
    the reference's scales (the small configs, on the CPU)."""
    for name in NAMES:
        _, _, ct, _ = _model(name)
        p = init_params(ct, torch.Generator().manual_seed(0))
        for key, (shape, scale) in param_specs(ct).items():
            assert tuple(p[key].shape) == shape, key
            if key in ("w_proj", "embed", "lm_head"):
                assert abs(float(p[key].std()) - scale) < 0.1 * scale, key


# ------------------------------------------------------------------ models


@pytest.mark.parametrize("quantized", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("name", NAMES)
def test_teacher_forced_logits_match_reference(name, quantized):
    """A 20-token prefill at B 2 (qwen2-vl's first 8 rows its projected
    patches) and 8 decode steps fed the same tokens: logits (musicgen's
    (B, 4, V)) within REL at every step, each int8 step from the
    reference's caches carried across (tests/test_torch_families.py says
    why)."""
    cj, pj, ct, pt = _model(name)
    toks, patches = _inputs(ct, 2, 28, 0)
    kw = dict(KW, quantized_kv=quantized,
              cache_dtype="bfloat16" if quantized else "float32")
    oj, ot = JT.RuntimeOpts(remat=False, **kw), TT.RuntimeOpts(**kw)
    lj, cjs = JT.prefill(pj, cj, jnp.asarray(toks[:, :20]), None if
                         patches is None else jnp.asarray(patches), 28, oj)
    lt, cts = TT.prefill(pt, ct, torch.as_tensor(toks[:, :20]), 28, ot,
                         None if patches is None else torch.as_tensor(
                             patches))
    assert lt.shape == lj.shape
    assert _rel(lt.numpy(), lj) <= REL
    for p in range(20, 28):
        if quantized:
            cts = _bridge_caches(cjs, ct)
        lj, cjs = JT.decode_step(pj, cj, jnp.asarray(toks[:, p:p + 1]), cjs,
                                 jnp.int32(p), oj)
        lt, cts = TT.decode_step(pt, ct, torch.as_tensor(toks[:, p:p + 1]),
                                 cts, torch.tensor(p, dtype=torch.int32), ot)
        assert _rel(lt.numpy(), lj) <= REL, p


@pytest.mark.parametrize("name", NAMES)
def test_engine_streams_match_reference_engine(name):
    """Greedy streams (int8 KV, 12-token prompts, 10 new tokens): qwen2-vl
    with patches (which change its stream), musicgen (B, S, 4) prompts
    giving (B, S + 10, 4) tokens and (B, 10, 4) logprobs, argmax a
    codebook: tokens equal to the reference ``Engine``'s, logprobs within
    1e-4."""
    cj, pj, ct, pt = _model(name)
    prompts, patches = _inputs(ct, 3, 12, 9)
    want = JaxEngine(cj, pj, JOPTS_Q, cache_len=32).generate(
        prompts, 10, patches=patches)
    eng = Engine(ct, pt, OPTS_Q, cache_len=32, device="cpu")
    got = eng.generate(prompts, 10, patches=patches)
    np.testing.assert_array_equal(got.tokens, want.tokens[:, :22])
    np.testing.assert_allclose(got.logprobs,
                               np.asarray(want.logprobs)[:, :10], **LP_TOL)
    if name == "musicgen-medium":
        assert got.tokens.shape == (3, 22, 4)
        assert got.logprobs.shape == (3, 10, 4)
    else:
        text = eng.generate(prompts, 10)
        assert not np.array_equal(text.tokens, got.tokens)
        jtext = JaxEngine(cj, pj, JOPTS_Q, cache_len=32).generate(prompts, 10)
        np.testing.assert_array_equal(text.tokens, jtext.tokens[:, :22])


def test_codebook_sampling_follows_each_codebooks_distribution():
    """``Engine.generate(temperature=0.9)`` on musicgen draws each (row,
    codebook) on its own, as the reference's ``categorical(axis=-1)``:
    over 96 equal prompts the first generated token of each codebook
    follows softmax(logits / 0.9) of the reference's prefill (a vocab of
    8: total variation below 0.15, the sampling noise at 96 draws about
    0.08); codebooks and rows draw distinct streams; the tokens come back
    (B, S + T, 4)."""
    cj = dataclasses.replace(small_config(jax_config("musicgen-medium")),
                             vocab_size=8)
    ct = dataclasses.replace(small_config(get_config("musicgen-medium")),
                             vocab_size=8)
    pj = JT.init_params(cj, jax.random.PRNGKey(3), jnp.float32)
    pt = from_jax_params(jax.tree.map(np.asarray, pj))
    prompt = np.random.default_rng(4).integers(0, 8, (1, 6, 4))
    lj, _ = JT.prefill(pj, cj, jnp.asarray(prompt), None, 8,
                       JT.RuntimeOpts(remat=False, q_chunk=16, kv_chunk=16))
    probs = np.asarray(jax.nn.softmax(lj[0] / 0.9, axis=-1))  # (4, 8)
    prompts = np.repeat(prompt, 96, axis=0)
    out = Engine(ct, pt, TT.RuntimeOpts(q_chunk=16, kv_chunk=16),
                 cache_len=16, device="cpu").generate(
        prompts, 3, temperature=0.9, seed=11)
    assert out.tokens.shape == (96, 9, 4)
    np.testing.assert_array_equal(out.tokens[:, :6], prompts)
    first = out.tokens[:, 6]  # (96, 4)
    for k in range(4):
        freq = np.bincount(first[:, k], minlength=8) / 96
        assert 0.5 * np.abs(freq - probs[k]).sum() < 0.15, k
    assert len({tuple(r) for r in out.tokens[:, 6:].reshape(96, -1)}) > 48
    assert np.any(first[:, 0] != first[:, 1])


def test_qwen2_vl_schedulers_and_fused_server_match_reference():
    """qwen2-vl text-only through the paged pool (the reference's paged
    entry points take no patches; M-RoPE ids from the absolute positions):
    tests/test_scheduler.py:34's jobs through three slots, a chunk budget
    of 4 (K2, K3 and K4 at G 6 through their plain versions), chunked and
    packed: the streams equal the reference ``Scheduler``'s, logprobs
    within 1e-4, the same decode steps, every page back; and
    ``LLMServer(backend="fused")`` gives the port's ``Engine`` streams."""
    cj, pj, ct, pt = _model("qwen2-vl-2b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, ct.vocab_size, (n,)) for n, _ in JOBS]
    for tick_mode in ("chunked", "packed"):
        kw = dict(num_pages=24, page_size=4, max_slots=3,
                  tick_mode=tick_mode, prefill_chunk=4)
        runs = []
        for sched in (JaxScheduler(cj, pj, JOPTS_Q, **kw),
                      Scheduler(ct, pt, OPTS_Q, device="cpu", **kw)):
            rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, JOBS)]
            results = sched.run()
            events = sorted(tuple(e[:4]) for e in sched.drain_events())
            runs.append(([results[r] for r in rids], events, sched))
        (want, want_ev, jsched), (got, got_ev, sched) = runs
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert [e[:3] for e in got_ev] == [e[:3] for e in want_ev]
        np.testing.assert_allclose([e[3] for e in got_ev],
                                   [e[3] for e in want_ev], **LP_TOL)
        assert sched.stats.steps == jsched.stats.steps
        assert sched.pool.pages_in_use == 0
    srv = LLMServer(ct, pt, OPTS_Q, backend="fused", cache_len=32,
                    device="cpu")
    same = [rng.integers(0, ct.vocab_size, (10,)) for _ in range(3)]
    rids = [srv.submit(p, SamplingParams(max_tokens=6)) for p in same]
    outs = srv.run()
    eng = Engine(ct, pt, OPTS_Q, cache_len=32, device="cpu").generate(
        np.stack(same), 6)
    np.testing.assert_array_equal(np.stack([outs[r].tokens for r in rids]),
                                  eng.tokens[:, 10:])


@pytest.mark.parametrize("compress", [True, False], ids=["tsq", "raw"])
@pytest.mark.parametrize("name", NAMES)
def test_split_engine_matches_reference(name, compress):
    """The split at layer 1 (block 0 as int8 codes through K7's plain
    version; musicgen's edge embeds its codebooks and the sinusoidal term
    at each step's position), int8 KV, text only for qwen2-vl as in the
    reference: the tokens (musicgen's (B, S + 6, 4)) and every
    ``SplitStats`` count equal the reference's."""
    cj, pj, ct, pt = _model(name)
    prompts, _ = _inputs(ct, 2, 20, 2)
    want = JaxSplitEngine(cj, pj, JOPSC(split_layer=1, qw_front=4),
                          opts=JOPTS_Q, cache_len=48).generate(
        prompts, 6, compress=compress)
    got = SplitEngine(ct, pt, OPSCConfig(split_layer=1, qw_front=4),
                      opts=OPTS_Q, cache_len=48, device="cpu").generate(
        prompts, 6, compress=compress)
    np.testing.assert_array_equal(got[0], want[0])
    for f in STAT_FIELDS:
        assert getattr(got[1], f) == getattr(want[1], f), f


def test_split_logprobs_carry_the_codebooks():
    """musicgen's split with ``with_logprobs=True``: (B, T, 4) logprobs
    equal to a full-precision uncompressed split's own head (the tokens'
    log-probabilities under the cloud's logits), tokens equal to the
    ``Engine``'s at ``qw_front`` 16 without compression."""
    _, _, ct, pt = _model("musicgen-medium")
    prompts, _ = _inputs(ct, 2, 12, 5)
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=1, qw_front=16),
                      opts=OPTS_Q, cache_len=32, device="cpu")
    toks, _, lps = eng.generate(prompts, 5, compress=False,
                                with_logprobs=True)
    want = Engine(ct, pt, OPTS_Q, cache_len=32, device="cpu").generate(
        prompts, 5)
    np.testing.assert_array_equal(toks, want.tokens)
    assert lps.shape == (2, 5, 4)
    np.testing.assert_allclose(lps, want.logprobs, **LP_TOL)


@pytest.mark.parametrize("split", [False, True], ids=["engine", "split"])
@pytest.mark.parametrize("name", NAMES)
def test_launcher_serves_the_modal_configs(name, split, capsys):
    """The launcher serves qwen2-vl (text) and musicgen ((B, S, 4)
    prompts, as the reference's launcher draws them) tiny on the CPU
    through the Engine and the split engine."""
    argv = ["--arch", name, "--tiny", "--batch", "2", "--prompt-len", "10",
            "--new", "4", "--quantized-kv", "--device", "cpu"]
    serve.main(argv + (["--split", "--qw-front", "4"] if split else []))
    out = capsys.readouterr().out
    if split:
        assert "[serve/split] 2×4 tokens" in out
    else:
        shape = "(2, 14, 4)" if name == "musicgen-medium" else "(2, 14)"
        assert f"[serve] {shape}" in out


def test_refusals_match_the_reference():
    """What the reference refuses on codebook prompts the port refuses
    alike: ``speculate_k`` and non-greedy sampling on the split engine, and
    non-greedy ``generate_requests`` (``NotImplementedError``); the server
    takes one 1-D prompt a request; the paged ``Scheduler`` refuses a
    codebook config up front (the reference fails inside its first tick)
    with a plain ``ValueError``; prompts of the wrong rank are refused."""
    cj, pj, ct, pt = _model("musicgen-medium")
    prompts, _ = _inputs(ct, 2, 8, 1)
    hot = SamplingParams(max_tokens=3, temperature=0.7, seed=1)
    jhot = JSamplingParams(max_tokens=3, temperature=0.7, seed=1)
    jeng = JaxSplitEngine(cj, pj, JOPSC(split_layer=1, qw_front=4),
                          opts=JOPTS_Q, cache_len=24)
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=1, qw_front=4),
                      opts=OPTS_Q, cache_len=24, device="cpu")
    for e, sp in ((jeng, jhot), (eng, hot)):
        with pytest.raises(NotImplementedError, match="token prompts"):
            e.generate(prompts, 3, speculate_k=2)
        with pytest.raises(NotImplementedError, match="token prompts"):
            e.generate(prompts, 3, sampling=sp)
    with pytest.raises(NotImplementedError, match="token prompts"):
        JaxEngine(cj, pj, JOPTS_Q, cache_len=24).generate_requests(
            prompts, jhot)
    engine = Engine(ct, pt, OPTS_Q, cache_len=24, device="cpu")
    with pytest.raises(NotImplementedError, match="token prompts"):
        engine.generate_requests(prompts, hot)
    with pytest.raises(ValueError, match="codebook"):
        engine.generate(prompts[..., 0], 3)
    with pytest.raises(ValueError, match="codebook"):
        eng.generate(prompts[..., 0], 3)
    with pytest.raises(ValueError, match="codebooks"):
        Scheduler(ct, pt, OPTS_Q, device="cpu", num_pages=8, page_size=4)
    srv = LLMServer(ct, pt, OPTS_Q, backend="fused", cache_len=24,
                    device="cpu")
    with pytest.raises(ValueError, match="1-D"):
        srv.submit(prompts[0])
    _, _, tv, tp = _model("qwen2-vl-2b")
    with pytest.raises(ValueError, match=r"\(B, S\)"):
        Engine(tv, tp, OPTS_Q, cache_len=24, device="cpu").generate(
            prompts, 3)


# ------------------------------------------------- the dense-gather route


@pytest.mark.parametrize("tick_mode", ["chunked", "packed"])
def test_dense_gather_route_matches_reference(tick_mode):
    """``RuntimeOpts(paged_prefill_kernel=False)``: continuation chunks and
    forks gather the pool dense into ``chunked_attention`` and the packed
    tick takes K4's plain version, as the reference's route with the same
    flag: qwen2-vl's jobs (a chunk budget of 4, the last two forking a
    6-token prefix) give the reference's streams, logprobs within 1e-4;
    the same requests through the kernel route give the same tokens."""
    cj, pj, ct, pt = _model("qwen2-vl-2b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, ct.vocab_size, (n,)) for n, _ in JOBS]
    for p in prompts[3:]:
        p[:2] = prompts[0][:2]
    prompts[3] = np.concatenate([prompts[0][:6], prompts[3]])
    prompts[4] = np.concatenate([prompts[0][:6], prompts[4]])
    kw = dict(num_pages=32, page_size=4, max_slots=3, tick_mode=tick_mode,
              prefill_chunk=4)
    gather = dict(KW, paged_prefill_kernel=False)
    runs = []
    for sched in (JaxScheduler(cj, pj, JT.RuntimeOpts(remat=False, **gather),
                               **kw),
                  Scheduler(ct, pt, TT.RuntimeOpts(**gather), device="cpu",
                            **kw),
                  Scheduler(ct, pt, OPTS_Q, device="cpu", **kw)):
        rids = []
        for i, (p, (_, mn)) in enumerate(zip(prompts, JOBS)):
            key = dict(prefix_key="head", prefix_len=6) if i in (0, 3, 4) \
                else {}
            rids.append(sched.submit(p, mn, **key))
        results = sched.run()
        events = sorted(tuple(e[:4]) for e in sched.drain_events())
        runs.append(([results[r] for r in rids], events, sched))
    (want, want_ev, _), (got, got_ev, sched), (kern, _, _) = runs
    for g, w, k in zip(got, want, kern):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(k, w)
    np.testing.assert_allclose([e[3] for e in got_ev],
                               [e[3] for e in want_ev], **LP_TOL)
    assert sched.stats.prefix_forks >= 1
    assert sched.pool.pages_in_use == 0


def _uncapped_windows(cfg):
    """gemma2's config with its sliding windows removed (the pool refuses
    windows, in both packages), its soft caps kept."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(ls, mixer=dataclasses.replace(
            ls.mixer, sliding_window=None)) for ls in cfg.pattern))


def test_soft_capped_config_serves_through_the_pool():
    """gemma2 tiny without its windows (logit soft caps on every layer,
    a final soft cap) through the chunked paged scheduler: its prefill
    chunks and decode steps gather the pool dense, as the reference's
    ``_gather_dense_kv`` route: the reference's streams, logprobs within
    1e-4, every page back. The packed tick refuses soft caps in both."""
    cj = _uncapped_windows(jax_config("gemma2-2b").tiny())
    ct = _uncapped_windows(get_config("gemma2-2b").tiny())
    assert all(ls.mixer.attn_softcap for ls in ct.pattern)
    pj = JT.init_params(cj, jax.random.PRNGKey(0), jnp.float32)
    pt = from_jax_params(jax.tree.map(np.asarray, pj))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, ct.vocab_size, (n,)) for n, _ in JOBS]
    kw = dict(num_pages=24, page_size=4, max_slots=3, prefill_chunk=4)
    runs = []
    for sched in (JaxScheduler(cj, pj, JOPTS_Q, **kw),
                  Scheduler(ct, pt, OPTS_Q, device="cpu", **kw)):
        rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, JOBS)]
        results = sched.run()
        events = sorted(tuple(e[:4]) for e in sched.drain_events())
        runs.append(([results[r] for r in rids], events, sched))
    (want, want_ev, _), (got, got_ev, sched) = runs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose([e[3] for e in got_ev],
                               [e[3] for e in want_ev], **LP_TOL)
    assert sched.pool.pages_in_use == 0
    for make in (lambda: JaxScheduler(cj, pj, JOPTS_Q, tick_mode="packed",
                                      **kw),
                 lambda: Scheduler(ct, pt, OPTS_Q, device="cpu",
                                   tick_mode="packed", **kw)):
        sched = make()
        sched.submit(prompts[0], 2)
        with pytest.raises(NotImplementedError, match="kernel-eligible"):
            sched.run()


@pytest.mark.parametrize("route", ["prefill", "decode"])
def test_dense_gather_layers_match_reference(route):
    """The layer routes alone on a random pool (4 rows over 6-page tables
    of 4 slots, G 6, soft cap 30): ``paged_prefill_attention`` with
    ``use_kernel=False`` over history below each row's first call
    position (with the cap and without; a left pad's row compared where
    it is real), and ``paged_decode_attention_layer`` with a soft cap over
    rows of 1 and 3 columns, both against the reference's functions."""
    rng = np.random.default_rng(5)
    r, kh, g, hd, page, nb, npages = 4, 2, 6, 32, 4, 6, 30
    spec_t = dataclasses.replace(
        small_config(get_config("qwen2-vl-2b")).pattern[0].mixer,
        attn_softcap=30.0)
    spec_j = dataclasses.replace(
        small_config(jax_config("qwen2-vl-2b")).pattern[0].mixer,
        attn_softcap=30.0)
    k = rng.integers(-127, 128, (npages, kh, page, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (npages, kh, page, hd)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (npages, kh, page)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (npages, kh, page)).astype(np.float32)
    bt = rng.permutation(np.arange(1, npages))[:r * nb].reshape(r, nb) \
        .astype(np.int32)
    lens = [13, 0, 21, 7]
    pool_pos = np.full((npages, page), -1, np.int32)
    for row, n in enumerate(lens):
        for p in range(n + 3):
            pool_pos[bt[row, p // page], p % page] = p
    s = 3 if route == "prefill" else 1
    qpos = np.stack([np.arange(n, n + s) for n in lens]).astype(np.int32)
    qpos[1, 0] = -1  # a left pad
    q = rng.normal(size=(r, s, kh * g, hd)).astype(np.float32)
    kf = rng.normal(size=(r, s, kh, hd)).astype(np.float32)
    vf = rng.normal(size=(r, s, kh, hd)).astype(np.float32)
    jc = JL.PagedKVCache(*(jnp.asarray(a) for a in (k, v, ks, vs, pool_pos,
                                                     bt)))
    tc = TL.PagedKVCache(*(torch.as_tensor(a) for a in (k, v, ks, vs,
                                                         pool_pos, bt)))
    if route == "prefill":
        specs = ((spec_j, spec_t), (dataclasses.replace(
            spec_j, attn_softcap=None), dataclasses.replace(
            spec_t, attn_softcap=None)))
        for sj, st in specs:
            want = JL.paged_prefill_attention(
                jnp.asarray(q), jc, jnp.asarray(kf), jnp.asarray(vf), sj,
                jnp.asarray(qpos), q_chunk=8, kv_chunk=8, use_kernel=False)
            got = TL.paged_prefill_attention(
                torch.as_tensor(q), tc, torch.as_tensor(kf),
                torch.as_tensor(vf), st, torch.as_tensor(qpos), q_chunk=8,
                kv_chunk=8, use_kernel=False)
            # a pad query has no valid key: its output is never read, and
            # the two chunked walks average it over different pads
            real = qpos >= 0
            np.testing.assert_allclose(got.numpy()[real],
                                       np.asarray(want)[real],
                                       rtol=1e-5, atol=1e-5)
        return
    for cols in (1, 3):
        qp = np.stack([np.arange(n, n + cols) for n in lens]) \
            .astype(np.int32)
        qq = rng.normal(size=(r, cols, kh * g, hd)).astype(np.float32)
        want = JL.paged_decode_attention_layer(jnp.asarray(qq), jc, spec_j,
                                               jnp.asarray(qp), q_chunk=8,
                                               kv_chunk=8)
        got = TL.paged_decode_attention_layer(torch.as_tensor(qq), tc,
                                              spec_t, torch.as_tensor(qp),
                                              q_chunk=8, kv_chunk=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
