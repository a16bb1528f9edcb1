"""The grouped- and multi-query configs in the port against the JAX package
on bridged weights: internlm2-20b (48 query heads on 8 kv heads, G 6) and
granite-34b (48 on one, G 48, an ungated GELU MLP, tied embeddings) at
small widths with their real group sizes (``ArchConfig.tiny()`` gives G 2
and G 4): teacher-forced logits, the ``Engine``'s and the fused server's
streams, the paged scheduler's chunked and packed streams and the split
engine's tokens and counts (int8 edge codes through K7's plain
version), and the launcher."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.opsc import OPSCConfig as JOPSC
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
from repro_torch.params import from_jax_params
from repro_torch.serving.api import LLMServer
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import SplitEngine

torch.set_num_threads(2)

# f32 logits across frameworks (tests/test_torch_model.py's tolerance)
REL = 1e-4
LP_TOL = dict(rtol=1e-4, atol=1e-4)
STAT_FIELDS = ("tokens_generated", "uplink_bits_measured", "uplink_bits_eq3",
               "latency_s", "early_exits", "kv_dropped_steps",
               "uplink_bits_paged", "cloud_pool_bytes_peak",
               "shared_prefix_pages", "uplink_round_trips")
# tests/test_scheduler.py:34's jobs, (prompt length, max new tokens)
JOBS = [(5, 6), (8, 3), (3, 9), (6, 4), (2, 7)]
# the query heads a kv head of each config at full width
GROUPS = {"internlm2-20b": 6, "granite-34b": 48}


def small_config(cfg, num_blocks=2):
    """``cfg`` at ``tiny()``'s widths (d_model 128, d_ff 256, vocab 256,
    head dim 32) with its full-width group size kept: 12 query heads on 2
    kv heads for internlm2 (G 6), 48 on 1 for granite (G 48). The same
    function of either package's config gives the same config in both."""
    m = cfg.pattern[0].mixer
    g = m.num_heads // m.num_kv_heads
    kv = 2 if g < 12 else 1
    pattern = tuple(dataclasses.replace(
        ls, mixer=dataclasses.replace(ls.mixer, num_heads=g * kv,
                                      num_kv_heads=kv, head_dim=32),
        ffn=dataclasses.replace(ls.ffn, d_ff=256)) for ls in cfg.pattern)
    return dataclasses.replace(cfg, name=cfg.name + "-small", d_model=128,
                               vocab_size=256, pattern=pattern,
                               num_blocks=num_blocks)


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
NAMES = list(GROUPS)


def test_small_configs_keep_the_full_width_group():
    """The small configs keep internlm2's G 6 and granite's G 48 (and
    granite's ungated GELU), where ``tiny()`` gives G 2 and G 4."""
    for name, g in GROUPS.items():
        full = get_config(name).pattern[0].mixer
        assert full.num_heads // full.num_kv_heads == g
        m = small_config(get_config(name)).pattern[0].mixer
        assert m.num_heads // m.num_kv_heads == g
        tiny = get_config(name).tiny().pattern[0].mixer
        assert tiny.num_heads // tiny.num_kv_heads != g
    f = get_config("granite-34b").pattern[0].ffn
    assert (f.gated, f.activation) == (False, "gelu")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("name", NAMES)
def test_teacher_forced_logits_match_reference(name, quantized):
    """A 20-token prefill at B 2 and 8 decode steps fed the same tokens
    (with the int8 cache the decode attention at G 6 or G 48 is K1's
    plain version against the reference's Pallas kernel): logits within
    REL at every step, each step from the reference's caches carried
    across (tests/test_torch_families.py says why)."""
    cj, pj, ct, pt = _model(name)
    toks = np.random.default_rng(0).integers(0, ct.vocab_size,
                                             (2, 28)).astype(np.int32)
    kw = dict(KW, quantized_kv=quantized,
              cache_dtype="bfloat16" if quantized else "float32")
    oj, ot = JT.RuntimeOpts(remat=False, **kw), TT.RuntimeOpts(**kw)
    lj, cjs = JT.prefill(pj, cj, jnp.asarray(toks[:, :20]), None, 28, oj)
    lt, cts = TT.prefill(pt, ct, torch.as_tensor(toks[:, :20]), 28, ot)
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
def test_engine_and_fused_server_streams_match_reference_engine(name):
    """Greedy streams (int8 KV, 12-token prompts, 10 new tokens): the
    port's ``Engine`` equals the reference ``Engine``, logprobs within
    1e-4; ``LLMServer(backend="fused")`` gives the Engine's."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(9).integers(0, ct.vocab_size, (3, 12))
    want = JaxEngine(cj, pj, JOPTS_Q, cache_len=32).generate(prompts, 10)
    got = Engine(ct, pt, OPTS_Q, cache_len=32, device="cpu").generate(
        prompts, 10)
    np.testing.assert_array_equal(got.tokens, want.tokens[:, :22])
    np.testing.assert_allclose(got.logprobs,
                               np.asarray(want.logprobs)[:, :10], **LP_TOL)
    srv = LLMServer(ct, pt, OPTS_Q, backend="fused", cache_len=32,
                    device="cpu")
    rids = [srv.submit(p, SamplingParams(max_tokens=10)) for p in prompts]
    outs = srv.run()
    np.testing.assert_array_equal(np.stack([outs[r].tokens for r in rids]),
                                  got.tokens[:, 12:])


@pytest.mark.parametrize("tick_mode", ["chunked", "packed"])
@pytest.mark.parametrize("name", NAMES)
def test_schedulers_match_reference_scheduler(name, tick_mode):
    """tests/test_scheduler.py:34's five jobs through three slots of one
    pool (mid-stream admission; K2, K3 and K4 at G 6 or G 48 through their
    plain versions), a chunk budget of 4: the streams equal the reference
    ``Scheduler``'s, logprobs within 1e-4, the same decode steps, and
    every page comes back."""
    cj, pj, ct, pt = _model(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, ct.vocab_size, (n,)) for n, _ in JOBS]
    kw = dict(num_pages=24, page_size=4, max_slots=3, tick_mode=tick_mode,
              prefill_chunk=4)
    runs = []
    for sched in (JaxScheduler(cj, pj, JOPTS_Q, **kw),
                  Scheduler(ct, pt, OPTS_Q, device="cpu", **kw)):
        rids = [sched.submit(p, mn) for p, (_, mn) in zip(prompts, JOBS)]
        results = sched.run()
        events = sorted((e[0], e[1], e[2], e[3])
                        for e in sched.drain_events())
        runs.append(([results[r] for r in rids], events, sched))
    (want, want_ev, jsched), (got, got_ev, sched) = runs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [e[:3] for e in got_ev] == [e[:3] for e in want_ev]
    np.testing.assert_allclose([e[3] for e in got_ev],
                               [e[3] for e in want_ev], **LP_TOL)
    assert sched.stats.steps == jsched.stats.steps
    assert sched.pool.pages_in_use == 0


@pytest.mark.parametrize("compress", [True, False], ids=["tsq", "raw"])
@pytest.mark.parametrize("name,qw_front", [("granite-34b", 4),
                                           ("granite-34b", 8),
                                           ("internlm2-20b", 4)])
def test_split_engine_matches_reference(name, qw_front, compress):
    """The split at layer 1 (block 0's projections as int8 codes: granite's
    ungated GELU ``w_up``, its one kv head's ``wk``/``wv``), int8 KV: the
    tokens and every ``SplitStats`` count equal the reference's; Eq. 3
    counts the one kv head's width on granite."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(2).integers(0, ct.vocab_size, (2, 20))
    want = JaxSplitEngine(cj, pj, JOPSC(split_layer=1, qw_front=qw_front),
                          opts=JOPTS_Q, cache_len=48).generate(
        prompts, 6, compress=compress)
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=1, qw_front=qw_front),
                      opts=OPTS_Q, cache_len=48, device="cpu")
    got = eng.generate(prompts, 6, compress=compress)
    np.testing.assert_array_equal(got[0], want[0])
    for f in STAT_FIELDS:
        assert getattr(got[1], f) == getattr(want[1], f), f
    if name == "granite-34b":
        assert "blocks/p0/ffn/w_gate" not in eng.edge_params


@pytest.mark.parametrize("split", [False, True], ids=["engine", "split"])
@pytest.mark.parametrize("name", NAMES)
def test_launcher_serves_the_gqa_configs(name, split, capsys):
    """The launcher serves internlm2 and granite tiny on the CPU through
    the Engine and the split engine."""
    argv = ["--arch", name, "--tiny", "--batch", "2", "--prompt-len", "10",
            "--new", "4", "--quantized-kv", "--device", "cpu"]
    serve.main(argv + (["--split", "--qw-front", "4"] if split else []))
    out = capsys.readouterr().out
    assert ("[serve/split]" if split else "[serve]") in out
