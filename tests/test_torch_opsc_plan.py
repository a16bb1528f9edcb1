"""The rest of the paper's split method on the port, against the JAX
package on the same seeded numpy inputs: the Table 3 weight baselines of
``core/quant.py`` (group-wise, int4 packing, SmoothQuant-, OmniQuant- and
Atom-lite), the uniform activation quantization ``RuntimeOpts.act_bits``
through the ``Engine``, the chunked ``Scheduler`` and the ``SplitEngine``,
OPSC fronts of 9 to 15 bits (int16 codes through K7's plain version),
``repro_torch.data.pipeline``, and Eq. 8's planner
(``examples/split_inference_torch.py``) on the committed induction
vehicle."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import quant as JQ
from repro.core.opsc import OPSCConfig as JOPSC
from repro.core.split_optimizer import SplitSearchSpace as JSpace
from repro.core.split_optimizer import optimize_split as jax_optimize_split
from repro.data import pipeline as JP
from repro.kernels.dequant_matmul import dequant_matmul as jax_dequant_matmul
from repro.models import transformer as JT
from repro.serving.engine import Engine as JaxEngine
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.split_engine import SplitEngine as JaxSplitEngine
from repro_torch.configs import get_config
from repro_torch.core import quant as Q
from repro_torch.core.opsc import OPSCConfig
from repro_torch.data import pipeline as P
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import SplitEngine

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# logprobs across frameworks: f32 log-softmax of logits that agree to ~1e-5
LP_TOL = dict(rtol=1e-4, atol=1e-4)
# an integer-code front against the reference's fake-quantized one
# (tests/test_torch_split_engine.py): code × scale is rounded in the
# reference's weight and not in K7's product
LP_TOL_QUANT_FRONT = dict(rtol=0, atol=1e-2)
# f32 sums in another order than the Pallas kernel's, relative to the
# largest output (tests/test_torch_split_kernels.py)
K7_REL = 1e-5
# logprobs of runs that quantize every layer's output (act_bits) over many
# positions: where a value sits on a rounding boundary of AIQ (or of the
# int8 KV cache) and the two frameworks' f32 values differ in the last
# bit, its code lands one step apart (1/127 of a token's range at 8 bits)
# and moves later logprobs by up to about 1e-3; tests/test_torch_ssm.py
# holds jamba's int8 keys at the same 5e-3
LP_TOL_CODES = dict(rtol=1e-4, atol=5e-3)
# TAB-Q's measured bits of a split whose state AIQ has put on a grid: a
# token's TAB-Q width turns on the last bit of a level and may land one
# step apart (the split-layer states part by about 1e-6 across frameworks)
BITS_REL = 2e-2


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _ulps(a, b) -> int:
    """The largest distance in f32 ulps between two f32 arrays."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


_MODELS: dict = {}


def _model(name):
    """(reference config, reference params, port config, port params) of
    ``name``'s tiny config, ``init_params(PRNGKey(0))`` carried across."""
    if name not in _MODELS:
        cj, ct = jax_config(name).tiny(), get_config(name).tiny()
        pj = JT.init_params(cj, jax.random.PRNGKey(0))
        _MODELS[name] = (cj, pj, ct, from_jax_params(
            jax.tree.map(np.asarray, pj)))
    return _MODELS[name]


def _opts(quantized=True, **kw):
    kw = dict(q_chunk=16, kv_chunk=16, quantized_kv=quantized,
              moe_capacity_factor=0.0, **kw)
    return JT.RuntimeOpts(remat=False, **kw), TT.RuntimeOpts(**kw)


# ------------------------------------------------- the Table 3 baselines


def _weight(din, dout, seed):
    """A weight with a few loud input channels (the outliers Atom keeps)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(din, dout)).astype(np.float32)
    w[rng.choice(din, 3, replace=False)] *= 20.0
    return w


@pytest.mark.parametrize("din", [256, 300, 100])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_groupwise_equals_reference(bits, group, din):
    """Codes and the per-row repeated group scales bit for bit, a ragged
    in-dim (padded to whole groups) included."""
    w = _weight(din, 48, din + group + bits)
    want = JQ.quantize_groupwise(jnp.asarray(w), bits, group)
    got = Q.quantize_groupwise(_t(w), bits, group)
    assert got.codes.dtype == torch.int8 and got.shape == (din, 48)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale.shape == (din, 48) and got.nbytes == want.nbytes


@pytest.mark.parametrize("n", [1, 7, 64, 101])
def test_pack_int4_equals_reference_and_round_trips(n):
    """Two codes a byte, the first in the low nibble, an odd length padded
    with a zero nibble; unpacking gives the codes back, signs included."""
    codes = np.random.default_rng(n).integers(-7, 8, (n,)).astype(np.int8)
    packed = Q.pack_int4(_t(codes))
    want = JQ.pack_int4(jnp.asarray(codes))
    assert packed.dtype == torch.uint8 and packed.numel() == -(-n // 2)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    back = Q.unpack_int4(packed, n)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JQ.unpack_int4(want, n)))
    np.testing.assert_array_equal(back.numpy(), codes)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bits", [4, 8])
def test_smoothquant_lite_equals_reference(bits, seed):
    """The smoothing vector within 2 ulps of the reference's, the per-tensor
    codes equal and their scale within 2 ulps. The reference's f32 power is
    XLA's, the CPU libm's ``powf``, which is not correctly rounded (it
    parts from the correctly rounded power by an ulp now and then); the
    port rounds an f64 power once, so each power may part by an ulp and
    their quotient by two."""
    w = _weight(256, 64, seed)
    act = np.abs(np.random.default_rng(seed + 10).normal(
        size=256)).astype(np.float32) * 5
    qa, sa = JQ.smoothquant_lite(jnp.asarray(w), jnp.asarray(act), bits)
    qt, st = Q.smoothquant_lite(_t(w), _t(act), bits)
    assert _ulps(st.numpy(), sa) <= 2
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(qa.codes))
    assert _ulps(qt.scale.numpy(), qa.scale) <= 2


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bits", [4, 8])
def test_omniquant_lite_equals_reference(bits, seed):
    """The clipping ratio each row keeps, hence its codes and scale, equal
    the reference's bit for bit (its mean squared error may part by an
    ulp; on these seeds no row's choice does)."""
    w = _weight(64, 200, seed)
    want = JQ.omniquant_lite(jnp.asarray(w), bits)
    got = Q.omniquant_lite(_t(w), bits)
    assert got.codes.dtype == torch.int8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("din,group", [(256, 128), (300, 32)])
def test_atom_lite_and_dequant_equal_reference(din, group):
    """The outlier mask, both code sets (group-wise int4 in an int8
    carrier, and per-row int8) and the dequantized weight, bit for bit."""
    w = _weight(din, 64, din)
    lj, oj, mj = JQ.atom_lite(jnp.asarray(w), group=group)
    lt, ot, mt = Q.atom_lite(_t(w), group=group)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(mt.sum()) >= max(1, int(din / 128))
    for got, want in ((lt, lj), (ot, oj)):
        assert got.codes.dtype == torch.int8
        np.testing.assert_array_equal(got.codes.numpy(),
                                      np.asarray(want.codes))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
    assert int(lt.codes.abs().max()) <= 7
    np.testing.assert_array_equal(
        Q.dequant_atom(lt, ot, mt).numpy(),
        np.asarray(JQ.dequant_atom(lj, oj, mj)))


# ------------------------------------- act_bits: uniform activation quant


@pytest.mark.parametrize("act_bits", [4, 8])
@pytest.mark.parametrize("name", ["llama2-7b", "h2o-danube-3-4b",
                                  "mamba2-780m"])
def test_engine_act_bits_matches_reference(name, act_bits):
    """AIQ after every layer (attention, sliding-window and Mamba-2
    layers, int8 KV): the reference Engine's greedy tokens, logprobs within
    LP_TOL, and different logits than without the option."""
    cj, pj, ct, pt = _model(name)
    prompts = np.random.default_rng(5).integers(0, ct.vocab_size, (2, 12))
    oj, ot = _opts(act_bits=act_bits)
    want = JaxEngine(cj, pj, oj, cache_len=32).generate(prompts, 8)
    got = Engine(ct, pt, ot, cache_len=32, device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_allclose(got.logprobs, np.asarray(want.logprobs),
                               **LP_TOL)
    plain = Engine(ct, pt, _opts()[1], cache_len=32,
                   device="cpu").generate(prompts, 8)
    assert not np.array_equal(plain.logprobs, got.logprobs)


def test_fake_quant_tokens_is_the_reference_aiq():
    """The layer's fake-quant: AIQ per token over the f32 view and back,
    cast to x's dtype, bit for bit the reference's on bf16 input."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 5, 64)) * 3).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    codes, s, z = JQ.aiq(xb.reshape(10, 64).astype(jnp.float32), 4, axis=-1)
    want = JQ.aiq_dequant(codes, s, z).reshape(2, 5, 64).astype(jnp.bfloat16)
    got = TT._fake_quant_tokens(_t(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16), 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("act_bits", [4, 8])
def test_scheduler_act_bits_matches_reference(act_bits):
    """The chunked Scheduler (multi-chunk prompts, a prefix fork) with
    act_bits: the reference scheduler's streams, logprobs within
    LP_TOL_CODES."""
    cj, pj, ct, pt = _model("llama2-7b")
    rng = np.random.default_rng(act_bits)
    prefix = rng.integers(0, ct.vocab_size, (9,))
    prompts = [rng.integers(0, ct.vocab_size, (n,)) for n in (11, 6)]
    prompts += [np.concatenate([prefix, rng.integers(0, ct.vocab_size, (n,))])
                for n in (4, 3)]
    max_new = [5, 6, 4, 5]
    oj, ot = _opts(act_bits=act_bits)
    kw = dict(num_pages=40, page_size=4, max_slots=2, prefill_chunk=4)
    runs = []
    for sched in (JaxScheduler(cj, pj, oj, **kw),
                  Scheduler(ct, pt, ot, device="cpu", **kw)):
        rids = [sched.submit(p, mn, prefix_key="sys" if i >= 2 else None,
                             prefix_len=9 if i == 2 else None)
                for i, (p, mn) in enumerate(zip(prompts, max_new))]
        results = sched.run()
        events = sorted((e[0], e[1], e[2], e[3])
                        for e in sched.drain_events())
        runs.append(([results[r] for r in rids], events))
    (want, want_ev), (got, got_ev) = runs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert [e[:3] for e in got_ev] == [e[:3] for e in want_ev]
    np.testing.assert_allclose([e[3] for e in got_ev],
                               [e[3] for e in want_ev], **LP_TOL_CODES)


def _split_pair(name, opsc_kw, opts_kw, prompts, n, compress,
                quantized=True):
    """The same split call on the reference and on the port (CPU):
    ((tokens, stats, logprobs), (tokens, stats, logprobs), port engine)."""
    cj, pj, ct, pt = _model(name)
    oj, ot = _opts(quantized, **opts_kw)
    want = JaxSplitEngine(cj, pj, JOPSC(split_layer=1, **opsc_kw), opts=oj,
                          cache_len=64).generate(prompts, n,
                                                 compress=compress,
                                                 with_logprobs=True)
    eng = SplitEngine(ct, pt, OPSCConfig(split_layer=1, **opsc_kw), opts=ot,
                      cache_len=64, device="cpu")
    return want, eng.generate(prompts, n, compress=compress,
                              with_logprobs=True), eng


@pytest.mark.parametrize("act_bits,compress", [(4, False), (8, False),
                                               (8, True)])
def test_split_engine_act_bits_matches_reference(act_bits, compress):
    """act_bits on both halves of the split (int4 front, int8 KV): the
    reference's tokens, Eq. 3 and measured uplink bits, and logprobs.
    Uncompressed, the bits are equal. With TS + TAB-Q payloads the
    split-layer state sits on AIQ's grid, where TAB-Q's choice of a
    token's width turns on the last bit of a level, so the measured bits
    are held within BITS_REL (at 4 bits a width's step then parts the
    tokens too: 4 bits is held uncompressed only)."""
    prompts = np.random.default_rng(3).integers(0, 256, (2, 8))
    want, got, _ = _split_pair("llama2-7b", dict(qw_front=4),
                               dict(act_bits=act_bits), prompts, 8, compress)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    if compress:
        assert got[1].uplink_bits_measured == pytest.approx(
            want[1].uplink_bits_measured, rel=BITS_REL)
    else:
        assert got[1].uplink_bits_measured == want[1].uplink_bits_measured
    assert got[1].uplink_bits_eq3 == want[1].uplink_bits_eq3
    np.testing.assert_allclose(got[2], np.asarray(want[2]),
                               **LP_TOL_QUANT_FRONT)


# ---------------------------------------- OPSC fronts of 9 to 15 bits


@pytest.mark.parametrize("bits", [9, 12, 15])
def test_split_wide_front_codes_and_tokens_match_reference(bits):
    """qw_front from 9 to 15: the edge holds int16 codes equal to the
    reference's ``quantize_sym`` codes (int32 there) with its scales, the
    split gives the reference's tokens and measured bits, logprobs within
    LP_TOL_QUANT_FRONT, and ``edge_weight_bytes`` counts two bytes a
    code."""
    cj, pj, ct, pt = _model("llama2-7b")
    prompts = np.random.default_rng(3).integers(0, ct.vocab_size, (2, 8))
    want, got, eng = _split_pair("llama2-7b", dict(qw_front=bits), {},
                                 prompts, 8, True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1].uplink_bits_measured == want[1].uplink_bits_measured
    np.testing.assert_allclose(got[2], np.asarray(want[2]),
                               **LP_TOL_QUANT_FRONT)
    codes_bytes = 0
    quant = {k: v for k, v in eng.edge_params.items()
             if isinstance(v, Q.QuantizedTensor)}
    assert len(quant) == 7
    for key, qt in quant.items():
        *path, leaf = key[len("blocks/p0/"):].split("/")
        node = pj["blocks"]["p0"]
        for part in path:
            node = node[part]
        x = node[leaf][:1]
        ref = JQ.quantize_sym(x.reshape(1, -1, x.shape[-1]), bits, axis=-2)
        assert qt.codes.dtype == torch.int16 and ref.codes.dtype == jnp.int32
        np.testing.assert_array_equal(qt.codes.numpy(),
                                      np.asarray(ref.codes))
        np.testing.assert_array_equal(qt.scale.numpy(),
                                      np.asarray(ref.scale))
        assert int(qt.codes.abs().max()) == 2 ** (bits - 1) - 1
        codes_bytes += qt.codes.numel() * 2 + qt.scale.numel() * 4
    norms = sum(v.numel() * v.element_size()
                for k, v in eng.edge_params.items()
                if k.startswith("blocks/") and k not in quant)
    assert eng.edge_weight_bytes() == codes_bytes + norms


@pytest.mark.parametrize("bits", [12, 15])
@pytest.mark.parametrize("mnk", [(128, 128, 512), (256, 128, 1024),
                                 (128, 256, 512), (8, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_plain_int16_matches_pallas_kernel(mnk, dtype, bits):
    """K7's plain version on int16 codes equals the Pallas kernel (interpret
    mode) on the same codes carried in int32, which it widens to f32 in
    its tile as the int8 ones, on ``tests/test_kernels.py``'s grid."""
    m, n, k = mnk
    rng = np.random.default_rng(m + n + bits)
    qmax = 2 ** (bits - 1) - 1
    x = (rng.normal(size=(m, k)) * 3).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    codes = rng.integers(-qmax, qmax + 1, (k, n)).astype(np.int32)
    scale = rng.uniform(1e-5, 1e-3, (n,)).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jax_dequant_matmul(xj, jnp.asarray(codes),
                                         jnp.asarray(scale),
                                         block_m=min(128, m),
                                         interpret=True))
    got = dm.dequant_matmul_ref(_t(x).to(getattr(torch, dtype)),
                                _t(codes.astype(np.int16)), _t(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=K7_REL * np.abs(want).max())


@pytest.mark.parametrize("m", [1, 4, 5, 96, 128, 192, 384, 600])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_route_on_int16_codes_never_takes_the_tensor_cores(m, x_dtype):
    """int16 codes take the GEMV up to 4 rows and the CUDA cores above,
    at every alignment; int8 codes at the same aligned bf16 shape take the
    tensor cores above 4 rows."""
    for n, k, at in ((4096, 4096, 0), (11008, 4096, 256), (60, 2048, 8)):
        got = dm.route(m, n, k, x_dtype, at, at, at, code_dtype=torch.int16)
        assert got == ("gemv" if m <= dm.GEMV_MAX_M else "cuda_cores")
    if m > dm.GEMV_MAX_M and x_dtype == torch.bfloat16:
        assert dm.route(m, 4096, 4096, x_dtype, 0, 0, 0).startswith(
            "tensor_cores")


@pytest.mark.parametrize("n,codes_at,scale_at,want", [
    (11008, 256, 512, 8), (4104, 0, 0, 8), (60, 0, 0, 4), (4100, 0, 0, 4),
    (4096, 8, 0, 4), (4096, 0, 4, 4), (4098, 0, 0, 1), (4096, 2, 0, 1)])
def test_gemv_vec_on_int16_codes(n, codes_at, scale_at, want):
    """Eight int16 codes a lane where N and both bases allow 16-byte loads
    (``gemv16_kernel``); else four by 8-byte loads; else one. A ragged N
    of a multiple of 4, as qwen2-moe's router (N 60), takes 8-byte
    loads."""
    assert dm.gemv_vec(n, codes_at, scale_at, 2) == want


@pytest.mark.parametrize("m,n,k", [(1, 4096, 4096), (1, 11008, 4096),
                                   (1, 4096, 11008), (4, 11008, 4096),
                                   (1, 1408, 2048)])
def test_gemv_plan_on_int16_codes_fills_the_sms(m, n, k):
    """The int16 GEMV's K ranges (256-column blocks) cover K with none
    empty, fill the SMs at least once, and stage their rows of x within
    the budget."""
    sms = 132
    mt, splits = dm.gemv_plan(m, n, k, 8, sms, 2)
    blocks = -(-n // 256) * -(-m // mt) * splits
    assert blocks >= sms or splits == k // dm.MIN_SPLIT_ROWS
    chunk = -(-k // splits)
    assert (splits - 1) * chunk < k <= splits * chunk
    assert chunk * 4 * mt <= dm.GEMV_STAGED_X


# ---------------------------------------------------- the data pipeline


@pytest.mark.parametrize("seed", [0, 3])
def test_induction_batch_and_zipf_markov_equal_reference(seed):
    """The copy task's tokens and loss mask, the Zipf–Markov chain's
    tables and samples and its entropy rate, for the same seeds."""
    for batch, seq, vocab in ((4, 33, 64), (3, 10, 17)):
        want = JP.induction_batch(np.random.default_rng(seed), batch, seq,
                                  vocab)
        got = P.induction_batch(np.random.default_rng(seed), batch, seq,
                                vocab)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    zj, zt = JP.ZipfMarkov(64, branching=4, seed=seed), \
        P.ZipfMarkov(64, branching=4, seed=seed)
    np.testing.assert_array_equal(zt.successors, zj.successors)
    np.testing.assert_array_equal(zt.probs, zj.probs)
    np.testing.assert_array_equal(
        zt.sample(np.random.default_rng(seed), 3, 20),
        zj.sample(np.random.default_rng(seed), 3, 20))
    assert zt.entropy_rate_bits() == zj.entropy_rate_bits()


def test_loaders_equal_reference():
    """Both prefetching loaders give the reference's batches (tokens,
    shifted labels, loss masks) in order, and then stop."""
    pairs = [(P.induction_loader(64, 4, 33, 3, seed=2),
              JP.induction_loader(64, 4, 33, 3, seed=2)),
             (P.lm_loader(P.ZipfMarkov(64, branching=4), 2, 12, 3),
              JP.lm_loader(JP.ZipfMarkov(64, branching=4), 2, 12, 3))]
    for got, want in pairs:
        got, want = list(got), list(want)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])
    b = P.make_batch(np.arange(6).reshape(2, 3))
    np.testing.assert_array_equal(b["loss_mask"], [[1, 1, 0], [1, 1, 0]])


# --------------------------------------------- Eq. 8's planner (example)


def _example():
    spec = importlib.util.spec_from_file_location(
        "split_inference_torch",
        os.path.join(ROOT, "examples", "split_inference_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def planned():
    """The example's plan on the CPU, and the reference's: its SplitEngine
    over the same prompts on the vehicle as ``benchmarks/common.py``
    restores it (``meta.msgpack`` exists, so nothing is trained), with an
    accuracy function memoized by (ℓ, ``qw_front``) as the example's."""
    from benchmarks.common import induction_vehicle

    ex = _example()
    cfg = ex.vehicle_config()
    params = ex.load_npz_checkpoint(ex.VEHICLE)
    prompts = ex.copy_prompts(cfg.vocab_size)
    got = ex.plan(cfg, params, prompts, "cpu")

    jcfg, jparams = induction_vehicle()
    jopts = JT.RuntimeOpts(q_chunk=64, kv_chunk=64, remat=False,
                           moe_capacity_factor=0.0)
    half = ex.HALF
    mono = JaxEngine(jcfg, jparams, jopts, cache_len=ex.CACHE_LEN)
    base = ex.copy_accuracy(np.asarray(mono.generate(
        prompts[:, :half + 1], half).tokens), prompts)
    accs = {}

    def acc_fn(opsc):
        key = (opsc.split_layer, opsc.qw_front)
        if key not in accs:
            eng = JaxSplitEngine(jcfg, jparams, opsc, opts=jopts,
                                 cache_len=ex.CACHE_LEN)
            sub = prompts[:ex.PLAN_PROMPTS]
            accs[key] = ex.copy_accuracy(np.asarray(eng.generate(
                sub[:, :half + 1], half)[0]), sub)
        return accs[key]

    mixer = jcfg.pattern[0].mixer
    sol = jax_optimize_split(
        num_layers=jcfg.num_layers,
        layer_param_counts=jcfg.layer_param_counts(),
        embed_params=jcfg.embed_params(),
        kv_heads_dim=mixer.num_kv_heads * mixer.head_dim, max_tokens=64,
        memory_budget_bytes=int(jcfg.total_params() * 0.9),
        accuracy_fn=acc_fn, base_accuracy=base, accuracy_drop=0.05,
        space=JSpace(split_layers=[1, 2, 3], qw_bits=(4, 8),
                     qa_bits=(4, 8)))
    scored = sorted(accs)
    for ell in (1, 2, 3):
        for qw in (4, 8):
            acc_fn(JOPSC(split_layer=ell, qw_front=qw))
    return ex, cfg, jcfg, got, {"base_accuracy": base, "accuracies": accs,
                                "scored": scored, "solution": sol}


def test_vehicle_config_and_weights_are_the_reference_vehicle(planned):
    """The example builds the reference's vehicle config from the port's
    configs, and reads the same weights."""
    ex, cfg, jcfg, _, _ = planned
    assert (cfg.d_model, cfg.vocab_size, cfg.num_blocks, cfg.num_layers) \
        == (jcfg.d_model, jcfg.vocab_size, jcfg.num_blocks, jcfg.num_layers)
    assert cfg.layer_param_counts() == jcfg.layer_param_counts()
    assert cfg.total_params() == jcfg.total_params()


def test_planner_accuracies_equal_reference(planned):
    """The monolithic copy accuracy and each (ℓ, qw_front) candidate's, the
    candidates the solver asked for and every other pair of the space,
    equal the reference SplitEngine's on the committed vehicle."""
    _, _, _, got, want = planned
    assert got["base_accuracy"] == want["base_accuracy"]
    assert got["scored"] == want["scored"]
    assert got["accuracies"] == want["accuracies"]
    assert len(got["accuracies"]) == 6


def test_planner_solution_equals_reference(planned):
    """``optimize_split``'s SplitSolution on the port equals the
    reference's, and satisfies its own budget and accuracy drop."""
    ex, cfg, _, got, want = planned
    sol, ref = got["solution"], want["solution"]
    assert sol is not None and ref is not None
    assert dataclasses.asdict(sol.config) == dataclasses.asdict(ref.config)
    assert (sol.psi, sol.memory_bytes, sol.accuracy) \
        == (ref.psi, ref.memory_bytes, ref.accuracy)
    assert sol.memory_bytes <= int(cfg.total_params() * ex.BUDGET_SHARE)
    assert sol.accuracy >= got["base_accuracy"] - ex.ACCURACY_DROP


def test_example_runs_on_the_cpu_and_imports_nothing_of_jax():
    """``examples/split_inference_torch.py --device cpu`` in a fresh
    process: its last line is the report, and neither ``jax`` nor the
    reference package was loaded."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['split_inference_torch.py', '--device', 'cpu']\n"
        f"runpy.run_path({os.path.join(ROOT, 'examples', 'split_inference_torch.py')!r},"
        " run_name='__main__')\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "BAD []"
    import json

    report = json.loads(lines[-2])
    assert report["solution"]["config"]["split_layer"] in (1, 2, 3)
    assert len(report["candidates"]) == 6
    assert report["early_exits"] == 0 and report["uplink_bits_measured"] > 0
