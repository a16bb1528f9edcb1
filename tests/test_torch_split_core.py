"""The port's split-path core modules against the JAX package on the same
numpy inputs: ``core.quant`` (AIQ, symmetric weight quantization), ``ts``
(threshold split, capacity overflow, bf16-origin ties), ``tabq``
(Algorithm 1), ``payload`` (the codec and its bit accounting), ``opsc``
(Eq. 1-3 and the front-segment fake quantization), ``channel``,
``early_exit`` (Algorithm 2, the Eq. 12 solver) and ``split_optimizer``
(Eq. 8). Codes, bit widths, counts and payload bits are held exactly; a
carrier's indices are held in order, which the reference sets (ties to
the lower index)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import channel as TC
from repro_torch.core import early_exit as TE
from repro_torch.core import opsc as TO
from repro_torch.core import payload as TP
from repro_torch.core import quant as TQ
from repro_torch.core import split_optimizer as TS
from repro_torch.core import tabq as TT
from repro_torch.core import ts as TTS
from repro_torch.params import from_jax_params

# the reference package's __init__ rebinds some module names to functions
JC = importlib.import_module("repro.core.channel")
JE = importlib.import_module("repro.core.early_exit")
JO = importlib.import_module("repro.core.opsc")
JP = importlib.import_module("repro.core.payload")
JQ = importlib.import_module("repro.core.quant")
JS = importlib.import_module("repro.core.split_optimizer")
JT = importlib.import_module("repro.core.tabq")
JTS = importlib.import_module("repro.core.ts")

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(shape, seed, scale=3.0, bf16=False, outliers=0):
    """Activations as f32 numpy; ``bf16`` rounds them to bf16 first (the
    split engine's payload input is a bf16 hidden state cast to f32, so
    equal magnitudes are common)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * scale
    if outliers:
        flat = x.reshape(-1)
        flat[rng.choice(flat.size, outliers, replace=False)] *= 40.0
    if bf16:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


# --------------------------------------------------------------- quant


@pytest.mark.parametrize("bits", [2, 4, 7, 8])
@pytest.mark.parametrize("dim", [-1, None])
def test_aiq_bit_identical(bits, dim):
    x = np.abs(_x((9, 96), bits, bf16=bits == 4))
    want = JQ.aiq(jnp.asarray(x), bits, axis=dim)
    got = TQ.aiq(_t(x), bits, dim=dim)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(TQ.aiq_dequant(*got).numpy(),
                                  np.asarray(JQ.aiq_dequant(*want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits,axis", [(4, -2), (8, -2), (4, -1), (8, None),
                                       (12, -2)])
def test_quantize_sym_bit_identical(dtype, bits, axis):
    """Codes and scales of the bridged weights equal the reference's bit
    for bit, in the weights' own dtype (the edge segment's quantizer)."""
    w = _x((3, 64, 48), 5, scale=0.05)
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = from_jax_params({"w": np.asarray(jw)})["w"]
    want = JQ.quantize_sym(jw, bits, axis=axis)
    got = TQ.quantize_sym(tw, bits, dim=axis)
    assert got.codes.dtype == (torch.int8 if bits <= 8 else torch.int32)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        got.dequantize().numpy(), np.asarray(want.dequantize()))
    assert got.nbytes == want.nbytes
    assert torch.equal(got[1].codes, got.codes[1])
    assert torch.equal(got[1].scale, got.scale[1] if axis is not None
                       else got.scale)


# ------------------------------------------------------------------ TS


def _assert_ts_equal(want, got):
    (jb, ja), (tb, ta) = want, got
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))  # values
    np.testing.assert_array_equal(ta.indices.numpy(), np.asarray(ja.indices))
    np.testing.assert_array_equal(ta.values.numpy(), np.asarray(ja.values))
    assert int(ta.count) == int(ja.count)
    assert ta.csr_bytes() == int(ja.csr_bytes())


@pytest.mark.parametrize("shape,tau,capacity,bf16", [
    ((1, 4096), 5.0, 16, False),  # a decode payload
    ((8, 384), 2.0, 64, True),  # ties in magnitude
    ((8, 384), 1.0, 16, True),  # far more outliers than capacity
    ((4, 256), 0.5, 16, False),  # overflow without ties
    ((3, 100), 50.0, 16, False),  # nothing above
])
def test_ts_encode_bit_identical(shape, tau, capacity, bf16):
    x = _x(shape, shape[1], bf16=bf16, outliers=5)
    want = JTS.ts_encode(jnp.asarray(x), tau, capacity)
    got = TTS.ts_encode(_t(x), tau, capacity)
    _assert_ts_equal(want, got)
    np.testing.assert_array_equal(TTS.ts_decode(got[1]).numpy(),
                                  np.asarray(JTS.ts_decode(want[1])))
    below = np.asarray(want[0])
    np.testing.assert_array_equal(
        TTS.reconstruct(_t(below), got[1]).numpy(),
        np.asarray(JTS.reconstruct(jnp.asarray(below), want[1])))


def test_ts_ties_keep_lower_indices():
    """|x| = [1,3,3,2,3,1,3]: ``jax.lax.top_k`` orders the tied 3s by index
    (``torch.topk`` does not); past capacity the higher-index 3s stay in
    ``below``."""
    x = np.array([[1, 3, -3, 2, 3, -1, 3]], np.float32)
    for cap in (4, 2):
        _assert_ts_equal(JTS.ts_encode(jnp.asarray(x), 2.5, cap),
                         TTS.ts_encode(_t(x), 2.5, cap))
    below, above = TTS.ts_encode(_t(x), 2.5, 2)
    assert above.indices.tolist() == [1, 2] and int(above.count) == 4
    assert below.tolist() == [[1, 0, 0, 2, 3, -1, 3]]


def test_split_dense_matches():
    x = _x((4, 64), 1)
    for w, g in zip(JTS.split_dense(jnp.asarray(x), 2.0),
                    TTS.split_dense(_t(x), 2.0)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------- TAB-Q


@pytest.mark.parametrize("shape,bf16", [((1, 4096), True), ((16, 384), False),
                                        ((6, 100), True)])
@pytest.mark.parametrize("max_bits,delta", [(8, 0.2), (6, 0.05), (4, 0.5),
                                            (2, 0.2)])
def test_tabq_bit_identical(shape, bf16, max_bits, delta):
    """Every field, the chosen bit widths and the payload bits equal the
    reference's: the levels run through K5's plain version."""
    x = _x(shape, max_bits, bf16=bf16)
    x[0, :3] = 0.0  # exact zeros: sign 0
    want = JT.tabq(jnp.asarray(x), max_bits=max_bits, delta=delta)
    got = TT.tabq(_t(x), max_bits=max_bits, delta=delta)
    for name in ("codes", "sign", "scale", "zero", "bits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.payload_bits() == int(want.payload_bits())
    np.testing.assert_array_equal(got.dequantize().numpy(),
                                  np.asarray(want.dequantize()))


def test_tabq_bits_vary_per_token():
    """Tokens of different spread take different widths, as in the
    reference."""
    rng = np.random.default_rng(2)
    x = np.stack([rng.normal(size=256) * s for s in (0.01, 1.0, 30.0)]
                 ).astype(np.float32)
    x[2, :4] = 300.0
    want = JT.tabq(jnp.asarray(x), 8, 0.2)
    got = TT.tabq(_t(x), 8, 0.2)
    np.testing.assert_array_equal(got.bits.numpy(), np.asarray(want.bits))


@pytest.mark.parametrize("bits", [3, 5, 8])
def test_tabq_fixed_bit_identical(bits):
    x = _x((5, 200), bits, bf16=True)
    want = JT.tabq_fixed(jnp.asarray(x), bits)
    got = TT.tabq_fixed(_t(x), bits)
    for name in ("codes", "sign", "scale", "zero", "bits"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


# ------------------------------------------------------------- payload


@pytest.mark.parametrize("shape,bf16,outliers", [((1, 4096), True, 0),
                                                 ((1, 4096), True, 40),
                                                 ((12, 512), False, 30),
                                                 ((7, 128), True, 300)])
@pytest.mark.parametrize("fixed_bits", [None, 4])
def test_payload_bit_identical(shape, bf16, outliers, fixed_bits):
    """The codec on the same f32 input: codes, sign, scale, zero, bits,
    carrier, count and payload bits equal; decode equal."""
    x = _x(shape, outliers + 1, bf16=bf16, outliers=outliers)
    want = JP.encode(jnp.asarray(x), tau=5.0, delta=0.2, max_bits=8,
                     fixed_bits=fixed_bits)
    got = TP.encode(_t(x), tau=5.0, delta=0.2, max_bits=8,
                    fixed_bits=fixed_bits)
    for name in ("codes", "sign", "scale", "zero", "bits"):
        np.testing.assert_array_equal(getattr(got.below, name).numpy(),
                                      np.asarray(getattr(want.below, name)))
    np.testing.assert_array_equal(got.above.indices.numpy(),
                                  np.asarray(want.above.indices))
    np.testing.assert_array_equal(got.above.values.numpy(),
                                  np.asarray(want.above.values))
    assert int(got.above.count) == int(want.above.count)
    assert got.payload_bits() == int(want.payload_bits())
    np.testing.assert_array_equal(TP.decode(got).numpy(),
                                  np.asarray(JP.decode(want)))
    np.testing.assert_allclose(TP.entropy_bound_bits(got.below),
                               float(JP.entropy_bound_bits(want.below)),
                               rtol=1e-5)


# ---------------------------------------------------------------- OPSC


def test_opsc_models_equal():
    counts = [1000 + 10 * i for i in range(12)]
    for ell in (1, 4, 11):
        for qw, qb in ((4, 16), (8, 8)):
            assert TO.weight_memory_bytes(counts, ell, qw, qb) == \
                JO.weight_memory_bytes(counts, ell, qw, qb)
            assert TO.edge_weight_memory_bytes(counts, ell, qw, 500) == \
                JO.edge_weight_memory_bytes(counts, ell, qw, 500)
        for w in (1, 17, 1024):
            for i_kv in (0, 1):
                assert TO.payload_bytes(w, ell, 12, 256, 512, 4, 16, i_kv) \
                    == JO.payload_bytes(w, ell, 12, 256, 512, 4, 16, i_kv)
        assert TO.kv_cache_bytes_shared(64, [80, 100], ell, 12, 256, 8, 8) \
            == JO.kv_cache_bytes_shared(64, [80, 100], ell, 12, 256, 8, 8)
    assert TO.ssm_state_bytes(3, 1000, 8) == JO.ssm_state_bytes(3, 1000, 8)
    with pytest.raises(ValueError):
        TO.kv_cache_bytes_shared(64, [10], 1, 12, 256, 8, 8)
    assert TO.OPSCConfig(split_layer=3) == TO.OPSCConfig(
        **vars(JO.OPSCConfig(split_layer=3)))


def test_quantize_front_params_bit_identical():
    from repro.configs import get_config as jax_config
    from repro.models import transformer as JTr

    jparams = JTr.init_params(jax_config("llama2-7b-tiny"),
                              jax.random.PRNGKey(0))
    want = from_jax_params(jax.tree.map(np.asarray, JO.quantize_front_params(
        jparams, 1, 4, num_blocks=2)))
    got = TO.quantize_front_params(
        from_jax_params(jax.tree.map(np.asarray, jparams)), 1, 4,
        num_blocks=2)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------- channel, ladder, Eq. 8


def test_channel_model_equal():
    cfg = TC.ChannelConfig()
    jcfg = JC.ChannelConfig()
    assert TC.optimal_rate(cfg) == JC.optimal_rate(jcfg)
    for r in (1e5, 3e7, 1.5e8):
        assert TC.outage_probability(r, cfg) == JC.outage_probability(r, jcfg)
        assert TC.g(r, cfg) == JC.g(r, jcfg)
        assert TC.worst_case_latency(1e5, r, cfg) == \
            JC.worst_case_latency(1e5, r, jcfg)
    lat = TC.LatencyModel(cfg, TC.optimal_rate(cfg), 1e-4)
    jlat = JC.LatencyModel(jcfg, JC.optimal_rate(jcfg), 1e-4)
    assert lat.total_latency(10, 4, 3e5) == jlat.total_latency(10, 4, 3e5)


@pytest.mark.parametrize("deadline", [1e-1, 1e-2, 3e-3, 1e-3, 1e-5])
def test_early_exit_ladder_equal(deadline):
    cfg, jcfg = TC.ChannelConfig(), JC.ChannelConfig()
    lat = TC.LatencyModel(cfg, TC.optimal_rate(cfg), 1e-4)
    jlat = JC.LatencyModel(jcfg, JC.optimal_rate(jcfg), 1e-4)
    op = TO.OPSCConfig(split_layer=8)
    jop = JO.OPSCConfig(split_layer=8)
    got = TE.EarlyExitController(
        op, lat, deadline, 32,
        TE.default_payload_bits_fn(op, 32, 4096, 4096)).decide(64)
    want = JE.EarlyExitController(
        jop, jlat, deadline, 32,
        JE.default_payload_bits_fn(jop, 32, 4096, 4096)).decide(64)
    assert vars(got) == vars(want)


def _bits_fn(w, ell, i_kv, compressed):
    return w * 4096 * 8.0 / (4.0 if compressed else 1.0)


@pytest.mark.parametrize("deadline,compute_s", [(0.01, 1e-4), (0.2, 1e-4),
                                                (0.15, 1e-3), (1.0, 10.0)])
def test_depth_objective_equal(deadline, compute_s):
    cfg, jcfg = TC.ChannelConfig(), JC.ChannelConfig()
    lat = TC.LatencyModel(cfg, TC.optimal_rate(cfg), compute_s)
    jlat = JC.LatencyModel(jcfg, JC.optimal_rate(jcfg), compute_s)
    assert TE.solve_depth_objective(lat, _bits_fn, deadline, 128, 16) == \
        JE.solve_depth_objective(jlat, _bits_fn, deadline, 128, 16)


def test_optimize_split_equal():
    def acc(c):
        return 0.9 - 0.01 * (16 - c.qw_front) / 4 - 0.002 * c.split_layer

    kw = dict(num_layers=8, layer_param_counts=[10_000] * 8,
              embed_params=5_000, kv_heads_dim=64, max_tokens=256,
              memory_budget_bytes=400_000, accuracy_fn=acc,
              base_accuracy=0.9, accuracy_drop=0.05)
    got = TS.optimize_split(**kw)
    want = JS.optimize_split(**kw)
    assert (got.config, got.psi, got.memory_bytes, got.accuracy) == \
        (TO.OPSCConfig(**vars(want.config)), want.psi, want.memory_bytes,
         want.accuracy)
    assert TS.psi(8, 3, 4, 16) == JS.psi(8, 3, 4, 16)
