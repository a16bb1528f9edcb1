"""The port's split-path kernel modules against the JAX package: the plain
versions of K5 (``tabq_quantize``, and ``tabq_adaptive``: TAB-Q's whole
level walk), K6 (``ts_mask_ref``, the dense pass ``ts_encode_ref`` starts
from) and K7 (``dequant_matmul``), which the port
runs on the CPU and which the CUDA kernels are held against on the card,
against the Pallas kernels in interpret mode and the reference oracles, on
``tests/test_kernels.py``'s grids plus a one-token payload, bf16-origin
inputs with ties, and K tails that are no multiple of the TPU kernel's
512-row block; ``tabq_adaptive``'s plain version against the reference's
``tabq`` bit for bit at the payload shapes; the wrappers' refusals of CPU
tensors; the layers' quantized-weight product."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.payload import encode as jax_encode
from repro.core.tabq import tabq as jax_tabq
from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul as jax_dequant_matmul
from repro.kernels.tabq_kernel import tabq_quantize as jax_tabq_quantize
from repro.kernels.ts_mask import ts_mask as jax_ts_mask
from repro_torch.core import payload as tpayload
from repro_torch.core.quant import quantize_sym
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import ops
from repro_torch.kernels import tabq_quantize as tq
from repro_torch.kernels import ts_mask as tsm
from repro_torch.models import layers as TL

torch.set_num_threads(2)

SHAPES_TD = [(8, 128), (16, 256), (32, 384), (64, 128)]


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _rand(shape, dtype, seed=0, scale=3.0, outliers=0):
    """``tests/test_kernels.py``'s inputs as numpy f32 (bf16-rounded for
    bf16), plus the dtype to hand each framework."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32) * scale
    if outliers:
        flat = x.reshape(-1)
        idx = rng.choice(flat.size, outliers, replace=False)
        flat[idx] = 80.0 * np.sign(flat[idx])
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _both(x, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(x, jd), _t(x).to(getattr(torch, dtype))


# ------------------------------------------------------------------- K5


def _assert_tabq_equal(want, got):
    for name, w, g in zip(("codes", "scale", "zero", "sign"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES_TD + [(1, 4096), (3, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_tabq_plain_equals_pallas_kernel(shape, dtype, bits):
    """Codes, scales, zeros and signs bit for bit against the Pallas kernel
    (interpret mode; block_t = T where T divides no 8) and the oracle under
    jit, both of which take the scale's 1/qmax as a rounded reciprocal.
    bf16 inputs carry ties."""
    x = _rand(shape, dtype, seed=shape[0] + bits)
    xj, xt = _both(x, dtype)
    block_t = 8 if shape[0] % 8 == 0 else shape[0]
    got = tq.tabq_quantize_ref(xt, bits)
    _assert_tabq_equal(jax_tabq_quantize(xj, bits, block_t, interpret=True),
                       got)
    oracle = jax.jit(jref.tabq_quantize_ref, static_argnums=1)(xj, bits)
    _assert_tabq_equal(oracle, got)
    # the dequantized round trip is the oracle's
    np.testing.assert_array_equal(
        ((got[0].float() - got[2]) * got[1] * got[3]).numpy(),
        np.asarray(jref.tabq_dequantize_ref(*oracle)))


def test_tabq_plain_edge_rows():
    """A constant row (the scale floor 1e-8), an all-zero row and a row of
    one sign: still bit-identical to the Pallas kernel."""
    x = np.zeros((3, 64), np.float32)
    x[0] = 2.5
    x[2] = -np.linspace(0.1, 3.0, 64)
    got = tq.tabq_quantize_ref(_t(x), 5)
    _assert_tabq_equal(jax_tabq_quantize(jnp.asarray(x), 5, 3,
                                         interpret=True), got)
    assert float(got[1][1, 0]) == np.float32(1e-8)


def _payload_tokens(t, d, seed):
    """bf16-rounded activations of ``t`` tokens (ties in magnitude), token
    r with ``r % 4`` outliers at 30x (so that the tokens take different
    bit widths); token 0 of equal magnitudes (mixed signs) and token 1 of
    zeros where T > 2, else exact zeros in token 0's first entries."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d)).astype(np.float32) * 2.0
    for r in range(t):
        x[r, rng.choice(d, r % 4, replace=False)] *= 30.0
    if t > 2:
        x[0] = np.where(rng.random(d) < 0.5, -1.5, 1.5)
        x[1] = 0.0
        x[2, : d // 2] = 0.0
    else:
        x[0, :3] = 0.0
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("t", [1, 96, 128])
@pytest.mark.parametrize("max_bits", [2, 3, 4, 5, 6, 7, 8])
def test_tabq_adaptive_plain_equals_reference_tabq(t, max_bits):
    """``tabq_adaptive_ref`` (the level walk the CUDA kernel is held to on
    the card) equals the reference's ``tabq`` bit for bit at the payload
    shapes (D 4096): codes, sign, scale, zero and the chosen bits, for Δ
    0.05, 0.2 and 1.0, with a token of equal magnitudes and one of zeros.
    Over many tokens the chosen widths differ."""
    x = _payload_tokens(t, 4096, seed=t * 10 + max_bits)
    chosen = set()
    for delta in (0.05, 0.2, 1.0):
        want = jax_tabq(jnp.asarray(x), max_bits=max_bits, delta=delta)
        got = tq.tabq_adaptive_ref(_t(x), max_bits, delta)
        for name, g in zip(("codes", "sign", "scale", "zero", "bits"), got):
            np.testing.assert_array_equal(
                g.numpy(), np.asarray(getattr(want, name)),
                err_msg=f"{name} at delta {delta}")
        # the CPU entry point is the plain version
        assert all(torch.equal(a, b) for a, b in zip(
            got, ops.tabq_adaptive(_t(x), max_bits, delta)))
        chosen |= set(got[4].tolist())
    if max_bits > 3 and t > 1:
        assert len(chosen) > 1, chosen


@pytest.mark.parametrize("rows", ["equal_magnitudes", "zeros"])
def test_tabq_adaptive_plain_one_token_edge_rows(rows):
    """A decode payload (T 1, D 4096) whose token has equal magnitudes
    (the scale's 1e-8 floor: codes near 2^28, δ far above Δ, the top
    width) or is all zeros (every level's codes 0: the lowest width):
    bit-identical to the reference's ``tabq``."""
    rng = np.random.default_rng(4)
    x = np.where(rng.random((1, 4096)) < 0.5, -0.75, 0.75) \
        if rows == "equal_magnitudes" else np.zeros((1, 4096))
    x = x.astype(np.float32)
    for delta in (0.05, 0.2, 1.0):
        want = jax_tabq(jnp.asarray(x), max_bits=8, delta=delta)
        got = tq.tabq_adaptive_ref(_t(x), 8, delta)
        for name, g in zip(("codes", "sign", "scale", "zero", "bits"), got):
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)
    assert int(got[4][0]) == (8 if rows == "equal_magnitudes" else 3)


@pytest.mark.parametrize("t", [1, 96, 128])
def test_encode_payload_bits_unchanged_by_the_one_launch_walk(t):
    """The codec (TS, then TAB-Q through ``ops.tabq_adaptive``) at the
    split path's OPSC defaults gives the reference's payload bits, field
    for field, at a decode payload and the prefill payloads."""
    x = _payload_tokens(t, 4096, seed=t) * 2.0
    want = jax_encode(jnp.asarray(x), tau=5.0, delta=0.2, max_bits=8)
    got = tpayload.encode(_t(x), tau=5.0, delta=0.2, max_bits=8)
    for name in ("codes", "sign", "scale", "zero", "bits"):
        np.testing.assert_array_equal(getattr(got.below, name).numpy(),
                                      np.asarray(getattr(want.below, name)),
                                      err_msg=name)
    assert got.payload_bits() == int(want.payload_bits())


# ------------------------------------------------------------------- K6


@pytest.mark.parametrize("shape", SHAPES_TD + [(1, 4096)])
@pytest.mark.parametrize("tau", [1.0, 5.0, 50.0])
def test_ts_mask_plain_equals_pallas_kernel(shape, tau):
    """``below``, the mask and the count exactly; the port counts per row,
    the TPU kernel per tile of ``block_t`` rows."""
    x = _rand(shape, "float32", seed=int(tau) + shape[1], outliers=6)
    block_t = 8 if shape[0] % 8 == 0 else shape[0]
    below, mask, counts = tsm.ts_mask_ref(_t(x), tau)
    jb, jm, jc = jax_ts_mask(jnp.asarray(x), tau, block_t, interpret=True)
    np.testing.assert_array_equal(below.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        counts.reshape(-1, block_t).sum(-1).numpy(),
        np.asarray(jc).reshape(-1))
    rb, rm, rc = jref.ts_mask_ref(jnp.asarray(x), tau)
    np.testing.assert_array_equal(below.numpy(), np.asarray(rb))
    assert int(counts.sum()) == int(rc)


def test_ts_mask_plain_bf16_ties_at_tau():
    """bf16 input whose values sit exactly at τ: ``|x| >= τ`` in f32 keeps
    them above, as the reference does."""
    x = _rand((4, 256), "bfloat16", seed=3)
    x[0, :8] = 2.0
    x[1, :8] = -2.0
    xj, xt = _both(x, "bfloat16")
    below, mask, counts = tsm.ts_mask_ref(xt, 2.0)
    jb, jm, jc = jax_ts_mask(xj, 2.0, 4, interpret=True)
    np.testing.assert_array_equal(below.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    assert int(counts.sum()) == int(np.asarray(jc).sum())
    assert mask[0, :8].all() and mask[1, :8].all()


# ------------------------------------------------------------------- K7

# f32 sums in another order than the Pallas kernel's: relative to the
# largest output
K7_REL = 1e-5


@pytest.mark.parametrize("mnk", [(128, 128, 512), (256, 128, 1024),
                                 (128, 256, 512), (8, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_matmul_plain_matches_pallas_kernel(mnk, dtype):
    m, n, k = mnk
    rng = np.random.default_rng(m + n)
    x = _rand((m, k), dtype, seed=m)
    codes = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.1, (n,)).astype(np.float32)
    xj, xt = _both(x, dtype)
    got = dm.dequant_matmul_ref(xt, _t(codes), _t(scale)).numpy()
    want = np.asarray(jax_dequant_matmul(xj, jnp.asarray(codes),
                                         jnp.asarray(scale),
                                         block_m=min(128, m),
                                         interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=K7_REL * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(1, 1376, 64), (3, 344, 40),
                                   (5, 11008 // 16, 17)])
def test_dequant_matmul_plain_ragged_against_oracle(m, k, n):
    """K no multiple of 512 (llama2-7b's w_down has K = 11008 = 21.5·512),
    M = 1, odd N: shapes the TPU kernel refuses."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.001, 0.1, (n,)).astype(np.float32)
    got = ops.dequant_matmul(_t(x), _t(codes), _t(scale)).numpy()
    want = np.asarray(jref.dequant_matmul_ref(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scale)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=K7_REL * np.abs(want).max())


def test_quantized_weight_product_in_layers():
    """``layers.matmul`` over a ``QuantizedTensor`` (the edge segment's
    weights) is K7's plain version cast back to x's dtype, and close to the
    fake-quantized product the reference computes."""
    rng = np.random.default_rng(11)
    x = _t(rng.normal(size=(2, 3, 64)).astype(np.float32))
    w = _t(rng.normal(size=(64, 48)).astype(np.float32))
    qt = quantize_sym(w, 8, dim=-2)
    got = TL.matmul(x, qt)
    want = dm.dequant_matmul_ref(x.reshape(6, 64), qt.codes,
                                 qt.scale.reshape(48)).reshape(2, 3, 48)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    fake = x @ qt.dequantize()
    np.testing.assert_allclose(got.numpy(), fake.numpy(), rtol=0,
                               atol=1e-5 * float(fake.abs().max()))
    xb = x.to(torch.bfloat16)
    assert TL.matmul(xb, qt).dtype == torch.bfloat16
    assert torch.equal(TL.matmul(x, w), x @ w)


def test_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 64))
    before = (tq.tabq_quantize.launches, tq.tabq_adaptive.launches,
              tsm.ts_encode.launches, dm.dequant_matmul.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tq.tabq_quantize(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        tq.tabq_adaptive(x, 8, 0.2)
    with pytest.raises(ValueError, match="CUDA"):
        tsm.ts_encode(x, 1.0, 16)
    with pytest.raises(ValueError, match="CUDA"):
        dm.dequant_matmul(x, torch.zeros((64, 8), dtype=torch.int8),
                          torch.ones(8))
    assert (tq.tabq_quantize.launches, tq.tabq_adaptive.launches,
            tsm.ts_encode.launches, dm.dequant_matmul.launches) == before


@pytest.mark.parametrize("m,n,k,vec", [(1, 4096, 4096, 8), (1, 11008, 4096, 8),
                                       (1, 4096, 11008, 8), (4, 4096, 4096, 8),
                                       (3, 17, 100, 1), (1, 64, 64, 8),
                                       (1, 4096, 4096, 16),
                                       (1, 11008, 4096, 16),
                                       (1, 4096, 11008, 16),
                                       (4, 4096, 11008, 16),
                                       (2, 528, 200, 16)])
def test_gemv_plan_covers_k(m, n, k, vec):
    """The GEMV's K ranges cover K with none empty, each of at least
    ``MIN_SPLIT_ROWS`` rows when there is more than one."""
    mt, splits = dm.gemv_plan(m, n, k, vec, 132)
    assert mt == (1 if m == 1 else dm.GEMV_MAX_M)
    chunk = -(-k // splits)
    assert (splits - 1) * chunk < k <= splits * chunk
    assert splits == 1 or chunk >= dm.MIN_SPLIT_ROWS
