"""The port's model layers against the JAX package's on the same numpy
inputs: the int8 KV quantizer bit for bit, RMSNorm, RoPE, the cache write
layouts, position-masked prefill attention and the gated MLP."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

torch.set_num_threads(2)

# f32 layers compared across frameworks: same math, other operation order
F32 = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _kv_inputs(shape, scale, seed):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    # a row whose quotients are exact halves (amax 127 → scale 1): rounding
    # must go half to even, as jnp.round does; and an all-zero row
    half = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5],
                      np.float32)
    rows = x.reshape(-1, shape[-1])
    rows[0, :8] = half
    rows[0, 8:] = 0.0
    rows[1] = 0.0
    return x


@pytest.mark.parametrize("shape", [(2, 5, 2, 32), (1, 7, 4, 128)])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_kv_bit_identical(shape, scale):
    """Codes and scales equal the reference's bit for bit on the same f32
    inputs: the reference's dense↔paged parity rests on these codes."""
    x = _kv_inputs(shape, scale, seed=int(scale * 1000) % 97 + shape[1])
    jc, js = JL._quantize_kv(jnp.asarray(x))
    tc, ts = TL._quantize_kv(_t(x))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert list(tc.reshape(-1, shape[-1])[0, :8]) == \
        [127, 0, 2, 2, 0, -2, 126, -126]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=(64,)).astype(np.float32)
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(w), 1e-6)
    got = TL.rms_norm(_t(x).to(getattr(torch, dtype)), _t(w), 1e-6)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = F32 if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_jax(batched):
    """Tables and rotation (halves, not interleaved pairs), from (S,) or
    (B, S) positions."""
    rng = np.random.default_rng(1)
    pos = np.arange(3, 14, dtype=np.int32)
    if batched:
        pos = np.stack([pos, pos + 100])
    jcos, jsin = JL.rope_table(jnp.asarray(pos), 32, 10000.0)
    tcos, tsin = TL.rope_table(_t(pos), 32, 10000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), **F32)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), **F32)
    x = rng.normal(size=(2, pos.shape[-1], 4, 32)).astype(np.float32)
    want = JL.apply_rope(jnp.asarray(x), jcos, jsin)
    got = TL.apply_rope(_t(x), tcos, tsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_update_layout_matches_jax(quantized):
    """A prefill write at position 0 then a one-token write at position 6:
    every leaf (kv-head-major int8 codes and scales, or the token-major fp
    cache, and the slot positions) equals the reference's."""
    b, s, kh, hd = 2, 12, 2, 32
    rng = np.random.default_rng(2)
    k0, v0 = (rng.normal(size=(b, 6, kh, hd)).astype(np.float32)
              for _ in range(2))
    k1, v1 = (rng.normal(size=(b, 1, kh, hd)).astype(np.float32)
              for _ in range(2))
    jc = JL.init_cache(b, s, kh, hd, jnp.float32, quantized)
    jc = JL.cache_update(jc, jnp.asarray(k0), jnp.asarray(v0), jnp.int32(0))
    jc = JL.cache_update(jc, jnp.asarray(k1), jnp.asarray(v1), jnp.int32(6))
    tc = TL.init_cache(b, s, kh, hd, torch.float32, quantized)
    tc = TL.cache_update(tc, _t(k0), _t(v0), 0)
    tc = TL.cache_update(tc, _t(k1), _t(v1),
                         torch.tensor(6, dtype=torch.int32))
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        j, t = getattr(jc, name), getattr(tc, name)
        if j is None:
            assert t is None
            continue
        assert tuple(t.shape) == j.shape, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert tc.quantized == quantized
    assert list(tc.pos[0]) == list(range(7)) + [-1] * 5


@pytest.mark.parametrize("sq,q_chunk,kv_chunk", [(20, 1024, 1024),
                                                 (20, 4, 8), (7, 3, 5)])
def test_chunked_attention_matches_jax(sq, q_chunk, kv_chunk):
    """Causal, position-masked prefill attention with GQA (G = 2), some
    keys invalid (pos -1), single-block and multi-chunk walks whose chunks
    do not divide S. Every query keeps one valid key: for a query with
    none, the reference's chunked walk also averages over its pad keys."""
    b, h, kh, hd = 2, 4, 2, 32
    rng = np.random.default_rng(sq + q_chunk)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, sq, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, sq, kh, hd)).astype(np.float32)
    pos = np.tile(np.arange(sq, dtype=np.int32), (b, 1))
    kv_pos = pos.copy()
    kv_pos[1, 1:3] = -1
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(pos), jnp.asarray(kv_pos),
                                q_chunk=q_chunk, kv_chunk=kv_chunk)
    got = TL.chunked_attention(_t(q), _t(k), _t(v), _t(pos), _t(kv_pos),
                               q_chunk=q_chunk, kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_layer_matches_jax(activation, gated):
    """SiLU and GELU (the reference's ``jax.nn.gelu``, whose default is the
    tanh approximation: the exact erf form misses by 4e-4 here),
    gated and not."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32)
    p = {"w_up": rng.normal(size=(64, 96)).astype(np.float32) / 8,
         "w_gate": rng.normal(size=(64, 96)).astype(np.float32) / 8,
         "w_down": rng.normal(size=(96, 64)).astype(np.float32) / 10}
    if not gated:
        del p["w_gate"]
    want = JL.mlp_layer({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), activation)
    got = TL.mlp_layer({k: _t(v) for k, v in p.items()}, _t(x), activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
