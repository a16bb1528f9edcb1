"""The port's decode-attention kernel module against the JAX package: the
plain version (what the port runs on the CPU, and what the CUDA kernel is
held against on the card) against the Pallas kernel in interpret mode and
the reference oracle, on the reference tests' shape grid; the cache
length rounding; the wrapper's refusals; and, on a card with JAX, the
CUDA kernel against the oracle (``tests/test_torch_cuda.py`` tests it on a
card without JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnSpec
from repro.kernels import ref as jref
from repro.kernels.decode_attention import padded_cache_len as jax_padded
from repro.kernels.ops import decode_attention as jax_decode_attention
from repro.models import layers as JL
from repro_torch.kernels import build, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.models import layers as TL

torch.set_num_threads(2)

# the reference tests' tolerance for the kernel against its oracle: f32
# math in another summation order
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _filled_caches(rng, b, kh, hd, s, fill):
    """The same int8 cache written by both packages' ``cache_update``."""
    k_new = rng.normal(size=(b, fill, kh, hd)).astype(np.float32)
    v_new = rng.normal(size=(b, fill, kh, hd)).astype(np.float32)
    jc = JL.cache_update(JL.init_cache(b, s, kh, hd, quantized=True),
                         jnp.asarray(k_new), jnp.asarray(v_new), jnp.int32(0))
    tc = TL.cache_update(TL.init_cache(b, s, kh, hd, quantized=True),
                         _t(k_new), _t(v_new), 0)
    return jc, tc


@pytest.mark.parametrize("h,kh", [(4, 2), (6, 1), (4, 4)])  # K<H and K=H
@pytest.mark.parametrize("s,fill", [(96, 96), (80, 50), (600, 450)])
def test_decode_attention_matches_jax(h, kh, s, fill):
    """``quantized_decode_attention`` (cache_update + the decode kernel
    module) against the JAX package's, whose kernel runs in interpret mode,
    and against the oracle. S = 600 is no multiple of the TPU kernel's
    512-slot block, which pads it."""
    b, hd = 2, 32
    rng = np.random.default_rng(h * 100 + s)
    jc, tc = _filled_caches(rng, b, kh, hd, s, fill)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    spec = AttnSpec(num_heads=h, num_kv_heads=kh, head_dim=hd)
    want = JL.quantized_decode_attention(jnp.asarray(q), jc, spec, None,
                                         jnp.int32(fill - 1))
    got = TL.quantized_decode_attention(
        _t(q), tc, spec, None, torch.tensor(fill - 1, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    qh = q[:, 0].reshape(b, kh, h // kh, hd)
    oracle = jref.decode_attention_ref(jnp.asarray(qh), jc.k, jc.k_scale, jc.v,
                                       jc.v_scale, jc.pos, jnp.int32(fill - 1))
    np.testing.assert_allclose(got[:, 0].reshape(b, kh, h // kh, hd).numpy(),
                               np.asarray(oracle), **TOL)


def _raw_inputs(rng, b, kh, g, hd, s):
    q = rng.normal(size=(b, kh, g, hd)).astype(np.float32)
    kc = rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    return q, kc, ks, vc, vs, pos


def test_decode_attention_fully_masked_row_matches_jax():
    """A row with no valid slot returns the uniform average of its v, as
    the TPU kernel does (masked scores are -1e30, not -inf)."""
    b, kh, g, hd, s = 2, 2, 2, 32, 96
    q, kc, ks, vc, vs, pos = _raw_inputs(np.random.default_rng(7), b, kh, g,
                                         hd, s)
    pos[1] = -1  # row 1: an empty cache
    args = (q, kc, ks, vc, vs, pos)
    want = jax_decode_attention(*map(jnp.asarray, args), jnp.int32(50))
    got = ops.decode_attention(*map(_t, args), torch.tensor(50, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    uniform = (vc[1].astype(np.float32) * vs[1][..., None]).mean(axis=1)
    np.testing.assert_allclose(got[1].numpy(),
                               np.broadcast_to(uniform[:, None], (kh, g, hd)),
                               **TOL)


def test_decode_attention_per_row_q_pos_matches_oracle():
    """q_pos may be one position per row, (B,) on the device, which the
    reference oracle also takes."""
    b, kh, g, hd, s = 3, 2, 3, 64, 40
    args = _raw_inputs(np.random.default_rng(8), b, kh, g, hd, s)
    q_pos = np.asarray([5, 39, -1], np.int32)  # row 2 fully masked
    want = jref.decode_attention_ref(*map(jnp.asarray, args),
                                     jnp.asarray(q_pos))
    got = ops.decode_attention(*map(_t, args), _t(q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "s", [1, 5, 16, 40, 127, 128, 129, 511, 512, 513, 600, 1024, 4097])
def test_padded_cache_len_matches_jax(s):
    assert da.padded_cache_len(s) == jax_padded(s)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The CUDA wrapper never falls back to the plain version: CPU tensors
    are refused before anything is built."""
    args = _raw_inputs(np.random.default_rng(9), 1, 1, 1, 32, 8)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(*map(_t, args), torch.tensor(3, dtype=torch.int32))
    assert build.library_path("decode_attention").parent == build.BUILD_DIR
    assert (build.CSRC / "decode_attention.cu").is_file()


@pytest.mark.parametrize("name", build.KERNELS)
def test_shared_header_is_in_every_kernels_key(name, tmp_path, monkeypatch):
    """A source that includes ``common.cuh`` is built with ``-I csrc``, and
    an edit of the header changes every kernel's library name, so nothing
    stale is loaded after it (no nvcc needed: only hashes and commands)."""
    src = (build.CSRC / f"{name}.cu").read_text()
    assert '#include "common.cuh"' in src
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    cmd = build.nvcc_command(tmp_path / "x.so", tmp_path / f"{name}.cu")
    assert cmd[cmd.index("-I") + 1] == str(build.CSRC)
    before = build.source_hash(name)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.source_hash(name) == before
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text()
                                     + "\n// edited\n")
    assert build.source_hash(name) != before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_jax_oracle(cuda_device):
    """On a card with JAX installed: the CUDA kernel itself against the
    reference oracle, on the reference tests' grid (G = 2, 6, 1; full,
    partial and non-block-multiple caches)."""
    for h, kh in ((4, 2), (6, 1), (4, 4)):
        for s, fill in ((96, 96), (80, 50), (600, 450)):
            args = list(_raw_inputs(np.random.default_rng(h + s), 2, kh,
                                    h // kh, 32, s))
            args[5][:, fill:] = -1
            # the oracle on JAX's CPU backend: in full f32, as elsewhere
            with jax.default_device(jax.devices("cpu")[0]):
                want = jref.decode_attention_ref(*map(jnp.asarray, args),
                                                 jnp.int32(fill - 1))
            got = ops.decode_attention(
                *[_t(a).to(cuda_device) for a in args],
                torch.tensor(fill - 1, dtype=torch.int32, device=cuda_device))
            np.testing.assert_allclose(got.cpu().numpy(), np.asarray(want),
                                       **TOL)
