"""The port's paged kernel modules against the JAX package: the plain
versions of paged decode attention (K2) and paged prefill attention (K3),
which the port runs on the CPU and holds the CUDA kernels against on the
card, against the Pallas kernels in interpret mode and the reference
oracles, on the reference tests' grids; ``first_call_position``; the
pool scatter ``paged_cache_update`` bit for bit; the model's paged
attention routes; and the CUDA wrappers' refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnSpec
from repro.kernels import ref as jref
from repro.kernels.ops import paged_decode_attention as jax_paged_decode
from repro.kernels.ops import paged_prefill_attention as jax_paged_prefill
from repro.kernels.paged_prefill_attention import \
    first_call_position as jax_first_call_position
from repro.models import layers as JL
from repro_torch.kernels import build, ops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.models import layers as TL

torch.set_num_threads(2)

# the reference tests' tolerance for a kernel against its oracle: f32 math
# in another summation order
TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _pool(rng, p=10, kh=2, page=16, hd=32, lens=(40, 20, 10)):
    """``tests/test_paged_decode.py``'s hand-built pool: request r holds
    ``lens[r]`` tokens in consecutive pages from 1; page 0 is trash."""
    kc = rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (p, kh, page)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (p, kh, page)).astype(np.float32)
    maxb = max(-(-n // page) for n in lens)
    bt = np.zeros((len(lens), maxb), np.int32)
    pool_pos = np.full((p, page), -1, np.int32)
    nxt = 1
    for r, n in enumerate(lens):
        for b in range(-(-n // page)):
            bt[r, b] = nxt
            nxt += 1
        for t in range(n):
            pool_pos[bt[r, t // page], t % page] = t
    return kc, ks, vc, vs, pool_pos, bt


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("g,kh", [(2, 2), (4, 1), (1, 2)])
@pytest.mark.parametrize("lens", [(40, 20, 10), (16, 16, 16), (31, 1, 7)])
def test_paged_decode_matches_jax(g, kh, lens):
    """``tests/test_paged_decode.py``'s grid: the plain version against the
    Pallas kernel (interpret mode) and the paged oracle."""
    rng = np.random.default_rng(g * 10 + sum(lens))
    pool = _pool(rng, kh=kh, lens=lens)
    q = rng.normal(size=(len(lens), kh, g, 32)).astype(np.float32)
    q_pos = np.asarray([n - 1 for n in lens], np.int32)
    args = (q, *pool, q_pos)
    got = ops.paged_decode_attention(*map(_t, args)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_paged_decode(*map(jnp.asarray, args))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.paged_decode_attention_ref(
            *map(jnp.asarray, args))), **TOL)


def test_paged_decode_free_slot_row_is_exact_zero():
    """A free decode slot (all-trash table, q_pos = -1) and a row whose
    pages hold no valid key give exact zeros, as the Pallas kernel's
    ``seen`` guard does; the oracle does not model this row."""
    rng = np.random.default_rng(7)
    kc, ks, vc, vs, pool_pos, bt = _pool(rng)
    bt = np.vstack([bt[:1], np.zeros((2, bt.shape[1]), np.int32)])
    q = rng.normal(size=(3, 2, 2, 32)).astype(np.float32)
    q_pos = np.asarray([39, -1, 12], np.int32)  # row 2: trash pages only
    args = (q, kc, ks, vc, vs, pool_pos, bt, q_pos)
    got = ops.paged_decode_attention(*map(_t, args)).numpy()
    want = np.asarray(jax_paged_decode(*map(jnp.asarray, args)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1:], 0.0)
    np.testing.assert_array_equal(want[1:], 0.0)
    np.testing.assert_allclose(got[0], want[0], **TOL)


# ------------------------------------------------------------------ K3


def _prefill_case(rng, hist_lens, suf_lens, kh=2, g=2, page=4, hd=32,
                  p=16):
    """``tests/test_chunked_prefill.py``'s fixture: request r holds
    ``hist_lens[r]`` history tokens AND this call's ``suf_lens[r]`` tokens
    in its pages (the post-update pool), the call's tokens right-aligned
    from position ``hist_lens[r]``. JAX layout: q (R, K, S, G, hd), fresh
    (R, K, S, hd)."""
    totals = [h + s for h, s in zip(hist_lens, suf_lens)]
    kc, ks, vc, vs, pool_pos, bt = _pool(rng, p=p, kh=kh, page=page, hd=hd,
                                         lens=totals)
    r, s = len(hist_lens), max(suf_lens)
    q_pos = np.full((r, s), -1, np.int32)
    for i, (h, ns) in enumerate(zip(hist_lens, suf_lens)):
        q_pos[i, s - ns:] = np.arange(h, h + ns)
    q = rng.normal(size=(r, kh, s, g, hd)).astype(np.float32)
    kf = rng.normal(size=(r, kh, s, hd)).astype(np.float32)
    vf = rng.normal(size=(r, kh, s, hd)).astype(np.float32)
    return q, kc, ks, vc, vs, pool_pos, bt, q_pos, kf, vf


def _port_prefill(q, kc, ks, vc, vs, pool_pos, bt, q_pos, kf, vf):
    """The port's K3 entry in its (model) layout, returned in JAX's."""
    out = ops.paged_prefill_attention(
        _t(q.transpose(0, 2, 1, 3, 4)), _t(kc), _t(ks), _t(vc), _t(vs),
        _t(pool_pos), _t(bt), _t(q_pos), _t(kf.transpose(0, 2, 1, 3)),
        _t(vf.transpose(0, 2, 1, 3)))
    return out.numpy().transpose(0, 2, 1, 3, 4)


@pytest.mark.parametrize("g,kh", [(2, 2), (4, 1), (1, 2)])
@pytest.mark.parametrize("hist,suf", [
    ((9, 5, 0), (4, 6, 3)),    # ragged, non-aligned trailing pages
    ((8, 8, 8), (4, 4, 4)),    # page-aligned shared-prefix forks
    ((13, 0, 1), (2, 7, 5)),   # long fork / plain / 1-token history
])
def test_paged_prefill_matches_jax(g, kh, hist, suf):
    """``tests/test_chunked_prefill.py``'s grid: the plain version against
    the Pallas kernel (interpret mode) and the oracle; pad query columns
    give exact zeros."""
    rng = np.random.default_rng(g * 100 + sum(hist) + sum(suf))
    args = _prefill_case(rng, hist, suf, kh=kh, g=g)
    got = _port_prefill(*args)
    jargs = tuple(map(jnp.asarray, args))
    np.testing.assert_allclose(got, np.asarray(jax_paged_prefill(*jargs)),
                               **TOL)
    start = jax_first_call_position(jargs[7])
    np.testing.assert_allclose(
        got, np.asarray(jref.paged_prefill_attention_ref(
            *jargs[:8], start, *jargs[8:])), **TOL)
    s = args[7].shape[1]
    for i, ns in enumerate(suf):
        np.testing.assert_array_equal(got[i, :, : s - ns], 0.0)


def test_paged_prefill_multiple_q_blocks_and_padded_rows():
    """The Pallas kernel with q_block 2 (several query blocks) against the
    plain version, with a fully padded row (an inactive row of a
    fixed-shape chunk call): that row gives exact zeros."""
    rng = np.random.default_rng(3)
    args = list(_prefill_case(rng, (9, 5, 0), (7, 6, 3)))
    args[7][2] = -1  # row 2 fully padded
    got = _port_prefill(*args)
    want = np.asarray(jax_paged_prefill(*map(jnp.asarray, args), q_block=2))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_array_equal(want[2], 0.0)


@pytest.mark.parametrize("q_pos", [
    [[-1, -1, 4, 5], [0, 1, 2, 3], [-1, -1, -1, -1]],
    [[7, 8, 9, 10], [-1, -1, -1, 2]]])
def test_first_call_position_matches_jax(q_pos):
    q_pos = np.asarray(q_pos, np.int32)
    np.testing.assert_array_equal(
        ppa.first_call_position(_t(q_pos)).numpy(),
        np.asarray(jax_first_call_position(jnp.asarray(q_pos))))


# ------------------------------------------------------- pool scatter


@pytest.mark.parametrize("positions,table", [
    # ragged right-aligned prefill with pads and a non-aligned tail
    ([[-1, -1, 0, 1, 2, 3], [0, 1, 2, 3, 4, 5], [5, 6, 7, 8, 9, 10]],
     [[1, 2, 0], [3, 4, 0], [5, 6, 7]]),
    # positions past the table's reach, and pages not yet allocated
    ([[0, 1, 11, 12, 40, -1], [4, 5, 6, 7, 8, 9], [-1, -1, -1, -1, -1, 0]],
     [[1, 0, 0], [2, 0, 0], [0, 0, 0]]),
    # decode: one token per row, a free slot at -1
    ([[6], [-1], [9]], [[1, 2, 0], [0, 0, 0], [3, 4, 5]]),
])
def test_paged_cache_update_bit_identical_to_jax(positions, table):
    """Codes, scales and positions of every page equal the reference's
    scatter bit for bit (pads, out-of-reach and unallocated positions go to
    the trash page with pos -1)."""
    rng = np.random.default_rng(11)
    positions = np.asarray(positions, np.int32)
    bt = np.asarray(table, np.int32)
    p, kh, page, hd = 8, 2, 4, 32
    r, s = positions.shape
    k = rng.normal(size=(r, s, kh, hd)).astype(np.float32)
    v = rng.normal(size=(r, s, kh, hd)).astype(np.float32)
    jc = JL.PagedKVCache(
        jnp.zeros((p, kh, page, hd), jnp.int8),
        jnp.zeros((p, kh, page, hd), jnp.int8),
        jnp.zeros((p, kh, page), jnp.float32),
        jnp.zeros((p, kh, page), jnp.float32),
        jnp.full((p, page), -1, jnp.int32), jnp.asarray(bt))
    jc = JL.paged_cache_update(jc, jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(positions))
    tc = TL.PagedKVCache(
        torch.zeros((p, kh, page, hd), dtype=torch.int8),
        torch.zeros((p, kh, page, hd), dtype=torch.int8),
        torch.zeros((p, kh, page)), torch.zeros((p, kh, page)),
        torch.full((p, page), -1, dtype=torch.int32), _t(bt))
    TL.paged_cache_update(tc, _t(k), _t(v), _t(positions))
    # the trash page's codes are whichever pad write won; its positions
    # stay -1 on both sides
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        want = np.asarray(getattr(jc, name))
        got = getattr(tc, name).numpy()
        np.testing.assert_array_equal(got[1:], want[1:], err_msg=name)
    np.testing.assert_array_equal(tc.pos.numpy()[0], -1)


# --------------------------------------------------- model-level routes


def test_paged_attention_layers_match_jax():
    """The model's paged routes on the same post-update pool: a forked
    prefill through ``paged_prefill_attention``, a ragged decode and a
    two-column verify through ``paged_decode_attention_layer``, against
    the reference's."""
    rng = np.random.default_rng(13)
    h, kh, hd = 4, 2, 32
    spec = AttnSpec(num_heads=h, num_kv_heads=kh, head_dim=hd)
    _, kc, ks, vc, vs, pool_pos, bt, q_pos, kf, vf = _prefill_case(
        rng, (9, 0, 4), (5, 6, 2), kh=kh, g=h // kh)
    s = q_pos.shape[1]
    q = rng.normal(size=(3, s, h, hd)).astype(np.float32)
    kf, vf = kf.transpose(0, 2, 1, 3), vf.transpose(0, 2, 1, 3)
    jc = JL.PagedKVCache(*map(jnp.asarray, (kc, vc, ks, vs, pool_pos, bt)))
    tc = TL.PagedKVCache(*map(_t, (kc, vc, ks, vs, pool_pos, bt)))
    want = JL.paged_prefill_attention(jnp.asarray(q), jc, jnp.asarray(kf),
                                      jnp.asarray(vf), spec,
                                      jnp.asarray(q_pos))
    got = TL.paged_prefill_attention(_t(q), tc, _t(kf), _t(vf), spec,
                                     _t(q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dec_pos = np.asarray([[13], [-1], [5]], np.int32)
    want = JL.paged_decode_attention_layer(jnp.asarray(q[:, -1:]), jc, spec,
                                           jnp.asarray(dec_pos))
    got = TL.paged_decode_attention_layer(_t(q[:, -1:]), tc, spec,
                                          _t(dec_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # S = 2, the speculative verify: each column one K2 query row (the
    # plain version here) against the reference's dense gather and
    # chunked attention
    ver_pos = np.ascontiguousarray(q_pos[:, -2:])
    want = JL.paged_decode_attention_layer(jnp.asarray(q[:, -2:]), jc, spec,
                                           jnp.asarray(ver_pos))
    got = TL.paged_decode_attention_layer(_t(q[:, -2:]), tc, spec,
                                          _t(ver_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------- wrapper refusals


def test_cuda_wrappers_refuse_cpu_tensors_and_wrong_types():
    """The CUDA wrappers never fall back to the plain versions: CPU tensors
    are refused before anything is built, and so are inputs of a type or
    shape the kernels do not take."""
    rng = np.random.default_rng(17)
    kc, ks, vc, vs, pool_pos, bt = map(_t, _pool(rng))
    q = _t(rng.normal(size=(3, 2, 2, 32)).astype(np.float32))
    q_pos = _t(np.asarray([39, 19, 9], np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        pda.paged_decode_attention(q, kc, ks, vc, vs, pool_pos, bt, q_pos)
    bad = [
        (q.double(), kc, ks, vc, vs, pool_pos, bt, q_pos),
        (q, kc.int(), ks, vc, vs, pool_pos, bt, q_pos),
        (q, kc, ks, vc, vs, pool_pos, bt.long(), q_pos),
        (q, kc, ks, vc, vs, pool_pos, bt, q_pos.long()),
        (q[..., :16].contiguous(), kc, ks, vc, vs, pool_pos, bt, q_pos),
    ]
    for args in bad:
        with pytest.raises(ValueError, match="must"):
            pda.paged_decode_attention(*args)
    args = list(map(_t, _prefill_case(rng, (9, 5, 0), (4, 6, 3))))
    q, kf, vf = (args[0].transpose(1, 2).contiguous(),
                 args[8].transpose(1, 2).contiguous(),
                 args[9].transpose(1, 2).contiguous())
    start = ppa.first_call_position(args[7])
    good = [q, *args[1:8], start, kf, vf]
    with pytest.raises(ValueError, match="CUDA"):
        ppa.paged_prefill_attention(*good)
    for i, bad_t in ((8, start.long()), (9, kf.to(torch.bfloat16)),
                     (7, args[7].long()), (0, q.transpose(1, 2))):
        with pytest.raises(ValueError, match="must"):
            ppa.paged_prefill_attention(*good[:i], bad_t, *good[i + 1:])
    assert pda.paged_decode_attention.launches == 0
    assert ppa.paged_prefill_attention.launches == 0
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()
