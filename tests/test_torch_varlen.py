"""The port's token-packed varlen path against the JAX package: the plain
version of varlen attention (K4), which the port runs on the CPU and holds
the CUDA kernel against on the card, against the reference oracle on the
reference tests' mixes and GQA ratios, against the Pallas kernel in
interpret mode on one mixed pack, on an all-pad buffer and a shuffled slot
layout; ``segment_start``; the segment-aware pool scatter
``paged_cache_update(slots=)`` bit for bit; the model's varlen route with
and without the ``quant_fresh`` round trip; ``transformer.packed_step``
logits on bridged weights; and the CUDA wrapper's refusals (mirroring
``tests/test_varlen_packed.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import AttnSpec
from repro.kernels import ref as jref
from repro.kernels.ops import varlen_attention as jax_varlen
from repro.kernels.varlen_attention import segment_start as jax_segment_start
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving.kv_pool import PagedKVPool as JaxPool
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels import varlen_attention as va
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax_params
from repro_torch.serving.kv_pool import PagedKVPool

torch.set_num_threads(2)

# the plain version against the oracle: the same f32 math, one softmax
# over the same valid keys in another summation order
ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)
# against the Pallas kernel (interpret mode): the reference tests' kernel
# tolerance, its online softmax folds page by page
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
# model logits across frameworks on bridged f32 weights: the same
# arithmetic in another order through a few layers
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _varlen_case(rng, segs, kh=2, g=2, page=4, hd=32, p=16, pad=0,
                 order=None):
    """``tests/test_varlen_packed.py``'s hand-built pool and flat batch:
    slot ``i`` holds ``segs[i][0]`` history tokens and contributes
    ``segs[i][1]`` fresh tokens from that position; the call's own tokens
    are stored in the pool too (post-update), and ``pad`` pad rows close
    the buffer. ``order`` lays the segments out in another slot order (a
    non-contiguous, shuffled layout); each stays one contiguous run."""
    kc = rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (p, kh, page)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (p, kh, page)).astype(np.float32)
    totals = [h + n for h, n in segs]
    maxb = max(-(-t // page) for t in totals)
    bt = np.zeros((len(segs), maxb), np.int32)
    pool_pos = np.full((p, page), -1, np.int32)
    nxt = 1
    for i, t in enumerate(totals):
        for b in range(-(-t // page)):
            bt[i, b] = nxt
            nxt += 1
        for tok in range(t):
            pool_pos[bt[i, tok // page], tok % page] = tok
    assert nxt <= p
    t_flat = sum(n for _, n in segs) + pad
    q_pos = np.full((t_flat,), -1, np.int32)
    tok_slot = np.full((t_flat,), -1, np.int32)
    cur = 0
    for i in (range(len(segs)) if order is None else order):
        h, n = segs[i]
        q_pos[cur:cur + n] = np.arange(h, h + n)
        tok_slot[cur:cur + n] = i
        cur += n
    q = rng.normal(size=(kh, t_flat, g, hd)).astype(np.float32)
    kf = rng.normal(size=(kh, t_flat, hd)).astype(np.float32)
    vf = rng.normal(size=(kh, t_flat, hd)).astype(np.float32)
    return q, kc, ks, vc, vs, pool_pos, bt, q_pos, tok_slot, kf, vf


def _oracle(args):
    """The reference's dense oracle on the same operands."""
    q, kc, ks, vc, vs, pp, bt, qp, sl, kf, vf = map(jnp.asarray, args)
    start = jax_segment_start(qp, sl, bt.shape[0])
    return np.asarray(jref.varlen_attention_ref(q, kc, ks, vc, vs, pp, bt,
                                                qp, sl, start, kf, vf))


def _port(args):
    """``kernels.ops.varlen_attention`` on CPU tensors: the plain version."""
    args = list(map(_t, args))
    start = ops.segment_start(args[7], args[8], args[6].shape[0])
    return ops.varlen_attention(*args[:9], start, *args[9:]).numpy()


MIXES = {  # test_varlen_packed.py's three packs
    "pure_decode": dict(segs=[(5, 1), (9, 1), (3, 1)], pad=3),
    "pure_prefill": dict(segs=[(0, 4), (6, 3), (0, 5)], pad=0),
    "mixed": dict(segs=[(9, 1), (5, 4), (0, 6), (7, 1)], pad=2),
}


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("g,kh", [(2, 2), (4, 1), (1, 2)])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_varlen_plain_matches_oracle(g, kh, mix):
    """The reference's MIXES × GQA grid: the plain version equals the
    oracle within ``ORACLE_TOL``; pad rows are exact zeros."""
    spec = MIXES[mix]
    rng = np.random.default_rng(sorted(MIXES).index(mix) * 10 + g + kh)
    args = _varlen_case(rng, spec["segs"], kh=kh, g=g, pad=spec["pad"])
    got = _port(args)
    np.testing.assert_allclose(got, _oracle(args), **ORACLE_TOL)
    if spec["pad"]:
        np.testing.assert_array_equal(got[:, -spec["pad"]:], 0.0)


def test_varlen_plain_matches_pallas_kernel_interpret():
    """One mixed pack against the Pallas kernel itself, run in interpret
    mode as the reference tests run it on the CPU."""
    rng = np.random.default_rng(5)
    args = _varlen_case(rng, MIXES["mixed"]["segs"], pad=2)
    want = np.asarray(jax_varlen(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(_port(args), want, **KERNEL_TOL)


def test_varlen_all_pad_buffer_gives_exact_zeros():
    """A buffer with no active token (every slot and position -1) comes
    back all zeros, never NaN from an empty softmax."""
    rng = np.random.default_rng(17)
    args = list(_varlen_case(rng, [(4, 2), (7, 1)], pad=1))
    args[7] = np.full_like(args[7], -1)
    args[8] = np.full_like(args[8], -1)
    got = _port(args)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(_oracle(args), 0.0)


@pytest.mark.parametrize("order", [(2, 0, 3, 1), (3, 1, 0, 2)])
def test_varlen_shuffled_slot_layout_matches_oracle(order):
    """Segments laid out in another slot order than their slot ids (the
    scheduler's buffer is slot-major, the oracle takes any layout): the
    plain version still equals the oracle, and each row's output does not
    depend on where its segment sits."""
    segs = [(9, 1), (5, 4), (0, 6), (7, 1)]
    rng = np.random.default_rng(19)
    base = _varlen_case(rng, segs, pad=2)
    rng = np.random.default_rng(19)
    args = _varlen_case(rng, segs, pad=2, order=order)
    got = _port(args)
    np.testing.assert_allclose(got, _oracle(args), **ORACLE_TOL)
    # the same tokens (q/k/v drawn per buffer row) in slot-major order
    # give the same per-token outputs once q and fresh k/v move with them
    perm = np.concatenate([np.flatnonzero(base[8] == s) for s in order]
                          + [np.flatnonzero(base[8] < 0)])
    moved = list(base)
    moved[0], moved[9], moved[10] = (base[0][:, perm], base[9][:, perm],
                                     base[10][:, perm])
    moved[7], moved[8] = base[7][perm], base[8][perm]
    np.testing.assert_allclose(_port(moved), _port(base)[:, perm],
                               **ORACLE_TOL)


def test_varlen_pure_decode_equals_paged_decode():
    """A pure-decode pack whose fresh k/v equal the pool's dequantized self
    entries is the paged decode problem: row r equals K2's plain version
    for request r (``test_varlen_packed.py:118``)."""
    segs = [(5, 1), (9, 1), (3, 1)]
    page = 4
    rng = np.random.default_rng(23)
    args = list(_varlen_case(rng, segs, page=page))
    kc, ks, vc, vs, bt = args[1], args[2], args[3], args[4], args[6]
    for t, (h, _) in enumerate(segs):
        pg, off = bt[t, h // page], h % page
        args[9][:, t] = kc[pg, :, off] * ks[pg, :, off, None]
        args[10][:, t] = vc[pg, :, off] * vs[pg, :, off, None]
    got = _port(args)
    want = pda.paged_decode_attention_ref(
        _t(args[0]).transpose(0, 1).contiguous(), *map(_t, args[1:7]),
        _t(np.asarray([h for h, _ in segs], np.int32)))
    np.testing.assert_allclose(got.transpose(1, 0, 2, 3), want.numpy(),
                               **ORACLE_TOL)


@pytest.mark.parametrize("q_pos,tok_slot,r", [
    ([5, 6, 7, -1, 2, 3], [1, 1, 1, -1, 0, 0], 3),  # slot 2 absent
    ([-1, -1, -1], [-1, -1, -1], 2),  # all pads
    ([4, 0, 9, 8], [2, 0, 2, 2], 3),  # a slot's rows out of order
    ([3, 1, 6], [0, 5, 1], 2),  # a slot id past R is dropped
])
def test_segment_start_matches_jax(q_pos, tok_slot, r):
    qp, sl = np.asarray(q_pos, np.int32), np.asarray(tok_slot, np.int32)
    want = np.asarray(jax_segment_start(jnp.asarray(qp), jnp.asarray(sl), r))
    got = va.segment_start(_t(qp), _t(sl), r)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_varlen_wrapper_refuses_cpu_and_wrong_inputs():
    """The CUDA wrapper never runs the plain version: CPU tensors and
    inputs of a type, shape or layout the kernel does not take raise
    before anything is built or launched."""
    rng = np.random.default_rng(29)
    args = list(map(_t, _varlen_case(rng, MIXES["mixed"]["segs"], pad=2)))
    start = va.segment_start(args[7], args[8], args[6].shape[0])
    good = [*args[:9], start, *args[9:]]
    with pytest.raises(ValueError, match="CUDA"):
        va.varlen_attention(*good)
    for i, bad in ((0, good[0].double()), (0, good[0].transpose(2, 3)),
                   (7, good[7].long()), (8, good[8][:-1]),
                   (9, start.long()), (10, good[10].to(torch.bfloat16)),
                   (11, good[11].transpose(1, 2)), (6, good[6].long())):
        with pytest.raises(ValueError, match="must"):
            va.varlen_attention(*good[:i], bad, *good[i + 1:])
    assert va.varlen_attention.launches == 0


# --------------------------------------------------- pool scatter, slots=


@pytest.mark.parametrize("positions,slots", [
    # a decode token, a chunk of three and a pad, in one flat row
    ([[9, 4, 5, 6, -1]], [[0, 1, 1, 1, -1]]),
    # positions past the table's reach, an unallocated page, a slot -1
    # with a real position
    ([[0, 13, 40, 3, 2, 7]], [[2, 2, 0, -1, 1, 1]]),
    # an all-pad buffer
    ([[-1, -1, -1]], [[-1, -1, -1]]),
])
def test_paged_cache_update_slots_bit_identical_to_jax(positions, slots):
    """The segment-aware scatter: each token's block-table row is its slot;
    codes, scales and positions equal the reference's bit for bit (pads,
    slot -1, out-of-reach and unallocated positions go to the trash page
    with pos -1)."""
    rng = np.random.default_rng(31)
    positions = np.asarray(positions, np.int32)
    slots = np.asarray(slots, np.int32)
    bt = np.asarray([[1, 2, 0], [3, 0, 0], [4, 5, 6]], np.int32)
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
                               jnp.asarray(positions), slots=jnp.asarray(
                                   slots))
    tc = TL.PagedKVCache(
        torch.zeros((p, kh, page, hd), dtype=torch.int8),
        torch.zeros((p, kh, page, hd), dtype=torch.int8),
        torch.zeros((p, kh, page)), torch.zeros((p, kh, page)),
        torch.full((p, page), -1, dtype=torch.int32), _t(bt))
    TL.paged_cache_update(tc, _t(k), _t(v), _t(positions), slots=_t(slots))
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        want = np.asarray(getattr(jc, name))
        got = getattr(tc, name).numpy()
        np.testing.assert_array_equal(got[1:], want[1:], err_msg=name)
    np.testing.assert_array_equal(tc.pos.numpy()[0], -1)


# --------------------------------------------------- model-level routes


@pytest.mark.parametrize("quant", [False, True])
def test_varlen_attention_layer_matches_jax(quant):
    """``attention_layer(packed=)`` on a paged cache:
    the pool write and the varlen route against the reference's layer on
    the same weights (its dense oracle route), with and without the int8
    round trip of the marked rows' fresh k/v; the pool after the call is
    bit-identical."""
    rng = np.random.default_rng(37)
    d, h, kh, hd, page = 64, 4, 2, 16, 4
    spec = AttnSpec(num_heads=h, num_kv_heads=kh, head_dim=hd)
    w = {n: (rng.normal(size=shape) / np.sqrt(d)).astype(np.float32)
         for n, shape in (("wq", (d, h * hd)), ("wk", (d, kh * hd)),
                          ("wv", (d, kh * hd)), ("wo", (h * hd, d)))}
    # slot 0 decodes at 9 over 9 tokens of history, slot 2 prefills a
    # chunk of 4 at 5 over 5, slot 1 starts a prompt of 3; two pads
    posn = np.asarray([[9, 5, 6, 7, 8, 0, 1, 2, -1, -1]], np.int32)
    slots = np.asarray([[0, 2, 2, 2, 2, 1, 1, 1, -1, -1]], np.int32)
    qf = np.asarray([[True] + [False] * 9])
    x = rng.normal(size=(1, posn.shape[1], d)).astype(np.float32)
    p = 12
    bt = np.asarray([[1, 2, 3], [4, 0, 0], [5, 6, 7]], np.int32)
    kc = rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (p, kh, page)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (p, kh, page)).astype(np.float32)
    pool_pos = np.full((p, page), -1, np.int32)
    for slot, n in ((0, 9), (2, 5)):  # history already in the pool
        for t in range(n):
            pool_pos[bt[slot, t // page], t % page] = t
    cos, sin = TL.rope_table(_t(posn), hd)
    jcs = tuple(jnp.asarray(a) for a in (cos.numpy(), sin.numpy()))
    jc = JL.PagedKVCache(*map(jnp.asarray, (kc, vc, ks, vs, pool_pos, bt)))
    want, jnew = JL.attention_layer(
        {k: jnp.asarray(a) for k, a in w.items()}, jnp.asarray(x), spec,
        rope_cs=jcs, cache=jc, pos=jnp.int32(0), q_positions=jnp.asarray(posn),
        token_slots=jnp.asarray(slots), prefill_kernel=False,
        quant_fresh=jnp.asarray(qf) if quant else None)
    tc = TL.PagedKVCache(*map(_t, (kc, vc, ks, vs, pool_pos, bt)))
    got, _ = TL.attention_layer(
        {k: _t(a) for k, a in w.items()}, _t(x), spec, rope_cs=(cos, sin),
        cache=tc, pos=0, q_positions=_t(posn),
        packed=TL.packed_layout(_t(posn), _t(slots), bt.shape[0],
                                _t(np.flatnonzero(qf)) if quant else None))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for name in ("k", "v", "k_scale", "v_scale", "pos"):
        np.testing.assert_array_equal(getattr(tc, name).numpy()[1:],
                                      np.asarray(getattr(jnew, name))[1:],
                                      err_msg=name)


@pytest.fixture(scope="module")
def tiny_model():
    cfg = get_config("llama2-7b-tiny")
    jcfg = jax_config("llama2-7b-tiny")
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, from_jax_params(jax.tree.map(np.asarray,
                                                            jparams))


@pytest.mark.parametrize("quant", [False, True])
def test_packed_step_logits_match_jax(tiny_model, quant):
    """``transformer.packed_step`` against the reference's on bridged
    weights: a slot-major buffer of one decode row over history written by
    an earlier call, a continuation chunk, a first chunk and tail pads.
    The logits of every slot's last row agree within ``LOGIT_TOL``, with
    and without the decode row's int8 round trip. The pools the two calls
    leave behind hold the same positions; past the first layer the k/v
    being quantized differ in their last bits (the frameworks sum in
    another order), so a scale may differ by an ulp and a code by one
    step."""
    cfg, jcfg, jparams, params = tiny_model
    jopts = JT.RuntimeOpts(q_chunk=16, kv_chunk=16, remat=False,
                           quantized_kv=True, moe_capacity_factor=0.0,
                           paged_prefill_kernel=False)
    opts = TT.RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    rng = np.random.default_rng(41)
    page, slots_n = 4, 3
    hist = {0: 7, 1: 5}  # tokens already in the pool per slot
    jpool = JaxPool(jcfg, num_pages=16, page_size=page, max_requests=slots_n)
    tpool = PagedKVPool(cfg, num_pages=16, page_size=page,
                        max_requests=slots_n, device="cpu")
    # write the histories through an ordinary ragged prefill on both sides
    pre_tok = rng.integers(0, cfg.vocab_size, (slots_n, 8)).astype(np.int32)
    pre_pos = np.full((slots_n, 8), -1, np.int32)
    for pool in (jpool, tpool):
        for _ in range(slots_n):
            pool.admit(8, reserve_tokens=12)
    for slot, n in hist.items():
        pre_pos[slot, 8 - n:] = np.arange(n)
    _, jc = JT.paged_prefill(jparams, jcfg, jnp.asarray(pre_tok),
                             jpool.device_caches(), jnp.asarray(pre_pos),
                             jopts)
    jpool.update_from(jc)
    TT.paged_prefill(params, cfg, _t(pre_tok), tpool.device_caches(),
                     _t(pre_pos), opts)
    # the packed buffer: slot 0 decodes at 7, slot 1 continues at 5 with
    # 3 tokens, slot 2 starts with 4; 3 pads
    tokens = rng.integers(0, cfg.vocab_size, (1, 11)).astype(np.int32)
    posn = np.asarray([[7, 5, 6, 7, 0, 1, 2, 3, -1, -1, -1]], np.int32)
    slots = np.asarray([[0, 1, 1, 1, 2, 2, 2, 2, -1, -1, -1]], np.int32)
    logit_rows = np.asarray([0, 3, 7], np.int32)
    qf = np.zeros((1, 11), bool)
    qf[0, 0] = quant
    want, jc = JT.packed_step(jparams, jcfg, jnp.asarray(tokens),
                              jpool.device_caches(), jnp.asarray(posn),
                              jnp.asarray(slots), jnp.asarray(logit_rows),
                              jopts, jnp.asarray(qf))
    jpool.update_from(jc)
    got, _ = TT.packed_step(params, cfg, _t(tokens), tpool.device_caches(),
                            _t(posn), _t(slots), _t(logit_rows), opts,
                            quant_rows=_t(np.flatnonzero(qf)))
    assert got.shape == (slots_n, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    jleaves = jpool.device_caches()
    for li in range(cfg.num_layers):
        pi, bi = li % len(cfg.pattern), li // len(cfg.pattern)
        want = {name: np.asarray(getattr(jleaves[pi], name))[bi]
                for name in ("k", "v", "k_scale", "v_scale", "pos")}
        np.testing.assert_array_equal(tpool.pos[li].numpy(), want["pos"])
        for name in ("k", "v"):
            step = np.abs(getattr(tpool, name)[li].numpy().astype(np.int32)
                          - want[name].astype(np.int32))
            assert step.max() <= 1, name
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tpool, name)[li].numpy(),
                                       want[name], rtol=1e-5, atol=0)
