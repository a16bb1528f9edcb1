"""K1 (``decode_attention``) as its split kernel computes it, without a
card: the unit plan (a grid from shapes alone whose live units cover
exactly a row's slots ``0 .. q_pos``, the slot contract), the unit size,
and the split-and-merge arithmetic emulated in f32 (units of ``U``
slots, live units only, a base-2 softmax in two passes a unit, the units
merged in unit order; a row with no valid slot the uniform average of v
over all S slots), held against the Pallas kernel in interpret mode on
``chip_smoke.py``'s K1 check shapes at small widths. The tolerance cannot
tell one f32 order from another: that the kernel repeats its bits is held
on the card (``tests/test_torch_cuda.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da

torch.set_num_threads(2)

ATOL = 1e-4  # K1 against the Pallas kernel (chip_smoke.py's ATOL)
LOG2E = math.log2(math.e)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _inputs(b, kh, g, hd, s, fill, seed, empty=()):
    """A dense cache of ``s`` slots, slot t holding position t below
    ``fill`` (-1 above it and at the (row, slot) pairs in ``empty``)."""
    rng = np.random.default_rng(seed)
    pos = np.where(np.arange(s) < fill, np.arange(s), -1).astype(np.int32)
    pos = np.tile(pos, (b, 1))
    for r, sl in empty:
        pos[r, sl] = -1
    return (rng.normal(size=(b, kh, g, hd)).astype(np.float32),
            rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8),
            rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32),
            rng.integers(-127, 128, (b, kh, s, hd)).astype(np.int8),
            rng.uniform(1e-3, 2e-2, (b, kh, s)).astype(np.float32), pos)


def _k1_emulated(q, kc, ks, vc, vs, pos, q_pos, keys):
    """The split kernel's arithmetic in f32: row b's slots ``0 .. q_pos``
    (``da.unit_slots``) cut into units of ``keys``; per unit the scores in
    base 2 (q pre-scaled by log2(e)/sqrt(hd), times k_scale), one max over
    the valid slots, then 2^(score - max) and the weighted values; the
    units merged in unit order; a row where no unit saw a valid slot gets
    the uniform average of v over all S slots."""
    b_n, kh_n, g_n, hd = q.shape
    s = kc.shape[2]
    out = torch.zeros(q.shape, dtype=torch.float32)
    v_all = vc.float() * vs[..., None]
    for b in range(b_n):
        qp = int(q_pos[b])
        qs = q[b].float() * torch.tensor(LOG2E / math.sqrt(hd),
                                          dtype=torch.float32)
        parts = []
        for u in range(da.grid(b_n, kh_n, g_n, s, keys)[2]):
            sl = da.unit_slots(qp, u, keys, s)
            if not sl:
                continue
            a, e = sl.start, sl.stop
            sc = torch.einsum("kgd,ksd->kgs", qs, kc[b, :, a:e].float()) \
                * ks[b, :, None, a:e]
            ok = (pos[b, a:e] >= 0) & (pos[b, a:e] <= qp)
            m = torch.where(ok, sc, -1e30).max(dim=-1).values  # (K, G)
            p = torch.where(ok, torch.exp2(sc - m[..., None]), 0.0)
            acc = torch.einsum("kgs,ksd->kgd", p * vs[b, :, None, a:e],
                               vc[b, :, a:e].float())
            parts.append((m, p.sum(dim=-1), acc))
        mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values \
            if parts else None
        if mx is None or not bool((mx > -0.5e30).any()):
            out[b] = v_all[b].mean(dim=1)[:, None, :].expand(kh_n, g_n, hd)
            continue
        lsum = torch.zeros_like(mx)
        acc = torch.zeros(kh_n, g_n, hd)
        for m, l, a in parts:  # unit order
            w = torch.exp2(m - mx)
            lsum = lsum + l * w
            acc = acc + a * w[..., None]
        out[b] = acc / lsum.clamp_min(1e-30)[..., None]
    return out


def _pallas(args, q_pos):
    """The Pallas kernel (interpret mode) row by row: it takes one q_pos
    for the whole batch."""
    rows = []
    for b, qp in enumerate(q_pos):
        rows.append(np.asarray(jax_decode(
            *(jnp.asarray(a[b:b + 1]) for a in args), int(qp),
            interpret=True)))
    return np.concatenate(rows)


def _emulated_keys(hd):
    """The kernel's unit size, and the smaller ones the probe builds (so
    that short rows too are merged from several units)."""
    return sorted({da.unit_keys(hd), 128, 64 if hd > 32 else 128})


# chip_smoke.py's K1 check shapes at small widths: (B, K, G, hd, S, fill,
# per-row q_pos or None, empty (row, slot) pairs in the live range)
K1_CASES = {
    "main_all_live": (2, 2, 1, 128, 1024, 1024, None, ()),
    "split_160_live": (1, 2, 1, 128, 1024, 160, None, ()),
    "four_rows_111": (2, 2, 1, 128, 1024, 111, None, ((1, 5), (1, 70))),
    "long_cache_200": (1, 2, 1, 128, 4096, 200, None, ()),
    "tiny": (2, 2, 2, 32, 96, 50, None, ()),
    "g6_s600": (2, 2, 6, 64, 600, 450, None, ()),
    "row_with_no_valid_slot": (2, 2, 2, 32, 96, 96, [40, -1], ()),
    "mqa_48": (1, 1, 48, 128, 700, 700, None, ()),
    "hd256_ragged_g": (2, 2, 3, 256, 130, 100, None, ()),
    "live_slots_all_empty": (2, 2, 1, 64, 256, 256, [200, 255],
                             tuple((0, t) for t in range(256))),
    # h2o-danube-3-4b's head dim and group, two units a row, odd S (the
    # kernel's 8-byte staging from an odd slot index)
    "hd120_g4": (2, 2, 4, 120, 301, 301, None, ()),
}


@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_split_arithmetic_matches_pallas_kernel(case):
    """The emulated split-and-merge arithmetic, at the kernel's unit size
    and at the probe's smaller ones, agrees with the Pallas
    kernel (interpret mode) within ATOL, also on a row with no valid slot
    (q_pos = -1, or every slot up to q_pos empty: the uniform average of
    v) and on rows with empty slots inside their live range."""
    b, kh, g, hd, s, fill, qp, empty = K1_CASES[case]
    args = _inputs(b, kh, g, hd, s, fill, seed=b * s + g + hd, empty=empty)
    q_pos = np.asarray(qp if qp is not None else [fill - 1] * b, np.int32)
    want = _pallas(args, q_pos)
    for keys in _emulated_keys(hd):
        got = _k1_emulated(*map(_t, args), q_pos, keys).numpy()
        assert float(np.abs(got - want).max()) <= ATOL, keys
    # the plain version agrees too (it is what the card holds K1 against)
    plain = da.decode_attention_ref(*map(_t, args), _t(q_pos)).numpy()
    assert float(np.abs(plain - want).max()) <= ATOL


@pytest.mark.parametrize("b,kh,g,hd,s", [
    (4, 32, 1, 128, 1024), (1, 32, 1, 128, 1024), (2, 2, 6, 64, 600),
    (1, 1, 48, 128, 700), (2, 4, 3, 256, 130), (2, 2, 2, 32, 96),
    (3, 1, 1, 64, 1), (2, 8, 4, 120, 4096)])
def test_k1_unit_plan_covers_exactly_the_live_slots(b, kh, g, hd, s):
    """The grid is (kv-heads × head groups, rows, units) from shapes
    alone, at the kernel's unit size and the probe's; for every causal
    bound the units of a row cover exactly its slots ``0 .. q_pos``
    (within the cache), in order, once each, and a unit past them is
    empty (it exits at once on the card)."""
    for keys in _emulated_keys(hd):
        heads, rows, units = da.grid(b, kh, g, s, keys)
        gc = g if g <= 2 else da.GROUP
        assert (heads, rows) == (kh * -(-g // gc), b)
        assert (units - 1) * keys < s <= units * keys
        for qp in sorted({-1, 0, 1, keys - 1, keys, keys + 1, 3 * keys + 2,
                          s - 1, s, s + 5}):
            slots = [t for u in range(units)
                     for t in da.unit_slots(qp, u, keys, s)]
            assert slots == list(range(0 if qp < 0 else min(qp + 1, s)))
            for u in range(units):
                sl = da.unit_slots(qp, u, keys, s)
                assert len(sl) <= keys and sl.start == u * keys


@pytest.mark.parametrize("hd", da.HEAD_DIMS)
def test_k1_unit_sizes_are_whole_block_steps_within_shared_memory(hd):
    """The unit size at each head dim, and each the probe builds, is a
    whole number of a block's steps (8 warps, hd / 16 lanes a slot, hd 120
    rounded up to hd 128's 8) and stages within 69 KB; the kernel's is the
    largest such size up to 256 slots (``unit_keys`` in the source says
    the same)."""
    step = da.WARPS * 32 // -(-hd // 16)
    for keys in _emulated_keys(hd):
        assert keys % step == 0 and keys * (2 * hd + 12) <= 70 * 1024
    fits = [k for k in (32, 64, 128, 256)
            if k % step == 0 and k * (2 * hd + 12) <= 70 * 1024]
    assert da.unit_keys(hd) == max(fits)
    src = (build.CSRC / "decode_attention.cu").read_text()
    assert "  return HD == 256 ? 128 : 256;" in src
