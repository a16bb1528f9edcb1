"""K2 (``paged_decode_attention``) and K7's decode GEMV as their CUDA
kernels compute them, without a card: K2's route (the single-pass kernel
for a table that fits one split), its split plan (a grid from shapes alone
whose units cover exactly the pages a row needs) and its split-and-combine
arithmetic emulated in f32 (each split of ``SPLIT`` keys its own online
softmax state, the splits merged in split order), and the GEMV's f32
accumulation in the kernel's summation order (per-warp fmaf sums over
passes of U rows, the warps added in warp order, the K ranges in range
order), each held against the Pallas kernel in interpret mode. The
tolerances cannot tell one f32 order from another: that the kernels repeat
their bits is held on the card (``tests/test_torch_cuda.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul as jax_dequant_matmul
from repro.kernels.ops import paged_decode_attention as jax_paged_decode
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import paged_decode_attention as pda

torch.set_num_threads(2)

ATOL = 1e-4  # K2 against the Pallas kernel (chip_smoke.py's ATOL)
K7_REL = 1e-5  # the GEMV against the Pallas kernel, of the largest output
SMS = 132  # an H100 SXM's streaming multiprocessors
# the GEMV kernel's block: 8 warps over 512 columns, U rows a warp a pass
# by rows of x a block (one, or up to four)
GEMV_WARPS, GEMV_COLS, GEMV_UNROLL = 8, 512, {1: 4, 4: 8}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ------------------------------------------------------------------ K2


def _pool(rng, kh, hd, page, nb, tokens, masked_below=()):
    """A pool holding ``tokens[r]`` tokens for row r (position t at page
    ``table[r, t // page]``, slot ``t % page``, pages in random order) and
    its block table; row r's positions below ``masked_below[r]`` are left
    empty (-1)."""
    masked = dict(enumerate(masked_below))
    need = [-(-n // page) for n in tokens]
    p = 1 + sum(need) + 2
    order = rng.permutation(np.arange(1, p))
    bt = np.zeros((len(tokens), nb), np.int32)
    pool_pos = np.full((p, page), -1, np.int32)
    nxt = 0
    for r, n in enumerate(tokens):
        for b in range(need[r]):
            bt[r, b] = order[nxt]
            nxt += 1
        for t in range(masked.get(r, 0), n):
            pool_pos[bt[r, t // page], t % page] = t
    return (rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8),
            rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
            rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8),
            rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
            pool_pos, bt)


def _k2_emulated(q, kc, ks, vc, vs, pool_pos, bt, q_pos, split):
    """K2's split-and-combine arithmetic in f32: a row's pages
    ``0 .. q_pos // page`` cut into splits of ``split`` logical slots
    (``pda.unit_slots``), each split an online softmax of its own (max,
    sum, weighted values) over the valid keys, the splits merged in split
    order; a row where no split saw a valid key gives exact zeros. (The
    kernel walks a row of one split in one pass, an online softmax over
    the same keys: the same arithmetic in another f32 order.)"""
    r_n, kh_n, g_n, hd = q.shape
    page, nb = kc.shape[2], bt.shape[1]
    units = [[pda.unit_slots(int(q_pos[r]), s, split, page, nb)
              for s in range(pda.splits(nb, page, split))]
             for r in range(r_n)]
    k = pda.gather_pages(kc, bt).float()  # (R, K, nb·page, hd) codes
    v = pda.gather_pages(vc, bt).float()
    k_sc, v_sc = pda.gather_pages(ks, bt), pda.gather_pages(vs, bt)
    pos = pda.gather_pages(pool_pos, bt)  # (R, nb·page)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for r in range(r_n):
        qs = q[r].float() / math.sqrt(hd)  # (K, G, hd)
        parts = []
        for sl in units[r]:
            if not sl:
                continue
            a, b = sl.start, sl.stop
            s = torch.einsum("kgd,ksd->kgs", qs, k[r, :, a:b]) \
                * k_sc[r, :, None, a:b]
            ok = ((pos[r, a:b] >= 0) & (pos[r, a:b] <= q_pos[r]))
            s = torch.where(ok, s, -1e30)
            m = s.max(dim=-1).values  # (K, G); -1e30 where none is valid
            p = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
            acc = torch.einsum("kgs,ksd->kgd", p * v_sc[r, :, None, a:b],
                               v[r, :, a:b])
            parts.append((m, p.sum(dim=-1), acc))
        if not parts:
            continue  # a free slot: nothing to walk, zeros
        mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        lsum = torch.zeros_like(mx)
        acc = torch.zeros(kh_n, g_n, hd)
        for m, l, a in parts:  # split order
            w = torch.exp(m - mx)
            lsum = lsum + l * w
            acc = acc + a * w[..., None]
        seen = (mx > -0.5e30)[..., None]
        out[r] = torch.where(seen, acc / lsum.clamp_min(1e-30)[..., None],
                             0.0)
    return out


K2_CASES = {
    # name: (kh, g, hd, page, nb, tokens, split, masked_below)
    "one_two_and_four_splits": (2, 2, 32, 4, 16, [10, 20, 50, 64], 16, ()),
    "split_256_at_600_tokens": (2, 1, 32, 16, 40, [600, 37], None, ()),
    "g6": (2, 6, 64, 8, 12, [90, 33, 8], 32, ()),
    "free_rows": (2, 2, 32, 4, 12, [0, 45, 0], 16, ()),
    "first_split_all_masked": (2, 2, 32, 8, 12, [90, 40], 32, (40,)),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_split_arithmetic_matches_pallas_kernel(case):
    """The emulated split-and-combine arithmetic agrees with the Pallas
    kernel (interpret mode) within ATOL, and with the paged oracle on the
    rows the oracle models (those with a valid key); free rows (q_pos =
    -1, an all-trash table) are exact zeros in the emulation and the
    Pallas kernel."""
    kh, g, hd, page, nb, toks, split, masked = K2_CASES[case]
    split = split or pda.SPLIT[hd]
    n_slots = [min(-(-n // page), nb) * page for n in toks]
    assert max(n_slots) > split or case == "free_rows"
    rng = np.random.default_rng(sum(toks) + g)
    pool = _pool(rng, kh, hd, page, nb, toks, masked)
    q = rng.normal(size=(len(toks), kh, g, hd)).astype(np.float32)
    q_pos = np.asarray([n - 1 for n in toks], np.int32)
    args = (q, *pool, q_pos)
    got = _k2_emulated(*map(_t, args), split).numpy()
    want = np.asarray(jax_paged_decode(*map(jnp.asarray, args)))
    oracle = np.asarray(jref.paged_decode_attention_ref(
        *map(jnp.asarray, args)))
    free = [i for i, n in enumerate(toks) if n == 0]
    live = [i for i, n in enumerate(toks) if n > 0]
    assert float(np.abs(got - want).max()) <= ATOL
    assert float(np.abs(got[live] - oracle[live]).max()) <= ATOL
    assert (got[free] == 0).all() and (want[free] == 0).all()
    if masked:  # the masked split must not pull the row toward zero
        assert float(np.abs(want[0]).max()) > 1e-3


@pytest.mark.parametrize("r,kh,g,hd,page,nb", [
    (8, 32, 1, 128, 16, 64), (3, 2, 2, 32, 4, 8), (2, 2, 6, 64, 16, 10),
    (2, 4, 3, 256, 8, 12), (2, 2, 1, 128, 64, 4), (2, 1, 4, 64, 1, 40),
    (1, 1, 9, 128, 16, 300)])
def test_k2_split_plan_covers_exactly_the_needed_pages(r, kh, g, hd, page,
                                                       nb):
    """The grid is (kv-heads × head groups, rows, splits) from shapes
    alone; for every causal bound the units of a row cover exactly its
    logical slots ``0 .. (q_pos // page + 1) · page`` (within the table),
    in order, once each, and a unit past them is empty."""
    heads, rows, n_split = pda.grid(r, kh, g, hd, page, nb)
    gc = g if g <= 2 else pda.GROUP
    assert (heads, rows) == (kh * -(-g // gc), r)
    assert (n_split - 1) * pda.SPLIT[hd] < nb * page <= n_split * pda.SPLIT[hd]
    for qp in sorted({-1, 0, 1, page - 1, page, 3 * page + 2,
                      pda.SPLIT[hd] - 1, pda.SPLIT[hd], nb * page - 1,
                      nb * page + 5}):
        slots = [t for s in range(n_split)
                 for t in pda.unit_slots(qp, s, pda.SPLIT[hd], page, nb)]
        need = 0 if qp < 0 else min(qp // page + 1, nb) * page
        assert slots == list(range(need))
        for s in range(n_split):
            sl = pda.unit_slots(qp, s, pda.SPLIT[hd], page, nb)
            assert len(sl) <= pda.SPLIT[hd]
            assert sl.start == s * pda.SPLIT[hd]


@pytest.mark.parametrize("hd,page,nb,want", [
    (128, 16, 16, "single_pass"), (128, 16, 17, "split"),
    (128, 16, 64, "split"), (32, 4, 64, "single_pass"),
    (32, 4, 65, "split"), (256, 8, 16, "single_pass"),
    (256, 8, 17, "split"), (64, 64, 4, "single_pass"),
    (64, 1, 257, "split")])
def test_k2_route_takes_single_pass_when_the_table_fits_one_split(
        hd, page, nb, want):
    """The route is a pure function of the shapes: a table of at most one
    split (nb · page <= SPLIT[hd]) takes the single-pass kernel, a wider
    one the split kernel, whose grid then has more than one split."""
    assert pda.route(hd, page, nb) == want
    n_split = pda.grid(1, 1, 1, hd, page, nb)[2]
    assert (n_split == 1) == (want == "single_pass")


# ------------------------------------------------------------------ K7


def _fma(acc, x, w):
    """fmaf in f32: the product of an f32 x and an int8 code is exact in
    f64, so one rounding of the f64 sum is fmaf's."""
    return (acc.double() + x.double() * w.double()).float()


def _gemv_emulated(x, codes, scale, splits, warps=GEMV_WARPS):
    """``gemv16_kernel``'s summation order: each K range of
    ceil(K / splits) rows is walked in passes of warps × unroll rows, warp
    w taking rows pass · warps · unroll + w · unroll + u in that order with
    fmaf; the warps' sums are added in warp order, the ranges' in range
    order, and the scale multiplies once."""
    m, k = x.shape
    unroll = GEMV_UNROLL[1 if m == 1 else dm.GEMV_MAX_M]
    xf, cf = x.float(), codes.float()
    chunk = -(-k // splits)
    rows_pass = warps * unroll
    total = None
    for sp in range(splits):
        k0, k1 = sp * chunk, min(k, sp * chunk + chunk)
        acc = torch.zeros(warps, m, codes.shape[1])
        for p in range(-(-chunk // rows_pass)):
            for u in range(unroll):
                rows = [k0 + p * rows_pass + w * unroll + u
                        for w in range(warps)]
                live = [i for i, row in enumerate(rows) if row < k1]
                if not live:
                    continue
                idx = torch.tensor([rows[i] for i in live])
                acc[live] = _fma(acc[live], xf[:, idx].T[:, :, None],
                                 cf[idx][:, None, :])
        s = acc[0]
        for w in range(1, warps):
            s = s + acc[w]
        total = s if total is None else total + s
    return total * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 512), (2, 512, 80),
                                   (3, 640, 528), (4, 1024, 1024),
                                   (1, 300, 48)])
def test_gemv_f32_accumulation_matches_pallas_kernel(dtype, m, k, n):
    """The emulated GEMV (f32 sums in the kernel's order), at the K split
    ``gemv_plan`` picks and at one range, agrees with the Pallas kernel
    (interpret mode) within K7_REL of the largest output, for M 1 to 4 and
    N no multiple of 512: an f32-accumulation check (any f32 order passes
    this tolerance)."""
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    codes = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(1e-3, 1e-1, (n,)).astype(np.float32)
    xt = _t(x).to(getattr(torch, dtype))
    xj = jnp.asarray(xt.float().numpy()).astype(getattr(jnp, dtype))
    want = np.asarray(jax_dequant_matmul(
        xj, jnp.asarray(codes), jnp.asarray(scale), block_m=m, block_n=n,
        block_k=k, interpret=True))
    _, splits = dm.gemv_plan(m, n, k, 16, SMS)
    assert splits > 1 or k < 2 * dm.MIN_SPLIT_ROWS
    for s in sorted({1, splits}):
        got = _gemv_emulated(xt, _t(codes), _t(scale), s).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=K7_REL * np.abs(want).max())


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (1, 4096, 11008),
                                   (1, 11008, 4096), (4, 4096, 11008),
                                   (4, 11008, 4096)])
def test_gemv_plan_fills_the_sms_at_llama_shapes(m, k, n):
    """At llama2-7b's three decode products (and w_up and w_down at M 4)
    the 16-byte GEMV's blocks fill the SMs at least once, its K ranges
    cover K with none empty, and each range's rows of x fit the staged
    budget."""
    mt, splits = dm.gemv_plan(m, n, k, 16, SMS)
    blocks = -(-n // GEMV_COLS) * -(-m // mt) * splits
    assert blocks >= SMS
    chunk = -(-k // splits)
    assert (splits - 1) * chunk < k <= splits * chunk
    assert chunk * 4 * mt <= dm.GEMV_STAGED_X


@pytest.mark.parametrize("n,codes_at,scale_at,want", [
    (11008, 256, 512, 16), (4096, 0, 16, 16), (4104, 0, 0, 8),
    (4096, 8, 0, 8), (4096, 0, 4, 8), (17, 0, 0, 1), (4096, 4, 0, 1)])
def test_gemv_vec_needs_16_byte_rows_and_bases(n, codes_at, scale_at, want):
    """16 codes a lane where N and both bases allow 16-byte loads; else the
    older kernel's 8-byte loads where N and the codes allow them; else 1."""
    assert dm.gemv_vec(n, codes_at, scale_at) == want


# ------------------------------------------------------------------ probes


@pytest.mark.parametrize("source,variants", [
    ("paged_decode_attention", "decode_probe.k2_variants"),
    ("decode_attention", "decode_probe.k1_variants"),
    ("ts_mask", "decode_probe.k6_variants"),
    ("dequant_matmul", "decode_probe.gemv_variants"),
    ("dequant_matmul", "k7_probe._variants")])
def test_probe_variants_still_edit_the_kernel_sources(source, variants):
    """Each variant the probes build is an exact-string edit of a kernel's
    source; an edit that no longer finds its string raises. Building the
    edits here keeps a change to a ``.cu`` file from breaking a probe
    unseen until a card call."""
    import importlib

    from repro_torch.kernels import build

    module, fn = variants.split(".")
    make = getattr(importlib.import_module(f"repro_torch.kernels.{module}"),
                   fn)
    src = (build.CSRC / f"{source}.cu").read_text()
    edited = make(src)
    assert edited
    for name, text in edited.items():
        assert name == "as_is" or text != src, name
