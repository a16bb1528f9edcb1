"""The tensor-core routes of K7 (``dequant_matmul``), K3
(``paged_prefill_attention``) and K4 (``varlen_attention``) without a
card: each wrapper's route choice (a pure function of dtype, shape and
alignment), K7's split-K plan and its large-M plan, K4's work list, and
K3's and K4's tensor-core arithmetic emulated in PyTorch (bf16-exact codes
and operands, each score column scaled after Q·Kᵀ, the online softmax in
base 2 over 64-key tiles, P times v_scale carried as hi + lo bf16; for
K4's decode rows the history split over blocks and merged in a fixed
order) against the Pallas kernels in interpret mode at the tiny config's
attention shape."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import paged_prefill_attention as jax_paged_prefill
from repro.kernels.ops import varlen_attention as jax_varlen
from repro_torch.configs import get_config
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import paged_prefill_attention as ppa
from repro_torch.kernels import varlen_attention as va
from repro_torch.kernels.paged_decode_attention import gather_pages

torch.set_num_threads(2)

ATOL = 1e-4  # K3 against its plain version (chip_smoke.py's ATOL)
SMS = 132  # an H100 SXM's streaming multiprocessors


# ------------------------------------------------------------------ K7


@pytest.mark.parametrize("m,n,k,dtype,aligned,want", [
    (1, 11008, 4096, torch.bfloat16, True, "gemv"),
    (4, 4096, 4096, torch.float32, True, "gemv"),
    (5, 4096, 4096, torch.bfloat16, True, "tensor_cores"),
    (128, 11008, 4096, torch.bfloat16, True, "tensor_cores"),
    (600, 4096, 11008, torch.bfloat16, True, "tensor_cores_large_m"),
    (128, 11008, 4096, torch.float32, True, "cuda_cores"),
    (128, 11008, 4096, torch.bfloat16, False, "cuda_cores"),
    (70, 50, 130, torch.bfloat16, True, "cuda_cores"),   # N % 16
    (70, 80, 130, torch.bfloat16, True, "cuda_cores"),   # K % 8
    (70, 80, 200, torch.bfloat16, True, "tensor_cores"),
])
def test_dequant_matmul_route(m, n, k, dtype, aligned, want):
    """M ≤ 4 takes the GEMV; bf16 x with N % 16 == 0, K % 8 == 0 and
    16-byte aligned bases the tensor cores (from ``LARGE_M_MIN`` rows the
    large-M kernel); anything else the CUDA cores."""
    addresses = (4096, 8192, 256 + (0 if aligned else 4))
    assert dm.route(m, n, k, dtype, *addresses) == want


@pytest.mark.parametrize("m,n,k", [
    (96, 4096, 4096), (128, 4096, 4096), (128, 11008, 4096),
    (128, 4096, 11008), (384, 11008, 4096), (600, 11008, 4096),
    (70, 80, 200), (130, 48, 1000), (5, 16, 8), (16, 16, 65536)])
def test_tc_plan_covers_every_tile_and_k(m, n, k):
    """K7's tensor-core plan: the tiles cover the output, the K ranges
    (whole 64-row steps) cover K with none empty, and a split product
    keeps all its blocks resident; the llama2-7b prefill products give a
    block to every SM."""
    tiles_m, tiles_n, splits, chunk = dm.tc_plan(m, n, k, SMS)
    assert (tiles_m - 1) * dm.TC_TILE_M < m <= tiles_m * dm.TC_TILE_M
    assert (tiles_n - 1) * dm.TC_TILE_N < n <= tiles_n * dm.TC_TILE_N
    assert chunk % dm.TC_STEP_K == 0
    assert (splits - 1) * chunk < k <= splits * chunk
    blocks = tiles_m * tiles_n * splits
    if splits > 1:
        assert chunk >= dm.TC_MIN_SPLIT_STEPS * dm.TC_STEP_K
        assert blocks <= dm.TC_BLOCKS_PER_SM * SMS
    if k >= 4096 and n >= 4096:
        assert blocks >= SMS


@pytest.mark.parametrize("m,want", [
    (96, "tensor_cores"), (128, "tensor_cores"),
    (dm.LARGE_M_MIN - 1, "tensor_cores"),
    (256, "tensor_cores_large_m"), (384, "tensor_cores_large_m"),
    (600, "tensor_cores_large_m")])
@pytest.mark.parametrize("n,k", [(11008, 4096), (4096, 11008)])
def test_dequant_matmul_large_m_route(m, want, n, k):
    """The split edge's prefill sizes in bf16: the 96- and 128-token
    prompts stay on ``tc_gemm_kernel``, from ``LARGE_M_MIN`` rows (the
    four 96-token rows of a shared prefix, 384; a 600-token prompt) the
    large-M kernel; f32 x keeps the CUDA cores at every M."""
    aligned = (4096, 8192, 256)
    assert dm.route(m, n, k, torch.bfloat16, *aligned) == want
    assert dm.route(m, n, k, torch.float32, *aligned) == "cuda_cores"


@pytest.mark.parametrize("m,n,k", [
    (256, 11008, 4096), (384, 11008, 4096), (600, 11008, 4096),
    (384, 4096, 4096), (600, 4096, 4096), (384, 4096, 11008),
    (600, 4096, 11008), (1024, 11008, 4096), (2048, 4096, 4096),
    (300, 48, 1000), (257, 16, 8)])
def test_large_plan_covers_every_row_column_and_k(m, n, k):
    """K7's large-M plan: a compiled tile (rows of x for its column
    width), tiles that cover the output, K ranges of whole 64-row steps
    that cover K with none empty, at most one CTA an SM and no idle CTA;
    the units of work spread evenly over the rounds."""
    bm, jn, tiles_m, tiles_n, splits, chunk, ctas = dm.large_plan(m, n, k,
                                                                 SMS)
    assert bm in dm.LARGE_TILE_ROWS[jn]
    assert (tiles_m - 1) * bm < m <= tiles_m * bm
    assert (tiles_n - 1) * 128 * jn < n <= tiles_n * 128 * jn
    assert chunk % dm.TC_STEP_K == 0
    assert (splits - 1) * chunk < k <= splits * chunk
    units = tiles_m * tiles_n * splits
    assert ctas == min(units, SMS)
    if splits > 1:
        assert chunk >= dm.TC_MIN_SPLIT_STEPS * dm.TC_STEP_K
    rounds = -(-units // ctas)
    assert units > (rounds - 1) * ctas  # no round is left empty


@pytest.mark.parametrize("m", [384, 600])
def test_large_plan_fills_the_sms_in_one_wave(m):
    """At the split path's large sizes (w_up's K 4096, N 11008) the whole
    grid is resident at once (one CTA on each of the 132 SMs, one wave);
    M 384 is one round of units, and at M 600 the units fill two rounds
    to at least 97% with rows padded by at most 5%."""
    bm, jn, tiles_m, tiles_n, splits, _, ctas = dm.large_plan(m, 11008, 4096,
                                                              SMS)
    units = tiles_m * tiles_n * splits
    assert ctas <= SMS and splits == 1
    assert units <= SMS if m == 384 else units >= 0.97 * 2 * SMS
    assert tiles_m * bm <= 1.05 * m


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("dtype,hd,s,aligned,want", [
    (torch.bfloat16, 128, 256, True, "tensor_cores"),
    (torch.bfloat16, 32, 40, True, "tensor_cores"),
    (torch.bfloat16, 64, 1, True, "tensor_cores"),
    (torch.bfloat16, 256, 50, True, "tensor_cores"),
    (torch.float32, 128, 256, True, "cuda_cores"),
    (torch.bfloat16, 96, 256, True, "cuda_cores"),
    (torch.bfloat16, 128, ppa.TC_MAX_S + 1, True, "cuda_cores"),
    (torch.bfloat16, 128, 256, False, "cuda_cores"),
])
def test_paged_prefill_route(dtype, hd, s, aligned, want):
    """bf16 q with a templated head dim, S within the fresh-tile mask and
    16-byte aligned bases takes the tensor cores; f32 q the CUDA cores."""
    addresses = (1024, 2048, 4096, 8192 + (0 if aligned else 2), 16384)
    assert ppa.route(dtype, hd, s, *addresses) == want


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _tc_prefill_emulated(q, kc, ks, vc, vs, pool_pos, bt, q_pos, kf, vf,
                         rows_a_block=64, keys_a_tile=64):
    """K3's tensor-core kernel's arithmetic in PyTorch (port layout, f32
    tensors holding bf16-exact q and fresh k/v): per (block of 64 query
    rows, kv head, row) the history tiles below min(start, max q_pos + 1)
    then the fresh tiles with a key at or before the block's last query;
    S = q·codes in f32 times k_scale / sqrt(hd) · log2(e) a column; base-2
    online softmax; P·v_scale split into hi + lo bf16 against the codes
    (or fresh v)."""
    r_n, s_n, kh_n, g_n, hd = q.shape
    page, nb = kc.shape[2], bt.shape[1]
    start = ppa.first_call_position(q_pos)
    scale = math.log2(math.e) / math.sqrt(hd)
    k_hist = gather_pages(kc, bt).float()  # (R, K, Sp, hd) codes
    v_hist = gather_pages(vc, bt).float()
    ks_hist, vs_hist = gather_pages(ks, bt), gather_pages(vs, bt)
    pos_hist = gather_pages(pool_pos, bt)  # (R, Sp)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for r in range(r_n):
        rowpos = q_pos[r].repeat_interleave(g_n)  # query row f = s·G + g
        for kh in range(kh_n):
            rows = q[r, :, kh].reshape(s_n * g_n, hd)
            res = torch.zeros(s_n * g_n, hd)
            for f0 in range(0, s_n * g_n, rows_a_block):
                qr = rows[f0:f0 + rows_a_block]
                qp = rowpos[f0:f0 + rows_a_block]
                maxq = int(qp.max())
                if maxq < 0:
                    continue
                n_hist = min(int(start[r]), maxq + 1, nb * page)
                tiles = []  # (keys, values, positions, score scale, v scale)
                for t0 in range(0, n_hist, keys_a_tile):
                    t1 = min(t0 + keys_a_tile, n_hist)
                    p = pos_hist[r, t0:t1]
                    ok = (p >= 0) & (p < start[r])
                    tiles.append((k_hist[r, kh, t0:t1], v_hist[r, kh, t0:t1],
                                  torch.where(ok, p, -1),
                                  ks_hist[r, kh, t0:t1] * scale,
                                  vs_hist[r, kh, t0:t1]))
                for j0 in range(0, s_n, keys_a_tile):
                    p = q_pos[r, j0:j0 + keys_a_tile]
                    if not bool(((p >= 0) & (p <= maxq)).any()):
                        continue
                    n = p.shape[0]
                    tiles.append((kf[r, j0:j0 + n, kh], vf[r, j0:j0 + n, kh],
                                  p, torch.full((n,), scale),
                                  torch.ones(n)))
                m = torch.full((qr.shape[0],), -1e30)
                l = torch.zeros(qr.shape[0])
                acc = torch.zeros(qr.shape[0], hd)
                for keys, values, kpos, csc, vsc in tiles:
                    valid = (kpos[None, :] >= 0) \
                        & (kpos[None, :] <= qp[:, None])
                    sc = torch.where(valid, (qr @ keys.T) * csc, -1e30)
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    corr = torch.exp2(m - m_new)
                    p = torch.where(valid, torch.exp2(sc - m_new[:, None]),
                                    0.0)
                    l = l * corr + p.sum(dim=1)
                    pv = p * vsc
                    hi = _bf16(pv)
                    lo = _bf16(pv - hi)
                    acc = acc * corr[:, None] + hi @ values + lo @ values
                    m = m_new
                seen = m > -0.5e30
                res[f0:f0 + rows_a_block] = torch.where(
                    seen[:, None], acc / l.clamp_min(1e-30)[:, None], 0.0)
            out[r, :, kh] = res.view(s_n, g_n, hd)
    return out


def test_k3_tensor_core_arithmetic_meets_the_tolerance():
    """The tiny config's attention (hd 32, G 2, 2 kv heads) over rows with
    history and fresh tokens, a history of three 64-key tiles, a fork and
    a fully padded row: the emulated tensor-core arithmetic agrees with
    the Pallas kernel (interpret mode) within ATOL; pads are exact zeros."""
    cfg = get_config("llama2-7b-tiny")
    attn = cfg.pattern[0].mixer
    kh, g, hd = attn.num_kv_heads, attn.num_heads // attn.num_kv_heads, \
        attn.head_dim
    assert (kh, g, hd) == (2, 2, 32)
    rng = np.random.default_rng(15)
    page, s = 16, 40
    rows = [(130, 40), (16, 9), None, (0, 23)]  # (history, fresh)
    totals = [0 if x is None else sum(x) for x in rows]
    nb = max(-(-n // page) for n in totals)
    p_n = 1 + sum(-(-n // page) for n in totals)
    bt = np.zeros((len(rows), nb), np.int32)
    pool_pos = np.full((p_n, page), -1, np.int32)
    order = rng.permutation(np.arange(1, p_n))
    nxt = 0
    for i, n in enumerate(totals):
        for b in range(-(-n // page)):
            bt[i, b] = order[nxt]
            nxt += 1
        for t in range(n):
            pool_pos[bt[i, t // page], t % page] = t
    q_pos = np.full((len(rows), s), -1, np.int32)
    for i, x in enumerate(rows):
        if x is not None:
            q_pos[i, s - x[1]:] = np.arange(x[0], x[0] + x[1])

    def bf16_exact(*shape):
        return _bf16(torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))).numpy()

    q = bf16_exact(len(rows), s, kh, g, hd)
    kf = bf16_exact(len(rows), s, kh, hd)
    vf = bf16_exact(len(rows), s, kh, hd)
    kc = rng.integers(-127, 128, (p_n, kh, page, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (p_n, kh, page, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (p_n, kh, page)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (p_n, kh, page)).astype(np.float32)

    t = [torch.from_numpy(a)
         for a in (q, kc, ks, vc, vs, pool_pos, bt, q_pos, kf, vf)]
    got = _tc_prefill_emulated(*t)
    want = np.asarray(jax_paged_prefill(
        jnp.asarray(q.transpose(0, 2, 1, 3, 4)), jnp.asarray(kc),
        jnp.asarray(ks), jnp.asarray(vc), jnp.asarray(vs),
        jnp.asarray(pool_pos), jnp.asarray(bt), jnp.asarray(q_pos),
        jnp.asarray(kf.transpose(0, 2, 1, 3)),
        jnp.asarray(vf.transpose(0, 2, 1, 3)))).transpose(0, 2, 1, 3, 4)
    assert float(np.abs(got.numpy() - want).max()) <= ATOL
    pads = q_pos < 0
    assert (got.numpy()[pads] == 0).all() and (want[pads] == 0).all()


# ------------------------------------------------------------------ K4


@pytest.mark.parametrize("dtype,hd,t,aligned,want", [
    (torch.bfloat16, 128, 264, True, "tensor_cores"),
    (torch.bfloat16, 32, 5, True, "tensor_cores"),
    (torch.bfloat16, 64, 1, True, "tensor_cores"),
    (torch.bfloat16, 256, 50, True, "tensor_cores"),
    (torch.float32, 128, 264, True, "cuda_cores"),
    (torch.float32, 32, 5, True, "cuda_cores"),
    (torch.bfloat16, 96, 264, True, "cuda_cores"),
    (torch.bfloat16, 128, va.TC_MAX_T + 1, True, "cuda_cores"),
    (torch.bfloat16, 128, 264, False, "cuda_cores"),
])
def test_varlen_route(dtype, hd, t, aligned, want):
    """bf16 q with a templated head dim, T within the fresh-tile mask and
    16-byte aligned bases and (K, T) strides takes the tensor cores; f32 q
    (the reserve run on f32 weights) keeps the CUDA cores."""
    alignments = (1024, 2048, 4096, 8192, 16384, 256,
                  8192 + (0 if aligned else 2), 256, 8192)
    assert va.route(dtype, hd, t, *alignments) == want


def test_segment_rows_orders_rows_by_slot():
    """The work list: rows by slot in buffer order (a segment split in two
    runs and a slot id past R included), pads and ids outside [0, R) last
    as slot R, each slot's first index and row count."""
    tok_slot = torch.tensor([2, 0, -1, 2, 0, 0, 5, 1, -1], dtype=torch.int32)
    rows = va.segment_rows(tok_slot, 3)
    t = tok_slot.numel()
    assert rows.dtype == torch.int32 and rows.shape == (t + 2 * 4,)
    order, first, count = rows[:t], rows[t:t + 4], rows[t + 4:]
    assert order.tolist() == [1, 4, 5, 7, 0, 3, 2, 6, 8]
    assert first.tolist() == [0, 3, 4, 6]
    assert count.tolist() == [3, 1, 2, 3]


def _tc_varlen_emulated(q, kc, ks, vc, vs, pool_pos, bt, q_pos, tok_slot,
                        kf, vf):
    """K4's bf16 route in PyTorch (port layout, f32 tensors holding
    bf16-exact q and fresh k/v). Segments of several rows: per tile of 64
    of the segment's query rows (f = i·G + g over its rows in buffer
    order) and kv head, the slot's history tiles below min(start, its
    slots), then the segment's fresh-key tiles with a key at or before the
    tile's last query, with K3's tensor-core arithmetic (a history key
    counts for every row of the slot, a fresh key causally). One-row
    segments: per query head, the history in splits of ``DECODE_SPLIT``
    keys, each an f32 softmax (split 0 with the row's own fresh key), the
    splits merged in split order."""
    kh_n, t_n, g_n, hd = q.shape
    r_n, nb = bt.shape
    page = kc.shape[2]
    keys_a_tile = 32 if hd == 256 else 64
    split = va.DECODE_SPLIT[hd]
    start = va.segment_start(q_pos, tok_slot, r_n)
    rows = va.segment_rows(tok_slot, r_n)
    order, first, count = (rows[:t_n], rows[t_n:t_n + r_n + 1],
                           rows[t_n + r_n + 1:])
    scale2 = math.log2(math.e) / math.sqrt(hd)
    k_hist = gather_pages(kc, bt).float()  # (R, K, Sp, hd) codes
    v_hist = gather_pages(vc, bt).float()
    ks_hist, vs_hist = gather_pages(ks, bt), gather_pages(vs, bt)
    pos_hist = gather_pages(pool_pos, bt)  # (R, Sp)
    out = torch.zeros(q.shape, dtype=torch.float32)
    for r in range(r_n):
        c = int(count[r])
        if c == 0:
            continue
        seg = order[int(first[r]):int(first[r]) + c].long()
        st = int(start[r])
        n_hist = min(st, nb * page)
        p_all = pos_hist[r, :n_hist]
        ok_all = (p_all >= 0) & (p_all < st)
        for kh in range(kh_n):
            if c == 1:  # a decode row: splits merged in order
                row = int(seg[0])
                for g in range(g_n):
                    qv = q[kh, row, g] / math.sqrt(hd)
                    parts = []
                    for k0 in range(0, max(n_hist, 1), split):
                        k1 = min(n_hist, k0 + split)
                        s = (k_hist[r, kh, k0:k1] @ qv) * ks_hist[r, kh, k0:k1]
                        vals = v_hist[r, kh, k0:k1] \
                            * vs_hist[r, kh, k0:k1, None]
                        ok = ok_all[k0:k1]
                        if k0 == 0 and int(q_pos[row]) >= 0:
                            s = torch.cat([s, (kf[kh, row] @ qv)[None]])
                            vals = torch.cat([vals, vf[kh, row][None]])
                            ok = torch.cat([ok, torch.ones(1, dtype=bool)])
                        m = float(s[ok].max()) if bool(ok.any()) else -1e30
                        p = torch.where(ok, torch.exp(s - m), 0.0)
                        parts.append((m, float(p.sum()), p @ vals))
                    mx = max(m for m, _, _ in parts)
                    w = [math.exp(m - mx) for m, _, _ in parts]
                    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
                    acc = sum(wi * a for wi, (_, _, a) in zip(w, parts))
                    if mx > -0.5e30:
                        out[kh, row, g] = acc / max(l, 1e-30)
                continue
            rows_q = q[kh, seg].reshape(c * g_n, hd)
            rowpos = q_pos[seg].repeat_interleave(g_n)
            res = torch.zeros(c * g_n, hd)
            for f0 in range(0, c * g_n, 64):
                qr, qp = rows_q[f0:f0 + 64], rowpos[f0:f0 + 64]
                maxq = int(qp.max())
                tiles = []  # (keys, values, positions, score, v scale, hist)
                for t0 in range(0, n_hist, keys_a_tile):
                    t1 = min(t0 + keys_a_tile, n_hist)
                    tiles.append((k_hist[r, kh, t0:t1], v_hist[r, kh, t0:t1],
                                  torch.where(ok_all[t0:t1], p_all[t0:t1], -1),
                                  ks_hist[r, kh, t0:t1] * scale2,
                                  vs_hist[r, kh, t0:t1], True))
                for j0 in range(0, c, keys_a_tile):
                    keys = seg[j0:j0 + keys_a_tile]
                    p = q_pos[keys]
                    if not bool(((p >= 0) & (p <= maxq)).any()):
                        continue
                    n = keys.numel()
                    tiles.append((kf[kh, keys], vf[kh, keys], p,
                                  torch.full((n,), scale2), torch.ones(n),
                                  False))
                m = torch.full((qr.shape[0],), -1e30)
                l = torch.zeros(qr.shape[0])
                acc = torch.zeros(qr.shape[0], hd)
                for keys, values, kpos, csc, vsc, hist in tiles:
                    valid = (kpos[None, :] >= 0) & (
                        hist | (kpos[None, :] <= qp[:, None]))
                    sc = torch.where(valid, (qr @ keys.T) * csc, -1e30)
                    m_new = torch.maximum(m, sc.max(dim=1).values)
                    corr = torch.exp2(m - m_new)
                    p = torch.where(valid, torch.exp2(sc - m_new[:, None]),
                                    0.0)
                    l = l * corr + p.sum(dim=1)
                    pv = p * vsc
                    hi = _bf16(pv)
                    lo = _bf16(pv - hi)
                    acc = acc * corr[:, None] + hi @ values + lo @ values
                    m = m_new
                seen = m > -0.5e30
                res[f0:f0 + 64] = torch.where(
                    seen[:, None], acc / l.clamp_min(1e-30)[:, None], 0.0)
            out[kh, seg] = res.view(c, g_n, hd)
    return out


def test_k4_tensor_core_arithmetic_meets_the_tolerance():
    """The tiny config's attention (hd 32, G 2, 2 kv heads) over a pack of
    a decode row whose 600-token history is split over three blocks, a
    short decode row, a continuation chunk of 70 rows over 150 tokens of
    history (three query tiles, three history tiles, two fresh tiles), a
    first chunk of 40 and three pad rows, laid out out of slot order: the
    emulated bf16 route agrees with the Pallas kernel (interpret mode)
    within ATOL; pads are exact zeros."""
    cfg = get_config("llama2-7b-tiny")
    attn = cfg.pattern[0].mixer
    kh, g, hd = attn.num_kv_heads, attn.num_heads // attn.num_kv_heads, \
        attn.head_dim
    assert (kh, g, hd) == (2, 2, 32)
    rng = np.random.default_rng(16)
    page = 16
    segs = [(600, 1), (150, 70), (20, 1), (0, 40)]  # (history, fresh)
    assert 600 > 2 * va.DECODE_SPLIT[hd]
    totals = [h + n for h, n in segs]
    nb = max(-(-n // page) for n in totals)
    p_n = 1 + sum(-(-n // page) for n in totals)
    bt = np.zeros((len(segs), nb), np.int32)
    pool_pos = np.full((p_n, page), -1, np.int32)
    pages = rng.permutation(np.arange(1, p_n))
    nxt = 0
    for i, n in enumerate(totals):
        for b in range(-(-n // page)):
            bt[i, b] = pages[nxt]
            nxt += 1
        for t in range(n):
            pool_pos[bt[i, t // page], t % page] = t
    pad = 3
    t_n = sum(n for _, n in segs) + pad
    q_pos = np.full((t_n,), -1, np.int32)
    tok_slot = np.full((t_n,), -1, np.int32)
    cur = 0
    for i in (3, 0, 1, 2):
        h, n = segs[i]
        q_pos[cur:cur + n] = np.arange(h, h + n)
        tok_slot[cur:cur + n] = i
        cur += n

    def bf16_exact(*shape):
        return _bf16(torch.from_numpy(
            rng.normal(size=shape).astype(np.float32))).numpy()

    q = bf16_exact(kh, t_n, g, hd)
    kf = bf16_exact(kh, t_n, hd)
    vf = bf16_exact(kh, t_n, hd)
    kc = rng.integers(-127, 128, (p_n, kh, page, hd)).astype(np.int8)
    vc = rng.integers(-127, 128, (p_n, kh, page, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (p_n, kh, page)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (p_n, kh, page)).astype(np.float32)

    args = (q, kc, ks, vc, vs, pool_pos, bt, q_pos, tok_slot, kf, vf)
    got = _tc_varlen_emulated(*[torch.from_numpy(a) for a in args])
    want = np.asarray(jax_varlen(*map(jnp.asarray, args), interpret=True))
    assert float(np.abs(got.numpy() - want).max()) <= ATOL
    pads = tok_slot < 0
    assert (got.numpy()[:, pads] == 0).all() and (want[:, pads] == 0).all()
