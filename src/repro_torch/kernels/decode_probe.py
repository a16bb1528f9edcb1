"""Probe what holds K7's decode GEMV, K2, K1 and K6 back, on the card:
variants of ``gemv16_kernel``, ``paged_split_kernel``,
``decode_split_kernel`` and ``ts_encode_kernel`` built from edited copies of
their sources into ``build/`` and timed beside the kernels as they are,
with the L2 flushed two ways.

    python -m repro_torch.kernels.decode_probe [--only gemv,k2,k1,k6]
        [--k1-baseline OLD/decode_attention.cu]

Needs a CUDA card and nvcc. Times are medians of 20 single calls timed in
turns by ``probe.timer``, after each of its two flushes of the L2
(``dirty`` and ``clean``).

The GEMV at llama2-7b's three decode products (M 1) and w_up at M 4, bf16
x: the kernel with ``gemv_plan``'s K split, with the split that gives 1 to
4 blocks an SM, the older ``gemv_kernel`` (8-byte loads, a reduction
launch), ``x @ W`` over bf16 weights, a launch that does no work
(``torch.cuda._sleep(1)``: the floor of the timing), and the variants

  * ``unroll_half`` / ``unroll_double``: U = 2 or 8 code rows a warp a
    pass at one row of x, 4 or 16 at four (the kernel's are 4 and 8);
  * ``no_prefetch``: a pass's loads are issued after the FMAs on the last;
  * ``no_fma``: the codes are loaded and XOR-folded, nothing multiplied
    (wrong results: its time is the loads');
  * ``ld_cg`` / ``ld_l2_256``: the codes loaded with ``ld.global.cg``
    (L2 only), or with the 256-byte L2 prefetch hint;
  * ``no_tail``: no ticket and no sum of the K ranges (wrong results: its
    time is the product's without the last block's sum);
  * ``tail_no_sum``: the tickets taken, the last block's sum skipped (wrong
    results).

K2 at the serve shape (the ``chip_smoke.py`` kernels phase's) and at a
decode tick's (eight rows of 129 tokens, through a table of 64 pages and of
16): the wrapper (its route), each route forced (``launch_route``), and
the split kernel's variants

  * ``no_walk``: staged and merged, the two passes over the keys skipped
    (wrong results: its time is the staging's and the merge's);
  * ``no_merge``: no ticket and no merge of a row's splits (wrong
    results);
  * ``two_a_sm`` / ``one_a_sm``: 100 KB (200 KB) of shared memory asked
    for a unit, so that at most two units (one) share an SM where the
    kernel's 68 KB lets three;
  * ``split128``: splits of 128 keys (eight for the 1024-token row);
  * ``last_split_first``: the splits launched last first (the kernel
    launches them in order);
  * ``staged_one_split``: a row that fits one split staged and written by
    its unit, as the longer rows' splits are (the kernel walks it in one
    pass).

K1 at the kernels phase's main shape (B 4, K 32, S 1024, every slot live),
the fused serve run's decode rows (B 2, q_pos 191: its last step), the
split run's (B 1, 160 live slots) and h2o-danube-3-4b's decode step (B 2,
K 8, G 4, hd 120, 4096 live slots), bf16 q: the wrapper, SDPA over K/V
dequantized to bf16 beforehand, an empty launch, the kernel's variants

  * ``units_64`` / ``units_128``: units of 64 or 128 slots (the kernel's
    are 256: ``decode_attention.unit_keys`` is fitted to these);
  * ``no_walk``: staged and merged, the two passes over the keys skipped
    (wrong results: its time is the staging's and the merge's);
  * ``no_merge``: no ticket and no merge of a row's units (wrong results
    where a row has several);
  * ``two_a_sm``: 100 KB of shared memory asked for a unit, so that at
    most two units share an SM where 256 keys' 68 KB lets three;

and, with ``--k1-baseline``, an earlier K1 source with the whole-cache
kernel's C entry (``decode_attention_launch`` with no workspace, as the
port's first K1 had: one block a (row, kv-head, head group) streaming all
S slots), e.g. the parent commit's, unpacked with ``git archive``.

K6 (``ts_mask.ts_encode``) at a decode payload (T 1) and a 128-token one,
D 4096, f32, τ 5, the codec's capacity: the wrapper, its plain version and
an empty launch, timed; and ``stamps``, a copy that records ``clock64`` in
the last block at the end of each step (the tile, its place in the
workspace, the ticket, the candidates' copy with the first radix pass's
histogram, the select's bin searches and later passes, S placed, the
sort, the carrier), as cycles from the block's start, medians of 5 calls
after a dirty flush; with the select's passes.

Prints one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import paged_decode_attention as pda
from repro_torch.kernels.probe import build_variants, edit, timer
from repro_torch.kernels.tickets import tickets


_FETCH_NEXT = "    fetch(nxt, p + 1);  // zeros past the range: no load\n"
_NEXT_TO_CUR = """#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = nxt[u];
"""
_FMA = "        for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv[m], w[j], acc[m][j]);"


def gemv_variants(src: str) -> dict:
    unroll = "constexpr int gemv_unroll() { return MT == 1 ? 4 : 8; }"
    load = "ld.global.nc.L1::no_allocate.v4.u32"
    return {
        "unroll_half": edit(src, unroll, unroll.replace("4 : 8", "2 : 4")),
        "unroll_double": edit(src, unroll, unroll.replace("4 : 8",
                                                           "8 : 16")),
        "no_prefetch": edit(edit(src, _FETCH_NEXT, ""), _NEXT_TO_CUR,
                             _NEXT_TO_CUR.replace(
                                 "cur[u] = nxt[u];", "(void)nxt[u];")
                             + "    fetch(cur, p + 1);\n"),
        "ld_cg": edit(src, load, "ld.global.cg.v4.u32"),
        "ld_l2_256": edit(src, load, load.replace(".v4", ".L2::256B.v4")),
        "no_fma": edit(src, _FMA, _FMA.replace(
            "fmaf(xv[m], w[j], acc[m][j])",
            "__int_as_float(__float_as_int(acc[m][j]) ^ cur[u].x)")),
        "no_tail": edit(src, _TAIL, _TAIL.replace(
            "if (splits == 1) return;", "return;")),
        "tail_no_sum": edit(src, _LAST, _LAST.replace(
            "if (!last) return;", "if (!last || splits > 0) return;")),
    }


_LAST = "  if (!last) return;\n  __threadfence();\n  // each thread's outputs"
_TAIL = """  if (splits == 1) return;

  // the block that takes a tile's last ticket"""
_PASS = "  for (int t = 0; t < KPL; ++t) {"
_MERGE = "  // the unit that takes the row's last ticket merges its splits in order\n"


_ONE_SPLIT = "  if (n_slots <= S::KEYS) {"
_PART_AT = """    const size_t at =
        (((size_t)r * splits + split) * a.K + kh) * a.G + g0 + g;
"""
_WRITE_ONE = """    if (n_split == 1) {
      if (d < HD)
        a.out[(rk * a.G + g0 + g) * HD + d] =
            mx > 0.5f * kNegInf ? v / fmaxf(lsum, 1e-30f) : 0.f;
      continue;
    }
"""
_SMEM = "  return Split<HD>::STAGE > merge ? Split<HD>::STAGE : merge;"
_KEYS = "  static constexpr int KEYS = HD == 256 ? 128 : 256;"
_ORDER = "splits = gridDim.z, split = blockIdx.z;"


def k2_variants(src: str) -> dict:
    if src.count(_PASS) != 2:
        raise RuntimeError("the kernel source changed: cannot find its two "
                           "passes over a lane group's keys")
    return {
        "no_walk": src.replace(_PASS, _PASS.replace("t < KPL", "t < 0")),
        "no_merge": edit(src, _MERGE, "  return;\n"),
        # shared memory asked for so that at most 2 (1) units share an SM
        "two_a_sm": edit(src, _SMEM, "  return 100 * 1024;"),
        "one_a_sm": edit(src, _SMEM, "  return 200 * 1024;"),
        "split128": edit(src, _KEYS, _KEYS.replace(
            "HD == 256 ? 128 : 256", "128")),
        "last_split_first": edit(src, _ORDER, _ORDER.replace(
            "split = blockIdx.z", "split = splits - 1 - (int)blockIdx.z")),
        "staged_one_split": edit(edit(edit(
            src, _ONE_SPLIT, "  if (n_slots == 0) {"), _PART_AT,
            _WRITE_ONE + _PART_AT), _MERGE, "  if (n_split == 1) return;\n"
            + _MERGE),
    }


# the variants' keys a split at hd 128, where the kernel's differ
K2_VARIANT_KEYS = {"split128": 128}


def _gemv_call(lib, x, codes, scale, vec, splits):
    """One GEMV launch through ``lib``'s C entry with a forced split."""
    m, k = x.shape
    n = codes.shape[1]
    mt = 1 if m == 1 else dm.GEMV_MAX_M
    out = torch.empty((m, n), dtype=torch.float32, device="cuda")
    part = torch.empty((splits, m, n), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ticket = tickets(x.device, stream, -(-n // 512) * -(-m // mt))
    err = lib.dequant_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        scale.data_ptr(), out.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), m, n, k, vec, mt, splits, stream)
    if err:
        raise RuntimeError(f"GEMV launch failed: CUDA error {err}")
    return out


def probe_gemv(time_us, sms: int) -> None:
    src = (build.CSRC / "dequant_matmul.cu").read_text()
    libs = build_variants("decode_probe_gemv",
                          {"as_is": src, **gemv_variants(src)})
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.dequant_matmul_launch.argtypes = [p, i, p, p, p, p, p] \
            + [i] * 6 + [p]
        lib.dequant_matmul_launch.restype = i
    gen = torch.Generator(device="cuda").manual_seed(7)
    for m, k, n in ((1, 4096, 4096), (1, 4096, 11008), (1, 11008, 4096),
                    (4, 4096, 11008)):
        codes = torch.randint(-7, 8, (k, n), generator=gen, device="cuda",
                              dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (codes.float() * scale).to(torch.bfloat16)
        mt, splits = dm.gemv_plan(m, n, k, 16, sms)
        tiles = -(-n // 512) * -(-m // mt)
        by_sm = {}
        for per_sm in (1, 2, 3, 4):
            s = max(1, min(-(-per_sm * sms // tiles), k // dm.MIN_SPLIT_ROWS))
            by_sm[per_sm] = -(-k // -(-k // s))
        fns = {"kernel": lambda: dm.dequant_matmul(x, codes, scale),
               "gemv_kernel_vec8": lambda: _gemv_call(
                   libs["as_is"], x, codes, scale, 8,
                   dm.gemv_plan(m, n, k, 8, sms)[1]),
               "library": lambda: x @ w,
               # the floor of the timing: a launch that does no work
               "empty_launch": lambda: torch.cuda._sleep(1)}
        for per_sm, s in by_sm.items():
            fns[f"splits_{s}_{per_sm}_per_sm"] = (
                lambda s=s: _gemv_call(libs["as_is"], x, codes, scale, 16, s))
        for name, lib in libs.items():
            if name != "as_is":
                fns[name] = (lambda lib=lib: _gemv_call(
                    lib, x, codes, scale, 16, splits))
        nbytes = m * k * 2 + k * n + n * 4 + m * n * 4
        print(json.dumps({"gemv": [m, k, n], "plan_splits": splits,
                          "bound_us": nbytes / 3.35e12 * 1e6,
                          "us": {f: time_us(fns, flush=f) for f in ("dirty",
                                                               "clean")}}),
              flush=True)


def probe_k2(time_us) -> None:
    src = (build.CSRC / "paged_decode_attention.cu").read_text()
    libs = build_variants("decode_probe_k2",
                          {"as_is": src, **k2_variants(src)})
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.paged_decode_attention_launch.argtypes = \
            [p, i, ctypes.c_float] + [p] * 10 + [i] * 8 + [p]
        lib.paged_decode_attention_launch.restype = i
    for toks, nb in K2_TIMED:
        _probe_k2_shape(time_us, libs, toks, nb)


# K2's shapes (R 8, K 32, G 1, hd 128, page 16), with the table's width:
# the kernels phase's serve shape, a decode tick of eight rows of 129
# tokens (the paged phase's: one split a row, three more past every row),
# and the same tick through a table of 16 pages (one split in all)
K2_TIMED = (([1024, 700, 301, 64, 17, 1, 0, 500], 64), ([129] * 8, 64),
            ([129] * 8, 16))


def _probe_k2_shape(time_us, libs: dict, toks: list, nb: int) -> None:
    rng = np.random.default_rng(1)
    r, kh, g, hd, page = len(toks), 32, 1, 128, 16
    need = [-(-t // page) for t in toks]
    n_pages = 1 + sum(need) + 3
    order = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((r, nb), np.int32)
    pos = np.full((n_pages, page), -1, np.int32)
    nxt = 0
    for row, t in enumerate(toks):
        for b in range(need[row]):
            bt[row, b] = order[nxt]
            nxt += 1
        for s in range(t):
            pos[bt[row, s // page], s % page] = s
    pool = [torch.from_numpy(a).cuda() for a in (
        rng.integers(-127, 128, (n_pages, kh, page, hd), dtype=np.int8),
        rng.uniform(1e-3, 2e-2, (n_pages, kh, page)).astype(np.float32),
        rng.integers(-127, 128, (n_pages, kh, page, hd), dtype=np.int8),
        rng.uniform(1e-3, 2e-2, (n_pages, kh, page)).astype(np.float32),
        pos, bt)]
    q_pos = torch.tensor([t - 1 for t in toks], dtype=torch.int32,
                         device="cuda")
    q = torch.randn((r, kh, g, hd), device="cuda").to(torch.bfloat16)

    def call(lib, splits):
        out = torch.empty((r, kh, g, hd), dtype=torch.float32, device="cuda")
        part = torch.empty((r * splits * kh * g * (hd + 2),),
                           dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        ticket = tickets(q.device, stream, r * kh * g)
        err = lib.paged_decode_attention_launch(
            q.data_ptr(), 1, math.log2(math.e) / hd ** 0.5,
            *[t.data_ptr() for t in pool], q_pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), ticket.data_ptr(), r, kh, g, hd, page, nb,
            splits, 0, stream)
        if err:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")

    fns = {"kernel": lambda: pda.paged_decode_attention(q, *pool, q_pos),
           "single_pass_route": lambda: pda.launch_route(
               "single_pass", q, *pool, q_pos),
           "split_route": lambda: pda.launch_route("split", q, *pool, q_pos),
           "empty_launch": lambda: torch.cuda._sleep(1)}
    fns.update({name: (lambda lib=lib, s=pda.splits(
        nb, page, K2_VARIANT_KEYS.get(name, pda.SPLIT[hd])): call(lib, s))
                for name, lib in libs.items() if name != "as_is"})
    pages = sum(min(n, nb) for n in need)
    nbytes = q.numel() * 2 + pages * (kh * page * (2 * hd + 8) + page * 4) \
        + bt.size * 4 + r * 4 + r * kh * g * hd * 4
    print(json.dumps({"k2": [r, kh, g, hd, page, nb], "tokens": toks,
                      "splits": pda.splits(nb, page, pda.SPLIT[hd]),
                      "bound_us": nbytes / 3.35e12 * 1e6,
                      "us": {f: time_us(fns, flush=f)
                             for f in ("dirty", "clean")}}),
          flush=True)


# K1's shapes (B, K, G, hd, S, live slots a row): the kernels phase's main
# shape, the serve run's last decode step, the split run's longest row,
# h2o-danube-3-4b's decode step (every slot of its ring live: 16 units a
# row, each of four query heads)
K1_TIMED = ((4, 32, 1, 128, 1024, 1024), (2, 32, 1, 128, 1024, 192),
            (1, 32, 1, 128, 1024, 160), (2, 8, 4, 120, 4096, 4096))


_K1_PASS = "  for (int t = 0; t < KPL; ++t) {"
_K1_MERGE = ("  // the unit that takes the row's last ticket merges its units "
             "in order\n")
_K1_SMEM = "  return stage > merge ? stage : merge;"
_K1_KEYS = "  return HD == 256 ? 128 : 256;"
_K1_SEEN = "  const int seen = __syncthreads_or(valid != 0u);"
_K1_ANY = "    any = mx > 0.5f * kNegInf;"


def k1_variants(src: str) -> dict:
    if src.count(_K1_PASS) != 2:
        raise RuntimeError("the kernel source changed: cannot find its two "
                           "passes over a lane group's keys")
    return {
        # (and no row taken for one without a valid slot: no slow branch)
        "no_walk": edit(edit(src.replace(
            _K1_PASS, _K1_PASS.replace("t < KPL", "t < 0")), _K1_SEEN,
            _K1_SEEN.replace("valid != 0u", "1")), _K1_ANY,
            _K1_ANY.replace("mx > 0.5f * kNegInf", "1")),
        "no_merge": edit(src, _K1_MERGE, "  return;\n"),
        # shared memory asked for so that at most 2 units share an SM
        "two_a_sm": edit(src, _K1_SMEM, "  return 100 * 1024;"),
        # (a unit is whole block steps: 128 slots at hd 32)
        "units_64": edit(src, _K1_KEYS, "  return HD == 32 ? 128 : 64;"),
        "units_128": edit(src, _K1_KEYS, "  return 128;"),
    }


# the unit size of each variant at hd 128, where it differs from the kernel's
K1_VARIANT_KEYS = {"units_64": 64, "units_128": 128}


def _k1_call(lib, keys, q, kc, ks, vc, vs, pos, q_pos):
    """One K1 launch with units of ``keys`` slots through ``lib``'s C
    entry."""
    b, kh, g, hd = q.shape
    s = kc.shape[2]
    heads, _, units = da.grid(b, kh, g, s, keys)
    out = torch.empty((b, kh, g, hd), dtype=torch.float32, device="cuda")
    part = torch.empty((b * units * kh * g * (hd + 2),), dtype=torch.float32,
                       device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ticket = tickets(q.device, stream, b * heads)
    err = lib.decode_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        math.log2(math.e) / hd ** 0.5, kc.data_ptr(), ks.data_ptr(),
        vc.data_ptr(), vs.data_ptr(), pos.data_ptr(), q_pos.data_ptr(),
        0 if q_pos.numel() == 1 else 1, out.data_ptr(), part.data_ptr(),
        ticket.data_ptr(), b, kh, g, s, hd, units, stream)
    if err:
        raise RuntimeError(f"K1 launch failed: CUDA error {err}")
    return out


def _k1_baseline_call(lib, q, kc, ks, vc, vs, pos, q_pos):
    """One launch of the whole-cache kernel's C entry (base e: the scale
    is 1/sqrt(hd))."""
    b, kh, g, hd = q.shape
    out = torch.empty((b, kh, g, hd), dtype=torch.float32, device="cuda")
    err = lib.decode_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), 1.0 / hd ** 0.5,
        kc.data_ptr(), ks.data_ptr(), vc.data_ptr(), vs.data_ptr(),
        pos.data_ptr(), q_pos.data_ptr(), 0 if q_pos.numel() == 1 else 1,
        out.data_ptr(), b, kh, g, kc.shape[2], hd,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K1 baseline launch failed: CUDA error {err}")
    return out


def probe_k1(time_us, baseline: str | None = None) -> None:
    src = (build.CSRC / "decode_attention.cu").read_text()
    variants = k1_variants(src)
    if baseline:
        with open(baseline) as f:
            variants["baseline"] = f.read()
    libs = build_variants("decode_probe_k1", variants)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, lib in libs.items():
        lib.decode_attention_launch.argtypes = (
            [p, i, ctypes.c_float] + [p] * 6 + [i, p] + [i] * 5 + [p]
            if name == "baseline" else
            [p, i, ctypes.c_float] + [p] * 6 + [i] + [p] * 3 + [i] * 6 + [p])
        lib.decode_attention_launch.restype = i
    gen = torch.Generator(device="cuda").manual_seed(3)
    for b, kh, g, hd, s, live in K1_TIMED:
        q = torch.randn((b, kh, g, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        kc, vc = (torch.randint(-127, 128, (b, kh, s, hd), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((b, kh, s), generator=gen, device="cuda") * 0.02
                  + 1e-3 for _ in range(2))
        pos = torch.arange(s, dtype=torch.int32, device="cuda")
        pos = torch.where(pos < live, pos, -1).expand(b, s).contiguous()
        q_pos = torch.tensor(live - 1, dtype=torch.int32, device="cuda")
        args = (q, kc, ks, vc, vs, pos, q_pos)
        kd = (kc.float() * ks[..., None]).to(torch.bfloat16)
        vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
        mask = ((pos >= 0) & (pos <= q_pos))[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        fns = {"kernel": lambda: da.decode_attention(*args),
               "library": lambda: sdpa(q, kd, vd, attn_mask=mask),
               "empty_launch": lambda: torch.cuda._sleep(1)}
        for name, lib in libs.items():
            keys = K1_VARIANT_KEYS.get(name, da.unit_keys(hd))
            fns[name] = (
                (lambda lib=lib: _k1_baseline_call(lib, *args))
                if name == "baseline" else
                (lambda lib=lib, keys=keys: _k1_call(lib, keys, *args)))
        want = da.decode_attention_ref(*args)
        errs = {name: float((fns[name]() - want).abs().max())
                for name in ("kernel", "baseline", *K1_VARIANT_KEYS)
                if name in fns}
        nbytes = q.numel() * 2 + b * live * (kh * (2 * hd + 8) + 4) \
            + 4 + b * kh * g * hd * 4
        print(json.dumps({"k1": [b, kh, g, hd, s], "live": live,
                          "unit_keys": da.unit_keys(hd),
                          "bound_us": nbytes / 3.35e12 * 1e6,
                          "max_abs_err": errs,
                          "us": {f: time_us(fns, flush=f)
                                 for f in ("dirty", "clean")}}),
              flush=True)


# K6's steps, as ``k6_variants``' stamps mark their ends
K6_STEPS = ("tile", "place", "ticket", "copy", "select", "collect", "sort",
            "carrier")


def k6_variants(src: str) -> dict:
    """``stamps``: K6 with ``clock64`` read by thread 0 at the end of each
    of ``K6_STEPS``; the last block keeps them, and the select's passes,
    for ``ts_stamps`` to read."""
    marks = ("  const int incl = warp_scan(mine);",
             "  int p = s_base + s_scan[warp] + incl - mine;",
             "  if (!s_last) return;\n",
             "  // S, the keys in play:",
             "  // ---- 3. S placed",
             "  // sort S a chunk",
             "  // the top k of S at",
             "  if (tid == 0) {\n    count[0] = n_cand - (int)nans;")
    st = edit(src, "namespace {\n\n// the keys' type",
              "__device__ long long g_st[12];\nnamespace {\n\n"
              "// the keys' type")
    st = edit(st, "  const int tid = threadIdx.x, lane = tid & 31, "
                  "warp = tid >> 5;\n",
              "  const int tid = threadIdx.x, lane = tid & 31, "
              "warp = tid >> 5;\n  long long st[9] = {0};\n  int passes = 0;\n"
              "  if (tid == 0) st[0] = clock64();\n")
    for i, mark in enumerate(marks):
        st = edit(st, mark, f"  if (tid == 0) st[{i + 1}] = clock64();\n"
                  + mark)
    st = edit(st, "    n_s = k - need + s_sel[pass & 1][2];",
              "    passes = pass + 1;\n    n_s = k - need + s_sel[pass & 1][2];")
    st = edit(st, "    count[0] = n_cand - (int)nans;",
              "    for (int i = 0; i < 9; ++i) g_st[i] = st[i] - st[0];\n"
              "    g_st[9] = passes;\n    count[0] = n_cand - (int)nans;")
    return {"stamps": st + """
extern "C" int ts_stamps(long long* out) {
  cudaMemcpyFromSymbol(out, g_st, 10 * sizeof(long long));
  return (int)cudaGetLastError();
}
"""}


def probe_k6(time_us) -> None:
    from repro_torch.kernels import ts_mask as tsm
    from repro_torch.kernels.tickets import scratch

    src = (build.CSRC / "ts_mask.cu").read_text()
    lib = build_variants("decode_probe_k6", k6_variants(src))["stamps"]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ts_encode_launch.argtypes = [p, i, ctypes.c_float, ctypes.c_longlong,
                                     i] + [p] * 7
    lib.ts_encode_launch.restype = i
    lib.ts_stamps.argtypes = [p]
    gen = torch.Generator(device="cuda").manual_seed(5)
    dirty = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for t in (1, 128):
        x = (torch.randn((t, 4096), generator=gen, device="cuda") * 2).to(
            torch.bfloat16).float()  # bf16-origin, as the split payload
        cap = max(16, x.numel() // 1024)
        n = x.numel()
        outs = (torch.empty_like(x), torch.empty(cap, device="cuda"),
                torch.empty(cap, dtype=torch.int64, device="cuda"),
                torch.empty((), dtype=torch.int32, device="cuda"))
        stream = torch.cuda.current_stream().cuda_stream
        state, work = scratch(x.device, stream, tsm.STATE_WORDS,
                              tsm.workspace_floats(n, cap))
        runs = []
        for _ in range(5):
            dirty.zero_()
            torch.cuda._sleep(20_000_000)
            if lib.ts_encode_launch(x.data_ptr(), 0, 5.0, n, cap,
                                    *[o.data_ptr() for o in outs],
                                    state.data_ptr(), work.data_ptr(),
                                    stream):
                raise RuntimeError("the stamps variant failed to launch")
            torch.cuda.synchronize()
            out = (ctypes.c_longlong * 10)()
            lib.ts_stamps(out)
            runs.append(list(out))
        med = [sorted(r[j] for r in runs)[2] for j in range(10)]
        want = tsm.ts_encode_ref(x, 5.0, cap)
        same = all(torch.equal(a, b) for a, b in zip(outs, want))
        fns = {"kernel": lambda: tsm.ts_encode(x, 5.0, cap),
               "plain": lambda: tsm.ts_encode_ref(x, 5.0, cap),
               "empty_launch": lambda: torch.cuda._sleep(1)}
        print(json.dumps({"k6": [t, 4096], "capacity": cap,
                          "count": int(want[3]), "stamps_equal_plain": same,
                          "passes": med[9],
                          "cycles_at_end_of": dict(zip(K6_STEPS, med[1:9])),
                          "us": {f: time_us(fns, flush=f)
                                 for f in ("dirty", "clean")}}), flush=True)


PROBES = ("gemv", "k2", "k1", "k6")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PROBES),
                    help="comma-separated subset of " + ",".join(PROBES))
    ap.add_argument("--k1-baseline", default=None,
                    help="an earlier decode_attention.cu with the "
                         "whole-cache kernel's C entry, timed beside K1")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    if set(only) - set(PROBES):
        ap.error(f"unknown probes {sorted(set(only) - set(PROBES))}")
    if not torch.cuda.is_available():
        raise SystemExit("the probe needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    time_us = functools.partial(timer, iters=20)
    if "gemv" in only:
        probe_gemv(time_us,
                   torch.cuda.get_device_properties(0).multi_processor_count)
    if "k2" in only:
        probe_k2(time_us)
    if "k6" in only:
        probe_k6(time_us)
    if "k1" in only:
        probe_k1(time_us, args.k1_baseline)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
