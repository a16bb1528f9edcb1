"""Sweep K7's large-M variants on the card (the data ``dequant_matmul.
large_plan``'s cost model is fitted to) and time K4's two routes.

    python -m repro_torch.kernels.sweep [--m 128,256,384,512,600]

Needs a CUDA card. For each M (K 4096, N 11008, bf16 x, w_up's product)
it prints one JSON line: the device time of every compiled large-M tile
(rows of x ``bm`` by 128·``jn`` columns, one K range), of the two
tensor-core routes with their plans (``tc_gemm_kernel`` and the large-M
kernel, whatever ``LARGE_M_MIN`` says), and of ``x @ W`` over the bf16
weights; then the same but the tiles at w_q's and w_down's shapes; then
K4 at the packed tick's shape on both routes. Times are medians of
CUDA-event timings of single calls, the L2 flushed and the device held
busy until the call is enqueued, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels.probe import timer
from repro_torch.kernels import varlen_attention as va
from repro_torch.kernels.paged_decode_attention import TRASH_PAGE


def _large(x, codes, scale, bm, jn):
    """The large-M kernel with a forced tile and one K range."""
    m, k = x.shape
    n = codes.shape[1]
    units = -(-m // bm) * -(-n // (128 * jn))
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    err = dm._large_launcher()(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None, m, n, k, bm, jn, 1, -(-k // 64) * 64,
        min(units, dm._sm_count(0)), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def _routed(x, codes, scale, large_m_min):
    """The wrapper's call with the large-M threshold set to
    ``large_m_min`` (5: always the large-M kernel with its plan; past M:
    always ``tc_gemm_kernel`` with its split-K plan)."""
    keep = dm.LARGE_M_MIN
    dm.LARGE_M_MIN = large_m_min
    try:
        return dm.dequant_matmul(x, codes, scale)
    finally:
        dm.LARGE_M_MIN = keep


def sweep_k7(ms) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    for k, n, variants in ((4096, 11008, True), (4096, 4096, False),
                           (11008, 4096, False)):
        codes = torch.randint(-7, 8, (k, n), generator=gen, device="cuda",
                              dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device="cuda") * 0.01 + 1e-4
        w = (codes.float() * scale).to(torch.bfloat16)
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            fns = {"library": lambda: x @ w,
                   "tensor_cores": lambda: _routed(x, codes, scale, m + 1),
                   "tensor_cores_large_m": lambda: _routed(x, codes, scale,
                                                           5)}
            if variants:
                for jn, rows in dm.LARGE_TILE_ROWS.items():
                    for bm in rows:
                        fns[f"bm{bm}_jn{jn}"] = (
                            lambda bm=bm, jn=jn: _large(x, codes, scale, bm,
                                                        jn))
            print(json.dumps({
                "m_k_n": [m, k, n],
                "route": dm.route(m, n, k, x.dtype, x.data_ptr(),
                                  codes.data_ptr(), scale.data_ptr()),
                "plan": dm.large_plan(m, n, k, dm._sm_count(0)),
                "us": timer(fns)}), flush=True)


def sweep_k4() -> None:
    """K4 at the packed tick's shape (six decode rows over 1023 to 1
    tokens, a chunk of 200 over 256, a first chunk of 50, 8 pads; K 32,
    hd 128, page 16, nb 64) in bf16 on both routes."""
    rng = np.random.default_rng(5)
    segs = [(1023, 1), (700, 1), (300, 1), (64, 1), (17, 1), (1, 1),
            (256, 200), (0, 50)]
    kh, hd, page, nb, pad = 32, 128, 16, 64, 8
    p = 1 + sum(-(-(h + n) // page) for h, n in segs)
    bt = np.full((len(segs), nb), TRASH_PAGE, np.int32)
    pool_pos = np.full((p, page), -1, np.int32)
    nxt = 1
    for i, (h, n) in enumerate(segs):
        for tok in range(h + n):  # the pool holds the call's tokens too
            if tok % page == 0:
                bt[i, tok // page] = nxt
                nxt += 1
            pool_pos[bt[i, tok // page], tok % page] = tok
    t = sum(n for _, n in segs) + pad
    q_pos = np.full((t,), -1, np.int32)
    tok_slot = np.full((t,), -1, np.int32)
    cur = 0
    for i, (h, n) in enumerate(segs):
        q_pos[cur:cur + n] = np.arange(h, h + n)
        tok_slot[cur:cur + n] = i
        cur += n

    def dev(a):
        return torch.from_numpy(a).cuda()

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).cuda().to(torch.bfloat16)

    args = [rand(kh, t, 1, hd),
            dev(rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)),
            dev(rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32)),
            dev(rng.integers(-127, 128, (p, kh, page, hd)).astype(np.int8)),
            dev(rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32)),
            dev(pool_pos), dev(bt), dev(q_pos), dev(tok_slot)]
    start = va.segment_start(args[7], args[8], len(segs))
    full = (*args, start, rand(kh, t, hd), rand(kh, t, hd))
    rows = va.segment_rows(args[8], len(segs))

    def cuda_cores():
        route = va.route
        va.route = lambda *a: "cuda_cores"
        try:
            return va.varlen_attention(*full)
        finally:
            va.route = route

    print(json.dumps({"k4": "packed tick, bf16", "us": timer({
        "tensor_cores": lambda: va.varlen_attention(*full, rows),
        "tensor_cores_work_list_inside": lambda: va.varlen_attention(*full),
        "work_list": lambda: va.segment_rows(args[8], len(segs)),
        "cuda_cores": cuda_cores}, iters=20)}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", default="128,256,384,512,600",
                    help="comma-separated M of the K7 sweep")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}), flush=True)
    sweep_k7([int(m) for m in args.m.split(",")])
    sweep_k4()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
