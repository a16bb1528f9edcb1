#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --phases env,kernels

Phases, each printing one JSON line:

  env      the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the kernels' build time;
  kernels  every kernel against its plain PyTorch version on the card at
           the main path's shapes and at edge shapes, with the tolerance
           stated, and at the main path's shape its time beside its bound,
           the plain version's time and a library call's time;
  model    llama2-7b tiny run greedily on the CPU (plain path) and on the
           card (kernel path): logits and tokens must agree;
  vehicle  the committed induction checkpoint served through
           LLMServer(backend="fused") on the card: copy accuracy, and
           tokens equal to the CPU run's;
  serve    llama2-7b at full width (random bf16 weights, int8 KV cache)
           answering four requests through LLMServer(backend="fused");
           every kernel launch counter is set to 0 just before this run
           and read just after.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Without a CUDA card, or without the repository's ``src/``
beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
PHASES = ("env", "kernels", "model", "vehicle", "serve")

# kernel vs plain, q in f32 or bf16: both widen the same q to f32 exactly and
# do the same f32 math, so they differ only in summation order
ATOL = 1e-4


def emit(obj) -> None:
    # numpy scalars print as plain numbers
    print(json.dumps(obj, default=lambda o: o.item()), flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def peak_rates(name: str) -> tuple:
    """(device-memory bytes/s, f32 CUDA-core flop/s) of an H100 SXM, from
    NVIDIA's data sheet (dense, at the full power limit)."""
    if "H100" not in name or "HBM3" not in name:
        raise SystemExit(f"no peak rates for {name!r}: only the H100 SXM "
                         f"(HBM3) is known")
    return 3.35e12, 67e12


class Timer:
    """Medians of CUDA-event timings of single calls, with the 50 MB L2
    flushed before each call (a decode layer finds its cache cold). Several
    functions are timed in turns (a, b, c, a, b, c, ...), so that a change
    of clock during the timing reaches them alike.

    With ``device_only`` the device spins for ``HOLD_CYCLES`` after the
    flush, so the host has enqueued the whole call before the first event
    fires: the timing is the call's device time, without the host's launch
    cost (tens of µs per PyTorch call on a shared host, more than a kernel
    takes). Without it the timing includes the host, as a request sees."""

    HOLD_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=device)

    def _once(self, fn, device_only: bool) -> float:
        torch = self.torch
        self.flush.zero_()
        if device_only:
            torch.cuda._sleep(self.HOLD_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    def __call__(self, fns: dict, iters: int = 30, warmup: int = 3,
                 device_only: bool = True) -> dict:
        """{name: median ms} of each function in ``fns``."""
        for fn in fns.values():
            for _ in range(warmup):
                fn()
        times = {name: [] for name in fns}
        for _ in range(iters):
            for name, fn in fns.items():
                times[name].append(self._once(fn, device_only))
        return {name: statistics.median(t) for name, t in times.items()}


# ------------------------------------------------------------------ phases


def phase_env(ctx) -> None:
    import torch
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    names = ["decode_attention"]
    for name in names:
        build.load(name)
    build_s = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in build.BUILD_LOG.items()}
    emit({"phase": "env", "nvidia_smi": ctx["smi"],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": build_s, "kernels_built": names, "ptxas": ptxas})


def _decode_inputs(torch, b, kh, g, hd, s, fill, qdtype, gen, device,
                   q_pos=None):
    q = torch.randn((b, kh, g, hd), generator=gen, device=device).to(qdtype)
    kc = torch.randint(-127, 128, (b, kh, s, hd), generator=gen,
                       device=device, dtype=torch.int8)
    vc = torch.randint(-127, 128, (b, kh, s, hd), generator=gen,
                       device=device, dtype=torch.int8)
    ks = torch.rand((b, kh, s), generator=gen, device=device) * 0.02 + 1e-3
    vs = torch.rand((b, kh, s), generator=gen, device=device) * 0.02 + 1e-3
    pos = torch.arange(s, dtype=torch.int32, device=device)
    pos = torch.where(pos < fill, pos, -1).expand(b, s).contiguous()
    if q_pos is None:
        q_pos = torch.tensor(fill - 1, dtype=torch.int32, device=device)
    return q, kc, ks, vc, vs, pos, q_pos


def phase_kernels(ctx) -> None:
    import torch
    from repro_torch.kernels import decode_attention as da

    device = ctx["device"]
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = [  # (B, K, G, hd, S, fill, per-row q_pos or None)
        (4, 32, 1, 128, 1024, 1024, None),  # main path
        (4, 32, 1, 128, 4096, 200, None),  # long cache, 200 slots filled
        (2, 2, 2, 32, 96, 50, None),  # llama2-7b tiny
        (2, 2, 6, 64, 600, 450, None),  # G = 6, S not a multiple of 512
        (2, 2, 2, 32, 96, 96, [40, -1]),  # row 1 fully masked, per-row q_pos
        (1, 1, 48, 128, 700, 700, None),  # MQA group of 48
        (2, 4, 3, 256, 130, 100, None),  # hd 256, ragged G
    ]
    checks, worst = [], 0.0
    for (b, kh, g, hd, s, fill, qp) in shapes:
        for qdtype in (torch.float32, torch.bfloat16):
            q_pos = None if qp is None else torch.tensor(
                qp, dtype=torch.int32, device=device)
            args = _decode_inputs(torch, b, kh, g, hd, s, fill, qdtype, gen,
                                  device, q_pos)
            got = da.decode_attention(*args)
            want = da.decode_attention_ref(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= ATOL
            checks.append({"shape": [b, kh, g, hd, s, fill], "q_pos": qp,
                           "q_dtype": str(qdtype)[6:], "max_abs_err": err,
                           "atol": ATOL, "ok": ok})
            worst = max(worst, err)
            if not ok:
                emit({"phase": "kernels", "checks": checks})
                raise SystemExit(f"decode_attention disagrees: {checks[-1]}")

    # time at the main path's shape with the main path's bf16 q
    b, kh, g, hd, s = 4, 32, 1, 128, 1024
    args = _decode_inputs(torch, b, kh, g, hd, s, s, torch.bfloat16, gen,
                          device)
    q, kc, ks, vc, vs, pos, q_pos = args
    # the library call is a yardstick only (the port never calls it): SDPA
    # over K/V dequantized to bf16 beforehand, with the same position mask
    kd = (kc.float() * ks[..., None]).to(torch.bfloat16)
    vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
    mask = ((pos >= 0) & (pos <= q_pos))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    clocks_query = "clocks.sm,clocks.max.sm,power.draw"
    clocks_before = nvidia_smi(clocks_query)
    ms = ctx["timer"]({"kernel": lambda: da.decode_attention(*args),
                       "plain": lambda: da.decode_attention_ref(*args),
                       "library": lambda: sdpa(q, kd, vd, attn_mask=mask)})
    clocks_after = nvidia_smi(clocks_query)
    kernel_ms, plain_ms, library_ms = ms["kernel"], ms["plain"], ms["library"]
    bw, f32_peak = peak_rates(ctx["device_name"])
    nbytes = (q.numel() * q.element_size() + 2 * kc.numel() + 2 * ks.numel() * 4
              + pos.numel() * 4 + q_pos.numel() * 4 + b * kh * g * hd * 4)
    flops = 4 * b * kh * g * s * hd
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / f32_peak * 1e3
    ctx["kernels"]["decode_attention"] = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:113",
        "launches": None, "max_abs_err": worst, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms}
    emit({"phase": "kernels", "checks": checks,
          "main_shape": [b, kh, g, hd, s], "bytes": nbytes, "flops": flops,
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
          "achieved_GBps": nbytes / kernel_ms / 1e6,
          "clocks_sm_max_sm_power": [clocks_before, clocks_after]})


def _greedy_stepwise(params, cfg, prompts, n, opts, cache_len, device):
    """Greedy decoding through prefill/decode_step: tokens (B, n) and the
    logits each token was drawn from, (B, n, V), both numpy."""
    import torch
    from repro_torch.models.transformer import decode_step, prefill

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device=device)
        logits, caches = prefill(params, cfg, tokens, cache_len, opts)
        toks, lgs = [], []
        for t in range(n):
            nxt = logits.argmax(-1)
            toks.append(nxt.cpu().numpy())
            lgs.append(logits.cpu().numpy())
            if t + 1 < n:
                logits, caches = decode_step(
                    params, cfg, nxt[:, None], caches,
                    torch.tensor(tokens.shape[1] + t, dtype=torch.int32,
                                 device=device), opts)
    import numpy as np

    return np.stack(toks, 1), np.stack(lgs, 1)


def _teacher_forced(params, cfg, prompts, forced, opts, cache_len, device):
    """The logits (B, n, V) at each step when the decode is fed ``forced``
    (B, n) instead of its own argmax."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import decode_step, prefill

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device=device)
        logits, caches = prefill(params, cfg, tokens, cache_len, opts)
        lgs = [logits.cpu().numpy()]
        for t in range(forced.shape[1] - 1):
            nxt = torch.as_tensor(forced[:, t:t + 1], device=device)
            logits, caches = decode_step(
                params, cfg, nxt, caches,
                torch.tensor(tokens.shape[1] + t, dtype=torch.int32,
                             device=device), opts)
            lgs.append(logits.cpu().numpy())
    return np.stack(lgs, 1)


def _margin_agreement(got, want, want_logits, tol):
    """Rows of ``got`` tokens (B, n) equal ``want`` at every step up to the
    first one whose top-1/top-2 margin in ``want_logits`` (relative to the
    largest logit) is within ``tol``. Returns (ok, steps compared)."""
    import numpy as np

    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]) / np.abs(want_logits).max()
    compared = 0
    for r in range(got.shape[0]):
        close = np.nonzero(margin[r] <= tol)[0]
        upto = close[0] + 1 if close.size else got.shape[1]
        compared += upto
        if not np.array_equal(got[r, :upto], want[r, :upto]):
            return False, compared
    return True, compared


# logits on the card against the CPU run, f32 both: the card sums the
# matmuls in another order, and an int8 code can land one step apart when a
# key differs in its last bit
MODEL_REL = 1e-3


def phase_model(ctx) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.engine import Engine

    device = ctx["device"]
    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = {k: v.to(device) for k, v in cpu.items()}
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 12))
    n, cache_len = 24, 64
    want, want_lg = _greedy_stepwise(cpu, cfg, prompts, n, opts, cache_len,
                                     "cpu")
    got_lg = _teacher_forced(card, cfg, prompts, want, opts, cache_len,
                             device)
    rel = float(np.abs(got_lg - want_lg).max() / np.abs(want_lg).max())
    got = Engine(cfg, card, opts, cache_len=cache_len,
                 device=device).generate(prompts, n).tokens[:, 12:]
    ok, compared = _margin_agreement(got, want, want_lg, MODEL_REL)
    emit({"phase": "model", "config": cfg.name, "steps": n,
          "max_rel_logit_err": rel, "tol": MODEL_REL,
          "tokens_compared": compared, "tokens_equal_all": bool(
              np.array_equal(got, want)), "ok": ok and rel <= MODEL_REL})
    if not (ok and rel <= MODEL_REL):
        raise SystemExit("model: the card disagrees with the CPU run")


def phase_vehicle(ctx) -> None:
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import load_npz_checkpoint
    from repro_torch.serving.api import LLMServer

    device = ctx["device"]
    # benchmarks/common.py: llama2-7b tiny, vocab 64, 4 blocks, copy task
    cfg = dataclasses.replace(get_config("llama2-7b-tiny"), vocab_size=64,
                              num_blocks=4)
    opts = RuntimeOpts(q_chunk=64, kv_chunk=64, quantized_kv=True)
    params = load_npz_checkpoint(
        os.path.join(ROOT, "experiments", "vehicles", "induction"))
    half, vocab = 16, 64
    rng = np.random.default_rng(0)  # data/pipeline.py: [prefix][SEP][prefix]
    prefix = rng.integers(0, vocab - 1, (16, half))
    prompts = np.concatenate([prefix, np.full((16, 1), vocab - 1)], axis=1)
    srv = LLMServer(cfg, params, opts, backend="fused", cache_len=64,
                    device=device)
    rids = [srv.submit(p, SamplingParams(max_tokens=half)) for p in prompts]
    outs = srv.run()
    got = np.stack([outs[r].tokens for r in rids])
    want, want_lg = _greedy_stepwise(params, cfg, prompts, half, opts, 64,
                                     "cpu")
    ok, compared = _margin_agreement(got, want, want_lg, MODEL_REL)
    acc = float(np.mean(got == prefix))
    emit({"phase": "vehicle", "requests": len(rids), "copy_accuracy": acc,
          "cpu_copy_accuracy": float(np.mean(want == prefix)),
          "tokens_compared": compared, "ok": ok})
    if not ok:
        raise SystemExit("vehicle: the card's tokens differ from the CPU's")


def phase_serve(ctx) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sampling import (SamplingParams, sample_tokens,
                                           sampling_operands)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.transformer import (RuntimeOpts, decode_step,
                                                prefill)
    from repro_torch.params import init_params
    from repro_torch.serving import engine
    from repro_torch.serving.api import LLMServer

    device = ctx["device"]
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    cache_len = 1024
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         torch.bfloat16, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in params.values())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (128, 128, 96, 96)]

    def requests(stop_tok):
        return [SamplingParams(max_tokens=64),
                SamplingParams(max_tokens=48, stop_token_ids=stop_tok),
                SamplingParams(max_tokens=64, temperature=0.8, top_p=0.9,
                               seed=7),
                SamplingParams(max_tokens=32)]

    def serve(sps):
        srv = LLMServer(cfg, params, opts, backend="fused",
                        cache_len=cache_len, device=device)
        rids = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = srv.run()
        return [outs[r] for r in rids]

    # a first run (it also warms up) picks a stop token that will fire
    first = serve(requests(()))
    stop = int(first[1].tokens[10])
    stop_at = list(first[1].tokens).index(stop) + 1

    decode_steps = (64 - 1) + (64 - 1)  # two length groups, 64 tokens each
    da.decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = serve(requests((stop,)))
    wall_s = time.perf_counter() - t0
    launches = {"decode_attention": da.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"] = launches

    reasons = [o.finish_reason for o in outs]
    lengths = [len(o.tokens) for o in outs]
    checks = {
        "reasons": reasons == ["length", "stop", "length", "length"],
        "lengths": lengths == [64, stop_at, 64, 32],
        "same_as_first_run": all(
            np.array_equal(o.tokens, f.tokens[:len(o.tokens)])
            for o, f in zip(outs, first)),
        "tokens_in_vocab": all(int(o.tokens.min()) >= 0 and int(
            o.tokens.max()) < cfg.vocab_size for o in outs),
        "launches": launches["decode_attention"]
        == cfg.num_layers * decode_steps}

    # the engine's loop (prefill, decode steps, greedy and seeded sampling)
    # makes no host sync: CUDA sync-debug mode raises on any
    b = 2
    sps = [SamplingParams(max_tokens=8),
           SamplingParams(max_tokens=8, temperature=0.8, top_p=0.9, seed=7)]
    seeds, temp, top_k, top_p = sampling_operands(sps, device)
    with torch.inference_mode():
        toks = torch.as_tensor(np.stack(prompts[:2]), device=device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            engine._fused_generate(
                params, cfg, opts, cache_len, 8, toks,
                lambda lg, t: sample_tokens(lg, seeds, t.expand(b), temp,
                                            top_k, top_p))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    checks["no_host_sync_in_loop"] = True

    # decode step time at the first group's shape (B = 2, 128-token prompt)
    with torch.inference_mode():
        logits, caches = prefill(params, cfg, toks, cache_len, opts)
        nxt = logits.argmax(-1)[:, None]
        pos = torch.tensor(128, dtype=torch.int32, device=device)
        step = lambda: decode_step(params, cfg, nxt, caches, pos, opts)  # noqa: E731
        # host included: the host issues about 1,000 kernels per step
        step_ms = ctx["timer"]({"step": step}, iters=20,
                               device_only=False)["step"]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
    rows = []  # device kernels only: CPU ops would count their kernels again
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        rows.append((dev_us / 5 / 1e3, evt.key[:60], evt.count / 5))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    bw, _ = peak_rates(ctx["device_name"])
    weight_bytes = sum(t.numel() * t.element_size() for k, t in params.items()
                       if k != "embed") + b * cfg.d_model * 2
    m = cfg.pattern[0].mixer
    cache_bytes = cfg.num_layers * b * m.num_kv_heads * cache_len * (
        2 * m.head_dim + 8)
    emit({"phase": "serve", "config": cfg.name, "params": n_params,
          "dtype": "bfloat16", "kv": "int8", "cache_len": cache_len,
          "init_s": init_s, "requests": len(outs), "finish_reasons": reasons,
          "generated": lengths, "stop_token": stop,
          "decode_steps": decode_steps, "launches": launches,
          "wall_s": wall_s, "tokens_per_s": sum(lengths) / wall_s,
          "computed_tokens_per_s": 2 * 64 * 2 / wall_s,
          "decode_step_ms": step_ms, "decode_step_batch": b,
          "decode_step_bound_ms": (weight_bytes + cache_bytes) / bw * 1e3,
          "profile_device_ms_per_step": device_ms,
          "profile_top": [{"ms": r[0], "kernel": r[1], "calls": r[2]}
                          for r in rows[:8]],
          "max_memory_allocated": peak, "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"serve: failed checks {checks}")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.device import resolve_device

    device = resolve_device()
    ctx = {"device": device, "device_name": torch.cuda.get_device_name(0),
           "smi": nvidia_smi(), "kernels": {}, "timer": Timer(torch, device)}
    runners = {"env": phase_env, "kernels": phase_kernels,
               "model": phase_model, "vehicle": phase_vehicle,
               "serve": phase_serve}
    for name in PHASES:
        if name in phases:
            runners[name](ctx)
    if phases != list(PHASES):
        return 0  # a subset is a debugging run: no summary, no verdict
    for name, row in ctx["kernels"].items():
        row["launches"] = ctx["launches"][name]
        if row["launches"] < 1:
            raise SystemExit(f"{name} was never launched on the main path")
    emit({"kernels": list(ctx["kernels"].values())})
    print(ctx["smi"])
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
