#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # every phase, as a check of the port
    python3 chip_smoke.py --phases env,kernels,packed
    python3 chip_smoke.py --phases env,train_mesh   # only when named

Phases, each printing one JSON line:

  env      the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the kernels' build time;
  kernels  every kernel against its plain PyTorch version on the card at
           the main path's shapes and at edge shapes, with the tolerance
           stated, and at the main path's shape its time beside its bound,
           the plain version's time and a library call's time; K7 also on
           int16 codes at 12 and 15 bits (``K7_WIDE_BITS``: the GEMV at
           M <= 4, the CUDA cores above), timed at w_up beside x @ W and
           the int8 kernel;
  model    llama2-7b tiny run greedily on the CPU (plain path) and on the
           card (kernel path): logits and tokens must agree;
  vehicle  the committed induction checkpoint served through
           LLMServer(backend="fused") on the card: copy accuracy, and
           tokens equal to the CPU run's; then Eq. 8's planner
           (examples/split_inference_torch.py) on the card and on the
           CPU, each in a process of its own: every candidate's copy
           accuracy and the chosen solution equal (a candidate that parts
           is excused only by the margin rule), within its own memory
           budget and accuracy drop;
  serve    llama2-7b at full width (random bf16 weights, int8 KV cache)
           answering four requests through LLMServer(backend="fused");
           every kernel launch counter is set to 0 just before this run
           and read just after; then the same Engine with act_bits 8 (the
           uniform activation quantization): K1 counted, its logits'
           distance from the run without it, its decode step, and the
           tiny f32 model with act_bits on the card against the CPU;
  paged    llama2-7b tiny through the paged Scheduler on the CPU (plain
           versions) and on the card (kernels), then llama2-7b at full
           width (the serve phase's weights) answering ten requests
           through LLMServer(backend="paged") with chunked prefill, a
           shared prefix and mid-stream admission, its streams held to the
           dense (fused) path in bf16 and, on f32 weights, closely; the
           counters are set to 0 just before the timed run and read just
           after;
  packed   llama2-7b tiny through the packed Scheduler with lazy growth
           and preemption on the CPU and on the card, then the paged
           phase's ten requests through LLMServer(backend="paged",
           tick_mode="packed") at full width: reserve admission (513
           pages; the counters are set to 0 just before it and read just
           after: K4 once per layer and packed tick, K1 to K3 never), its
           streams on f32 weights held to the dense path, and lazy growth
           on a pool that forces preemption, with swap and with refill
           resume, each stream held to the reserve run's; then one packed
           tick beside the chunked tick doing the same work;
  split    llama2-7b tiny through the split engine on the CPU and on the
           card, then llama2-7b at full width answering four requests
           through LLMServer(backend="split") with the paper's OPSC
           defaults at ℓ = 8 (edge blocks as int4 codes through K7, TS +
           TAB-Q payloads through K6 and K5, int8 KV through K1): the
           counters are set to 0 just before that run and read just after;
           its payloads held to the plain versions'; a full-precision,
           uncompressed split held to the Engine bit for bit; a paged cloud
           with a shared prefix and the stateless I_kv = 0 cloud held to the
           dense cloud; the front at 12 bits (int16 codes through K7,
           counted by route and code width with the counters set to 0
           just before and read just after) held to the 16-bit front,
           its edge bytes beside Eq. 1 and its decode step by stage; one
           decode step timed by stage;
  spec     speculative decoding: llama2-7b at full width through the paged
           Scheduler (the paged phase's pool) at speculate_k 3 in chunked
           and packed ticks, against the same requests at speculate_k 0
           (streams, decode ticks, K2 at the verify call's 32 rows, the
           pool drained), and one verify tick timed beside one decode
           tick; the split phase's ℓ = 8 engine drafting on the
           edge and verifying on the dense and the paged cloud against its
           per-token loop (tokens, round trips, uplink bits); and the
           induction vehicle, where drafts are accepted, through both: fewer
           decode ticks and round trips than speculate_k 0, equal streams;
  service  the paged phase's ten requests as ten concurrent HTTP clients
           (eight SSE streams, two non-streaming completions) of
           ServingHTTPServer over AsyncLLMServer over
           LLMServer(backend="paged", auto_prefix=True, telemetry=Tracer())
           at full width, with no prefix key (detection must find the
           shared 200-token head), then a stream that hangs up after 4
           tokens: the streams held to the same requests in process (equal,
           or the first flip at a margin within PAGED_REL), a detected and
           forked prefix, K2 and K3 launched (counters set to 0 just before
           the traffic and read just after), no page left, /healthz 200
           then 503, the trace validated by tools/trace_report.py, TTFT and
           e2e percentiles from /v1/metrics; a decode tick with a tracer
           and without, in turns; the serve phase's four requests through
           the fused backend with a tracer and without: equal streams;
  disagg   the disaggregated deployment at full width: the paged phase's
           ten requests through LLMServer(backend="paged",
           deployment="disaggregated"), a prefill and a decode replica on
           the one card (each with the paged phase's pool) joined by the
           page stream, chunked (A) and packed with speculate_k 3 on the
           decode replica (B): the streams held to the single scheduler's
           (the paged and packed phases' runs, or run here), both pools
           drained, the page-stream bytes equal to the written pages, the
           weights shared by the replicas, the counters set to 0 just
           before each main run and read just after (K2 and K3 in A, K4
           and K2's verify rows in B); TTFT beside the single scheduler's,
           the stream's host seconds, and a facade step with eight slots
           decoding beside the single scheduler's decode tick;
  sharded  the sharded deployment (one rank a process over
           torch.distributed, a ("kv", "model") mesh): A, llama2-7b at full
           width and depth through LLMServer(deployment="sharded") on the
           (1, 1) mesh of one NCCL rank, the paged phase's ten requests,
           chunked and packed, token for token the single scheduler's
           streams; B, four gloo ranks sharing the card on the (2, 2) mesh
           (pages over two ranks, 16 kv heads a rank), llama2-7b over 8 of
           32 blocks, four requests, chunked and packed, token for token
           the unsharded scheduler's on the card; K2 to K4 counted in every
           rank (counters set to 0 just before each run and read just
           after), each rank's pool bytes, the pools drained. The kernels
           phase holds K2, K3 and K4 on each head group of the (2, 2)
           mesh's split against the all-heads call bit for bit
           (``HEAD_GROUPS``);
  families the sliding-window families: gemma2-2b and h2o-danube-3-4b tiny
           on the CPU against the card; both at full width, danube over
           9 of its 24 blocks and gemma2 over 5 of its 13
           (``FAMILY_DANUBE_BLOCKS``, ``FAMILY_GEMMA2_BLOCKS``; random bf16
           weights, int8 KV,
           cache_len 4352) answering four
           requests through LLMServer(backend="fused"), two of whose
           4160-token prompts wrap every 4096-slot ring: finish reasons,
           lengths, a repeat of the first run, K1 once a layer and
           decode step on danube and never on gemma2 (its soft caps take
           the plain route; the counter set to 0 just before the run and
           read just after); request 0's stream decoded step by step: the
           rings hold exactly the window's positions, K1 equals its plain
           version over them, the first 8 steps' int8 logits lie within
           the reference's bound of an unquantized prefill's; a decode
           step timed, the 4160-token prefill, peak memory; then danube
           through LLMServer(backend="split") at ℓ = 8 (K1, K5, K6 and K7
           at its widths, K7 by route; payloads held to their plain
           versions; an uncompressed split equal to the Engine; the step
           by stage). The kernels phase holds K1 at danube's decode shape
           over a wrapped ring (``K1_STEPS["danube_step"]``);
  moe      the mixture-of-experts configs, served dropless: both tiny ones
           on the CPU against the card; qwen2-moe-a2.7b at full width over
           10 of its 24 blocks (``MOE_QWEN2_BLOCKS``; random bf16
           weights, int8 KV) through
           LLMServer(backend="fused") (A: four requests of 512, 512, 128
           and 128 tokens, as the families phase checks them, K1 and k
           routed pairs a token and layer, none dropped; a decode step
           against the bytes of the experts it ran; the MoE layer alone,
           its dispatch beside its expert products and its host syncs),
           through the paged backend (B: eight requests, three forking a
           256-token prefix, chunked then packed; K2, K3, K4 counted; the
           streams held to the fused path and to each other) and through
           the split backend at ℓ = 8 (C: K7 on the edge's expert slices
           and router, counted by route); qwen3-moe-235b-a22b at full width
           over 4 of its 94 blocks (D: QK-norm, K1 and K4 at 16 query
           heads a kv head), fused then packed. Two paths of a MoE config
           are held step by step with each layer's expert choice recorded
           on both: a step is left out only where its own token chose
           other experts on one path (MOE_RULE). The kernels phase holds K1
           at qwen3's decode step (``K1_STEPS["qwen3_step"]``) and K7 at
           qwen2-moe's expert and router products (``K7_MOE``);
  gqa      the grouped- and multi-query configs: internlm2-20b (G 6) and
           granite-34b (G 48) at small widths with those group sizes on
           the CPU against the card; internlm2-20b at full width over 9
           of its 48 blocks (``GQA_INTERNLM2_BLOCKS``; random bf16
           weights, int8 KV) through LLMServer(backend=
           "fused") (A: four requests, as the families phase checks them),
           the paged backend (B: eight requests, three forking a
           256-token prefix, chunked then packed; K2, K3, K4 counted by
           route; every step held to the fused path, packed to chunked)
           and the split backend at ℓ = 8 (C: K7 by route); granite-34b
           over its first 9 of 88 blocks (``GQA_GRANITE_BLOCKS``) the
           same, fused (D), paged chunked (E) and split (F: its ungated
           GELU w_up through K7). The kernels phase holds K1 at
           both decode steps (``K1_STEPS``), K2 to K4 at both group sizes
           (``GQA_GROUPS``) and K7 at granite's w_up (``K7_SLICE16``);
  ssm      the state-space configs: mamba2-780m tiny and jamba-v0.1-52b
           at small widths with its whole period-8 pattern on the CPU
           against the card; mamba2-780m on f32 weights at full width and
           depth, the step recurrence held to the chunked prefill and a
           bf16 recurrent state to the f32 one; mamba2-780m on bf16
           weights over 9 of its 48 blocks (``SSM_MAMBA2_BLOCKS``)
           through the fused backend (A: requests of 4160, 4160, 256 and
           256 tokens, K1 never) and the split backend at ℓ = 8 (B: K5,
           K6, K7 on the SSM projections); jamba-v0.1-52b at full
           width over 2 of its 4 blocks fused (C: 1024, 1024, 256, 256
           tokens, K1 once an attention layer and step, MoE held by
           MOE_RULE) and split at ℓ = 8 (D). The kernels phase holds K7 at
           mamba2's projections (``K7_SLICE16``);
  modal    the vision-stub and codebook configs: qwen2-vl-2b (G 6 over 8
           patch slots) and musicgen-medium at small widths on the CPU
           against the card; qwen2-vl-2b at full width over 9 of its 28
           blocks (``MODAL_QWEN2_VL_BLOCKS``; random bf16 weights, int8
           KV) through LLMServer(backend="fused") on
           text (A, as the families phase checks it) and through the
           Engine over 1,024 projected patch slots and 128 text tokens
           (K1 counted, the int8 steps within the reference's bound of an
           unquantized prefill's, K1 equal to its plain version, the
           decode step beside its byte bound), the paged backend (B:
           ``_dense_paged``, chunked then packed; K2, K3, K4 at K 2, G 6)
           and the split backend at ℓ = 8 (C); musicgen-medium at full
           width over 9 of its 48 blocks (``MODAL_MUSICGEN_BLOCKS``)
           through the Engine on (2, 512, 4) codebook
           prompts (D, held as A's Engine run, K1 at head dim 64) and the
           split engine at ℓ = 8 (E); the paged pool's dense-gather route
           (``paged_prefill_kernel=False``) on four of B's requests held
           to K3's streams (F). The kernels phase holds K1 at both decode
           steps (``K1_STEPS``), K2 to K4 at K 2, G 6 (``GQA_GROUPS``) and
           K7 at both configs' edge widths (``K7_SLICE16``);
  train    training: llama2-7b at full width over 4 of its 32 blocks
           (f32 weights and AdamW state, 17 GB) through
           ``repro_torch.launch.train.main`` (A: batch 4 × 512, accum 2,
           remat, 8 steps on the Zipf-Markov corpus; each step's loss,
           grad norm, lr, host-clock ms, device span and, in a second
           run, its profiled device-busy ms; tokens/s, peak memory); one
           step over 1 block on the card against the CPU on a 64-token
           batch (B: the loss and every leaf's gradient, remat on against
           off, accum 1 against 2); the induction vehicle trained from the
           port's init (C: 250 steps, CE below 0.7 × its first, its
           checkpoint read back bit for bit, copy accuracy through the
           int8-KV Engine beside the committed vehicle's); the
           straight-through codec on a (128, 4096) payload (D: one launch
           of K6 and of K5, the forward bit for bit the CPU's, the
           backward the upstream gradient); the sharded training mesh
           (``make_train_step(mesh=)``): E, run A's config, batches and
           schedule for 3 steps over the (1, 1) mesh of one NCCL rank,
           every metric and every parameter's SHA-256 after each step
           bit for bit the unsharded steps' (which are run A's);
  train_mesh  run only when named in ``--phases`` (``ON_REQUEST``): its
           gloo ranks share the card and move every gathered weight
           through the host, about three minutes that the whole script
           cannot spare on a slow host within its limit. F, four
           gloo ranks sharing the card on the (2, 2) mesh, llama2-7b
           over 2 of its 32 blocks, batch 4 × 256, accum 2, 2 steps; G,
           two gloo ranks on the (2, 1) mesh, qwen2-moe-a2.7b over 1 of
           its 24 blocks, ``moe_groups`` 2, 2 steps, then ``moe_layer_ep``
           on block 0's weights (FSDP) against ``moe_layer(groups=2)``
           and the mean of the two halves' losses. Each step of F and G
           is held to the unsharded step on the card from the same state
           (the seed-0 draw, then the blocks the ranks wrote after the
           step before, put together): metrics and parameters; each
           rank's parameter and moment bytes equal the placement's share,
           and each rank's peak is below the unsharded step's.

Every phase's line carries ``phase_s`` and ``part_s`` (its seconds, and
its parts'). Then a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Without a CUDA card, or without the repository's ``src/``
beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
PHASES = ("env", "kernels", "model", "vehicle", "serve", "paged", "packed",
          "split", "spec", "service", "disagg", "sharded", "families", "moe",
          "gqa", "ssm", "modal", "train")
# phases that run only when --phases names them (not in a run with no
# arguments): the training mesh's gloo ranks, F and G
ON_REQUEST = ("train_mesh",)

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


# the bf16 tensor cores' dense peak of an H100 SXM (NVIDIA's data sheet, at
# the full power limit): int8 codes and bf16 operands are exact in bf16, so
# K7's products and K3's and K4's on bf16 inputs are work the tensor cores
# could do at this rate
BF16_PEAK = 989e12


def attention_bound(ctx, nbytes: int, flops: int, bf16: bool) -> dict:
    """The least time of an attention call: its bytes over the memory rate
    and its operations over the bf16 tensor cores' peak for bf16 inputs
    (exact there), the f32 CUDA-core peak for f32 ones; both terms."""
    bw, f32_peak = peak_rates(ctx["device_name"])
    bytes_ms = nbytes / bw * 1e3
    ops_ms = flops / (BF16_PEAK if bf16 else f32_peak) * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "ops_peak": "bf16" if bf16 else "f32",
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


def _mark(ctx, part: str) -> None:
    """End a part of the running phase: its seconds since the phase began,
    or since the last mark, go under ``part`` in the phase's ``part_s``."""
    now = time.perf_counter()
    ctx["part_s"][part] = now - ctx["part_t0"]
    ctx["part_t0"] = now


def _times(ctx) -> dict:
    """The running phase's seconds so far (``phase_s``) and its marked
    parts' (``part_s``), for its report."""
    return {"phase_s": time.perf_counter() - ctx["phase_t0"],
            "part_s": dict(ctx["part_s"])}


def phase_env(ctx) -> None:
    import torch
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    names = list(build.KERNELS)
    build.build(*names)  # one nvcc per source, all started together
    for name in names:
        build.load(name)
    build_s = time.perf_counter() - t0
    _mark(ctx, "build")
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in build.BUILD_LOG.items()}
    emit({"phase": "env", **_times(ctx), "nvidia_smi": ctx["smi"],
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


# K1's timed shapes beside the kernels phase's main one (B, K, G, hd, S,
# live slots a row): the serve run's last decode step (rows at positions up
# to 191), the split run's longest row (160 live slots),
# h2o-danube-3-4b's decode step over a 4096-slot ring that has wrapped,
# qwen3-moe-235b-a22b's (64 heads on 4 kv heads: 16 query heads a kv head),
# internlm2-20b's (48 on 8: G 6, groups of 4 and 2), granite-34b's (48
# on 1: G 48, twelve groups of 4 reading the same slots), qwen2-vl-2b's in
# the modal phase (12 on 2: G 6; 1,024 patch slots, 128 text tokens and 16
# new: 1,168 slots padded to 1,536) and musicgen-medium's (24 on 24 at head
# dim 64; 512 + 32 tokens)
K1_STEPS = {"serve_step": (2, 32, 1, 128, 1024, 192),
            "split_step": (1, 32, 1, 128, 1024, 160),
            "danube_step": (2, 8, 4, 120, 4096, 4096),
            "qwen3_step": (2, 4, 16, 128, 1024, 1024),
            "internlm2_step": (2, 8, 6, 128, 1024, 1024),
            "granite_step": (2, 1, 48, 128, 1024, 1024),
            "qwen2vl_step": (2, 2, 6, 128, 1536, 1168),
            "musicgen_step": (2, 24, 1, 64, 1024, 544)}
# the ring steps' q_pos: slot t holds the p = t (mod W) in (q_pos - W, q_pos]
K1_RING_Q_POS = {"danube_step": 4223}
# the steps held to the plain version in f32 and bf16 q before their timing
K1_HELD_STEPS = ("danube_step", "qwen3_step", "internlm2_step",
                 "granite_step", "qwen2vl_step", "musicgen_step")


def ring_positions(torch, b, s, w, q_pos, device):
    """(B, S) int32 positions of a sliding-window ring of ``w`` of ``s``
    slots that has wrapped at ``q_pos``: slot t < w holds the p = t (mod
    w) in (q_pos - w, q_pos], the slots past w hold -1."""
    t = torch.arange(s, device=device)
    p = q_pos - torch.remainder(q_pos - t, w)
    return torch.where(t < w, p, -1).to(torch.int32).expand(b, s) \
        .contiguous()


def _k1_bound(ctx, q, b, kh, g, hd, live) -> dict:
    """K1's least time on ``b`` rows of ``live`` slots: the codes, scales
    and positions of the slots the rows need (the slot contract: 0 ..
    q_pos), q and the output, against 4 flops a slot, a dim and a query
    head, f32 on the CUDA cores."""
    bw, f32_peak = peak_rates(ctx["device_name"])
    nbytes = (q.numel() * q.element_size() + b * live * (kh * (2 * hd + 8) + 4)
              + 4 + b * kh * g * hd * 4)
    flops = 4 * b * kh * g * live * hd
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / f32_peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _kernel_k1(ctx) -> dict:
    """K1 against its plain version on the main path's shapes and edge
    shapes, q in f32 and bf16; then at the main shape (every slot live) its
    time beside the plain version's and SDPA's, and the same at the serve
    and split steps' shapes (``K1_STEPS``), each beside a bound that counts
    the live slots."""
    import torch
    from repro_torch.kernels import decode_attention as da

    device = ctx["device"]
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = [  # (B, K, G, hd, S, fill, per-row q_pos or None)
        (4, 32, 1, 128, 1024, 1024, None),  # main path
        (1, 32, 1, 128, 1024, 160, None),  # split: one request (96-160)
        (2, 32, 1, 128, 1024, 192, None),  # serve: the last decode step
        (4, 32, 1, 128, 1024, 111, None),  # split: four 96-token rows
        (4, 32, 1, 128, 4096, 200, None),  # long cache, 200 slots filled
        (2, 2, 2, 32, 96, 50, None),  # llama2-7b tiny
        (2, 2, 6, 64, 600, 450, None),  # G = 6, S not a multiple of 512
        (2, 2, 2, 32, 96, 96, [40, -1]),  # row 1 fully masked, per-row q_pos
        (1, 1, 48, 128, 700, 700, None),  # MQA group of 48
        (2, 4, 3, 256, 130, 100, None),  # hd 256, ragged G
        # row 0's slots all empty up to its q_pos, over several units
        (2, 4, 1, 128, 512, 512, [300, 511]),
    ]
    checks, worst = [], 0.0
    for (b, kh, g, hd, s, fill, qp) in shapes:
        for qdtype in (torch.float32, torch.bfloat16):
            q_pos = None if qp is None else torch.tensor(
                qp, dtype=torch.int32, device=device)
            args = _decode_inputs(torch, b, kh, g, hd, s, fill, qdtype, gen,
                                  device, q_pos)
            if qp == [300, 511]:
                args[5][0] = -1
            got = da.decode_attention(*args)
            want = da.decode_attention_ref(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and err <= ATOL
            checks.append({"shape": [b, kh, g, hd, s, fill], "q_pos": qp,
                           "q_dtype": str(qdtype)[6:],
                           "units": da.grid(b, kh, g, s, da.unit_keys(hd))[2],
                           "max_abs_err": err, "atol": ATOL, "ok": ok})
            worst = max(worst, err)
            if not ok:
                emit({"phase": "kernels", "decode_attention": checks})
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
    ms = ctx["timer"]({
        "kernel": lambda: da.decode_attention(*args),
        "plain": lambda: da.decode_attention_ref(*args),
        "library": lambda: sdpa(q, kd, vd, attn_mask=mask)})
    clocks_after = nvidia_smi(clocks_query)
    bound = _k1_bound(ctx, q, b, kh, g, hd, s)
    main = [b, kh, g, hd, s]
    ctx["kernels"]["decode_attention"] = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:113",
        "launches": None, "max_abs_err": worst, "ms": ms["kernel"],
        "plain_ms": ms["plain"], "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": ms["library"]}

    # the serve and split steps' shapes: rows live up to q_pos only (the
    # ring step's and the qwen3 step's every slot, held to the plain
    # version first in f32 and bf16 q); and at the serve step's, the host's
    # time a call (the wrapper's checks, its workspace and tickets, the
    # launch), no sync between
    steps, host_us = {}, None
    for name, (b, kh, g, hd, s, live) in K1_STEPS.items():
        ring_qp = K1_RING_Q_POS.get(name)
        held = name in K1_HELD_STEPS
        for qdtype in ((torch.float32, torch.bfloat16) if held else
                       (torch.bfloat16,)):
            st = list(_decode_inputs(torch, b, kh, g, hd, s, live, qdtype,
                                     gen, device))
            if not held:
                break
            if ring_qp is not None:
                st[5] = ring_positions(torch, b, s, live, ring_qp, device)
                st[6] = torch.tensor(ring_qp, dtype=torch.int32,
                                     device=device)
            err = float((da.decode_attention(*st)
                         - da.decode_attention_ref(*st)).abs().max())
            checks.append({"shape": [b, kh, g, hd, s, live], "step": name,
                           "q_pos": ring_qp, "q_dtype": str(qdtype)[6:],
                           "units": da.grid(b, kh, g, s,
                                            da.unit_keys(hd))[2],
                           "max_abs_err": err, "atol": ATOL,
                           "ok": err <= ATOL})
            worst = max(worst, err)
            if not err <= ATOL:
                emit({"phase": "kernels", "decode_attention": checks})
                raise SystemExit(f"decode_attention disagrees: "
                                 f"{checks[-1]}")
        sq, skc, sks, svc, svs, spos, sqp = st
        # SDPA over the kv heads expanded to the query heads
        skd = (skc.float() * sks[..., None]).to(torch.bfloat16) \
            .repeat_interleave(g, dim=1)
        svd = (svc.float() * svs[..., None]).to(torch.bfloat16) \
            .repeat_interleave(g, dim=1)
        sq = sq.reshape(b, kh * g, 1, hd)
        smask = ((spos >= 0) & (spos <= sqp))[:, None, None, :]
        t = ctx["timer"]({
            "kernel": lambda st=st: da.decode_attention(*st),
            "plain": lambda st=st: da.decode_attention_ref(*st),
            "library": lambda sq=sq, skd=skd, svd=svd, smask=smask: sdpa(
                sq, skd, svd, attn_mask=smask)})
        if name == "serve_step":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                da.decode_attention(*st)
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        steps[name] = {"shape": [b, kh, g, hd, s], "live_slots": live,
                       "ring_q_pos": ring_qp,
                       **_k1_bound(ctx, st[0], b, kh, g, hd, live),
                       "kernel_ms": t["kernel"], "plain_ms": t["plain"],
                       "library_ms": t["library"]}
    return {"checks": checks, "main_shape": main,
            "unit_keys": da.unit_keys(hd),
            "grid": da.grid(main[0], main[1], main[2], main[4],
                            da.unit_keys(hd)),
            "device_launches_a_call": 1, **bound,
            "kernel_ms": ms["kernel"],
            "plain_ms": ms["plain"], "library_ms": ms["library"],
            "achieved_GBps": bound["bytes"] / ms["kernel"] / 1e6,
            "steps": steps, "serve_step_host_us_a_call": host_us,
            "clocks_sm_max_sm_power": [clocks_before, clocks_after]}


def _paged_pool(torch, rng, kh, hd, page, nb, tokens, device):
    """A pool holding ``tokens[r]`` tokens for row r (position t at page
    ``table[r, t // page]``, slot ``t % page``, pages in random order),
    random int8 codes everywhere (the trash page 0 included) and its block
    table, all on ``device``. Returns (k_codes, k_scale, v_codes, v_scale,
    pool_pos, block_table)."""
    import numpy as np

    need = [-(-n // page) for n in tokens]
    p = 1 + sum(need) + 3
    order = rng.permutation(np.arange(1, p))
    bt = np.zeros((len(tokens), nb), np.int32)
    pool_pos = np.full((p, page), -1, np.int32)
    nxt = 0
    for r, n in enumerate(tokens):
        for b in range(need[r]):
            bt[r, b] = order[nxt]
            nxt += 1
        for t in range(n):
            pool_pos[bt[r, t // page], t % page] = t
    arrays = (rng.integers(-127, 128, (p, kh, page, hd), dtype=np.int8),
              rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
              rng.integers(-127, 128, (p, kh, page, hd), dtype=np.int8),
              rng.uniform(1e-3, 2e-2, (p, kh, page)).astype(np.float32),
              pool_pos, bt)
    return [torch.from_numpy(a).to(device) for a in arrays]


def _kernel_k2(ctx) -> dict:
    """K2 against its plain version on the serve phase's shape and on edge
    shapes, among them rows over several splits (a row filling its table,
    128-key splits at hd 256, G 6, a row whose first split holds only
    masked keys), q in f32 and bf16; rows with no valid key must be exact
    zeros. Then its time at the serve shape beside its bound, the plain
    version's and SDPA's over the gathered, dequantized bf16 K/V."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pda

    device = ctx["device"]
    rng = np.random.default_rng(1)
    serve = (8, 32, 1, 128, 16, 64, [1024, 700, 301, 64, 17, 1, 0, 500])
    shapes = [  # (R, K, G, hd, page, nb, tokens per row; 0 = free slot)
        serve,
        (4, 32, 1, 128, 16, 64, [111, 104, 97, 100]),  # split's cloud
        (3, 2, 2, 32, 4, 8, [20, 7, 0]),  # llama2-7b tiny
        (2, 2, 6, 64, 16, 10, [150, 33]),  # G = 6
        (2, 4, 3, 256, 8, 12, [90, 5]),  # hd 256, ragged G
        (2, 2, 1, 128, 64, 4, [200, 64]),  # largest page
        (2, 1, 4, 64, 1, 40, [40, 13]),  # page of one slot
        (2, 4, 1, 128, 16, 64, [1024, 3]),  # a row filling its whole table
        (2, 4, 2, 256, 16, 40, [640, 130]),  # hd 256: five 128-key splits
        (2, 2, 6, 128, 16, 48, [700, 20]),  # G = 6 over three splits
    ]
    # and a row whose first split (256 slots) holds only masked keys
    masked = (2, 2, 1, 128, 16, 48, [700, 300])
    checks, worst = [], 0.0
    for (r, kh, g, hd, page, nb, toks) in shapes + [masked]:
        pool = _paged_pool(torch, rng, kh, hd, page, nb, toks, device)
        if (r, kh, g, hd, page, nb, toks) == masked:
            pool[4][pool[5][0, :300 // page]] = -1  # row 0's first pages
        q_pos = torch.tensor([n - 1 for n in toks], dtype=torch.int32,
                             device=device)
        for qdtype in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(rng.normal(size=(r, kh, g, hd)).astype(
                np.float32)).to(device, qdtype)
            got = pda.paged_decode_attention(q, *pool, q_pos)
            want = pda.paged_decode_attention_ref(q, *pool, q_pos)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            empty = [i for i, n in enumerate(toks) if n == 0]
            zeros = all(bool((got[i] == 0).all()) for i in empty)
            ok = bool(torch.isfinite(got).all()) and err <= ATOL and zeros
            checks.append({"shape": [r, kh, g, hd, page, nb], "tokens": toks,
                           "route": pda.route(hd, page, nb),
                           "splits": pda.splits(nb, page, pda.SPLIT[hd]),
                           "q_dtype": str(qdtype)[6:], "max_abs_err": err,
                           "atol": ATOL, "free_rows_exact_zero": zeros,
                           "ok": ok})
            worst = max(worst, err)
            if not ok:
                emit({"phase": "kernels", "paged_decode_attention": checks})
                raise SystemExit(f"paged_decode_attention disagrees: "
                                 f"{checks[-1]}")

    if {c["route"] for c in checks} != set(pda.ROUTES):
        raise SystemExit(f"paged_decode_attention: the checks do not take "
                         f"both routes {pda.ROUTES}")
    tick = _k2_tick_routes(ctx, rng)

    r, kh, g, hd, page, nb, toks = serve
    pool = _paged_pool(torch, rng, kh, hd, page, nb, toks, device)
    kc, ks, vc, vs, pool_pos, bt = pool
    q_pos = torch.tensor([n - 1 for n in toks], dtype=torch.int32,
                         device=device)
    q = torch.randn((r, kh, g, hd), device=device).to(torch.bfloat16)
    # the library call is a yardstick only (the port never calls it)
    kd = (pda.gather_pages(kc, bt).float()
          * pda.gather_pages(ks, bt)[..., None]).to(torch.bfloat16)
    vd = (pda.gather_pages(vc, bt).float()
          * pda.gather_pages(vs, bt)[..., None]).to(torch.bfloat16)
    kv_pos = pda.gather_pages(pool_pos, bt)
    mask = ((kv_pos >= 0) & (kv_pos <= q_pos[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = ctx["timer"]({
        "kernel": lambda: pda.paged_decode_attention(q, *pool, q_pos),
        "plain": lambda: pda.paged_decode_attention_ref(q, *pool, q_pos),
        "library": lambda: sdpa(q, kd, vd, attn_mask=mask)})
    bw, f32_peak = peak_rates(ctx["device_name"])
    # only the pages each row must read: 0 .. q_pos // page
    pages = sum(min(-(-n // page), nb) for n in toks)
    nbytes = (q.numel() * q.element_size() + pages * (
        kh * page * (2 * hd + 8) + page * 4) + bt.numel() * 4 + r * 4
        + r * kh * g * hd * 4)
    flops = 4 * kh * g * hd * sum(toks)
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / f32_peak * 1e3
    ctx["kernels"]["paged_decode_attention"] = {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_decode_attention.py:121",
        "launches": None, "max_abs_err": worst, "ms": ms["kernel"],
        "plain_ms": ms["plain"], "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": ms["library"]}
    return {"checks": checks, "main_shape": [r, kh, g, hd, page, nb],
            "tokens": toks, "route": pda.route(hd, page, nb),
            "grid": pda.grid(r, kh, g, hd, page, nb),
            "device_launches_a_call": 1, "bytes": nbytes, "flops": flops,
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "bound_ms": max(bytes_ms, ops_ms),
            "achieved_GBps": nbytes / ms["kernel"] / 1e6,
            "decode_tick_routes": tick}


# the paged phase's decode tick as K2 sees it: 8 rows of 129 tokens
# (128-token prompts and one decoded token) of llama2-7b through the pool's
# 64-page table; every row fits one split of the split route
K2_TICK = (8, 32, 1, 128, 16, 64, [129] * 8)


def _k2_tick_routes(ctx, rng) -> dict:
    """K2 at the paged decode tick's shape (``K2_TICK``) by both routes on
    the same inputs: the single-pass kernel (which the route takes for a
    table that fits one split) and the split kernel (which the route takes
    for the tick's 64-page table; it walks each one-split row in one pass).
    Each within ``ATOL`` of the plain version, then their times in turns
    beside the bound and SDPA's over the gathered, dequantized bf16 K/V."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pda

    r, kh, g, hd, page, nb, toks = K2_TICK
    pool = _paged_pool(torch, rng, kh, hd, page, nb, toks, ctx["device"])
    q_pos = torch.tensor([n - 1 for n in toks], dtype=torch.int32,
                         device=ctx["device"])
    q = torch.from_numpy(rng.normal(size=(r, kh, g, hd)).astype(
        np.float32)).to(ctx["device"], torch.bfloat16)
    want = pda.paged_decode_attention_ref(q, *pool, q_pos)
    err = {}
    for way in pda.ROUTES:
        got = pda.launch_route(way, q, *pool, q_pos)
        torch.cuda.synchronize()
        err[way] = float((got - want).abs().max())
        if not (bool(torch.isfinite(got).all()) and err[way] <= ATOL):
            raise SystemExit(f"paged_decode_attention ({way}) disagrees at "
                             f"the decode tick's shape: {err[way]}")
    # the library call is a yardstick only (the port never calls it): SDPA
    # over the rows' pages gathered and dequantized to bf16 beforehand
    kc, ks, vc, vs, pool_pos, bt = pool
    kd = (pda.gather_pages(kc, bt).float()
          * pda.gather_pages(ks, bt)[..., None]).to(torch.bfloat16)
    vd = (pda.gather_pages(vc, bt).float()
          * pda.gather_pages(vs, bt)[..., None]).to(torch.bfloat16)
    kv_pos = pda.gather_pages(pool_pos, bt)
    mask = ((kv_pos >= 0) & (kv_pos <= q_pos[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fns = {way: (lambda way=way: pda.launch_route(way, q, *pool, q_pos))
           for way in pda.ROUTES}
    fns["library"] = lambda: sdpa(q, kd, vd, attn_mask=mask)
    ms = ctx["timer"](fns)
    bw, _ = peak_rates(ctx["device_name"])
    pages = sum(-(-n // page) for n in toks)
    nbytes = (q.numel() * 2 + pages * (kh * page * (2 * hd + 8) + page * 4)
              + r * nb * 4 + r * 4 + r * kh * g * hd * 4)
    return {"shape": [r, kh, g, hd, page, nb], "tokens": toks,
            "route_taken": pda.route(hd, page, nb), "max_abs_err": err,
            "ms": {k: v for k, v in ms.items() if k != "library"},
            "library_ms": ms["library"], "bound_ms": nbytes / bw * 1e3}


# the spec phase's verify call as K2 sees it: 8 slots, each with its last
# token and a 3-token draft burst (speculate_k 3) = 4 columns, 32 query
# rows over the pool's 64-page table; each slot's 128-token prompt and the
# burst written at positions 128 .. 131 (llama2-7b, page 16)
K2_VERIFY = dict(slots=8, columns=4, kh=32, g=1, hd=128, page=16, nb=64,
                 first=128)


def _k2_verify_inputs(torch, rng, device):
    """K2's operands at ``K2_VERIFY``: the pool, the slots' block table,
    the verify rows' table (each slot's row repeated once a column), their
    causal bounds (row (s, j) at ``first + j``) and bf16 q (R·S, K, G,
    hd)."""
    import numpy as np

    v = K2_VERIFY
    slots, cols = v["slots"], v["columns"]
    pool = _paged_pool(torch, rng, v["kh"], v["hd"], v["page"], v["nb"],
                       [v["first"] + cols] * slots, device)
    rows_bt = pool[5].repeat_interleave(cols, dim=0)
    q_pos = torch.tensor(np.tile(v["first"] + np.arange(cols), slots),
                         dtype=torch.int32, device=device)
    q = torch.from_numpy(rng.normal(size=(
        slots * cols, v["kh"], v["g"], v["hd"])).astype(np.float32)).to(
            device, torch.bfloat16)
    return pool, rows_bt, q_pos, q


def _k2_verify(ctx) -> dict:
    """K2 at the speculative verify's shape (``K2_VERIFY``): within
    ``ATOL`` of its plain version, and each column bit for bit the K2 call
    of the sequential decode step it stands for (the same rows' table and
    bounds, one column at a time). Then its time beside its bound (each
    slot's live pages read ONCE, though K2 reads them once a column), the
    plain version's, and SDPA's over each slot's K/V gathered and
    dequantized to bf16 beforehand (one causal call over the columns)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pda

    device = ctx["device"]
    v = K2_VERIFY
    slots, cols, kh, g, hd = (v["slots"], v["columns"], v["kh"], v["g"],
                              v["hd"])
    pool, rows_bt, q_pos, q = _k2_verify_inputs(
        torch, np.random.default_rng(23), device)
    kc, ks, vc, vs, pool_pos, bt = pool
    got = pda.paged_decode_attention(q, kc, ks, vc, vs, pool_pos, rows_bt,
                                     q_pos)
    want = pda.paged_decode_attention_ref(q, kc, ks, vc, vs, pool_pos,
                                          rows_bt, q_pos)
    per_column = []
    for j in range(cols):  # the sequential decode step of column j
        one = pda.paged_decode_attention(
            q[j::cols].contiguous(), kc, ks, vc, vs, pool_pos, bt,
            q_pos[j::cols].contiguous())
        per_column.append(bool(torch.equal(one, got[j::cols])))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= ATOL
            and all(per_column)):
        raise SystemExit(f"paged_decode_attention at the verify shape: err "
                         f"{err}, columns equal to sequential calls "
                         f"{per_column}")
    # the library call is a yardstick only (the port never calls it)
    kd = (pda.gather_pages(kc, bt).float()
          * pda.gather_pages(ks, bt)[..., None]).to(torch.bfloat16)
    vd = (pda.gather_pages(vc, bt).float()
          * pda.gather_pages(vs, bt)[..., None]).to(torch.bfloat16)
    kv_pos = pda.gather_pages(pool_pos, bt)  # (slots, nb·page)
    sq = q.reshape(slots, cols, kh, hd).transpose(1, 2)  # (slots, K, S, hd)
    spos = q_pos.reshape(slots, cols)
    mask = ((kv_pos[:, None, :] >= 0)
            & (kv_pos[:, None, :] <= spos[:, :, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = ctx["timer"]({
        "kernel": lambda: pda.paged_decode_attention(
            q, kc, ks, vc, vs, pool_pos, rows_bt, q_pos),
        "plain": lambda: pda.paged_decode_attention_ref(
            q, kc, ks, vc, vs, pool_pos, rows_bt, q_pos),
        "library": lambda: sdpa(sq, kd, vd, attn_mask=mask)})
    bw, f32_peak = peak_rates(ctx["device_name"])
    page = v["page"]
    pages = slots * -(-(v["first"] + cols) // page)  # live pages, once
    r = slots * cols
    nbytes = (q.numel() * 2 + pages * (kh * page * (2 * hd + 8) + page * 4)
              + rows_bt.numel() * 4 + r * 4 + r * kh * g * hd * 4)
    keys = slots * sum(v["first"] + j + 1 for j in range(cols))
    flops = 4 * kh * g * hd * keys
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / f32_peak * 1e3
    return {"shape": {**v, "rows": r}, "route": pda.route(hd, page, v["nb"]),
            "grid": pda.grid(r, kh, g, hd, page, v["nb"]),
            "max_abs_err": err, "atol": ATOL,
            "columns_equal_sequential_calls": per_column,
            "bytes": nbytes, "flops": flops, "kernel_ms": ms["kernel"],
            "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _prefill_inputs(torch, rng, r, s, kh, g, hd, page, nb, rows, dtype,
                    device):
    """K3's operands: row i is ``rows[i] = (history, fresh)`` tokens (the
    pool holds both: the post-update convention) or None for a fully
    padded row; fresh tokens are right-aligned from position ``history``."""
    import numpy as np

    totals = [0 if x is None else x[0] + x[1] for x in rows]
    pool = _paged_pool(torch, rng, kh, hd, page, nb, totals, device)
    q_pos = np.full((r, s), -1, np.int32)
    for i, x in enumerate(rows):
        if x is not None:
            q_pos[i, s - x[1]:] = np.arange(x[0], x[0] + x[1])

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device, dtype)

    return (rand(r, s, kh, g, hd), *pool,
            torch.from_numpy(q_pos).to(device), rand(r, s, kh, hd),
            rand(r, s, kh, hd))


def _kernel_k3(ctx) -> dict:
    """K3 against its plain version on the serve phase's chunk shape and on
    edge shapes, q and fresh k/v in f32 and bf16; pad columns and padded
    rows must be exact zeros, and the main path's shapes in bf16 must take
    the tensor cores. Then its time at the serve shape beside its bound,
    the plain version's and SDPA's."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa

    device = ctx["device"]
    rng = np.random.default_rng(2)
    serve = (8, 256, 32, 1, 128, 16, 64,
             [(256, 256), None, (512, 88), None, (200, 150), None, None,
              None])  # two continuation chunks, one fork, five pads
    shapes = [  # (R, S, K, G, hd, page, nb, rows)
        serve,
        # the split's shared-prefix prefill: rows 1+ read row 0's prefix
        (4, 96, 32, 1, 128, 16, 64, [(0, 96), (64, 32), (64, 32), (64, 32)]),
        (3, 8, 2, 2, 32, 4, 8, [(9, 5), (0, 6), (13, 8)]),  # tiny
        (2, 40, 2, 6, 64, 16, 8, [(33, 40), (0, 17)]),  # G = 6
        (2, 50, 4, 3, 256, 8, 16, [(70, 50), (5, 31)]),  # hd 256, S = 50
        (2, 37, 2, 1, 128, 16, 4, [(0, 37), (0, 12)]),  # no history at all
    ]
    checks, worst = [], 0.0
    routes = ppa.paged_prefill_attention.route_launches
    for i, (r, s, kh, g, hd, page, nb, rows) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            args = _prefill_inputs(torch, rng, r, s, kh, g, hd, page, nb,
                                   rows, dtype, device)
            start = ppa.first_call_position(args[7])
            before = dict(routes)
            got = ppa.paged_prefill_attention(*args[:8], start, *args[8:])
            way = next(k for k in routes if routes[k] != before[k])
            want = ppa.paged_prefill_attention_ref(*args[:8], start,
                                                   *args[8:])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            pads = args[7] < 0  # (R, S): pad columns and padded rows
            zeros = bool((got[pads] == 0).all())
            ok = bool(torch.isfinite(got).all()) and err <= ATOL and zeros
            if dtype == torch.bfloat16 and i < 2:  # the main path's shapes
                ok = ok and way == "tensor_cores"
            checks.append({"shape": [r, s, kh, g, hd, page, nb],
                           "rows": rows, "dtype": str(dtype)[6:],
                           "route": way, "max_abs_err": err, "atol": ATOL,
                           "pads_exact_zero": zeros, "ok": ok})
            worst = max(worst, err)
            if not ok:
                emit({"phase": "kernels", "paged_prefill_attention": checks})
                raise SystemExit(f"paged_prefill_attention disagrees: "
                                 f"{checks[-1]}")

    r, s, kh, g, hd, page, nb, rows = serve
    args = _prefill_inputs(torch, rng, r, s, kh, g, hd, page, nb, rows,
                           torch.bfloat16, device)
    q, kc, ks, vc, vs, pool_pos, bt, q_pos, kf, vf = args
    start = ppa.first_call_position(q_pos)
    # the library call is a yardstick only (the port never calls it): SDPA
    # over the gathered, dequantized bf16 history and the fresh keys
    kd = (pda.gather_pages(kc, bt).float()
          * pda.gather_pages(ks, bt)[..., None]).to(torch.bfloat16)
    vd = (pda.gather_pages(vc, bt).float()
          * pda.gather_pages(vs, bt)[..., None]).to(torch.bfloat16)
    hist = pda.gather_pages(pool_pos, bt)
    kv_pos = torch.cat([torch.where(hist < start[:, None], hist, -1), q_pos],
                       dim=1)
    k_all = torch.cat([kd, kf.transpose(1, 2)], dim=2)
    v_all = torch.cat([vd, vf.transpose(1, 2)], dim=2)
    q_l = q[:, :, :, 0].transpose(1, 2).contiguous()  # G = 1: (R, K, S, hd)
    mask = ((kv_pos[:, None, :] >= 0)
            & (kv_pos[:, None, :] <= q_pos[:, :, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = ctx["timer"]({
        "kernel": lambda: ppa.paged_prefill_attention(*args[:8], start,
                                                      *args[8:]),
        "plain": lambda: ppa.paged_prefill_attention_ref(*args[:8], start,
                                                         *args[8:]),
        "library": lambda: sdpa(q_l, k_all, v_all, attn_mask=mask)})
    # the history pages each row must read (slots below its start), the
    # live queries' q and fresh k/v, all of the f32 output; and 4·hd flops
    # (the dot and the weighted sum) per valid (query, key) pair
    pages, pairs, live = 0, 0, 0
    for x in rows:
        if x is None:
            continue
        hist_n, fresh = x
        pages += min(-(-hist_n // page), nb)
        pairs += fresh * hist_n + fresh * (fresh + 1) // 2
        live += fresh
    el = q.element_size()
    nbytes = (live * kh * (g + 2) * hd * el + pages * (
        kh * page * (2 * hd + 8) + page * 4) + bt.numel() * 4
        + q_pos.numel() * 4 + r * 4 + q.numel() * 4)
    bound = attention_bound(ctx, nbytes, 4 * hd * kh * g * pairs,
                            q.dtype == torch.bfloat16)
    ctx["kernels"]["paged_prefill_attention"] = {
        "name": "paged_prefill_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        "replaces": "src/repro/kernels/paged_prefill_attention.py:200",
        "launches": None, "max_abs_err": worst, "ms": ms["kernel"],
        "plain_ms": ms["plain"], "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": ms["library"]}
    return {"checks": checks, "main_shape": [r, s, kh, g, hd, page, nb],
            "rows": rows, "live_queries": live, **bound,
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"],
            "achieved_TFLOPs": bound["flops"] / ms["kernel"] / 1e9}


def _varlen_inputs(torch, rng, segs, kh, g, hd, page, nb, pad, dtype,
                   device, order=None):
    """K4's operands: slot i holds ``segs[i] = (history, fresh)`` tokens in
    its pages (the call's own tokens too: the post-update convention) and
    contributes ``fresh`` rows from position ``history`` to the flat batch,
    in slot order or in ``order``; ``pad`` pad rows close it. A slot with
    fresh 0 is absent from the call. Returns the operands of
    ``kernels.ops.varlen_attention`` (q, pool leaves, block table, q_pos,
    tok_slot, k_fresh, v_fresh)."""
    import numpy as np

    pool = _paged_pool(torch, rng, kh, hd, page, nb,
                       [h + n for h, n in segs], device)
    t = sum(n for _, n in segs) + pad
    q_pos = np.full((t,), -1, np.int32)
    tok_slot = np.full((t,), -1, np.int32)
    cur = 0
    for i in (range(len(segs)) if order is None else order):
        h, n = segs[i]
        q_pos[cur:cur + n] = np.arange(h, h + n)
        tok_slot[cur:cur + n] = i
        cur += n

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device, dtype)

    return (rand(kh, t, g, hd), *pool, torch.from_numpy(q_pos).to(device),
            torch.from_numpy(tok_slot).to(device), rand(kh, t, hd),
            rand(kh, t, hd))


# K4's main-path shape: the default packed tick of the packed phase (budget
# 256 + 8 slots): six decode rows, a continuation chunk of 200 over 256
# tokens of history, a first chunk of 50, eight pad rows
VARLEN_MAIN = dict(
    segs=[(1023, 1), (700, 1), (300, 1), (64, 1), (17, 1), (1, 1),
          (256, 200), (0, 50)], kh=32, g=1, hd=128, page=16, nb=64, pad=8)


def _kernel_k4(ctx) -> dict:
    """K4 against its plain version at the packed tick's shape and on packs
    of decode rows, prefill chunks and both, an all-pad buffer and a
    shuffled slot layout, over G, hd, page and q's dtype (bf16 must take
    the tensor-core route, f32 the CUDA cores); pad rows must be
    exact zeros, a row's result must not change bit for bit when its
    segment moves in the buffer, and a pure-decode pack whose fresh k/v are
    the pool's own entries must equal K2. Then its time at the packed
    tick's shape, with the work list given as the packed step builds it
    once a tick (its own time beside), beside its bound, the plain
    version's and SDPA's over the gathered, dequantized bf16 keys."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import varlen_attention as va

    device = ctx["device"]
    rng = np.random.default_rng(5)
    mixes = {  # name: (segs, pad, order)
        "pure_decode": ([(5, 1), (90, 1), (33, 1), (0, 0), (140, 1)], 3,
                        None),
        "pure_prefill": ([(0, 37), (48, 21), (0, 5), (130, 64)], 0, None),
        "mixed": ([(90, 1), (57, 40), (0, 70), (7, 1), (0, 0), (33, 1)], 5,
                  None),
        "shuffled": ([(90, 1), (57, 40), (0, 70), (7, 1), (200, 3)], 2,
                     (3, 0, 4, 2, 1)),
        "all_pad": ([(40, 0), (12, 0)], 9, None),
    }
    grid = [  # (G, hd, page): every G, both head dims, every page size
        (1, 128, 16), (2, 64, 16), (4, 128, 1), (8, 64, 64), (1, 64, 64),
        (8, 128, 1)]
    m = VARLEN_MAIN
    cases = [("main_path", m["segs"], m["pad"], None, m["kh"], m["g"],
              m["hd"], m["page"], m["nb"])]  # (name, ..., K, G, hd, page, nb)
    cases += [(name, segs, pad, order, 2, g, hd, page,
               max(1, max(-(-(h + n) // page) for h, n in segs)))
              for name, (segs, pad, order) in mixes.items()
              for g, hd, page in grid]
    checks, worst = [], 0.0
    routes = va.varlen_attention.route_launches
    for name, segs, pad, order, kh, g, hd, page, nb in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _varlen_inputs(torch, rng, segs, kh, g, hd, page, nb, pad,
                                  dtype, device, order)
            start = va.segment_start(args[7], args[8], len(segs))
            full = (*args[:9], start, *args[9:])
            before = dict(routes)
            got = va.varlen_attention(*full)
            way = next(k for k in routes if routes[k] != before[k])
            want = va.varlen_attention_ref(*full)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            zeros = bool((got[:, args[8] < 0] == 0).all())
            ok = bool(torch.isfinite(got).all()) and err <= ATOL and zeros \
                and way == ("tensor_cores" if dtype == torch.bfloat16
                            else "cuda_cores")
            checks.append({"mix": name, "K": kh, "G": g, "hd": hd,
                           "page": page, "nb": nb, "dtype": str(dtype)[6:],
                           "route": way, "max_abs_err": err, "atol": ATOL,
                           "pads_exact_zero": zeros, "ok": ok})
            worst = max(worst, err)
            if not ok:
                emit({"phase": "kernels", "varlen_attention": checks})
                raise SystemExit(f"varlen_attention disagrees: "
                                 f"{checks[-1]}")

    # a row's result must not depend on where its segment sits in the
    # buffer: the same tokens laid out in another slot order give
    # bit-identical rows (the packed tick's streams rest on it)
    segs, order = mixes["shuffled"][0], mixes["shuffled"][2]
    placement = {}
    for g, page in ((1, 16), (2, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            args = list(_varlen_inputs(torch, rng, segs, 2, g, 128, page,
                                       -(-203 // page), 2, dtype, device))
            sl = args[8]
            perm = torch.cat([torch.nonzero(sl == i)[:, 0] for i in order]
                             + [torch.nonzero(sl < 0)[:, 0]])
            moved = list(args)
            for i in (0, 9, 10):
                moved[i] = args[i][:, perm].contiguous()
            moved[7], moved[8] = args[7][perm], args[8][perm]
            start = va.segment_start(args[7], args[8], len(segs))
            got = va.varlen_attention(*args[:9], start, *args[9:])
            got_m = va.varlen_attention(*moved[:9], start, *moved[9:])
            torch.cuda.synchronize()
            placement[f"G{g}_page{page}_{str(dtype)[6:]}"] = bool(
                torch.equal(got_m, got[:, perm]))
    if not all(placement.values()):
        raise SystemExit(f"varlen_attention rows change with their "
                         f"placement: {placement}")

    # a pure-decode pack whose fresh k/v are the pool's dequantized self
    # entries is K2's problem (tests/test_varlen_packed.py:118)
    segs, page, nb, kh, g, hd = ([(5, 1), (90, 1), (33, 1), (140, 1)], 16,
                                 10, 4, 2, 128)
    q, kc, ks, vc, vs, pool_pos, bt, q_pos, tok_slot, kf, vf = \
        _varlen_inputs(torch, rng, segs, kh, g, hd, page, nb, 0,
                       torch.float32, device)
    for t, (h, _) in enumerate(segs):
        pg, off = int(bt[t, h // page]), h % page
        kf[:, t] = kc[pg, :, off].float() * ks[pg, :, off, None]
        vf[:, t] = vc[pg, :, off].float() * vs[pg, :, off, None]
    start = va.segment_start(q_pos, tok_slot, len(segs))
    got = va.varlen_attention(q, kc, ks, vc, vs, pool_pos, bt, q_pos,
                              tok_slot, start, kf, vf)
    want = pda.paged_decode_attention(q.transpose(0, 1).contiguous(), kc, ks,
                                      vc, vs, pool_pos, bt, q_pos)
    torch.cuda.synchronize()
    k2_err = float((got.transpose(0, 1) - want).abs().max())
    if not k2_err <= 1e-5:
        raise SystemExit(f"varlen_attention differs from K2 on a pure-decode "
                         f"pack by {k2_err}")

    args = _varlen_inputs(torch, rng, m["segs"], m["kh"], m["g"], m["hd"],
                          m["page"], m["nb"], m["pad"], torch.bfloat16,
                          device)
    q, kc, ks, vc, vs, pool_pos, bt, q_pos, tok_slot, kf, vf = args
    r = len(m["segs"])
    start = va.segment_start(q_pos, tok_slot, r)
    # the work list, as the packed step builds it once a tick for its layers
    rows = va.segment_rows(tok_slot, r)
    full = (*args[:9], start, *args[9:])
    # the library call is a yardstick only (the port never calls it): SDPA
    # over every slot's history, gathered and dequantized to bf16, and the
    # fresh keys, with the varlen mask
    kh, t, hd = m["kh"], q.shape[1], m["hd"]
    kd = (pda.gather_pages(kc, bt).float()
          * pda.gather_pages(ks, bt)[..., None]).to(torch.bfloat16)
    vd = (pda.gather_pages(vc, bt).float()
          * pda.gather_pages(vs, bt)[..., None]).to(torch.bfloat16)
    hist = pda.gather_pages(pool_pos, bt)  # (R, Sp)
    sp = hist.shape[1]
    ok_hist = (hist >= 0) & (hist < start[:, None])
    own = tok_slot[:, None] == torch.arange(r, device=device)
    fresh_ok = ((tok_slot[None, :] == tok_slot[:, None])
                & (tok_slot[None, :] >= 0)
                & (q_pos[None, :] <= q_pos[:, None]) & (q_pos[None, :] >= 0))
    mask = torch.cat([(own[:, :, None] & ok_hist[None]).reshape(t, r * sp),
                      fresh_ok], dim=1)
    k_all = torch.cat([kd.transpose(0, 1).reshape(kh, r * sp, hd), kf],
                      dim=1)[None]
    v_all = torch.cat([vd.transpose(0, 1).reshape(kh, r * sp, hd), vf],
                      dim=1)[None]
    q_l = q[:, :, 0][None]  # G = 1: (1, K, T, hd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = ctx["timer"]({
        "kernel": lambda: va.varlen_attention(*full, rows),
        "plain": lambda: va.varlen_attention_ref(*full),
        "library": lambda: sdpa(q_l, k_all, v_all, attn_mask=mask),
        "work_list": lambda: va.segment_rows(tok_slot, r)})
    # the history pages each slot must read (slots below its start), the
    # live rows' q and fresh k/v, all of the f32 output; and 4·hd flops per
    # valid (query, key) pair: a row sees its slot's history and its
    # segment's fresh keys up to itself
    pages, pairs, live = 0, 0, 0
    for h, n in m["segs"]:
        if n:
            pages += min(-(-h // m["page"]), m["nb"])
            pairs += n * h + n * (n + 1) // 2
            live += n
    el = q.element_size()
    nbytes = (live * kh * (m["g"] + 2) * hd * el + pages * (
        kh * m["page"] * (2 * hd + 8) + m["page"] * 4) + bt.numel() * 4
        + 2 * t * 4 + r * 4 + q.numel() * 4)
    bound = attention_bound(ctx, nbytes, 4 * hd * kh * m["g"] * pairs,
                            q.dtype == torch.bfloat16)
    ctx["kernels"]["varlen_attention"] = {
        "name": "varlen_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/varlen_attention.cu",
        "replaces": "src/repro/kernels/varlen_attention.py:186",
        "launches": None, "max_abs_err": worst, "ms": ms["kernel"],
        "plain_ms": ms["plain"], "bound_ms": bound["bound_ms"],
        "bound_by": bound["bound_by"], "library_ms": ms["library"]}
    return {"checks": checks, "placement_bit_identical": placement,
            "k2_pure_decode_max_abs_err": k2_err,
            "main_shape": {k: v for k, v in m.items()}, "T": t,
            "pages": pages, "pairs_per_head": pairs, "live_rows": live,
            **bound, "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"], "work_list_ms": ms["work_list"],
            "achieved_TFLOPs": bound["flops"] / ms["kernel"] / 1e9}


# K7 against its plain version: f32 sums in another order, bounded by a
# multiple of the largest possible sum of term magnitudes, |x| @ |codes|
# times the scale (a dropped row of codes moves a result by about 1/K of
# it: 9e-5 at K = 11008)
K7_REL = 1e-5
# the decode payload, K5's and K6's main-path input: one token's f32
# split-layer hidden state of llama2-7b; and the shapes they are checked at
PAYLOAD_SHAPE = (1, 4096)
K5_K6_CHECKS = dict(t=(1, 7, 96, 128, 600), d=(64, 4096))
K5_K6_CODEC = (128, 4096)  # a 128-token prefill payload
# TAB-Q's distortion tolerances Δ the adaptive K5 is checked at (0.2: the
# OPSC default), with every max_bits from 2 to 8
K5_DELTAS = (0.05, 0.2, 1.0)
# K7's checks (M, K, N): llama2-7b's edge products at the split phase's
# decode (M = 1, 4) and prefill (96, 128, and 384 = 4 x 96) sizes and at
# 600, then ragged ones; its timed decode product (w_up's) and the prefill
# M it is also timed at
K7_CHECKS = [(m, k, n) for m in (1, 4, 96, 128, 384, 600)
             for k, n in ((4096, 4096), (4096, 11008), (11008, 4096))] + [
    (3, 100, 17), (70, 130, 50), (5, 1000, 33), (1, 1, 1), (2, 11008, 8),
    # the tensor cores' ragged edges: M, N and K no multiple of a tile
    (70, 200, 80), (130, 1000, 48)]
# the prefill sizes the split phase launches: with bf16 x they must take
# the tensor cores, from dequant_matmul.LARGE_M_MIN rows the large-M kernel
K7_TC_M = (96, 128, 384, 600)
K7_MAIN = (1, 4096, 11008)
# the decode products the GEMV is timed at beside x @ W (M, K, N): w_q's
# shape (also w_k, w_v, w_o), w_up's (also w_gate), w_down's, and w_up at
# four rows; and the GEMV's launches a split decode step at each shape (8
# edge layers: 4 w_q-shaped, 2 w_up-shaped, 1 w_down-shaped a layer)
K7_GEMV_TIMED = ((1, 4096, 4096), (1, 4096, 11008), (1, 11008, 4096),
                 (4, 4096, 11008))
K7_GEMV_PER_LAYER = {(4096, 4096): 4, (4096, 11008): 2, (11008, 4096): 1}
# the prefill M K7 is timed at beside x @ W (w_up's K and N)
K7_TIMED_M = (128, 384, 600)
# qwen2-moe-a2.7b's edge decode products (M, K, N, x's dtype): an expert's
# w_gate and w_up, its w_down (each a view of rows of one (E·K, N) code
# matrix whose scale row the experts share), and the f32 router (N 60);
# held to the plain version, timed beside x @ W and their bound
K7_MOE = {"expert_up": (1, 2048, 1408, "bfloat16"),
          "expert_down": (1, 1408, 2048, "bfloat16"),
          "router": (1, 2048, 60, "float32")}
K7_MOE_EXPERTS = 4  # experts in the code matrix an expert view is cut from
# the edge's decode products of the GQA/MQA and state-space configs, held
# and timed as K7_MOE's (one expert: the whole code matrix): granite-34b's
# ungated w_up, mamba2-780m's w_z and w_x (N d_inner), w_B and w_C
# (N d_state), w_dt (N 48 heads, no multiple of 16) and w_out; the modal
# phase's qwen2-vl-2b (wq and wo at 1536, wk and wv at 256, w_gate and w_up
# at 8960, w_down) and musicgen-medium (its four attention products at
# 1536, the ungated GELU's w_up at 6144, w_down)
K7_SLICE16 = {"granite_w_up": (1, 6144, 24576, "bfloat16"),
              "mamba2_w_z": (1, 1536, 3072, "bfloat16"),
              "mamba2_w_B": (1, 1536, 128, "bfloat16"),
              "mamba2_w_dt": (1, 1536, 48, "bfloat16"),
              "mamba2_w_out": (1, 3072, 1536, "bfloat16"),
              "qwen2vl_wq": (1, 1536, 1536, "bfloat16"),
              "qwen2vl_wk": (1, 1536, 256, "bfloat16"),
              "qwen2vl_w_up": (1, 1536, 8960, "bfloat16"),
              "qwen2vl_w_down": (1, 8960, 1536, "bfloat16"),
              "musicgen_w_up": (1, 1536, 6144, "bfloat16"),
              "musicgen_w_down": (1, 6144, 1536, "bfloat16")}
# K7 on int16 codes (OPSC fronts of 9 to 15 bits): the code widths it is
# held at over K7_CHECKS' shapes (GEMV at M <= 4, the CUDA cores above,
# never the tensor cores), and the M it is timed at on w_up's shape beside
# its byte bound (2 bytes a code), x @ W in bf16 and the int8 kernel
K7_WIDE_BITS = (12, 15)
K7_WIDE_TIMED_M = (1, 128)
# K7's device functions (csrc/dequant_matmul.cu), as a profile names them
K7_DEVICE_NAMES = ("gemm_kernel", "gemv_kernel", "gemv16_kernel",
                   "splitk_reduce_kernel", "tc_gemm_kernel",
                   "tc_large_kernel")
# the decode GEMV's (M <= 4), and K1's and K2's device functions
GEMV_DEVICE_NAMES = ("gemv16_kernel", "gemv_kernel", "splitk_reduce_kernel")
K1_DEVICE_NAMES = ("decode_split_kernel",)
K5_DEVICE_NAMES = ("tabq_adaptive_kernel", "tabq_quantize_kernel")
K6_DEVICE_NAMES = ("ts_encode_kernel",)
K2_DEVICE_NAMES = ("paged_split_kernel", "paged_decode_attention_kernel")
# cuBLAS's and K7's matrix products, as a profile names them
GEMM_DEVICE_NAMES = ("nvjet", "gemm", "gemv", "xmma", "cutlass",
                     "splitKreduce", "splitk_reduce")


def _activations(torch, gen, t, d, dtype, device, outliers=0):
    """bf16-rounded activations (ties in magnitude, as the split engine's
    payload input has), ``outliers`` of them scaled by 30."""
    x = torch.randn((t, d), generator=gen, device=device) * 2.0
    if outliers:
        idx = torch.randperm(t * d, generator=gen, device=device)[:outliers]
        x.view(-1)[idx] *= 30.0
    return x.to(torch.bfloat16).to(dtype)


def _k6_cases(torch, gen, device, tsm, same_bits) -> dict:
    """K6 (``ts_encode``) against its plain version, bit for bit and twice
    in a row, where its selection has edges: no entry above τ; fewer and
    exactly as many as the capacity; far more; ties at the C-th magnitude
    in two tiles (the kept set ends inside the second); NaNs (each takes a
    carrier slot as (-1, 0)); and captured calls replayed after an eager
    call has outgrown the stream's state and workspace."""

    def clipped(t, d):  # bf16-origin, |x| <= 4
        return torch.randn((t, d), generator=gen, device=device).to(
            torch.bfloat16).float().clamp(-4.0, 4.0)

    def signs(m):
        return torch.where(torch.rand(m, generator=gen, device=device) < 0.5,
                           -1.0, 1.0)

    def outliers(t, d, m):  # m entries of |x| in [6, 60)
        x = clipped(t, d)
        at = torch.randperm(t * d, generator=gen, device=device)[:m]
        x.view(-1)[at] = (torch.rand(m, generator=gen, device=device) * 54
                          + 6) * signs(m)
        return x

    ties = clipped(2, 4096)  # 20 sevens in each tile of 4096, six larger
    at = torch.randperm(4096, generator=gen, device=device)
    ties.view(-1)[torch.cat([at[:20], at[20:40] + 4096])] = 7.0 * signs(40)
    ties.view(-1)[at[40:46]] = torch.tensor(
        [9.0, -11.0, 9.0, 30.0, -9.0, 12.0], device=device)
    nan = outliers(128, 4096, 600)
    nan.view(-1)[torch.randperm(128 * 4096, generator=gen,
                                device=device)[:3]] = float("nan")
    cases = {  # name: (x, tau, capacity, the count it gives or None)
        "count_0": (clipped(1, 4096) * 2, 1e3, 16, 0),
        "count_below_C": (outliers(1, 4096, 5), 5.0, 16, 5),
        "count_equals_C": (outliers(1, 4096, 16), 5.0, 16, 16),
        "count_far_above_C": (clipped(128, 4096), 0.5, 512, None),
        "ties_across_two_tiles": (ties, 5.0, 31, 46),
        "nan": (nan, 5.0, 512, 600)}
    res = {}
    for name, (x, tau, cap, count) in cases.items():
        want = tsm.ts_encode_ref(x, tau, cap)
        res[name] = all([same_bits("ts_encode", tsm.ts_encode(x, tau, cap),
                                   want) for _ in range(2)]) \
            and (count is None or int(want[3]) == count)
    # the kept sevens lie in both tiles; each NaN holds a slot as (-1, 0)
    kept = tsm.ts_encode_ref(ties, 5.0, 31)[2]
    res["ties_kept_in_both_tiles"] = bool((kept[6:] < 4096).sum() == 20
                                          and (kept[6:] >= 4096).sum() == 5)
    res["nan_slots"] = tsm.ts_encode_ref(nan, 5.0, 512)[2][:3].tolist() \
        == [-1] * 3
    # captured at the decode and a prefill payload, replayed after an eager
    # call at 600 tokens with τ 0.5 (2 million candidates)
    calls = [(x, 5.0, max(16, x.numel() // 1024)) for x in (
        outliers(1, 4096, 30), outliers(128, 4096, 6000))]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in calls:
            tsm.ts_encode(*args)
    torch.cuda.current_stream().wait_stream(side)
    graphs, outs = [], []
    for args in calls:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(tsm.ts_encode(*args))
        graphs.append(graph)
    big = clipped(600, 4096)
    res["eager_outgrowing_the_stream"] = same_bits(
        "ts_encode", tsm.ts_encode(big, 0.5, 2400),
        tsm.ts_encode_ref(big, 0.5, 2400))
    replay = True
    for _ in range(2):
        for graph in graphs:
            graph.replay()
        torch.cuda.synchronize()
        replay = replay and all(same_bits("ts_encode", out,
                                          tsm.ts_encode_ref(*args))
                                for out, args in zip(outs, calls))
    res["graph_replay_after_growth"] = replay
    return res


def _kernel_k5_k6(ctx) -> dict:
    """K5 at every bit width (``tabq_quantize``) and as TAB-Q's whole walk
    (``tabq_adaptive``: every max_bits, ``K5_DELTAS``) and K6
    (``ts_encode``: threshold splitting's whole encode, at the codec's
    capacity) against their plain versions, and the walk against the
    per-level loop over K5's kernel: identical outputs at the payload
    shapes (T = 1 decode, 96 and 128 prefill) and edge shapes, f32 and
    bf16, with tokens of zeros and of equal magnitudes; K6's edge cases
    (``_k6_cases``); the codec through them with more outliers than its
    carrier holds; and at the decode payload's shape, their times (the
    walk beside the per-level loop it replaces; K6 also at 128 tokens)."""
    import torch
    from repro_torch.core.payload import encode
    from repro_torch.kernels import tabq_quantize as tq
    from repro_torch.kernels import ts_mask as tsm

    device = ctx["device"]
    gen = torch.Generator(device=device).manual_seed(5)
    checks, ok = [], True
    # max |kernel - plain|
    err = {"tabq_quantize": 0.0, "tabq_adaptive": 0.0, "ts_encode": 0.0}

    def same(name, got, want) -> bool:
        for a, b in zip(got, want):
            err[name] = max(err[name], float((a.float() - b.float()).abs()
                                             .max()))
        return all(torch.equal(a, b) for a, b in zip(got, want))

    def same_bits(name, got, want) -> bool:
        """``same`` bit for bit, where a NaN equals itself."""
        got, want = list(got), list(want)
        same(name, [a.nan_to_num() for a in got],
             [b.nan_to_num() for b in want])
        return all(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(torch.int32) if a.dtype == torch.float32 else a,
            b.view(torch.int32) if b.dtype == torch.float32 else b)
            for a, b in zip(got, want))

    for t in K5_K6_CHECKS["t"]:
        for d in K5_K6_CHECKS["d"]:
            for dtype in (torch.float32, torch.bfloat16):
                x = _activations(torch, gen, t, d, dtype, device,
                                 outliers=max(1, t * d // 512))
                x[0, :3] = 0.0
                if t > 2:  # a token of equal magnitudes, one of zeros
                    x[1] = torch.where(x[1] < 0, -1.5, 1.5).to(dtype)
                    x[2] = 0.0
                k5 = all([same("tabq_quantize", tq.tabq_quantize(x, bits),
                               tq.tabq_quantize_ref(x, bits))
                          for bits in range(1, 9)])
                walk, widths = True, set()
                for mb in range(2, 9):
                    for delta in K5_DELTAS:
                        got = tq.tabq_adaptive(x, mb, delta)
                        walk = same("tabq_adaptive", got,
                                    tq.tabq_adaptive_ref(x, mb, delta)) \
                            and same("tabq_adaptive", got,
                                     tq.tabq_adaptive_ref(
                                         x, mb, delta,
                                         level=tq.tabq_quantize)) and walk
                        widths |= set(got[4].tolist())
                cap = max(16, t * d // 1024)  # the codec's default
                k6 = all([same_bits("ts_encode",
                                    tsm.ts_encode(x, tau, cap),
                                    tsm.ts_encode_ref(x, tau, cap))
                          for tau in (0.5, 5.0, 1e3)])
                checks.append({"shape": [t, d], "dtype": str(dtype)[6:],
                               "k5_identical_bits_1_to_8": k5,
                               "k5_walk_identical_to_plain_and_loop": walk,
                               "k5_walk_widths": sorted(widths),
                               "k6_identical": k6})
                ok = ok and k5 and walk and k6
    k6_cases = _k6_cases(torch, gen, device, tsm, same_bits)
    ok = ok and all(k6_cases.values())
    # the codec: K5 and K6 on the card, their plain versions on the CPU,
    # far more entries above tau than the carrier holds
    t, d = K5_K6_CODEC
    x = _activations(torch, gen, t, d, torch.float32, device,
                     outliers=t * d // 256)
    got, want = encode(x, tau=5.0), encode(x.cpu(), tau=5.0)
    payload_ok = (all(torch.equal(getattr(got.below, f).cpu(),
                                  getattr(want.below, f))
                      for f in ("codes", "sign", "scale", "zero", "bits"))
                  and torch.equal(got.above.indices.cpu(), want.above.indices)
                  and torch.equal(got.above.values.cpu(), want.above.values)
                  and got.payload_bits() == want.payload_bits())
    overflow = [int(want.above.count), want.above.values.shape[0]]
    ok = ok and payload_ok and overflow[0] > overflow[1]
    torch.cuda.synchronize()
    if not ok:
        emit({"phase": "kernels", "tabq_ts": checks, "max_abs_err": err,
              "k6_cases": k6_cases, "payload_identical": payload_ok,
              "overflow": overflow})
        raise SystemExit("tabq_quantize, tabq_adaptive or ts_encode differs "
                         "from its plain version")

    # time at the decode payload's shape: f32 input, the OPSC defaults (8
    # bits, Δ 0.2): the walk in one launch, the per-level loop over K5's
    # kernel it replaces (6 launches and the small ops around them), the
    # plain walk, and K5 at the top level alone
    t, d = PAYLOAD_SHAPE
    x = _activations(torch, gen, t, d, torch.float32, device)
    walk = {"kernel": lambda: tq.tabq_adaptive(x, 8, 0.2),
            "per_level_loop": lambda: tq.tabq_adaptive_ref(
                x, 8, 0.2, level=tq.tabq_quantize)}
    ms5 = ctx["timer"]({
        "kernel": walk["kernel"],
        "plain": lambda: tq.tabq_adaptive_ref(x, 8, 0.2),
        "level_kernel": lambda: tq.tabq_quantize(x, 7)})
    # the walk beside the loop it replaces: device busy a call (profiler;
    # the loop's host-to-device copy of Δ waits for the device, so the
    # Timer's device hold cannot hide its host time) and host included
    walk_ms = {f"{k}_device_busy": _device_profile(torch, fn, 5)[0]
               for k, fn in walk.items()}
    walk_ms.update({f"{k}_host_included": v for k, v in ctx["timer"](
        walk, device_only=False).items()})
    # K6 at the decode payload (T 1) and a 128-token prefill payload, τ 5
    # and the codec's capacity; and with every entry a candidate (τ 0)
    x128 = _activations(torch, gen, *K5_K6_CODEC, torch.float32, device)
    k6_timed = {}
    for name, xt, tau in (("t1", x, 5.0), ("t128", x128, 5.0),
                          ("t128_tau0", x128, 0.0)):
        cap = max(16, xt.numel() // 1024)
        k6_timed[name] = ctx["timer"]({
            "kernel": lambda: tsm.ts_encode(xt, tau, cap),
            "plain": lambda: tsm.ts_encode_ref(xt, tau, cap)})
        k6_timed[name].update(
            shape=list(xt.shape), tau=tau, capacity=cap,
            count=int(tsm.ts_encode(xt, tau, cap)[3]),
            bytes=xt.numel() * (4 + 4) + cap * (4 + 8) + 4)
        k6_timed[name]["bound_ms"] = k6_timed[name]["bytes"] / peak_rates(
            ctx["device_name"])[0] * 1e3
    ms6 = k6_timed["t1"]
    # the walk's levels on this input: the top one, each level kept, the
    # first one refused (if any), and the chosen one written again
    q_ref, chosen = 7, int(tq.tabq_adaptive(x, 8, 0.2)[4].max()) - 1
    levels = 2 + (q_ref - chosen) + (chosen > tq.MIN_BITS)
    bw, f32_peak = peak_rates(ctx["device_name"])
    rows = {}
    # (name, bytes: x read once and the outputs written once, f32
    # operations a value, times)
    for name, nbytes, ops_per, ms, src, stem in (
            ("tabq_adaptive", t * d * (4 + 2) + t * 12, 8 * levels, ms5,
             "tabq_kernel.py:59", "tabq_quantize"),
            ("ts_encode", ms6["bytes"], 2, ms6, "ts_mask.py:32",
             "ts_mask")):
        bytes_ms, ops_ms = nbytes / bw * 1e3, t * d * ops_per / f32_peak * 1e3
        ctx["kernels"][name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
            "replaces": f"src/repro/kernels/{src}", "launches": None,
            "max_abs_err": err[name], "ms": ms["kernel"],
            "plain_ms": ms["plain"],
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}
        rows[name] = {"main_shape": [t, d], "bytes": nbytes,
                      **{f"{k}_ms": ms[k] for k in ("kernel", "plain")},
                      "bound_ms": max(bytes_ms, ops_ms)}
    rows["tabq_adaptive"].update(levels_walked=levels, max_bits=8, delta=0.2,
                                 walk_and_loop_ms=walk_ms,
                                 level_kernel_ms=ms5["level_kernel"])
    rows["ts_encode"]["by_shape"] = k6_timed
    return {"checks": checks, "max_abs_err": err, "k6_cases": k6_cases,
            "payload_identical": payload_ok,
            "overflow_count_capacity": overflow, "timed": rows,
            "library": "none: no one PyTorch call computes per-token AIQ "
                       "with the rebase, or the split with its counts"}


def _kernel_k7(ctx) -> dict:
    """K7 (``dequant_matmul``) against its plain version on llama2-7b's
    edge products at decode (M = 1, 4) and prefill (M = 96, 128, 384, 600)
    sizes and on ragged ones, f32 and bf16 x (the prefill sizes in bf16
    must take the tensor cores, from ``LARGE_M_MIN`` rows the large-M
    kernel); the decode GEMV at the three projection shapes (M 1) and at
    w_up with M 4 (``K7_GEMV_TIMED``), and the product at ``K7_TIMED_M``
    prefill rows, timed beside the bf16 product over the dequantized
    weights (the reference's fake-quant product) and the byte bound."""
    import torch
    from repro_torch.kernels import dequant_matmul as dm

    device = ctx["device"]
    gen = torch.Generator(device=device).manual_seed(7)
    checks, worst = [], 0.0
    routes = dm.dequant_matmul.route_launches
    for m, k, n in K7_CHECKS:
        codes = torch.randint(-7, 8, (k, n), generator=gen, device=device,
                              dtype=torch.int8)
        scale = torch.rand((n,), generator=gen, device=device) * 0.01 + 1e-4
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device=device).to(dtype)
            before = dict(routes)
            got = dm.dequant_matmul(x, codes, scale)
            way = next(r for r in routes if routes[r] != before[r])
            want = dm.dequant_matmul_ref(x, codes, scale)
            bound = float((x.float().abs() @ codes.float().abs()
                           * scale).max())
            torch.cuda.synchronize()
            rel = float((got - want).abs().max()) / bound
            ok = bool(torch.isfinite(got).all()) and rel <= K7_REL
            if dtype == torch.bfloat16 and m in K7_TC_M:
                ok = ok and way == ("tensor_cores_large_m"
                                    if m >= dm.LARGE_M_MIN
                                    else "tensor_cores")
            checks.append({"m_k_n": [m, k, n], "x_dtype": str(dtype)[6:],
                           "route": way, "rel_err": rel, "max_abs_err": float(
                               (got - want).abs().max()), "ok": ok})
            worst = max(worst, checks[-1]["max_abs_err"])
            if not ok:
                emit({"phase": "kernels", "dequant_matmul": checks})
                raise SystemExit(f"dequant_matmul disagrees: {checks[-1]}")

    bw, _ = peak_rates(ctx["device_name"])

    def bound(m, k=K7_MAIN[1], n=K7_MAIN[2]):
        nbytes = m * k * 2 + k * n + n * 4 + m * n * 4
        b_ms, o_ms = nbytes / bw * 1e3, 2 * m * n * k / BF16_PEAK * 1e3
        return nbytes, max(b_ms, o_ms), "bytes" if b_ms >= o_ms \
            else "operations"

    # the decode GEMV at each projection shape, bf16 x as the edge's hidden
    # state, beside x @ W over the reference's weight and its byte bound
    gemv = {}
    for mg, kg, ng in K7_GEMV_TIMED:
        codes = torch.randint(-7, 8, (kg, ng), generator=gen, device=device,
                              dtype=torch.int8)
        scale = torch.rand((ng,), generator=gen, device=device) * 0.01 + 1e-4
        x = torch.randn((mg, kg), generator=gen, device=device).to(
            torch.bfloat16)
        w = (codes.float() * scale).to(torch.bfloat16)
        fns = {"kernel": lambda: dm.dequant_matmul(x, codes, scale),
               "library": lambda: x @ w}
        if (mg, kg, ng) == K7_MAIN:
            fns["plain"] = lambda: dm.dequant_matmul_ref(x, codes, scale)
        ms_g = ctx["timer"](fns)
        nbytes, bound_ms, bound_by = bound(mg, kg, ng)
        gemv[f"{mg}x{kg}x{ng}"] = {
            "route": dm.route(mg, ng, kg, x.dtype, x.data_ptr(),
                              codes.data_ptr(), scale.data_ptr()),
            "vec": dm.gemv_vec(ng, codes.data_ptr(), scale.data_ptr()),
            "splits": dm.gemv_plan(mg, ng, kg, 16, dm._sm_count(0))[1],
            "launches_a_split_decode_step": SPLIT_LAYER
            * K7_GEMV_PER_LAYER[(kg, ng)] if mg == 1 else None,
            "kernel_ms": ms_g["kernel"], "library_ms": ms_g["library"],
            "plain_ms": ms_g.get("plain"), "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes,
            "achieved_GBps": nbytes / ms_g["kernel"] / 1e6,
            "share_of_bound": bound_ms / ms_g["kernel"]}
        if (mg, kg, ng) == K7_MAIN:
            ms = ms_g
    m, k, n = K7_MAIN
    codes = torch.randint(-7, 8, (k, n), generator=gen, device=device,
                          dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device=device) * 0.01 + 1e-4
    w = (codes.float() * scale).to(torch.bfloat16)  # the reference's weight

    # and the prefill products: the main path's 128-token prompt, the four
    # 96-token rows of a shared prefix (384) and a 600-token prompt
    prefill = {}
    for mp in K7_TIMED_M:
        xp = torch.randn((mp, k), generator=gen, device=device).to(
            torch.bfloat16)
        ms_p = ctx["timer"]({
            "kernel": lambda: dm.dequant_matmul(xp, codes, scale),
            "library": lambda: xp @ w}, iters=10)
        prefill[mp] = {"route": dm.route(mp, n, k, xp.dtype, xp.data_ptr(),
                                         codes.data_ptr(), scale.data_ptr()),
                       "kernel_ms": ms_p["kernel"],
                       "library_ms": ms_p["library"],
                       "bound_ms": bound(mp)[1], "bound_by": bound(mp)[2],
                       "achieved_TFLOPs": 2 * mp * n * k
                       / ms_p["kernel"] / 1e9}

    # the MoE edge's decode products: the last expert's rows of a code
    # matrix (a view at an offset of (E - 1)·K·N bytes), and the router
    _, f32_peak = peak_rates(ctx["device_name"])
    moe, slice16 = {}, {}
    for name, (mm, km, nm, xdt) in {**K7_MOE, **K7_SLICE16}.items():
        e = K7_MOE_EXPERTS if name in K7_MOE and name != "router" else 1
        full = torch.randint(-7, 8, (e * km, nm), generator=gen,
                             device=device, dtype=torch.int8)
        cm = full[(e - 1) * km:]
        sm = torch.rand((nm,), generator=gen, device=device) * 0.01 + 1e-4
        xm = torch.randn((mm, km), generator=gen, device=device).to(
            getattr(torch, xdt))
        before = dict(routes)
        got = dm.dequant_matmul(xm, cm, sm)
        way = next(r for r in routes if routes[r] != before[r])
        want = dm.dequant_matmul_ref(xm, cm, sm)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max()) / float(
            (xm.float().abs() @ cm.float().abs() * sm).max())
        checks.append({"m_k_n": [mm, km, nm], "x_dtype": xdt, "moe": name,
                       "route": way, "rel_err": rel, "max_abs_err": float(
                           (got - want).abs().max()), "ok": rel <= K7_REL})
        worst = max(worst, checks[-1]["max_abs_err"])
        if not rel <= K7_REL:
            emit({"phase": "kernels", "dequant_matmul": checks})
            raise SystemExit(f"dequant_matmul disagrees: {checks[-1]}")
        wm = (cm.float() * sm).to(xm.dtype)  # the reference's weight
        t = ctx["timer"]({
            "kernel": lambda xm=xm, cm=cm, sm=sm: dm.dequant_matmul(xm, cm,
                                                                    sm),
            "plain": lambda xm=xm, cm=cm, sm=sm: dm.dequant_matmul_ref(
                xm, cm, sm),
            "library": lambda xm=xm, wm=wm: xm @ wm})
        nb = mm * km * xm.element_size() + km * nm + nm * 4 + mm * nm * 4
        b_ms = nb / bw * 1e3
        o_ms = 2 * mm * nm * km / (BF16_PEAK if xdt == "bfloat16"
                                   else f32_peak) * 1e3
        (moe if name in K7_MOE else slice16)[name] = {
            "m_k_n": [mm, km, nm], "x_dtype": xdt, "route": way,
            "vec": dm.gemv_vec(nm, cm.data_ptr(), sm.data_ptr()),
            "kernel_ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bytes": nb,
            "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations"}

    wide = _kernel_k7_wide(ctx, gen, codes, scale)
    worst = max(worst, wide["max_abs_err"])
    nbytes, bound_ms, bound_by = bound(1)
    ctx["kernels"]["dequant_matmul"] = {
        "name": "dequant_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
        "replaces": "src/repro/kernels/dequant_matmul.py:52",
        "launches": None, "max_abs_err": worst, "ms": ms["kernel"],
        "plain_ms": ms["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": ms["library"],
        "gemv": {shape: {key: r[key] for key in (
            "kernel_ms", "library_ms", "bound_ms", "bound_by")}
            for shape, r in gemv.items()},
        "prefill": {str(mp): {key: r[key] for key in (
            "route", "kernel_ms", "library_ms", "bound_ms", "bound_by")}
            for mp, r in prefill.items()},
        "moe": {name: {key: r[key] for key in (
            "route", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for name, r in moe.items()},
        "slice16": {name: {key: r[key] for key in (
            "route", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for name, r in slice16.items()},
        "int16": {"checks": len(wide["checks"]),
                  "max_abs_err": wide["max_abs_err"], "launches": None,
                  "timed": {str(m): {key: r[key] for key in (
                      "route", "kernel_ms", "plain_ms", "library_ms",
                      "int8_ms", "bound_ms", "bound_by")}
                      for m, r in wide["timed"].items()}}}
    return {"checks": checks, "tol_rel_to_abs_sum": K7_REL, "int16": wide,
            "main_shape": [m, k, n], "bytes": nbytes, "bound_ms": bound_ms,
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "library_ms": ms["library"],
            "achieved_GBps": nbytes / ms["kernel"] / 1e6,
            "gemv": gemv, "prefill": prefill, "moe": moe,
            "slice16": slice16}


def _kernel_k7_wide(ctx, gen, codes8, scale8) -> dict:
    """K7 on int16 codes at ``K7_WIDE_BITS`` against its plain version on
    ``K7_CHECKS``' shapes, f32 and bf16 x, within K7_REL of |x| @ |codes|
    times the scale, on the GEMV at M <= 4 and the CUDA cores above; w_up's
    product timed at ``K7_WIDE_TIMED_M`` beside its plain version, the byte
    bound (2 bytes a code; the operations counted at the bf16 tensor cores'
    rate for two int8 planes, ROADMAP queue 2's design), x @ W over the
    dequantized bf16 weight (the same bytes) and the int8 kernel on
    ``codes8``, w_up's int8 codes."""
    import torch
    from repro_torch.kernels import dequant_matmul as dm

    device = ctx["device"]
    checks, worst = [], 0.0
    routes = dm.dequant_matmul.route_launches
    for bits in K7_WIDE_BITS:
        qmax = 2 ** (bits - 1) - 1
        for m, k, n in K7_CHECKS:
            codes = torch.randint(-qmax, qmax + 1, (k, n), generator=gen,
                                  device=device, dtype=torch.int16)
            scale = (torch.rand((n,), generator=gen, device=device) * 0.01
                     + 1e-4) / qmax
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((m, k), generator=gen, device=device).to(
                    dtype)
                before = dict(routes)
                got = dm.dequant_matmul(x, codes, scale)
                way = next(r for r in routes if routes[r] != before[r])
                want = dm.dequant_matmul_ref(x, codes, scale)
                bound = float((x.float().abs() @ codes.float().abs()
                               * scale).max())
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                ok = bool(torch.isfinite(got).all()) and err <= \
                    K7_REL * bound and way == (
                        "gemv" if m <= dm.GEMV_MAX_M else "cuda_cores")
                checks.append({"bits": bits, "m_k_n": [m, k, n],
                               "x_dtype": str(dtype)[6:], "route": way,
                               "rel_err": err / bound, "max_abs_err": err,
                               "ok": ok})
                worst = max(worst, err)
                if not ok:
                    emit({"phase": "kernels", "dequant_matmul_int16": checks})
                    raise SystemExit(f"dequant_matmul int16 disagrees: "
                                     f"{checks[-1]}")

    bw, _ = peak_rates(ctx["device_name"])
    _, k, n = K7_MAIN
    qmax = 2 ** (K7_WIDE_BITS[0] - 1) - 1
    codes = torch.randint(-qmax, qmax + 1, (k, n), generator=gen,
                          device=device, dtype=torch.int16)
    scale = (torch.rand((n,), generator=gen, device=device) * 0.01
             + 1e-4) / qmax
    w = (codes.float() * scale).to(torch.bfloat16)  # the reference's weight
    timed = {}
    for m in K7_WIDE_TIMED_M:
        x = torch.randn((m, k), generator=gen, device=device).to(
            torch.bfloat16)
        ms = ctx["timer"]({
            "kernel": lambda x=x: dm.dequant_matmul(x, codes, scale),
            "plain": lambda x=x: dm.dequant_matmul_ref(x, codes, scale),
            "library": lambda x=x: x @ w,
            "int8": lambda x=x: dm.dequant_matmul(x, codes8, scale8)},
            iters=20)
        nbytes = m * k * 2 + k * n * 2 + n * 4 + m * n * 4
        b_ms = nbytes / bw * 1e3
        o_ms = 2 * 2 * m * n * k / BF16_PEAK * 1e3  # two int8 planes
        timed[m] = {"route": dm.route(m, n, k, x.dtype, x.data_ptr(),
                                      codes.data_ptr(), scale.data_ptr(),
                                      code_dtype=torch.int16),
                    "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
                    "library_ms": ms["library"], "int8_ms": ms["int8"],
                    "bytes": nbytes, "bound_ms": max(b_ms, o_ms),
                    "bound_by": "bytes" if b_ms >= o_ms else "operations",
                    "f32_cuda_core_ops_ms": 2 * m * n * k
                    / peak_rates(ctx["device_name"])[1] * 1e3,
                    "achieved_GBps": nbytes / ms["kernel"] / 1e6}
    return {"bits": list(K7_WIDE_BITS), "checks": checks,
            "max_abs_err": worst, "tol_rel_to_abs_sum": K7_REL,
            "timed": timed}


def _graph_replay(ctx) -> dict:
    """One bf16 K4 call at ``VARLEN_MAIN`` (its work list built inside the
    call), one K7 call at M 600, one K2 call at the serve shape, one by
    each route at the decode tick's (``K2_TICK``) and one at the verify's
    (``K2_VERIFY``), one GEMV at w_up
    (``K7_MAIN``), K1 at the main shape and the serve step's
    (``K1_STEPS``), and TAB-Q's walk (``tabq_adaptive``) and K6
    (``ts_encode``) at the decode payload's shape captured in a
    ``torch.cuda.CUDAGraph`` and replayed:
    two eager calls must be bit-identical, and the replay must equal the
    eager result bit for bit (no host read-back, a grid from shapes alone,
    the tickets reset by the kernels)."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import tabq_quantize as tq
    from repro_torch.kernels import ts_mask as tsm
    from repro_torch.kernels import varlen_attention as va

    device = ctx["device"]
    m = VARLEN_MAIN
    args = _varlen_inputs(torch, np.random.default_rng(6), m["segs"],
                          m["kh"], m["g"], m["hd"], m["page"], m["nb"],
                          m["pad"], torch.bfloat16, device)
    start = va.segment_start(args[7], args[8], len(m["segs"]))
    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.randn((600, 4096), generator=gen, device=device).to(
        torch.bfloat16)
    codes = torch.randint(-7, 8, (4096, 11008), generator=gen, device=device,
                          dtype=torch.int8)
    scale = torch.rand((11008,), generator=gen, device=device) * 0.01 + 1e-4
    x1 = x[:K7_MAIN[0]].contiguous()
    toks = [1024, 700, 301, 64, 17, 1, 0, 500]
    pool = _paged_pool(torch, np.random.default_rng(9), 32, 128, 16, 64,
                       toks, device)
    q_pos = torch.tensor([n - 1 for n in toks], dtype=torch.int32,
                         device=device)
    q = torch.randn((8, 32, 1, 128), generator=gen, device=device).to(
        torch.bfloat16)
    r, kh, g, hd, page, nb, tick_toks = K2_TICK
    tick_pool = _paged_pool(torch, np.random.default_rng(10), kh, hd, page,
                            nb, tick_toks, device)
    tick_pos = torch.tensor([n - 1 for n in tick_toks], dtype=torch.int32,
                            device=device)
    tick_q = torch.randn((r, kh, g, hd), generator=gen, device=device).to(
        torch.bfloat16)
    ver_pool, ver_bt, ver_pos, ver_q = _k2_verify_inputs(
        torch, np.random.default_rng(11), device)
    calls = {"varlen_attention": lambda: va.varlen_attention(
        *args[:9], start, *args[9:]),
        "dequant_matmul": lambda: dm.dequant_matmul(x, codes, scale),
        "paged_decode_attention": lambda: pda.paged_decode_attention(
            q, *pool, q_pos),
        # the decode tick's rows of one split, by both routes
        "paged_decode_attention_tick_split": lambda: pda.launch_route(
            "split", tick_q, *tick_pool, tick_pos),
        "paged_decode_attention_tick_single_pass": lambda: pda.launch_route(
            "single_pass", tick_q, *tick_pool, tick_pos),
        # the speculative verify's 32 rows (K2_VERIFY)
        "paged_decode_attention_verify": lambda: pda.paged_decode_attention(
            ver_q, *ver_pool[:5], ver_bt, ver_pos),
        "dequant_matmul_gemv": lambda: dm.dequant_matmul(x1, codes, scale)}
    k1_main = _decode_inputs(torch, 4, 32, 1, 128, 1024, 1024,
                             torch.bfloat16, gen, device)
    b, kh, g, hd, s, live = K1_STEPS["serve_step"]
    k1_step = _decode_inputs(torch, b, kh, g, hd, s, live, torch.bfloat16,
                             gen, device)
    xp = _activations(torch, gen, *PAYLOAD_SHAPE, torch.float32, device)
    calls.update({
        "decode_attention": lambda: da.decode_attention(*k1_main),
        "decode_attention_serve_step": lambda: da.decode_attention(*k1_step),
        "tabq_adaptive": lambda: tq.tabq_adaptive(xp, 8, 0.2),
        "ts_encode": lambda: tsm.ts_encode(xp, 5.0, 16)})
    res, repeat = {}, {}

    def equal(a, b) -> bool:  # a tensor or a tuple of them
        if isinstance(a, torch.Tensor):
            return bool(torch.equal(a, b))
        return all(torch.equal(u, v) for u, v in zip(a, b))

    for name, fn in calls.items():
        eager = fn()
        repeat[name] = equal(fn(), eager)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the default stream
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        same = True
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            same = same and equal(out, eager)
        res[name] = same
    if not all(res.values()) or not all(repeat.values()):
        raise SystemExit(f"a graph replay or a second eager call differs: "
                         f"replay {res}, eager twice {repeat}")
    return {"replay_bit_identical": res, "eager_twice_bit_identical": repeat}


# K2, K3 and K4 at internlm2-20b's (8 kv heads, G 6) and granite-34b's (1
# kv head, G 48) group sizes, hd 128, at the main path's shapes: the paged
# decode tick's rows (``_kernel_k2``'s serve shape), the chunk call's rows
# (``_kernel_k3``'s) and the packed tick (``VARLEN_MAIN``)
GQA_GROUPS = {"internlm2": (8, 6), "granite": (1, 48), "qwen2vl": (2, 6)}


def _expand_heads(t, g, dim):
    """``t``'s kv heads (axis ``dim``) repeated for their ``g`` query heads:
    the layout SDPA takes (a yardstick only)."""
    return t.repeat_interleave(g, dim=dim)


def _kernel_groups(ctx) -> dict:
    """K2, K3 and K4 at each ``GQA_GROUPS`` group size, bf16 q (the main
    path's), held to their plain versions in f32 and bf16 q, then timed
    beside their bound, the plain version and SDPA over the dequantized
    bf16 K/V with the kv heads expanded to the query heads."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va

    device = ctx["device"]
    rng = np.random.default_rng(26)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bw, f32_peak = peak_rates(ctx["device_name"])
    out = {}

    def held(name, fn, ref, zeros_at):
        err = float((fn() - ref()).abs().max())
        got = fn()
        ok = bool(torch.isfinite(got).all()) and err <= ATOL and bool(
            (got[zeros_at] == 0).all())
        if not ok:
            raise SystemExit(f"{name} disagrees at a GQA group: {err}")
        return err

    def dequant(codes, scale, bt):
        return (pda.gather_pages(codes, bt).float()
                * pda.gather_pages(scale, bt)[..., None]).to(torch.bfloat16)

    for cfg_name, (kh, g) in GQA_GROUPS.items():
        res = {}
        # K2: the paged decode tick's eight rows
        toks = [1024, 700, 301, 64, 17, 1, 0, 500]
        r, hd, page, nb = len(toks), 128, 16, 64
        pool = _paged_pool(torch, rng, kh, hd, page, nb, toks, device)
        q_pos = torch.tensor([n - 1 for n in toks], dtype=torch.int32,
                             device=device)
        errs = []
        for qdtype in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(rng.normal(size=(r, kh, g, hd)).astype(
                np.float32)).to(device, qdtype)
            errs.append(held("paged_decode_attention",
                             lambda: pda.paged_decode_attention(q, *pool,
                                                                q_pos),
                             lambda: pda.paged_decode_attention_ref(
                                 q, *pool, q_pos), q_pos < 0))
        kc, ks, vc, vs, pool_pos, bt = pool
        kd = _expand_heads(dequant(kc, ks, bt), g, 1)
        vd = _expand_heads(dequant(vc, vs, bt), g, 1)
        kv_pos = pda.gather_pages(pool_pos, bt)
        mask = ((kv_pos >= 0) & (kv_pos <= q_pos[:, None]))[:, None, None, :]
        ql = q.reshape(r, kh * g, 1, hd)
        t = ctx["timer"]({
            "kernel": lambda: pda.paged_decode_attention(q, *pool, q_pos),
            "plain": lambda: pda.paged_decode_attention_ref(q, *pool, q_pos),
            "library": lambda: sdpa(ql, kd, vd, attn_mask=mask)})
        pages = sum(min(-(-n // page), nb) for n in toks)
        nbytes = (q.numel() * 2 + pages * (kh * page * (2 * hd + 8)
                                           + page * 4)
                  + bt.numel() * 4 + r * 4 + r * kh * g * hd * 4)
        bound = attention_bound(ctx, nbytes,
                                4 * kh * g * hd * sum(toks), False)
        res["paged_decode_attention"] = {
            "shape": [r, kh, g, hd, page, nb], "tokens": toks,
            "route": pda.route(hd, page, nb), "max_abs_err": max(errs),
            **bound, "kernel_ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"]}

        # K3: the chunk call (two continuation chunks, a fork, five pads)
        rows = [(256, 256), None, (512, 88), None, (200, 150), None, None,
                None]
        s = 256
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            args = _prefill_inputs(torch, rng, r, s, kh, g, hd, page, nb,
                                   rows, dtype, device)
            start = ppa.first_call_position(args[7])
            errs.append(held("paged_prefill_attention",
                             lambda: ppa.paged_prefill_attention(
                                 *args[:8], start, *args[8:]),
                             lambda: ppa.paged_prefill_attention_ref(
                                 *args[:8], start, *args[8:]),
                             args[7] < 0))
        q, kc, ks, vc, vs, pool_pos, bt, qp, kf, vf = args
        hist = pda.gather_pages(pool_pos, bt)
        kv_pos = torch.cat([torch.where(hist < start[:, None], hist, -1),
                            qp], dim=1)
        k_all = _expand_heads(torch.cat([dequant(kc, ks, bt),
                                         kf.transpose(1, 2)], dim=2), g, 1)
        v_all = _expand_heads(torch.cat([dequant(vc, vs, bt),
                                         vf.transpose(1, 2)], dim=2), g, 1)
        ql = q.permute(0, 2, 3, 1, 4).reshape(r, kh * g, s, hd)
        mask = ((kv_pos[:, None, :] >= 0)
                & (kv_pos[:, None, :] <= qp[:, :, None]))[:, None]
        t = ctx["timer"]({
            "kernel": lambda: ppa.paged_prefill_attention(*args[:8], start,
                                                          *args[8:]),
            "plain": lambda: ppa.paged_prefill_attention_ref(
                *args[:8], start, *args[8:]),
            "library": lambda: sdpa(ql, k_all, v_all, attn_mask=mask)},
            iters=10)
        pages, pairs, live = 0, 0, 0
        for x in rows:
            if x is not None:
                pages += min(-(-x[0] // page), nb)
                pairs += x[1] * x[0] + x[1] * (x[1] + 1) // 2
                live += x[1]
        nbytes = (live * kh * (g + 2) * hd * 2 + pages * (
            kh * page * (2 * hd + 8) + page * 4) + bt.numel() * 4
            + qp.numel() * 4 + r * 4 + q.numel() * 4)
        bound = attention_bound(ctx, nbytes, 4 * hd * kh * g * pairs, True)
        res["paged_prefill_attention"] = {
            "shape": [r, s, kh, g, hd, page, nb], "rows": rows,
            "query_rows_a_kv_head": s * g, "max_abs_err": max(errs),
            **bound, "kernel_ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"]}

        # K4: the packed tick (six decode rows, chunks of 200 and 50)
        m = VARLEN_MAIN
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            args = _varlen_inputs(torch, rng, m["segs"], kh, g, hd, page, nb,
                                  m["pad"], dtype, device)
            start = va.segment_start(args[7], args[8], len(m["segs"]))
            full = (*args[:9], start, *args[9:])
            errs.append(held("varlen_attention",
                             lambda: va.varlen_attention(*full),
                             lambda: va.varlen_attention_ref(*full),
                             (slice(None), args[8] < 0)))
        q, kc, ks, vc, vs, pool_pos, bt, qp, tok_slot, kf, vf = args
        nr, tt = len(m["segs"]), q.shape[1]
        rows_list = va.segment_rows(tok_slot, nr)
        hist = pda.gather_pages(pool_pos, bt)
        sp = hist.shape[1]
        ok_hist = (hist >= 0) & (hist < start[:, None])
        own = tok_slot[:, None] == torch.arange(nr, device=device)
        fresh_ok = ((tok_slot[None, :] == tok_slot[:, None])
                    & (tok_slot[None, :] >= 0) & (qp[None, :] <= qp[:, None])
                    & (qp[None, :] >= 0))
        mask = torch.cat([(own[:, :, None] & ok_hist[None]).reshape(
            tt, nr * sp), fresh_ok], dim=1)
        k_all = torch.cat([dequant(kc, ks, bt).transpose(0, 1).reshape(
            kh, nr * sp, hd), kf], dim=1)
        v_all = torch.cat([dequant(vc, vs, bt).transpose(0, 1).reshape(
            kh, nr * sp, hd), vf], dim=1)
        k_all, v_all = (_expand_heads(x, g, 0)[None] for x in (k_all, v_all))
        ql = q.permute(0, 2, 1, 3).reshape(1, kh * g, tt, hd)
        t = ctx["timer"]({
            "kernel": lambda: va.varlen_attention(*full, rows_list),
            "plain": lambda: va.varlen_attention_ref(*full),
            "library": lambda: sdpa(ql, k_all, v_all, attn_mask=mask)},
            iters=10)
        pages, pairs, live = 0, 0, 0
        for h, n in m["segs"]:
            if n:
                pages += min(-(-h // page), nb)
                pairs += n * h + n * (n + 1) // 2
                live += n
        nbytes = (live * kh * (g + 2) * hd * 2 + pages * (
            kh * page * (2 * hd + 8) + page * 4) + bt.numel() * 4
            + 2 * tt * 4 + nr * 4 + q.numel() * 4)
        bound = attention_bound(ctx, nbytes, 4 * hd * kh * g * pairs, True)
        res["varlen_attention"] = {
            "segs": m["segs"], "K": kh, "G": g, "T": tt,
            "max_abs_err": max(errs), **bound, "kernel_ms": t["kernel"],
            "plain_ms": t["plain"], "library_ms": t["library"]}
        out[cfg_name] = res
    return out


# the sharded deployment's head split at llama2-7b: the (2, 2) mesh's
# "model" dim of four ranks, 16 of the 32 kv heads a rank
HEAD_GROUPS = 2


def _route_delta(fn, call):
    """``call()``'s result and the routes it added to ``fn``'s
    ``route_launches``."""
    before = dict(fn.route_launches)
    out = call()
    return out, {k: v - before[k] for k, v in fn.route_launches.items()
                 if v != before[k]}


def _kernel_head_groups(ctx) -> dict:
    """K2, K3 and K4 at llama2-7b's main-path shapes (bf16 q, K 32, hd
    128) on each head group of a ``HEAD_GROUPS``-way split, called as the
    sharded layers call them: K2's and K3's q and fresh k/v sliced to
    contiguous tensors, K4's q and fresh k/v as head slices of the packed
    step's (T, K, ...) views, every pool leaf sliced to a contiguous copy.
    Each group's output must equal the same rows of the all-heads call bit
    for bit, by the same route. Then the all-heads call and one group's
    timed in turns, with the group's plain version and SDPA over its
    dequantized bf16 K/V, each call beside its bound."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va

    device = ctx["device"]
    rng = np.random.default_rng(32)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, g, hd, page, nb = 32, 1, 128, 16, 64
    kl = kh // HEAD_GROUPS
    heads = lambda t, dim, off: t.narrow(dim, off, kl).contiguous()
    pool_of = lambda pool, off: [heads(t, 1, off) for t in pool[:4]] \
        + list(pool[4:])

    def dequant(codes, scale, bt):  # (R, K, nb·page, hd) bf16
        return (pda.gather_pages(codes, bt).float()
                * pda.gather_pages(scale, bt)[..., None]).to(torch.bfloat16)

    calls = {}

    # K2: the paged decode tick's eight rows
    toks = [1024, 700, 301, 64, 17, 1, 0, 500]
    pool = _paged_pool(torch, rng, kh, hd, page, nb, toks, device)
    q_pos = torch.tensor([n - 1 for n in toks], dtype=torch.int32,
                         device=device)
    q = torch.randn((len(toks), kh, g, hd), device=device).to(torch.bfloat16)
    pages = sum(min(-(-n // page), nb) for n in toks)

    def k2_bytes(k):
        return (len(toks) * k * g * hd * 6 + pages * (k * page * (2 * hd + 8)
                + page * 4) + len(toks) * (nb + 1) * 4)

    def k2_library(args):
        qg, kc, ks, vc, vs, pos, bt, qp = args
        kv_pos = pda.gather_pages(pos, bt)
        mask = ((kv_pos >= 0) & (kv_pos <= qp[:, None]))[:, None, None, :]
        kd, vd = dequant(kc, ks, bt), dequant(vc, vs, bt)
        return lambda: sdpa(qg, kd, vd, attn_mask=mask)

    calls["paged_decode_attention"] = (
        pda.paged_decode_attention, pda.paged_decode_attention_ref, 1,
        lambda off: (heads(q, 1, off), *pool_of(pool, off), q_pos),
        (q, *pool, q_pos), k2_bytes, 4 * g * hd * sum(toks), False,
        k2_library)

    # K3: the chunk call (two continuation chunks, a fork, five pads)
    rows = [(256, 256), None, (512, 88), None, (200, 150), None, None, None]
    s = 256
    a3 = _prefill_inputs(torch, rng, len(rows), s, kh, g, hd, page, nb,
                         rows, torch.bfloat16, device)
    start3 = ppa.first_call_position(a3[7])
    live = [x for x in rows if x is not None]
    pairs = sum(n * h + n * (n + 1) // 2 for h, n in live)
    p3 = sum(min(-(-h // page), nb) for h, _ in live)

    def k3_bytes(k):
        return (sum(n for _, n in live) * k * (g + 2) * hd * 2 + p3 * (
            k * page * (2 * hd + 8) + page * 4) + a3[6].numel() * 4
            + a3[7].numel() * 4 + len(rows) * 4
            + a3[0].numel() // kh * k * 4)

    def k3_library(args):
        qg, kc, ks, vc, vs, pos, bt, qp, start, kf, vf = args
        hist = pda.gather_pages(pos, bt)
        kv_pos = torch.cat([torch.where(hist < start[:, None], hist, -1),
                            qp], dim=1)
        k_all = torch.cat([dequant(kc, ks, bt), kf.transpose(1, 2)], dim=2)
        v_all = torch.cat([dequant(vc, vs, bt), vf.transpose(1, 2)], dim=2)
        ql = qg.permute(0, 2, 3, 1, 4).reshape(len(rows), kl * g, s, hd)
        mask = ((kv_pos[:, None, :] >= 0)
                & (kv_pos[:, None, :] <= qp[:, :, None]))[:, None]
        return lambda: sdpa(ql, k_all, v_all, attn_mask=mask)

    calls["paged_prefill_attention"] = (
        ppa.paged_prefill_attention, ppa.paged_prefill_attention_ref, 2,
        lambda off: (heads(a3[0], 2, off), *pool_of(a3[1:7], off), a3[7],
                     start3, heads(a3[8], 2, off), heads(a3[9], 2, off)),
        (*a3[:8], start3, *a3[8:]), k3_bytes, 4 * hd * g * pairs, True,
        k3_library)

    # K4: the packed tick; q and fresh k/v laid out as the packed step
    # hands them over, (K, T, ...) views of (T, K, ...) tensors
    m = VARLEN_MAIN
    a4 = list(_varlen_inputs(torch, rng, m["segs"], kh, g, hd, page, nb,
                             m["pad"], torch.bfloat16, device))
    for i in (0, 9, 10):
        a4[i] = a4[i].transpose(0, 1).contiguous().transpose(0, 1)
    nr = len(m["segs"])
    start4 = va.segment_start(a4[7], a4[8], nr)
    work = va.segment_rows(a4[8], nr)
    fresh = [(h, n) for h, n in m["segs"] if n]
    pairs4 = sum(n * h + n * (n + 1) // 2 for h, n in fresh)
    p4 = sum(min(-(-h // page), nb) for h, _ in fresh)

    def k4_bytes(k):
        return (sum(n for _, n in fresh) * k * (g + 2) * hd * 2 + p4 * (
            k * page * (2 * hd + 8) + page * 4) + a4[6].numel() * 4
            + 2 * a4[7].numel() * 4 + nr * 4 + a4[0].numel() // kh * k * 4)

    def k4_library(args):
        qg, kc, ks, vc, vs, pos, bt, qp, slot, start, kf, vf = args[:12]
        tt = qg.shape[1]
        hist = pda.gather_pages(pos, bt)
        sp = hist.shape[1]
        ok_hist = (hist >= 0) & (hist < start[:, None])
        own = slot[:, None] == torch.arange(nr, device=device)
        fresh_ok = ((slot[None, :] == slot[:, None]) & (slot[None, :] >= 0)
                    & (qp[None, :] <= qp[:, None]) & (qp[None, :] >= 0))
        mask = torch.cat([(own[:, :, None] & ok_hist[None]).reshape(
            tt, nr * sp), fresh_ok], dim=1)
        k_all = torch.cat([dequant(kc, ks, bt).transpose(0, 1).reshape(
            kl, nr * sp, hd), kf], dim=1)[None]
        v_all = torch.cat([dequant(vc, vs, bt).transpose(0, 1).reshape(
            kl, nr * sp, hd), vf], dim=1)[None]
        ql = qg.permute(0, 2, 1, 3).reshape(1, kl * g, tt, hd)
        return lambda: sdpa(ql, k_all, v_all, attn_mask=mask)

    calls["varlen_attention"] = (
        va.varlen_attention, va.varlen_attention_ref, 0,
        lambda off: (a4[0].narrow(0, off, kl), *pool_of(a4[1:7], off),
                     a4[7], a4[8], start4, a4[9].narrow(0, off, kl),
                     a4[10].narrow(0, off, kl), work),
        (*a4[:9], start4, *a4[9:], work), k4_bytes, 4 * hd * g * pairs4,
        True, k4_library)

    out = {}
    for name, (fn, ref, dim, group_args, full_args, nbytes, flops_a_head,
               bf16, library) in calls.items():
        full, full_route = _route_delta(fn, lambda: fn(*full_args))
        groups = []
        for off in range(0, kh, kl):
            args = group_args(off)
            part, route = _route_delta(fn, lambda: fn(*args))
            groups.append({"heads": [off, off + kl], "route": route,
                           "bit_for_bit": bool(torch.equal(
                               part, full.narrow(dim, off, kl)))})
        ok = all(gr["bit_for_bit"] and gr["route"] == full_route
                 for gr in groups)
        if not ok:
            emit({"phase": "kernels", "head_groups": {name: groups}})
            raise SystemExit(f"{name} on a head group differs from the "
                             f"all-heads call: {groups}")
        one = group_args(0)
        plain_args = one[:12] if name == "varlen_attention" else one
        err = float((fn(*one) - ref(*plain_args)).abs().max())
        t = ctx["timer"]({"all_heads": lambda: fn(*full_args),
                          "one_group": lambda: fn(*one),
                          "one_group_plain": lambda: ref(*plain_args),
                          "one_group_library": library(one)}, iters=20)
        out[name] = {
            "heads": kh, "group_heads": kl, "route": full_route,
            "groups": groups, "ok": ok, "one_group_max_abs_err": err,
            **{f"{k}_ms": v for k, v in t.items()},
            "all_heads_bound": attention_bound(
                ctx, nbytes(kh), flops_a_head * kh, bf16),
            "one_group_bound": attention_bound(
                ctx, nbytes(kl), flops_a_head * kl, bf16)}
        if err > ATOL:
            raise SystemExit(f"{name} on a head group: {err} from its "
                             f"plain version")
    return out


def phase_kernels(ctx) -> None:
    parts = {}
    for key, fn in (("decode_attention", _kernel_k1),
                    ("paged_decode_attention", _kernel_k2),
                    ("paged_decode_attention_verify", _k2_verify),
                    ("paged_prefill_attention", _kernel_k3),
                    ("varlen_attention", _kernel_k4),
                    ("tabq_ts_encode", _kernel_k5_k6),
                    ("dequant_matmul", _kernel_k7),
                    ("gqa_groups", _kernel_groups),
                    ("head_groups", _kernel_head_groups),
                    ("cuda_graph", _graph_replay)):
        parts[key] = fn(ctx)
        _mark(ctx, key)
    emit({"phase": "kernels", **_times(ctx), "nvidia_smi": ctx["smi"],
          **parts})


def _greedy_stepwise(params, cfg, prompts, n, opts, cache_len, device,
                     routes=None, patches=None):
    """Greedy decoding through prefill/decode_step: tokens (B, n) and the
    logits each token was drawn from, (B, n, V), both numpy; with an
    active ``routes`` (:class:`_Routes`), also a route record: each
    step's MoE choices at its token ``sel`` (B, n, L, k), their router
    gaps ``gap`` (B, n, L), and the prefill's choices at every prompt
    position ``prompt`` (L, B, S, k), and the int8 KV codes written, by
    position: ``codes`` (B, slots, L·2·K·hd), from the final caches (an
    int8 cache without rings). ``patches`` feed the vision stub; codebook
    prompts (B, S, K) give tokens (B, n, K) and logits (B, n, K, V)."""
    import torch
    from repro_torch.models.transformer import decode_step, prefill

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device=device)
        logits, caches = prefill(params, cfg, tokens, cache_len, opts,
                                 None if patches is None else
                                 torch.as_tensor(patches, device=device))
        if routes is not None:
            routes.keep(*tokens.shape)
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
                if routes is not None:
                    routes.keep(tokens.shape[0], 1)
    import numpy as np

    out = np.stack(toks, 1), np.stack(lgs, 1)
    if routes is None:
        return out
    return out + (routes.record(caches),)


def _teacher_forced(params, cfg, prompts, forced, opts, cache_len, device,
                    routes=None, patches=None):
    """The logits (B, n, V) at each step when the decode is fed ``forced``
    (B, n) instead of its own argmax; with an active ``routes``, also the
    route record of :func:`_greedy_stepwise`; ``patches`` and codebooks as
    there."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import decode_step, prefill

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, device=device)
        logits, caches = prefill(params, cfg, tokens, cache_len, opts,
                                 None if patches is None else
                                 torch.as_tensor(patches, device=device))
        if routes is not None:
            routes.keep(*tokens.shape)
        lgs = [logits.cpu().numpy()]
        for t in range(forced.shape[1] - 1):
            nxt = torch.as_tensor(forced[:, t:t + 1], device=device)
            logits, caches = decode_step(
                params, cfg, nxt, caches,
                torch.tensor(tokens.shape[1] + t, dtype=torch.int32,
                             device=device), opts)
            if routes is not None:
                routes.keep(tokens.shape[0], 1)
            lgs.append(logits.cpu().numpy())
    if routes is None:
        return np.stack(lgs, 1)
    return np.stack(lgs, 1), routes.record(caches)


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
# Two paths of a mixture-of-experts config are held step by step, with
# each MoE layer's top-k choice recorded on both (``_Routes``). Every step
# is held to the dense configs' bound (its largest logit error against
# the tolerance). A step past the bound is excused only where the two
# paths measurably made another discrete choice: at the step's own token
# some layer chose another set of experts, or (where both paths are
# recorded at every position: the tiny configs' CPU and card runs, the
# int8 bound's two paths) an earlier position of its row did so in a
# layer whose keys and values later layers attend, or (the tiny runs,
# both int8) a cache slot the step attends holds another int8 code. At
# most half the steps of a comparison may be excused. Tokens must agree
# at every step within the bound whose top-1/top-2 margin exceeds the
# tolerance (streams running free: up to the first step where they part,
# which only a near tie or an excused step may cause), at least one
# token a row where both paths are fed the same tokens
MOE_RULE = ("every step at the full bound; a step past it excused only "
            "where a routing choice or an int8 code measurably differs; "
            "at most half excused")
MOE_MAX_EXCUSED = 0.5


class _Routes:
    """Each MoE layer's top-k choice as a path computes it. Inside
    ``with``, ``moe.top_k`` is wrapped: every call returns what the real
    one returns and keeps, on the host, the chosen experts (T, k) and the
    gap between the k-th and (k+1)-th router probability (T,), a copy a
    call (for checks, not timings); ``by_rid`` holds what
    :func:`_record_logits` keeps a request."""

    def __init__(self):
        self.calls, self.by_rid, self.undo, self.kept = [], {}, [], []

    def __enter__(self):
        import torch
        from repro_torch.models import moe

        self._moe, real = moe, moe.top_k

        def top_k(probs, k):
            vals, idx = real(probs, k)
            more, _ = real(probs, min(k + 1, probs.shape[-1]))
            gap = more[..., k - 1] - more[..., k] if more.shape[-1] > k \
                else torch.full_like(more[..., 0], float("inf"))
            self.calls.append((idx.cpu().numpy(), gap.float().cpu().numpy()))
            return vals, idx

        self._real, moe.top_k = real, top_k
        return self

    def __exit__(self, *exc):
        self._moe.top_k = self._real
        while self.undo:
            self.undo.pop()()

    def take(self):
        """The calls since the last take, one a layer: choices (L, T, k)
        and gaps (L, T)."""
        import numpy as np

        calls, self.calls = self.calls, []
        return (np.stack([c[0] for c in calls]),
                np.stack([c[1] for c in calls]))

    def last_tokens(self, b, s):
        """A (b, s) call's every layer at each row's last token: choices
        (b, L, k), gaps (b, L), and the whole call's choices (L, b, s, k)."""
        sel, gap = self.take()
        sel = sel.reshape(sel.shape[0], b, s, -1)
        return (sel[:, :, -1].transpose(1, 0, 2),
                gap.reshape(gap.shape[0], b, s)[:, :, -1].T, sel)

    def keep(self, b, s):
        """Keep a stepwise run's (b, s) call: each row's last token, and
        every position of the run's first call (its prefill)."""
        self.kept.append(self.last_tokens(b, s))

    def record(self, caches):
        """The kept run's route record (see :func:`_greedy_stepwise`), its
        final ``caches`` read for their codes; the next run starts
        afresh."""
        import numpy as np

        kept, self.kept = self.kept, []
        return {"sel": np.stack([k[0] for k in kept], 1),
                "gap": np.stack([k[1] for k in kept], 1),
                "prompt": kept[0][2], "codes": _cache_codes(caches)}


def _route_flips(sel_a, sel_b):
    """Per step, the layers whose chosen set of experts differs between two
    paths: ``sel_a``/``sel_b`` (n, L, k) → a list of n arrays of layer
    indices."""
    import numpy as np

    differ = (np.sort(sel_a, -1) != np.sort(sel_b, -1)).any(-1)  # (n, L)
    return [np.nonzero(d)[0] for d in differ]


def _cache_codes(caches):
    """The int8 K and V codes of every attention layer's cache (B, K, S,
    hd), by slot: (B, S, L·2·K·hd) on the host; None for an unquantized
    cache. A Mamba-2 layer's state has no slots and no codes."""
    import numpy as np
    import torch

    caches = [c for c in caches if not isinstance(c, tuple)]
    if caches[0].k.dtype != torch.int8:
        return None
    return np.concatenate([
        t.permute(0, 2, 1, 3).reshape(t.shape[0], t.shape[2], -1)
        .cpu().numpy() for c in caches for t in (c.k, c.v)], axis=-1)


def _earlier_flips(rec_a, rec_b, row):
    """Per step of ``row``, the (layer, position) pairs before the step's
    token whose choice differs between two stepwise runs (``rec_a``,
    ``rec_b``: the route records of :func:`_greedy_stepwise` /
    :func:`_teacher_forced`), in every layer but the last (whose choices
    no later layer attends)."""
    import numpy as np

    def differ(a, b):
        return (np.sort(a, -1) != np.sort(b, -1)).any(-1)[:-1]

    prompt = int(differ(rec_a["prompt"][:, row, :-1],
                        rec_b["prompt"][:, row, :-1]).sum())
    steps = differ(rec_a["sel"][row].transpose(1, 0, 2),
                   rec_b["sel"][row].transpose(1, 0, 2)).sum(0)  # (n,)
    return [prompt + int(steps[:j].sum()) for j in range(len(steps))]


def _code_flips(rec_a, rec_b, row):
    """Per step of ``row``, the cache slots up to the step's own token
    (which its query attends) where some layer's int8 K or V code differs
    between two stepwise runs: the cache's own discontinuity, a value one
    side of a rounding boundary on one path and the other on the other."""
    import numpy as np

    differ = (rec_a["codes"][row] != rec_b["codes"][row]).any(-1)
    s = rec_a["prompt"].shape[2]
    return [int(differ[:s + j].sum()) for j in range(rec_a["sel"].shape[1])]


def _moe_hold(rows, tol, free, min_tokens):
    """MOE_RULE over ``rows``, one dict a row: ``err`` (n,) each step's
    largest logit error relative to the largest reference logit,
    ``margin`` (n,) the reference's top-1/top-2 gap on the same scale,
    ``got``/``want`` (n,) tokens, ``flips`` (n arrays of the layers whose
    choice differs at that step's token), ``earlier`` (n counts of
    differing (layer, position) pairs before it) and ``codes`` (n counts
    of cache slots up to it whose int8 codes differ), each None where not
    recorded, ``gaps`` ((n, L) router gaps of each path, for the report).
    A dense config's rows carry no ``flips`` and no ``gaps``: no step is
    excused, so every step must lie within the bound. ``free``: the two
    streams ran free, so a row compares only up to the first step where
    its tokens part. Returns the report, with ``ok``."""
    import numpy as np

    steps = within = tokens = served = routed_otherwise = coded = 0
    worst = 0.0
    excused, unexplained, wrong = [], [], []
    for r, row in enumerate(rows):
        err, got, want = row["err"], row["got"], row["want"]
        earlier, codes = row.get("earlier"), row.get("codes")
        n = len(err)
        served += n
        if free:
            parted = np.nonzero(got != want)[0]
            n = int(parted[0]) + 1 if parted.size else n
        for j in range(n):
            steps += 1
            layers = row["flips"][j] if "flips" in row else np.zeros(0, int)
            before = earlier[j] if earlier is not None else 0
            slots = codes[j] if codes is not None else 0
            routed_otherwise += bool(len(layers) or before)
            coded += bool(slots)
            worst = max(worst, float(err[j]))
            if err[j] > tol:
                step = {"row": r, "step": j, "err": float(err[j]),
                        "layers": layers.tolist(), "earlier_pairs": before,
                        "code_slots": slots,
                        "gaps": [[float(g[j, ly]) for ly in layers]
                                 for g in row.get("gaps", ())]}
                (excused if len(layers) or before or slots
                 else unexplained).append(step)
                continue
            within += 1
            if row["margin"][j] > tol:
                tokens += 1
                if got[j] != want[j]:
                    wrong.append((r, j))
    ok = (not unexplained and not wrong and tokens >= min_tokens
          and len(excused) <= MOE_MAX_EXCUSED * steps)
    return {"steps_comparable": steps, "steps_within_bound": within,
            "steps_routed_otherwise": routed_otherwise,
            "steps_after_a_code_differs": coded,
            "steps_excused": excused, "steps_past_unexplained": unexplained,
            "tokens_served": served, "tokens_compared": tokens,
            "min_tokens": min_tokens, "tokens_differing": wrong,
            "max_rel_logit_err": worst, "tol": tol, "ok": ok}


def _margins(logits):
    """Each step's top-1/top-2 gap relative to the largest logit of
    ``logits`` (..., V)."""
    import numpy as np

    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) / np.abs(logits).max()


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
    _mark(ctx, "cpu")
    got_lg = _teacher_forced(card, cfg, prompts, want, opts, cache_len,
                             device)
    rel = float(np.abs(got_lg - want_lg).max() / np.abs(want_lg).max())
    got = Engine(cfg, card, opts, cache_len=cache_len,
                 device=device).generate(prompts, n).tokens[:, 12:]
    ok, compared = _margin_agreement(got, want, want_lg, MODEL_REL)
    _mark(ctx, "card")
    emit({"phase": "model", **_times(ctx), "config": cfg.name, "steps": n,
          "max_rel_logit_err": rel, "tol": MODEL_REL,
          "tokens_compared": compared, "tokens_equal_all": bool(
              np.array_equal(got, want)), "ok": ok and rel <= MODEL_REL})
    if not (ok and rel <= MODEL_REL):
        raise SystemExit("model: the card disagrees with the CPU run")


def _planner_run(device: str) -> dict:
    """``examples/split_inference_torch.py`` (Eq. 8's planner on the
    committed induction vehicle, then the solution deployed) in a process
    of its own on ``device`` ("cuda" is its default): its report, the
    JSON of its last line."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "split_inference_torch.py"),
         *(["--device", device] if device != "cuda" else [])],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    if res.returncode != 0:
        raise SystemExit(f"vehicle: the planner failed on {device}:\n"
                         f"{res.stdout[-2000:]}{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _planner_parted(cfg, params, prompts, card, cpu, device) -> list:
    """The candidates whose copy accuracy differs between the card's and
    the CPU's planner runs, each re-run on both devices with its cloud
    logits recorded: a candidate is excused only where its tokens agree
    by the margin rule of the CPU's logits at SPLIT_TINY_REL."""
    import numpy as np
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.split_engine import SplitEngine

    want = {(c["split_layer"], c["qw_front"]): c["accuracy"]
            for c in cpu["candidates"]}
    parted = []
    for c in card["candidates"]:
        key = (c["split_layer"], c["qw_front"])
        if c["accuracy"] == want.get(key):
            continue
        opsc = OPSCConfig(split_layer=key[0], qw_front=key[1])
        runs = []
        for dev in ("cpu", device):
            eng = SplitEngine(cfg, params, opsc, opts=RuntimeOpts(
                q_chunk=64, kv_chunk=64, moe_capacity_factor=0.0),
                cache_len=128, device=dev)
            rec = _record_cloud_logits(eng)
            toks, _ = eng.generate(prompts, 16)
            runs.append((toks[:, prompts.shape[1]:], np.stack(rec, 1)))
        ok, compared = _margin_agreement(runs[1][0], runs[0][0], runs[0][1],
                                         SPLIT_TINY_REL)
        parted.append({"split_layer": key[0], "qw_front": key[1],
                       "accuracy_card_cpu": [c["accuracy"], want.get(key)],
                       "tokens_compared": compared, "excused": ok})
    return parted


def phase_vehicle(ctx) -> None:
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.data.pipeline import induction_batch
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
    tokens, _ = induction_batch(np.random.default_rng(0), 16, 2 * half + 1,
                                vocab)  # [prefix][SEP][prefix]
    prefix, prompts = tokens[:, :half], tokens[:, :half + 1]
    srv = LLMServer(cfg, params, opts, backend="fused", cache_len=64,
                    device=device)
    rids = [srv.submit(p, SamplingParams(max_tokens=half)) for p in prompts]
    outs = srv.run()
    got = np.stack([outs[r].tokens for r in rids])
    _mark(ctx, "serve")
    want, want_lg = _greedy_stepwise(params, cfg, prompts, half, opts, 64,
                                     "cpu")
    ok, compared = _margin_agreement(got, want, want_lg, MODEL_REL)
    acc = float(np.mean(got == prefix))
    _mark(ctx, "cpu")

    # Eq. 8's planner (the example) on the card and on the CPU
    card, cpu = _planner_run("cuda"), _planner_run("cpu")
    _mark(ctx, "planner")
    # the example's planner prompts: seed 0's 32 rows, the first 8
    ex_tokens, _ = induction_batch(np.random.default_rng(0), 32,
                                   2 * half + 1, vocab)
    planner_prompts = ex_tokens[:8, :half + 1]
    parted = _planner_parted(cfg, params, planner_prompts, card, cpu, device)
    sol = card["solution"]
    checks = {
        "fused_card_equals_cpu": ok,
        "planner_candidates": len(card["candidates"])
        == len(cpu["candidates"]) == 6,
        "planner_candidates_agree": all(p["excused"] for p in parted),
        # the chosen configuration, Ψ and memory; its accuracy too, unless
        # its candidate parted and the margin rule excused it
        "planner_solution_equals_cpu": all(
            sol[k] == cpu["solution"][k]
            for k in ("config", "psi", "memory_bytes")) and (
            sol["accuracy"] == cpu["solution"]["accuracy"] or any(
                (p["split_layer"], p["qw_front"]) == (
                    sol["config"]["split_layer"],
                    sol["config"]["qw_front"]) for p in parted)),
        "planner_solution_in_budget": sol["memory_bytes"]
        <= card["budget_bytes"],
        "planner_solution_within_drop": sol["accuracy"]
        >= card["base_accuracy"] - card["accuracy_drop"],
        "planner_base_accuracy_equals_cpu": card["base_accuracy"]
        == cpu["base_accuracy"]}
    _mark(ctx, "planner_held")
    emit({"phase": "vehicle", **_times(ctx),
          "requests": len(rids), "copy_accuracy": acc,
          "cpu_copy_accuracy": float(np.mean(want == prefix)),
          "tokens_compared": compared,
          "planner": {"card": card, "cpu_solution": cpu["solution"],
                      "cpu_candidates": cpu["candidates"],
                      "parted_candidates": parted},
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"vehicle: failed checks {checks}")


# the profiled calls of a full-width step, tick or split stage in every
# phase: one profiled call of these eager steps costs a second or more of
# host time, and the device time a call is steady (it was 5 in the
# serve, paged, packed, split, spec and disagg phases; PERF.md)
STEP_PROFILE_N = 2


def _device_profile(torch, fn, n: int) -> tuple:
    """``fn`` run ``n`` times under ``torch.profiler``: (device-busy ms per
    call, the kernels by device time per call, largest first)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return _profile_rows(torch, prof, n)


def _profile_rows(torch, prof, n: int = 1) -> tuple:
    """(device-busy ms per call, the device kernels by time per call,
    largest first) of a stopped profiler over ``n`` calls."""
    rows = []  # device kernels only: CPU ops would count their kernels again
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        rows.append({"ms": dev_us / n / 1e3, "kernel": evt.key[:60],
                     "calls": evt.count / n})
    rows.sort(key=lambda row: -row["ms"])
    return sum(row["ms"] for row in rows), rows


def _kernel_share(rows, names) -> dict:
    """Device ms and launches a call of the profile ``rows`` whose kernel
    name holds one of ``names``."""
    hit = [row for row in rows if any(n in row["kernel"] for n in names)]
    return {"ms": sum(row["ms"] for row in hit),
            "launches": sum(row["calls"] for row in hit),
            "kernels": sorted({row["kernel"] for row in hit})}


def _llama7b_params(ctx) -> tuple:
    """llama2-7b's random bf16 weights from seed 0, drawn on the card once
    and shared by the serve and paged phases; (params, seconds to draw)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.params import init_params

    if "params_7b" not in ctx:
        t0 = time.perf_counter()
        params = init_params(get_config("llama2-7b"), torch.Generator(
            device=ctx["device"]).manual_seed(0), torch.bfloat16,
            ctx["device"])
        torch.cuda.synchronize()
        ctx["params_7b"] = (params, time.perf_counter() - t0)
    return ctx["params_7b"]


# the uniform activation quantization baseline (RuntimeOpts.act_bits): its
# width, the decode steps its full-width run is held over, and the tiny
# f32 run's bound, card against CPU: AIQ's codes land a step apart where
# the two devices' f32 sums differ in the last bit, as TAB-Q's do in the
# split (SPLIT_TINY_REL)
ACT_BITS = 8
ACT_NEW = 16
ACT_TINY_REL = 2e-2


def _serve_act_bits(ctx, cfg, params, prompts, cache_len) -> dict:
    """llama2-7b at full width through the fused ``Engine`` with act_bits
    (``ACT_BITS``): greedy for ``ACT_NEW`` tokens with the K1 counter set
    to 0 just before and read just after; its logits teacher-forced on the
    run without act_bits, their largest distance from that run's relative
    to its largest logit; a decode step with the host and busy; and the
    tiny f32 model with act_bits on the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.transformer import (RuntimeOpts, decode_step,
                                                prefill)
    from repro_torch.params import init_params
    from repro_torch.serving.engine import Engine

    device = ctx["device"]
    plain = RuntimeOpts(quantized_kv=True)
    opts = RuntimeOpts(quantized_kv=True, act_bits=ACT_BITS)
    s = prompts.shape[1]
    da.decode_attention.launches = 0
    out = Engine(cfg, params, opts, cache_len=cache_len,
                 device=device).generate(prompts, ACT_NEW)
    k1 = da.decode_attention.launches
    want, want_lg = _greedy_stepwise(params, cfg, prompts, ACT_NEW, plain,
                                     cache_len, device)
    got_lg = _teacher_forced(params, cfg, prompts, want, opts, cache_len,
                             device)
    dist = float(np.abs(got_lg - want_lg).max() / np.abs(want_lg).max())
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device=device)
        logits, caches = prefill(params, cfg, toks, cache_len, opts)
        nxt = logits.argmax(-1)[:, None]
        pos = torch.tensor(s, dtype=torch.int32, device=device)
        step = lambda: decode_step(params, cfg, nxt, caches, pos, opts)  # noqa: E731
        step_ms = ctx["timer"]({"step": step}, iters=20,
                               device_only=False)["step"]
        busy_ms, rows = _device_profile(torch, step, STEP_PROFILE_N)

    tiny = get_config("llama2-7b-tiny")
    t_opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                         act_bits=ACT_BITS)
    cpu = init_params(tiny, torch.Generator().manual_seed(0))
    card = {k: v.to(device) for k, v in cpu.items()}
    t_prompts = np.random.default_rng(0).integers(0, tiny.vocab_size, (3, 12))
    t_want, t_want_lg = _greedy_stepwise(cpu, tiny, t_prompts, 24, t_opts, 64,
                                         "cpu")
    t_got_lg = _teacher_forced(card, tiny, t_prompts, t_want, t_opts, 64,
                               device)
    t_rel = float(np.abs(t_got_lg - t_want_lg).max()
                  / np.abs(t_want_lg).max())
    t_got = Engine(tiny, card, t_opts, cache_len=64,
                   device=device).generate(t_prompts, 24).tokens[:, 12:]
    t_ok, t_compared = _margin_agreement(t_got, t_want, t_want_lg,
                                         ACT_TINY_REL)
    gen = out.tokens[:, s:]
    checks = {
        "act_bits_tokens_in_vocab": int(gen.min()) >= 0
        and int(gen.max()) < cfg.vocab_size,
        "act_bits_logits_finite": bool(np.isfinite(got_lg).all()),
        "act_bits_moves_logits": dist > 0,
        "act_bits_k1_launches": k1 == cfg.num_layers * (ACT_NEW - 1),
        "act_bits_tiny_card_equals_cpu": t_ok and t_rel <= ACT_TINY_REL}
    return {"act_bits": ACT_BITS, "batch": int(prompts.shape[0]),
            "new_tokens": ACT_NEW, "k1_launches": k1,
            "max_rel_logit_distance_from_plain": dist,
            "tokens_equal_plain": bool(np.array_equal(gen, want)),
            "decode_step_ms": step_ms, "profile_device_ms_per_step": busy_ms,
            "idle_share": 1 - busy_ms / step_ms,
            "profile_top": rows[:6],
            "tiny": {"max_rel_logit_err": t_rel, "tol": ACT_TINY_REL,
                     "tokens_compared": t_compared,
                     "tokens_equal_all": bool(np.array_equal(t_got,
                                                             t_want))},
            "checks": checks}


def phase_serve(ctx) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sampling import (SamplingParams, sample_tokens,
                                           sampling_operands)
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.transformer import (RuntimeOpts, decode_step,
                                                prefill)
    from repro_torch.serving import engine
    from repro_torch.serving.api import LLMServer

    device = ctx["device"]
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    cache_len = 1024
    params, init_s = _llama7b_params(ctx)
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

    _mark(ctx, "first_run")
    decode_steps = (64 - 1) + (64 - 1)  # two length groups, 64 tokens each
    da.decode_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = serve(requests((stop,)))
    wall_s = time.perf_counter() - t0
    launches = {"decode_attention": da.decode_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"].update(launches)

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

    _mark(ctx, "main_run")
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

    _mark(ctx, "no_sync_loop")
    # decode step time at the first group's shape (B = 2, 128-token prompt)
    with torch.inference_mode():
        logits, caches = prefill(params, cfg, toks, cache_len, opts)
        nxt = logits.argmax(-1)[:, None]
        pos = torch.tensor(128, dtype=torch.int32, device=device)
        step = lambda: decode_step(params, cfg, nxt, caches, pos, opts)  # noqa: E731
        # host included: the host issues about 1,000 kernels per step
        step_ms = ctx["timer"]({"step": step}, iters=20,
                               device_only=False)["step"]
        device_ms, rows = _device_profile(torch, step, STEP_PROFILE_N)
    bw, _ = peak_rates(ctx["device_name"])
    weight_bytes = sum(t.numel() * t.element_size() for k, t in params.items()
                       if k != "embed") + b * cfg.d_model * 2
    m = cfg.pattern[0].mixer
    cache_bytes = cfg.num_layers * b * m.num_kv_heads * cache_len * (
        2 * m.head_dim + 8)
    _mark(ctx, "step_timing")
    act = _serve_act_bits(ctx, cfg, params, np.stack(prompts[:2]), cache_len)
    checks.update(act.pop("checks"))
    _mark(ctx, "act_bits")
    emit({"phase": "serve", **_times(ctx),
          "config": cfg.name, "params": n_params,
          "dtype": "bfloat16", "kv": "int8", "cache_len": cache_len,
          "init_s": init_s, "requests": len(outs), "finish_reasons": reasons,
          "generated": lengths, "stop_token": stop,
          "decode_steps": decode_steps, "launches": launches,
          "wall_s": wall_s,
          "tokens_per_s": sum(lengths) / wall_s,
          "computed_tokens_per_s": 2 * 64 * 2 / wall_s,
          "decode_step_ms": step_ms, "decode_step_batch": b,
          "decode_step_bound_ms": (weight_bytes + cache_bytes) / bw * 1e3,
          "profile_device_ms_per_step": device_ms,
          "k1_in_step": _kernel_share(rows, K1_DEVICE_NAMES),
          "profile_top": rows[:8], "act_bits": act,
          "max_memory_allocated": peak, "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"serve: failed checks {checks}")


# paged against fused logits of llama2-7b at full width in bf16, a sanity
# check only: the two paths' bf16 GEMMs round differently at their batch
# shapes (one bf16 step at the largest logit is 2^-8 of it; the paths differ
# by 0.9 to 1.8% of it on the H100, as far as the dense path alone moves
# when only its batch size changes), so this bound cannot see a fault of K3
PAGED_REL = 5e-2
# the same in f32 on rows whose prefill reads earlier chunks or the shared
# prefix back as int8 codes (K3's history): sound runs read 0.80 to 0.92%
# of the largest logit on the H100
HISTORY_REL = 2e-2
# the f32 margin rule must compare at least this many tokens over the
# greedy rows (random weights give flat logits, so it stops early)
F32_MIN_COMPARED = 100


def _record_logits(sched, routes=None) -> dict:
    """Wrap ``sched``'s sampler so that every emitted token's logits row is
    kept on the host: {rid: [(V,) f32, ...]} in generation order. Each
    sample then copies its logits to the host: for checks, not timings. A
    verify tick's tokens (``speculate_k`` > 0) take their rows of the
    verify logits: burst column j is generation index t0 + j. With an
    active ``routes`` (:class:`_Routes`; not with ``speculate_k``), each
    emitted token also keeps every MoE layer's choice at the token its
    logits came from and the router gaps, in ``routes.by_rid[rid]``: a
    (R, S) prefill, chunk or decode call's row i at its last column, a
    packed call's at its ``logit_rows[i]``. Leaving ``routes`` undoes
    this."""
    import numpy as np
    from repro_torch.serving import scheduler as scheduler_mod

    rec, last = {}, {}
    orig_sample, orig_emit = sched._sample, sched._emit
    orig_verify, orig_burst = sched._verify_tick, sched._emit_burst
    # the scheduler's step functions (the sharded deployment's under a
    # mesh); the verify step carries no routes (speculation is excluded)
    real_fwd = dict(sched._steps)

    def routed(name):
        def call(params, cfg, tokens, *args, **kw):
            routes.calls.clear()
            out = real_fwd[name](params, cfg, tokens, *args, **kw)
            sel, gap = routes.take()
            r, t = tokens.shape
            at = (args[3].cpu().numpy() if name == "packed"
                  else np.arange(r) * t + t - 1)
            last["routes"] = (sel[:, at], gap[:, at])
            return out
        return call

    def sample(logits, t, rows=None):
        last["logits"], last["rows"] = logits.float().cpu().numpy(), rows
        return orig_sample(logits, t, rows)

    def verify_tick(active, plan):
        real = scheduler_mod.speculative_verify

        def spy(drafts, n, logits, *args):
            last["verify"] = logits.float().cpu().numpy()
            return real(drafts, n, logits, *args)

        scheduler_mod.speculative_verify = spy
        try:
            orig_verify(active, plan)
        finally:
            scheduler_mod.speculative_verify = real

    def emit_burst(slot, toks, n, lps, kd):
        last["burst"] = [slot, 0]
        try:
            orig_burst(slot, toks, n, lps, kd)
        finally:
            del last["burst"]

    def emit(st, token, logprob):
        burst = last.get("burst")
        if burst is not None:
            row = last["verify"][burst[0], burst[1]]
            burst[1] += 1
        else:
            i = sched.slots.index(st)
            rows = last["rows"]
            j = i if rows is None else list(rows).index(i)
            row = last["logits"][j]
            if routes is not None:
                sel, gap = last["routes"]
                routes.by_rid.setdefault(st.req.rid, []).append(
                    (sel[:, j], gap[:, j]))
        rec.setdefault(st.req.rid, []).append(row)
        orig_emit(st, token, logprob)

    sched._sample, sched._emit = sample, emit
    sched._verify_tick, sched._emit_burst = verify_tick, emit_burst
    if routes is not None:
        sched._steps = {**real_fwd, **{
            f: routed(f) for f in ("prefill", "prefill_shared", "decode",
                                   "packed")}}
        routes.undo.append(lambda: setattr(sched, "_steps", real_fwd))
    return rec


def _against_dense(params, cfg, opts, prompts, outs, rec, tols,
                   device) -> tuple:
    """The paged run's streams ``outs`` (rows ``tols`` names) fed to the
    dense (fused) path on the same card: per row, the largest logit error
    relative to the largest dense logit over every step and at the first
    token, and whether the logits and (margin rule) the tokens agree within
    ``tols[row]``. Returns (agree, tokens compared, {row: error},
    {row: first-token error})."""
    import numpy as np

    agree, compared, rel, rel_first = True, 0, {}, {}
    for i, tol in tols.items():
        o = outs[i]
        dense = _teacher_forced(params, cfg, prompts[i][None],
                                o.tokens[None], opts, 1024, device)
        err = np.abs(np.stack(rec[o.rid]) - dense[0]).max(-1) / np.abs(
            dense).max()
        rel[i], rel_first[i] = float(err.max()), float(err[0])
        ok, c = _margin_agreement(o.tokens[None], dense.argmax(-1), dense,
                                  tol)
        agree = agree and ok and rel[i] <= tol
        compared += c
    return agree, compared, rel, rel_first


def _moe_against_dense(params, cfg, opts, prompts, outs, rec, routes, tol,
                       device) -> dict:
    """As :func:`_against_dense` for a MoE config over every row of
    ``outs``, held step by step as MOE_RULE says: ``routes`` is the
    :class:`_Routes` the paged run was recorded with, and the dense path
    is recorded here. Returns the rule's report with each row's largest
    error and first-token error."""
    import numpy as np

    rows, rel, rel_first = [], {}, {}
    for i, o in enumerate(outs):
        with _Routes() as dense_routes:
            dense, dense_rec = _teacher_forced(
                params, cfg, prompts[i][None], o.tokens[None], opts, 1024,
                device, dense_routes)
        err = np.abs(np.stack(rec[o.rid]) - dense[0]).max(-1) / np.abs(
            dense).max()
        rel[i], rel_first[i] = float(err.max()), float(err[0])
        paged = routes.by_rid[o.rid]
        rows.append({"err": err, "margin": _margins(dense[0]),
                     "got": o.tokens, "want": dense[0].argmax(-1),
                     "flips": _route_flips(dense_rec["sel"][0], np.stack(
                         [p[0] for p in paged])),
                     "gaps": (dense_rec["gap"][0],
                              np.stack([p[1] for p in paged]))})
    report = _moe_hold(rows, tol, False, len(rows))
    report.update(max_rel_logit_err_by_row=rel,
                  first_token_rel_err_by_row=rel_first)
    return report


def _paged_tiny(ctx) -> dict:
    """llama2-7b tiny through the paged Scheduler on the CPU (plain
    versions) and on the card (kernels K2 and K3): the card's tokens must
    agree with the CPU's under the margin rule of the CPU's logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, (10,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (18, 9, 4)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                     (n,))]) for n in (5, 3)]
    max_new = [6, 5, 8, 4, 6]

    def serve(device, record):
        sched = Scheduler(cfg, params, opts, num_pages=40, page_size=4,
                          max_slots=2, prefill_chunk=4, device=device)
        rec = _record_logits(sched) if record else None
        rids = [sched.submit(p, n, prefix_key="sys" if i >= 3 else None,
                             prefix_len=10 if i >= 3 else None)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        res = sched.run()
        return ([res[r][len(p):] for r, p in zip(rids, prompts)],
                [rec and np.stack(rec[r]) for r in rids], sched)

    cpu, cpu_logits, _ = serve("cpu", True)
    card, _, sched = serve(ctx["device"], False)
    ok, compared = True, 0
    for want, lg, got in zip(cpu, cpu_logits, card):
        agree, c = _margin_agreement(got[None], want[None], lg[None],
                                     MODEL_REL)
        ok, compared = ok and agree, compared + c
    return {"requests": len(prompts), "tokens_compared": compared,
            "card_equals_cpu": all(np.array_equal(a, b)
                                   for a, b in zip(cpu, card)),
            "prefix_forks": sched.stats.prefix_forks,
            "pool_reclaimed": sched.pool.pages_in_use == 0, "ok": ok
            and sched.pool.pages_in_use == 0}


# the paged and packed phases' traffic: ten requests, more than the eight
# slots; prompt lengths and max_tokens per request
TEN_LENS = [600, 264, 300, 128, 96, 64, 150, 700, 200, 80]
TEN_MAX_TOKENS = [48, 40, 32, 64, 64, 32, 48, 32, 40, 56]
SHARED_PREFIX = 200  # requests 1 and 2 share it (not page-aligned)


def _ten_requests(cfg) -> tuple:
    """The ten prompts (seed 4), ``sampling(i, stop)``, the request
    options of prompt i (requests 1 and 2 share a 200-token prefix, 3
    stops on the tokens ``stop``, 4 is seeded at temperature 0.8), and the
    generator, for further draws."""
    import numpy as np
    from repro_torch.core.sampling import SamplingParams

    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, (SHARED_PREFIX,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in TEN_LENS]
    for i in (1, 2):
        prompts[i][:SHARED_PREFIX] = shared

    def sampling(i, stop):
        kw = dict(max_tokens=TEN_MAX_TOKENS[i])
        if i in (1, 2):
            kw.update(prefix_key="shared", prefix_len=SHARED_PREFIX)
        if i == 3:
            kw.update(stop_token_ids=stop)
        if i == 4:
            kw.update(temperature=0.8, top_p=0.9, seed=7)
        return SamplingParams(**kw)

    return prompts, sampling, rng


def phase_paged(ctx) -> None:
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.scheduler import Scheduler

    tiny = _paged_tiny(ctx)
    _mark(ctx, "tiny")
    device = ctx["device"]
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    params, _ = _llama7b_params(ctx)
    pool_kw = dict(num_pages=513, page_size=16, max_slots=8,
                   max_seq_len=1024, device=device)
    lens, max_tokens = TEN_LENS, TEN_MAX_TOKENS
    prompts, sampling, rng = _ten_requests(cfg)

    def serve(stop, record=False, weights=params):
        srv = LLMServer(cfg, weights, opts, backend="paged", **pool_kw)
        rec = _record_logits(srv.backend.scheduler) if record else None
        pieces = _record_pieces(srv.backend.scheduler)
        rids = [srv.submit(p, sampling(i, stop))
                for i, p in enumerate(prompts)]
        outs = srv.run()
        return [outs[r] for r in rids], srv.backend.scheduler, rec, pieces

    # a first run (it also warms up, and keeps every emitted token's
    # logits) picks a stop token that will fire
    first, first_sched, rec, _ = serve((), record=True)
    chunk = first_sched.prefill_chunk
    # its pool must not count in the timed run's peak: the recording
    # wrappers hold it in a reference cycle, so collect
    del first_sched
    gc.collect()
    stop = int(first[3].tokens[10])
    stop_at = list(first[3].tokens).index(stop) + 1

    _mark(ctx, "first_run")
    # the first run's greedy streams (not the seeded request 4) against the
    # dense (fused) path on the same card, fed the same tokens: logits
    # within PAGED_REL of the largest one, and tokens equal under the margin
    # rule at that tolerance (a sanity check)
    greedy = [i for i in range(len(prompts)) if i != 4]
    agree, compared, rel, rel_first = _against_dense(
        params, cfg, opts, prompts, first, rec,
        {i: PAGED_REL for i in greedy}, device)
    del rec

    _mark(ctx, "against_dense_bf16")
    # the same traffic on f32 weights (the same draws): rows prefilled in
    # one chunk hold the dense path to MODEL_REL; rows whose prefill reads
    # int8 history (later chunks, the fork of request 2) to HISTORY_REL
    params32 = init_params(cfg, torch.Generator(device=device).manual_seed(
        0), torch.float32, device)
    first32, sched32, rec32, _ = serve((), record=True, weights=params32)
    del sched32
    history = {i for i, n in enumerate(lens) if n > chunk} | {2}
    agree32, compared32, rel32, rel32_first = _against_dense(
        params32, cfg, opts, prompts, first32, rec32,
        {i: HISTORY_REL if i in history else MODEL_REL for i in greedy},
        device)
    del params32, first32, rec32
    gc.collect()

    _mark(ctx, "against_dense_f32")
    for fn in (da.decode_attention, pda.paged_decode_attention,
               ppa.paged_prefill_attention):
        fn.launches = 0
    k2_routes = pda.paged_decode_attention.route_launches
    k2_routes.update(dict.fromkeys(k2_routes, 0))
    k3_routes = ppa.paged_prefill_attention.route_launches
    k3_routes.update(dict.fromkeys(k3_routes, 0))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, sched, _, pieces = serve((stop,))
    wall_s = time.perf_counter() - t0
    # the single scheduler's streams, which the disagg phase is held to
    ctx["single"]["chunked"] = {"outs": outs, "pieces": pieces,
                                "stop": stop}
    launches = {"decode_attention": da.decode_attention.launches,
                "paged_decode_attention": pda.paged_decode_attention.launches,
                "paged_prefill_attention":
                    ppa.paged_prefill_attention.launches}
    k2_routes, k3_routes = dict(k2_routes), dict(k3_routes)
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"].update({k: v for k, v in launches.items()
                            if k != "decode_attention"})
    st = sched.stats

    reasons = [o.finish_reason for o in outs]
    lengths = [len(o.tokens) for o in outs]
    want_lengths = list(max_tokens)
    want_lengths[3] = stop_at
    kinds = {shape[0] for shape in sched._shapes}
    checks = {
        "tiny_card_equals_cpu_margin_rule": tiny["ok"],
        "reasons": reasons == ["stop" if i == 3 else "length"
                               for i in range(len(prompts))],
        "lengths": lengths == want_lengths,
        "greedy_equal_fused_margin_rule": agree,
        "f32_greedy_equal_fused": agree32,
        "f32_tokens_compared": compared32 >= F32_MIN_COMPARED,
        "same_as_first_run": all(
            np.array_equal(o.tokens, f.tokens[:len(o.tokens)])
            for o, f in zip(outs, first)),
        "pool_reclaimed": sched.pool.pages_in_use == 0
        and not sched.pool.refcount.any(),
        "prefix_forks": st.prefix_forks >= 1,
        "one_shape_per_tick_kind": st.compiled_shapes == len(kinds),
        "k2_launches": launches["paged_decode_attention"]
        == cfg.num_layers * st.steps,
        "k3_launches": launches["paged_prefill_attention"]
        == cfg.num_layers * st.shared_prefill_calls,
        "k3_on_tensor_cores": k3_routes["tensor_cores"]
        == launches["paged_prefill_attention"],
        "k1_not_launched": launches["decode_attention"] == 0,
        "tokens_in_vocab": all(int(o.tokens.min()) >= 0 and int(
            o.tokens.max()) < cfg.vocab_size for o in outs)}

    _mark(ctx, "main_run")
    # a decode tick with every slot decoding (128-token prompts), host
    # included, and its device-busy time
    tick = Scheduler(cfg, params, opts, **pool_kw)
    for p in rng.integers(0, cfg.vocab_size, (8, 128)):
        tick.submit(p, 200)
    tick.step()  # every prompt in one chunk, first tokens sampled
    tick_ms = ctx["timer"]({"tick": tick._decode_tick}, iters=20,
                           device_only=False)["tick"]
    device_ms, top = _device_profile(torch, tick._decode_tick,
                                     STEP_PROFILE_N)
    # K2 in the tick by each route, in turns (split, single pass, split):
    # the tick's 64-page table takes the split route; the single-pass one is
    # forced by standing in for route() (every row fits one split)
    k2_routes_in_tick = {way: [] for way in pda.ROUTES}
    taken = pda.route
    for way in ("split", "single_pass", "split"):
        pda.route = lambda hd, page, nb, way=way: way
        try:
            k2_routes_in_tick[way].append(_kernel_share(_device_profile(
                torch, tick._decode_tick, STEP_PROFILE_N)[1],
                K2_DEVICE_NAMES)["ms"])
        finally:
            pda.route = taken
    for rid in range(8):
        tick.abort(rid)

    delivered = sum(lengths)
    computed = st.slot_ticks + len(prompts)  # decode rows + first tokens
    _mark(ctx, "tick")
    emit({"phase": "paged", **_times(ctx), "tiny": tiny, "config": cfg.name,
          "pool": {"num_pages": 513, "page_size": 16, "max_slots": 8,
                   "max_seq_len": 1024, "prefill_chunk": sched.prefill_chunk,
                   "page_bytes": sched.pool.page_bytes()},
          "prompt_lens": lens, "finish_reasons": reasons,
          "generated": lengths, "stop_token": stop, "ticks": sched._tick,
          "decode_steps": st.steps, "prefill_calls": st.prefills,
          "shared_prefill_calls": st.shared_prefill_calls,
          "prefix_forks": st.prefix_forks,
          "compiled_shapes": st.compiled_shapes, "tick_kinds": sorted(kinds),
          "peak_occupancy": st.peak_occupancy,
          "peak_shared_pages": st.peak_shared_pages, "launches": launches,
          "k2_routes": k2_routes, "k3_routes": k3_routes,
          "wall_s": wall_s, "tokens_per_s": delivered / wall_s,
          "computed_tokens_per_s": computed / wall_s,
          "ttft_ticks": [st.ttft_ticks[o.rid] for o in outs],
          "tokens_compared": compared, "tol": PAGED_REL,
          "max_rel_logit_err_vs_fused": rel,
          "first_token_rel_err_vs_fused": rel_first,
          "f32": {"history_rows": sorted(history),
                  "tol": {"one_chunk": MODEL_REL, "history": HISTORY_REL},
                  "tokens_compared": compared32,
                  "max_rel_logit_err_vs_fused": rel32,
                  "first_token_rel_err_vs_fused": rel32_first},
          "decode_tick_ms": tick_ms, "decode_tick_batch": 8,
          "profile_device_ms_per_tick": device_ms,
          "k2_in_tick": _kernel_share(top, K2_DEVICE_NAMES),
          "k2_in_tick_ms_by_route": k2_routes_in_tick,
          "profile_top": top[:8], "max_memory_allocated": peak,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"paged: failed checks {checks}")


def _packed_tiny(ctx) -> dict:
    """llama2-7b tiny through the packed Scheduler with lazy growth on a
    pool small enough to preempt (swap resume), on the CPU (plain
    versions) and on the card (kernel K4): the card's tokens must agree
    with the CPU's under the margin rule of the CPU's logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.scheduler import Scheduler

    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, (10,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in (18, 9, 4)]
    prompts += [np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                     (n,))]) for n in (5, 3)]
    max_new = [6, 5, 8, 4, 6]

    def serve(device, record):
        # 9 usable pages of 4 tokens for 2 slots: growth must preempt
        sched = Scheduler(cfg, params, opts, num_pages=10, page_size=4,
                          max_slots=2, prefill_chunk=4, tick_mode="packed",
                          lazy_growth=True, device=device)
        rec = _record_logits(sched) if record else None
        rids = [sched.submit(p, n, prefix_key="sys" if i >= 3 else None,
                             prefix_len=10 if i >= 3 else None,
                             priority=i % 2)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        res = sched.run()
        return ([res[r][len(p):] for r, p in zip(rids, prompts)],
                [rec and np.stack(rec[r]) for r in rids], sched)

    cpu, cpu_logits, cpu_sched = serve("cpu", True)
    card, _, sched = serve(ctx["device"], False)
    ok, compared = True, 0
    for want, lg, got in zip(cpu, cpu_logits, card):
        agree, c = _margin_agreement(got[None], want[None], lg[None],
                                     MODEL_REL)
        ok, compared = ok and agree, compared + c
    preempt = [cpu_sched.stats.preemptions, sched.stats.preemptions]
    reclaimed = sched.pool.pages_in_use == 0 and sched.pool.swap_bytes == 0
    return {"requests": len(prompts), "tokens_compared": compared,
            "card_equals_cpu": all(np.array_equal(a, b)
                                   for a, b in zip(cpu, card)),
            "preemptions_cpu_card": preempt,
            "compiled_shapes": sched.stats.compiled_shapes,
            "pool_reclaimed": reclaimed,
            "ok": ok and min(preempt) >= 1 and reclaimed
            and sched.stats.compiled_shapes == 1}


def _record_pieces(sched) -> dict:
    """Wrap ``sched``'s pool so that every prefill piece it commits is kept
    per request: {rid: [(first token, end token), ...]} in order."""
    pieces, orig = {}, sched.pool.commit_prefill

    def commit(slot, n_tokens):
        lo = int(sched.pool.lengths[slot])
        pieces.setdefault(sched.slots[slot].req.rid, []).append(
            (lo, int(n_tokens)))
        orig(slot, n_tokens)

    sched.pool.commit_prefill = commit
    return pieces


def _hold_streams(ref, run, greedy, tol) -> dict:
    """The greedy streams of ``run`` against those of ``ref``, each a tuple
    (outputs, logits by rid or None, prefill pieces by rid): per row
    bit-identity (tokens and length) and the first position that differs,
    and agreement under the margin rule of ``run``'s own logits at
    ``tol``. A packed row's result depends on its own inputs only, so a row
    whose prefill was cut into the same pieces in both runs (the fork's
    creator's too) must be bit-identical: ``same_pieces_identical``."""
    import numpy as np

    (ref_outs, _, ref_pieces), (outs, rec, pieces) = ref, run
    agree, compared, same, first_diff, same_pieces = True, 0, {}, {}, {}
    for i in greedy:
        a, b = ref_outs[i].tokens, outs[i].tokens
        n = min(len(a), len(b))
        same[i] = bool(np.array_equal(a, b))
        diff = np.nonzero(a[:n] != b[:n])[0]
        first_diff[i] = int(diff[0]) if diff.size else None
        ok, c = _margin_agreement(b[None, :n], a[None, :n],
                                  np.stack(rec[outs[i].rid])[None, :n], tol)
        agree, compared = agree and ok, compared + c
        rows = (1, 2) if i == 2 else (i,)  # the fork reads its creator's
        same_pieces[i] = all(ref_pieces[ref_outs[j].rid]
                             == pieces[outs[j].rid] for j in rows)
    return {"agree": agree, "tokens_compared": compared,
            "bit_identical": same, "first_difference": first_diff,
            "same_pieces": same_pieces,
            "same_pieces_identical": all(same[i] for i in greedy
                                         if same_pieces[i])}


def phase_packed(ctx) -> None:
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.kv_pool import uniform_page_count
    from repro_torch.serving.scheduler import Scheduler

    tiny = _packed_tiny(ctx)
    _mark(ctx, "tiny")
    device = ctx["device"]
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    params, _ = _llama7b_params(ctx)
    page, slots = 16, 8
    sched_kw = dict(page_size=page, max_slots=slots, max_seq_len=1024,
                    prefill_chunk=256, tick_mode="packed", device=device)
    lens, max_tokens = TEN_LENS, TEN_MAX_TOKENS
    prompts, sampling, rng = _ten_requests(cfg)
    greedy = [i for i in range(len(prompts)) if i != 4]

    def serve(stop, num_pages=513, record=False, weights=params, **kw):
        srv = LLMServer(cfg, weights, opts, backend="paged",
                        num_pages=num_pages, **sched_kw, **kw)
        sched = srv.backend.scheduler
        rec = _record_logits(sched) if record else None
        pieces = _record_pieces(sched)
        rids = [srv.submit(p, sampling(i, stop))
                for i, p in enumerate(prompts)]
        outs = srv.run()
        return [outs[r] for r in rids], sched, rec, pieces

    # a first run (it also warms up) picks a stop token that will fire
    first, first_sched, _, _ = serve(())
    budget = first_sched.token_budget
    del first_sched
    gc.collect()
    stop = int(first[3].tokens[10])
    stop_at = list(first[3].tokens).index(stop) + 1

    _mark(ctx, "first_run")
    # the same traffic on f32 weights against the dense path fed the same
    # tokens: rows prefilled in one piece to MODEL_REL, rows whose prefill
    # reads int8 history (a later piece, or the fork of request 2) to
    # HISTORY_REL, as in the paged phase
    params32 = init_params(cfg, torch.Generator(device=device).manual_seed(
        0), torch.float32, device)
    k4_routes = va.varlen_attention.route_launches
    k4_routes.update(dict.fromkeys(k4_routes, 0))
    first32, sched32, rec32, pieces32 = serve((), record=True,
                                              weights=params32)
    k4_routes_f32 = dict(k4_routes)
    rid_row = {o.rid: i for i, o in enumerate(first32)}
    history = {rid_row[r] for r, p in pieces32.items() if len(p) > 1} | {2}
    del sched32
    agree32, compared32, rel32, rel32_first = _against_dense(
        params32, cfg, opts, prompts, first32, rec32,
        {i: HISTORY_REL if i in history else MODEL_REL for i in greedy},
        device)
    del params32, first32, rec32
    gc.collect()

    _mark(ctx, "against_dense_f32")
    # reserve admission, 513 pages: the main path's run
    kernels = {"decode_attention": da.decode_attention,
               "paged_decode_attention": pda.paged_decode_attention,
               "paged_prefill_attention": ppa.paged_prefill_attention,
               "varlen_attention": va.varlen_attention}
    for fn in kernels.values():
        fn.launches = 0
    k4_routes.update(dict.fromkeys(k4_routes, 0))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, sched, _, pieces = serve((stop,))
    wall_s = time.perf_counter() - t0
    ctx["single"]["packed"] = {"outs": outs, "pieces": pieces, "stop": stop}
    launches = {name: fn.launches for name, fn in kernels.items()}
    k4_routes_bf16 = dict(k4_routes)
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"]["varlen_attention"] = launches["varlen_attention"]
    st = sched.stats

    reasons = [o.finish_reason for o in outs]
    lengths = [len(o.tokens) for o in outs]
    want_lengths = list(max_tokens)
    want_lengths[3] = stop_at
    # every prompt token is prefilled once (the fork's shared prefix not at
    # all), and every generated token but each request's first (it rides
    # its last prefill row) and its last (never fed back) is a decode row
    want_tokens = (sum(lens) - SHARED_PREFIX * st.prefix_forks
                   + sum(lengths) - len(prompts))
    checks = {
        "tiny_card_equals_cpu_margin_rule": tiny["ok"],
        "reasons": reasons == ["stop" if i == 3 else "length"
                               for i in range(len(prompts))],
        "lengths": lengths == want_lengths,
        "pool_reclaimed": sched.pool.pages_in_use == 0
        and not sched.pool.refcount.any(),
        "compiled_shapes_1": st.compiled_shapes == 1,
        "packed_tokens_exact": st.packed_tokens == want_tokens
        and st.packed_tokens + st.packed_pad_tokens
        == st.packed_ticks * budget,
        "k4_launches": launches["varlen_attention"]
        == cfg.num_layers * st.packed_ticks,
        # bf16 weights: every K4 launch on the tensor cores; f32 weights
        # (the dense comparison): every one on the CUDA cores
        "k4_bf16_on_tensor_cores": k4_routes_bf16 == {
            "tensor_cores": launches["varlen_attention"], "cuda_cores": 0},
        "k4_f32_on_cuda_cores": k4_routes_f32["tensor_cores"] == 0
        and k4_routes_f32["cuda_cores"] > 0,
        "k1_k2_k3_not_launched": launches["decode_attention"]
        == launches["paged_decode_attention"]
        == launches["paged_prefill_attention"] == 0,
        "f32_greedy_equal_dense": agree32,
        "f32_tokens_compared": compared32 >= F32_MIN_COMPARED,
        "prefix_forks": st.prefix_forks >= 1,
        "tokens_in_vocab": all(int(o.tokens.min()) >= 0 and int(
            o.tokens.max()) < cfg.vocab_size for o in outs)}
    reserve = {"num_pages": 513, "ticks": sched._tick,
               "packed_ticks": st.packed_ticks,
               "packed_tokens": st.packed_tokens,
               "packed_pad_tokens": st.packed_pad_tokens,
               "prefill_tokens": st.prefill_tokens,
               "decode_rows": st.slot_ticks, "prefix_forks": st.prefix_forks,
               "compiled_shapes": st.compiled_shapes,
               "finish_reasons": reasons, "generated": lengths,
               "launches": launches, "k4_routes": k4_routes_bf16,
               "k4_routes_f32": k4_routes_f32, "wall_s": wall_s,
               "tokens_per_s": sum(lengths) / wall_s,
               "ttft_ticks": [st.ttft_ticks[o.rid] for o in outs],
               "peak_occupancy": st.peak_occupancy,
               "max_memory_allocated": peak}
    del sched
    gc.collect()

    _mark(ctx, "reserve_run")
    # lazy growth on a pool between the first eight requests' admission
    # pages (prompt + 1 token) and their worst case, the fork's shared
    # full pages counted once: decode growth must preempt
    shared = SHARED_PREFIX // page
    lazy_pages = sum(uniform_page_count(n + 1, page)
                     for n in lens[:slots]) - shared
    worst_pages = sum(uniform_page_count(n + m, page) for n, m in
                      zip(lens[:slots], max_tokens[:slots])) - shared
    lazy_pool = 1 + lazy_pages + (worst_pages - lazy_pages) // 2
    lazy = {"num_pages": lazy_pool, "admission_pages": lazy_pages,
            "worst_case_pages": worst_pages}
    for resume in ("swap", "refill"):
        t0 = time.perf_counter()
        outs_l, sched_l, rec_l, pieces_l = serve(
            (stop,), num_pages=lazy_pool, record=True, lazy_growth=True,
            resume=resume)
        run_s = time.perf_counter() - t0
        sl = sched_l.stats
        held = _hold_streams((outs, None, pieces), (outs_l, rec_l, pieces_l),
                             greedy, PAGED_REL)
        lazy[resume] = {
            "preemptions": sl.preemptions, "peak_swap_bytes":
            sl.peak_swap_bytes, "swap_transfers": sched_l._swap.transfers,
            "swap_bytes_moved": sched_l._swap.bytes_moved,
            "swap_seconds": sched_l._swap.seconds, "ticks": sched_l._tick,
            "compiled_shapes": sl.compiled_shapes, "wall_s": run_s,
            "finish_reasons": [o.finish_reason for o in outs_l],
            "generated": [len(o.tokens) for o in outs_l], **held}
        checks[f"{resume}_preempted"] = sl.preemptions >= 1
        checks[f"{resume}_pool_reclaimed"] = (
            sched_l.pool.pages_in_use == 0
            and not sched_l.pool.refcount.any()
            and sched_l.pool.swap_bytes == 0)
        checks[f"{resume}_streams_held_to_reserve"] = held["agree"]
        checks[f"{resume}_same_pieces_bit_identical"] = \
            held["same_pieces_identical"]
        del sched_l, rec_l
        gc.collect()

    _mark(ctx, "lazy_growth")
    # one tick with seven slots decoding (128-token prompts) and the eighth
    # in flight with a 256-token continuation chunk over 256 tokens of
    # history, host included, packed (one K4 call per layer) beside chunked
    # (a K3 chunk call and a K2 decode call per layer): before each tick
    # the long prompt is set back to 256 written tokens, so every tick
    # carries the same work
    def armed(tick_mode):
        sch = Scheduler(cfg, params, opts, num_pages=513,
                        **dict(sched_kw, tick_mode=tick_mode))
        for p in rng.integers(0, cfg.vocab_size, (slots - 1, 128)):
            sch.submit(p, 200)
        sch.submit(rng.integers(0, cfg.vocab_size, (1000,)), 8)
        while any(s is None or (s.prefilling and s.req.rid < slots - 1)
                  for s in sch.slots):
            sch.step()
        long = next(i for i, s in enumerate(sch.slots) if s.prefilling)
        st_long = sch.slots[long]

        def tick():
            st_long.prefilled = 256
            sch.pool.lengths[long] = 256
            if tick_mode == "packed":
                sch._packed_tick()
            else:
                sch._prefill_chunk_tick()
                sch._decode_tick()
        return sch, tick

    sch_p, tick_p = armed("packed")
    sch_c, tick_c = armed("chunked")
    ms = ctx["timer"]({"packed": tick_p, "chunked": tick_c}, iters=20,
                      device_only=False)
    dev_p, top_p = _device_profile(torch, tick_p, STEP_PROFILE_N)
    dev_c, top_c = _device_profile(torch, tick_c, STEP_PROFILE_N)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        tick_p()
    torch.cuda.synchronize()
    tick_peak = torch.cuda.max_memory_allocated()
    tick = {"packed_ms": ms["packed"], "chunked_ms": ms["chunked"],
            "packed_device_ms": dev_p, "chunked_device_ms": dev_c,
            "packed_idle_share": 1 - dev_p / ms["packed"],
            "chunked_idle_share": 1 - dev_c / ms["chunked"],
            "packed_k4_ms": sum(r["ms"] for r in top_p
                                if "varlen" in r["kernel"]),
            "chunked_k3_ms": sum(r["ms"] for r in top_c
                                 if "prefill" in r["kernel"]),
            "packed_top": top_p[:8], "chunked_top": top_c[:8],
            "packed_live_rows": slots - 1 + 256, "token_budget": budget,
            "packed_peak_memory_allocated": tick_peak}
    del sch_p, sch_c, tick_p, tick_c
    gc.collect()

    _mark(ctx, "ticks")
    emit({"phase": "packed", **_times(ctx), "tiny": tiny, "config": cfg.name,
          "pool": {"page_size": page, "max_slots": slots,
                   "max_seq_len": 1024, "prefill_chunk": 256,
                   "token_budget": budget},
          "prompt_lens": lens, "stop_token": stop, "reserve": reserve,
          "f32": {"history_rows": sorted(history),
                  "tol": {"one_piece": MODEL_REL, "history": HISTORY_REL},
                  "tokens_compared": compared32,
                  "max_rel_logit_err_vs_dense": rel32,
                  "first_token_rel_err_vs_dense": rel32_first},
          "lazy": lazy, "lazy_tol": PAGED_REL, "tick": tick,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"packed: failed checks {checks}")


# the split phase's traffic: four requests through LLMServer(backend=
# "split"), ℓ = 8 of llama2-7b's 32 layers on the edge as int4 codes
SPLIT_LAYER = 8  # ℓ
SPLIT_LENS = (128, 128, 96, 96)
SPLIT_MAX_TOKENS = 32
SPLIT_SHARED_PREFIX = 64  # four whole 16-token pages
SPLIT_WIDE_BITS = 12  # the int16-code front, held to the 16-bit one
SPLIT_WIDE_NEW = 16  # its new tokens on the shared-prefix run's 4 rows


def _record_cloud_logits(eng) -> list:
    """Wrap ``eng._cloud_back`` so that the logits (B, V) of every cloud
    call are kept on the host in call order: the logits each emitted token
    was drawn from (checks only, not timings)."""
    rec, orig = [], eng._cloud_back

    def back(*args, **kw):
        logits = orig(*args, **kw)
        rec.append(logits.float().cpu().numpy())
        return logits

    eng._cloud_back = back
    return rec


def _logits_agree(got, want, got_lg, want_lg, tol) -> dict:
    """Greedy ``got`` tokens (B, n) against ``want`` under the margin rule
    of ``want_lg`` at ``tol``, and the largest logit error relative to the
    largest logit over the steps whose token history is still the same."""
    import numpy as np

    ok, compared = _margin_agreement(got, want, want_lg, tol)
    same = np.cumprod(got == want, axis=1)  # history equal up to step t
    rel = 0.0
    for r in range(got.shape[0]):
        upto = 1 + int(same[r].sum()) if same[r].sum() < got.shape[1] \
            else got.shape[1]
        err = np.abs(got_lg[r, :upto] - want_lg[r, :upto]).max()
        rel = max(rel, float(err / np.abs(want_lg).max()))
    return {"ok": ok and rel <= tol, "tokens_compared": compared,
            "max_rel_logit_err": rel, "tol": tol,
            "tokens_equal_all": bool(np.array_equal(got, want))}


def _split_tiny(ctx) -> dict:
    """llama2-7b tiny (f32) through the split engine, int4-code front,
    TS + TAB-Q payloads, int8 KV, on the CPU (plain versions) and on the
    card (K1, K5, K6, K7): the card's tokens agree with the CPU's under the
    margin rule of the CPU's logits, and the logits agree."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.split_engine import SplitEngine

    cfg = get_config("llama2-7b-tiny")
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 12))
    # τ = 0.5: the tiny model's hidden states exceed it, so TS's carrier
    # is used (and overflows)
    opsc = OPSCConfig(split_layer=1, qw_front=4, tau=0.5)
    n, runs = 16, []
    for dev in ("cpu", ctx["device"]):
        eng = SplitEngine(cfg, params, opsc, opts=opts, cache_len=64,
                          device=dev)
        rec = _record_cloud_logits(eng)
        toks, st = eng.generate(prompts, n)
        runs.append((toks[:, 12:], np.stack(rec, 1), st))
    (want, want_lg, wst), (got, got_lg, gst) = runs
    return {"steps": n, **_logits_agree(got, want, got_lg, want_lg,
                                        SPLIT_TINY_REL),
            "uplink_bits_card_cpu": [gst.uplink_bits_measured,
                                     wst.uplink_bits_measured]}


# tiny split on the card against the CPU, f32 weights: the front's f32 sums
# run in another order, so a TAB-Q code on a rounding boundary can land one
# step apart, which moves the logits more than MODEL_REL allows
SPLIT_TINY_REL = 2e-2


def _payloads_identical(held, opsc) -> dict:
    """The payloads of hidden states ``held`` (recorded from the main
    run): TS + TAB-Q through K5 and K6 on the card against their plain
    versions on the CPU, every field and the measured bits."""
    import torch
    from repro_torch.core.payload import decode, encode

    fields = ("codes", "sign", "scale", "zero", "bits")
    same, tokens = True, 0
    for h in held:
        x = h.reshape(-1, h.shape[-1]).float()
        kw = dict(tau=opsc.tau, delta=opsc.delta, max_bits=opsc.max_act_bits)
        got, want = encode(x, **kw), encode(x.cpu(), **kw)
        same = same and all(torch.equal(getattr(got.below, f).cpu(),
                                        getattr(want.below, f))
                            for f in fields) \
            and torch.equal(got.above.indices.cpu(), want.above.indices) \
            and torch.equal(got.above.values.cpu(), want.above.values) \
            and got.payload_bits() == want.payload_bits() \
            and torch.equal(decode(got).cpu(), decode(want))
        tokens += x.shape[0]
    return {"payloads": len(held), "tokens": tokens, "identical": same}


def _split_stages(ctx, eng, opts, prompt, cache_len,
                  profile_n=STEP_PROFILE_N) -> dict:
    """One split decode step at B = 1 after ``prompt`` (1, S), by stage:
    edge (the front layers: K7 and K1), payload (TS + TAB-Q and the
    reconstruction, with the host sync that reads its bits), cloud (the
    back layers and the head) and the whole step; host-included times
    (CUDA events, in turns), device-busy times and profiles
    (``torch.profiler``, ``profile_n`` calls a stage), the decode payload's
    bits, and the edge's prefill of the prompt (it rewrites the same cache
    entries): its device time and profile."""
    import torch
    from repro_torch.models.transformer import init_caches

    cfg, device = eng.cfg, ctx["device"]
    with torch.inference_mode():
        nfront = eng.split_block
        edge_c = init_caches(cfg, 1, cache_len, opts, device, nfront)
        cloud_c = init_caches(cfg, 1, cache_len, opts, device,
                              cfg.num_blocks - nfront)
        toks = torch.as_tensor(prompt, device=device)
        h, _ = eng._compress(eng._edge_front(toks, edge_c, 0, decode=False))
        nxt = eng._cloud_back(h, cloud_c, 0, decode=False).argmax(-1)[:, None]
        pos = torch.tensor(toks.shape[1], dtype=torch.int32, device=device)
        h_edge = eng._edge_front(nxt, edge_c, pos, decode=True)
        h_rec, bits = eng._compress(h_edge)
        stages = {
            "edge": lambda: eng._edge_front(nxt, edge_c, pos, decode=True),
            "payload": lambda: eng._compress(h_edge),
            "cloud": lambda: eng._cloud_back(h_rec, cloud_c, pos,
                                             decode=True),
            "step": lambda: eng._cloud_back(eng._compress(eng._edge_front(
                nxt, edge_c, pos, decode=True))[0], cloud_c, pos,
                decode=True)}
        stage_ms = ctx["timer"](stages, iters=20, device_only=False)
        device_ms, profiles = {}, {}
        for k, fn in stages.items():
            device_ms[k], profiles[k] = _device_profile(torch, fn,
                                                        profile_n)
        _, top = _device_profile(torch, stages["step"], profile_n)
        prefill = _device_profile(
            torch, lambda: eng._edge_front(toks, edge_c, 0, decode=False), 3)
    return {"host_included_ms": stage_ms, "device_busy_ms": device_ms,
            "profiles": profiles, "top": top, "bits": bits,
            "edge_prefill": prefill}


def _split_wide_front(ctx, cfg, params, opts, base, blen, kernels) -> dict:
    """OPSC's front at ``SPLIT_WIDE_BITS`` (int16 codes through K7: the GEMV
    at decode, the CUDA cores on the prefill) on the rows ``base`` (B,
    blen), uncompressed, with every launch counter set to 0 just before the
    run and read just after; its tokens (margin rule) and cloud logits held
    to the 16-bit front's within PAGED_REL; its edge bytes beside Eq. 1's
    count; one decode step at B 1 by stage. Returns the report with its
    ``checks``."""
    import numpy as np
    import torch
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.serving.split_engine import SplitEngine

    common = dict(opts=opts, cache_len=1024, device=ctx["device"])
    opsc = OPSCConfig(split_layer=SPLIT_LAYER, qw_front=SPLIT_WIDE_BITS)
    eng = SplitEngine(cfg, params, opsc, **common)
    rec = _record_cloud_logits(eng)
    for fn in kernels.values():
        fn.launches = 0
    routes, widths = (dm.dequant_matmul.route_launches,
                      dm.dequant_matmul.code_launches)
    routes.update(dict.fromkeys(routes, 0))
    widths.update(dict.fromkeys(widths, 0))
    toks, _ = eng.generate(base, SPLIT_WIDE_NEW, compress=False)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    routes, widths = dict(routes), dict(widths)
    got_lg = np.stack(rec, 1)
    if "dequant_matmul" in ctx["kernels"]:
        ctx["kernels"]["dequant_matmul"]["int16"]["launches"] = \
            widths["int16"]
    full = SplitEngine(cfg, params, OPSCConfig(split_layer=SPLIT_LAYER,
                                               qw_front=16), **common)
    rec16 = _record_cloud_logits(full)
    toks16, _ = full.generate(base, SPLIT_WIDE_NEW, compress=False)
    del full
    held = _logits_agree(toks[:, blen:], toks16[:, blen:], got_lg,
                         np.stack(rec16, 1), PAGED_REL)

    products = 7 * SPLIT_LAYER  # the edge's projections: 7 a layer
    edge = {k: v for k, v in eng.edge_params.items()
            if isinstance(v, QuantizedTensor)}
    front = sum(params[k][:eng.split_block].numel() for k in params
                if k.startswith("blocks/"))
    edge_bytes = eng.edge_weight_bytes()
    by_stage = _split_stages(ctx, eng, opts, base[:1], 1024)
    del eng
    checks = {
        "wide_edge_holds_int16_codes": len(edge) == 7 and all(
            q.codes.dtype == torch.int16 for q in edge.values()),
        "wide_k7_int16_launches": widths == {
            "int8": 0, "int16": products * SPLIT_WIDE_NEW},
        "wide_k7_routes": routes == {
            "gemv": products * (SPLIT_WIDE_NEW - 1), "cuda_cores": products,
            "tensor_cores": 0, "tensor_cores_large_m": 0},
        "wide_k1_launches": launches["decode_attention"]
        == cfg.num_layers * (SPLIT_WIDE_NEW - 1),
        "wide_agrees_with_16_bit_front": held["ok"]}
    stage_ms, device_ms = by_stage["host_included_ms"], \
        by_stage["device_busy_ms"]
    return {"qw_front": SPLIT_WIDE_BITS, "rows": int(base.shape[0]),
            "prompt_len": blen, "new_tokens": SPLIT_WIDE_NEW,
            "launches": launches, "k7_routes": routes, "k7_codes": widths,
            "against_16_bit_front": held,
            "edge_weight_bytes": edge_bytes,
            "edge_weight_bytes_eq1": front * SPLIT_WIDE_BITS // 8,
            "decode_step_b1": {
                "host_included_ms": stage_ms, "device_busy_ms": device_ms,
                "idle_share": {k: 1 - device_ms[k] / stage_ms[k]
                               for k in stage_ms},
                "gemv_in_step": _kernel_share(by_stage["top"],
                                              GEMV_DEVICE_NAMES),
                "gemv_in_edge": _kernel_share(by_stage["profiles"]["edge"],
                                              GEMV_DEVICE_NAMES),
                "profile_top": by_stage["top"][:8]},
            "edge_prefill_96": {
                "device_busy_ms": by_stage["edge_prefill"][0],
                "k7_ms": sum(r["ms"] for r in by_stage["edge_prefill"][1]
                             if any(k in r["kernel"]
                                    for k in K7_DEVICE_NAMES))},
            "checks": checks}


def phase_split(ctx) -> None:
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.core.sampling import SamplingParams, truncate_at_stop
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import tabq_quantize as tq
    from repro_torch.kernels import ts_mask as tsm
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.split_engine import SplitEngine

    tiny = _split_tiny(ctx)
    _mark(ctx, "tiny")
    device = ctx["device"]
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    params, _ = _llama7b_params(ctx)
    # the paper's OPSC defaults: int4 front, τ 5, Δ 0.2, 8-bit TAB-Q
    opsc = OPSCConfig(split_layer=SPLIT_LAYER, qw_front=4)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in SPLIT_LENS]
    n_new = SPLIT_MAX_TOKENS

    def requests(stop):
        return [SamplingParams(max_tokens=n_new),
                SamplingParams(max_tokens=n_new, stop_token_ids=stop),
                SamplingParams(max_tokens=n_new, temperature=0.8, top_p=0.9,
                               seed=7),
                SamplingParams(max_tokens=n_new)]

    def serve(srv, sps):
        rids = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = srv.run()
        return [outs[r] for r in rids]

    srv = LLMServer(cfg, params, opts, backend="split", opsc=opsc,
                    cache_len=1024, device=device)
    eng = srv.backend.engine
    # a first run (it also warms up) picks a stop token that will fire and
    # keeps the first request's hidden states at the split
    held = []

    def compress(h):
        if len(held) < 6:  # the prefill and five decode payloads
            held.append(h.detach().clone())
        return SplitEngine._compress(eng, h)

    eng._compress = compress
    first = serve(srv, requests(()))
    del eng._compress
    payloads = _payloads_identical(held, opsc)
    del held
    stop = int(first[1].tokens[10])
    stop_at = list(first[1].tokens).index(stop) + 1

    _mark(ctx, "first_run")
    kernels = {"decode_attention": da.decode_attention,
               "tabq_quantize": tq.tabq_quantize,
               "tabq_adaptive": tq.tabq_adaptive, "ts_encode": tsm.ts_encode,
               "dequant_matmul": dm.dequant_matmul}
    for fn in kernels.values():
        fn.launches = 0
    k7_routes = dm.dequant_matmul.route_launches
    k7_routes.update(dict.fromkeys(k7_routes, 0))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = serve(srv, requests((stop,)))
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    k7_routes = dict(k7_routes)
    peak = torch.cuda.max_memory_allocated()
    ctx["launches"].update({k: v for k, v in launches.items()
                            if k != "decode_attention"})

    payloads_n = len(prompts) * n_new  # one prefill + n_new - 1 decodes
    decodes = len(prompts) * (n_new - 1)
    reasons = [o.finish_reason for o in outs]
    lengths = [len(o.tokens) for o in outs]
    stats = [o.split_stats for o in outs]
    checks = {
        "tiny_card_equals_cpu_margin_rule": tiny["ok"],
        "payloads_identical_to_plain": payloads["identical"],
        "reasons": reasons == ["length", "stop", "length", "length"],
        "lengths": lengths == [n_new, stop_at, n_new, n_new],
        "same_as_first_run": all(
            np.array_equal(o.tokens, f.tokens[:len(o.tokens)])
            for o, f in zip(outs, first)),
        "tokens_in_vocab": all(int(o.tokens.min()) >= 0 and int(
            o.tokens.max()) < cfg.vocab_size for o in outs),
        # TAB-Q's walk: one launch a payload, no per-level launch
        "k5_launches": launches["tabq_adaptive"] == payloads_n
        and launches["tabq_quantize"] == 0,
        # threshold splitting's encode: one launch a payload
        "k6_launches": launches["ts_encode"] == payloads_n,
        "k7_launches": launches["dequant_matmul"]
        == 7 * opsc.split_layer * payloads_n,
        # each prompt's edge prefill on the tensor cores (the route its
        # length takes: from LARGE_M_MIN tokens the large-M kernel), decode
        # on the GEMV
        "k7_prefill_on_tensor_cores": k7_routes == {
            "gemv": 7 * opsc.split_layer * decodes,
            **{way: 7 * opsc.split_layer * sum(
                ("tensor_cores_large_m" if len(p) >= dm.LARGE_M_MIN
                 else "tensor_cores") == way for p in prompts)
               for way in ("tensor_cores_large_m", "tensor_cores")},
            "cuda_cores": 0},
        "k1_launches": launches["decode_attention"]
        == cfg.num_layers * decodes,
        "no_early_exit": all(s.early_exits == 0 for s in stats)}

    _mark(ctx, "main_run")
    # with a full-precision front and no compression, each stream is the
    # Engine's on that prompt alone, bit for bit (logprobs too)
    srv16 = LLMServer(cfg, params, opts, backend="split",
                      opsc=OPSCConfig(split_layer=SPLIT_LAYER,
                                      qw_front=16),
                      compress=False, cache_len=1024, device=device)
    outs16 = serve(srv16, requests((stop,)))
    eng16 = srv16.backend.engine
    engine = Engine(cfg, params, opts, cache_len=1024, device=device)
    equal16 = []
    for p, sp, o in zip(prompts, requests((stop,)), outs16):
        want = engine.generate_requests(p[None], [sp])
        toks, _, lps = eng16.generate(p[None], n_new, compress=False,
                                      sampling=sp, with_logprobs=True)
        gen, _ = truncate_at_stop(want.tokens[0, len(p):], sp)
        equal16.append(bool(np.array_equal(toks, want.tokens)
                            and np.array_equal(lps, want.logprobs)
                            and gen == o.tokens.tolist()))
    checks["uncompressed_fp_front_equals_engine"] = all(equal16)
    del srv16, eng16, engine, outs16
    gc.collect()

    _mark(ctx, "uncompressed_fp_front")
    # four edge devices with a 64-token shared prefix: the paged cloud (K3
    # reads the prefix on rows 1+, K2 decodes) held to the dense cloud.
    # Uncompressed: with TS + TAB-Q the shared run would encode row 0 alone
    # and rows 1+ without their prefix, so TS's carrier capacity (1/1024 of
    # a payload) and the payloads would differ from the dense run's
    blen = 96
    base = rng.integers(0, cfg.vocab_size, (4, blen))
    base[:, :SPLIT_SHARED_PREFIX] = base[0, :SPLIT_SHARED_PREFIX]
    common = dict(opts=opts, cache_len=1024, device=device)
    dense = SplitEngine(cfg, params, opsc, **common)
    rec = _record_cloud_logits(dense)
    t_dense, st_dense = dense.generate(base, 16, compress=False)
    dense_lg = np.stack(rec, 1)
    del dense
    paged = SplitEngine(cfg, params, opsc, paged_cloud_kv=True,
                        cloud_pool_pages=48, cloud_page_size=16, **common)
    rec = _record_cloud_logits(paged)
    k2, k3 = (pda.paged_decode_attention.launches,
              ppa.paged_prefill_attention.launches)
    t_paged, st_paged = paged.generate(
        base, 16, compress=False, shared_prefix_len=SPLIT_SHARED_PREFIX)
    k2 = pda.paged_decode_attention.launches - k2
    k3 = ppa.paged_prefill_attention.launches - k3
    paged_cmp = _logits_agree(t_paged[:, blen:], t_dense[:, blen:],
                              np.stack(rec, 1), dense_lg, PAGED_REL)
    del paged
    gc.collect()
    back_layers = cfg.num_layers - opsc.split_layer
    checks["paged_shared_prefix_agrees_with_dense"] = paged_cmp["ok"]
    checks["shared_prefix_pages"] = st_paged.shared_prefix_pages \
        == SPLIT_SHARED_PREFIX // 16
    checks["paged_k2_k3_launches"] = (k2, k3) == (back_layers * 15,
                                                  back_layers)
    checks["shared_prefix_ships_less"] = \
        st_paged.uplink_bits_measured < st_dense.uplink_bits_measured

    _mark(ctx, "paged_cloud")
    # I_kv = 0, short: the stateless cloud re-runs its 24 layers over the
    # whole received history every step; held to the I_kv = 1 engine
    ikv0 = SplitEngine(cfg, params, OPSCConfig(
        split_layer=SPLIT_LAYER, qw_front=4, i_kv=0), **common)
    rec0 = _record_cloud_logits(ikv0)
    p0 = prompts[3][None]
    t_ikv0, st_ikv0 = ikv0.generate(p0, 6)
    del ikv0
    rec1 = _record_cloud_logits(eng)
    t_ikv1, st_ikv1 = eng.generate(p0, 6)
    del eng._cloud_back
    plen = p0.shape[1]
    ikv0_cmp = _logits_agree(t_ikv0[:, plen:], t_ikv1[:, plen:],
                             np.stack(rec0, 1), np.stack(rec1, 1), PAGED_REL)
    checks["ikv0_agrees_with_ikv1"] = ikv0_cmp["ok"]
    checks["ikv0_eq3_smaller"] = st_ikv0.uplink_bits_eq3 \
        < st_ikv1.uplink_bits_eq3
    gc.collect()

    _mark(ctx, "ikv0")
    wide = _split_wide_front(ctx, cfg, params, opts, base, blen, kernels)
    checks.update(wide.pop("checks"))
    gc.collect()

    _mark(ctx, "wide_front")
    # one decode step at B = 1 after a 128-token prompt, by stage
    nfront = eng.split_block
    by_stage = _split_stages(ctx, eng, opts, prompts[0][None], 1024)
    stage_ms, device_ms = by_stage["host_included_ms"], \
        by_stage["device_busy_ms"]
    profiles, top = by_stage["profiles"], by_stage["top"]
    bits = by_stage["bits"]
    prefill_ms, prefill_top = by_stage["edge_prefill"]
    # K6 does threshold splitting's selection: no sort on the card
    checks["no_sort_in_payload"] = not any(
        "sort" in row["kernel"].lower() for row in profiles["payload"])
    bw, _ = peak_rates(ctx["device_name"])
    front_keys = [k for k in params if k.startswith("blocks/")]
    bf16_front = sum(params[k][:nfront].numel() * 2 for k in front_keys)
    cloud_bytes = sum(params[k][nfront:].numel() * 2 for k in front_keys) \
        + params["lm_head"].numel() * 2
    step_bound_ms = (eng.edge_weight_bytes() + cloud_bytes) / bw * 1e3

    _mark(ctx, "stages")
    emit({"phase": "split", **_times(ctx), "tiny": tiny, "config": cfg.name,
          "opsc": vars(opsc), "kv": "int8", "cache_len": 1024,
          "prompt_lens": list(SPLIT_LENS), "finish_reasons": reasons,
          "generated": lengths, "stop_token": stop, "launches": launches,
          "k7_routes": k7_routes,
          "payloads": payloads_n, "wall_s": wall_s,
          "tokens_per_s": sum(lengths) / wall_s,
          "computed_tokens_per_s": len(prompts) * n_new / wall_s,
          "uplink_bits_measured": [s.uplink_bits_measured for s in stats],
          "uplink_bits_eq3": [s.uplink_bits_eq3 for s in stats],
          "measured_over_eq3": sum(s.uplink_bits_measured for s in stats)
          / sum(s.uplink_bits_eq3 for s in stats),
          "decode_payload_bits": bits,
          "edge_weight_bytes": eng.edge_weight_bytes(),
          "edge_weight_bytes_bf16": bf16_front,
          "edge_weight_bytes_eq1": bf16_front // 2 * opsc.qw_front // 8,
          "payload_check": payloads,
          "uncompressed_equal_engine": equal16,
          "paged_shared_prefix": {
              "shared_prefix_pages": st_paged.shared_prefix_pages,
              "cloud_pool_bytes_peak": st_paged.cloud_pool_bytes_peak,
              "uplink_bits_paged": st_paged.uplink_bits_paged,
              "uplink_bits_measured_paged_dense": [
                  st_paged.uplink_bits_measured,
                  st_dense.uplink_bits_measured],
              "k2_k3_launches": [k2, k3], **paged_cmp},
          "ikv0": {"uplink_bits_eq3_ikv0_ikv1": [st_ikv0.uplink_bits_eq3,
                                                 st_ikv1.uplink_bits_eq3],
                   **ikv0_cmp},
          "wide_front": wide,
          "decode_step_b1": {"host_included_ms": stage_ms,
                             "device_busy_ms": device_ms,
                             "idle_share": {k: 1 - device_ms[k] / stage_ms[k]
                                            for k in stage_ms},
                             "bound_ms": step_bound_ms,
                             "gemv_in_step": _kernel_share(
                                 top, GEMV_DEVICE_NAMES),
                             "k1_in_step": _kernel_share(
                                 top, K1_DEVICE_NAMES),
                             "k1_in_edge": _kernel_share(
                                 profiles["edge"], K1_DEVICE_NAMES),
                             "k1_in_cloud": _kernel_share(
                                 profiles["cloud"], K1_DEVICE_NAMES),
                             "k5_in_payload": _kernel_share(
                                 profiles["payload"], K5_DEVICE_NAMES),
                             "k6_in_payload": _kernel_share(
                                 profiles["payload"], K6_DEVICE_NAMES),
                             "payload_profile": profiles["payload"],
                             "profile_top": top[:10]},
          "edge_prefill_128": {
              "device_busy_ms": prefill_ms,
              "k7_ms": sum(r["ms"] for r in prefill_top if any(
                  k in r["kernel"] for k in K7_DEVICE_NAMES)),
              "profile_top": prefill_top[:8]},
          "max_memory_allocated": peak, "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"split: failed checks {checks}")


# ------------------------------------------------------------- speculation

SPEC_K = 3  # speculate_k: the verify call is (max_slots, 1 + SPEC_K)
SPEC_REQUESTS = 6
SPEC_MAX_TOKENS = 32
SPEC_SPLIT_ROWS = 2  # edge devices of the split runs
SPEC_SPLIT_LEN = 96
SPEC_SPLIT_TOKENS = 16
VEHICLE_SPLIT_LAYER = 2  # of the vehicle's 4 blocks


def _spec_prompts(vocab, rng, n, lo, hi):
    """``n`` prompts that each tile a random 3- to 16-token pattern to
    ``lo`` .. ``hi`` tokens (the reference tests' repetitive prompts), so
    prompt lookup finds earlier occurrences and proposes drafts."""
    import numpy as np

    out = []
    for _ in range(n):
        pat = rng.integers(0, vocab, (int(rng.integers(3, 17)),))
        length = int(rng.integers(lo, hi + 1))
        out.append(np.tile(pat, -(-length // pat.size))[:length])
    return out


def _first_flips(got, want, want_lg, tol) -> tuple:
    """Per stream, the first index where ``got`` differs from ``want``, and
    that step's top-1/top-2 margin in ``want_lg`` relative to its largest
    logit. A flip is allowed only where the margin is within ``tol``.
    Returns (all flips allowed, [{row, index, margin}])."""
    import numpy as np

    flips, ok = [], True
    for r, (g, w) in enumerate(zip(got, want)):
        n = min(len(g), len(w))
        diff = np.nonzero(np.asarray(g[:n]) != np.asarray(w[:n]))[0]
        if not diff.size:
            continue
        i = int(diff[0])
        lg = np.asarray(want_lg[r][i], np.float64)
        top2 = np.sort(lg)[-2:]
        margin = float((top2[1] - top2[0]) / np.abs(lg).max())
        flips.append({"row": r, "index": i, "margin": margin,
                      "allowed": margin <= tol})
        ok = ok and margin <= tol
    return ok, flips


def _spec_scheduler(ctx, cfg, params, opts, prompts, max_new, pool_kw,
                    rel_tol) -> dict:
    """``prompts`` through the paged Scheduler in chunked and then packed
    ticks, each mode as three runs in turns: speculate_k 0 (warm-up; every
    emitted token's logits kept), SPEC_K (the counters set to 0 just before
    it and read just after), speculate_k 0 again (timed like the SPEC_K
    run). Per mode: the spec counts, decode ticks against k = 0, the
    streams against the k = 0 streams (a greedy flip allowed only where
    its margin is within ``rel_tol``), the pages left in use, and K2 (and
    in packed ticks K4) launches."""
    import torch
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va
    from repro_torch.serving.scheduler import Scheduler

    kernels = {"paged_decode_attention": pda.paged_decode_attention,
               "paged_prefill_attention": ppa.paged_prefill_attention,
               "varlen_attention": va.varlen_attention}
    out = {}
    for mode in ("chunked", "packed"):
        def serve(k, record=False):
            sched = Scheduler(cfg, params, opts, tick_mode=mode,
                              speculate_k=k, **pool_kw)
            rec = _record_logits(sched) if record else None
            rids = [sched.submit(p, max_new) for p in prompts]
            if not record:
                for fn in kernels.values():
                    fn.launches = 0
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sched.run()
            wall = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in kernels.items()}
            streams = [res[r][len(p):] for r, p in zip(rids, prompts)]
            return streams, sched, wall, launches, rec and [
                rec[r] for r in rids]

        base, _, _, _, base_lg = serve(0, record=True)
        spec, sched, spec_wall, launches, _ = serve(SPEC_K)
        base2, sched0, base_wall, _, _ = serve(0)
        st, st0 = sched.stats, sched0.stats
        ok, flips = _first_flips(spec, base, base_lg, rel_tol)
        layers = cfg.num_layers
        verify = {sh for sh in sched._shapes if sh[0] == "verify"}
        checks = {
            "flips_within_margin": ok,
            "k0_runs_equal": all((a == b).all() for a, b in zip(base, base2)),
            "lengths": all(len(t) == max_new for t in spec),
            "tokens_in_vocab": all(int(t.min()) >= 0
                                   and int(t.max()) < cfg.vocab_size
                                   for t in spec),
            "pool_drained": sched.pool.pages_in_use == 0
            and not sched.pool.refcount.any(),
            "spec_rounds": st.spec_rounds > 0 and st.spec_drafted > 0,
            "one_verify_shape": verify == {
                ("verify", pool_kw["max_slots"], 1 + SPEC_K)},
            # every decode tick is one verify call: K2 once a layer
            "k2_launches": launches["paged_decode_attention"]
            == layers * st.steps}
        if mode == "packed":
            checks["k4_launches"] = launches["varlen_attention"] \
                == layers * st.packed_ticks
        out[mode] = {
            "spec_rounds": st.spec_rounds, "spec_drafted": st.spec_drafted,
            "spec_accepted": st.spec_accepted,
            "acceptance_rate": st.acceptance_rate,
            "decode_ticks": st.steps, "decode_ticks_k0": st0.steps,
            "ticks": sched._tick, "ticks_k0": sched0._tick,
            "tokens_equal_k0": [bool((a == b).all())
                                for a, b in zip(spec, base)],
            "first_flips": flips, "flip_tol": rel_tol,
            "pages_in_use_after": sched.pool.pages_in_use,
            "launches": launches,
            "k2_rows_a_launch": pool_kw["max_slots"] * (1 + SPEC_K),
            "wall_s": spec_wall, "wall_s_k0": base_wall,
            "checks": checks}
    return out


def _verify_tick_profile(ctx, cfg, params, opts, pool_kw, rng) -> dict:
    """One verify tick (8 slots decoding after 128-token prompts that tile
    a pattern, speculate_k SPEC_K) beside one plain decode tick of the same
    slots, in turns: host-included time (CUDA events, L2 flushed), then
    device-busy time and K2's share by ``torch.profiler``. Each verify tick
    drafts, appends, verifies and rolls back, so the slots advance by their
    accepted runs as it is timed."""
    import numpy as np
    import torch
    from repro_torch.serving.scheduler import Scheduler

    prompts = _spec_prompts(cfg.vocab_size, rng, pool_kw["max_slots"], 128,
                            128)
    ticks = {}
    for name, k in (("verify", SPEC_K), ("decode", 0)):
        sched = Scheduler(cfg, params, opts, speculate_k=k, **pool_kw)
        for p in prompts:
            sched.submit(p, 400)
        sched.step()  # every prompt in one chunk, first tokens sampled
        ticks[name] = sched
    before = {n: sum(len(st.generated) for st in t.slots)
              for n, t in ticks.items()}
    calls = dict.fromkeys(ticks, 0)

    def counted(n):
        def tick():
            calls[n] += 1
            ticks[n]._decode_tick()
        return tick

    ms = ctx["timer"]({n: counted(n) for n in ticks}, iters=20,
                      device_only=False)
    emitted = {n: (sum(len(st.generated) for st in t.slots) - before[n])
               / calls[n] for n, t in ticks.items()}
    out = {}
    for n, t in ticks.items():
        device_ms, top = _device_profile(torch, t._decode_tick,
                                         STEP_PROFILE_N)
        out[n] = {"host_included_ms": ms[n], "device_busy_ms": device_ms,
                  "idle_share": 1 - device_ms / ms[n],
                  "tokens_a_tick": emitted[n],
                  "k2_in_tick": _kernel_share(top, K2_DEVICE_NAMES),
                  "profile_top": top[:6]}
        for rid in range(len(prompts)):
            t.abort(rid)
    return out


def _spec_split(cfg, params, opts, opsc, prompts, n_new, device,
                pool_pages) -> dict:
    """``prompts`` (B, S) through a SplitEngine on the dense and on the
    paged cloud, per token and at speculate_k SPEC_K (compressed): tokens,
    round trips, uplink bits and spec counts of both, and the first token
    where the streams differ with the per-token logits' margin there. The
    counters are set to 0 just before each speculative run and read just
    after: K5 and K6 once a payload (the prefill's and one a round), K2 on
    the paged cloud once a layer and round."""
    import numpy as np
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import tabq_quantize as tq
    from repro_torch.kernels import ts_mask as tsm
    from repro_torch.serving.split_engine import SplitEngine

    kernels = {"paged_decode_attention": pda.paged_decode_attention,
               "tabq_adaptive": tq.tabq_adaptive, "ts_encode": tsm.ts_encode}
    res = {}
    back = cfg.num_layers - opsc.split_layer
    plen = prompts.shape[1]
    for cloud, kw in (("dense", {}), ("paged", dict(
            paged_cloud_kv=True, cloud_pool_pages=pool_pages,
            cloud_page_size=16))):
        eng = SplitEngine(cfg, params, opsc, opts=opts, cache_len=1024,
                          device=device, **kw)
        rec = _record_cloud_logits(eng)
        t0, st0 = eng.generate(prompts, n_new)
        del eng._cloud_back
        base_lg = np.stack(rec, 1)  # (B, n_new, V): each token's logits
        for fn in kernels.values():
            fn.launches = 0
        t1, st1 = eng.generate(prompts, n_new, speculate_k=SPEC_K)
        launches = {n: fn.launches for n, fn in kernels.items()}
        _, flips = _first_flips(t1[:, plen:], t0[:, plen:], base_lg, 1.0)
        checks = {
            "tokens_in_vocab": bool((t1 >= 0).all()
                                    and (t1 < cfg.vocab_size).all()),
            "lengths": t1.shape == t0.shape,
            "spec_rounds": st1.spec_rounds > 0,
            "round_trips_at_most_per_token":
                st1.uplink_round_trips <= st0.uplink_round_trips,
            "payload_kernels_once_a_payload":
                launches["tabq_adaptive"] == launches["ts_encode"]
                == 1 + st1.spec_rounds}
        if cloud == "paged":
            checks["k2_launches"] = launches["paged_decode_attention"] \
                == back * st1.spec_rounds
        res[cloud] = {
            "tokens_equal_per_token": bool(np.array_equal(t1, t0)),
            "first_flips": [{k: v for k, v in f.items() if k != "allowed"}
                            for f in flips],
            "uplink_round_trips": [st1.uplink_round_trips,
                                   st0.uplink_round_trips],
            "uplink_bits_measured": [st1.uplink_bits_measured,
                                     st0.uplink_bits_measured],
            "uplink_bits_eq3": [st1.uplink_bits_eq3, st0.uplink_bits_eq3],
            "spec_rounds": st1.spec_rounds, "spec_drafted": st1.spec_drafted,
            "spec_accepted": st1.spec_accepted,
            "acceptance_rate": st1.acceptance_rate,
            "launches": launches, "checks": checks}
        del eng
    return res


def _spec_vehicle(ctx) -> dict:
    """The vehicle phase's induction model (trained on a copy task, so
    prompt lookup and the edge's draft head propose the copy) through the
    same scheduler and split runs: with speculation, fewer decode ticks and
    fewer uplink round trips than speculate_k 0, and equal streams."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import load_npz_checkpoint
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.serving.split_engine import SplitEngine

    device = ctx["device"]
    cfg = dataclasses.replace(get_config("llama2-7b-tiny"), vocab_size=64,
                              num_blocks=4)
    opts = RuntimeOpts(q_chunk=64, kv_chunk=64, quantized_kv=True)
    params = load_npz_checkpoint(
        os.path.join(ROOT, "experiments", "vehicles", "induction"))
    half, vocab = 16, 64
    rng = np.random.default_rng(0)  # the vehicle phase's prompts
    prefix = rng.integers(0, vocab - 1, (16, half))
    prompts = np.concatenate([prefix, np.full((16, 1), vocab - 1)], axis=1)
    out, checks = {}, {}
    for mode in ("chunked", "packed"):
        runs = {}
        for k in (0, SPEC_K):
            sched = Scheduler(cfg, params, opts, num_pages=64, page_size=16,
                              max_slots=8, tick_mode=mode, speculate_k=k,
                              device=device)
            rids = [sched.submit(p, half) for p in prompts[:SPEC_REQUESTS]]
            res = sched.run()
            runs[k] = ([res[r] for r in rids], sched)
        (base, s0), (spec, s3) = runs[0], runs[SPEC_K]
        equal = all(np.array_equal(a, b) for a, b in zip(spec, base))
        copy = float(np.mean([np.mean(o[half + 1:] == p) for o, p in
                              zip(spec, prefix)]))
        checks[f"{mode}_equal_streams"] = equal
        checks[f"{mode}_fewer_decode_ticks"] = s3.stats.steps < s0.stats.steps
        checks[f"{mode}_pool_drained"] = s3.pool.pages_in_use == 0
        out[mode] = {"decode_ticks": [s3.stats.steps, s0.stats.steps],
                     "spec_rounds": s3.stats.spec_rounds,
                     "spec_drafted": s3.stats.spec_drafted,
                     "spec_accepted": s3.stats.spec_accepted,
                     "copy_accuracy": copy}
    opsc = OPSCConfig(split_layer=VEHICLE_SPLIT_LAYER)
    for cloud, kw in (("dense", {}), ("paged", dict(
            paged_cloud_kv=True, cloud_pool_pages=16, cloud_page_size=16))):
        eng = SplitEngine(cfg, params, opsc, opts=opts, cache_len=64,
                          device=device, **kw)
        t0, st0 = eng.generate(prompts[:SPEC_SPLIT_ROWS], half)
        t1, st1 = eng.generate(prompts[:SPEC_SPLIT_ROWS], half,
                               speculate_k=SPEC_K)
        checks[f"split_{cloud}_equal_streams"] = bool(np.array_equal(t1, t0))
        checks[f"split_{cloud}_fewer_round_trips"] = \
            st1.uplink_round_trips < st0.uplink_round_trips
        out[f"split_{cloud}"] = {
            "uplink_round_trips": [st1.uplink_round_trips,
                                   st0.uplink_round_trips],
            "uplink_bits_measured": [st1.uplink_bits_measured,
                                     st0.uplink_bits_measured],
            "spec_rounds": st1.spec_rounds, "spec_drafted": st1.spec_drafted,
            "spec_accepted": st1.spec_accepted}
    return {"split_layer": VEHICLE_SPLIT_LAYER, **out, "checks": checks}


def phase_spec(ctx) -> None:
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.models.transformer import RuntimeOpts

    device = ctx["device"]
    vehicle = _spec_vehicle(ctx)
    _mark(ctx, "vehicle")
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    params, _ = _llama7b_params(ctx)
    rng = np.random.default_rng(21)
    prompts = _spec_prompts(cfg.vocab_size, rng, SPEC_REQUESTS, 100, 300)
    pool_kw = dict(num_pages=513, page_size=16, max_slots=8,
                   max_seq_len=1024, device=device)
    sched = _spec_scheduler(ctx, cfg, params, opts, prompts, SPEC_MAX_TOKENS,
                            pool_kw, PAGED_REL)
    gc.collect()
    _mark(ctx, "scheduler")
    tick = _verify_tick_profile(ctx, cfg, params, opts, pool_kw, rng)
    gc.collect()
    _mark(ctx, "verify_tick")
    split_prompts = np.stack(_spec_prompts(
        cfg.vocab_size, rng, SPEC_SPLIT_ROWS, SPEC_SPLIT_LEN,
        SPEC_SPLIT_LEN))
    split = _spec_split(cfg, params, opts, OPSCConfig(
        split_layer=SPLIT_LAYER, qw_front=4), split_prompts,
        SPEC_SPLIT_TOKENS, device, pool_pages=32)
    gc.collect()
    _mark(ctx, "split")
    torch.cuda.synchronize()
    checks = {f"vehicle_{k}": v for k, v in vehicle["checks"].items()}
    for name, part in (("scheduler", sched), ("split", split)):
        for sub, row in part.items():
            checks.update({f"{name}_{sub}_{k}": v
                           for k, v in row["checks"].items()})
    emit({"phase": "spec", **_times(ctx),
          "config": cfg.name, "speculate_k": SPEC_K,
          "prompt_lens": [len(p) for p in prompts],
          "max_tokens": SPEC_MAX_TOKENS,
          "pool": {k: v for k, v in pool_kw.items() if k != "device"},
          "scheduler": sched, "verify_tick_b8": tick,
          "split": {"split_layer": SPLIT_LAYER, "rows": SPEC_SPLIT_ROWS,
                    "prompt_len": SPEC_SPLIT_LEN,
                    "max_tokens": SPEC_SPLIT_TOKENS, **split},
          "vehicle": vehicle, "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"spec: failed checks "
                         f"{[k for k, v in checks.items() if not v]}")


# the service phase: the paged phase's ten requests over HTTP (requests 1
# and 2, which share a 200-token head, go as the two non-streaming
# completions), then one stream that hangs up after this many tokens
SERVICE_NONSTREAM = (1, 2)
SERVICE_DISCONNECT_AFTER = 4
SERVICE_DISCONNECT_LEN = 300  # its prompt; it asks for 64 tokens
SERVICE_TRACE_PHASES = "queued,prefill,first_token,decode,finish"


async def _http_open(host, port, method, path, body=None):
    """A raw HTTP/1.1 request; (reader, writer, status code)."""
    import asyncio

    reader, writer = await asyncio.open_connection(host, port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(payload)}\r\n\r\n").encode()
                 + payload)
    await writer.drain()
    code = int((await reader.readline()).split()[1])
    while await reader.readline() not in (b"\r\n", b"\n", b""):
        pass  # headers
    return reader, writer, code


async def _http_json(host, port, method, path, body=None) -> tuple:
    reader, writer, code = await _http_open(host, port, method, path, body)
    raw = await reader.read()  # Connection: close: the body ends at EOF
    writer.close()
    return code, json.loads(raw) if raw else None


async def _http_stream(host, port, body, first=None, stop_after=None):
    """A streaming completion: (code, the SSE payloads). ``first``, an
    asyncio.Event, is set at the first token; with ``stop_after`` the
    client hangs up after that many tokens."""
    from repro_torch.serving.http import SSEParser

    reader, writer, code = await _http_open(
        host, port, "POST", "/v1/completions", dict(body, stream=True))
    msgs, parser = [], SSEParser()
    while code == 200:
        chunk = await reader.read(65536)
        if not chunk:
            break
        msgs += parser.feed(chunk)
        tokens = [m for m in msgs if m != "[DONE]" and not m.get("finished")]
        if first is not None and tokens:
            first.set()
        if stop_after is not None and len(tokens) >= stop_after:
            break
        if msgs and msgs[-1] == "[DONE]":
            break
    writer.close()
    return code, msgs


def _request_body(prompt, sp) -> dict:
    """The /v1/completions body of ``prompt`` under ``sp``: no prefix key
    (detection must find shared heads)."""
    body = {"prompt": [int(t) for t in prompt], "max_tokens": sp.max_tokens}
    if not sp.greedy:
        body.update(temperature=sp.temperature, top_p=sp.top_p, seed=sp.seed)
    if sp.stop_token_ids:
        body["stop_token_ids"] = list(sp.stop_token_ids)
    return body


def _service_traffic(engine, http, prompts, sampling, rng,
                     vocab: int) -> dict:
    """The ten requests as ten concurrent HTTP clients: eight SSE streams,
    and once each has its first token (every slot busy), the two requests
    of :data:`SERVICE_NONSTREAM` as non-streaming completions, which then
    queue together: detection attaches both to one shared prefix, the
    first in FIFO order writes it and the other forks it. Then a stream
    that hangs up after :data:`SERVICE_DISCONNECT_AFTER` tokens,
    /v1/metrics, the shutdown, and /healthz before and after it."""
    import asyncio

    async def go():
        await http.start()  # binds port 0 on this loop, which serves it
        host, port = http.host, http.port
        streamed = [i for i in range(len(prompts))
                    if i not in SERVICE_NONSTREAM]
        firsts = {i: asyncio.Event() for i in streamed}
        tasks = {i: asyncio.ensure_future(_http_stream(
            host, port, _request_body(prompts[i], sampling(i, ())),
            first=firsts[i])) for i in streamed}
        await asyncio.gather(*(e.wait() for e in firsts.values()))
        for i in SERVICE_NONSTREAM:
            tasks[i] = asyncio.ensure_future(_http_json(
                host, port, "POST", "/v1/completions",
                _request_body(prompts[i], sampling(i, ()))))
        results = {i: await t for i, t in tasks.items()}
        drop = rng.integers(0, vocab, (SERVICE_DISCONNECT_LEN,))
        drop_code, drop_msgs = await _http_stream(
            host, port, {"prompt": drop.tolist(), "max_tokens": 64},
            stop_after=SERVICE_DISCONNECT_AFTER)
        for _ in range(3000):  # the abort lands on the next tick
            if not engine.server.pending:
                break
            await asyncio.sleep(0.01)
        metrics_code, metrics = await _http_json(host, port, "GET",
                                                 "/v1/metrics")
        health = await _http_json(host, port, "GET", "/healthz")
        await engine.shutdown()
        closed = await _http_json(host, port, "GET", "/healthz")
        await http.stop(shutdown_engine=False)
        return {"results": results, "drop": (drop_code, drop_msgs),
                "metrics": (metrics_code, metrics), "health": health,
                "closed": closed}

    return asyncio.run(asyncio.wait_for(go(), 900))


def _traced_tick(ctx, cfg, params, opts, pool_kw, rng) -> dict:
    """A decode tick (``Scheduler.step`` with every slot decoding after
    128-token prompts) with a Tracer attached and without, in turns (A, B,
    B, A), host included, and the traced ticks' own records."""
    from repro_torch.serving.scheduler import Scheduler
    from repro_torch.serving.telemetry import Tracer

    prompts = rng.integers(0, cfg.vocab_size, (8, 128))
    scheds = {}
    for name, tel in (("untraced", None), ("traced", Tracer())):
        sched = Scheduler(cfg, params, opts, telemetry=tel, **pool_kw)
        for p in prompts:
            sched.submit(p, 200)
        sched.step()  # every prompt in one chunk, first tokens sampled
        scheds[name] = sched
    a, b = scheds["untraced"].step, scheds["traced"].step
    ms = ctx["timer"]({"untraced": a, "traced": b, "traced_again": b,
                       "untraced_again": a}, iters=30, device_only=False)
    records = scheds["traced"].telemetry.ticks[1:]
    for sched in scheds.values():
        for rid in range(8):
            sched.abort(rid)
    return {"step_ms": ms, "batch": 8,
            "traced_record_wall_ms_median": statistics.median(
                r.wall_s * 1e3 for r in records),
            "traced_records": len(records),
            "tokens_a_record": sorted({r.tokens for r in records})}


def _fused_traced(cfg, params, opts, device) -> dict:
    """The serve phase's four requests (no stop token) through
    LLMServer(backend="fused") without a tracer and with one: the same
    streams bit for bit, and the tracer's counters."""
    import numpy as np
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.telemetry import Tracer

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (n,))
               for n in (128, 128, 96, 96)]
    sps = [SamplingParams(max_tokens=64), SamplingParams(max_tokens=48),
           SamplingParams(max_tokens=64, temperature=0.8, top_p=0.9, seed=7),
           SamplingParams(max_tokens=32)]
    runs = {}
    for name, tel in (("off", None), ("on", Tracer())):
        srv = LLMServer(cfg, params, opts, backend="fused", cache_len=1024,
                        telemetry=tel, device=device)
        rids = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = srv.run()
        runs[name] = ([outs[r].tokens for r in rids], srv.metrics())
    m = runs["on"][1]
    return {"bit_identical": all(np.array_equal(a, b) for a, b in zip(
        runs["off"][0], runs["on"][0])), "fused_calls": m["fused.calls"],
        "fused_tokens": m["fused.tokens"],
        "fused_batch_s_p50": m["fused.batch_s.p50"]}


def phase_service(ctx) -> None:
    import gc

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.async_engine import AsyncLLMServer
    from repro_torch.serving.http import (ServingHTTPServer,
                                          build_serving_kernels)
    from repro_torch.serving.telemetry import Tracer

    device = ctx["device"]
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    params, _ = _llama7b_params(ctx)
    pool_kw = dict(num_pages=513, page_size=16, max_slots=8,
                   max_seq_len=1024, device=device)
    prompts, sampling, rng = _ten_requests(cfg)
    greedy = [i for i in range(len(prompts)) if i != 4]

    # the same requests in process, without a tracer and with the explicit
    # prefix key; every emitted token's logits kept (the streams' yardstick)
    ref = LLMServer(cfg, params, opts, backend="paged", **pool_kw)
    rec = _record_logits(ref.backend.scheduler)
    ref_pieces = _record_pieces(ref.backend.scheduler)
    ref_rids = [ref.submit(p, sampling(i, ())) for i, p in enumerate(prompts)]
    ref_all = ref.run()
    ref_outs = [ref_all[r] for r in ref_rids]
    del ref
    gc.collect()

    _mark(ctx, "reference")
    # the service: AsyncLLMServer over LLMServer(backend="paged",
    # auto_prefix=True, telemetry=Tracer()) behind ServingHTTPServer
    tracer = Tracer()
    srv = LLMServer(cfg, params, opts, backend="paged", auto_prefix=True,
                    telemetry=tracer, **pool_kw)
    sched = srv.backend.scheduler
    pieces = _record_pieces(sched)
    build_serving_kernels(device)  # no first token waits on nvcc
    engine = AsyncLLMServer(srv)
    http = ServingHTTPServer(engine, "127.0.0.1", 0)
    for fn in (pda.paged_decode_attention, ppa.paged_prefill_attention):
        fn.launches = 0
    t0 = time.perf_counter()
    traffic = _service_traffic(engine, http, prompts, sampling, rng,
                               cfg.vocab_size)
    wall_s = time.perf_counter() - t0
    launches = {"paged_decode_attention": pda.paged_decode_attention.launches,
                "paged_prefill_attention":
                    ppa.paged_prefill_attention.launches}
    for name, n in launches.items():
        ctx["launches"][name] = ctx["launches"].get(name, 0) + n

    # what came over HTTP, against the outputs the server kept
    outputs = srv.outputs()
    http_tokens, rids = {}, {}
    for i, res in traffic["results"].items():
        if i in SERVICE_NONSTREAM:
            code, body = res
            rids[i], http_tokens[i] = body["rid"], body["tokens"]
            ok_code = code == 200
        else:
            code, msgs = res
            toks = [m for m in msgs if m != "[DONE]" and not m.get("finished")]
            rids[i], http_tokens[i] = toks[0]["rid"], [m["token"]
                                                        for m in toks]
            ok_code = code == 200 and msgs[-1] == "[DONE]"
        if not ok_code:
            raise SystemExit(f"service: request {i} answered {code}")
    outs = [outputs[rids[i]] for i in range(len(prompts))]
    held = _hold_streams((outs, None, pieces), (ref_outs, rec, ref_pieces),
                         greedy, PAGED_REL)
    drop_code, drop_msgs = traffic["drop"]
    drop_rid = drop_msgs[0]["rid"] if drop_msgs else None
    drop_out = outputs.get(drop_rid)
    metrics_code, metrics = traffic["metrics"]
    latency = {f"{name}.{q}": metrics[f"requests.{name}.{q}"]
               for name in ("ttft_s", "e2e_s") for q in ("p50", "p95")}

    trace_path = os.path.join(ROOT, "build", "service_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    tracer.export_chrome_trace(trace_path)
    report = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_report.py"),
         trace_path, "--require-ticks", "5", "--require-phases",
         SERVICE_TRACE_PHASES], capture_output=True, text=True)
    st = sched.stats
    checks = {
        "http_equals_outputs": all(
            list(outs[i].tokens) == http_tokens[i]
            for i in range(len(prompts))),
        "lengths": [len(o.tokens) for o in outs] == list(TEN_MAX_TOKENS),
        "streams_held_margin_rule": held["agree"],
        "auto_prefix_hits": st.auto_prefix_hits >= 1,
        "prefix_forks": st.prefix_forks >= 1,
        "k2_launched": launches["paged_decode_attention"] > 0,
        "k3_launched": launches["paged_prefill_attention"] > 0,
        "disconnect_aborted": drop_code == 200 and drop_out is not None
        and drop_out.finish_reason == "abort"
        and len(drop_out.tokens) >= SERVICE_DISCONNECT_AFTER,
        "no_page_leaked": sched.pool.pages_in_use == 0
        and not sched.pool.refcount.any(),
        "healthz_200_then_503": traffic["health"][0] == 200
        and traffic["closed"][0] == 503,
        "metrics_endpoint": metrics_code == 200
        and metrics["requests.retained"] == len(prompts) + 1,
        "trace_report_validates": report.returncode == 0,
        "tokens_in_vocab": all(int(o.tokens.min()) >= 0 and int(
            o.tokens.max()) < cfg.vocab_size for o in outs)}
    del engine, http, srv, sched, outputs
    gc.collect()

    _mark(ctx, "traffic")
    tick = _traced_tick(ctx, cfg, params, opts, pool_kw, rng)
    gc.collect()
    _mark(ctx, "traced_tick")
    fused = _fused_traced(cfg, params, opts, device)
    checks["fused_bit_identical_tracer_on_off"] = fused["bit_identical"]
    gc.collect()
    _mark(ctx, "fused_traced")
    emit({"phase": "service", **_times(ctx),
          "config": cfg.name, "nvidia_smi": ctx["smi"],
          "pool": {k: v for k, v in pool_kw.items() if k != "device"},
          "clients": len(prompts) + 1,
          "nonstreaming": list(SERVICE_NONSTREAM),
          "latency_s": latency, "wall_s": wall_s,
          "tokens": sum(len(o.tokens) for o in outs),
          "ticks": len(tracer.ticks), "auto_prefix_hits": st.auto_prefix_hits,
          "prefix_forks": st.prefix_forks, "launches": launches,
          "streams": {"bit_identical": sum(held["bit_identical"].values()),
                      "greedy": len(greedy),
                      "first_difference": held["first_difference"],
                      "tokens_compared": held["tokens_compared"],
                      "same_pieces": held["same_pieces"], "tol": PAGED_REL},
          "disconnect": {"tokens": None if drop_out is None
                         else len(drop_out.tokens),
                         "reason": None if drop_out is None
                         else drop_out.finish_reason},
          "trace_report": report.stdout.splitlines()[:3]
          + report.stderr.splitlines()[-3:],
          "tick_with_tracer": tick, "fused_tracer": fused,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"service: failed checks "
                         f"{[k for k, v in checks.items() if not v]}")


DISAGG_SPEC_K = 3  # run B: the decode replica's speculate_k


def _single_streams(ctx, cfg, params, opts, pool_kw, mode) -> dict:
    """The ten requests through one ``Scheduler`` in ``mode``, speculation
    off: the paged (chunked) or packed phase's main run when that phase ran
    in this call, else run here as those phases run it (a first run picks
    request 3's stop token, the second is kept). {"outs", "pieces",
    "stop"}."""
    from repro_torch.serving.api import LLMServer

    if mode not in ctx["single"]:
        prompts, sampling, _ = _ten_requests(cfg)

        def serve(stop):
            srv = LLMServer(cfg, params, opts, backend="paged",
                            tick_mode=mode, **pool_kw)
            pieces = _record_pieces(srv.backend.scheduler)
            rids = [srv.submit(p, sampling(i, stop))
                    for i, p in enumerate(prompts)]
            outs = srv.run()
            return [outs[r] for r in rids], pieces

        first, _ = serve(())
        stop = int(first[3].tokens[10])
        outs, pieces = serve((stop,))
        ctx["single"][mode] = {"outs": outs, "pieces": pieces, "stop": stop}
    return ctx["single"][mode]


def _disagg_run(cfg, params, opts, pool_kw, mode, k, stop, record) -> dict:
    """The ten requests through ``LLMServer(deployment="disaggregated")``
    (tick ``mode`` on both replicas, ``speculate_k`` k on the decode one, a
    Tracer on the prefill one): outputs, the facade, the tracer, host
    seconds of each extract, and with ``record`` both replicas' logits and
    prefill pieces merged by rid."""
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.telemetry import Tracer

    prompts, sampling, _ = _ten_requests(cfg)
    tracer = Tracer()
    srv = LLMServer(cfg, params, opts, backend="paged",
                    deployment="disaggregated", tick_mode=mode,
                    decode_kwargs={"speculate_k": k}, telemetry=tracer,
                    **pool_kw)
    ds = srv.backend.scheduler
    recs = [_record_logits(s) for s in (ds.prefill, ds.decode)] \
        if record else None
    pieces = [_record_pieces(s) for s in (ds.prefill, ds.decode)]
    extract_s, extract = [], ds.prefill.extract

    def timed_extract(rid):
        t0 = time.perf_counter()
        req = extract(rid)
        extract_s.append(time.perf_counter() - t0)
        return req

    ds.prefill.extract = timed_extract
    rids = [srv.submit(p, sampling(i, (stop,)))
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    outs = srv.run()
    wall_s = time.perf_counter() - t0

    def merged(parts):
        out = {}
        for part in parts:  # prefill side first: its tokens come first
            for rid, rows in part.items():
                out.setdefault(rid, []).extend(rows)
        return out

    return {"outs": [outs[r] for r in rids], "ds": ds, "tracer": tracer,
            "rec": merged(recs) if record else None,
            "pieces": merged(pieces), "extract_s": extract_s,
            "wall_s": wall_s}


def _facade_step_timing(ctx, cfg, params, opts, pool_kw) -> dict:
    """A facade step with eight slots decoding on the decode replica (the
    prefill replica idle) beside the single scheduler's decode tick with
    the same eight slots, in turns: host included (CUDA events) and
    device busy (``torch.profiler``)."""
    import numpy as np
    import torch
    from repro_torch.serving.page_transport import DisaggregatedScheduler
    from repro_torch.serving.scheduler import Scheduler

    rng = np.random.default_rng(23)
    prompts = rng.integers(0, cfg.vocab_size, (pool_kw["max_slots"], 128))
    ds = DisaggregatedScheduler(cfg, params, opts, **pool_kw)
    single = Scheduler(cfg, params, opts, **pool_kw)
    for p in prompts:
        ds.submit(p, 200)
        single.submit(p, 200)
    single.step()  # every prompt in one chunk, first tokens sampled
    while ds.prefill.pending or any(
            st is None for st in ds.decode.slots):
        ds.step()
    ms = ctx["timer"]({"facade_step": ds.step,
                       "single_decode_tick": single._decode_tick},
                      iters=20, device_only=False)
    dev_ds, top_ds = _device_profile(torch, ds.step, STEP_PROFILE_N)
    dev_single, _ = _device_profile(torch, single._decode_tick,
                                    STEP_PROFILE_N)
    out = {"facade_step_ms": ms["facade_step"],
           "single_decode_tick_ms": ms["single_decode_tick"],
           "facade_step_device_ms": dev_ds,
           "single_decode_tick_device_ms": dev_single,
           "facade_idle_share": 1 - dev_ds / ms["facade_step"],
           "decoding_slots": sum(st is not None for st in ds.decode.slots),
           "prefill_idle": not ds.prefill.pending, "profile_top": top_ds[:6]}
    for rid in range(len(prompts)):
        ds.abort(rid)
        single.abort(rid)
    return out


def phase_disagg(ctx) -> None:
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va
    from repro_torch.models.transformer import RuntimeOpts

    device = ctx["device"]
    cfg = get_config("llama2-7b")  # full width and depth
    opts = RuntimeOpts(quantized_kv=True)
    params, _ = _llama7b_params(ctx)
    pool_kw = dict(num_pages=513, page_size=16, max_slots=8,
                   max_seq_len=1024, prefill_chunk=256, device=device)
    prompts, _, _ = _ten_requests(cfg)
    greedy = [i for i in range(len(prompts)) if i != 4]
    kernels = {"paged_decode_attention": pda.paged_decode_attention,
               "paged_prefill_attention": ppa.paged_prefill_attention,
               "varlen_attention": va.varlen_attention}
    layers = cfg.num_layers
    checks, runs = {}, {}
    for name, mode, k in (("A", "chunked", 0), ("B", "packed", DISAGG_SPEC_K)):
        single = _single_streams(ctx, cfg, params, opts, pool_kw, mode)
        stop = single["stop"]
        # a recorded run (every emitted token's logits: the margin rule),
        # which also warms up, then the main path's run: the counters set
        # to 0 just before it and read just after
        rec_run = _disagg_run(cfg, params, opts, pool_kw, mode, k, stop,
                              record=True)
        held = _hold_streams(
            (single["outs"], None, single["pieces"]),
            (rec_run["outs"], rec_run["rec"], rec_run["pieces"]), greedy,
            PAGED_REL)
        rec_tokens = [o.tokens for o in rec_run["outs"]]
        del rec_run
        gc.collect()
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        run = _disagg_run(cfg, params, opts, pool_kw, mode, k, stop,
                          record=False)
        launches = {n: fn.launches for n, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated()
        for n, c in launches.items():
            ctx["launches"][n] = ctx["launches"].get(n, 0) + c
        ds, tracer, outs = run["ds"], run["tracer"], run["outs"]
        st, pre, dec = ds.stats, ds.prefill, ds.decode
        tp = ds.transport
        page_bytes = pre.pool.page_bytes()
        # what crossed: every request the decode replica finished; each
        # shipped the pages of what it had written on the prefill replica:
        # its prompt, and in chunked ticks the token the prefill tick's own
        # decode step fed (its first token)
        crossed = sorted(set(dec.results))
        fed = 1 if mode == "chunked" else 0
        rid_row = {o.rid: i for i, o in enumerate(outs)}
        want_pages = sum(pre.pool.pages_for(len(prompts[rid_row[r]]) + fed)
                         for r in crossed)
        spans = [sp for sp in tracer.spans if sp.name == "page_stream"]
        single_outs = single["outs"]
        seeded_equal = bool(np.array_equal(outs[4].tokens,
                                           single_outs[4].tokens))
        first_equal = {i: bool(outs[i].tokens[0] == single_outs[i].tokens[0])
                       for i in greedy if held["same_pieces"][i]}
        c = {
            "streams_margin_rule": held["agree"],
            "same_as_recorded_run": all(
                np.array_equal(o.tokens, t) for o, t in zip(outs, rec_tokens)),
            # request 3 stops where the single run's does unless its
            # stream flipped before (allowed under the margin rule)
            "lengths_equal_single": all(
                len(outs[i].tokens) == len(single_outs[i].tokens)
                for i in range(len(prompts))
                if i != 3 or held["first_difference"][3] is None),
            "same_pieces_first_token_equal": all(first_equal.values()),
            "pools_drained": all(
                s.pool.pages_in_use == 0 and not s.pool.refcount.any()
                and s.pool.swap_bytes == 0 for s in (pre, dec)),
            "every_multi_token_request_crossed_once": crossed == sorted(
                o.rid for o in outs if len(o.tokens) > 1 + fed)
            and sorted(sp.rid for sp in spans) == crossed
            and tp.transfers == len(crossed) * len(cfg.pattern),
            "bytes_moved_equal_written_pages": tp.bytes_moved
            == want_pages * page_bytes,
            "span_bytes_equal_bytes_moved": sum(
                sp.attrs["bytes"] for sp in spans) == tp.bytes_moved,
            "weights_shared": all(
                dec.params[key].data_ptr() == t.data_ptr()
                for key, t in pre.params.items()),
            "ttft_on_prefill_replica": set(st.ttft_ticks)
            == {o.rid for o in outs} and not dec.stats.ttft_ticks,
            "tokens_in_vocab": all(int(o.tokens.min()) >= 0 and int(
                o.tokens.max()) < cfg.vocab_size for o in outs)}
        if mode == "chunked":
            # same decode path on both sides: the pieces decide each row
            c["same_pieces_bit_identical"] = held["same_pieces_identical"]
            c["seeded_stream_equal"] = seeded_equal
            c["k2_launches"] = launches["paged_decode_attention"] \
                == layers * st.steps > 0
            c["k3_launches"] = launches["paged_prefill_attention"] \
                == layers * st.shared_prefill_calls > 0
        else:
            c["k4_launches"] = launches["varlen_attention"] \
                == layers * st.packed_ticks > 0
            c["k2_verify_launches"] = launches["paged_decode_attention"] \
                == layers * st.steps > 0
            c["decode_replica_speculated"] = dec.stats.spec_rounds > 0 \
                and pre.speculate_k == 0
        checks.update({f"{name}_{key}": v for key, v in c.items()})
        moved_s = tp.seconds
        runs[name] = {
            "tick_mode": mode, "speculate_k": k, "stop_token": stop,
            "ticks": {"prefill_replica": pre._tick,
                      "decode_replica": dec._tick},
            "wall_s": run["wall_s"],
            "tokens_per_s": sum(len(o.tokens) for o in outs) / run["wall_s"],
            "ttft_ticks": [o.metrics.ttft_ticks for o in outs],
            "ttft_ticks_single": [o.metrics.ttft_ticks for o in single_outs],
            "ttft_s": [o.metrics.ttft_s for o in outs],
            "ttft_s_single": [o.metrics.ttft_s for o in single_outs],
            "e2e_s": [o.metrics.e2e_s for o in outs],
            "e2e_s_single": [o.metrics.e2e_s for o in single_outs],
            "page_stream": {
                "transfers": tp.transfers, "bytes_moved": tp.bytes_moved,
                "pages": want_pages, "page_bytes": page_bytes,
                "wire_s": moved_s, "wire_s_per_transfer":
                moved_s / max(tp.transfers, 1),
                "wire_gb_per_s": tp.bytes_moved / moved_s / 1e9
                if moved_s else None,
                "extract_s": sum(run["extract_s"]),
                "extract_s_per_request": run["extract_s"],
                "restore_s": dec._swap.seconds,
                "restore_transfers": dec._swap.transfers,
                "span_bytes": [sp.attrs["bytes"] for sp in spans],
                "span_s": [sp.end - sp.start for sp in spans]},
            "launches": launches,
            "spec": {"rounds": dec.stats.spec_rounds,
                     "drafted": dec.stats.spec_drafted,
                     "accepted": dec.stats.spec_accepted},
            "streams": {"bit_identical": held["bit_identical"],
                        "first_difference": held["first_difference"],
                        "same_pieces": held["same_pieces"],
                        "tokens_compared": held["tokens_compared"],
                        "tol": PAGED_REL, "seeded_equal": seeded_equal,
                        "same_pieces_first_token_equal": first_equal},
            "max_memory_allocated": peak,
            "weights_bytes": sum(t.numel() * t.element_size()
                                 for t in params.values()),
            "pools_bytes": 2 * pre.pool.num_pages * page_bytes}
        del run, ds, tracer, pre, dec
        gc.collect()

    _mark(ctx, "runs")
    step = _facade_step_timing(ctx, cfg, params, opts, pool_kw)
    gc.collect()
    _mark(ctx, "step_timing")
    emit({"phase": "disagg", **_times(ctx),
          "config": cfg.name, "nvidia_smi": ctx["smi"],
          "pool": {k: v for k, v in pool_kw.items() if k != "device"},
          "runs": runs, "step": step, "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"disagg: failed checks "
                         f"{[k for k, v in checks.items() if not v]}")


# ------------------------------------------------------------ the sharded

# run B: four gloo ranks sharing the card, each with a copy of llama2-7b
# over its first 8 of 32 blocks (3.8 GB of bf16 weights), four requests
# through a pool each rank stores half of (33 of 66 pages, 35.7 MB); every
# tick gathers the pool through the host, so a small pool and few tokens
# keep the run to seconds
SHARDED_B_RANKS = 4
SHARDED_B_BLOCKS = 8
SHARDED_B_LENS = (320, 200, 96, 64)
SHARDED_B_MAX_TOKENS = (16, 8, 16, 8)
SHARDED_B_POOL = dict(num_pages=65, page_size=16, max_slots=4,
                      max_seq_len=512, prefill_chunk=128)
SHARDED_MODES = ("chunked", "packed")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _paged_kernels() -> dict:
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va

    return {"paged_decode_attention": pda.paged_decode_attention,
            "paged_prefill_attention": ppa.paged_prefill_attention,
            "varlen_attention": va.varlen_attention}


def _sharded_serve(cfg, params, opts, pool_kw, mode, mesh, requests,
                   device) -> dict:
    """``requests`` [(prompt, SamplingParams)] through ``LLMServer(
    deployment="sharded")`` (``mesh`` None: the unsharded scheduler) in
    ``mode``, the K2 to K4 counters set to 0 just before and read just
    after: tokens, launches, the scheduler's counts, the pool's gauges and
    the host seconds of the run."""
    import torch
    from repro_torch.serving.api import LLMServer

    kw = dict(deployment="sharded", mesh=mesh) if mesh is not None else {}
    srv = LLMServer(cfg, params, opts, backend="paged", tick_mode=mode,
                    device=device, **kw, **pool_kw)
    kernels = _paged_kernels()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rids = [srv.submit(p, sp) for p, sp in requests]
    outs = srv.run()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    sched = srv.backend.scheduler
    st = sched.stats
    return {"tokens": [[int(t) for t in outs[r].tokens] for r in rids],
            "launches": {n: fn.launches for n, fn in kernels.items()},
            "steps": st.steps, "shared_prefill_calls":
            st.shared_prefill_calls, "packed_ticks": st.packed_ticks,
            "ticks": sched._tick, "gauges": sched.pool.gauges(),
            "swap_bytes": sched.pool.swap_bytes, "wall_s": wall}


def _sharded_b_requests(cfg) -> list:
    import numpy as np
    from repro_torch.core.sampling import SamplingParams

    rng = np.random.default_rng(32)
    return [(rng.integers(0, cfg.vocab_size, (n,)),
             SamplingParams(max_tokens=m))
            for n, m in zip(SHARDED_B_LENS, SHARDED_B_MAX_TOKENS)]


def _sharded_b_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama2-7b"),
                               num_blocks=SHARDED_B_BLOCKS)


def _sharded_b_rank(rank: int, world: int, device_name: str) -> dict:
    """One rank of run B (``launch.ranks.run_ranks`` starts it under
    gloo): the weights drawn on the card from seed 0, the mesh over the
    default group, both tick modes."""
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params

    torch.set_num_threads(2)
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg = _sharded_b_config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         torch.bfloat16, device)
    mesh = make_serving_mesh(cfg.pattern[0].mixer.num_kv_heads)
    out = {"mesh": list(mesh.shape), "setup_s": time.perf_counter() - t0,
           "runs": {}}
    for mode in SHARDED_MODES:
        out["runs"][mode] = _sharded_serve(
            cfg, params, RuntimeOpts(quantized_kv=True), SHARDED_B_POOL,
            mode, mesh, _sharded_b_requests(cfg), device)
    return out


def _sharded_checks(run, layers, mode) -> dict:
    """The launches of K2 and K3 (chunked) or K4 (packed) equal to one a
    layer and call; the pool drained."""
    n = run["launches"]
    if mode == "chunked":
        c = {"k2_launches": n["paged_decode_attention"]
             == layers * run["steps"] > 0,
             "k3_launches": n["paged_prefill_attention"]
             == layers * run["shared_prefill_calls"] > 0}
    else:
        c = {"k4_launches": n["varlen_attention"]
             == layers * run["packed_ticks"] > 0}
    c["pool_drained"] = run["gauges"]["pages_in_use"] == 0 \
        and run["swap_bytes"] == 0
    return c


def phase_sharded(ctx) -> None:
    """The sharded deployment on the card. A: llama2-7b at full width and
    depth through ``LLMServer(deployment="sharded")`` on the (1, 1) mesh
    of one NCCL rank (this process), the paged phase's ten requests,
    chunked and packed, held token for token to the single scheduler's
    streams (the paged and packed phases' runs). B: four gloo ranks
    sharing the card on the (2, 2) mesh (pages over two ranks, 16 kv heads
    a rank), llama2-7b over 8 of its 32 blocks, four requests, chunked and
    packed, held token for token to the unsharded scheduler on the card at
    the same depth. Each rank's pool bytes, K2 to K4 launches (counters set
    to 0 just before each run and read just after) and seconds."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params

    device = ctx["device"]
    opts = RuntimeOpts(quantized_kv=True)
    checks, runs = {}, {}

    # A: one NCCL rank, the (1, 1) mesh, full depth
    cfg = get_config("llama2-7b")
    params, _ = _llama7b_params(ctx)
    pool_kw = dict(num_pages=513, page_size=16, max_slots=8,
                   max_seq_len=1024, prefill_chunk=256)
    prompts, sampling, _ = _ten_requests(cfg)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_serving_mesh(cfg.pattern[0].mixer.num_kv_heads)
        for mode in SHARDED_MODES:
            single = _single_streams(ctx, cfg, params, opts,
                                     dict(pool_kw, device=device), mode)
            reqs = [(p, sampling(i, (single["stop"],)))
                    for i, p in enumerate(prompts)]
            run = _sharded_serve(cfg, params, opts, pool_kw, mode, mesh,
                                 reqs, device)
            want = [[int(t) for t in o.tokens] for o in single["outs"]]
            c = _sharded_checks(run, cfg.num_layers, mode)
            c["streams_equal_single"] = run["tokens"] == want
            checks.update({f"A_{mode}_{k}": v for k, v in c.items()})
            for n, v in run["launches"].items():
                ctx["launches"][n] = ctx["launches"].get(n, 0) + v
            runs[f"A_{mode}"] = {k: v for k, v in run.items()
                                 if k != "tokens"}
            runs[f"A_{mode}"]["mesh"] = list(mesh.shape)
            gc.collect()
    finally:
        dist.destroy_process_group()
    _mark(ctx, "A_nccl_1x1")

    # B: four gloo ranks sharing the card, (2, 2) mesh, 8 of 32 blocks
    cfg_b = _sharded_b_config()
    params_b = init_params(cfg_b, torch.Generator(device=device).manual_seed(
        0), torch.bfloat16, device)
    reqs_b = _sharded_b_requests(cfg_b)
    single_b = {mode: _sharded_serve(cfg_b, params_b, opts, SHARDED_B_POOL,
                                     mode, None, reqs_b, device)
                for mode in SHARDED_MODES}
    del params_b
    gc.collect()
    torch.cuda.empty_cache()
    _mark(ctx, "B_unsharded")
    # the ranks share this process's card, named with its index
    rank_device = torch.device("cuda", torch.cuda.current_device()) \
        if device.type == "cuda" else device
    ranks = run_ranks(_sharded_b_rank, SHARDED_B_RANKS, backend="gloo",
                      workdir=os.path.join(ROOT, "build", "sharded_ranks"),
                      args=(str(rank_device),), timeout=600)
    _mark(ctx, "B_gloo_2x2")
    for mode in SHARDED_MODES:
        want = single_b[mode]["tokens"]
        c = {"ranks_mesh_2x2": all(r["mesh"] == [2, 2] for r in ranks),
             "streams_equal_unsharded": all(
                 r["runs"][mode]["tokens"] == want for r in ranks)}
        for i, r in enumerate(ranks):
            for k, v in _sharded_checks(r["runs"][mode], cfg_b.num_layers,
                                        mode).items():
                c[f"rank{i}_{k}"] = v
            g = r["runs"][mode]["gauges"]
            c[f"rank{i}_stores_half_the_pages"] = \
                2 * g["shard_device_bytes"] == g["pool_device_bytes"]
        checks.update({f"B_{mode}_{k}": v for k, v in c.items()})
        runs[f"B_{mode}"] = {
            "unsharded": {k: v for k, v in single_b[mode].items()
                          if k != "tokens"},
            "ranks": [{"setup_s": r["setup_s"],
                       **{k: v for k, v in r["runs"][mode].items()
                          if k != "tokens"}} for r in ranks],
            "tokens_compared": sum(len(t) for t in want)}
    emit({"phase": "sharded", **_times(ctx), "config": cfg.name,
          "nvidia_smi": ctx["smi"], "pool_A": pool_kw,
          "pool_B": SHARDED_B_POOL, "blocks_B": SHARDED_B_BLOCKS,
          "runs": runs, "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"sharded: failed checks "
                         f"{[k for k, v in checks.items() if not v]}")


# ----------------------------------------------------------- the families

# the families phase's fused traffic (gemma2-2b and h2o-danube-3-4b at full
# width): two prompts that wrap every 4096-slot ring in prefill and keep it
# wrapping in decode, two that never wrap
FAMILY_LENS = (4160, 4160, 256, 256)
FAMILY_CACHE_LEN = 4352
FAMILY_TF_STEPS = 8  # decode steps held to the unquantized prefill
# the reference's bound on int8-KV logits against the unquantized cache's,
# relative to the largest logit (tests/test_arch_smoke.py::
# test_quantized_kv_decode_close)
INT8_BOUND = 0.08
FAMILY_SPLIT_LAYER = 8  # ℓ of h2o-danube-3-4b's layers
FAMILY_TINY = ("gemma2-2b-tiny", "h2o-danube-3-4b-tiny")
# gemma2-2b over its first 5 of 13 blocks (10 of 26 layers, windowed and
# global alternating) and h2o-danube-3-4b over 9 of its 24 (one layer past
# FAMILY_SPLIT_LAYER): full depth was measured (PERF.md); cut for the whole
# script's time (7 and 24 until the sharded phase came, danube 16 until
# the train phase's mesh parts), as the moe and gqa phases' configs are
FAMILY_GEMMA2_BLOCKS = 5
FAMILY_DANUBE_BLOCKS = 9


def _family_params(ctx, name, blocks=None) -> tuple:
    """The config's random bf16 weights from seed 0, drawn on the card, of
    its first ``blocks`` blocks (default: all); (cfg, params, seconds to
    draw)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.params import init_params

    cfg = get_config(name)
    if blocks is not None:
        cfg = dataclasses.replace(cfg, num_blocks=blocks)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(
        device=ctx["device"]).manual_seed(0), torch.bfloat16, ctx["device"])
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def _cache_bytes(caches) -> int:
    """Bytes of per-layer caches: a KV cache's codes or values, scales and
    positions, a Mamba-2 layer's conv and recurrent states."""
    total = 0
    for c in caches:
        parts = c if isinstance(c, tuple) else (c.k, c.v, c.k_scale,
                                                c.v_scale, c.pos)
        total += sum(t.numel() * t.element_size() for t in parts
                     if t is not None)
    return total


def _ring_check(cfg, caches, q_pos) -> dict:
    """Each layer's cache after a run that wrote positions 0 .. q_pos of
    every row: a windowed layer's ring holds exactly (q_pos - W, q_pos]
    and -1 in its pad slots; a full layer 0 .. q_pos at slot = position
    and -1 past it."""
    import torch

    ok, slots = True, []
    for c, ls in zip(caches, cfg.pattern * cfg.num_blocks):
        if ls.mixer.kind == "ssm":  # a recurrent state: no slots
            continue
        s = c.pos.shape[1]
        t = torch.arange(s, device=c.pos.device)
        w = ls.mixer.sliding_window
        if w is None:
            want = torch.where(t <= q_pos, t, -1)
        else:
            w = min(w, s)
            want = torch.where(t < w, q_pos - torch.remainder(q_pos - t, w),
                               -1)
        ok = ok and bool((c.pos == want.to(torch.int32)).all())
        slots.append(s)
    return {"ok": ok, "slots": sorted(set(slots))}


def _family_fused(ctx, name, weights=None, lens=FAMILY_LENS,
                  cache_len=FAMILY_CACHE_LEN, max_tokens=(64, 48, 64, 32),
                  opts_kw=None, tf_held=True) -> dict:
    """One config at full width (random bf16 weights, int8 KV; ``weights``
    (cfg, params, seconds) or drawn here) answering four requests of
    prompt lengths ``lens`` through LLMServer(backend="fused"): a first
    run picks a stop token; the main run (K1's and the MoE layer's counters
    set to 0 just before it and read just after) gives the asked finish
    reasons and lengths, repeats the first run, and launches K1 once a
    layer and decode step on a config without soft caps, never on a
    soft-capped one; a MoE config routes k pairs a token and layer and
    drops none. Then request 0's stream decoded step by step on rows 0 and
    1 (both fed request 0's tokens): the caches hold exactly the positions
    written (a ring its window's), K1 equals its plain version on every
    layer's last query (gemma2: a random query over each local layer's
    ring), and the first decode steps' logits lie within the reference's
    int8 bound of an unquantized prefill's over the same tokens (a MoE
    config step by step as MOE_RULE says); on a config with Mamba-2 layers
    that also compares the step recurrence with the chunked prefill, and
    the steps' tokens must agree where the prefill's top-1/top-2 margin
    exceeds the bound (with ``tf_held=False`` the comparison is reported,
    not held). Timed: the first prompt's
    prefill, a decode step at B = 2 (host included; device busy) beside
    the bytes it must read (on a MoE config, of the experts it ran), the
    MoE layer alone (dispatch and expert products), peak memory against
    weights plus caches."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import (RuntimeOpts, decode_step,
                                                init_caches, prefill)
    from repro_torch.serving.api import LLMServer

    device = ctx["device"]
    base = torch.cuda.memory_allocated()  # other phases' tensors
    cfg, params, init_s = weights or _family_params(ctx, name)
    opts = RuntimeOpts(quantized_kv=True, **(opts_kw or {}))
    layers = cfg.pattern * cfg.num_blocks
    attn = [ls.mixer for ls in layers if ls.mixer.kind == "attn"]
    windowed_only = all(m.attn_softcap is None for m in attn)
    moe_layers = [ls.ffn for ls in layers
                  if ls.ffn is not None and ls.ffn.kind == "moe"]
    is_moe = bool(moe_layers)
    ffn = moe_layers[0] if is_moe else None
    ssm = len(attn) < len(layers)  # Mamba-2 layers carry a state
    rng = np.random.default_rng(24)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]

    def requests(stop_tok):
        return [SamplingParams(max_tokens=max_tokens[0]),
                SamplingParams(max_tokens=max_tokens[1],
                               stop_token_ids=stop_tok),
                SamplingParams(max_tokens=max_tokens[2], temperature=0.8,
                               top_p=0.9, seed=7),
                SamplingParams(max_tokens=max_tokens[3])]

    def serve(sps):
        srv = LLMServer(cfg, params, opts, backend="fused",
                        cache_len=cache_len, device=device)
        rids = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = srv.run()
        return [outs[r] for r in rids]

    first = serve(requests(()))
    stop = int(first[1].tokens[10])
    stop_at = list(first[1].tokens).index(stop) + 1
    # the fused backend runs each prompt length's group to its largest
    # max_tokens: (rows, decode steps) a group
    groups: dict = {}
    for n, mt in zip(lens, max_tokens):
        rows, most = groups.get(n, (0, 0))
        groups[n] = (rows + 1, max(most, mt))
    decode_steps = sum(most - 1 for _, most in groups.values())
    decode_rows = sum(rows * (most - 1) for rows, most in groups.values())
    da.decode_attention.launches = 0
    moe.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = serve(requests((stop,)))
    wall_s = time.perf_counter() - t0
    launches = da.decode_attention.launches
    moe_stats = dict(moe.STATS)
    peak = torch.cuda.max_memory_allocated()
    reasons = [o.finish_reason for o in outs]
    lengths = [len(o.tokens) for o in outs]
    checks = {
        "reasons": reasons == ["length", "stop", "length", "length"],
        "lengths": lengths == [max_tokens[0], stop_at, max_tokens[2],
                               max_tokens[3]],
        "same_as_first_run": all(
            np.array_equal(o.tokens, f.tokens[:len(o.tokens)])
            for o, f in zip(outs, first)),
        "tokens_in_vocab": all(int(o.tokens.min()) >= 0 and int(
            o.tokens.max()) < cfg.vocab_size for o in outs),
        "k1_launches": launches == (len(attn) * decode_steps
                                    if windowed_only else 0)}
    if is_moe:  # k pairs a token and layer: the prefills' and each step's
        checks["moe_routes_k_pairs_a_token"] = moe_stats["pairs"] \
            == len(moe_layers) * ffn.top_k * (sum(lens) + decode_rows)
        checks["moe_drops_none"] = moe_stats["dropped"] == 0

    # request 0's stream, step by step, on the two long prompts
    n0 = len(outs[0].tokens)
    forced = torch.as_tensor(np.tile(outs[0].tokens[:n0 - 1], (2, 1)),
                             device=device)
    s = lens[0]
    # a MoE config: each layer's choices on row 0, the prompt's (L, s, k)
    # and each held decode step's token's (L, k)
    routes = _Routes() if is_moe else None
    step_sel = []
    with torch.inference_mode():
        toks = torch.as_tensor(np.stack(prompts[:2]), device=device)
        with routes or contextlib.nullcontext():
            logits, caches = prefill(params, cfg, toks, cache_len, opts)
            if routes:
                prompt_sel = routes.last_tokens(2, s)[2][:, 0]
            stepped = [logits.float().cpu()]
            for t in range(n0 - 2):
                pos = torch.tensor(s + t, dtype=torch.int32, device=device)
                logits, caches = decode_step(params, cfg, forced[:, t:t + 1],
                                             caches, pos, opts)
                if t < FAMILY_TF_STEPS:
                    stepped.append(logits.float().cpu())
                    if routes:
                        sel, gap, _ = routes.last_tokens(2, 1)
                        step_sel.append((sel[0], gap[0]))
                elif routes:
                    routes.take()
        # the last step, every layer's K1 call recorded
        q_pos = s + n0 - 2
        seen, real = [], ops.decode_attention

        def record(*args):
            seen.append(args)
            return real(*args)

        ops.decode_attention = record
        try:
            decode_step(params, cfg, forced[:, n0 - 2:], caches, torch.tensor(
                q_pos, dtype=torch.int32, device=device), opts)
        finally:
            ops.decode_attention = real
        rings = _ring_check(cfg, caches, q_pos)
        checks["caches_hold_the_positions"] = rings["ok"]
        k1_err = 0.0
        if windowed_only:
            checks["k1_calls_last_step"] = len(seen) == len(attn)
            for a in seen:
                k1_err = max(k1_err, float((da.decode_attention(*a)
                                            - da.decode_attention_ref(*a))
                                           .abs().max()))
        else:
            checks["k1_calls_last_step"] = not seen
            gen = torch.Generator(device=device).manual_seed(1)
            qp = torch.tensor(q_pos, dtype=torch.int32, device=device)
            for c, ls in zip(caches, cfg.pattern * cfg.num_blocks):
                if ls.mixer.sliding_window is None:
                    continue
                m = ls.mixer
                q = torch.randn((2, m.num_kv_heads, m.num_heads
                                 // m.num_kv_heads, m.head_dim),
                                generator=gen, device=device)
                a = (q, c.k, c.k_scale, c.v, c.v_scale, c.pos, qp)
                k1_err = max(k1_err, float((da.decode_attention(*a)
                                            - da.decode_attention_ref(*a))
                                           .abs().max()))
        checks["k1_equals_plain_on_caches"] = k1_err <= ATOL
        # the int8 cache against an unquantized prefill over the prompt
        # and the tokens so far: decode step j's logits
        plain = RuntimeOpts(quantized_kv=False, **(opts_kw or {}))
        tf_rel, ref_sel, earlier, ref_lg = [], [], [], []
        for j in range(1, FAMILY_TF_STEPS + 1):  # request 0's row
            full = torch.cat([toks[:1], forced[:1, :j]], dim=1)
            with routes or contextlib.nullcontext():
                ref, _ = prefill(params, cfg, full, None, plain)
            ref = ref.float().cpu()
            ref_lg.append(ref[0].numpy())
            tf_rel.append(float((stepped[j][:1] - ref).abs().max()
                                / ref.abs().max()))
            if routes:
                sel, gap, whole = routes.last_tokens(1, s + j)
                ref_sel.append((sel[0], gap[0]))
                # (layer, position) pairs before this step's token whose
                # choice differs: the prompt's and the earlier steps', in
                # every layer but the last (none attends its choices)
                mine = np.concatenate([prompt_sel] + [
                    st[0][:, None] for st in step_sel[:j - 1]], axis=1)
                earlier.append(int((np.sort(mine, -1) != np.sort(
                    whole[:, 0, :-1], -1)).any(-1)[:-1].sum()))
        ref_lg = np.stack(ref_lg)
        step_tok = np.array([int(stepped[j][0].argmax())
                             for j in range(1, FAMILY_TF_STEPS + 1)])
        tf_tokens = None
        if ssm:  # tokens where the prefill's margin exceeds the tolerance
            margin = _margins(ref_lg[None])[0]
            far = margin > INT8_BOUND
            tf_tokens = {"compared": int(far.sum()), "equal": bool(
                (step_tok[far] == ref_lg.argmax(-1)[far]).all())}
        if is_moe:  # step by step, MOE_RULE
            z = np.zeros(len(tf_rel))
            int8_rule = _moe_hold([{
                "err": np.array(tf_rel),
                "got": step_tok if ssm else z,
                "want": ref_lg.argmax(-1) if ssm else z,
                "margin": _margins(ref_lg[None])[0] if ssm else z,
                "flips": _route_flips(np.stack([r[0] for r in ref_sel]),
                                      np.stack([d[0] for d in step_sel])),
                "earlier": earlier,
                "gaps": (np.stack([r[1] for r in ref_sel]),
                         np.stack([d[1] for d in step_sel]))}],
                INT8_BOUND, False, 0)
            if tf_held:
                checks["int8_within_reference_bound"] = int8_rule["ok"]
        else:
            int8_rule = None
            if tf_held:
                checks["int8_within_reference_bound"] = \
                    max(tf_rel) < INT8_BOUND
            if ssm and tf_held:
                checks["steps_tokens_margin_rule"] = tf_tokens["equal"]

        # timings: the first prompt's prefill (B = 1), and one decode step
        # at B = 2 (it rewrites the same slots)
        one = toks[:1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cfg, one, cache_len, opts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        nxt = forced[:, n0 - 2:n0 - 1]
        pos = torch.tensor(q_pos, dtype=torch.int32, device=device)
        step = lambda: decode_step(params, cfg, nxt, caches, pos, opts)  # noqa: E731
        moe.reset_stats()
        step()
        step_moe = dict(moe.STATS)
        step_ms = ctx["timer"]({"step": step}, iters=20,
                               device_only=False)["step"]
        device_ms, rows = _device_profile(torch, step, STEP_PROFILE_N)
        moe_layer = _moe_layer_timing(ctx, cfg, params, opts, 2) \
            if is_moe else None
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    meta = init_caches(cfg, 2, cache_len, opts, torch.device("meta"))
    cache_bytes = _cache_bytes(meta)
    bw, _ = peak_rates(ctx["device_name"])
    # a step reads every weight but the embedding's rows (a tied head
    # reads them all) and the experts it does not run, each attention
    # layer's live slots (codes, scales, position) and each Mamba-2
    # layer's state, which it also writes back
    expert_bytes = 0
    if is_moe:
        expert_bytes = 3 * cfg.d_model * ffn.d_ff * 2  # bf16 gate, up, down
        weight_read = weight_bytes - expert_bytes * (
            len(moe_layers) * ffn.num_experts - step_moe["experts"])
    else:
        weight_read = weight_bytes
    read = weight_read - _unread_bytes(params)
    for c, ls in zip(caches, layers):
        m = ls.mixer
        if m.kind == "ssm":
            read += 2 * _cache_bytes([c])
        else:
            read += 2 * min(c.pos.shape[1], q_pos + 1) * (
                m.num_kv_heads * (2 * m.head_dim + 8) + 4)
    gemm = _kernel_share(rows, GEMM_DEVICE_NAMES)
    k1 = _kernel_share(rows, K1_DEVICE_NAMES)
    out = {"config": cfg.name, "blocks": cfg.num_blocks,
           "params": sum(t.numel() for t in params.values()),
           "init_s": init_s, "cache_len": cache_len,
           "cache_slots": rings["slots"], "prompt_lens": list(lens),
           "max_tokens": list(max_tokens),
           "finish_reasons": reasons, "generated": lengths,
           "stop_token": stop, "decode_steps": decode_steps,
           "k1_launches": launches, "moe_counts": moe_stats,
           "wall_s": wall_s, "tokens_per_s": sum(lengths) / wall_s,
           "k1_max_abs_err_on_caches": k1_err,
           "int8_rel_err_per_step": tf_rel, "int8_bound": INT8_BOUND,
           "int8_bound_held": tf_held,
           "int8_moe_rule": int8_rule, "steps_tokens": tf_tokens,
           "prefill_tokens": s, "prefill_s": prefill_s,
           "decode_step_b2": {
               "q_pos": q_pos, "host_included_ms": step_ms,
               "device_busy_ms": device_ms,
               "idle_share": 1 - device_ms / step_ms,
               "bytes_read": read, "bound_ms": read / bw * 1e3,
               "moe_counts": step_moe if is_moe else None,
               "gemm_in_step": gemm, "k1_in_step": k1,
               "other_ms": device_ms - gemm["ms"] - k1["ms"],
               "profile_top": rows[:8]},
           "moe_layer_b2": moe_layer,
           "max_memory_allocated": peak, "allocated_before": base,
           "weight_bytes": weight_bytes,
           "cache_bytes_b2": cache_bytes, "checks": checks}
    del params, caches, seen
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_layer_timing(ctx, cfg, params, opts, b) -> dict:
    """Block 0's first MoE layer alone on a decode step's input (B rows,
    one token each, in the weights' dtype): host-included time (CUDA events)
    and device time (``torch.profiler``), split into the GEMMs (router,
    experts, shared expert) and everything else (the dispatch: softmax,
    top-k, ranks, grouping, gathers, the combine, the SiLU products), and
    its host syncs and experts run a call."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_params

    ls, p = next((ls, p) for ls, p in layer_params(cfg, params, (0, 1))
                 if ls.ffn is not None and ls.ffn.kind == "moe")
    gen = torch.Generator(device=ctx["device"]).manual_seed(3)
    x = torch.randn((b, 1, cfg.d_model), generator=gen,
                    device=ctx["device"]).to(params["embed"].dtype)

    def call():
        return moe.moe_layer(p["ffn"], x, ls.ffn, opts.moe_capacity_factor,
                             opts.moe_groups)

    moe.reset_stats()
    call()
    counts = dict(moe.STATS)
    host_ms = ctx["timer"]({"moe_layer": call}, iters=20,
                           device_only=False)["moe_layer"]
    device_ms, rows = _device_profile(torch, call, 10)
    gemm = _kernel_share(rows, GEMM_DEVICE_NAMES)
    return {"rows": b, "host_included_ms": host_ms,
            "device_busy_ms": device_ms, "products_ms": gemm["ms"],
            "dispatch_ms": device_ms - gemm["ms"],
            "host_syncs_a_call": counts["host_syncs"],
            "experts_a_call": counts["experts"], "profile_top": rows[:10]}


def _k7_per_edge_block(cfg) -> int:
    """K7 launches of one edge block's forward apart from its routed
    experts (each expert that runs adds 3): a layer's 4 attention
    projections or a Mamba-2 layer's 6 (``conv_w`` is used dequantized),
    and the ffn's products (an MLP's 2 or 3; a MoE layer's router and its
    shared expert's 3; none without an ffn)."""
    n = 0
    for ls in cfg.pattern:
        n += 4 if ls.mixer.kind == "attn" else 6
        f = ls.ffn
        if f is None:
            continue
        if f.kind != "moe":
            n += 3 if f.gated else 2
        else:
            n += 1 + (3 if f.num_shared else 0)
    return n


def _family_split(ctx, name="h2o-danube-3-4b", weights=None,
                  opts_kw=None, n_new=SPLIT_MAX_TOKENS) -> dict:
    """A config at full width (``weights`` (cfg, params, seconds) or drawn
    here) through LLMServer(backend="split") at ℓ = FAMILY_SPLIT_LAYER
    with the paper's OPSC defaults, four requests of the split phase's
    lengths (counters set to 0 just before the run and read just after:
    K1 on the edge and the cloud, K5, K6 and K7, K7 by route and, on a MoE
    config, once a projection, the router and each expert the edge ran);
    the first request's payloads held to their plain versions after the
    run; an uncompressed full-precision split equal to the Engine bit for
    bit; one decode step by stage (STEP_PROFILE_N profiled calls a
    stage). Each request asks for ``n_new`` tokens."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.core.sampling import SamplingParams, truncate_at_stop
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import tabq_quantize as tq
    from repro_torch.kernels import ts_mask as tsm
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.api import LLMServer
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.split_engine import SplitEngine

    from repro_torch.models import moe

    device = ctx["device"]
    cfg, params, _ = weights or _family_params(ctx, name)
    opts = RuntimeOpts(quantized_kv=True, **(opts_kw or {}))
    opsc = OPSCConfig(split_layer=FAMILY_SPLIT_LAYER, qw_front=4)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in SPLIT_LENS]
    sps = [SamplingParams(max_tokens=n_new),
           SamplingParams(max_tokens=n_new, temperature=0.8, top_p=0.9,
                          seed=7),
           SamplingParams(max_tokens=n_new), SamplingParams(max_tokens=n_new)]

    def serve(srv):
        rids = [srv.submit(p, sp) for p, sp in zip(prompts, sps)]
        outs = srv.run()
        return [outs[r] for r in rids]

    srv = LLMServer(cfg, params, opts, backend="split", opsc=opsc,
                    cache_len=1024, device=device)
    eng = srv.backend.engine
    held, edge_experts = [], [0]

    def compress(h):  # keeps the first request's hidden states
        if len(held) < 4:  # the prefill and three decode payloads
            held.append(h.detach().clone())
        return SplitEngine._compress(eng, h)

    def edge_front(*args, **kw):  # counts the experts the edge runs
        before = moe.STATS["experts"]
        out = SplitEngine._edge_front(eng, *args, **kw)
        edge_experts[0] += moe.STATS["experts"] - before
        return out

    eng._compress, eng._edge_front = compress, edge_front
    kernels = {"decode_attention": da.decode_attention,
               "tabq_adaptive": tq.tabq_adaptive, "ts_encode": tsm.ts_encode,
               "dequant_matmul": dm.dequant_matmul}
    for fn in kernels.values():
        fn.launches = 0
    k7_routes = dm.dequant_matmul.route_launches
    k7_routes.update(dict.fromkeys(k7_routes, 0))
    moe.reset_stats()
    part_s, t0 = {}, time.perf_counter()
    outs = serve(srv)
    part_s["serve"] = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    k7_routes = dict(k7_routes)
    moe_counts = dict(moe.STATS)
    del eng._compress, eng._edge_front
    t0 = time.perf_counter()
    payloads = _payloads_identical(held, opsc)
    part_s["payloads"] = time.perf_counter() - t0
    payloads_n = len(prompts) * n_new
    decodes = len(prompts) * (n_new - 1)
    blocks = opsc.split_layer // len(cfg.pattern)
    k7_want = _k7_per_edge_block(cfg) * blocks * payloads_n \
        + 3 * edge_experts[0]
    n_attn = cfg.num_blocks * sum(ls.mixer.kind == "attn"
                                  for ls in cfg.pattern)
    checks = {
        "payloads_identical_to_plain": payloads["identical"],
        "lengths": [len(o.tokens) for o in outs] == [n_new] * 4,
        "k1_launches": launches["decode_attention"] == n_attn * decodes,
        "k5_k6_launches": launches["tabq_adaptive"] == launches["ts_encode"]
        == payloads_n,
        "k7_launches": launches["dequant_matmul"] == k7_want,
        "no_early_exit": all(o.split_stats.early_exits == 0 for o in outs)}

    # a full-precision, uncompressed split: the Engine's streams bit for bit
    t0 = time.perf_counter()
    srv16 = LLMServer(cfg, params, opts, backend="split",
                      opsc=OPSCConfig(split_layer=FAMILY_SPLIT_LAYER,
                                      qw_front=16),
                      compress=False, cache_len=1024, device=device)
    outs16 = serve(srv16)
    engine = Engine(cfg, params, opts, cache_len=1024, device=device)
    equal16 = []
    for p, sp, o in zip(prompts, sps, outs16):
        want = engine.generate_requests(p[None], [sp])
        gen, _ = truncate_at_stop(want.tokens[0, len(p):], sp)
        equal16.append(gen == o.tokens.tolist())
    checks["uncompressed_fp_front_equals_engine"] = all(equal16)
    del srv16, engine, outs16
    part_s["uncompressed_and_engine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_stage = _split_stages(ctx, eng, opts, prompts[0][None], 1024,
                             STEP_PROFILE_N)
    part_s["stages"] = time.perf_counter() - t0
    stage_ms, device_ms = by_stage["host_included_ms"], \
        by_stage["device_busy_ms"]
    profiles = by_stage["profiles"]
    out = {"config": cfg.name, "opsc": vars(opsc),
           "prompt_lens": list(SPLIT_LENS), "launches": launches,
           "k7_routes": k7_routes, "k7_expected": k7_want,
           "edge_experts_run": edge_experts[0], "moe_counts": moe_counts,
           "payload_check": payloads,
           "uncompressed_equal_engine": equal16,
           "uplink_bits_measured": [o.split_stats.uplink_bits_measured
                                    for o in outs],
           "edge_weight_bytes": eng.edge_weight_bytes(), "part_s": part_s,
           "decode_step_b1": {
               "host_included_ms": stage_ms, "device_busy_ms": device_ms,
               "idle_share": {k: 1 - device_ms[k] / stage_ms[k]
                              for k in stage_ms},
               "decode_payload_bits": by_stage["bits"],
               "k1_in_edge": _kernel_share(profiles["edge"],
                                           K1_DEVICE_NAMES),
               "k1_in_cloud": _kernel_share(profiles["cloud"],
                                            K1_DEVICE_NAMES),
               "k7_in_edge": _kernel_share(profiles["edge"],
                                           K7_DEVICE_NAMES),
               "k5_in_payload": _kernel_share(profiles["payload"],
                                              K5_DEVICE_NAMES),
               "k6_in_payload": _kernel_share(profiles["payload"],
                                              K6_DEVICE_NAMES),
               "profile_top": by_stage["top"][:8]},
           "checks": checks}
    del srv, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _family_tiny(ctx, name, opts_kw=None, cfg=None) -> dict:
    """A tiny config (f32 weights, int8 KV, 20-token prompts: past the
    families' 16-slot window; ``cfg`` in place of the registered ``name``)
    greedily on the CPU (plain versions) and on the card (kernels): logits
    within MODEL_REL, tokens under the margin rule, as the model phase
    holds llama2-7b tiny (a config with MoE layers step by step as
    MOE_RULE says: the card fed the CPU's tokens, then the card's Engine
    running free)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.engine import Engine

    device = ctx["device"]
    cfg = cfg or get_config(name)
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                       **(opts_kw or {}))
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = {k: v.to(device) for k, v in cpu.items()}
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 20))
    n, cache_len = 24, 64
    moe = any(ls.ffn is not None and ls.ffn.kind == "moe"
              for ls in cfg.pattern)
    got = Engine(cfg, card, opts, cache_len=cache_len,
                 device=device).generate(prompts, n).tokens[:, 20:]
    if not moe:
        want, want_lg = _greedy_stepwise(cpu, cfg, prompts, n, opts,
                                         cache_len, "cpu")
        got_lg = _teacher_forced(card, cfg, prompts, want, opts, cache_len,
                                 device)
        rel = float((np.abs(got_lg - want_lg).max() / np.abs(want_lg).max()))
        ok, compared = _margin_agreement(got, want, want_lg, MODEL_REL)
        return {"config": name, "steps": n, "max_rel_logit_err": rel,
                "tol": MODEL_REL, "tokens_compared": compared,
                "ok": ok and rel <= MODEL_REL}
    with _Routes() as routes:
        want, want_lg, cpu_routes = _greedy_stepwise(
            cpu, cfg, prompts, n, opts, cache_len, "cpu", routes)
        got_lg, card_routes = _teacher_forced(
            card, cfg, prompts, want, opts, cache_len, device, routes)
    err = np.abs(got_lg - want_lg).max(-1) / np.abs(want_lg).max()
    margin = _margins(want_lg)
    rows = [{"err": err[r], "margin": margin[r], "want": want[r],
             "flips": _route_flips(cpu_routes["sel"][r],
                                   card_routes["sel"][r]),
             "earlier": _earlier_flips(cpu_routes, card_routes, r),
             "codes": _code_flips(cpu_routes, card_routes, r),
             "gaps": (cpu_routes["gap"][r], card_routes["gap"][r])}
            for r in range(len(want))]
    # the card fed the CPU's tokens: its argmax at every step
    forced = _moe_hold([dict(row, got=got_lg[r].argmax(-1))
                        for r, row in enumerate(rows)], MODEL_REL, False,
                       len(rows))
    # the card's Engine running free
    free = _moe_hold([dict(row, got=got[r]) for r, row in enumerate(rows)],
                     MODEL_REL, True, len(rows))
    return {"config": name, "steps": n,
            "max_rel_logit_err": float(err.max()), "held": MOE_RULE,
            "tol": MODEL_REL, "rel_logit_err_by_step": err.tolist(),
            "teacher_forced": forced, "engine_free": free,
            "tokens_compared": forced["tokens_compared"]
            + free["tokens_compared"], "ok": forced["ok"] and free["ok"]}


def phase_families(ctx) -> None:
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    timed, part_s = _timed_parts(ctx)
    tiny = {name: timed(name, _family_tiny, name) for name in FAMILY_TINY}
    danube = _family_params(ctx, "h2o-danube-3-4b", FAMILY_DANUBE_BLOCKS)
    fused = {"h2o-danube-3-4b": timed("h2o-danube-3-4b", _family_fused,
                                      "h2o-danube-3-4b", danube),
             "gemma2-2b": timed("gemma2-2b", _family_fused, "gemma2-2b",
                                _family_params(ctx, "gemma2-2b",
                                               FAMILY_GEMMA2_BLOCKS))}
    split = timed("split", _family_split, weights=danube)
    del danube
    checks = {f"tiny_{k}": v["ok"] for k, v in tiny.items()}
    for part, res in (("A", fused["h2o-danube-3-4b"]),
                      ("B", fused["gemma2-2b"]), ("C", split)):
        checks.update({f"{part}_{k}": v for k, v in res["checks"].items()})
    emit({"phase": "families", "nvidia_smi": ctx["smi"], "tiny": tiny,
          "gemma2_blocks": [FAMILY_GEMMA2_BLOCKS,
                            get_config("gemma2-2b").num_blocks],
          "danube_blocks": [FAMILY_DANUBE_BLOCKS,
                            get_config("h2o-danube-3-4b").num_blocks],
          "A_danube_fused": fused["h2o-danube-3-4b"],
          "B_gemma2_fused": fused["gemma2-2b"], "C_danube_split": split,
          "phase_s": time.perf_counter() - t0, "part_s": part_s,
          "checks": checks,
          "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"families: failed checks "
                         f"{[k for k, v in checks.items() if not v]}")


# the mixture-of-experts configs: qwen2-moe-a2.7b at full width (12 of 24
# blocks; full depth is measured in PERF.md),
# qwen3-moe-235b-a22b at full width over its first 4 of 94 blocks (all of
# them are 470 GB of bf16); both served dropless, as the reference serves
MOE_OPTS = dict(moe_capacity_factor=0.0)
MOE_QWEN3_BLOCKS = 4
# qwen2-moe-a2.7b over its first 10 of 24 blocks: full depth was measured
# (PERF.md), and the whole script must finish well inside its 1,200 s
# limit on a slow host too (one measured run took 1.35 × as long); 12
# until the train phase came
MOE_QWEN2_BLOCKS = 10
MOE_FUSED_LENS = (512, 512, 128, 128)  # A: qwen2-moe through "fused"
MOE_FUSED_CACHE_LEN = 640
MOE_QWEN3_LENS = (256, 256, 64, 64)  # D: qwen3-moe, fused then packed
MOE_QWEN3_MAX_TOKENS = (32, 32, 32, 32)
# B: eight requests through the paged backend, the last three sharing a
# 256-token prefix (forks, K3), a 256-token chunk budget
MOE_PAGED_LENS = (600, 96, 450, 128, 200, 300, 280, 400)
MOE_PAGED_PREFIX = 256
MOE_PAGED_FORKS = (5, 6, 7)
MOE_PAGED_MAX_TOKENS = 32
MOE_SPLIT_MAX_TOKENS = 16  # C: the split phase's prompts, 16 tokens each
MOE_TINY = ("qwen2-moe-a2.7b-tiny", "qwen3-moe-235b-a22b-tiny")


def _moe_paged(ctx, weights, lens, max_new, prefix, forks, modes) -> dict:
    """A MoE config (``weights``: cfg, params, seconds) answering greedy
    requests of prompt lengths ``lens`` (``forks`` share a ``prefix``)
    through LLMServer(backend="paged") in each tick mode of ``modes`` (the
    paged phase's pool: 8 slots, 513 pages of 16, a 256-token chunk
    budget), its counters set to 0 just before each run and read just
    after: K2 once a layer and decode step, K3 once a layer and chunk or
    fork call, K4 once a layer and packed tick, no pair dropped, no page
    left. Each run records every emitted token's logits and MoE choices:
    the first mode's streams are held to the dense (fused) path fed the
    same tokens, a later mode's to the first's while the two streams
    agree, step by step within PAGED_REL as MOE_RULE says."""
    import numpy as np
    import torch
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va
    from repro_torch.models import moe
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.api import LLMServer

    device = ctx["device"]
    cfg, params, _ = weights
    opts = RuntimeOpts(quantized_kv=True, **MOE_OPTS)
    rng = np.random.default_rng(25)
    shared = rng.integers(0, cfg.vocab_size, (prefix,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    for i in forks:
        prompts[i][:prefix] = shared

    def sampling(i):
        kw = dict(prefix_key="shared", prefix_len=prefix) if i in forks \
            else {}
        return SamplingParams(max_tokens=max_new, **kw)

    kernels = {"decode_attention": da.decode_attention,
               "paged_decode_attention": pda.paged_decode_attention,
               "paged_prefill_attention": ppa.paged_prefill_attention,
               "varlen_attention": va.varlen_attention}
    runs, out, checks = {}, {}, {}
    for mode in modes:
        srv = LLMServer(cfg, params, opts, backend="paged", tick_mode=mode,
                        num_pages=513, page_size=16, max_slots=8,
                        max_seq_len=1024, prefill_chunk=256, device=device)
        sched = srv.backend.scheduler
        routes = _Routes().__enter__()
        rec = _record_logits(sched, routes)
        for fn in kernels.values():
            fn.launches = 0
        k4_routes = va.varlen_attention.route_launches
        k4_routes.update(dict.fromkeys(k4_routes, 0))
        moe.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [srv.submit(p, sampling(i)) for i, p in enumerate(prompts)]
        try:
            outs = srv.run()
        finally:
            routes.__exit__()
        wall_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        st = sched.stats
        outs = [outs[r] for r in rids]
        runs[mode] = (outs, rec, routes)
        L = cfg.num_layers
        checks.update({
            f"{mode}_lengths": [len(o.tokens) for o in outs]
            == [max_new] * len(lens),
            f"{mode}_pool_reclaimed": sched.pool.pages_in_use == 0
            and not sched.pool.refcount.any(),
            f"{mode}_drops_none": moe.STATS["dropped"] == 0,
            f"{mode}_k1_not_launched": launches["decode_attention"] == 0})
        if mode == "packed":
            checks["packed_k4_launches"] = launches["varlen_attention"] \
                == L * st.packed_ticks > 0
            checks["packed_k4_on_tensor_cores"] = \
                k4_routes["tensor_cores"] == launches["varlen_attention"]
        else:
            checks[f"{mode}_k2_launches"] = \
                launches["paged_decode_attention"] == L * st.steps > 0
            checks[f"{mode}_k3_launches"] = \
                launches["paged_prefill_attention"] \
                == L * st.shared_prefill_calls
            if forks:
                checks[f"{mode}_k3_launched"] = st.shared_prefill_calls > 0
        if forks:
            checks[f"{mode}_prefix_forks"] = st.prefix_forks \
                == len(forks) - 1
        out[mode] = {"wall_s": wall_s,
                     "tokens_per_s": sum(len(o.tokens) for o in outs)
                     / wall_s, "ticks": sched._tick,
                     "decode_steps": st.steps,
                     "packed_ticks": st.packed_ticks,
                     "shared_prefill_calls": st.shared_prefill_calls,
                     "prefix_forks": st.prefix_forks,
                     "launches": launches, "k4_routes": dict(k4_routes),
                     "moe_counts": dict(moe.STATS)}
        del srv, sched
    first = modes[0]
    report = _moe_against_dense(params, cfg, opts, prompts, *runs[first],
                                PAGED_REL, device)
    checks[f"{first}_equal_fused_margin_rule"] = report["ok"]
    out[first]["vs_fused"] = report
    for mode in modes[1:]:
        (want, want_rec, want_routes), (got, got_rec, got_routes) = \
            runs[first], runs[mode]
        rows = []
        for w, g in zip(want, got):
            n = min(len(w.tokens), len(g.tokens))
            wl = np.stack(want_rec[w.rid])[:n]
            ws = want_routes.by_rid[w.rid][:n]
            gs = got_routes.by_rid[g.rid][:n]
            rows.append({
                "err": np.abs(np.stack(got_rec[g.rid])[:n] - wl).max(-1)
                / np.abs(wl).max(), "margin": _margins(wl),
                "got": g.tokens[:n], "want": w.tokens[:n],
                "flips": _route_flips(np.stack([x[0] for x in ws]),
                                      np.stack([x[0] for x in gs])),
                "gaps": (np.stack([x[1] for x in ws]),
                         np.stack([x[1] for x in gs]))})
        # streams running free part at the first step whose error crosses
        # a top-1/top-2 gap, often the first few: one token in all
        report = _moe_hold(rows, PAGED_REL, True, 1)
        checks[f"{mode}_equal_{first}_margin_rule"] = report["ok"]
        out[mode]["vs_" + first] = report
        out[mode]["bit_identical_rows"] = [bool(np.array_equal(
            w.tokens, g.tokens)) for w, g in zip(want, got)]
    return {"config": cfg.name, "prompt_lens": list(lens),
            "max_tokens": max_new, "shared_prefix": prefix,
            "forks": list(forks), "tol": PAGED_REL, "runs": out,
            "checks": checks}


def phase_moe(ctx) -> None:
    from repro_torch.configs import get_config

    qwen2_blocks = get_config("qwen2-moe-a2.7b").num_blocks
    t0 = time.perf_counter()
    timed, part_s = _timed_parts(ctx)
    tiny = {name: timed(name, _family_tiny, name, MOE_OPTS)
            for name in MOE_TINY}
    qwen2 = timed("init_qwen2", _family_params, "qwen2-moe-a2.7b",
                  MOE_QWEN2_BLOCKS)
    a = timed("A", _family_fused, "qwen2-moe-a2.7b", qwen2,
              lens=MOE_FUSED_LENS, cache_len=MOE_FUSED_CACHE_LEN,
              opts_kw=MOE_OPTS)
    b = timed("B", _moe_paged, qwen2, MOE_PAGED_LENS, MOE_PAGED_MAX_TOKENS,
              MOE_PAGED_PREFIX, MOE_PAGED_FORKS, ("chunked", "packed"))
    c = timed("C", _family_split, "qwen2-moe-a2.7b", qwen2,
              opts_kw=MOE_OPTS, n_new=MOE_SPLIT_MAX_TOKENS)
    del qwen2
    _free_weights()
    qwen3 = timed("init_qwen3", _family_params, "qwen3-moe-235b-a22b",
                  MOE_QWEN3_BLOCKS)
    d = timed("D", _family_fused, "qwen3-moe-235b-a22b", qwen3,
              lens=MOE_QWEN3_LENS, cache_len=MOE_FUSED_CACHE_LEN,
              max_tokens=MOE_QWEN3_MAX_TOKENS, opts_kw=MOE_OPTS)
    d_packed = timed("D_packed", _moe_paged, qwen3, MOE_QWEN3_LENS,
                     MOE_QWEN3_MAX_TOKENS[0], 0, (), ("packed",))
    del qwen3
    _free_weights()
    checks = {f"tiny_{k}": v["ok"] for k, v in tiny.items()}
    for part, res in (("A", a), ("B", b), ("C", c), ("D", d),
                      ("D", d_packed)):
        checks.update({f"{part}_{k}": v for k, v in res["checks"].items()})
    emit({"phase": "moe", "nvidia_smi": ctx["smi"], "tiny": tiny,
          "qwen2_moe_blocks": [MOE_QWEN2_BLOCKS, qwen2_blocks],
          "A_qwen2_moe_fused": a, "B_qwen2_moe_paged": b,
          "C_qwen2_moe_split": c, "D_qwen3_moe_fused": d,
          "D_qwen3_moe_packed": d_packed,
          "phase_s": time.perf_counter() - t0, "part_s": part_s,
          "checks": checks, "ok": all(checks.values())})
    if not all(checks.values()):
        raise SystemExit(f"moe: failed checks "
                         f"{[k for k, v in checks.items() if not v]}")


# the GQA/MQA configs (ROADMAP queue 1 item 9.1): internlm2-20b (48 query
# heads on 8 kv heads: G 6) and granite-34b (48 on 1: G 48, an ungated GELU
# MLP) at full width (the depths below), random bf16 weights, int8 KV
GQA_FUSED_LENS = (512, 512, 128, 128)
GQA_FUSED_CACHE_LEN = 640
GQA_MAX_TOKENS = (16, 16, 16, 16)
# the paged runs: eight greedy requests, the last three forking a 256-token
# prefix (K3), through the paged phase's pool and chunk budget
GQA_PAGED_LENS = (600, 96, 450, 128, 200, 300, 280, 400)
GQA_PAGED_PREFIX = 256
GQA_PAGED_FORKS = (5, 6, 7)
GQA_PAGED_MAX_TOKENS = 16
GQA_SPLIT_MAX_TOKENS = 8  # the split runs: the split phase's prompts
# granite-34b runs over its first 12 of 88 blocks and internlm2-20b over 12
# of 48: both depths were measured (PERF.md), and the later phases need the
# seconds within the script's 1,200 s limit (on a slow host too); 22 and 24
# before the train phase came, 16 before the sharded phase, 12 before the
# train phase's mesh parts (9: one layer past FAMILY_SPLIT_LAYER)
GQA_GRANITE_BLOCKS = 9
GQA_INTERNLM2_BLOCKS = 9


def _small_config(name, blocks=2):
    """The registered config ``name`` at ``tiny()``'s widths (d_model 128,
    vocab 256, head dim 32, d_ff 256; a Mamba-2 mixer of d_inner 256,
    d_state 16, chunk 8; 4 experts top-2 of d_ff 64) over ``blocks`` of
    its whole pattern (``tiny()`` keeps two layer kinds: jamba's has no
    attention layer) with its full-width query heads a kv head (``tiny()``
    gives internlm2 G 2, granite G 4 and qwen2-vl G 2): 2 kv heads below
    G 12, else 1; the vision stub as ``tiny()`` cuts it (M-RoPE sections
    (4, 6, 6), 8 patches of width 64)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(name)

    def mixer(m):
        if m.kind != "attn":
            return dataclasses.replace(m, d_inner=256, d_state=16,
                                       head_dim=32, chunk=8)
        g = m.num_heads // m.num_kv_heads
        kv = 2 if g < 12 else 1
        return dataclasses.replace(m, num_heads=g * kv, num_kv_heads=kv,
                                   head_dim=32)

    def ffn(f):
        if f is None or f.kind == "mlp":
            return f and dataclasses.replace(f, d_ff=256)
        return dataclasses.replace(f, num_experts=4, top_k=2, d_ff=64)

    pattern = tuple(dataclasses.replace(ls, mixer=mixer(ls.mixer),
                                        ffn=ffn(ls.ffn))
                    for ls in cfg.pattern)
    vlm = dict(mrope_sections=(4, 6, 6), num_patches=8, d_vision=64) \
        if cfg.embed == "vlm" else {}
    return dataclasses.replace(cfg, name=name + "-small", d_model=128,
                               vocab_size=256, pattern=pattern,
                               num_blocks=blocks, **vlm)


def _dense_paged(ctx, weights, modes) -> dict:
    """A dense config (``weights``: cfg, params, seconds) answering eight
    greedy requests (``GQA_PAGED_*``: three fork a 256-token prefix)
    through LLMServer(backend="paged") in each tick mode of ``modes`` (the
    paged phase's pool: 8 slots, 513 pages of 16, a 256-token chunk
    budget), the counters set to 0 just before each run and read just
    after: K2 once a layer and decode step, K3 once a layer and chunk or
    fork call, K4 once a layer and packed tick, each on the tensor cores
    where it has them, K1 never, no page left. Every emitted token's
    logits are recorded and held step by step (``_moe_hold`` with no
    route record: every step within PAGED_REL of the largest logit, the
    tokens equal at every step whose top-1/top-2 margin exceeds it): the
    first mode's streams against the dense (fused) path fed the same
    tokens, a later mode's against the first's up to the first step where
    the two streams part."""
    import numpy as np
    import torch
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.kernels import varlen_attention as va
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.api import LLMServer

    device = ctx["device"]
    cfg, params, _ = weights
    opts = RuntimeOpts(quantized_kv=True)
    rng = np.random.default_rng(26)
    shared = rng.integers(0, cfg.vocab_size, (GQA_PAGED_PREFIX,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in GQA_PAGED_LENS]
    for i in GQA_PAGED_FORKS:
        prompts[i][:GQA_PAGED_PREFIX] = shared

    def sampling(i):
        kw = dict(prefix_key="shared", prefix_len=GQA_PAGED_PREFIX) \
            if i in GQA_PAGED_FORKS else {}
        return SamplingParams(max_tokens=GQA_PAGED_MAX_TOKENS, **kw)

    kernels = {"decode_attention": da.decode_attention,
               "paged_decode_attention": pda.paged_decode_attention,
               "paged_prefill_attention": ppa.paged_prefill_attention,
               "varlen_attention": va.varlen_attention}
    routed = {k: kernels[k].route_launches for k in
              ("paged_decode_attention", "paged_prefill_attention",
               "varlen_attention")}
    runs, out, checks = {}, {}, {}
    L = cfg.num_layers
    for mode in modes:
        srv = LLMServer(cfg, params, opts, backend="paged", tick_mode=mode,
                        num_pages=513, page_size=16, max_slots=8,
                        max_seq_len=1024, prefill_chunk=256, device=device)
        sched = srv.backend.scheduler
        rec = _record_logits(sched)
        for fn in kernels.values():
            fn.launches = 0
        for r in routed.values():
            r.update(dict.fromkeys(r, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [srv.submit(p, sampling(i)) for i, p in enumerate(prompts)]
        outs = srv.run()
        wall_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        routes = {k: dict(r) for k, r in routed.items()}
        st = sched.stats
        outs = [outs[r] for r in rids]
        runs[mode] = (outs, rec)
        checks.update({
            f"{mode}_lengths": [len(o.tokens) for o in outs]
            == [GQA_PAGED_MAX_TOKENS] * len(prompts),
            f"{mode}_pool_reclaimed": sched.pool.pages_in_use == 0
            and not sched.pool.refcount.any(),
            f"{mode}_prefix_forks": st.prefix_forks
            == len(GQA_PAGED_FORKS) - 1,
            f"{mode}_k1_not_launched": launches["decode_attention"] == 0})
        if mode == "packed":
            checks["packed_k4_launches"] = launches["varlen_attention"] \
                == L * st.packed_ticks > 0
            checks["packed_k4_on_tensor_cores"] = \
                routes["varlen_attention"]["tensor_cores"] \
                == launches["varlen_attention"]
        else:
            checks[f"{mode}_k2_launches"] = \
                launches["paged_decode_attention"] == L * st.steps > 0
            checks[f"{mode}_k3_launches"] = \
                launches["paged_prefill_attention"] \
                == L * st.shared_prefill_calls > 0
            checks[f"{mode}_k3_on_tensor_cores"] = \
                routes["paged_prefill_attention"]["tensor_cores"] \
                == launches["paged_prefill_attention"]
        out[mode] = {"wall_s": wall_s,
                     "tokens_per_s": sum(len(o.tokens) for o in outs)
                     / wall_s, "ticks": sched._tick,
                     "decode_steps": st.steps,
                     "packed_ticks": st.packed_ticks,
                     "shared_prefill_calls": st.shared_prefill_calls,
                     "prefix_forks": st.prefix_forks,
                     "launches": launches, "routes": routes}
        del srv, sched
    first = modes[0]
    outs, rec = runs[first]
    rows = []
    for i, o in enumerate(outs):
        dense = _teacher_forced(params, cfg, prompts[i][None],
                                o.tokens[None], opts, 1024, device)[0]
        rows.append({"err": np.abs(np.stack(rec[o.rid]) - dense).max(-1)
                     / np.abs(dense).max(), "margin": _margins(dense),
                     "got": o.tokens, "want": dense.argmax(-1)})
    report = _moe_hold(rows, PAGED_REL, False, len(rows))
    checks[f"{first}_equal_fused_step_rule"] = report["ok"]
    out[first]["vs_fused"] = report
    for mode in modes[1:]:
        (want, want_rec), (got, got_rec) = runs[first], runs[mode]
        rows = []
        for w, g in zip(want, got):
            wl = np.stack(want_rec[w.rid])
            rows.append({"err": np.abs(np.stack(got_rec[g.rid]) - wl).max(-1)
                         / np.abs(wl).max(), "margin": _margins(wl),
                         "got": g.tokens, "want": w.tokens})
        # streams running free part at the first step whose error crosses
        # a top-1/top-2 gap
        report = _moe_hold(rows, PAGED_REL, True, 1)
        checks[f"{mode}_equal_{first}_step_rule"] = report["ok"]
        out[mode]["vs_" + first] = dict(report, bit_identical_rows=[
            bool(np.array_equal(w.tokens, g.tokens))
            for w, g in zip(want, got)])
    return {"config": cfg.name, "prompt_lens": list(GQA_PAGED_LENS),
            "max_tokens": GQA_PAGED_MAX_TOKENS,
            "shared_prefix": GQA_PAGED_PREFIX,
            "forks": list(GQA_PAGED_FORKS), "tol": PAGED_REL, "runs": out,
            "checks": checks}


def _timed_parts(ctx):
    """(``timed(part, fn, *args, **kw)``: ``fn(ctx, ...)`` with its seconds
    kept under ``part``, the dict of those seconds)."""
    part_s = {}

    def timed(part, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(ctx, *args, **kw)
        part_s[part] = time.perf_counter() - t
        return out

    return timed, part_s


def _free_weights() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _phase_verdict(name, parts, checks) -> None:
    """Fold the parts' checks into one verdict and fail the phase on any."""
    for part, res in parts:
        checks.update({f"{part}_{k}": v for k, v in res["checks"].items()})
    if not all(checks.values()):
        raise SystemExit(f"{name}: failed checks "
                         f"{[k for k, v in checks.items() if not v]}")


def phase_gqa(ctx) -> None:
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    timed, part_s = _timed_parts(ctx)
    # granite-34b's 67.3 GB of bf16 weights and its split's codes leave no
    # room for llama2-7b's, which the earlier phases share; no later phase
    # reads them (``_llama7b_params`` draws them again if asked)
    ctx.pop("params_7b", None)
    _free_weights()
    tiny = {name: timed(name, _family_tiny, name, cfg=_small_config(name))
            for name in ("internlm2-20b", "granite-34b")}
    internlm2 = timed("init_internlm2", _family_params, "internlm2-20b",
                      GQA_INTERNLM2_BLOCKS)
    a = timed("A", _family_fused, "internlm2-20b", internlm2,
              lens=GQA_FUSED_LENS, cache_len=GQA_FUSED_CACHE_LEN,
              max_tokens=GQA_MAX_TOKENS)
    b = timed("B", _dense_paged, internlm2, ("chunked", "packed"))
    c = timed("C", _family_split, "internlm2-20b", internlm2,
              n_new=GQA_SPLIT_MAX_TOKENS)
    del internlm2
    _free_weights()
    granite = timed("init_granite", _family_params, "granite-34b",
                    GQA_GRANITE_BLOCKS)
    d = timed("D", _family_fused, "granite-34b", granite,
              lens=GQA_FUSED_LENS, cache_len=GQA_FUSED_CACHE_LEN,
              max_tokens=GQA_MAX_TOKENS)
    e = timed("E", _dense_paged, granite, ("chunked",))
    f = timed("F", _family_split, "granite-34b", granite,
              n_new=GQA_SPLIT_MAX_TOKENS)
    del granite
    _free_weights()
    checks = {f"tiny_{k}": v["ok"] for k, v in tiny.items()}
    report = {"phase": "gqa", "nvidia_smi": ctx["smi"], "tiny": tiny,
              "granite_blocks": [GQA_GRANITE_BLOCKS,
                                 get_config("granite-34b").num_blocks],
              "internlm2_blocks": [GQA_INTERNLM2_BLOCKS,
                                   get_config("internlm2-20b").num_blocks],
              "A_internlm2_fused": a, "B_internlm2_paged": b,
              "C_internlm2_split": c, "D_granite_fused": d,
              "E_granite_paged": e, "F_granite_split": f,
              "phase_s": time.perf_counter() - t0, "part_s": part_s,
              "checks": checks}
    try:
        _phase_verdict("gqa", (("A", a), ("B", b), ("C", c), ("D", d),
                              ("E", e), ("F", f)), checks)
    finally:
        report["ok"] = all(checks.values())
        emit(report)


# the state-space configs (ROADMAP queue 1 item 9.2): mamba2-780m at full
# width, its f32 holds at full depth, its bf16 runs (A, B) over 12 of its
# 48 blocks (both measured at full depth in PRs 26 and 27; cut to 24 to
# make room for the planner and the 12-bit split, to 16 for the train
# phase, to 12 for the sharded one, to 9 for the train phase's mesh parts:
# one layer past FAMILY_SPLIT_LAYER); jamba-v0.1-52b at full width
# over 2 of its 4 blocks (16 of 32 layers: 2 attention, 14 Mamba-2, 8 MoE;
# all 4 blocks are 103 GB of bf16), served dropless; random bf16 weights,
# int8 KV
SSM_MAMBA2_BLOCKS = 9
SSM_JAMBA_BLOCKS = 2
SSM_JAMBA_LENS = (1024, 1024, 256, 256)
SSM_JAMBA_CACHE_LEN = 1152
SSM_JAMBA_MAX_TOKENS = (32, 32, 32, 32)
SSM_SPLIT_MAX_TOKENS = 16  # mamba2's split: the split phase's prompts
SSM_STATE_LEN = 256  # the bf16-state run: two prompts of this many tokens
SSM_STATE_STEPS = 32
# the recurrence hold: two prompts of FAMILY_LENS[0] tokens, then this many
# decode steps, each against a prefill of the same tokens
SSM_RECURRENCE_STEPS = 8


def _ssm_f32_holds(ctx) -> dict:
    """mamba2-780m at full width and depth on f32 weights (seed 0, 3.1 GB),
    where bf16 rounding does not hide the algorithm: (a) the step
    recurrence against the chunked prefill, two prompts of FAMILY_LENS[0]
    tokens, then SSM_RECURRENCE_STEPS decode steps, step j's logits against
    a prefill of the same S + j tokens (17 chunks of 256) within MODEL_REL
    of the largest logit, their tokens equal wherever the prefill's
    top-1/top-2 margin exceeds it, and the final recurrent states alike (the
    conv state kept in f32, ``cache_dtype="float32"``: a bf16 conv state
    rounds the f32 inputs it keeps); (b) ``ssm_state_dtype="bfloat16"``
    against the f32 state: the recurrent states' bytes halved; two
    SSM_STATE_LEN-token prompts decoded greedily with the f32 state, then
    fed the same tokens with the bf16 state, every step within INT8_BOUND
    of the largest logit (the reference's bound on a cache stored at lower
    precision) and the tokens equal where the margin exceeds it; the bf16
    state's own greedy stream held to the f32 one up to the first step
    where they part (``_moe_hold``, no route record)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import (RuntimeOpts, decode_step,
                                                init_caches, prefill)
    from repro_torch.params import init_params

    device = ctx["device"]
    cfg = get_config("mamba2-780m")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         torch.float32, device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(28)

    # (a) the recurrence against the chunked prefill
    s, n = FAMILY_LENS[0], SSM_RECURRENCE_STEPS
    opts = RuntimeOpts(quantized_kv=True, cache_dtype="float32")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, s + n)),
                           device=device)
    stepped, refs = [], []
    with torch.inference_mode():
        _, caches = prefill(params, cfg, toks[:, :s], s + n, opts)
        for j in range(n):
            lg, caches = decode_step(params, cfg, toks[:, s + j:s + j + 1],
                                     caches, s + j, opts)
            stepped.append(lg.float().cpu().numpy())
            ref, full = prefill(params, cfg, toks[:, :s + j + 1], s + n, opts)
            refs.append(ref.float().cpu().numpy())
        state_err = max(float((a[1] - b[1]).abs().max() / b[1].abs().max())
                        for a, b in zip(caches, full))
    stepped, refs = np.stack(stepped, 1), np.stack(refs, 1)  # (2, n, V)
    err = np.abs(stepped - refs).max(-1) / np.abs(refs).max()
    margin = _margins(refs)
    rows = [{"err": err[r], "margin": margin[r],
             "got": stepped[r].argmax(-1), "want": refs[r].argmax(-1)}
            for r in range(2)]
    recurrence = _moe_hold(rows, MODEL_REL, False, 1)
    recurrence.update(prompt_len=s, steps=n, final_state_rel_err=state_err,
                      rel_logit_err_by_step=err.max(0).tolist())

    # (b) the bf16 state against the f32 state
    f32 = RuntimeOpts(quantized_kv=True)
    bf16 = RuntimeOpts(quantized_kv=True, ssm_state_dtype="bfloat16")
    meta = torch.device("meta")
    state_bytes = {
        name: sum(c[1].numel() * c[1].element_size() for c in init_caches(
            cfg, 2, 1, o, meta))
        for name, o in (("float32", f32), ("bfloat16", bf16))}
    prompts = rng.integers(0, cfg.vocab_size, (2, SSM_STATE_LEN))
    cache_len = SSM_STATE_LEN + SSM_STATE_STEPS
    want, want_lg = _greedy_stepwise(params, cfg, prompts, SSM_STATE_STEPS,
                                     f32, cache_len, device)
    forced = _teacher_forced(params, cfg, prompts, want, bf16, cache_len,
                             device)
    got, _ = _greedy_stepwise(params, cfg, prompts, SSM_STATE_STEPS, bf16,
                              cache_len, device)
    err = np.abs(forced - want_lg).max(-1) / np.abs(want_lg).max()
    margin = _margins(want_lg)
    teacher = _moe_hold([{"err": err[r], "margin": margin[r],
                          "got": forced[r].argmax(-1), "want": want[r]}
                         for r in range(2)], INT8_BOUND, False, 1)
    free = _moe_hold([{"err": err[r], "margin": margin[r], "got": got[r],
                       "want": want[r]} for r in range(2)], INT8_BOUND,
                     True, 1)
    del params, caches, full
    _free_weights()
    checks = {"recurrence_equals_chunked_prefill": recurrence["ok"],
              "bf16_state_bytes_halved": state_bytes["bfloat16"] * 2
              == state_bytes["float32"],
              "bf16_state_teacher_forced": teacher["ok"],
              "bf16_state_stream": free["ok"]}
    return {"config": cfg.name, "weights": "float32", "init_s": init_s,
            "recurrence": recurrence,
            "bf16_state": {"state_bytes_b2": state_bytes,
                           "prompt_len": SSM_STATE_LEN,
                           "steps": SSM_STATE_STEPS,
                           "rel_logit_err_by_step": err.max(0).tolist(),
                           "teacher_forced": teacher, "free": free,
                           "bit_identical_rows": [
                               bool(np.array_equal(g, w))
                               for g, w in zip(got, want)]},
            "checks": checks}


def phase_ssm(ctx) -> None:
    t0 = time.perf_counter()
    timed, part_s = _timed_parts(ctx)
    # f32 conv states: a bf16 one rounds the f32 inputs it keeps, a
    # boundary the CPU and the card can land on either side of
    tiny_kw = dict(cache_dtype="float32")
    tiny = {"mamba2-780m-tiny": timed("mamba2-780m-tiny", _family_tiny,
                                      "mamba2-780m-tiny", tiny_kw),
            "jamba-v0.1-52b-small": timed(
                "jamba-v0.1-52b-small", _family_tiny, "jamba-v0.1-52b",
                dict(MOE_OPTS, **tiny_kw),
                cfg=_small_config("jamba-v0.1-52b"))}
    holds = timed("f32_holds", _ssm_f32_holds)
    mamba = timed("init_mamba2", _family_params, "mamba2-780m",
                  SSM_MAMBA2_BLOCKS)
    # on bf16 weights the state integrates each step's rounding
    # differences: the step-against-prefill comparison is reported here and
    # held on f32 weights (_ssm_f32_holds)
    a = timed("A", _family_fused, "mamba2-780m", mamba,
              max_tokens=(32, 24, 32, 16), tf_held=False)
    b = timed("B", _family_split, "mamba2-780m", mamba,
              n_new=SSM_SPLIT_MAX_TOKENS)
    del mamba
    _free_weights()
    jamba = timed("init_jamba", _family_params, "jamba-v0.1-52b",
                  SSM_JAMBA_BLOCKS)
    c = timed("C", _family_fused, "jamba-v0.1-52b", jamba,
              lens=SSM_JAMBA_LENS, cache_len=SSM_JAMBA_CACHE_LEN,
              max_tokens=SSM_JAMBA_MAX_TOKENS, opts_kw=MOE_OPTS)
    d = timed("D", _family_split, "jamba-v0.1-52b", jamba, opts_kw=MOE_OPTS,
              n_new=MOE_SPLIT_MAX_TOKENS)
    del jamba
    _free_weights()
    checks = {f"tiny_{k}": v["ok"] for k, v in tiny.items()}
    report = {"phase": "ssm", "nvidia_smi": ctx["smi"], "tiny": tiny,
              "f32_holds": holds, "A_mamba2_fused": a, "B_mamba2_split": b,
              "C_jamba_fused": c, "D_jamba_split": d,
              "phase_s": time.perf_counter() - t0, "part_s": part_s,
              "checks": checks}
    try:
        _phase_verdict("ssm", (("f32", holds), ("A", a), ("B", b),
                               ("C", c), ("D", d)), checks)
    finally:
        report["ok"] = all(checks.values())
        emit(report)


# the vision-stub and codebook configs (ROADMAP queue 1 items 9.3 and 9.4):
# qwen2-vl-2b and musicgen-medium at full width (over ``MODAL_*_BLOCKS``),
# random bf16 weights, int8 KV. A: qwen2-vl's text prompts through the fused backend
# as the families phase checks them, then the Engine over 1,024 projected
# patch slots and 128 text tokens; B: the paged backend (``GQA_PAGED_*``),
# chunked then packed; C: the split at l = 8; D: musicgen through the
# Engine on (B, S, 4) codebook prompts; E: its split; F: the dense-gather
# route (``paged_prefill_kernel=False``) on some of B's requests
MODAL_FUSED_LENS = (512, 512, 128, 128)
MODAL_FUSED_CACHE_LEN = 640
MODAL_MAX_TOKENS = (16, 16, 16, 16)
MODAL_TEXT = 128  # A: text tokens after qwen2-vl's 1,024 patch slots
MODAL_VLM_NEW = 16
MODAL_MUSIC_LEN = 512  # D: musicgen's prompts (2, 512, 4)
MODAL_MUSIC_NEW = 32
MODAL_SPLIT_LEN = 96  # E: musicgen's split prompts (2, 96, 4)
MODAL_SPLIT_NEW = 8
MODAL_GATHER_REQUESTS = (0, 2, 5, 6)  # F: two long prompts, two forks
MODAL_TINY = ("qwen2-vl-2b", "musicgen-medium")
# qwen2-vl-2b over its first 12 of 28 blocks and musicgen-medium over 16 of
# 48: both were measured at full depth (PERF.md, PR 27's and 28's runs);
# cut to make room for the train phase (16 and 24), then the sharded one
# (12 and 16), then the train phase's mesh parts (9: one layer past
# FAMILY_SPLIT_LAYER)
MODAL_QWEN2_VL_BLOCKS = 9
MODAL_MUSICGEN_BLOCKS = 9


def _unread_bytes(params) -> int:
    """Bytes of the weights a decode step does not read in full: the
    embedding beside an untied head (the step gathers B of its rows;
    qwen2-vl's head is untied under ``tie_embeddings=True``) and the vision
    stub's projector (read by a prefill with patches only)."""
    n = 0
    for key in ("embed", "w_proj"):
        if key in params and (key == "w_proj" or "lm_head" in params):
            n += params[key].numel() * params[key].element_size()
    return n


def _modal_inputs(cfg, b, s, rng):
    """Prompts (B, S), or (B, S, K) on a codebook config, and the vision
    stub's patch embeddings (B, num_patches, d_vision) f32 (None without
    one), from ``rng``."""
    import numpy as np

    shape = (b, s) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                      else ())
    prompts = rng.integers(0, cfg.vocab_size, shape)
    patches = None
    if cfg.embed == "vlm":
        patches = rng.normal(size=(b, cfg.num_patches, cfg.d_vision)) \
            .astype(np.float32)
    return prompts, patches


def _modal_tiny(ctx, name) -> dict:
    """The config at small widths with its full-width group (``_small_config``:
    qwen2-vl G 6 over 8 patch slots; musicgen's codebooks and sinusoidal
    positions), f32 weights, int8 KV, 20-token prompts (qwen2-vl's first 8
    rows projected patches): greedy on the CPU (plain versions) against the
    card (kernels) fed the same tokens, logits within MODEL_REL; the card's
    Engine tokens under the margin rule, each codebook a row."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.engine import Engine

    device = ctx["device"]
    cfg = _small_config(name)
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = {k: v.to(device) for k, v in cpu.items()}
    prompts, patches = _modal_inputs(cfg, 3, 20, np.random.default_rng(0))
    n, cache_len = 24, 64
    want, want_lg = _greedy_stepwise(cpu, cfg, prompts, n, opts, cache_len,
                                     "cpu", patches=patches)
    got_lg = _teacher_forced(card, cfg, prompts, want, opts, cache_len,
                             device, patches=patches)
    rel = float(np.abs(got_lg - want_lg).max() / np.abs(want_lg).max())
    got = Engine(cfg, card, opts, cache_len=cache_len, device=device) \
        .generate(prompts, n, patches=patches).tokens[:, 20:]
    if cfg.num_codebooks > 1:  # each (row, codebook) a row of the rule
        k, v = cfg.num_codebooks, cfg.vocab_size
        got, want = (t.transpose(0, 2, 1).reshape(-1, n) for t in (got, want))
        want_lg = want_lg.transpose(0, 2, 1, 3).reshape(-1, n, v)
        assert got.shape[0] == 3 * k
    ok, compared = _margin_agreement(got, want, want_lg, MODEL_REL)
    return {"config": cfg.name, "groups": cfg.pattern[0].mixer.num_heads
            // cfg.pattern[0].mixer.num_kv_heads, "steps": n,
            "max_rel_logit_err": rel, "tol": MODEL_REL,
            "tokens_compared": compared, "ok": ok and rel <= MODEL_REL}


def _modal_engine(ctx, weights, prompts, n_new, patches=None) -> dict:
    """``Engine.generate`` at full width (``weights`` (cfg, params,
    seconds); B 2) over ``prompts`` (B, S) with the vision stub's
    ``patches``, or codebook prompts (B, S, K): K1's counter set to 0 just
    before the timed run and read just after (once a layer and decode
    step); tokens (B, S + n_new[, K]) in the vocabulary, the prompt kept, a
    repeat equal; row 0's first FAMILY_TF_STEPS decode steps fed the
    Engine's tokens, bit for bit the Engine's argmax, within the
    reference's int8 bound of an unquantized prefill's (patches included);
    K1 equal to its plain version on the last step's calls. Timed: the
    prefill, a decode step at B 2 (host included; device busy) beside the
    bytes it must read."""
    import gc

    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import (RuntimeOpts, decode_step,
                                                prefill)
    from repro_torch.serving.engine import Engine

    device = ctx["device"]
    cfg, params, _ = weights
    opts = RuntimeOpts(quantized_kv=True)
    b, s = prompts.shape[:2]
    cache_len = s + n_new
    eng = Engine(cfg, params, opts, cache_len=cache_len, device=device)
    first = eng.generate(prompts, n_new, patches=patches)
    da.decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, n_new, patches=patches)
    wall_s = time.perf_counter() - t0
    launches = da.decode_attention.launches
    gen = res.tokens[:, s:]
    checks = {
        "shape": res.tokens.shape == (b, s + n_new) + prompts.shape[2:]
        and res.logprobs.shape == (b, n_new) + prompts.shape[2:],
        "prompt_kept": bool(np.array_equal(res.tokens[:, :s], prompts)),
        "tokens_in_vocab": int(gen.min()) >= 0
        and int(gen.max()) < cfg.vocab_size,
        "logprobs_finite": bool(np.isfinite(res.logprobs).all()
                                and (res.logprobs <= 0).all()),
        "same_as_first_run": bool(np.array_equal(res.tokens, first.tokens)),
        "k1_launches": launches == cfg.num_layers * (n_new - 1)}
    del eng, first
    steps = min(FAMILY_TF_STEPS, n_new - 1)
    plain = RuntimeOpts(quantized_kv=False)
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device=device)
        forced = torch.as_tensor(gen, device=device)
        pt = None if patches is None else torch.as_tensor(patches,
                                                          device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, toks, cache_len, opts, pt)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        stepped = []
        for t in range(steps):
            logits, caches = decode_step(params, cfg, forced[:, t:t + 1],
                                         caches, s + t, opts)
            stepped.append(logits.float().cpu())
        step_tok = np.stack([lg.argmax(-1).numpy() for lg in stepped], 1)
        checks["steps_equal_engine_tokens"] = bool(np.array_equal(
            step_tok, gen[:, 1:steps + 1]))
        tf_rel = []
        for j in range(1, steps + 1):
            full = torch.cat([toks[:1], forced[:1, :j]], dim=1)
            ref, _ = prefill(params, cfg, full, None, plain,
                             None if pt is None else pt[:1])
            ref = ref.float().cpu()
            tf_rel.append(float((stepped[j - 1][:1] - ref).abs().max()
                                / ref.abs().max()))
        checks["int8_within_reference_bound"] = max(tf_rel) < INT8_BOUND
        # the last generated token fed at the last position, every layer's
        # K1 call recorded
        q_pos = s + n_new - 1
        nxt = forced[:, n_new - 1:]
        pos = torch.tensor(q_pos, dtype=torch.int32, device=device)
        seen, real = [], ops.decode_attention

        def record(*args):
            seen.append(args)
            return real(*args)

        ops.decode_attention = record
        try:
            decode_step(params, cfg, nxt, caches, pos, opts)
        finally:
            ops.decode_attention = real
        checks["k1_calls_last_step"] = len(seen) == cfg.num_layers
        k1_err = max(float((da.decode_attention(*a)
                            - da.decode_attention_ref(*a)).abs().max())
                     for a in seen)
        checks["k1_equals_plain_on_caches"] = k1_err <= ATOL
        step = lambda: decode_step(params, cfg, nxt, caches, pos, opts)  # noqa: E731
        step_ms = ctx["timer"]({"step": step}, iters=20,
                               device_only=False)["step"]
        device_ms, rows = _device_profile(torch, step, STEP_PROFILE_N)
    bw, _ = peak_rates(ctx["device_name"])
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    read = weight_bytes - _unread_bytes(params)
    for c, ls in zip(caches, cfg.pattern * cfg.num_blocks):
        m = ls.mixer
        read += b * min(c.pos.shape[1], q_pos + 1) * (
            m.num_kv_heads * (2 * m.head_dim + 8) + 4)
    out = {"config": cfg.name, "prompt": list(prompts.shape),
           "patches": None if patches is None else list(patches.shape),
           "new": n_new, "cache_len": cache_len, "k1_launches": launches,
           "wall_s": wall_s, "tokens_per_s": b * n_new / wall_s,
           "prefill_s": prefill_s, "int8_rel_err_per_step": tf_rel,
           "int8_bound": INT8_BOUND, "k1_max_abs_err_on_caches": k1_err,
           "decode_step_b2": {
               "q_pos": q_pos, "host_included_ms": step_ms,
               "device_busy_ms": device_ms,
               "idle_share": 1 - device_ms / step_ms, "bytes_read": read,
               "bound_ms": read / bw * 1e3,
               "gemm_in_step": _kernel_share(rows, GEMM_DEVICE_NAMES),
               "k1_in_step": _kernel_share(rows, K1_DEVICE_NAMES),
               "profile_top": rows[:8]},
           "checks": checks}
    del caches, seen
    gc.collect()
    return out


def _codebook_split(ctx, weights) -> dict:
    """musicgen at full width through ``SplitEngine`` at l =
    FAMILY_SPLIT_LAYER with the paper's OPSC defaults on (2,
    MODAL_SPLIT_LEN, 4) prompts, MODAL_SPLIT_NEW tokens (LLMServer takes
    1-D prompts, so the engine is driven directly), the counters set to 0
    just before the run and read just after: K1 once a layer and decode
    step, K5 and K6 once a payload, K7 once an edge projection and payload;
    tokens (B, S + n, 4); the payloads held to their plain versions; an
    uncompressed full-precision split equal to the Engine bit for bit; one
    decode step by stage."""
    import gc

    import numpy as np
    import torch
    from repro_torch.core.opsc import OPSCConfig
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import tabq_quantize as tq
    from repro_torch.kernels import ts_mask as tsm
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.split_engine import SplitEngine

    device = ctx["device"]
    cfg, params, _ = weights
    opts = RuntimeOpts(quantized_kv=True)
    opsc = OPSCConfig(split_layer=FAMILY_SPLIT_LAYER, qw_front=4)
    prompts, _ = _modal_inputs(cfg, 2, MODAL_SPLIT_LEN,
                               np.random.default_rng(14))
    n_new, cache_len = MODAL_SPLIT_NEW, MODAL_SPLIT_LEN + MODAL_SPLIT_NEW
    eng = SplitEngine(cfg, params, opsc, opts=opts, cache_len=cache_len,
                      device=device)
    held = []

    def compress(h):  # keeps the first payloads' hidden states
        if len(held) < 4:
            held.append(h.detach().clone())
        return SplitEngine._compress(eng, h)

    eng._compress = compress
    kernels = {"decode_attention": da.decode_attention,
               "tabq_adaptive": tq.tabq_adaptive, "ts_encode": tsm.ts_encode,
               "dequant_matmul": dm.dequant_matmul}
    for fn in kernels.values():
        fn.launches = 0
    k7_routes = dm.dequant_matmul.route_launches
    k7_routes.update(dict.fromkeys(k7_routes, 0))
    t0 = time.perf_counter()
    toks, stats = eng.generate(prompts, n_new)
    wall_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    k7_routes = dict(k7_routes)
    del eng._compress
    payloads = _payloads_identical(held, opsc)
    blocks = opsc.split_layer // len(cfg.pattern)
    checks = {
        "shape": toks.shape == (2, MODAL_SPLIT_LEN + n_new, 4),
        "tokens_in_vocab": int(toks.min()) >= 0
        and int(toks.max()) < cfg.vocab_size,
        "payloads_identical_to_plain": payloads["identical"],
        "k1_launches": launches["decode_attention"]
        == cfg.num_layers * (n_new - 1),
        "k5_k6_launches": launches["tabq_adaptive"] == launches["ts_encode"]
        == n_new,
        "k7_launches": launches["dequant_matmul"]
        == _k7_per_edge_block(cfg) * blocks * n_new,
        "no_early_exit": stats.early_exits == 0}
    by_stage = _split_stages(ctx, eng, opts, prompts[:1], cache_len,
                             STEP_PROFILE_N)
    edge_bytes = eng.edge_weight_bytes()
    del eng, held
    gc.collect()
    full = SplitEngine(cfg, params, OPSCConfig(
        split_layer=FAMILY_SPLIT_LAYER, qw_front=16), opts=opts,
        cache_len=cache_len, device=device)
    t16, _ = full.generate(prompts, n_new, compress=False)
    del full
    want = Engine(cfg, params, opts, cache_len=cache_len,
                  device=device).generate(prompts, n_new)
    checks["uncompressed_fp_front_equals_engine"] = bool(
        np.array_equal(t16, want.tokens))
    gc.collect()
    torch.cuda.empty_cache()
    stage_ms, device_ms = by_stage["host_included_ms"], \
        by_stage["device_busy_ms"]
    return {"config": cfg.name, "opsc": vars(opsc),
            "prompt": list(prompts.shape), "new": n_new, "wall_s": wall_s,
            "launches": launches, "k7_routes": k7_routes,
            "payload_check": payloads,
            "uplink_bits_measured": stats.uplink_bits_measured,
            "edge_weight_bytes": edge_bytes,
            "decode_step_b1": {
                "host_included_ms": stage_ms, "device_busy_ms": device_ms,
                "decode_payload_bits": by_stage["bits"],
                "k7_in_edge": _kernel_share(by_stage["profiles"]["edge"],
                                            K7_DEVICE_NAMES),
                "profile_top": by_stage["top"][:8]},
            "checks": checks}


def _gather_route(ctx, weights) -> dict:
    """The paged pool's dense-gather route at full width: some of
    ``_dense_paged``'s requests (``MODAL_GATHER_REQUESTS``: two long
    prompts and two forks of the 256-token prefix) through
    LLMServer(backend="paged") chunked, first with K3 (the default), then
    with ``RuntimeOpts(paged_prefill_kernel=False)``, which gathers the
    pool dense into ``chunked_attention`` for every continuation chunk and
    fork; the counters set to 0 just before each run and read just after
    (K3 once a layer and chunk call in the first, never in the second; K2
    once a layer and decode step in both); the second's streams held to
    the first's step by step within PAGED_REL (``_moe_hold`` with no route
    record), no page left."""
    import numpy as np
    import torch
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.kernels import paged_decode_attention as pda
    from repro_torch.kernels import paged_prefill_attention as ppa
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.api import LLMServer

    device = ctx["device"]
    cfg, params, _ = weights
    rng = np.random.default_rng(26)  # _dense_paged's requests
    shared = rng.integers(0, cfg.vocab_size, (GQA_PAGED_PREFIX,))
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in GQA_PAGED_LENS]
    for i in GQA_PAGED_FORKS:
        prompts[i][:GQA_PAGED_PREFIX] = shared
    L = cfg.num_layers
    runs, out, checks = [], {}, {}
    for kernel in (True, False):
        opts = RuntimeOpts(quantized_kv=True, paged_prefill_kernel=kernel)
        srv = LLMServer(cfg, params, opts, backend="paged",
                        tick_mode="chunked", num_pages=513, page_size=16,
                        max_slots=8, max_seq_len=1024, prefill_chunk=256,
                        device=device)
        sched = srv.backend.scheduler
        rec = _record_logits(sched)
        for fn in (pda.paged_decode_attention, ppa.paged_prefill_attention):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [srv.submit(prompts[i], SamplingParams(
            max_tokens=GQA_PAGED_MAX_TOKENS,
            **(dict(prefix_key="shared", prefix_len=GQA_PAGED_PREFIX)
               if i in GQA_PAGED_FORKS else {})))
            for i in MODAL_GATHER_REQUESTS]
        outs = srv.run()
        wall_s = time.perf_counter() - t0
        st = sched.stats
        k2, k3 = (pda.paged_decode_attention.launches,
                  ppa.paged_prefill_attention.launches)
        name = "k3" if kernel else "dense_gather"
        checks[f"{name}_k2_launches"] = k2 == L * st.steps > 0
        checks[f"{name}_k3_launches"] = (
            k3 == L * st.shared_prefill_calls > 0 if kernel else k3 == 0)
        checks[f"{name}_chunk_calls"] = st.shared_prefill_calls > 0
        checks[f"{name}_pool_reclaimed"] = sched.pool.pages_in_use == 0
        outs = [outs[r] for r in rids]
        runs.append((outs, rec))
        out[name] = {"wall_s": wall_s, "decode_steps": st.steps,
                     "shared_prefill_calls": st.shared_prefill_calls,
                     "prefix_forks": st.prefix_forks, "k2_launches": k2,
                     "k3_launches": k3}
        del srv, sched
    (want, want_rec), (got, got_rec) = runs
    rows = []
    for w, g in zip(want, got):
        wl = np.stack(want_rec[w.rid])
        rows.append({"err": np.abs(np.stack(got_rec[g.rid]) - wl).max(-1)
                     / np.abs(wl).max(), "margin": _margins(wl),
                     "got": g.tokens, "want": w.tokens})
    report = _moe_hold(rows, PAGED_REL, True, 1)
    checks["dense_gather_equals_k3_step_rule"] = report["ok"]
    out["vs_k3"] = dict(report, bit_identical_rows=[
        bool(np.array_equal(w.tokens, g.tokens)) for w, g in zip(want, got)])
    return {"config": cfg.name, "requests": list(MODAL_GATHER_REQUESTS),
            "tol": PAGED_REL, "runs": out, "checks": checks}


def phase_modal(ctx) -> None:
    import numpy as np

    t0 = time.perf_counter()
    timed, part_s = _timed_parts(ctx)
    tiny = {name: timed(f"{name}-small", _modal_tiny, name)
            for name in MODAL_TINY}
    vlm = timed("init_qwen2_vl", _family_params, "qwen2-vl-2b",
                MODAL_QWEN2_VL_BLOCKS)
    a = timed("A", _family_fused, "qwen2-vl-2b", vlm,
              lens=MODAL_FUSED_LENS, cache_len=MODAL_FUSED_CACHE_LEN,
              max_tokens=MODAL_MAX_TOKENS)
    cfg = vlm[0]
    prompts, patches = _modal_inputs(cfg, 2, cfg.num_patches + MODAL_TEXT,
                                     np.random.default_rng(27))
    a_patches = timed("A_patches", _modal_engine, vlm, prompts,
                      MODAL_VLM_NEW, patches)
    b = timed("B", _dense_paged, vlm, ("chunked", "packed"))
    c = timed("C", _family_split, "qwen2-vl-2b", vlm,
              n_new=GQA_SPLIT_MAX_TOKENS)
    f = timed("F", _gather_route, vlm)
    del vlm
    _free_weights()
    music = timed("init_musicgen", _family_params, "musicgen-medium",
                  MODAL_MUSICGEN_BLOCKS)
    prompts, _ = _modal_inputs(music[0], 2, MODAL_MUSIC_LEN,
                               np.random.default_rng(28))
    d = timed("D", _modal_engine, music, prompts, MODAL_MUSIC_NEW)
    e = timed("E", _codebook_split, music)
    del music
    _free_weights()
    checks = {f"tiny_{k}": v["ok"] for k, v in tiny.items()}
    report = {"phase": "modal", "nvidia_smi": ctx["smi"], "tiny": tiny,
              "A_qwen2_vl_fused": a, "A_qwen2_vl_patches": a_patches,
              "B_qwen2_vl_paged": b, "C_qwen2_vl_split": c,
              "D_musicgen_engine": d, "E_musicgen_split": e,
              "F_dense_gather": f,
              "phase_s": time.perf_counter() - t0, "part_s": part_s,
              "checks": checks}
    try:
        _phase_verdict("modal", (("A", a), ("A_patches", a_patches),
                                 ("B", b), ("C", c), ("D", d), ("E", e),
                                 ("F", f)), checks)
    finally:
        report["ok"] = all(checks.values())
        emit(report)


# the train phase: run A, the launcher at full width (llama2-7b's first 4
# of 32 blocks: f32 weights, grads and AdamW's two moments of its 1.07 B
# parameters are 17 GB, all 32 blocks' 108 GB would not fit the card);
# run B, one step at full width over 1 block, card against CPU, on a
# 64-token batch; run C, the induction vehicle trained from the port's
# init (``benchmarks/common.py``'s settings); run D, the straight-through
# codec at a 128-token prefill payload
TRAIN_ARGV = ("--arch", "llama2-7b", "--num-blocks", "4", "--batch", "4",
              "--seq", "512", "--accum", "2", "--steps", "8")
# run A's steps profiled, each on its own (a profiled step's host time
# grows by about 1%; its profile's processing, about 1.5 s, falls between
# steps)
TRAIN_PROFILED = (1, 7)
TRAIN_B_BATCH = (2, 32)  # run B: 64 tokens, two rows for accum 2
TRAIN_VEHICLE = dict(vocab=64, blocks=4, batch=32, seq=33, steps=250,
                     lr=3e-3, warmup=20)
TRAIN_STE_SHAPE = (128, 4096)
# tests/test_torch_train_families.py's bars: loss relative, and a leaf's
# gradient against the largest entry of that leaf
TRAIN_LOSS_REL = 2e-6
TRAIN_GRAD_REL = 5e-5


def _flag(argv, name) -> int:
    """The integer value of ``name``'s last occurrence in ``argv``."""
    return int(argv[len(argv) - argv[::-1].index(name)])


def _leaf_err(got: dict, want: dict) -> tuple:
    """(the worst leaf, its largest |got - want| over its largest |want|)."""
    errs = {}
    for k, w in want.items():
        w = w.float().cpu()
        g = got[k].float().cpu()
        errs[k] = float((g - w).abs().max() / max(float(w.abs().max()),
                                                  1e-30))
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _step_grads(params, cfg, batch, opts) -> tuple:
    """(loss, {key: grad}) of ``train_loop.loss_fn`` on ``batch``."""
    import torch
    from repro_torch.training.train_loop import loss_fn

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = loss_fn(leaves, cfg, batch, opts)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss), dict(zip(leaves, grads))


def _train_launcher(ctx) -> dict:
    """Run A: ``launch.train.main`` at full width. Each step's host-clock
    ms and its device span (CUDA events recorded as the step starts and
    after its readback); the steps of ``TRAIN_PROFILED`` each profiled on
    their own (device-busy ms, idle share; the last one's kernels);
    tokens/s and the peak memory. Step 0 follows the launcher's setup and
    carries the first calls' costs."""
    import math

    import torch
    from repro_torch.launch import train as launcher

    argv = list(TRAIN_ARGV)
    tokens = _flag(argv, "--batch") * _flag(argv, "--seq")
    n = _flag(argv, "--steps")
    starts, ends, busy = [None] * n, [None] * n, [None] * n
    prof, rows = [None], []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def on_step(i, row):
        ends[i] = event()
        if prof[0] is not None:
            prof[0].stop()
            busy[i], rows[:] = _profile_rows(torch, prof[0])
            prof[0] = None
        if i + 1 in TRAIN_PROFILED:
            prof[0] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof[0].start()
        if i + 1 < n:
            starts[i + 1] = event()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = launcher.main(argv, on_step=on_step)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steps = [{"step": i, "loss": h["loss"], "grad_norm": h["grad_norm"],
              "lr": h["lr"], "host_ms": h["host_ms"],
              "device_span_ms": None if starts[i] is None
              else starts[i].elapsed_time(ends[i]),
              "tokens_per_s": tokens / (h["host_ms"] / 1e3),
              "busy_ms": busy[i],
              "idle_share": None if busy[i] is None
              else 1 - busy[i] / h["host_ms"]}
             for i, h in enumerate(hist)]
    checks = {"steps": len(hist) == n,
              "finite": all(math.isfinite(h["loss"])
                            and math.isfinite(h["grad_norm"]) for h in hist),
              "profiled": all(busy[i] is not None and busy[i] > 0
                              for i in TRAIN_PROFILED)}
    return {"argv": argv, "tokens_per_step": tokens, "steps": steps,
            "peak_gb": peak / 1e9, "last_step_kernels": rows[:12],
            "checks": checks}


def _train_card_cpu(ctx) -> dict:
    """Run B: llama2-7b at full width over 1 block, f32 weights drawn on the
    card from seed 0 and copied to the CPU: one 64-token batch's loss and
    every leaf's gradient on the card against the CPU's, remat on against
    off on the card, and one train step with accum 1 against accum 2 (the
    reference test's bars: loss within 1e-4, parameters within 5e-3)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ZipfMarkov, make_batch
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, make_train_step

    device = ctx["device"]
    cfg = dataclasses.replace(get_config("llama2-7b"), num_blocks=1)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(1),
                         device=device)
    b, s = TRAIN_B_BATCH
    corpus = ZipfMarkov(cfg.vocab_size, branching=8, seed=0)
    host = make_batch(corpus.sample(np.random.default_rng(2), b, s))
    on = {dev: {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
          for dev in (device, "cpu")}
    opts = RuntimeOpts(q_chunk=s, kv_chunk=s, remat=True)
    loss_card, g_card = _step_grads(params, cfg, on[device], opts)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    loss_cpu, g_cpu = _step_grads(cpu_params, cfg, on["cpu"], opts)
    del cpu_params
    _mark(ctx, "B_cpu")
    worst, err = _leaf_err(g_card, g_cpu)
    del g_cpu
    loss_off, g_off = _step_grads(params, cfg, on[device],
                                  dataclasses.replace(opts, remat=False))
    remat_worst, remat_err = _leaf_err(g_off, g_card)
    remat_bits = all(torch.equal(g_off[k], g_card[k]) for k in g_card)
    del g_off, g_card
    state = adamw_init(params)
    out = {}
    for accum in (1, 2):
        tc = TrainConfig(AdamWConfig(lr=1e-2, warmup_steps=0,
                                     total_steps=10), accum_steps=accum)
        out[accum] = make_train_step(cfg, tc, opts)(params, state, on[device])
    (p1, _, m1), (p2, _, m2) = out[1], out[2]
    accum_dp = max(float((p1[k] - p2[k]).abs().max()) for k in p1)
    accum_loss = (float(m1["loss"]), float(m2["loss"]))
    del out, p1, p2
    checks = {
        "loss_card_cpu": abs(loss_card - loss_cpu)
        <= TRAIN_LOSS_REL * abs(loss_cpu),
        "grads_card_cpu": err <= TRAIN_GRAD_REL,
        "remat_loss": loss_off == loss_card,
        "remat_grads": remat_err <= TRAIN_GRAD_REL,
        "accum_loss": abs(accum_loss[0] - accum_loss[1])
        <= 1e-4 * abs(accum_loss[0]),
        "accum_params": accum_dp < 5e-3}
    return {"config": cfg.name, "blocks": 1, "batch": [b, s],
            "loss_card": loss_card, "loss_cpu": loss_cpu,
            "grad_worst_leaf": worst, "grad_worst_rel": err,
            "remat_worst_leaf": remat_worst, "remat_worst_rel": remat_err,
            "remat_grads_bit_equal": remat_bits,
            "accum_1_2_loss": list(accum_loss),
            "accum_1_2_max_param_diff": accum_dp,
            "tol": {"loss_rel": TRAIN_LOSS_REL, "grad_rel": TRAIN_GRAD_REL},
            "checks": checks}


def _copy_accuracy(cfg, params, device) -> tuple:
    """(copy accuracy of 16 seed-0 induction prompts greedily through the
    int8-KV ``Engine``, K1's launches)."""
    import numpy as np
    from repro_torch.data.pipeline import induction_batch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.serving.engine import Engine

    half = TRAIN_VEHICLE["seq"] // 2
    tokens, _ = induction_batch(np.random.default_rng(0), 16,
                                TRAIN_VEHICLE["seq"], cfg.vocab_size)
    eng = Engine(cfg, params, RuntimeOpts(q_chunk=64, kv_chunk=64,
                                          quantized_kv=True),
                 cache_len=64, device=device)
    da.decode_attention.launches = 0
    out = eng.generate(tokens[:, :half + 1].astype(np.int32), half).tokens
    return (float(np.mean(out[:, half + 1:] == tokens[:, :half])),
            da.decode_attention.launches)


def _train_vehicle(ctx) -> dict:
    """Run C: the induction vehicle trained on the card from the port's
    seed-0 init, its checkpoint written and read back through
    ``restore_checkpoint`` and ``params.load_npz_checkpoint``, and its copy
    accuracy through the int8-KV Engine beside the committed vehicle's."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import induction_loader
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import load_npz_checkpoint
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, train

    device, v = ctx["device"], TRAIN_VEHICLE
    cfg = dataclasses.replace(get_config("llama2-7b").tiny(),
                              vocab_size=v["vocab"], num_blocks=v["blocks"])
    loader = induction_loader(v["vocab"], batch=v["batch"], seq=v["seq"],
                              num_batches=v["steps"])
    tc = TrainConfig(AdamWConfig(lr=v["lr"], warmup_steps=v["warmup"],
                                 total_steps=v["steps"]))
    t0 = time.perf_counter()
    params, _, hist = train(cfg, loader, tc, RuntimeOpts(
        q_chunk=64, kv_chunk=64, remat=False, moe_capacity_factor=0.0),
        log_every=10 ** 9, device=device)
    train_s = time.perf_counter() - t0
    path = os.path.join(ROOT, "build", "train_vehicle")
    save_checkpoint(path, params, step=v["steps"])
    restored, step = restore_checkpoint(
        path, {k: torch.zeros_like(t) for k, t in params.items()})
    loaded = load_npz_checkpoint(path, device)
    acc, k1 = _copy_accuracy(cfg, params, device)
    committed, _ = _copy_accuracy(cfg, load_npz_checkpoint(
        os.path.join(ROOT, "experiments", "vehicles", "induction")), device)
    first, last = hist[0]["ce"], hist[-1]["ce"]
    checks = {"ce_falls": last < 0.7 * first,
              "restore_bits": step == v["steps"] and all(
                  torch.equal(restored[k], t) for k, t in params.items()),
              "load_npz_bits": set(loaded) == set(params) and all(
                  torch.equal(loaded[k], t) for k, t in params.items()),
              "k1_launched": k1 > 0}
    return {**v, "ce_first": first, "ce_last": last,
            "train_s": train_s,
            "step_host_ms_median": statistics.median(
                h["host_ms"] for h in hist),
            "copy_accuracy": acc, "committed_copy_accuracy": committed,
            "k1_launches": k1, "checks": checks}


def _train_ste(ctx) -> dict:
    """Run D: ``encode_decode_ste`` on a (128, 4096) f32 payload with
    outliers at the OPSC defaults: its forward on the card (K6, then K5)
    bit for bit the CPU's plain composition, its backward exactly the
    upstream gradient, one launch of each kernel; its forward timed."""
    import torch
    from repro_torch.core.payload import encode_decode_ste
    from repro_torch.kernels import tabq_quantize as tq
    from repro_torch.kernels import ts_mask as tsm

    device = ctx["device"]
    gen = torch.Generator(device=device).manual_seed(7)
    t, d = TRAIN_STE_SHAPE
    x = _activations(torch, gen, t, d, torch.float32, device,
                     outliers=t * d // 512).requires_grad_()
    kw = dict(tau=5.0, delta=0.2, max_bits=8)
    tsm.ts_encode.launches = tq.tabq_adaptive.launches = 0
    tq.tabq_quantize.launches = 0
    out = encode_decode_ste(x, **kw)
    launches = {"ts_encode": tsm.ts_encode.launches,
                "tabq_adaptive": tq.tabq_adaptive.launches,
                "tabq_quantize": tq.tabq_quantize.launches}
    want = encode_decode_ste(x.detach().cpu(), **kw)
    upstream = torch.randn((t, d), generator=gen, device=device)
    (grad,) = torch.autograd.grad(out, x, upstream)
    timed = ctx["timer"]({"ste": lambda: encode_decode_ste(x, **kw)},
                         iters=10)
    checks = {"forward_bits": torch.equal(out.detach().cpu(), want),
              "backward_identity": torch.equal(grad, upstream),
              "launches": launches == {"ts_encode": 1, "tabq_adaptive": 1,
                                       "tabq_quantize": 0}}
    return {"shape": [t, d], **kw, "launches": launches,
            "max_abs_err": float((out.detach().cpu() - want).abs().max()),
            "forward_ms": timed["ste"], "checks": checks}


# parts E to G: the sharded training mesh (launch.mesh.make_training_mesh,
# launch.sharding, make_train_step(mesh=)). E: one NCCL rank on the (1, 1)
# mesh at run A's shape for TRAIN_E_STEPS steps, bit for bit the unsharded
# step; F: four gloo ranks sharing the card on the (2, 2) mesh; G: two
# gloo ranks on the (2, 1) mesh over qwen2-moe-a2.7b's first block, then
# moe_layer_ep on that block's weights. Each step of F and G is held to the
# unsharded step from the same state at tests/test_torch_sharded_train.py's
# bars (the parameters within 2 lr of that step)
TRAIN_E_STEPS = 3
TRAIN_F = dict(arch="llama2-7b", dims=(2, 2), blocks=2, batch=4, seq=256,
               accum=2, steps=2, moe_groups=1, moe_cf=1.25)
TRAIN_G = dict(arch="qwen2-moe-a2.7b", dims=(2, 1), blocks=1, batch=4,
               seq=128, accum=1, steps=2, moe_groups=2, moe_cf=0.0,
               ep=dict(seq=128, cf=1.25))
TRAIN_MESH_LR = dict(lr=1e-3, warmup_steps=1, total_steps=10)
TRAIN_MESH_METRIC_REL = 2e-5
TRAIN_MESH_PARAM_TIGHT = 1e-5
TRAIN_MESH_PARAM_LOOSE_SHARE = 0.01
TRAIN_EP_REL = 1e-4  # y against the largest |y|; the aux relative


def _digests(params: dict) -> dict:
    """Each leaf's SHA-256 over its bytes (hashed on host threads)."""
    import concurrent.futures
    import hashlib

    host = {k: v.detach().cpu().numpy() for k, v in params.items()}
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        return dict(zip(host, ex.map(
            lambda a: hashlib.sha256(a.data).hexdigest(), host.values())))


def _train_e(ctx, run_a) -> dict:
    """Part E: run A's config, batches and schedule for TRAIN_E_STEPS
    steps, unsharded and then over the (1, 1) mesh of one NCCL rank (this
    process): each step's metrics and every parameter's SHA-256, bit for
    bit; the unsharded steps' metrics are run A's."""
    import dataclasses
    import itertools

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import ZipfMarkov, lm_loader
    from repro_torch.device import to_device
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.launch.sharding import TrainPlacement
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import (TrainConfig,
                                                 init_train_state,
                                                 make_train_step)

    device, argv = ctx["device"], list(TRAIN_ARGV)
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              num_blocks=_flag(argv, "--num-blocks"))
    b, s, n = (_flag(argv, f) for f in ("--batch", "--seq", "--steps"))
    opts = RuntimeOpts(q_chunk=min(1024, s), kv_chunk=min(1024, s),
                       remat=True)
    tc = TrainConfig(AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=n),
                     accum_steps=_flag(argv, "--accum"))
    batches = list(itertools.islice(lm_loader(
        ZipfMarkov(cfg.vocab_size, branching=8, seed=0), b, s, n),
        TRAIN_E_STEPS))

    def run(mesh):
        params, state = init_train_state(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
        if mesh is not None:
            place = TrainPlacement(cfg, mesh)
            params, state = place.shard(params), place.shard(state)
        step = make_train_step(cfg, tc, opts, mesh=mesh)
        rows = []
        for batch in batches:
            t0 = time.perf_counter()
            params, state, m = step(params, state, {
                k: to_device(v, device) for k, v in batch.items()})
            row = {k: float(v) for k, v in m.items()}
            row["host_ms"] = (time.perf_counter() - t0) * 1e3
            row["digests"] = _digests(params)
            rows.append(row)
        del params, state
        _free_weights()
        return rows

    plain = run(None)
    _mark(ctx, "E_unsharded")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_training_mesh((1, 1))
        meshed = run(mesh)
    finally:
        dist.destroy_process_group()
    keys = ("loss", "ce", "aux", "grad_norm", "lr")
    checks = {
        "metrics_bits": all(p[k] == m[k] for p, m in zip(plain, meshed)
                            for k in keys),
        "digests_bits": all(p["digests"] == m["digests"]
                            for p, m in zip(plain, meshed)),
        "unsharded_is_run_a": all(
            p[k] == a[k] for p, a in zip(plain, run_a["steps"])
            for k in ("loss", "grad_norm", "lr"))}
    return {"config": cfg.name, "mesh": [1, 1], "backend": "nccl",
            "steps": [{k: v for k, v in r.items() if k != "digests"}
                      for r in meshed],
            "unsharded_host_ms": [r["host_ms"] for r in plain],
            "leaves_hashed": len(plain[0]["digests"]), "checks": checks}


def _mesh_config(spec):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(spec["arch"]),
                               num_blocks=spec["blocks"])


def _mesh_setup(spec):
    """(config, TrainConfig, RuntimeOpts, batches) of a TRAIN_F/TRAIN_G
    spec."""
    from repro_torch.data.pipeline import ZipfMarkov, lm_loader
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig

    cfg = _mesh_config(spec)
    tc = TrainConfig(AdamWConfig(**TRAIN_MESH_LR),
                     accum_steps=spec["accum"])
    opts = RuntimeOpts(q_chunk=spec["seq"], kv_chunk=spec["seq"],
                       remat=True, moe_groups=spec["moe_groups"],
                       moe_capacity_factor=spec["moe_cf"])
    batches = list(lm_loader(ZipfMarkov(cfg.vocab_size, branching=8,
                                        seed=0),
                             spec["batch"], spec["seq"], spec["steps"]))
    return cfg, tc, opts, batches


def _ep_inputs_on(spec, cfg, device):
    """G's moe_layer_ep input: (2, seq, D) f32 from seed 5 on the card."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5)
    return torch.randn((2, spec["ep"]["seq"], cfg.d_model), generator=gen,
                       device=device)


def _block_ffn(params) -> dict:
    """Block 0's MoE leaves of a whole parameter dict, nested."""
    out = {}
    for k, v in params.items():
        if k.startswith("blocks/p0/ffn/"):
            name = k[len("blocks/p0/ffn/"):]
            if name.startswith("shared/"):
                out.setdefault("shared", {})[name[7:]] = v[0]
            else:
                out[name] = v[0]
    return out


def _block_file(work: str, rank: int, step: int) -> str:
    return os.path.join(work, f"blocks_r{rank}_s{step}.pt")


def _assemble(blocks: list, spec, dims: tuple, names: tuple):
    """The whole leaf from every rank's block (in rank order) of a leaf
    placed by ``spec`` on a training mesh of ``dims``: rank r sits at its
    row-major coordinates, as ``make_training_mesh`` places it."""
    import torch
    from repro_torch.launch.sharding import entry_dims

    sizes = dict(zip(names, dims))
    cuts = [entry_dims(e) for e in spec]
    first = blocks[0]
    whole = torch.empty([n * math.prod(sizes[m] for m in c)
                         for n, c in zip(first.shape, cuts)],
                        dtype=first.dtype)
    for r, b in enumerate(blocks):
        at, rest = {}, r
        for name, size in reversed(tuple(zip(names, dims))):
            at[name], rest = rest % size, rest // size
        index = []
        for n, c in zip(b.shape, cuts):
            i = 0
            for m in c:
                i = i * sizes[m] + at[m]
            index.append(slice(i * n, (i + 1) * n))
        whole[tuple(index)] = b
    return whole


def _assembled(work: str, step: int, world: int, specs: dict, dims: tuple,
               moments: bool):
    """(whole params, whole AdamWState or None) after ``step`` from the
    blocks every rank wrote; the files are removed."""
    import torch
    from repro_torch.launch.mesh import TRAIN_DIMS
    from repro_torch.training.optimizer import AdamWState

    paths = [_block_file(work, r, step) for r in range(world)]
    loaded = [torch.load(p, mmap=True) for p in paths]

    def whole(group):
        return {k: _assemble([f[group][k] for f in loaded], specs[k], dims,
                             TRAIN_DIMS[len(dims)])
                for k in loaded[0][group]}

    params = whole("params")
    state = AdamWState(whole("mu"), whole("nu"), loaded[0]["count"]) \
        if moments else None
    del loaded
    for p in paths:
        os.remove(p)
    return params, state


def _plain_step(step, params, state, batch, device, base: int) -> dict:
    """The unsharded step from ``params`` and ``state`` (host or card): its
    metrics, host ms, new parameters on the host, and its peak device
    bytes over ``base`` (what was allocated before the state came onto the
    card)."""
    import torch
    from repro_torch.training.optimizer import AdamWState

    p = {k: v.to(device) for k, v in params.items()}
    s = AdamWState({k: v.to(device) for k, v in state.mu.items()},
                   {k: v.to(device) for k, v in state.nu.items()},
                   state.count.to(device))
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    p, s, m = step(p, s, batch)
    row = {k: float(v) for k, v in m.items()}
    row["host_ms"] = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(device) - base
    new = {k: v.cpu() for k, v in p.items()}
    del p, s
    return {"metrics": row, "params": new, "peak_bytes": peak}


def _param_hold(got: dict, want: dict, device) -> dict:
    """Largest |got − want| over the parameters, and how many entries
    pass TRAIN_MESH_PARAM_TIGHT (compared on the card, a leaf at a
    time)."""
    worst, loose, total = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].to(device) - w.to(device)).abs()
        worst = max(worst, float(d.max()))
        loose += int((d > TRAIN_MESH_PARAM_TIGHT).sum())
        total += d.numel()
        del d
    return {"max_abs_err": worst, "loose": loose, "counted": total}


def _train_mesh_rank(rank: int, world: int, device_name: str, spec: dict,
                     ep_want, work: str) -> dict:
    """One rank of part F or G (``launch.ranks.run_ranks`` starts it under
    gloo): the whole state drawn from seed 0 and cut, (G) moe_layer_ep on
    block 0's whole weights cut as it takes them, then the sharded steps.
    After each step the rank writes its blocks (and, but after the last
    step, its moments' blocks) under ``work`` for the caller's holds.
    Returns the rank's resident bytes, its peak over the steps, and each
    step's metrics and host ms."""
    import torch
    from repro_torch.device import to_device
    from repro_torch.launch.collectives import block_index
    from repro_torch.launch.mesh import make_training_mesh
    from repro_torch.launch.sharding import TrainPlacement
    from repro_torch.models.moe import moe_layer_ep
    from repro_torch.params import param_specs as shapes
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    torch.set_num_threads(2)
    device = torch.device(device_name)
    torch.cuda.set_device(device)
    t_setup = time.perf_counter()
    cfg, tc, opts, batches = _mesh_setup(spec)
    mesh = make_training_mesh(spec["dims"])
    place = TrainPlacement(cfg, mesh)
    params, state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    out = {"mesh": list(mesh.shape)}
    if ep_want is not None:
        ffn = _block_ffn(params)
        idx, n = block_index(place.data)
        cut = {"w_router": ffn["w_router"]}
        for k, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
            cut[k] = ffn[k].chunk(n, dim)[idx].contiguous()
        cut["shared"] = {k: v.chunk(n, 0)[idx].contiguous()
                         for k, v in ffn["shared"].items()}
        x = _ep_inputs_on(spec, cfg, device).chunk(n, 0)[idx]
        with torch.no_grad():
            y, aux = moe_layer_ep(cut, x, cfg.pattern[0].ffn, ("data",),
                                  spec["ep"]["cf"], True, mesh=mesh)
        want_y = torch.from_numpy(ep_want["y"]).chunk(n, 0)[idx]
        out["ep"] = {"y_err": float((y.cpu() - want_y).abs().max()),
                     "y_max": float(want_y.abs().max()),
                     "aux": float(aux), "aux_want": ep_want["aux"],
                     "aux_grouped": ep_want["aux_grouped"]}
        del ffn, cut
    params, state = place.shard(params), place.shard(state)
    _free_weights()
    whole = {k: v[0] for k, v in shapes(cfg).items()}
    out["resident"] = {"params": place.resident_bytes(params),
                       "moments": place.resident_bytes(state),
                       "share": place.share_bytes(whole),
                       "whole": sum(4 * math.prod(s)
                                    for s in whole.values())}
    out["setup_s"] = time.perf_counter() - t_setup
    step = make_train_step(cfg, tc, opts, mesh=mesh)
    rows, peak = [], 0
    for i, batch in enumerate(batches):
        batch = {k: to_device(v, device) for k, v in batch.items()}
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        row = {k: float(v) for k, v in m.items()}
        row["host_ms"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize(device)
        peak = max(peak, torch.cuda.max_memory_allocated(device))
        t0 = time.perf_counter()
        blocks = {"params": {k: v.cpu() for k, v in params.items()}}
        if i + 1 < len(batches):  # the next step's unsharded start
            blocks.update(mu={k: v.cpu() for k, v in state.mu.items()},
                          nu={k: v.cpu() for k, v in state.nu.items()},
                          count=state.count.cpu())
        torch.save(blocks, _block_file(work, rank, i))
        del blocks
        row["write_ms"] = (time.perf_counter() - t0) * 1e3
        rows.append(row)
    out.update(steps=rows, peak_bytes=peak)
    return out


def _train_mesh(ctx, spec, name) -> dict:
    """Part F or G. Each step of the ranks is held against the unsharded
    step on the card from the same state: step 1 from the seed-0 draw
    (run here before the ranks, which draw the same), each later step
    from the ranks' blocks after the step before, put together here from
    the files they wrote. (G) moe_layer_ep is held to the unsharded
    ``moe_layer`` on block 0 of the draw."""
    import torch
    from repro_torch.device import to_device
    from repro_torch.launch.mesh import TRAIN_DIMS, AbstractMesh
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.launch.sharding import param_specs
    from repro_torch.models.moe import moe_layer
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    device = ctx["device"]
    cfg, tc, opts, batches = _mesh_setup(spec)
    dims = tuple(spec["dims"])
    batches = [{k: to_device(v, device) for k, v in b.items()}
               for b in batches]
    plain = make_train_step(cfg, tc, opts)
    _free_weights()
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    params, state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    ep_want = None
    if "ep" in spec:
        x = _ep_inputs_on(spec, cfg, device)
        ffn, moe = _block_ffn(params), cfg.pattern[0].ffn
        with torch.no_grad():
            y, aux_grouped = moe_layer(ffn, x, moe, spec["ep"]["cf"],
                                       groups=2)
            own = [moe_layer(ffn, half, moe, spec["ep"]["cf"])[1]
                   for half in x.chunk(2, 0)]
        ep_want = {"y": y.cpu().numpy(), "aux_grouped": float(aux_grouped),
                   "aux": float((own[0] + own[1]) / 2)}
        del ffn, x, y, own
    wants = [_plain_step(plain, params, state, batches[0], device, base)]
    del params, state
    _free_weights()
    _mark(ctx, f"{name}_unsharded")
    work = os.path.join(ROOT, "build", f"{name}_ranks")
    os.makedirs(work, exist_ok=True)
    rank_device = str(torch.device("cuda", torch.cuda.current_device()))
    world = math.prod(dims)
    ranks = run_ranks(_train_mesh_rank, world, backend="gloo",
                      workdir=work, args=(rank_device, spec, ep_want, work),
                      timeout=900)
    _mark(ctx, f"{name}_ranks")
    specs = param_specs(cfg, AbstractMesh(dims, TRAIN_DIMS[len(dims)]),
                        fsdp=True)
    held = []
    for i in range(spec["steps"]):
        more = i + 1 < spec["steps"]
        got, state = _assembled(work, i, world, specs, dims, moments=more)
        held.append(_param_hold(got, wants[i]["params"], device))
        if more:  # the next step from the state the ranks hold
            _free_weights()
            torch.cuda.synchronize(device)
            wants.append(_plain_step(plain, got, state, batches[i + 1],
                                     device, torch.cuda.memory_allocated(
                                         device)))
        del got, state
        _free_weights()
    lr = [w["metrics"]["lr"] for w in wants]
    for h, rate in zip(held, lr):
        h["param_atol"] = 2 * rate
    keys = ("loss", "ce", "aux", "grad_norm", "lr")
    # every step at the bar, each from the state the ranks held before it
    tight = [all(abs(g[k] - w["metrics"][k])
                 <= TRAIN_MESH_METRIC_REL * abs(w["metrics"][k]) + 1e-7
                 for k in keys)
             for g, w in zip(ranks[0]["steps"], wants)]
    plain_peak = max(w["peak_bytes"] for w in wants)
    checks = {
        "mesh": all(r["mesh"] == list(dims) for r in ranks),
        "steps_held": len(held) == len(ranks[0]["steps"]) == spec["steps"],
        "ranks_agree": all([{k: s[k] for k in keys} for s in r["steps"]]
                           == [{k: s[k] for k in keys}
                               for s in ranks[0]["steps"]] for r in ranks),
        "metrics": all(tight),
        "params_within_lr": all(h["max_abs_err"] <= h["param_atol"]
                                for h in held),
        "params_tight": all(h["loose"] <= TRAIN_MESH_PARAM_LOOSE_SHARE
                            * h["counted"] for h in held),
        "resident_is_share": all(
            r["resident"]["params"] == r["resident"]["share"]
            and r["resident"]["moments"] == 2 * r["resident"]["share"]
            for r in ranks),
        "peak_below_unsharded": all(r["peak_bytes"] < plain_peak
                                    for r in ranks)}
    if ep_want is not None:
        checks["ep_y"] = all(r["ep"]["y_err"] <= TRAIN_EP_REL
                             * r["ep"]["y_max"] for r in ranks)
        checks["ep_aux_mean_of_ranks"] = all(
            abs(r["ep"]["aux"] - ep_want["aux"])
            <= TRAIN_EP_REL * ep_want["aux"] for r in ranks)
    return {"config": cfg.name, **{k: v for k, v in spec.items()
                                   if k != "arch"},
            "backend": "gloo (ranks share the card)",
            "unsharded": {"steps": [w["metrics"] for w in wants],
                          "peak_gb": plain_peak / 1e9},
            "ranks": [{"setup_s": r["setup_s"],
                       "step_host_ms": [s["host_ms"] for s in r["steps"]],
                       "write_ms": [s["write_ms"] for s in r["steps"]],
                       "peak_gb": r["peak_bytes"] / 1e9,
                       "params_gb": r["resident"]["params"] / 1e9,
                       "moments_gb": r["resident"]["moments"] / 1e9,
                       "share_gb": r["resident"]["share"] / 1e9,
                       "whole_params_gb": r["resident"]["whole"] / 1e9,
                       **({"ep": r["ep"]} if "ep" in r else {})}
                      for r in ranks],
            "metrics": ranks[0]["steps"], "metrics_tight": tight,
            "params": held,
            "tol": {"metric_rel": TRAIN_MESH_METRIC_REL,
                    "param_tight": TRAIN_MESH_PARAM_TIGHT,
                    "param_loose_share": TRAIN_MESH_PARAM_LOOSE_SHARE,
                    "ep_rel": TRAIN_EP_REL},
            "checks": checks}


def phase_train(ctx) -> None:
    parts = []
    for name, fn in (("A", _train_launcher), ("B", _train_card_cpu),
                     ("C", _train_vehicle), ("D", _train_ste),
                     ("E", lambda ctx: _train_e(ctx, parts[0][1]))):
        parts.append((name, fn(ctx)))
        _mark(ctx, name)
        _free_weights()
    _emit_parts(ctx, "train", parts)


def phase_train_mesh(ctx) -> None:
    parts = []
    for name, spec in (("F", TRAIN_F), ("G", TRAIN_G)):
        parts.append((name, _train_mesh(ctx, spec, name)))
        _mark(ctx, name)
        _free_weights()
    _emit_parts(ctx, "train_mesh", parts)


def _emit_parts(ctx, phase: str, parts: list) -> None:
    """The phase's line: its parts, times, the card; failed on any check."""
    import torch

    checks = {}
    report = {"phase": phase, **_times(ctx), "nvidia_smi": ctx["smi"],
              **dict(parts),
              "device_memory_gb": torch.cuda.get_device_properties(
                  0).total_memory / 1e9}
    try:
        _phase_verdict(phase, parts, checks)
    finally:
        report.update(checks=checks, ok=all(checks.values()))
        emit(report)


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                    + ",".join(PHASES + ON_REQUEST))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES + ON_REQUEST)
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
           "smi": nvidia_smi(), "kernels": {}, "launches": {},
           "single": {}, "timer": Timer(torch, device)}
    runners = {"env": phase_env, "kernels": phase_kernels,
               "model": phase_model, "vehicle": phase_vehicle,
               "serve": phase_serve, "paged": phase_paged,
               "packed": phase_packed, "split": phase_split,
               "spec": phase_spec, "service": phase_service,
               "disagg": phase_disagg, "sharded": phase_sharded,
               "families": phase_families,
               "moe": phase_moe, "gqa": phase_gqa, "ssm": phase_ssm,
               "modal": phase_modal, "train": phase_train,
               "train_mesh": phase_train_mesh}
    for name in PHASES + ON_REQUEST:
        if name in phases:
            ctx["phase_t0"] = ctx["part_t0"] = time.perf_counter()
            ctx["part_s"] = {}
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
