"""Serving launcher: a batch of random prompts through the port's
``Engine``, or with ``--split`` through the paper's ``SplitEngine`` (port
of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --tiny --batch 4 --new 16 --quantized-kv [--device cpu] \
      [--split --split-layer 1 --qw-front 8 [--deadline-ms 0.1]]

``--arch`` takes any config of ``repro_torch.configs`` (llama2-7b,
llama2-13b, gemma2-2b, h2o-danube-3-4b, qwen2-moe-a2.7b,
qwen3-moe-235b-a22b, internlm2-20b, granite-34b, mamba2-780m,
jamba-v0.1-52b, qwen2-vl-2b, served on text prompts as the reference's
launcher serves it, and musicgen-medium, whose prompts are (B, S, 4)
codebook tokens); ``--split-layer`` is snapped to a pattern boundary
(gemma2's pattern is two layers, jamba's eight). Mixture-of-experts layers
route dropless (``moe_capacity_factor=0.0``), as the reference serves
them. ``--num-blocks`` keeps the first blocks of a config too deep for one
card: qwen3-moe-235b-a22b's 94 blocks are 940 GB of f32 weights, four of
them with its embedding and head about 45 GB; jamba-v0.1-52b's 4 blocks
of 8 layers are 206 GB of f32, one of them about 53 GB:

  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \
      --num-blocks 4 --quantized-kv
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --num-blocks 1 --quantized-kv

Runs on the CUDA card unless ``--device`` names another device.
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.opsc import OPSCConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import init_params
from repro_torch.serving.engine import Engine
from repro_torch.serving.split_engine import SplitEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--quantized-kv", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="serve only the first N blocks (default: all)")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--split-layer", type=int, default=1)
    ap.add_argument("--qw-front", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    if args.num_blocks is not None:
        cfg = dataclasses.replace(cfg, num_blocks=args.num_blocks)
    opts = RuntimeOpts(q_chunk=64, kv_chunk=64, quantized_kv=args.quantized_kv,
                       moe_capacity_factor=0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    rng = np.random.default_rng(0)
    shape = (args.batch, args.prompt_len)
    if cfg.embed == "musicgen":  # one token stream a codebook
        shape += (cfg.num_codebooks,)
    prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    cache_len = args.prompt_len + args.new

    if args.split:
        # snap the split to a pattern boundary (OPSC splits between blocks)
        plen = len(cfg.pattern)
        ell = max(plen, args.split_layer - args.split_layer % plen)
        if ell != args.split_layer:
            print(f"[serve/split] split_layer {args.split_layer} → {ell} "
                  f"(pattern boundary)")
        eng = SplitEngine(cfg, params, OPSCConfig(split_layer=ell,
                                                  qw_front=args.qw_front),
                          channel=ChannelConfig(),
                          deadline_s=(args.deadline_ms or 0) / 1e3 or None,
                          opts=opts, cache_len=cache_len, device=device)
        t0 = time.perf_counter()
        tokens, stats = eng.generate(prompts, args.new)
        dt = time.perf_counter() - t0
        print(f"[serve/split] {tokens.shape[0]}×{args.new} tokens in "
              f"{dt:.2f}s on {device}; uplink "
              f"{stats.uplink_bits_measured / 8e3:.1f} KB measured "
              f"({stats.uplink_bits_eq3 / 8e3:.1f} KB Eq.3), "
              f"early_exits={stats.early_exits}")
        return
    eng = Engine(cfg, params, opts, cache_len=cache_len, device=device)
    t0 = time.perf_counter()
    res = eng.generate(prompts, args.new)
    dt = time.perf_counter() - t0
    print(f"[serve] {res.tokens.shape} in {dt:.2f}s on {device} = "
          f"{args.batch * args.new / dt:.1f} tok/s "
          f"(kv={'int8' if args.quantized_kv else 'float32'}, "
          f"{cfg.num_layers} layers)")


if __name__ == "__main__":
    main()
