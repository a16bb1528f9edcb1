"""Serving launcher: a batch of random prompts through the port's
``Engine`` (port of ``repro/launch/serve.py``, non-split branch).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2-7b \
      --tiny --batch 4 --new 16 --quantized-kv [--device cpu]

Runs on the CUDA card unless ``--device`` names another device.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.params import init_params
from repro_torch.serving.engine import Engine


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
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    if args.split:
        raise NotImplementedError("--split: the split engine is not ported "
                                  "yet (ROADMAP queue 1, item 8)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    opts = RuntimeOpts(q_chunk=64, kv_chunk=64, quantized_kv=args.quantized_kv)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    eng = Engine(cfg, params, opts, cache_len=args.prompt_len + args.new,
                 device=device)
    t0 = time.perf_counter()
    res = eng.generate(prompts, args.new)
    dt = time.perf_counter() - t0
    print(f"[serve] {res.tokens.shape} in {dt:.2f}s on {device} = "
          f"{args.batch * args.new / dt:.1f} tok/s "
          f"(kv={'int8' if args.quantized_kv else 'float32'})")


if __name__ == "__main__":
    main()
