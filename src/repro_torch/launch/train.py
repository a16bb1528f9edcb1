"""Training launcher (port of ``repro/launch/train.py``): a config trained
on the Zipf-Markov corpus (branching 8) with AdamW (warmup 10 steps, a
cosine decay over ``--steps``), f32 parameters and state, each block
recomputed in the backward pass, then optionally a checkpoint in the
reference's format.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama2-7b \\
      --tiny --steps 20 [--accum 2] [--checkpoint DIR] [--device cpu]

``--num-blocks`` keeps a config's first blocks, as ``launch.serve`` does:
llama2-7b's 32 blocks with f32 weights, gradients and AdamW's two moments
are 16 bytes × 6.7 B parameters, more than one 80 GB card holds; 4 of
them with the embedding and head are 1.07 B parameters, 17 GB:

  python -m repro_torch.launch.train --arch llama2-7b --num-blocks 4 \\
      --batch 4 --seq 512 --accum 2 --steps 8

``--mesh`` (the reference's FSDP × TP mesh) is not ported. Runs on the
CUDA card unless ``--device`` names another device. :func:`main` returns
the history, one dict of metrics a step.
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import ZipfMarkov, lm_loader
from repro_torch.device import resolve_device
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state,
                                             train)


def main(argv=None, on_step=None) -> list:
    """Parse ``argv``, train, save; the history. ``on_step(i, metrics)``
    runs after each step (``train_loop.train``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default=None, help="e.g. 2x4 (data x model)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="train only the first N blocks (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: a sharded training mesh is not ported (ROADMAP queue "
            "1, item 8, the sharded deployment)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    if args.num_blocks is not None:
        cfg = dataclasses.replace(cfg, num_blocks=args.num_blocks)
    print(f"[train] arch={cfg.name} params={cfg.total_params():,} "
          f"device={device}")

    opts = RuntimeOpts(q_chunk=min(1024, args.seq),
                       kv_chunk=min(1024, args.seq), remat=True)
    tc = TrainConfig(AdamWConfig(lr=args.lr, warmup_steps=10,
                                 total_steps=args.steps),
                     accum_steps=args.accum)
    params, opt_state = init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    corpus = ZipfMarkov(cfg.vocab_size, branching=8, seed=0)
    loader = lm_loader(corpus, args.batch, args.seq, args.steps)
    t0 = time.perf_counter()

    def report(i, row):
        if i % 10 == 0:
            print(f"[train] step {i:4d} loss {row['loss']:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
        if on_step is not None:
            on_step(i, row)

    params, _, history = train(cfg, loader, tc, opts, params=params,
                               opt_state=opt_state, device=device,
                               log_every=10 ** 9, on_step=report)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps)
        print(f"[train] saved checkpoint → {args.checkpoint}")
    return history


if __name__ == "__main__":
    main()
