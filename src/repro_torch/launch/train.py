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

``--mesh AxB`` (data × model) or ``AxBxC`` (pod × data × model) trains
on the reference's FSDP × TP mesh (``launch.mesh.make_training_mesh``,
``launch.sharding``): one rank a process, each storing its blocks of the
parameters and AdamW moments and training on its rows of every
microbatch. Outside ``torchrun`` the launcher starts the ranks itself
(``launch.ranks.run_ranks``); under ``torchrun`` (``WORLD_SIZE`` set)
each rank joins from the environment. ``--backend`` is ``gloo`` on the
CPU or for ranks that share a card (default off CUDA), ``nccl`` for one
rank a card (default on CUDA); nccl with more ranks on a host than its
cards raises ``ValueError``. Rank 0 prints and writes the checkpoint:

  python -m repro_torch.launch.train --arch llama2-7b --tiny --mesh 2x2 \\
      --device cpu --steps 3 [--checkpoint DIR]

Runs on the CUDA card unless ``--device`` names another device (ranks
share it under gloo; under nccl each rank takes the card of its index on
its host, torchrun's ``LOCAL_RANK``). :func:`main` returns the history,
one dict of metrics a step (rank 0's under a mesh).
"""

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import ZipfMarkov, lm_loader
from repro_torch.device import resolve_device
from repro_torch.launch.ranks import run_ranks
from repro_torch.launch.sharding import TrainPlacement
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
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="--mesh's process group (default: nccl on CUDA, "
                         "gloo on the CPU)")
    args = ap.parse_args(argv)
    if args.mesh:
        return _main_mesh(args, on_step)
    if args.backend:
        ap.error("--backend needs --mesh")
    return _train(args, resolve_device(args.device), on_step)


def _mesh_dims(text: str) -> tuple:
    dims = tuple(int(x) for x in text.lower().split("x"))
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh {text}: give data x model (2x2) or pod x "
                         f"data x model (2x1x2)")
    return dims


def _check_backend(backend: str, device, ranks_here: int) -> None:
    """nccl runs one rank a CUDA card: ``ValueError`` naming ``--backend
    gloo`` when ``device`` is no CUDA device or this host has fewer cards
    than the ``ranks_here`` ranks it runs."""
    if backend != "nccl":
        return
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device.type != "cuda" or ranks_here > cards:
        raise ValueError(
            f"--backend nccl runs one rank a CUDA card: {ranks_here} ranks "
            f"on this host's {cards} card(s) of --device {device}; pass "
            f"--backend gloo to share a device")


def _main_mesh(args, on_step) -> list:
    """Start or join the ranks of ``--mesh``; rank 0's history."""
    import torch.distributed as dist

    world = math.prod(_mesh_dims(args.mesh))
    device = torch.device(args.device or "cuda")
    args.backend = args.backend or ("nccl" if device.type == "cuda"
                                    else "gloo")
    if "WORLD_SIZE" in os.environ:  # torchrun started this rank
        # the cards are this host's: torchrun's LOCAL_* name its ranks
        _check_backend(args.backend, device,
                       int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        dist.init_process_group(args.backend)
        try:
            return _rank_main(dist.get_rank(), dist.get_world_size(),
                              vars(args), on_step,
                              int(os.environ.get("LOCAL_RANK", 0)))
        finally:
            dist.destroy_process_group()
    _check_backend(args.backend, device, world)  # every rank on this host
    if on_step is not None:
        raise ValueError("on_step runs in process: start the ranks with "
                         "torchrun to pass one with --mesh")
    with tempfile.TemporaryDirectory(prefix="train-ranks-") as work:
        return run_ranks(_rank_main, world, backend=args.backend,
                         workdir=work, args=(vars(args),),
                         timeout=24 * 3600.0)[0]


def _rank_device(args, local_rank: int):
    """This rank's device: ``--device`` with an index as given; else under
    nccl card ``local_rank`` of this host, under gloo the current card."""
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device(
            "cuda", local_rank if args.backend == "nccl"
            else torch.cuda.current_device())
    return device


def _rank_main(rank: int, world: int, args: dict, on_step=None,
               local_rank: int | None = None) -> list:
    """One rank of ``--mesh`` (``local_rank``, its index on its host,
    defaults to ``rank``: ``run_ranks`` starts every rank on one host):
    its device, the mesh, then :func:`_train`."""
    from repro_torch.launch.mesh import make_training_mesh

    args = argparse.Namespace(**args)
    device = _rank_device(args, rank if local_rank is None else local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_training_mesh(_mesh_dims(args.mesh))
    return _train(args, resolve_device(device), on_step, mesh)


def _train(args, device, on_step, mesh=None) -> list:
    """Train ``args``' config on ``device`` (over ``mesh`` when given;
    rank 0 prints and saves); the history."""
    lead = mesh is None or mesh.get_rank() == 0
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    if args.num_blocks is not None:
        cfg = dataclasses.replace(cfg, num_blocks=args.num_blocks)
    where = f"device={device}"
    if mesh is not None:
        where += f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
        where += f" backend={args.backend}"
    if lead:
        print(f"[train] arch={cfg.name} params={cfg.total_params():,} "
              f"{where}")

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
        if i % 10 == 0 and lead:
            print(f"[train] step {i:4d} loss {row['loss']:.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1):.2f}s/step)")
        if on_step is not None:
            on_step(i, row)

    place = None
    if mesh is not None:
        place = TrainPlacement(cfg, mesh)
        params, opt_state = place.shard(params), place.shard(opt_state)
    params, _, history = train(cfg, loader, tc, opts, params=params,
                               opt_state=opt_state, device=device,
                               log_every=10 ** 9, on_step=report, mesh=mesh)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps,
                        placement=place)
        if lead:
            print(f"[train] saved checkpoint → {args.checkpoint}")
    return history


if __name__ == "__main__":
    main()
