"""End-to-end split-computing inference on the PyTorch port: the paper's
full system (§2), steps 2 to 4 of ``examples/split_inference.py``.

1. The induction vehicle: llama2-7b tiny with a vocabulary of 64 and 4
   blocks, trained on the copy task ``[prefix][SEP][prefix]``. By default
   the committed one (``experiments/vehicles/induction``); with
   ``--steps N`` (N > 0) the port trains it first, as step 1 of
   ``examples/split_inference.py`` does (batch 32, seq 33, AdamW at lr
   3e-3 with 20 warmup steps, from the port's seed-0 init), and plans on
   the weights it trained.
2. Solve the unified optimization (Eq. 8) for the split point and the
   front and back bits under an edge memory budget of 0.9 of the model's
   parameters in bytes, with copy accuracy as the constraint (a drop of
   at most 0.05), over ℓ ∈ {1, 2, 3} and bits ∈ {4, 8}.
3. Deploy the solution with ``SplitEngine``: OPSC front codes through K7,
   TS + TAB-Q payloads through K6 and K5, the ε-outage channel model and
   Algorithm 2's early exit under a 0.5 s deadline.
4. Report accuracy, uplink bits and modelled latency against the
   monolithic engine. The last line of the output is one JSON object.

A candidate's copy accuracy depends only on (ℓ, ``qw_front``): the split
engine reads ``qa_front`` and ``qa_back`` only in Eq. 3's uplink
accounting, so the accuracy function is memoized by that pair.

  python examples/split_inference_torch.py [--steps 250] [--device cpu]

Without ``--device`` it runs on the card (``cuda``) and raises without
one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.channel import ChannelConfig, optimal_rate  # noqa: E402
from repro_torch.core.opsc import OPSCConfig  # noqa: E402
from repro_torch.core.split_optimizer import (SplitSearchSpace,  # noqa: E402
                                              optimize_split)
from repro_torch.data.pipeline import (induction_batch,  # noqa: E402
                                       induction_loader)
from repro_torch.models.transformer import RuntimeOpts  # noqa: E402
from repro_torch.params import load_npz_checkpoint  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.split_engine import SplitEngine  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_loop import TrainConfig, train  # noqa: E402

OPTS = RuntimeOpts(q_chunk=64, kv_chunk=64, moe_capacity_factor=0.0)
VEHICLE = os.path.join(ROOT, "experiments", "vehicles", "induction")
SEQ, HALF, PROMPTS, PLAN_PROMPTS = 33, 16, 32, 8
CACHE_LEN = 128
SPACE = SplitSearchSpace(split_layers=[1, 2, 3], qw_bits=(4, 8),
                         qa_bits=(4, 8))
BUDGET_SHARE, ACCURACY_DROP, MAX_TOKENS = 0.9, 0.05, 64


def vehicle_config():
    """``benchmarks/common.py``'s vehicle: llama2-7b tiny, vocabulary 64,
    4 blocks (4 layers, so 3 split candidates)."""
    return dataclasses.replace(get_config("llama2-7b").tiny(),
                               vocab_size=64, num_blocks=4)


def train_vehicle(cfg, steps: int, device=None) -> tuple:
    """The vehicle trained on the port for ``steps`` steps of 32 copy
    sequences of 33 tokens (``examples/split_inference.py``'s step 1):
    (params, history)."""
    loader = induction_loader(cfg.vocab_size, batch=32, seq=SEQ,
                              num_batches=steps)
    tc = TrainConfig(AdamWConfig(lr=3e-3, warmup_steps=20,
                                 total_steps=steps))
    params, _, hist = train(cfg, loader, tc,
                            dataclasses.replace(OPTS, remat=False),
                            log_every=50, device=device)
    print(f"[split] trained: ce {hist[0]['ce']:.3f} → {hist[-1]['ce']:.3f}")
    return params, hist


def copy_prompts(vocab: int, n: int = PROMPTS, seed: int = 0) -> np.ndarray:
    """The example's copy prompts: ``induction_batch`` from seed 0."""
    prompts, _ = induction_batch(np.random.default_rng(seed), n, SEQ, vocab)
    return prompts.astype(np.int32)


def copy_accuracy(tokens: np.ndarray, prompts: np.ndarray) -> float:
    """Share of the generated half equal to the prompt's prefix."""
    return float(np.mean(tokens[:, HALF + 1:2 * HALF + 1]
                         == prompts[:, :HALF]))


def plan(cfg, params, prompts, device=None) -> dict:
    """Eq. 8 on the vehicle: the monolithic copy accuracy, its
    ``SplitSolution`` (None when no candidate is feasible), the (ℓ,
    ``qw_front``) pairs whose accuracy the solver asked for, and the
    memoized accuracy of every pair of the search space (the solver's and
    the rest, for the report)."""
    mono = Engine(cfg, params, OPTS, cache_len=CACHE_LEN, device=device)
    base_acc = copy_accuracy(
        mono.generate(prompts[:, :HALF + 1], HALF).tokens, prompts)
    accs: dict = {}

    def acc_fn(opsc: OPSCConfig) -> float:
        key = (opsc.split_layer, opsc.qw_front)
        if key not in accs:
            eng = SplitEngine(cfg, params, opsc, opts=OPTS,
                              cache_len=CACHE_LEN, device=device)
            sub = prompts[:PLAN_PROMPTS]
            accs[key] = copy_accuracy(
                eng.generate(sub[:, :HALF + 1], HALF)[0], sub)
        return accs[key]

    mixer = cfg.pattern[0].mixer
    sol = optimize_split(
        num_layers=cfg.num_layers,
        layer_param_counts=cfg.layer_param_counts(),
        embed_params=cfg.embed_params(),
        kv_heads_dim=mixer.num_kv_heads * mixer.head_dim,
        max_tokens=MAX_TOKENS,
        memory_budget_bytes=int(cfg.total_params() * BUDGET_SHARE),
        accuracy_fn=acc_fn, base_accuracy=base_acc,
        accuracy_drop=ACCURACY_DROP, space=SPACE)
    scored = sorted(accs)
    for ell in SPACE.split_layers:  # the report's grid: every (ℓ, qw_front)
        for qw in SPACE.qw_bits:
            acc_fn(OPSCConfig(split_layer=ell, qw_front=qw))
    return {"base_accuracy": base_acc, "accuracies": accs, "scored": scored,
            "solution": sol,
            "budget_bytes": int(cfg.total_params() * BUDGET_SHARE)}


def deploy(cfg, params, opsc: OPSCConfig, prompts, device=None) -> tuple:
    """The solution served with the ε-outage channel and a 0.5 s
    deadline: (copy accuracy, SplitStats, optimal rate in bit/s)."""
    chan = ChannelConfig()
    eng = SplitEngine(cfg, params, opsc, channel=chan, deadline_s=0.5,
                      opts=OPTS, cache_len=CACHE_LEN, device=device)
    out, stats = eng.generate(prompts[:, :HALF + 1], HALF)
    return copy_accuracy(out, prompts), stats, optimal_rate(chan)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--steps", type=int, default=0,
                    help="train the vehicle for this many steps first "
                         "(default 0: the committed vehicle)")
    args = ap.parse_args(argv)

    cfg = vehicle_config()
    training = None
    if args.steps > 0:
        params, hist = train_vehicle(cfg, args.steps, args.device)
        training = {"steps": args.steps, "ce_first": hist[0]["ce"],
                    "ce_last": hist[-1]["ce"]}
    else:
        params = load_npz_checkpoint(VEHICLE)
    prompts = copy_prompts(cfg.vocab_size)
    planned = plan(cfg, params, prompts, args.device)
    base_acc, sol = planned["base_accuracy"], planned["solution"]
    print(f"[split] monolithic copy-accuracy: {base_acc:.3f}")
    if sol is None:
        raise SystemExit("no feasible split configuration")
    c = sol.config
    print(f"[split] Eq.8 solution: ℓ={c.split_layer} "
          f"Qw=({c.qw_front},{c.qw_back}) Qa=({c.qa_front},{c.qa_back}) "
          f"Ψ={sol.psi} mem={sol.memory_bytes / 1e6:.1f}MB "
          f"acc={sol.accuracy:.3f}")

    split_acc, stats, rate = deploy(cfg, params, c, prompts, args.device)
    print(f"[split] split copy-accuracy: {split_acc:.3f} "
          f"(Δ {split_acc - base_acc:+.3f})")
    print(f"[split] uplink: measured {stats.uplink_bits_measured / 8e3:.1f} "
          f"KB, Eq.3 accounting {stats.uplink_bits_eq3 / 8e3:.1f} KB, "
          f"R*={rate / 1e6:.2f} Mbit/s, modeled latency "
          f"{stats.latency_s * 1e3:.1f} ms, early_exits={stats.early_exits}")
    result = {
        "solution": {"config": dataclasses.asdict(c), "psi": sol.psi,
                     "memory_bytes": sol.memory_bytes,
                     "accuracy": sol.accuracy},
        "budget_bytes": planned["budget_bytes"],
        "accuracy_drop": ACCURACY_DROP,
        "candidates": [{"split_layer": ell, "qw_front": qw, "accuracy": a,
                        "scored_by_solver": (ell, qw) in planned["scored"]}
                       for (ell, qw), a in sorted(
                           planned["accuracies"].items())],
        "training": training,
        "base_accuracy": base_acc, "split_accuracy": split_acc,
        "uplink_bits_measured": stats.uplink_bits_measured,
        "uplink_bits_eq3": stats.uplink_bits_eq3,
        "latency_s": stats.latency_s, "early_exits": stats.early_exits}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
