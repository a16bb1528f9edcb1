"""Synthetic data pipeline (port of ``repro/data/pipeline.py``, which is
numpy only: this is the port's own copy, the same arrays for the same
``np.random.default_rng`` seeds).

Two corpora, no external data:

* **Zipf–Markov LM**: a deterministic sparse Markov chain over the
  vocabulary with Zipf-distributed transition weights; a model must learn
  the transition structure, so perplexity is meaningful (the paper's
  Table 4 analog).
* **Induction-copy task**: sequences ``[prefix][SEP][prefix]``; next-token
  accuracy on the second half needs attention to work (the accuracy
  vehicle of Tables 2, 3 and 5; TS and TAB-Q distortion disrupts the
  induction heads). The committed induction vehicle
  (``experiments/vehicles/induction``) was trained on it, and the split
  planner (``examples/split_inference_torch.py``) scores copy accuracy on
  its prompts.

Batches are dicts {tokens, labels (shifted), loss_mask}. The loaders
prefetch on a background thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass
class ZipfMarkov:
    """Deterministic sparse Markov chain with Zipf marginals."""

    vocab_size: int
    branching: int = 8  # successors per state
    alpha: float = 1.2  # Zipf exponent
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v, b = self.vocab_size, self.branching
        self.successors = rng.integers(0, v, size=(v, b))
        w = rng.zipf(self.alpha, size=(v, b)).astype(np.float64)
        self.probs = w / w.sum(axis=1, keepdims=True)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int64)
        state = rng.integers(0, self.vocab_size, size=batch)
        for t in range(seq):
            out[:, t] = state
            choice = np.array([rng.choice(self.branching, p=self.probs[s]) for s in state])
            state = self.successors[state, choice]
        return out

    def entropy_rate_bits(self) -> float:
        """Per-token entropy of the chain (uniform stationary approx) —
        lower bound on achievable loss, used to sanity-check training."""
        h = -np.sum(self.probs * np.log2(np.maximum(self.probs, 1e-12)), axis=1)
        return float(np.mean(h))


def induction_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
                    sep_token: int | None = None):
    """[prefix][SEP][prefix] sequences. Returns (tokens, loss_mask) where the
    mask selects the copied half (where accuracy is measurable)."""
    sep = sep_token if sep_token is not None else vocab - 1
    half = (seq - 1) // 2
    prefix = rng.integers(0, vocab - 1, size=(batch, half))
    tokens = np.concatenate(
        [prefix, np.full((batch, 1), sep), prefix], axis=1)[:, :seq]
    mask = np.zeros((batch, seq), np.float32)
    mask[:, half + 1:] = 1.0  # predictable (copied) region
    return tokens.astype(np.int64), mask


def make_batch(tokens: np.ndarray, loss_mask: np.ndarray | None = None) -> dict:
    """Next-token LM batch: labels are tokens shifted left."""
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1] * 0], axis=1)
    if loss_mask is None:
        loss_mask = np.ones_like(labels, np.float32)
        loss_mask[:, -1] = 0.0
    else:
        loss_mask = loss_mask[:, 1:]
        loss_mask = np.concatenate([loss_mask, np.zeros_like(loss_mask[:, :1])], 1)
    return {"tokens": tokens, "labels": labels, "loss_mask": loss_mask}


class DataLoader:
    """Background-thread prefetching iterator over a batch factory."""

    def __init__(self, batch_fn, num_batches: int, prefetch: int = 4):
        self.batch_fn = batch_fn
        self.num_batches = num_batches
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self):
        for i in range(self.num_batches):
            self.q.put(self.batch_fn(i))
        self.q.put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item


def lm_loader(corpus: ZipfMarkov, batch: int, seq: int, num_batches: int,
              seed: int = 1) -> DataLoader:
    def fn(i):
        rng = np.random.default_rng(seed + i)
        return make_batch(corpus.sample(rng, batch, seq))

    return DataLoader(fn, num_batches)


def induction_loader(vocab: int, batch: int, seq: int, num_batches: int,
                     seed: int = 1) -> DataLoader:
    def fn(i):
        rng = np.random.default_rng(seed + i)
        tokens, mask = induction_batch(rng, batch, seq, vocab)
        return make_batch(tokens, mask)

    return DataLoader(fn, num_batches)
