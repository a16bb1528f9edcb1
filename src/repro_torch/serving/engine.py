"""Batched serving engine: one prefill and an on-device decode loop (port
of ``repro/serving/engine.py``).

The loop keeps the sampled tokens, their logprobs, the logits and the
write position on the device; nothing is read back to the host between
steps, and the finished tokens and logprobs are copied to the host once at
the end. With ``RuntimeOpts(quantized_kv=True)`` each decode step streams
the int8 KV cache through the decode-attention CUDA kernel at every
attention layer; a Mamba-2 layer carries its conv and recurrent states
through the loop instead (``transformer.init_caches``), each step writing
them in place.

Prompts are (B, S) token ids, or (B, S, K) on a codebook config
(musicgen), whose tokens and logprobs then carry the codebook axis; the
vision stub (qwen2-vl) takes ``patches=`` (B, num_patches, d_vision),
projected over the prompt's first ``num_patches`` positions.

Requests are batched by equal prompt length. Unlike the reference, which
rounds the number of decode steps up to a power of two so that lengths
share XLA compiles, the port runs exactly ``max_new - 1`` decode steps;
the first ``max_new`` tokens are the same.

With ``telemetry=`` (a ``serving.telemetry.Tracer``) each call lands one
``"fused_generate"`` span on the ``"engine"`` track and ``fused.*``
counters; the span ends after a sync of the device's current stream, made
only when a tracer is attached.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sampling import (SamplingParams, bias_rows,
                                       broadcast_params, sample_tokens,
                                       sampling_operands, token_logprobs)
from repro_torch.device import resolve_device, stream_sync
from repro_torch.models.transformer import RuntimeOpts, decode_step, prefill


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, prompt + generated)
    steps: int
    # (B, generated) f32: each emitted token's log-probability under the
    # raw model distribution; None only for zero-step generations
    logprobs: np.ndarray | None = None


def _fused_generate(params, cfg, opts, cache_len, max_new, tokens, sample,
                    patches=None):
    """One prefill (``patches`` feed the vision stub), then ``max_new - 1``
    decode steps; ``sample(logits, t)`` draws the token at index ``t`` (a
    0-d device tensor) from the logits carried in from the previous step,
    and the last token needs no step. Returns device tensors
    ((B, prompt + max_new) tokens, (B, max_new) logprobs), each with a
    trailing codebook axis K on a codebook config."""
    b, s = tokens.shape[:2]
    logits, caches = prefill(params, cfg, tokens, cache_len, opts, patches)
    rest = tuple(tokens.shape[2:])  # (K,) with codebooks
    toks = torch.empty((b, max_new) + rest, dtype=tokens.dtype,
                       device=tokens.device)
    lps = torch.empty((b, max_new) + rest, dtype=torch.float32,
                      device=tokens.device)
    t = torch.zeros((), dtype=torch.int32, device=tokens.device)
    for i in range(max_new):
        nxt = sample(logits, t)
        toks[:, i] = nxt
        lps[:, i] = token_logprobs(logits, nxt)
        if i + 1 < max_new:
            # the token at index t is written at position s + t
            logits, caches = decode_step(params, cfg, toks[:, i:i + 1],
                                         caches, t + s, opts)
            t += 1
    return torch.cat([tokens, toks], dim=1), lps


def make_sampler(sampling: list, vocab_size: int, device):
    """``sample(logits (B, V), t)`` → (B,) tokens for the rows'
    :class:`SamplingParams`, ``t`` a 0-d device tensor, the generation
    index of the token drawn. All-greedy batches take a plain argmax (with
    any logit bias added first; on codebook logits (B, K, V) one a
    codebook); the rest draw through :func:`sample_tokens`."""
    b = len(sampling)
    bias = None
    if any(p.logit_bias for p in sampling):
        bias = torch.as_tensor(bias_rows(sampling, vocab_size), device=device)
    if all(p.greedy for p in sampling):
        def sample(logits, t):
            return torch.argmax(logits if bias is None else logits + bias,
                                dim=-1)
    else:
        seeds, temp, top_k, top_p = sampling_operands(sampling, device)

        def sample(logits, t):
            return sample_tokens(logits, seeds, t.expand(b), temp, top_k,
                                 top_p, bias)
    return sample


class Engine:
    """``Engine(cfg, params, opts, cache_len=4096, telemetry=None,
    device=None)``: params (the flat dict of :mod:`repro_torch.params`) are
    moved to ``device``, which is ``cuda`` unless the caller names another;
    with no device and no CUDA card the constructor raises. ``telemetry``
    takes a ``Tracer`` (module docstring)."""

    def __init__(self, cfg: ArchConfig, params, opts: RuntimeOpts = RuntimeOpts(),
                 cache_len: int = 4096, telemetry=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.opts = opts
        self.cache_len = cache_len
        # serving.telemetry.Tracer or None: None skips every tracer call
        # and the sync that ends the span
        self.telemetry = telemetry

    def _span(self, t0: float, *, batch: int, prompt_len: int,
              max_new: int) -> None:
        """Close one call's span; the sync makes it cover the device work
        (values are untouched)."""
        tel = self.telemetry
        stream_sync(self.device)
        t1 = tel.now()
        tel.add_span("fused_generate", t0, t1, track="engine", batch=batch,
                     prompt_len=prompt_len, max_new=max_new)
        tel.metrics.count("fused.calls")
        tel.metrics.count("fused.requests", batch)
        tel.metrics.count("fused.tokens", batch * max_new)
        tel.metrics.observe("fused.batch_s", t1 - t0)

    def _prompts(self, prompts) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(prompts), device=self.device)
        k = self.cfg.num_codebooks
        if k > 1 and (tokens.dim() != 3 or tokens.shape[2] != k):
            raise ValueError(f"prompts must be (B, S, {k}) codebook token "
                             f"ids, got shape {tuple(tokens.shape)}")
        if k == 1 and tokens.dim() != 2:
            raise ValueError(f"prompts must be (B, S) token ids, got shape "
                             f"{tuple(tokens.shape)}")
        return tokens

    @torch.inference_mode()
    def _run(self, tokens, max_new: int, sample, patches=None):
        tel = self.telemetry
        t0 = tel.now() if tel is not None else 0.0
        out, lps = _fused_generate(self.params, self.cfg, self.opts,
                                   self.cache_len, max_new, tokens, sample,
                                   patches)
        if tel is not None:
            self._span(t0, batch=tokens.shape[0], prompt_len=tokens.shape[1],
                       max_new=max_new)
        return GenerationResult(out.cpu().numpy(), max_new,
                                logprobs=lps.cpu().numpy())

    def generate_requests(self, prompts, sampling,
                          patches=None) -> GenerationResult:
        """Serve a batch of equal-length prompts (B, S) (or (B, S, K) on a
        codebook config) with per-request :class:`SamplingParams` (one for
        every row, or a list of B). Runs to the batch's largest
        ``max_tokens``; per-row ``max_tokens`` and stop truncation are the
        caller's (``serving.api`` does both). All-greedy batches take a
        plain argmax; codebook prompts take greedy rows only, as the
        reference's. ``patches`` (B, num_patches, d_vision) feed the
        vision stub."""
        tokens = self._prompts(prompts)
        b, s = tokens.shape[:2]
        sampling = broadcast_params(sampling, b)
        if tokens.dim() != 2 and not all(p.greedy for p in sampling):
            raise NotImplementedError(
                "non-greedy sampling needs (B, S) token prompts")
        max_new = max(p.max_tokens for p in sampling)
        if s + max_new > self.cache_len:
            raise ValueError(f"prompt {s} + max_tokens {max_new} exceeds "
                             f"cache_len {self.cache_len}")
        return self._run(tokens, max_new,
                         make_sampler(sampling, self.cfg.vocab_size,
                                      self.device), self._patches(patches))

    def _patches(self, patches):
        return None if patches is None else torch.as_tensor(
            np.asarray(patches), device=self.device)

    def generate(self, prompts, max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0, patches=None) -> GenerationResult:
        """``prompts`` (B, S) int, equal lengths, or (B, S, K) on a
        codebook config (musicgen: the tokens come back (B, S + T, K), the
        logprobs (B, T, K)). ``temperature > 0`` samples every row at that
        temperature, row r with seed ``seed + r``; with codebooks each
        (row r, codebook k) draws on its own, with seed ``seed + r·K + k``.
        ``patches`` (B, num_patches, d_vision) are the vision stub's
        pre-projector patch embeddings (qwen2-vl): they replace the
        prompt's first ``num_patches`` positions."""
        tokens = self._prompts(prompts)
        b, s = tokens.shape[:2]
        if s + max_new_tokens > self.cache_len:
            raise ValueError(f"prompt {s} + max_new_tokens {max_new_tokens} "
                             f"exceeds cache_len {self.cache_len}")
        if max_new_tokens == 0:
            return GenerationResult(tokens.cpu().numpy(), 0)
        k = self.cfg.num_codebooks
        if k == 1 or temperature <= 0:
            return self.generate_requests(prompts, [
                SamplingParams(max_tokens=max_new_tokens,
                               temperature=temperature, seed=seed + r)
                for r in range(b)], patches)
        # one sampler row a (row, codebook)
        rows = make_sampler([SamplingParams(temperature=temperature,
                                            seed=seed + i)
                             for i in range(b * k)], self.cfg.vocab_size,
                            self.device)

        def sample(logits, t):
            return rows(logits.reshape(b * k, -1), t).reshape(b, k)

        return self._run(tokens, max_new_tokens, sample,
                         self._patches(patches))
