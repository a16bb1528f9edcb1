"""Batched sampler with per-request temperature / top-k / top-p and
per-request random lanes (port of ``repro/core/sampling.py``).

A request's token stream is a function of (its logits, its seed, its
generation index) only:

  * every per-request knob is a per-row device tensor, so a batch mixing
    greedy, temperature and nucleus requests runs one code path;
  * the random draw of row r at generation index t is Gumbel-max over a
    counter-based hash of (seed_r, t_r, vocab id), written in plain torch
    integer ops, so it never depends on the batch around the row. The
    reference draws with ``fold_in(PRNGKey(seed), t)``, which torch cannot
    reproduce: draws match the reference in distribution, not draw for
    draw;
  * the greedy lane is exact: rows with ``temperature <= 0`` or
    ``top_k == 1`` take ``argmax``.

:func:`speculative_verify` is the sampler half of speculative decoding:
it accepts a draft burst against one multi-token verify call's logits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_LATENCY_HINTS = ("interactive", "balanced", "batch")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters (the reference's dataclass, with
    the same validation and defaults: greedy, 16 tokens).

    ``temperature <= 0`` or ``top_k == 1`` selects the exact argmax lane;
    ``top_k = 0`` and ``top_p = 1.0`` disable their filters.
    ``stop_token_ids`` and ``eos_id`` form :attr:`stop_set`: the output is
    truncated at the first such token, inclusive, with reason ``"stop"``.
    ``logit_bias`` maps token ids to additive biases applied before the
    argmax and the filters; reported logprobs stay raw.
    ``prefix_key``/``prefix_len`` and ``latency_hint`` are read by the
    paged scheduler; ``priority`` orders its preemption; ``speculate_k``
    (0 disables) caps the request's draft burst on the paged and split
    backends. The fused backend ignores all five, as the reference's
    does."""

    max_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token_ids: tuple = ()
    eos_id: int | None = None
    priority: int = 0
    prefix_key: object = None
    prefix_len: int | None = None
    latency_hint: str = "balanced"
    speculate_k: int = 0
    logit_bias: object = None

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), got {self.top_k}")
        if self.speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0 (0 disables), "
                             f"got {self.speculate_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.latency_hint not in _LATENCY_HINTS:
            raise ValueError(f"latency_hint must be one of {_LATENCY_HINTS}, "
                             f"got {self.latency_hint!r}")
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        s = frozenset(self.stop_token_ids)
        if self.eos_id is not None:
            s |= {int(self.eos_id)}
        object.__setattr__(self, "_stop_set", s)
        lb = self.logit_bias
        if lb:
            items = lb.items() if hasattr(lb, "items") else lb
            lb = tuple(sorted((int(t), float(b)) for t, b in items))
            for tid, _ in lb:
                if tid < 0:
                    raise ValueError(
                        f"logit_bias token ids must be >= 0, got {tid}")
        else:
            lb = ()
        object.__setattr__(self, "logit_bias", lb)

    @property
    def greedy(self) -> bool:
        """Whether this request takes the exact-argmax lane."""
        return self.temperature <= 0.0 or self.top_k == 1

    @property
    def stop_set(self) -> frozenset:
        """Tokens that finish the request (``eos_id`` included)."""
        return self._stop_set


def broadcast_params(sampling, batch: int) -> list:
    """One :class:`SamplingParams` (applied to every row) or a sequence of
    ``batch`` → a validated list."""
    lst = [sampling] * batch if isinstance(sampling, SamplingParams) \
        else list(sampling)
    if len(lst) != batch:
        raise ValueError(f"need one SamplingParams per row: got {len(lst)} "
                         f"for batch {batch}")
    return lst


def sampling_operands(params_list, device=None) -> tuple:
    """The per-row operands :func:`sample_tokens` takes, on ``device``:
    (seeds (R,) int64 in [0, 2^32), temperature (R,) f32, top_k (R,)
    int64, top_p (R,) f32)."""
    return (torch.tensor([p.seed & _M32 for p in params_list],
                         dtype=torch.int64, device=device),
            torch.tensor([p.temperature for p in params_list],
                         dtype=torch.float32, device=device),
            torch.tensor([p.top_k for p in params_list],
                         dtype=torch.int64, device=device),
            torch.tensor([p.top_p for p in params_list],
                         dtype=torch.float32, device=device))


def bias_rows(params_list, vocab_size: int) -> np.ndarray:
    """Dense (R, V) f32 logit-bias rows; an all-zero row is the exact
    identity."""
    rows = np.zeros((len(params_list), vocab_size), np.float32)
    for i, p in enumerate(params_list):
        for tid, b in p.logit_bias:
            if tid >= vocab_size:
                raise ValueError(f"logit_bias token id {tid} out of range "
                                 f"for vocab size {vocab_size}")
            rows[i, tid] = b
    return rows


def truncate_at_stop(tokens, params: SamplingParams) -> tuple:
    """Truncate at the first stop-set token (inclusive) → (python int list,
    ``"stop"`` or ``"length"``)."""
    toks = [int(tok) for tok in tokens]
    stop = params.stop_set
    if stop:
        for j, tok in enumerate(toks):
            if tok in stop:
                return toks[: j + 1], "stop"
    return toks, "length"


def filtered_logits(logits, temperature, top_k, top_p):
    """Temperature-scale ``logits`` (R, V) and set everything outside the
    intersection of the per-row top-k and nucleus sets to ``NEG_INF`` (ties
    at a cutoff are kept; the argmax always survives). Returns (R, V) f32."""
    logits = logits.float()
    v = logits.shape[-1]
    safe_t = torch.where(temperature > 0.0, temperature,
                         torch.ones_like(temperature))
    z = logits / safe_t[:, None]
    sz = torch.sort(z, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, torch.full_like(top_k, v),
                    torch.clamp(top_k, max=v))
    kth = torch.gather(sz, 1, (k - 1)[:, None])[:, 0]
    # nucleus: keep sorted entries whose EXCLUSIVE cumulative probability
    # is < top_p (the top-1 entry always)
    probs = torch.softmax(sz, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    keep = cum < top_p[:, None]
    keep[:, 0] = True
    n_keep = keep.sum(dim=-1)
    pth = torch.gather(sz, 1, (n_keep - 1)[:, None])[:, 0]
    cutoff = torch.maximum(kth, pth)
    return torch.where(z >= cutoff[:, None], z, NEG_INF)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for x in [0, 2^32) held in int64, without any
    intermediate reaching 2^63 (16-bit halves)."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, two rounds)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_noise(seeds: torch.Tensor, t: torch.Tensor, vocab: int,
                  tag: int = 0):
    """Counter-based uniform noise in (0, 1), (R, V) f32: entry (r, i) is a
    hash of (seeds[r], t[r], i) alone. A nonzero ``tag`` hashes in a
    further constant, giving a stream of its own at the same (seed, t);
    tag 0 is the token draw's stream."""
    row = _mix32(_mix32(seeds & _M32) ^ (t.to(torch.int64) & _M32))
    if tag:
        row = _mix32(row ^ (tag & _M32))
    ids = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _mix32(_mix32(row[:, None] ^ ids[None, :]))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _gumbel_argmax(masked, seeds, t, tag: int = 0):
    """Gumbel-max over ``masked`` (N, V) with :func:`uniform_noise` of
    (seeds, t, tag): the draw :func:`sample_tokens` makes at tag 0."""
    u = uniform_noise(seeds, t, masked.shape[-1], tag)
    return torch.argmax(masked - torch.log(-torch.log(u)), dim=-1)


def sample_tokens(logits, seeds, t, temperature, top_k, top_p, bias=None):
    """One token per row: ``logits`` (R, V) (promoted to f32), operands
    from :func:`sampling_operands`, ``t`` (R,) the per-row generation index,
    ``bias`` optional (R, V) f32 added before everything. Greedy rows get
    the exact argmax; the rest draw by Gumbel-max from
    :func:`filtered_logits`. Returns (R,) int64."""
    logits = logits.float()
    if bias is not None:
        logits = logits + bias
    greedy_tok = torch.argmax(logits, dim=-1)
    use_greedy = (temperature <= 0.0) | (top_k == 1)
    masked = filtered_logits(logits, temperature, top_k, top_p)
    sampled = _gumbel_argmax(masked, seeds, torch.clamp(t, min=0))
    return torch.where(use_greedy, greedy_tok, sampled)


def token_logprobs(logits, tokens):
    """Log-probability of each row's token under the row's raw softmax
    (untempered, unfiltered). ``logits`` (..., V), ``tokens`` (...) →
    (...) f32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tokens[..., None].long())[..., 0]


def sample_tokens_with_logprobs(logits, seeds, t, temperature, top_k, top_p,
                                bias=None):
    """:func:`sample_tokens` and each drawn token's :func:`token_logprobs`
    value under the RAW logits (``bias`` reshapes the draw only). Returns
    ((R,) int64 tokens, (R,) f32 logprobs)."""
    toks = sample_tokens(logits, seeds, t, temperature, top_k, top_p, bias)
    return toks, token_logprobs(logits, toks)


# the speculative accept and residual draws' stream tags (uniform_noise):
# the token draw at generation index t has tag 0, so the three streams at
# one (seed, t) never coincide; reusing the token stream for acceptance
# would tie "was the draft accepted" to "which token would be drawn"
_ACCEPT_TAG = 0x5EC00001
_RESIDUAL_TAG = 0x5EC00002


def _leading(accept: torch.Tensor) -> torch.Tensor:
    """Per row, how many leading entries of ``accept`` (R, K) are True."""
    return torch.cumprod(accept.long(), dim=-1).sum(dim=-1)


def speculative_verify(draft, draft_len, logits, seeds, t0, temperature,
                       top_k, top_p, bias=None):
    """Accept a draft burst per row against one multi-token verify call.

    ``draft`` (R, K) int, each row's proposed tokens (anything past
    ``draft_len``); ``draft_len`` (R,) int in [0, K]; ``logits``
    (R, K + 1, V): column j is the target distribution of generation index
    ``t0 + j`` given the drafts before j; ``seeds``, ``temperature``,
    ``top_k``, ``top_p`` as :func:`sample_tokens` takes them; ``t0`` (R,)
    the generation index of the round's first token; ``bias`` optional
    (R, V), added at every column before everything.

    Greedy rows (``temperature <= 0`` or ``top_k == 1``) accept draft j
    iff it equals column j's argmax and emit the argmaxes: the stream of
    non-speculative greedy decoding, whatever was drafted. Other rows take
    rejection sampling against the point-mass draft: draft j is accepted
    with its probability under :func:`filtered_logits` (the distribution
    :func:`sample_tokens` draws from), the first rejection draws from the
    rest of that distribution, and after a fully accepted burst the bonus
    token at column ``draft_len`` is drawn with the very bits
    :func:`sample_tokens` uses at that generation index, so a round with
    ``draft_len == 0`` is exactly a non-speculative draw. The accept and
    residual draws hash in their own tags. Plain torch on the logits'
    device, no host sync.

    Returns (out (R, K + 1) int64, n_out (R,) int64, logprobs (R, K + 1)
    f32): row r emits ``out[r, :n_out[r]]`` (1 <= n_out <= draft_len + 1),
    and ``logprobs`` are :func:`token_logprobs` under the raw verify
    logits (bias left out)."""
    raw = logits.float()
    lg = raw if bias is None else raw + bias[:, None, :]
    r, k1, v = lg.shape
    kd = k1 - 1
    dev = lg.device
    draft = draft.long().reshape(r, kd)
    draft_len = draft_len.long()
    t0 = torch.clamp(t0.long(), min=0)
    tgt = torch.argmax(lg, dim=-1)  # (R, K + 1)
    in_draft = torch.arange(kd, device=dev)[None, :] < draft_len[:, None]
    use_greedy = (temperature <= 0.0) | (top_k == 1)
    g_m = _leading((draft == tgt[:, :kd]) & in_draft)

    # non-greedy lanes: every column's filtered distribution, its fresh
    # draw at t0 + j (sample_tokens' bits), the accept and residual draws
    rep = lambda x: x.repeat_interleave(k1)  # noqa: E731
    tj = t0[:, None] + torch.arange(k1, device=dev)[None, :]  # (R, K + 1)
    masked = filtered_logits(lg.reshape(r * k1, v), rep(temperature),
                             rep(top_k), rep(top_p))
    fresh = _gumbel_argmax(masked, rep(seeds), tj.reshape(-1)).reshape(r, k1)
    masked = masked.reshape(r, k1, v)[:, :kd]  # the drafted columns
    ds = seeds.repeat_interleave(kd)
    dt = tj[:, :kd].reshape(-1)
    p_draft = torch.gather(torch.softmax(masked, dim=-1), -1,
                           draft[..., None])[..., 0]  # (R, K)
    u = uniform_noise(ds, dt, 1, _ACCEPT_TAG).reshape(r, kd)
    m = _leading((u < p_draft) & in_draft)
    # the residual at a rejection: the target without the drafted token
    no_draft = masked.scatter(-1, draft[..., None], NEG_INF)
    resid = _gumbel_argmax(no_draft.reshape(r * kd, v), ds, dt,
                           _RESIDUAL_TAG).reshape(r, kd)
    jj = torch.arange(k1, device=dev)[None, :]
    pad = torch.zeros((r, 1), dtype=torch.long, device=dev)
    rejected = (jj == m[:, None]) & (m < draft_len)[:, None]
    ng_out = torch.where(jj < m[:, None], torch.cat([draft, pad], 1),
                         torch.where(rejected, torch.cat([resid, pad], 1),
                                     fresh))
    out = torch.where(use_greedy[:, None], tgt, ng_out)
    n_out = torch.where(use_greedy, g_m, m) + 1
    return out, n_out, token_logprobs(raw, out)
