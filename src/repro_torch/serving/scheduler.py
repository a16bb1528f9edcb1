"""Continuous-batching scheduler over the paged KV pool, with explicit
prefix sharing (port of ``repro/serving/scheduler.py``, the ``"chunked"``
and ``"wave"`` ticks with reserve admission).

Requests of ragged prompt and generation lengths share one decode batch and
one pool; a finished request's slot and pages go to the next queued request
without draining the batch. Per request:

  admit   — the queue head is admitted when a slot row and the pages of its
            WORST case (prompt + max_new_tokens) are free, so a decode can
            never meet an exhausted pool: the queue is the backpressure. A
            request submitted with ``prefix_key=`` attaches to the shared
            prefix: the first such request (the creator) prefills the whole
            prompt and its prefix pages are pinned as a
            ``kv_pool.SharedPrefix``; later requests FORK, their tables
            aliasing the pinned pages, and prefill only their suffix;
  prefill — ``tick_mode="chunked"`` (default): every prompt goes in fixed
            ``prefill_chunk``-token pieces, and each tick advances every
            mid-prefill slot by one chunk through one fixed-shape
            ``(max_slots, chunk)`` call. First chunks attend only
            themselves (``transformer.paged_prefill``, the same math as
            ``Engine``'s prefill); continuation chunks and forks also attend
            their pool history (``transformer.paged_prefill_shared``, kernel
            K3). ``"wave"``: the admitted group prefills raggedly in one
            right-aligned call of a bucketed ``(R_adm, S_pad)`` shape;
  decode  — every decoding slot steps together through one fixed
            ``(max_slots, 1)`` ``paged_decode_step`` (kernel K2), each row at
            its own position; free and mid-prefill rows ride along masked;
  evict   — at ``max_tokens`` or a stop token the slot's page references go
            back to the pool.

Sampling runs on the device with per-slot operands (seed, temperature,
top-k, top-p, logit bias), uploaded only when a slot's row changes; a row's
draw depends on its seed, its own generation index and its logits alone,
so a seeded request draws the same stream here as on the fused backend
wherever the two paths give it bit-identical logits (in f32 on the CPU; in
bf16 on the card their logits differ and so may the draws). Each tick reads
back only the sampled tokens and their logprobs, in one copy.

Not ported yet, and refused with ``NotImplementedError``: lazy growth with
preemption and swap, the packed tick, speculation, ``auto_prefix``,
``mesh=`` and telemetry (ROADMAP queue 1, items 6, 7 and 9).
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sampling import (SamplingParams, bias_rows,
                                       sample_tokens_with_logprobs,
                                       truncate_at_stop)
from repro_torch.device import resolve_device, to_device
from repro_torch.models.transformer import (RuntimeOpts, paged_decode_step,
                                            paged_prefill,
                                            paged_prefill_shared)
from repro_torch.serving.kv_pool import (DEFAULT_PAGE_SIZE, PagedKVPool,
                                         PoolExhaustedError)

# the adaptive-prefill ladder ``prefill_chunk="auto"`` expands to, picked
# per tick by batch composition (Scheduler._pick_chunk)
AUTO_CHUNK_LADDER = (64, 128, 256)

# the operands of a free slot row: greedy, no filters, no bias
_GREEDY = SamplingParams()

_NOT_PORTED = {
    "lazy_growth": "lazy growth with preemption and swap (ROADMAP queue 1, "
                   "item 6.4)",
    "packed": "the packed tick and token_budget (ROADMAP queue 1, item 6.2)",
    "speculate_k": "speculative decoding (ROADMAP queue 1, item 6.3)",
    "auto_prefix": "auto_prefix (ROADMAP queue 1, item 6.4)",
    "mesh": "mesh= (ROADMAP queue 1, item 9)",
    "telemetry": "telemetry (ROADMAP queue 1, item 7)",
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    sampling: SamplingParams  # every per-request knob, stop set included
    prefix_key: object = None  # hashable; same key ⇒ shared prompt prefix
    submit_tick: int = 0  # scheduler tick at submission (TTFT in ticks)

    @property
    def max_new_tokens(self) -> int:
        return self.sampling.max_tokens


@dataclasses.dataclass
class _PrefixEntry:
    """Registry row for one shared prompt prefix."""

    key: object
    tokens: np.ndarray  # (prefix_len,) int32, checked on every submit
    handle: object = None  # kv_pool.SharedPrefix once materialized
    creator_rid: int | None = None  # request whose prefill writes it


@dataclasses.dataclass
class _SlotState:
    req: Request
    generated: list
    prefilled: int = 0  # prompt TOKENS already written to the pool

    @property
    def prefilling(self) -> bool:
        """More chunks to write before the slot decodes."""
        return self.prefilled < len(self.req.prompt)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        return bool(self.generated
                    and self.generated[-1] in self.req.sampling.stop_set)


@dataclasses.dataclass
class SchedulerStats:
    steps: int = 0  # decode steps executed
    prefills: int = 0  # prefill CALLS (waves, or per-tick chunk calls)
    shared_prefill_calls: int = 0  # of those, calls that attend the pool
    #                                (continuation chunks and forks: K3)
    prefill_chunks: int = 0  # per-slot chunks written (chunked mode)
    admitted: int = 0
    evicted: int = 0  # completed requests
    aborted: int = 0
    prefix_forks: int = 0  # admissions that attached to a shared prefix
    slot_ticks: int = 0  # Σ decoding slots over decode steps
    peak_occupancy: float = 0.0
    peak_pool_bytes: int = 0  # physical page bytes (shared pages once)
    peak_eq2_bytes: int = 0  # logical per-request Eq. 2 bytes
    peak_shared_pages: int = 0  # pages with refcount > 1
    compiled_shapes: int = 0  # distinct step-call shapes (kind, R, S)
    prefill_tokens: int = 0  # prompt TOKENS written by prefill calls
    # rid → ticks from submit to the first sampled token
    ttft_ticks: dict = dataclasses.field(default_factory=dict)
    # chunk size → ticks it was picked (adaptive prefill_chunk)
    auto_chunks: dict = dataclasses.field(default_factory=dict)


def _bucket(n: int) -> int:
    """Next power of two: bounds the distinct wave-prefill shapes."""
    return 1 << max(0, (n - 1).bit_length())


class Scheduler:
    """Continuous-batching front end over one shared ``PagedKVPool`` on
    ``device`` (``cuda`` unless the caller names another; raises with no
    card). ``submit`` enqueues; ``step`` runs one admit → prefill → decode
    → evict tick; ``run`` drains. ``prefill_chunk`` is a size, ``"auto"``
    (:data:`AUTO_CHUNK_LADDER`) or a tuple of sizes, picked per tick: small
    when decoding slots dominate or one hints
    ``latency_hint="interactive"``, large when the batch is prefill-heavy.

    Not thread-safe: ``submit``, ``abort`` and ``step`` must run on one
    thread."""

    def __init__(self, cfg: ArchConfig, params,
                 opts: RuntimeOpts = RuntimeOpts(), *,
                 num_pages: int = 128, page_size: int = DEFAULT_PAGE_SIZE,
                 max_slots: int = 4, max_seq_len: int | None = None,
                 lazy_growth: bool = False,
                 prefill_chunk: int | str | tuple = 256,
                 tick_mode: str = "chunked",
                 token_budget: int | None = None, speculate_k: int = 0,
                 auto_prefix: bool = False, telemetry=None, mesh=None,
                 device=None):
        if tick_mode not in ("packed", "chunked", "wave"):
            raise ValueError(f"tick_mode must be 'packed', 'chunked' or "
                             f"'wave', got {tick_mode}")
        refused = {"lazy_growth": lazy_growth,
                   "packed": tick_mode == "packed" or token_budget is not None,
                   "speculate_k": speculate_k > 0, "auto_prefix": auto_prefix,
                   "mesh": mesh is not None,
                   "telemetry": telemetry is not None}
        for name, on in refused.items():
            if on:
                raise NotImplementedError(f"{_NOT_PORTED[name]} is not "
                                          f"ported yet")
        if prefill_chunk == "auto":
            ladder = AUTO_CHUNK_LADDER
        elif isinstance(prefill_chunk, (tuple, list)):
            ladder = tuple(sorted({int(c) for c in prefill_chunk}))
        else:
            ladder = (int(prefill_chunk),)
        if not ladder or min(ladder) < 1:
            raise ValueError(
                f"prefill_chunk sizes must be >= 1, got {prefill_chunk!r}")
        self.device = resolve_device(device)
        self.cfg, self.opts = cfg, opts
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.pool = PagedKVPool(cfg, num_pages=num_pages, page_size=page_size,
                                max_requests=max_slots,
                                max_seq_len=max_seq_len, device=self.device)
        self.max_slots = max_slots
        self.tick_mode = tick_mode
        # no prompt exceeds the block table's reach, so no chunk need either
        reach = self.pool.max_blocks * page_size
        self._chunk_ladder = tuple(sorted({min(c, reach) for c in ladder}))
        self.prefill_chunk = self._chunk_ladder[-1]
        self._tick = 0
        self._shapes: set = set()  # distinct step-call shapes dispatched
        self.queue: deque = deque()
        self.slots: list = [None] * max_slots
        self.results: dict = {}
        self.finish_reasons: dict = {}  # rid → "stop" | "length" | "abort"
        self.stats = SchedulerStats()
        self._prefixes: dict = {}
        self._next_rid = 0
        # streamed (rid, index, token, logprob) events and finished rids,
        # drained by serving.api.PagedBackend
        self._events: list = []
        self._finished: list = []
        # per-slot sampling operands: host rows, changed at admit/evict;
        # the device copy is rebuilt only after a change. Freed rows reset
        # to greedy.
        v = cfg.vocab_size
        self._op_seed = np.zeros((max_slots,), np.int64)
        self._op_temp = np.zeros((max_slots,), np.float32)
        self._op_topk = np.zeros((max_slots,), np.int64)
        self._op_topp = np.ones((max_slots,), np.float32)
        self._op_bias = np.zeros((max_slots, v), np.float32)
        self._dev_ops: tuple | None = None

    # -------------------------------------------------------------- intake

    def submit(self, prompt, max_new_tokens: int | None = None,
               eos_id: int | None = None,
               *, prefix_key=None, prefix_len: int | None = None,
               priority: int | None = None,
               sampling: SamplingParams | None = None) -> int:
        """Enqueue a request; returns its rid. Either ``sampling`` (every
        per-request knob, the single source of truth) or the legacy form
        ``submit(prompt, max_new_tokens, eos_id, prefix_key=, ...)``.

        ``prefix_key`` (hashable) declares that the prompt's first
        ``prefix_len`` TOKENS are shared verbatim with every request of the
        same key: the key's first submit fixes the length (default: the
        whole prompt minus one token), later ones inherit it. The shared
        length is capped at ``len(prompt) - 1`` and must match token for
        token."""
        if sampling is None:
            if max_new_tokens is None:
                raise ValueError("submit needs max_new_tokens or sampling=")
            sampling = SamplingParams(
                max_tokens=int(max_new_tokens), eos_id=eos_id,
                priority=priority or 0, prefix_key=prefix_key,
                prefix_len=prefix_len)
        elif any(a is not None for a in (max_new_tokens, eos_id, prefix_key,
                                         prefix_len, priority)):
            raise ValueError(
                "pass either sampling= or the legacy arguments, not both — "
                "sampling is the single source of truth when given")
        prefix_key, prefix_len = sampling.prefix_key, sampling.prefix_len
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("cannot submit an empty prompt")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, sampling, submit_tick=self._tick)
        if prefix_key is not None:
            entry = self._prefixes.get(prefix_key)
            if prefix_len is not None:
                plen = int(prefix_len)
            elif entry is not None:
                plen = int(entry.tokens.size)  # inherit the key's length
            else:
                plen = prompt.size - 1
            plen = min(plen, prompt.size - 1)
            if plen >= 1:
                if entry is None:
                    entry = _PrefixEntry(prefix_key, prompt[:plen].copy())
                    self._prefixes[prefix_key] = entry
                elif entry.tokens.size != plen or not np.array_equal(
                        entry.tokens, prompt[:plen]):
                    raise ValueError(
                        f"prefix_key {prefix_key!r}: request {rid}'s "
                        f"declared {plen}-token prefix does not match the "
                        f"registered {entry.tokens.size}-token one")
                req.prefix_key = prefix_key
        self.queue.append(req)
        return rid

    def release_prefixes(self) -> None:
        """Release every pinned shared prefix (its pages return once the
        last attached request finishes) and drop registry entries no queued
        or running request names. ``run`` calls this after draining."""
        for entry in self._prefixes.values():
            if entry.handle is not None:
                self.pool.release_prefix(entry.handle)
                entry.handle = None
                entry.creator_rid = None
        live = {r.prefix_key for r in self.queue} | {
            st.req.prefix_key for st in self.slots if st is not None}
        self._prefixes = {k: e for k, e in self._prefixes.items()
                          if k in live}

    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it is — queued, mid-prefill or
        decoding. The partial result (prompt + tokens emitted so far) is
        recorded with reason ``"abort"``; a live slot's pages return to
        the pool now. False when the rid is unknown or already finished."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._finish_abort(req, [])
                return True
        for i, st in enumerate(self.slots):
            if st is not None and st.req.rid == rid:
                self.pool.free(i)
                self.slots[i] = None
                self._set_ops(i, _GREEDY)
                self._finish_abort(st.req, st.generated)
                return True
        return False

    def _finish_abort(self, req: Request, generated: list) -> None:
        # an aborted prefix creator must not strand waiting forks: the next
        # same-key admission materializes the prefix instead
        entry = self._prefixes.get(req.prefix_key) \
            if req.prefix_key is not None else None
        if entry is not None and entry.creator_rid == req.rid:
            entry.creator_rid = None
        self.results[req.rid] = np.concatenate(
            [req.prompt, np.asarray(generated, np.int32)])
        self.finish_reasons[req.rid] = "abort"
        self._finished.append(req.rid)
        self.stats.aborted += 1

    def drain_events(self) -> list:
        """Return and clear the token events emitted since the last call:
        ``(rid, index, token, logprob)`` in emission order (position order
        per request)."""
        ev, self._events = self._events, []
        return ev

    def drain_finished(self) -> list:
        """Return and clear the rids finished (evicted or aborted) since the
        last call."""
        f, self._finished = self._finished, []
        return f

    # ------------------------------------------------------ sampling lanes

    def _set_ops(self, slot: int, sp: SamplingParams) -> None:
        """Install ``sp``'s sampling operands in the slot's row (a freed
        slot gets :data:`_GREEDY`'s); the device copy is invalidated only
        when the row's values change."""
        row = (sp.seed & 0xFFFFFFFF, np.float32(sp.temperature), sp.top_k,
               np.float32(sp.top_p))
        brow = bias_rows([sp], self._op_bias.shape[1])[0] \
            if sp.logit_bias else None
        if (self._op_seed[slot] == row[0] and self._op_temp[slot] == row[1]
                and self._op_topk[slot] == row[2]
                and self._op_topp[slot] == row[3]
                and (not self._op_bias[slot].any() if brow is None
                     else np.array_equal(self._op_bias[slot], brow))):
            return
        (self._op_seed[slot], self._op_temp[slot], self._op_topk[slot],
         self._op_topp[slot]) = row
        self._op_bias[slot] = 0.0 if brow is None else brow
        self._dev_ops = None

    def _device_ops(self) -> tuple:
        """(seeds, temperature, top_k, top_p, bias or None) for every slot
        row, uploaded once per change rather than per tick."""
        if self._dev_ops is None:
            dev = self.device
            self._dev_ops = (
                to_device(self._op_seed, dev), to_device(self._op_temp, dev),
                to_device(self._op_topk, dev), to_device(self._op_topp, dev),
                to_device(self._op_bias, dev) if self._op_bias.any() else None)
        return self._dev_ops

    def _sample(self, logits, t, rows=None) -> tuple:
        """Each row's token at generation index ``t`` (host (R,) array)
        from ``logits`` (R, V) with its slot's operands (``rows``: the slot
        of each logits row, default every slot), and its logprob; one
        device→host copy."""
        seeds, temp, tk, tp, bias = self._device_ops()
        if rows is not None:
            idx = to_device(np.asarray(rows, np.int64), self.device)
            seeds, temp, tk, tp = seeds[idx], temp[idx], tk[idx], tp[idx]
            bias = None if bias is None else bias[idx]
        toks, lps = sample_tokens_with_logprobs(
            logits, seeds, to_device(t, self.device), temp, tk, tp, bias)
        host = torch.stack([toks.double(), lps.double()]).cpu().numpy()
        return host[0].astype(np.int64), host[1].astype(np.float32)

    # ------------------------------------------------------------ lifecycle

    def _register_shape(self, *shape) -> None:
        """Record a step call's shape (kind, R, S): ``stats.
        compiled_shapes`` counts the distinct ones, the shapes a CUDA graph
        would capture once each."""
        self._shapes.add(shape)
        self.stats.compiled_shapes = len(self._shapes)

    def _admission_target(self, req: Request) -> int:
        """TOKENS the admission reserves: the request's worst-case final
        length."""
        return len(req.prompt) + req.max_new_tokens

    def _admit_wave(self) -> list:
        """Admit queue heads while a slot row and their pages fit. FIFO: a
        head that does not fit blocks the queue; a head whose shared prefix
        its creator is still writing waits, then forks. Returns the slots
        admitted."""
        admitted = []
        while self.queue:
            req = self.queue[0]
            handle, entry = None, None
            if req.prefix_key is not None:
                entry = self._prefixes.get(req.prefix_key)
                if entry is not None:
                    if entry.handle is not None:
                        handle = entry.handle
                    elif entry.creator_rid is not None:
                        break  # the creator's prefix lands in a later tick
            target = self._admission_target(req)
            if not self.pool.can_admit(target, prefix=handle):
                break
            slot = self.pool.admit(len(req.prompt), reserve_tokens=target,
                                   prefix=handle)
            if handle is not None:
                self.stats.prefix_forks += 1
            elif entry is not None:
                entry.creator_rid = req.rid
            admitted.append(slot)
            self.queue.popleft()
            # tokens already resident: 0, or the shared prefix of a fork
            self.slots[slot] = _SlotState(
                req, [], prefilled=int(self.pool.lengths[slot]))
            self._set_ops(slot, req.sampling)
        return admitted

    def _emit(self, st: _SlotState, token: int, logprob: float) -> None:
        st.generated.append(token)
        self._events.append((st.req.rid, len(st.generated) - 1, token,
                             logprob))

    def _record_first_token(self, st: _SlotState, token: int,
                            logprob: float) -> None:
        self._emit(st, token, logprob)
        self.stats.ttft_ticks.setdefault(st.req.rid,
                                         self._tick - st.req.submit_tick)

    def _maybe_pin_prefix(self, st: _SlotState, slot: int) -> None:
        """Pin the shared prefix as soon as its creator has WRITTEN the
        covered tokens (under chunked prefill, possibly mid-prompt)."""
        entry = self._prefixes.get(st.req.prefix_key) \
            if st.req.prefix_key is not None else None
        if entry is not None and entry.handle is None \
                and entry.creator_rid == st.req.rid \
                and st.prefilled >= entry.tokens.size:
            entry.handle = self.pool.share_prefix(slot, entry.tokens.size)
            entry.creator_rid = None

    def _prefill_call(self, kind: str, tokens, posn, rows=None):
        """One prefill call through the model: ``shared`` kinds attend the
        pool (K3). ``rows`` are the slot rows of the call (None: all)."""
        shared = kind in ("prefill_shared", "chunk_shared")
        self._register_shape(kind, *tokens.shape)
        fn = paged_prefill_shared if shared else paged_prefill
        with torch.inference_mode():
            logits, _ = fn(self.params, self.cfg,
                           to_device(tokens, self.device),
                           self.pool.device_caches(rows=rows),
                           to_device(posn, self.device), self.opts)
        self.stats.prefills += 1
        self.stats.shared_prefill_calls += int(shared)
        return logits

    def _prefill_wave(self, admitted: list) -> None:
        """One ragged right-aligned prefill over the admitted rows; the last
        column is every row's final prompt token → its first sampled token.
        Forked rows carry only their suffix and attend the shared pages."""
        toks = [self.slots[s].req.prompt for s in admitted]
        starts = [int(self.pool.lengths[s]) for s in admitted]  # 0 or prefix
        lens = [t.size - st for t, st in zip(toks, starts)]
        s_pad = _bucket(max(lens))
        r = len(admitted)
        tokens = np.zeros((r, s_pad), np.int32)
        posn = np.full((r, s_pad), -1, np.int32)
        for i, slot in enumerate(admitted):
            suffix = toks[i][starts[i]:]
            tokens[i, s_pad - suffix.size:] = suffix
            posn[i, s_pad - suffix.size:] = np.arange(starts[i], toks[i].size)
        kind = "prefill_shared" if any(starts) else "prefill"
        logits = self._prefill_call(kind, tokens, posn, rows=admitted)
        first, first_lp = self._sample(logits, np.zeros(r, np.int32),
                                       rows=admitted)
        for i, slot in enumerate(admitted):
            st = self.slots[slot]
            self.pool.commit_prefill(slot, int(toks[i].size))
            st.prefilled = int(toks[i].size)
            self._record_first_token(st, int(first[i]), float(first_lp[i]))
            self._maybe_pin_prefix(st, slot)
        self.stats.prefill_tokens += sum(lens)
        self.stats.admitted += r

    def _pick_chunk(self) -> int:
        """The tick's prefill chunk: the one size, or from the ladder —
        smallest when decoding slots dominate or one of them hints
        ``"interactive"``, largest when prefill dominates, middle when
        balanced."""
        ladder = self._chunk_ladder
        if len(ladder) == 1:
            return ladder[0]
        decoding = [st for st in self.slots
                    if st is not None and not st.prefilling and not st.done]
        n_pre = sum(1 for st in self.slots
                    if st is not None and st.prefilling)
        if decoding and any(st.req.sampling.latency_hint == "interactive"
                            for st in decoding):
            c = ladder[0]
        elif len(decoding) > n_pre:
            c = ladder[0]
        elif n_pre > len(decoding):
            c = ladder[-1]
        else:
            c = ladder[len(ladder) // 2]
        self.stats.auto_chunks[c] = self.stats.auto_chunks.get(c, 0) + 1
        return c

    def _prefill_chunk_tick(self) -> bool:
        """Advance every mid-prefill slot by ONE chunk through a fixed
        ``(max_slots, chunk)`` call per kind: first chunks (nothing of the
        request in the pool yet) attend only themselves; continuation
        chunks and forks also attend their pool history. Rows with nothing
        to do ride along fully padded. A chunk that completes its prompt
        yields the row's first token from the call's last column."""
        rows = [i for i, st in enumerate(self.slots)
                if st is not None and st.prefilling]
        if not rows:
            return False
        c = self._pick_chunk()
        fresh = [i for i in rows if int(self.pool.lengths[i]) == 0]
        cont = [i for i in rows if int(self.pool.lengths[i]) > 0]
        for group, kind in ((fresh, "chunk"), (cont, "chunk_shared")):
            if not group:
                continue
            tokens = np.zeros((self.max_slots, c), np.int32)
            posn = np.full((self.max_slots, c), -1, np.int32)
            ends = {}
            for i in group:
                st = self.slots[i]
                prompt = st.req.prompt
                lo, hi = st.prefilled, min(st.prefilled + c, prompt.size)
                tokens[i, c - (hi - lo):] = prompt[lo:hi]
                posn[i, c - (hi - lo):] = np.arange(lo, hi)
                ends[i] = (hi, prompt.size)
            logits = self._prefill_call(kind, tokens, posn)
            # sample only when some row completes its prompt this call
            first, first_lp = self._sample(
                logits, np.zeros(self.max_slots, np.int32)) \
                if any(hi == total for hi, total in ends.values()) \
                else (None, None)
            for i in group:
                st = self.slots[i]
                hi, total = ends[i]
                self.pool.commit_prefill(i, hi)
                self.stats.prefill_chunks += 1
                self.stats.prefill_tokens += hi - st.prefilled
                st.prefilled = hi
                self._maybe_pin_prefix(st, i)
                if hi == total:
                    self._record_first_token(st, int(first[i]),
                                             float(first_lp[i]))
        return True

    def _release_idle_prefix(self) -> bool:
        """Unpin one materialized prefix whose pages nobody but its handle
        references; a later same-key request re-creates it."""
        for entry in self._prefixes.values():
            if entry.handle is None:
                continue
            if any(self.pool.refcount[p] > 1 for p in entry.handle.pages):
                continue
            self.pool.release_prefix(entry.handle)
            entry.handle = None
            entry.creator_rid = None
            return True
        return False

    def _grow_decode_slots(self) -> None:
        """Account one token per decoding slot. Admission reserved every
        request's worst case, so this never exhausts the pool."""
        for i, st in enumerate(self.slots):
            if st is not None and not st.prefilling:
                self.pool.append(i, 1)

    def _decode_tick(self) -> None:
        """One ragged decode step over EVERY slot row (one call shape);
        free and mid-prefill rows carry position -1 and are masked."""
        self._grow_decode_slots()
        active = [i for i, st in enumerate(self.slots)
                  if st is not None and not st.prefilling]
        self._register_shape("decode", self.max_slots, 1)
        tokens = np.zeros((self.max_slots, 1), np.int32)
        pos = np.full((self.max_slots,), -1, np.int32)
        # each row samples at its OWN generation index
        t = np.zeros((self.max_slots,), np.int32)
        for i in active:
            st = self.slots[i]
            tokens[i, 0] = st.generated[-1]
            pos[i] = int(self.pool.lengths[i]) - 1  # position being written
            t[i] = len(st.generated)
        with torch.inference_mode():
            logits, _ = paged_decode_step(
                self.params, self.cfg, to_device(tokens, self.device),
                self.pool.device_caches(), to_device(pos, self.device),
                self.opts)
        nxt, lps = self._sample(logits, t)
        for i in active:
            self._emit(self.slots[i], int(nxt[i]), float(lps[i]))
        self.stats.steps += 1
        self.stats.slot_ticks += len(active)

    def _evict_finished(self) -> None:
        for i, st in enumerate(self.slots):
            if st is None or not st.done:
                continue
            toks, reason = truncate_at_stop(
                st.generated[: st.req.max_new_tokens], st.req.sampling)
            self.results[st.req.rid] = np.concatenate(
                [st.req.prompt, np.asarray(toks, np.int32)])
            self.finish_reasons[st.req.rid] = reason
            self._finished.append(st.req.rid)
            self.pool.free(i)
            self.slots[i] = None
            self._set_ops(i, _GREEDY)
            self.stats.evicted += 1

    def _track_occupancy(self) -> None:
        s, pool = self.stats, self.pool
        s.peak_occupancy = max(s.peak_occupancy, pool.occupancy())
        s.peak_pool_bytes = max(s.peak_pool_bytes, pool.page_bytes_in_use())
        s.peak_eq2_bytes = max(s.peak_eq2_bytes, pool.eq2_bytes())
        s.peak_shared_pages = max(s.peak_shared_pages, pool.pages_shared)

    # ------------------------------------------------------------- driving

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def _fail_stuck_queue(self) -> None:
        """The batch is idle yet the queue head does not fit: release an
        idle pinned prefix, or raise — it can never be admitted."""
        if self._release_idle_prefix():
            return
        req = self.queue[0]
        need = self.pool.pages_for(self._admission_target(req))
        raise PoolExhaustedError(
            f"request {req.rid} needs {need} pages worst-case but the "
            f"whole pool has {self.pool.num_pages - 1} (max_blocks "
            f"{self.pool.max_blocks}); it can never be admitted")

    def step(self) -> bool:
        """One tick: admit, advance prefill (one chunk per mid-prefill slot,
        or the whole wave), evict what finished on its first token, decode
        the ragged batch, evict. Returns whether work remains."""
        self._tick += 1
        admitted = self._admit_wave()
        if self.tick_mode == "wave":
            # fresh and forked rows prefill separately: only forks pay the
            # pool-history walk
            for group in ([s for s in admitted if self.pool.lengths[s] == 0],
                          [s for s in admitted if self.pool.lengths[s] > 0]):
                if group:
                    self._prefill_wave(group)
            did_prefill = bool(admitted)
        else:
            self.stats.admitted += len(admitted)
            did_prefill = self._prefill_chunk_tick()
        if did_prefill:
            self._track_occupancy()
            self._evict_finished()  # max_tokens == 1 finishes here
        if any(st is not None and not st.prefilling for st in self.slots):
            self._decode_tick()
            self._track_occupancy()
            self._evict_finished()
        elif (not admitted and self.queue
              and all(st is None for st in self.slots)):
            self._fail_stuck_queue()
        return self.pending

    def run(self) -> dict:
        """Drain queue and batch; returns {rid: prompt + generation} (stop
        truncated). Pinned prefixes are released after the drain, so the
        pool ends fully reclaimed."""
        while self.step():
            pass
        self.release_prefixes()
        return self.results
