"""Continuous-batching scheduler over the paged KV pool, with explicit
prefix sharing, lazy page growth and preemption (port of
``repro/serving/scheduler.py``: the ``"packed"``, ``"chunked"`` and
``"wave"`` ticks, reserve and lazy admission, swap and refill resume).

Requests of ragged prompt and generation lengths share one decode batch and
one pool; a finished request's slot and pages go to the next queued request
without draining the batch. Per request:

  admit   — the queue head is admitted when a slot row and its admission
            pages are free. Reserve admission (default) takes the pages of
            the WORST case (prompt + max_new_tokens), so a decode can never
            meet an exhausted pool: the queue is the backpressure. Lazy
            admission (``lazy_growth=True``) takes the prompt's pages and
            one token of headroom; decode grows page by page and an
            exhausted pool is resolved by PREEMPTION (below). A request
            submitted with ``prefix_key=`` attaches to the shared prefix:
            the first such request (the creator) prefills the whole prompt
            and its prefix pages are pinned as a ``kv_pool.SharedPrefix``;
            later requests FORK, their tables aliasing the pinned pages,
            and prefill only their suffix;
  tick    — ``tick_mode="packed"``: ONE call serves the whole tick. Every
            decoding slot's next token and up to ``token_budget`` prefill-
            chunk tokens ride in one flat ``(1, token_budget)`` buffer, each
            slot one contiguous segment (a decode token is a length-1
            segment), attended in one pass by kernel K4
            (``transformer.packed_step``): one call shape, one dispatch per
            tick, pad only in the buffer's tail.
            ``"chunked"`` (default): every prompt goes in fixed
            ``prefill_chunk``-token pieces, and each tick advances every
            mid-prefill slot by one chunk through one fixed-shape
            ``(max_slots, chunk)`` call. First chunks attend only
            themselves (``transformer.paged_prefill``, the same math as
            ``Engine``'s prefill); continuation chunks and forks also attend
            their pool history (``transformer.paged_prefill_shared``, kernel
            K3). ``"wave"``: the admitted group prefills raggedly in one
            right-aligned call of a bucketed ``(R_adm, S_pad)`` shape. In
            both, every decoding slot then steps together through one fixed
            ``(max_slots, 1)`` ``paged_decode_step`` (kernel K2), each row
            at its own position; free and mid-prefill rows ride along
            masked;
  preempt — (lazy) when a decoding slot's growth exhausts the pool, idle
            pinned prefixes are released first; then the lowest-priority
            (ties: most recently admitted) running request goes back to the
            queue head with the tokens it generated, its pages freed. It
            resumes by ``resume="swap"`` (default: its written pages were
            copied to host memory and come back bit-identically,
            ``page_transport.HostSwapTransport``) or ``"refill"`` (it
            re-prefills prompt + generated tokens). A preempted request
            waits ``preempt_cooldown`` extra ticks while others run;
  evict   — at ``max_tokens`` or a stop token the slot's page references go
            back to the pool.

Speculation (``speculate_k=k`` > 0) makes every decode tick a verify tick,
in every tick mode: each decoding slot drafts up to k tokens by prompt
lookup (:func:`_prompt_lookup_draft`, no second model), appends them with
its last token, and all slots are scored by ONE fixed ``(max_slots, 1 + k)``
``transformer.paged_verify_step`` call that reads every key back from the
pool (kernel K2, one query row per column). ``core.sampling.
speculative_verify`` accepts per slot and the pool truncates each rejected
tail, so a greedy stream is the ``speculate_k=0`` stream. In packed mode
the decoding slots leave the packed buffer and ride the verify tick.
``SamplingParams.speculate_k`` lowers a request's burst below k.

Sampling runs on the device with per-slot operands (seed, temperature,
top-k, top-p, logit bias), uploaded only when a slot's row changes; a row's
draw depends on its seed, its own generation index and its logits alone,
so a seeded request draws the same stream here as on the fused backend
wherever the two paths give it bit-identical logits (in f32 on the CPU; in
bf16 on the card their logits differ and so may the draws). Each tick reads
back only the sampled tokens and their logprobs, in one copy.

``auto_prefix=True`` detects shared heads with no ``prefix_key``: a submit
is matched (longest common prefix) against the last ``auto_prefix_window``
prompts and the auto prefixes already registered; a match of at least
``auto_prefix_min`` tokens attaches the request under a minted key
``("auto_prefix", n)`` through the explicit-prefix and CoW fork machinery
(:meth:`Scheduler._detect_auto_prefix`). Greedy streams do not change;
``stats.auto_prefix_hits`` counts the attachments.

``telemetry=`` (a ``serving.telemetry.Tracer``) lands a ``TickRecord`` a
tick, built from differences of the stats, and each request's lifecycle as
spans and instants (queued, prefill, first_token, decode, preempt,
swap_out/swap_resume, finish). A prefill span ends after a sync of the
pool device's current stream, made only when a tracer is attached; with
``telemetry=None`` no tracer method runs and no sync is added. Values never
depend on the tracer.

``extract`` and ``inject`` hand a running request from one scheduler to
another with its written pages as a host snapshot (the swap preemption's
export) and its emitted tokens: the disaggregated deployment's handoff
(``page_transport.DisaggregatedScheduler``).

Threads: the scheduler is single-driver. ``submit``, ``abort`` and ``step``
mutate pool and slot state and must run on ONE thread (the async front
end's tick thread); a second thread entering ``step`` mid-tick raises
``RuntimeError``. ``drain_events`` and ``drain_finished`` may be called
from another thread by a single consumer: ``_emit_lock`` makes the appends
atomic with the drain's swap.

A codebook config (musicgen) is refused up front with ``ValueError``: a
request here is one token stream. The vision stub (qwen2-vl) serves text
only, its M-RoPE ids taken from each token's absolute position, as the
reference's paged entry points take them.

The sharded deployment (``mesh=``, a ``("kv", "model")`` mesh from
``launch.mesh.make_serving_mesh``): one scheduler a rank, every rank
given the same submissions and stepping in lockstep (SPMD). Every host
decision here (admission, chunks, preemption, swap, forks, drafts) reads
only host state that every rank holds alike, so the ranks agree without
talking; the pool stores 1/kv of its pages a rank, and the five step
functions are ``transformer.sharded_step_fns``' (the pool gathered over
``"kv"``, kv heads split over ``"model"``, exactly), so every rank samples
the unsharded scheduler's tokens.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.sampling import (SamplingParams, bias_rows,
                                       sample_tokens_with_logprobs,
                                       speculative_verify, truncate_at_stop)
from repro_torch.device import resolve_device, stream_sync, to_device
from repro_torch.models.transformer import (RuntimeOpts, packed_step,
                                            paged_decode_step, paged_prefill,
                                            paged_prefill_shared,
                                            paged_verify_step,
                                            sharded_step_fns)
from repro_torch.serving.kv_pool import (DEFAULT_PAGE_SIZE, PagedKVPool,
                                         PoolExhaustedError)
from repro_torch.serving.page_transport import HostSwapTransport

# the adaptive-prefill ladder ``prefill_chunk="auto"`` expands to, picked
# per tick by batch composition (Scheduler._pick_chunk)
AUTO_CHUNK_LADDER = (64, 128, 256)

# the operands of a free slot row: greedy, no filters, no bias
_GREEDY = SamplingParams()

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32, the ORIGINAL prompt
    sampling: SamplingParams  # every per-request knob, stop set included
    prefix_key: object = None  # hashable; same key ⇒ shared prompt prefix
    submit_tick: int = 0  # scheduler tick at submission (TTFT in ticks)
    # resume state of a preempted request: the tokens it generated (never
    # sampled again) and, with swap resume, the host snapshot of its pages
    generated: list = dataclasses.field(default_factory=list)
    snapshot: dict | None = dataclasses.field(default=None, repr=False)
    # anti-thrash backoff: not re-admitted before this tick while any
    # other slot runs
    cooldown_until: int = 0

    @property
    def max_new_tokens(self) -> int:
        return self.sampling.max_tokens

    @property
    def priority(self) -> int:
        """Lower is preempted first."""
        return self.sampling.priority

    @property
    def prefill_tokens(self) -> np.ndarray:
        """TOKENS a (re-)prefill writes: the prompt and every generated
        token already fed to the model (all but the last, which is the next
        decode input)."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated[:-1], np.int32)])


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
    seq: int = 0  # admission sequence number (preemption tie-break)
    prefilled: int = 0  # prompt/resume TOKENS already written to the pool

    @property
    def prefilling(self) -> bool:
        """More chunks to write before the slot decodes."""
        return self.prefilled < len(self.req.prefill_tokens)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        return bool(self.generated
                    and self.generated[-1] in self.req.sampling.stop_set)


@dataclasses.dataclass
class SchedulerStats:
    steps: int = 0  # decode steps executed (packed ticks with decode rows)
    prefills: int = 0  # prefill CALLS (waves, per-tick chunk calls, or
    #                    packed ticks carrying a prefill piece)
    shared_prefill_calls: int = 0  # of those, calls that attend the pool
    #                                (continuation chunks and forks: K3)
    prefill_chunks: int = 0  # per-slot chunks written (chunked mode)
    admitted: int = 0  # admissions, resumptions included
    evicted: int = 0  # completed requests
    aborted: int = 0
    preemptions: int = 0  # evict-to-queue events (lazy growth)
    prefix_forks: int = 0  # admissions that attached to a shared prefix
    slot_ticks: int = 0  # Σ decoding slots over decode steps
    peak_occupancy: float = 0.0
    peak_pool_bytes: int = 0  # physical page bytes (shared pages once)
    peak_eq2_bytes: int = 0  # logical per-request Eq. 2 bytes
    peak_shared_pages: int = 0  # pages with refcount > 1
    peak_swap_bytes: int = 0  # host bytes held by swapped-out snapshots
    compiled_shapes: int = 0  # distinct step-call shapes (kind, R, S);
    #                           exactly 1 for a packed run
    packed_ticks: int = 0  # token-packed calls dispatched
    packed_tokens: int = 0  # live tokens those calls carried
    packed_pad_tokens: int = 0  # tail-pad rows they carried
    prefill_tokens: int = 0  # prompt/resume TOKENS written by prefill calls
    spec_rounds: int = 0  # verify rounds that carried >= 1 draft token
    spec_drafted: int = 0  # draft tokens proposed in those rounds
    spec_accepted: int = 0  # draft tokens EMITTED (accepted, not cut by a
    #                         stop token)
    auto_prefix_hits: int = 0  # submits attached to a detected shared
    #                            prefix (auto_prefix=True)
    # rid → ticks from submit to the first sampled token
    ttft_ticks: dict = dataclasses.field(default_factory=dict)
    # chunk size → ticks it was picked (adaptive prefill_chunk)
    auto_chunks: dict = dataclasses.field(default_factory=dict)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of proposed draft tokens that were emitted."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)


def _bucket(n: int) -> int:
    """Next power of two: bounds the distinct wave-prefill shapes."""
    return 1 << max(0, (n - 1).bit_length())


def _prompt_lookup_draft(context: np.ndarray, k: int,
                         max_ngram: int = 3) -> np.ndarray:
    """Draft by PROMPT LOOKUP: find the most recent earlier occurrence of
    the context's trailing n-gram (the longest of ``max_ngram`` .. 1 that
    occurs) and propose the up to ``k`` tokens that followed it. No model
    and no weights: host-side token matching. A bad guess costs acceptance
    length, never correctness, since the verify accepts only what the
    target model agrees with. Returns (<= k,) int32, possibly empty."""
    context = np.asarray(context, np.int32).reshape(-1)
    length = context.size
    if k <= 0 or length < 2:
        return np.zeros((0,), np.int32)
    for n in range(min(max_ngram, length - 1), 0, -1):
        pat = context[length - n:]
        # windows over context[:-1]: each start leaves >= 1 follower, and
        # the trailing n-gram itself never matches
        windows = np.lib.stride_tricks.sliding_window_view(
            context[:length - 1], n)
        hits = np.flatnonzero((windows == pat).all(axis=1))
        if hits.size:
            start = int(hits[-1])  # the most recent occurrence
            return context[start + n:start + n + k].copy()
    return np.zeros((0,), np.int32)


class Scheduler:
    """Continuous-batching front end over one shared ``PagedKVPool`` on
    ``device`` (``cuda`` unless the caller names another; raises with no
    card). ``submit`` enqueues; ``step`` runs one tick; ``run`` drains.
    ``prefill_chunk`` is a size, ``"auto"`` (:data:`AUTO_CHUNK_LADDER`) or
    a tuple of sizes, picked per tick: small when decoding slots dominate
    or one hints ``latency_hint="interactive"``, large when the batch is
    prefill-heavy.

    ``tick_mode="packed"`` serves each tick in ONE token-packed call over a
    flat ``(1, token_budget)`` buffer (see the module docstring);
    ``token_budget`` defaults to ``prefill_chunk + max_slots`` (a chunk's
    worth of prefill beside a full decode batch) and is raised to at least
    ``max_slots + 1`` (every decoding slot a row, and one for prefill).
    ``lazy_growth=True`` admits on current need and preempts on an
    exhausted pool; ``resume`` ("swap" or "refill") says how a preempted
    request comes back, and ``preempt_cooldown`` (ticks) how long it waits
    while others run (0: re-admit at once). ``speculate_k`` > 0 is the
    verify call's draft width (see the module docstring); 0 leaves every
    tick as it is without speculation. ``auto_prefix`` turns on automatic
    prefix detection (matches of at least ``auto_prefix_min`` tokens
    against the last ``auto_prefix_window`` prompts) and ``telemetry``
    takes a ``Tracer`` (both in the module docstring). ``mesh=`` makes this
    scheduler one rank of the sharded deployment (the module docstring);
    a ``mesh`` that is not a ``("kv", "model")`` ``DeviceMesh`` raises
    ``TypeError``.

    Single-driver: ``submit``, ``abort`` and ``step`` must run on one
    thread; ``step`` raises ``RuntimeError`` when a second thread enters
    it mid-tick."""

    def __init__(self, cfg: ArchConfig, params,
                 opts: RuntimeOpts = RuntimeOpts(), *,
                 num_pages: int = 128, page_size: int = DEFAULT_PAGE_SIZE,
                 max_slots: int = 4, max_seq_len: int | None = None,
                 lazy_growth: bool = False, resume: str = "swap",
                 prefill_chunk: int | str | tuple = 256,
                 preempt_cooldown: int = 1, tick_mode: str = "chunked",
                 token_budget: int | None = None, speculate_k: int = 0,
                 auto_prefix: bool = False, auto_prefix_min: int = 8,
                 auto_prefix_window: int = 16, telemetry=None, mesh=None,
                 device=None):
        if tick_mode not in ("packed", "chunked", "wave"):
            raise ValueError(f"tick_mode must be 'packed', 'chunked' or "
                             f"'wave', got {tick_mode}")
        if resume not in ("swap", "refill"):
            raise ValueError(f"resume must be 'swap' or 'refill', got "
                             f"{resume}")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if cfg.num_codebooks > 1:
            # the reference takes the config and fails inside its first
            # tick, once submit has flattened a (S, K) prompt
            raise ValueError(
                f"{cfg.name}: the paged scheduler serves one token stream "
                f"a request; a config of {cfg.num_codebooks} codebooks "
                f"takes (B, S, {cfg.num_codebooks}) prompts through Engine "
                f"or SplitEngine")
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
                                max_seq_len=max_seq_len, mesh=mesh,
                                device=self.device)
        # the five step functions: over a mesh, sharded_step_fns' (the pool
        # checked the mesh); each has the unsharded one's signature
        self.mesh = mesh
        self._steps = sharded_step_fns(cfg, opts, mesh) \
            if mesh is not None else {
                "prefill": paged_prefill,
                "prefill_shared": paged_prefill_shared,
                "decode": paged_decode_step, "packed": packed_step,
                "verify": paged_verify_step}
        self.max_slots = max_slots
        self.tick_mode = tick_mode
        self.lazy_growth = lazy_growth
        self.resume = resume
        self.preempt_cooldown = preempt_cooldown
        self.speculate_k = int(speculate_k)
        # no prompt exceeds the block table's reach, so no chunk need either
        reach = self.pool.max_blocks * page_size
        self._chunk_ladder = tuple(sorted({min(c, reach) for c in ladder}))
        self.prefill_chunk = self._chunk_ladder[-1]
        if token_budget is None:
            token_budget = self.prefill_chunk + max_slots
        # every decoding slot needs a row, and prefill at least one
        self.token_budget = max(int(token_budget), max_slots + 1)
        # serving.telemetry.Tracer or None: every site below is guarded on
        # it, so the disabled path never calls the tracer nor syncs
        self.telemetry = telemetry
        # the preempt/resume page mover (bytes, host time and swap spans)
        self._swap = HostSwapTransport(telemetry=telemetry)
        self._tick = 0
        self._admit_seq = 0
        self._shapes: set = set()  # distinct step-call shapes dispatched
        self.queue: deque = deque()
        self.slots: list = [None] * max_slots
        self.results: dict = {}
        self.finish_reasons: dict = {}  # rid → "stop" | "length" | "abort"
        self.stats = SchedulerStats()
        self._prefixes: dict = {}
        self._next_rid = 0
        # automatic prefix detection: the last auto_prefix_window requests
        # and the auto keys minted so far
        self.auto_prefix = bool(auto_prefix)
        self.auto_prefix_min = max(1, int(auto_prefix_min))
        self._recent_reqs: deque = deque(
            maxlen=max(1, int(auto_prefix_window)))
        self._auto_keys: set = set()
        self._auto_seq = 0
        # streamed (rid, index, token, logprob) events and finished rids,
        # drained by serving.api.PagedBackend, possibly from another
        # thread: _emit_lock makes an append atomic with the drain's swap.
        # _step_guard turns a second thread entering step() into an error
        self._events: list = []
        self._finished: list = []
        self._emit_lock = threading.Lock()
        self._step_guard = threading.Lock()
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
        if prefix_key is None and self.auto_prefix:
            prefix_key, prefix_len = self._detect_auto_prefix(prompt)
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
        if self.auto_prefix:
            self._recent_reqs.append(req)
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.request_submitted(rid)
        return rid

    @staticmethod
    def _lcp(a: np.ndarray, b: np.ndarray) -> int:
        """Length of the longest common prefix of two token sequences."""
        n = min(a.size, b.size)
        neq = np.nonzero(a[:n] != b[:n])[0]
        return int(neq[0]) if neq.size else n

    def _detect_auto_prefix(self, prompt: np.ndarray) -> tuple:
        """``(prefix_key, prefix_len)`` to attach ``prompt`` with, or
        ``(None, None)``: the longest shared head of at least
        ``auto_prefix_min`` tokens between the prompt and (a) an auto
        prefix already registered or (b) one of the last
        ``auto_prefix_window`` prompts.

        Matching a registered auto prefix joins it (the fork path). A longer
        match against a recent prompt mints a new key ``("auto_prefix",
        n)`` over the common head; when that earlier request is still
        queued and keyless it is attached too, so the first of the pair in
        FIFO order writes the prefix and the later one forks it. Both
        lengths are capped at each prompt's size - 1 (a suffix token must
        prefill to give first logits)."""
        best_key, best_len = None, 0
        for key in self._auto_keys:
            entry = self._prefixes.get(key)
            if entry is None:
                continue
            plen = int(entry.tokens.size)
            if (plen > best_len and plen <= prompt.size - 1
                    and np.array_equal(entry.tokens, prompt[:plen])):
                best_key, best_len = key, plen
        best_req, best_req_len = None, best_len
        for other in self._recent_reqs:
            lcp = min(self._lcp(prompt, other.prompt),
                      prompt.size - 1, other.prompt.size - 1)
            if lcp > best_req_len:
                best_req, best_req_len = other, lcp
        if best_req is not None and best_req_len >= self.auto_prefix_min:
            self._auto_seq += 1
            key = ("auto_prefix", self._auto_seq)
            self._auto_keys.add(key)
            self._prefixes[key] = _PrefixEntry(
                key, prompt[:best_req_len].copy())
            if best_req.prefix_key is None and any(
                    r is best_req for r in self.queue):
                best_req.prefix_key = key  # the FIFO-first creates it
            self.stats.auto_prefix_hits += 1
            return key, best_req_len
        if best_key is not None and best_len >= self.auto_prefix_min:
            self.stats.auto_prefix_hits += 1
            return best_key, best_len
        return None, None

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
        self._auto_keys &= set(self._prefixes)

    def abort(self, rid: int) -> bool:
        """Cancel a request wherever it is — queued (swapped out too),
        mid-prefill or decoding. The partial result (prompt + tokens
        emitted so far) is recorded with reason ``"abort"``; a live slot's
        pages return to the pool now (a swapped-out one's snapshot is
        dropped). False when the rid is unknown or already finished."""
        for req in self.queue:
            if req.rid == rid:
                if req.snapshot is not None:  # swapped out: drop its bytes
                    self.pool.discard_snapshot(req.snapshot)
                    req.snapshot = None
                self.queue.remove(req)
                self._finish_abort(req, req.generated)
                return True
        for i, st in enumerate(self.slots):
            if st is not None and st.req.rid == rid:
                self.pool.free(i)
                self.slots[i] = None
                self._set_ops(i, _GREEDY)
                self._finish_abort(st.req, st.generated, track=f"slot{i}")
                return True
        return False

    def _finish_abort(self, req: Request, generated: list,
                      track: str = "queue") -> None:
        # an aborted prefix creator must not strand waiting forks: the next
        # same-key admission materializes the prefix instead
        entry = self._prefixes.get(req.prefix_key) \
            if req.prefix_key is not None else None
        if entry is not None and entry.creator_rid == req.rid:
            entry.creator_rid = None
        self.results[req.rid] = np.concatenate(
            [req.prompt, np.asarray(generated, np.int32)])
        self.finish_reasons[req.rid] = "abort"
        self._mark_finished(req.rid)
        self.stats.aborted += 1
        if self.telemetry is not None:
            self.telemetry.request_finished(req.rid, track, "abort",
                                            len(generated))

    def extract(self, rid: int) -> Request | None:
        """Detach a RUNNING request from its slot and return it with a host
        snapshot of every position it has WRITTEN (``req.snapshot``) and the
        tokens it emitted (``req.generated``, never sampled again): the
        prefill→decode handoff of the disaggregated deployment
        (``page_transport.DisaggregatedScheduler``). The snapshot is the
        swap preemption's export, so the request, :meth:`inject`-ed into
        ANOTHER scheduler, decodes on bit-identically. Its slot and pages
        free now and the slot's sampling row goes back to greedy. None when
        the rid is not in a slot (queued or finished)."""
        for i, st in enumerate(self.slots):
            if st is None or st.req.rid != rid:
                continue
            st.req.generated = list(st.generated)
            # only positions written: the last generated token is the next
            # decode input, not yet in the pool
            written = (len(st.req.prompt) + len(st.generated) - 1
                       if st.generated else st.prefilled)
            st.req.snapshot = self.pool.export_slot(i, n_tokens=written)
            self.pool.free(i)
            self.slots[i] = None
            self._set_ops(i, _GREEDY)
            if self.telemetry is not None:
                self.telemetry.event("extract", track=f"slot{i}", rid=rid,
                                     tokens=written)
            return st.req
        return None

    def inject(self, req: Request) -> None:
        """Enqueue a request :meth:`extract`-ed from another scheduler, its
        snapshot and generated tokens intact: the decode side of the
        disaggregated handoff. The next admission restores the snapshot
        through the swap-resume path. The caller keeps rids unique: a
        scheduler that both ``submit``s and ``inject``s must keep the two
        rid spaces apart (``page_transport.DisaggregatedScheduler`` only
        injects into its decode replica)."""
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.request_submitted(req.rid)

    def _emit_event(self, rid: int, idx: int, tok: int, lp: float) -> None:
        """Append one streamed-token event, atomically with the drain's
        swap: an append racing the swap would otherwise land in the list
        just drained and be lost."""
        with self._emit_lock:
            self._events.append((rid, idx, tok, lp))

    def _mark_finished(self, rid: int) -> None:
        with self._emit_lock:
            self._finished.append(rid)

    def drain_events(self) -> list:
        """Return and clear the token events emitted since the last call:
        ``(rid, index, token, logprob)`` in emission order (position order
        per request). Safe from another thread than the one that steps,
        for ONE consumer: each event is returned once."""
        with self._emit_lock:
            ev, self._events = self._events, []
        return ev

    def drain_finished(self) -> list:
        """Return and clear the rids finished (evicted or aborted) since the
        last call; the same single-consumer contract as
        :meth:`drain_events`."""
        with self._emit_lock:
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
        new = shape not in self._shapes
        self._shapes.add(shape)
        self.stats.compiled_shapes = len(self._shapes)
        if self.telemetry is not None:
            self.telemetry.shape_dispatch(new)

    def _admission_target(self, req: Request) -> int:
        """TOKENS the admission reserves. Reserve admission: the request's
        worst-case final length. Lazy: its (re-)prefill length plus ONE
        decode token of headroom (capped at the final written length), so
        an admitted request decodes at least one token before it can be
        preempted; a swap snapshot never holds more than that prefill
        length."""
        final = len(req.prompt) + req.max_new_tokens
        if not self.lazy_growth:
            return final
        # final - 1: the last sampled token is emitted, never written
        return min(len(req.prefill_tokens) + 1, final - 1)

    def _admit_wave(self) -> tuple:
        """Admit queue heads while a slot row and their pages fit. FIFO: a
        head that does not fit blocks the queue; a head whose shared prefix
        its creator is still writing waits, then forks; a freshly preempted
        head waits out its cooldown while any slot runs. A swapped-out head
        comes back from its snapshot. Returns (slots needing a prefill,
        slots restored from a snapshot)."""
        admitted, restored = [], []
        while self.queue:
            req = self.queue[0]
            if (req.cooldown_until > self._tick
                    and any(st is not None for st in self.slots)):
                break
            handle, entry = None, None
            if req.snapshot is None and req.prefix_key is not None:
                entry = self._prefixes.get(req.prefix_key)
                if entry is not None:
                    if entry.handle is not None:
                        handle = entry.handle
                    elif entry.creator_rid is not None:
                        break  # the creator's prefix lands in a later tick
            target = self._admission_target(req)
            if not self.pool.can_admit(target, prefix=handle):
                break
            # a swap resume carries a snapshot, a refill resume only the
            # tokens it generated
            resumed = req.snapshot is not None or bool(req.generated)
            if req.snapshot is not None:
                slot = self._swap.swap_in(self.pool, req.snapshot,
                                          reserve_tokens=target, rid=req.rid)
                req.snapshot = None
                restored.append(slot)
            else:
                slot = self.pool.admit(len(req.prefill_tokens),
                                       reserve_tokens=target, prefix=handle)
                if handle is not None:
                    self.stats.prefix_forks += 1
                elif entry is not None:
                    entry.creator_rid = req.rid
                admitted.append(slot)
            self.queue.popleft()
            # tokens already resident: 0, the shared prefix of a fork, or a
            # restored snapshot (for a victim preempted mid-prefill, less
            # than its prompt: it resumes chunking where it left off)
            self.slots[slot] = _SlotState(
                req, list(req.generated), self._admit_seq,
                prefilled=int(self.pool.lengths[slot]))
            self._admit_seq += 1
            self._set_ops(slot, req.sampling)
            if self.telemetry is not None:
                self.telemetry.request_admitted(req.rid, slot,
                                                resumed=resumed)
        return admitted, restored

    def _emit(self, st: _SlotState, token: int, logprob: float) -> None:
        st.generated.append(token)
        self._emit_event(st.req.rid, len(st.generated) - 1, token, logprob)

    def _record_first_token(self, st: _SlotState, slot: int, token: int,
                            logprob: float) -> None:
        """Emit the slot's first sampled token and record its TTFT. A
        resumed request keeps the tokens it emitted: its last one is the
        next decode input, and this sample is dropped."""
        if st.generated:
            return
        self._emit(st, token, logprob)
        ticks = self._tick - st.req.submit_tick
        self.stats.ttft_ticks.setdefault(st.req.rid, ticks)
        if self.telemetry is not None:
            self.telemetry.first_token(st.req.rid, f"slot{slot}",
                                       ttft_ticks=ticks)

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

    def _traced_end(self) -> float:
        """The end of a traced span over device work: the pool device's
        current stream is synced first (a tracer is attached)."""
        stream_sync(self.device)
        return self.telemetry.now()

    def _prefill_call(self, kind: str, tokens, posn, rows=None) -> tuple:
        """One prefill call through the model: ``shared`` kinds attend the
        pool (K3). ``rows`` are the slot rows of the call (None: all).
        Returns (logits, its span's (t0, t1) with a tracer, else None)."""
        shared = kind in ("prefill_shared", "chunk_shared")
        self._register_shape(kind, *tokens.shape)
        fn = self._steps["prefill_shared" if shared else "prefill"]
        tel = self.telemetry
        t0 = tel.now() if tel is not None else None
        with torch.inference_mode():
            logits, _ = fn(self.params, self.cfg,
                           to_device(tokens, self.device),
                           self.pool.device_caches(rows=rows),
                           to_device(posn, self.device), self.opts)
        span = (t0, self._traced_end()) if tel is not None else None
        self.stats.prefills += 1
        self.stats.shared_prefill_calls += int(shared)
        return logits, span

    def _prefill_wave(self, admitted: list) -> None:
        """One ragged right-aligned prefill over the admitted rows; the last
        column is every row's final prompt token → its first sampled token.
        Forked rows carry only their suffix and attend the shared pages."""
        toks = [self.slots[s].req.prefill_tokens for s in admitted]
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
        logits, span = self._prefill_call(kind, tokens, posn, rows=admitted)
        first, first_lp = self._sample(logits, np.zeros(r, np.int32),
                                       rows=admitted)
        for i, slot in enumerate(admitted):
            st = self.slots[slot]
            self.pool.commit_prefill(slot, int(toks[i].size))
            st.prefilled = int(toks[i].size)
            if span is not None:
                self.telemetry.add_span(
                    "prefill", *span, track=f"slot{slot}", rid=st.req.rid,
                    tokens=lens[i], stage="wave")
            self._record_first_token(st, slot, int(first[i]),
                                     float(first_lp[i]))
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
                toks = st.req.prefill_tokens
                lo, hi = st.prefilled, min(st.prefilled + c, toks.size)
                tokens[i, c - (hi - lo):] = toks[lo:hi]
                posn[i, c - (hi - lo):] = np.arange(lo, hi)
                ends[i] = (hi, toks.size)
            logits, span = self._prefill_call(kind, tokens, posn)
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
                if span is not None:
                    self.telemetry.add_span(
                        "prefill", *span, track=f"slot{i}", rid=st.req.rid,
                        tokens=hi - st.prefilled, stage=kind,
                        done=hi == total)
                st.prefilled = hi
                self._maybe_pin_prefix(st, i)
                if hi == total:
                    self._record_first_token(st, i, int(first[i]),
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

    def _preempt_one(self, requester: int) -> bool:
        """Evict the lowest-priority (ties: most recently admitted) running
        request to the queue head with its generated tokens, freeing its
        pages for ``requester``'s growth; an idle pinned prefix goes first.
        Refuses (False) when the requester is the only candidate: the pool
        is then too small for it, and the caller fails loudly."""
        if self._release_idle_prefix():
            return True
        cands = [(st.req.priority, -st.seq, i)
                 for i, st in enumerate(self.slots) if st is not None]
        if not cands:
            return False
        victim = min(cands)[2]
        if victim == requester and len(cands) == 1:
            return False
        st = self.slots[victim]
        st.req.generated = list(st.generated)
        st.req.cooldown_until = self._tick + 1 + self.preempt_cooldown
        tel = self.telemetry
        if tel is not None:
            tel.span_end(("decode", st.req.rid), outcome="preempt")
            tel.event("preempt", track=f"slot{victim}", rid=st.req.rid,
                      reason="pool_exhausted", resume=self.resume)
            tel.metrics.count("scheduler.preemptions")
        # only positions WRITTEN: the last generated token is the next
        # decode input, not yet in the pool; a victim still prefilling has
        # written its chunks so far, and one admitted this tick nothing
        written = (len(st.req.prompt) + len(st.generated) - 1
                   if st.generated else st.prefilled)
        if self.resume == "swap" and written:
            st.req.snapshot = self._swap.swap_out(self.pool, victim,
                                                  n_tokens=written,
                                                  rid=st.req.rid)
            self.stats.peak_swap_bytes = max(self.stats.peak_swap_bytes,
                                             self.pool.swap_bytes)
        entry = self._prefixes.get(st.req.prefix_key) \
            if st.req.prefix_key is not None else None
        if (st.req.snapshot is None and entry is not None
                and entry.handle is None and entry.creator_rid == st.req.rid):
            # a creator that comes back without its pages must not wait for
            # itself: it (or a fork behind it) materializes the prefix anew
            entry.creator_rid = None
        self.pool.free(victim)
        self.slots[victim] = None
        self._set_ops(victim, _GREEDY)
        self.queue.appendleft(st.req)
        self.stats.preemptions += 1
        if tel is not None:
            tel.request_requeued(st.req.rid, reason="preempt")
        return True

    def _draft_plan(self) -> dict:
        """This tick's draft burst per decoding slot, ``{slot: (kd,)
        int32}`` (empty without speculation). A slot's cap is
        ``speculate_k`` (the verify call's width), lowered by its request's
        own ``SamplingParams.speculate_k`` when that is set, and bounded so
        that the round emits at most the tokens the request may still emit
        (``kd + 1``): the bound that keeps a reserve admission unbreached.
        Drafts come from :func:`_prompt_lookup_draft` over prompt +
        generated."""
        k = self.speculate_k
        if not k:
            return {}
        plan = {}
        for i, st in enumerate(self.slots):
            if st is None or st.prefilling:
                continue
            sp = st.req.sampling
            cap = min(k, sp.speculate_k) if sp.speculate_k > 0 else k
            kd = min(cap, st.req.max_new_tokens - len(st.generated) - 1)
            plan[i] = _prompt_lookup_draft(
                np.concatenate([st.req.prompt,
                                np.asarray(st.generated, np.int32)]), kd)
        return plan

    def _grow_decode_slots(self, plan: dict | None = None) -> None:
        """Account the tokens each decoding slot writes this tick: one, plus
        its planned draft burst when speculating. Reserve admission reserved
        every request's worst case, so that never exhausts the pool; under
        lazy growth a growth that does first sheds the slot's OWN drafts (a
        burst is optional work), then preempts before the step runs (a
        victim's untaken step is simply not taken: it resumes from the
        tokens it emitted)."""
        for i in range(self.max_slots):
            if self.slots[i] is None or self.slots[i].prefilling:
                continue
            want = 1 + (plan[i].size if plan else 0)
            while True:
                try:
                    self.pool.append(i, want)
                    break
                except PoolExhaustedError:
                    if want > 1:
                        plan[i] = plan[i][:0]
                        want = 1
                        continue
                    if not self._preempt_one(requester=i):
                        raise PoolExhaustedError(
                            f"request {self.slots[i].req.rid} cannot grow: "
                            f"the pool's {self.pool.num_pages - 1} page(s) "
                            f"cannot hold its worst case even alone")
                    if self.slots[i] is None:
                        break  # it was the victim: no step for it

    def _decode_tick(self) -> None:
        """One ragged decode step over EVERY slot row (one call shape);
        free and mid-prefill rows carry position -1 and are masked. With
        ``speculate_k`` set the tick is one verify call instead
        (:meth:`_verify_tick`)."""
        plan = self._draft_plan()
        self._grow_decode_slots(plan)
        active = [i for i, st in enumerate(self.slots)
                  if st is not None and not st.prefilling]
        if not active:
            return
        if self.speculate_k:
            self._verify_tick(active, plan)
            return
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
        self._decode_spans(active)
        with torch.inference_mode():
            logits, _ = self._steps["decode"](
                self.params, self.cfg, to_device(tokens, self.device),
                self.pool.device_caches(), to_device(pos, self.device),
                self.opts)
        nxt, lps = self._sample(logits, t)
        for i in active:
            self._emit(self.slots[i], int(nxt[i]), float(lps[i]))
        self.stats.steps += 1
        self.stats.slot_ticks += len(active)

    def _decode_spans(self, rows) -> None:
        """Open the decode-residency span of every slot in ``rows`` (a no-op
        for one already open, and without a tracer)."""
        if self.telemetry is not None:
            for i in rows:
                self.telemetry.decode_begin(self.slots[i].req.rid,
                                            f"slot{i}")

    def _verify_tick(self, active: list, plan: dict) -> None:
        """The speculative decode tick: each decoding slot's last token and
        its draft burst, right-aligned in one fixed ``(max_slots, 1 + k)``
        ``paged_verify_step`` call (every key read back from the pool: the
        sequential decode steps' attention inputs), then
        ``speculative_verify`` per slot on the device, one readback, and a
        rollback of each rejected tail. Free and mid-prefill rows ride
        fully padded."""
        k = self.speculate_k
        s = 1 + k
        r = self.max_slots
        self._register_shape("verify", r, s)
        # one upload: tokens, positions, the logits' realignment, drafts,
        # draft lengths and each row's first generation index
        host = np.zeros((r, 3 * s + k + 2), np.int32)
        tokens, posn = host[:, :s], host[:, s:2 * s]
        gather, draft = host[:, 2 * s:3 * s], host[:, 3 * s:3 * s + k]
        posn[:] = -1
        for i in active:
            st, d = self.slots[i], plan[i]
            kd = d.size
            base = int(self.pool.lengths[i]) - 1 - kd  # first position
            tokens[i, s - 1 - kd:] = np.concatenate([[st.generated[-1]], d])
            posn[i, s - 1 - kd:] = np.arange(base, base + 1 + kd)
            # verify column j (generation index t0 + j) is call column
            # s - 1 - kd + j; past the drafts the sampler ignores it
            gather[i] = s - 1 - kd + np.minimum(np.arange(s), kd)
            draft[i, :kd] = d
            host[i, -2] = kd
            host[i, -1] = len(st.generated)
        seeds, temp, tk, tp, bias = self._device_ops()
        dev = to_device(host, self.device)
        self._decode_spans(active)
        with torch.inference_mode():
            logits, _ = self._steps["verify"](
                self.params, self.cfg, dev[:, :s], self.pool.device_caches(),
                dev[:, s:2 * s], self.opts)
            idx = dev[:, 2 * s:3 * s].long()[:, :, None]
            logits = torch.gather(logits, 1, idx.expand(-1, -1,
                                                        logits.shape[-1]))
            out, n, lps = speculative_verify(
                dev[:, 3 * s:3 * s + k], dev[:, -2], logits, seeds,
                dev[:, -1], temp, tk, tp, bias)
            res = torch.cat([out.double(), n[:, None].double(),
                             lps.double()], 1).cpu().numpy()
        for i in active:
            self._emit_burst(i, res[i, :s].astype(np.int64), int(res[i, s]),
                             res[i, s + 1:].astype(np.float32), plan[i].size)
        self.stats.steps += 1
        self.stats.slot_ticks += len(active)

    def _emit_burst(self, slot: int, toks, n: int, lps, kd: int) -> None:
        """Land one verify round on ``slot``: ``toks[:n]`` are emitted in
        index order, each with its logprob under the verify logits, cut at
        the first stop token (a sequential decode would have finished
        there); then the pool rolls the slot back to the tokens actually
        fed whenever part of the appended burst went unemitted
        (``PagedKVPool.truncate``)."""
        st = self.slots[slot]
        stop = st.req.sampling.stop_set
        emit = 0
        for j in range(n):
            tok = int(toks[j])
            self._emit(st, tok, float(lps[j]))
            emit += 1
            if tok in stop:
                break
        if kd:
            self.stats.spec_rounds += 1
            self.stats.spec_drafted += kd
            self.stats.spec_accepted += emit - 1
            if self.telemetry is not None:
                self.telemetry.metrics.observe("scheduler.accepted_tokens",
                                               float(emit))
        if emit < 1 + kd:
            self.pool.truncate(slot, int(self.pool.lengths[slot])
                               - (1 + kd) + emit)

    def _packed_tick(self) -> bool:
        """ONE token-packed call for the whole tick: every decoding slot's
        next-token row and, up to the remaining budget, every mid-prefill
        slot's next piece, laid out slot-major as contiguous segments of a
        fixed ``(1, token_budget)`` buffer (tail rows carry position and
        slot -1). Decode rows are never cut and are named in ``quant_rows``
        (the reference's ``quant_fresh``), so they attend their own key as
        a sequential decode step reads it from the pool. The call gathers
        each slot's LAST row into (R, V) logits, sampled with the per-slot
        operands in one readback. With ``speculate_k`` set the decoding
        slots stay out of the buffer: their bursts must be attended through
        the pool's int8 codes, by the verify tick that follows. Returns
        whether anything was dispatched."""
        speculating = bool(self.speculate_k)
        if not speculating:
            self._grow_decode_slots()
        t_budget = self.token_budget
        tokens = np.zeros((1, t_budget), np.int32)
        posn = np.full((1, t_budget), -1, np.int32)
        slot_ids = np.full((1, t_budget), -1, np.int32)
        logit_rows = np.zeros((self.max_slots,), np.int32)
        t_idx = np.zeros((self.max_slots,), np.int32)
        decode_rows = [] if speculating else [
            i for i, st in enumerate(self.slots)
            if st is not None and not st.prefilling]
        budget = t_budget - len(decode_rows)
        cap = self._pick_chunk() if any(
            st is not None and st.prefilling for st in self.slots) else 0
        cur = 0
        pieces = {}  # slot → (lo, hi, total) prefill piece taken this tick
        for i, st in enumerate(self.slots):
            if st is None or (speculating and not st.prefilling):
                continue
            if not st.prefilling:
                tokens[0, cur] = st.generated[-1]
                posn[0, cur] = int(self.pool.lengths[i]) - 1
                slot_ids[0, cur] = i
                logit_rows[i] = cur
                t_idx[i] = len(st.generated)
                cur += 1
            elif budget > 0:
                toks = st.req.prefill_tokens
                lo = st.prefilled
                hi = min(lo + min(cap, budget), toks.size)
                n = hi - lo
                tokens[0, cur:cur + n] = toks[lo:hi]
                posn[0, cur:cur + n] = np.arange(lo, hi)
                slot_ids[0, cur:cur + n] = i
                logit_rows[i] = cur + n - 1
                pieces[i] = (lo, hi, toks.size)
                budget -= n
                cur += n
        if cur == 0:
            return False
        self._register_shape("packed", self.max_slots, t_budget)
        dev = self.device
        tel = self.telemetry
        self._decode_spans(decode_rows)
        t0 = tel.now() if tel is not None else None
        with torch.inference_mode():
            logits, _ = self._steps["packed"](
                self.params, self.cfg, to_device(tokens, dev),
                self.pool.device_caches(), to_device(posn, dev),
                to_device(slot_ids, dev), to_device(logit_rows, dev),
                self.opts, quant_rows=to_device(
                    logit_rows[decode_rows].astype(np.int64), dev))
        t1 = self._traced_end() if tel is not None else None
        nxt, lps = self._sample(logits, t_idx)
        for i, (lo, hi, total) in pieces.items():
            st = self.slots[i]
            self.pool.commit_prefill(i, hi)
            st.prefilled = hi
            self.stats.prefill_chunks += 1
            self.stats.prefill_tokens += hi - lo
            if tel is not None:
                tel.add_span("prefill", t0, t1, track=f"slot{i}",
                             rid=st.req.rid, tokens=hi - lo, stage="packed",
                             done=hi == total)
            self._maybe_pin_prefix(st, i)
            if hi == total:  # prompt complete → first token
                self._record_first_token(st, i, int(nxt[i]), float(lps[i]))
        for i in decode_rows:
            self._emit(self.slots[i], int(nxt[i]), float(lps[i]))
        self.stats.packed_ticks += 1
        self.stats.packed_tokens += cur
        self.stats.packed_pad_tokens += t_budget - cur
        if pieces:
            self.stats.prefills += 1
        if decode_rows:
            self.stats.steps += 1
            self.stats.slot_ticks += len(decode_rows)
        return True

    def _evict_finished(self) -> None:
        for i, st in enumerate(self.slots):
            if st is None or not st.done:
                continue
            toks, reason = truncate_at_stop(
                st.generated[: st.req.max_new_tokens], st.req.sampling)
            self.results[st.req.rid] = np.concatenate(
                [st.req.prompt, np.asarray(toks, np.int32)])
            self.finish_reasons[st.req.rid] = reason
            self._mark_finished(st.req.rid)
            self.pool.free(i)
            self.slots[i] = None
            self._set_ops(i, _GREEDY)
            self.stats.evicted += 1
            if self.telemetry is not None:
                self.telemetry.request_finished(st.req.rid, f"slot{i}",
                                                reason, len(toks))

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
        kind = "for admission" if self.lazy_growth else "worst-case"
        raise PoolExhaustedError(
            f"request {req.rid} needs {need} pages {kind} but the "
            f"whole pool has {self.pool.num_pages - 1} (max_blocks "
            f"{self.pool.max_blocks}); it can never be admitted")

    def step(self) -> bool:
        """One tick. Packed: admit, then ONE token-packed call carrying
        every decode token and up to a budget of prefill tokens, then
        evict (speculating: the packed call carries prefill only, and the
        decoding slots then take one verify call). Chunked and wave: admit,
        advance prefill (one chunk per mid-prefill slot, or the whole
        wave), evict what finished on its first token, decode the ragged
        batch, evict. Returns whether work remains.

        With a tracer, the tick also lands one ``TickRecord`` built from
        differences of the stats, so the traced tick makes the same
        decisions as the bare one. SINGLE-DRIVER: a second thread entering
        mid-tick raises ``RuntimeError``."""
        if not self._step_guard.acquire(blocking=False):
            raise RuntimeError(
                "Scheduler.step() re-entered from another thread mid-tick: "
                "the scheduler is single-driver — submit/abort/step must "
                "all run on ONE thread (drain_events/drain_finished are "
                "the only cross-thread-safe surfaces)")
        try:
            return self._step_guarded()
        finally:
            self._step_guard.release()

    def _step_guarded(self) -> bool:
        tel = self.telemetry
        if tel is None:
            return self._step_inner()
        s = self.stats
        pre = (s.packed_tokens, s.packed_pad_tokens, s.prefill_tokens,
               s.slot_ticks)
        tel.tick_begin(self._tick + 1, self.tick_mode)
        try:
            pending = self._step_inner()
        finally:
            if self.tick_mode == "packed":
                tokens = s.packed_tokens - pre[0]
                pad = s.packed_pad_tokens - pre[1]
                if self.speculate_k:
                    # the verify call runs outside the packed buffer:
                    # count its stepped slots as the two-call ticks do
                    tokens += s.slot_ticks - pre[3]
            else:
                # prefill tokens and one decode token per stepped slot; no
                # fixed buffer, so no pad count
                tokens = (s.prefill_tokens - pre[2]) + (s.slot_ticks - pre[3])
                pad = None
            g = self.pool.gauges()
            tel.tick_end(
                tokens=tokens, pad_tokens=pad,
                pages_in_use=g["pages_in_use"],
                pages_shared=g["pages_shared"],
                swap_bytes=g["swap_bytes"], queue_depth=len(self.queue),
                active_slots=sum(st is not None for st in self.slots),
                prefilling_slots=sum(st is not None and st.prefilling
                                     for st in self.slots))
        return pending

    def _step_inner(self) -> bool:
        self._tick += 1
        admitted, restored = self._admit_wave()
        self.stats.admitted += len(restored)
        if self.tick_mode == "packed":
            self.stats.admitted += len(admitted)
            did = self._packed_tick()
            if did or restored:
                self._track_occupancy()
                self._evict_finished()
            if self.speculate_k and any(
                    st is not None and not st.prefilling
                    for st in self.slots):
                self._decode_tick()
                self._track_occupancy()
                self._evict_finished()
            elif not (did or restored or admitted) and self.queue \
                    and all(st is None for st in self.slots):
                self._fail_stuck_queue()
            return self.pending
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
        if did_prefill or restored:
            self._track_occupancy()
            self._evict_finished()  # max_tokens == 1 finishes here
        if any(st is not None and not st.prefilling for st in self.slots):
            self._decode_tick()
            self._track_occupancy()
            self._evict_finished()
        elif (not admitted and not restored and self.queue
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
