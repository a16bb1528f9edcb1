"""The request-level serving API (port of ``repro/serving/api.py``).

  * :class:`~repro_torch.core.sampling.SamplingParams`: every per-request
    knob in one frozen dataclass;
  * :class:`GenerationRequest` / :class:`RequestOutput`: a prompt going in;
    tokens, finish reason and latency metrics coming out, with per-token
    :class:`TokenEvent` streaming in between;
  * :class:`LLMServer`: the facade: ``submit()`` requests, ``stream()``
    token events, ``run()`` to drain, ``abort()`` to cancel.

The port has the reference's three backends: ``"paged"`` (the default:
:class:`PagedBackend`, over the continuous-batching
:class:`~repro_torch.serving.scheduler.Scheduler` with its packed, chunked
and wave ticks and reserve or lazy admission), ``"fused"``
(:class:`FusedBackend`, over :class:`~repro_torch.serving.engine.Engine`)
and ``"split"`` (:class:`SplitBackend`, over the paper's
:class:`~repro_torch.serving.split_engine.SplitEngine`); the paged
backend's ``deployment="disaggregated"`` splits it into a prefill and a
decode replica joined by the page stream, and ``deployment="sharded"``
makes it one rank of the sharded deployment (its pool's pages and
attention's kv heads spread over a ``torch.distributed`` mesh). Per request,
token events arrive strictly in position order; finish events carry
``token = -1``, ``index = len(generated)`` and the finish reason
(``"stop"`` | ``"length"`` | ``"abort"`` | ``"deadline"``).

``telemetry=`` threads one :class:`~repro_torch.serving.telemetry.Tracer`
through the chosen backend (``True`` builds one, ``server.tracer``):
request-lifecycle spans, tick records and the backend's counters land in
it, and :meth:`LLMServer.metrics` merges its registry.
:class:`~repro_torch.serving.async_engine.AsyncLLMServer` drives a server
from one tick thread for asyncio clients, and
:mod:`repro_torch.serving.http` serves it over HTTP/SSE.

Quickstart::

    from repro_torch.serving.api import LLMServer
    from repro_torch.core.sampling import SamplingParams

    server = LLMServer(cfg, params, RuntimeOpts(quantized_kv=True),
                       num_pages=513, max_slots=8, max_seq_len=1024)
    rid = server.submit(prompt, SamplingParams(max_tokens=32))
    for ev in server.stream():          # or: outputs = server.run()
        print(ev.rid, ev.index, ev.token)
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.sampling import SamplingParams, truncate_at_stop
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.serving.engine import Engine
from repro_torch.serving.page_transport import DisaggregatedScheduler
from repro_torch.serving.scheduler import Scheduler
from repro_torch.serving.split_engine import SplitEngine
from repro_torch.serving.telemetry import Histogram, Tracer


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token (or the finish marker, ``token = -1``)."""

    rid: int
    index: int  # 0-based generation index; strictly increasing per rid
    token: int  # -1 on the finish marker
    finished: bool = False
    finish_reason: str | None = None  # set only on the finish marker
    # the token's log-probability under the raw model distribution; None
    # on finish markers
    logprob: float | None = None


@dataclasses.dataclass
class GenerationRequest:
    """A prompt plus its :class:`SamplingParams`; ``rid`` is assigned by
    the backend at submit."""

    prompt: np.ndarray
    sampling: SamplingParams = SamplingParams()
    rid: int = -1


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock latency per request, as ``time.perf_counter()`` stamps
    and differences (host clock: the fused backend's times include the
    device work, which ends in a device→host copy)."""

    submit_s: float = 0.0
    ttft_s: float | None = None  # submit → first streamed token
    latency_s: float | None = None  # submit → finish
    e2e_s: float | None = None  # submit → finish (the SLO surfaces' name)
    # server steps from submit to first token
    ttft_ticks: int | None = None


@dataclasses.dataclass
class RequestOutput:
    """Generated tokens (stop token included, truncated at it), finish
    reason and metrics of one request."""

    rid: int
    prompt: np.ndarray
    tokens: np.ndarray  # generated tokens only
    finished: bool = False
    finish_reason: str | None = None
    metrics: RequestMetrics = dataclasses.field(default_factory=RequestMetrics)
    split_stats: object | None = None  # split_engine.SplitStats (split only)

    @property
    def full_tokens(self) -> np.ndarray:
        """Prompt + generation."""
        return np.concatenate([np.asarray(self.prompt, np.int32),
                               np.asarray(self.tokens, np.int32)])


class _RequestBook:
    """Per-request bookkeeping: tracked requests, metrics, finished outputs,
    deferred finish events, and the ``release`` memory valve."""

    def __init__(self):
        self._reqs: dict = {}
        self._metrics: dict = {}
        self._outputs: dict = {}
        self._pending_events: list = []  # finish markers for the next step

    def _track(self, req: GenerationRequest, rid: int) -> int:
        req.rid = rid
        self._reqs[rid] = req
        self._metrics[rid] = RequestMetrics(submit_s=time.perf_counter())
        return rid

    def outputs(self) -> dict:
        return dict(self._outputs)

    def _release_dicts(self) -> tuple:
        """Extra per-rid dicts a backend also retains (popped by release)."""
        return ()

    def release(self, rid: int) -> bool:
        """Drop a FINISHED request's retained state; False for unknown or
        unfinished rids."""
        if rid not in self._outputs:
            return False
        for d in (self._outputs, self._metrics,
                  self._reqs) + self._release_dicts():
            d.pop(rid, None)
        return True


class _ReplayBackend(_RequestBook):
    """Backends that compute whole requests and then replay them as
    streams: queueing, abort, and the round-robin emitter (one token per
    request per step)."""

    def __init__(self, telemetry=None):
        super().__init__()
        self.telemetry = telemetry
        self._next_rid = 0
        self._queued: list = []
        # rid → [tokens, cursor, finish_reason, logprobs | None]
        self._streams: dict = {}
        self._split_stats: dict = {}
        self._steps = 0
        self._submit_step: dict = {}

    def submit(self, req: GenerationRequest) -> int:
        rid = self._track(req, self._next_rid)
        self._next_rid += 1
        self._queued.append(req)
        self._submit_step[rid] = self._steps
        if self.telemetry is not None:
            self.telemetry.request_submitted(rid)
        return rid

    @property
    def pending(self) -> bool:
        return bool(self._queued or self._streams or self._pending_events)

    @property
    def queue_depth(self) -> int:
        return len(self._queued)

    def _release_dicts(self) -> tuple:
        return (self._split_stats, self._submit_step)

    def abort(self, rid: int) -> bool:
        """Cancel: a queued request never computes; a streaming one is cut
        at its cursor. The finish marker arrives on the next ``step()``."""
        for i, req in enumerate(self._queued):
            if req.rid == rid:
                # by index: dataclass equality would compare prompt arrays
                del self._queued[i]
                self._finalize(rid, np.zeros((0,), np.int32), "abort")
                self._pending_events.append(TokenEvent(
                    rid, 0, -1, finished=True, finish_reason="abort"))
                return True
        if rid in self._streams:
            toks, cur, _, _ = self._streams.pop(rid)
            self._finalize(rid, toks[:cur], "abort")
            self._pending_events.append(TokenEvent(
                rid, cur, -1, finished=True, finish_reason="abort"))
            return True
        return False

    def _finalize(self, rid: int, gen, reason: str) -> None:
        m = self._metrics[rid]
        m.latency_s = m.e2e_s = time.perf_counter() - m.submit_s
        self._outputs[rid] = RequestOutput(
            rid, self._reqs[rid].prompt, np.asarray(gen, np.int32),
            finished=True, finish_reason=reason, metrics=m,
            split_stats=self._split_stats.get(rid))
        if self.telemetry is not None:
            self.telemetry.request_finished(rid, "requests", reason,
                                            len(self._outputs[rid].tokens))

    def _emit_round(self) -> list:
        events, self._pending_events = self._pending_events, []
        self._steps += 1
        now = time.perf_counter()
        for rid in list(self._streams):
            toks, cur, reason, lps = self._streams[rid]
            if cur < len(toks):
                m = self._metrics[rid]
                if m.ttft_s is None:
                    m.ttft_s = now - m.submit_s
                    m.ttft_ticks = self._steps - self._submit_step[rid]
                    if self.telemetry is not None:
                        self.telemetry.first_token(
                            rid, "requests", ttft_ticks=m.ttft_ticks)
                lp = None if lps is None else float(lps[cur])
                events.append(TokenEvent(rid, cur, int(toks[cur]),
                                         logprob=lp))
                cur += 1
                self._streams[rid][1] = cur
            if cur >= len(toks):
                del self._streams[rid]
                self._finalize(rid, toks, reason)
                events.append(TokenEvent(rid, cur, -1, finished=True,
                                         finish_reason=reason))
        return events


class FusedBackend(_ReplayBackend):
    """``Engine``'s prefill + decode loop behind the request API. Submitted
    requests accumulate until the next ``step()``, which computes all of
    them, grouped by prompt length (one ``Engine.generate_requests`` call
    per group, run to the group's largest ``max_tokens``), then replays the
    tokens as interleaved events. Per-request ``max_tokens`` and stop sets
    truncate the replay."""

    def __init__(self, cfg, params, opts: RuntimeOpts = RuntimeOpts(), *,
                 cache_len: int = 4096, telemetry=None, device=None):
        super().__init__(telemetry=telemetry)
        self.engine = Engine(cfg, params, opts, cache_len=cache_len,
                             telemetry=telemetry, device=device)
        self.device = self.engine.device

    def step(self) -> list:
        if self._queued:
            self._compute()
        return self._emit_round()

    def _compute(self) -> None:
        groups: dict = {}
        for req in self._queued:
            groups.setdefault(req.prompt.shape, []).append(req)
        self._queued = []
        for group in groups.values():
            prompts = np.stack([r.prompt for r in group])
            res = self.engine.generate_requests(
                prompts, [r.sampling for r in group])
            for i, (row, req) in enumerate(zip(res.tokens, group)):
                plen = req.prompt.shape[0]
                gen = row[plen: plen + req.sampling.max_tokens]
                toks, reason = truncate_at_stop(gen, req.sampling)
                gen = np.asarray(toks, np.int32)
                self._streams[req.rid] = [gen, 0, reason,
                                          res.logprobs[i, : gen.shape[0]]]


class SplitBackend(_ReplayBackend):
    """The paper's split system behind the request API: each request runs
    ``SplitEngine.generate`` (edge front → TS + TAB-Q uplink → cloud back,
    the Algorithm 2 deadline ladder) with its own sampling params, one
    request per ``step()``, then replays its tokens as events. The
    :class:`RequestOutput` carries the call's ``SplitStats``; a generation
    the deadline ladder cut short finishes with reason ``"deadline"``.
    ``opsc=`` is required; other keyword arguments (``cache_len=``,
    ``deadline_s=``, ``paged_cloud_kv=``, ``device=``, ...) reach the
    ``SplitEngine``. ``SamplingParams(speculate_k=)`` above 0 makes the
    request's call speculative (``SplitEngine.generate(speculate_k=)``:
    the edge drafts that many tokens a round, one payload a round); the
    carried ``SplitStats`` count the rounds and the accepted drafts."""

    def __init__(self, cfg, params, opts: RuntimeOpts = RuntimeOpts(), *,
                 opsc=None, compress: bool = True, telemetry=None,
                 **split_kwargs):
        if opsc is None:
            raise ValueError("the split backend needs opsc=OPSCConfig(...)")
        super().__init__(telemetry=telemetry)
        self.compress = compress
        self.engine = SplitEngine(cfg, params, opsc, opts=opts,
                                  telemetry=telemetry, **split_kwargs)
        self.device = self.engine.device

    def step(self) -> list:
        if self._queued and not self._streams:
            req = self._queued.pop(0)
            sp = req.sampling
            toks, stats, lps = self.engine.generate(
                req.prompt[None], sp.max_tokens, compress=self.compress,
                sampling=sp, with_logprobs=True, speculate_k=sp.speculate_k)
            gen, reason = truncate_at_stop(toks[0, req.prompt.shape[0]:], sp)
            if reason == "length" and len(gen) < sp.max_tokens:
                reason = "deadline"  # Algorithm 2 cut the generation short
            self._split_stats[req.rid] = stats
            self._streams[req.rid] = [np.asarray(gen, np.int32), 0, reason,
                                      lps[0, : len(gen)]]
        return self._emit_round()


class PagedBackend(_RequestBook):
    """The continuous-batching ``Scheduler`` behind the request API, with
    true streaming: each ``step()`` is one scheduler tick, and the tick's
    sampled tokens come back as events at once. ``abort()`` cancels in
    place (pages reclaimed in the call); a drained scheduler releases its
    pinned prefixes, as ``Scheduler.run`` does; ``release()`` also drops
    the scheduler's retained results. Keyword arguments reach the
    ``Scheduler`` (``num_pages=``, ``page_size=``, ``max_slots=``,
    ``max_seq_len=``, ``prefill_chunk=``, ``tick_mode=`` with
    ``"packed"``, ``"chunked"`` or ``"wave"``, ``token_budget=``,
    ``lazy_growth=``, ``resume=``, ``preempt_cooldown=``, ``speculate_k=``,
    ``auto_prefix=``, ``device=``). With ``speculate_k=`` k > 0 every
    decode tick verifies a prompt-lookup draft burst of up to k tokens a
    request in one call, and a tick's several tokens a request stream as
    events in index order, each with its own logprob;
    ``SamplingParams(speculate_k=)`` lowers a request's burst below k.
    The fused backend ignores ``speculate_k``: it has no incremental tick
    to amortize.

    ``deployment`` picks the topology; greedy streams agree across them:

    * ``"fused"`` (default): one scheduler on one device;
    * ``"disaggregated"``: a prefill replica and a decode replica with
      pools of their own, joined by the page stream
      (:class:`~repro_torch.serving.page_transport.DisaggregatedScheduler`);
      ``prefill_kwargs=`` and ``decode_kwargs=`` tune the two sides (their
      ``device=`` too);
    * ``"sharded"``: this rank's scheduler of the sharded deployment
      (``Scheduler(mesh=)``: pool pages sharded over the mesh's ``"kv"``
      dim, attention's kv heads over ``"model"``). Every rank builds the
      same server and is given the same submissions. ``mesh=`` pins a
      mesh; omitted, it is ``launch.mesh.make_serving_mesh`` over the
      default process group, which the caller has initialized (else it
      raises ``RuntimeError``). ``mesh=`` with another deployment raises
      ``ValueError``."""

    def __init__(self, cfg, params, opts: RuntimeOpts = RuntimeOpts(), *,
                 telemetry=None, deployment: str = "fused",
                 **scheduler_kwargs):
        super().__init__()
        self.telemetry = telemetry
        mesh = scheduler_kwargs.pop("mesh", None)
        if mesh is not None and deployment != "sharded":
            raise ValueError(f"mesh= requires deployment='sharded', not "
                             f"{deployment!r}")
        if deployment == "fused":
            self.scheduler = Scheduler(cfg, params, opts,
                                       telemetry=telemetry,
                                       **scheduler_kwargs)
        elif deployment == "sharded":
            if mesh is None:
                from repro_torch.launch.mesh import make_serving_mesh

                mesh = make_serving_mesh(cfg.pattern[0].mixer.num_kv_heads)
            self.scheduler = Scheduler(cfg, params, opts,
                                       telemetry=telemetry, mesh=mesh,
                                       **scheduler_kwargs)
        elif deployment == "disaggregated":
            self.scheduler = DisaggregatedScheduler(
                cfg, params, opts, telemetry=telemetry, **scheduler_kwargs)
        else:
            raise ValueError(f"unknown deployment {deployment!r}: expected "
                             f"'fused', 'sharded' or 'disaggregated'")
        self.deployment = deployment
        self.device = self.scheduler.device

    def submit(self, req: GenerationRequest) -> int:
        return self._track(req, self.scheduler.submit(
            req.prompt, sampling=req.sampling))

    @property
    def pending(self) -> bool:
        return self.scheduler.pending or bool(self._pending_events)

    @property
    def queue_depth(self) -> int:
        """Requests waiting unadmitted in the scheduler's queue; the
        disaggregated facade sums its two replicas' queues."""
        sched = self.scheduler
        if hasattr(sched, "queue"):
            return len(sched.queue)
        return len(sched.prefill.queue) + len(sched.decode.queue)

    def _release_dicts(self) -> tuple:
        rd = getattr(self.scheduler, "_release_dicts", None)
        if rd is not None:  # the disaggregated facade's own dicts
            return rd()
        return (self.scheduler.results, self.scheduler.finish_reasons)

    def step(self) -> list:
        events, sched = self._pending_events, self.scheduler
        self._pending_events = []
        if sched.pending:
            sched.step()
        events += self._collect(time.perf_counter())
        if not sched.pending:  # drained: the same reclamation as run()
            sched.release_prefixes()
        return events

    def abort(self, rid: int) -> bool:
        ok = self.scheduler.abort(rid)
        if ok:  # the partial result now, its events on the next step
            self._pending_events += self._collect(time.perf_counter())
        return ok

    def _collect(self, now: float) -> list:
        sched, events = self.scheduler, []
        for rid, idx, tok, lp in sched.drain_events():
            m = self._metrics[rid]
            if m.ttft_s is None:
                m.ttft_s = now - m.submit_s
            events.append(TokenEvent(rid, idx, tok, logprob=lp))
        for rid in sched.drain_finished():
            req = self._reqs[rid]
            reason = sched.finish_reasons.get(rid, "length")
            gen = np.asarray(sched.results[rid][req.prompt.shape[0]:],
                             np.int32)
            m = self._metrics[rid]
            m.latency_s = m.e2e_s = now - m.submit_s
            # the tracer's copy when tracing (the same value; it survives a
            # reset of the stats)
            m.ttft_ticks = sched.stats.ttft_ticks.get(rid)
            if self.telemetry is not None:
                m.ttft_ticks = self.telemetry.ttft_ticks.get(rid, m.ttft_ticks)
            self._outputs[rid] = RequestOutput(
                rid, req.prompt, gen, finished=True, finish_reason=reason,
                metrics=m)
            events.append(TokenEvent(rid, gen.shape[0], -1, finished=True,
                                     finish_reason=reason))
        return events


_BACKENDS = {"fused": FusedBackend, "paged": PagedBackend,
             "split": SplitBackend}


class LLMServer:
    """The facade over a serving backend. ``backend`` is ``"paged"`` (the
    default; extra keyword arguments, e.g. ``num_pages=``, ``max_slots=``,
    ``tick_mode="packed"``, ``lazy_growth=True`` and ``device=``, reach
    :class:`PagedBackend`'s ``Scheduler``; ``speculate_k=`` makes its
    decode ticks speculative),
    ``"fused"`` (``cache_len=`` and ``device=`` reach :class:`FusedBackend`),
    ``"split"`` (``opsc=``, ``compress=`` and the ``SplitEngine``'s keyword
    arguments reach :class:`SplitBackend`) or an already-built backend.
    Every backend runs on the ``device`` it names (``cuda`` unless the
    caller names another).

    ``telemetry`` threads one :class:`~repro_torch.serving.telemetry.Tracer`
    through the backend (``True`` builds one); it is ``server.tracer``, and
    :meth:`metrics` merges its registry. None keeps every instrumented
    path a strict no-op."""

    def __init__(self, cfg=None, params=None,
                 opts: RuntimeOpts = RuntimeOpts(), *,
                 backend="paged", telemetry=None, **backend_kwargs):
        if telemetry is True:
            telemetry = Tracer()
        self.tracer = telemetry
        if isinstance(backend, str):
            if backend not in _BACKENDS:
                raise ValueError(f"backend must be one of ['fused', 'paged', "
                                 f"'split'], got {backend!r}")
            backend = _BACKENDS[backend](cfg, params, opts,
                                         telemetry=telemetry,
                                         **backend_kwargs)
        elif telemetry is not None and getattr(
                backend, "telemetry", None) is None:
            raise ValueError(
                "pass telemetry= to the backend's constructor when handing "
                "LLMServer an already-built backend")
        self.backend = backend
        if self.tracer is None:  # adopt a prebuilt backend's tracer
            self.tracer = getattr(backend, "telemetry", None)

    def submit(self, prompt,
               sampling: SamplingParams = SamplingParams()) -> int:
        """Enqueue ONE request (a 1-D token sequence); returns its rid."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim == 0:
            prompt = prompt.reshape(1)
        if prompt.ndim != 1:
            raise ValueError(
                f"submit takes ONE 1-D prompt, got shape {prompt.shape} — "
                f"submit a batch as one request per row")
        return self.backend.submit(GenerationRequest(prompt, sampling))

    @property
    def pending(self) -> bool:
        return self.backend.pending

    @property
    def queue_depth(self) -> int:
        """Requests accepted but not yet computing."""
        return getattr(self.backend, "queue_depth", 0)

    def stream(self):
        """Drive the backend, yielding :class:`TokenEvent`s, until every
        submitted request has finished."""
        while self.backend.pending:
            yield from self.backend.step()

    def run(self) -> dict:
        """Drain everything; returns {rid: :class:`RequestOutput`}."""
        for _ in self.stream():
            pass
        return self.backend.outputs()

    def outputs(self) -> dict:
        return self.backend.outputs()

    def abort(self, rid: int) -> bool:
        """Cancel a request; its partial output (reason ``"abort"``)
        appears in :meth:`outputs`."""
        return self.backend.abort(rid)

    def release(self, rid: int) -> bool:
        """Drop a finished request's retained output and metrics."""
        return self.backend.release(rid)

    def metrics(self) -> dict:
        """Flat ``{name: number}`` metrics. Always: from the finished
        outputs still retained, count, per-reason counts, and percentile
        summaries of ``requests.ttft_s`` / ``latency_s`` / ``ttft_ticks`` /
        ``e2e_s`` / ``tpot_s``. With a tracer, its whole registry (tick
        times, pool gauges, TTFT/TPOT/e2e histograms, shape counters, the
        split uplink account) under its own names."""
        out: dict = {}
        if self.tracer is not None:
            out.update(self.tracer.metrics_dict())
        finished = self.backend.outputs()
        out["requests.retained"] = len(finished)
        ttft, lat = Histogram(), Histogram()
        ticks, e2e, tpot = Histogram(), Histogram(), Histogram()
        for o in finished.values():
            out[f"requests.reason.{o.finish_reason}"] = out.get(
                f"requests.reason.{o.finish_reason}", 0) + 1
            m = o.metrics
            if m.ttft_s is not None:
                ttft.record(m.ttft_s)
            if m.latency_s is not None:
                lat.record(m.latency_s)
            if m.ttft_ticks is not None:
                ticks.record(m.ttft_ticks)
            e2e_v = m.e2e_s if m.e2e_s is not None else m.latency_s
            if e2e_v is not None:
                e2e.record(e2e_v)
                if m.ttft_s is not None and len(o.tokens) > 1:
                    tpot.record((e2e_v - m.ttft_s) / (len(o.tokens) - 1))
        for name, h in (("requests.ttft_s", ttft),
                        ("requests.latency_s", lat),
                        ("requests.ttft_ticks", ticks),
                        ("requests.e2e_s", e2e),
                        ("requests.tpot_s", tpot)):
            for k, v in h.summary().items():
                out[f"{name}.{k}"] = v
        return out
