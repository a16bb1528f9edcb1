"""Async serving front end: one background tick thread, many asyncio clients
(port of ``repro/serving/async_engine.py``).

Everything below :class:`LLMServer` is synchronous and single-driver — the
scheduler's tick loop wants to be driven hard from ONE thread, while HTTP
clients arrive concurrently on an asyncio event loop. This module is the
bridge:

  * a daemon **tick thread** owns the backend outright: it drives
    ``backend.step()`` continuously while work is pending and executes
    every mutating call (``submit`` / ``abort`` / ``metrics`` / ...)
    marshaled to it through a command queue — the scheduler never sees a
    second thread, so its single-driver contract
    (:meth:`repro_torch.serving.scheduler.Scheduler.step`) holds by
    construction;
  * each tick's :class:`~repro_torch.serving.api.TokenEvent` batch fans out to
    per-request ``asyncio.Queue``s via ``loop.call_soon_threadsafe`` —
    clients ``async for`` over :meth:`AsyncLLMServer.stream` without ever
    touching the backend;
  * **bounded admission**: :meth:`submit` raises :class:`AdmissionError`
    (HTTP 429 upstream) once ``server.queue_depth`` — requests accepted
    but not yet scheduled — reaches ``max_queue_depth``, so a traffic
    burst queues in the CLIENTS, not in an unbounded server-side list;
  * **client disconnect → abort**: leaving :meth:`stream` early (the HTTP
    layer closes the generator when the socket drops) fires
    :meth:`abort_nowait`, so an abandoned request frees its pool pages on
    the very next tick;
  * **graceful shutdown**: :meth:`shutdown` stops admission, optionally
    drains in-flight requests to completion (``drain=True``) or aborts
    them (``drain=False`` — the abort finish markers still flush to every
    open stream), then joins the thread.

Because all request wall-clock stamps (``RequestMetrics.ttft_s`` /
``e2e_s``) are taken by whichever thread drives the backend, running under
this front end stamps them on the tick thread — ``metrics()`` (and the
HTTP ``/v1/metrics`` endpoint) report real concurrent-serving latencies
with or without a tracer attached.

On a CUDA device:

  * the tick thread runs its whole life inside ``torch.cuda.device`` of
    the backend's device. A new thread's current device is 0, and two
    things of the port are keyed by the CURRENT device: a kernel's
    shared-memory opt-in and the per-(device, stream) tickets and
    workspaces of ``kernels/tickets.py``;
  * the tick thread is the ONLY thread that launches a kernel or reads a
    device tensor: ``metrics()``, ``outputs()`` and ``release()`` are
    marshaled to it too, and what reaches the event loop is host ints,
    floats and numpy arrays, never a tensor (the kernels' launch counters
    are plain module attributes, correct only under this rule);
  * a failure stays loud: an exception in the tick thread (a kernel that
    does not build or launch, a CUDA error) reaches every open stream and
    every waiting :meth:`AsyncLLMServer.result` as that exception, later
    submits as :class:`EngineClosedError` chained to it, and
    :meth:`AsyncLLMServer.shutdown` re-raises it. Nothing retries on the
    CPU or through a plain version;
  * kernels build at first use, on whichever thread calls first: a
    service builds and loads them before it takes traffic
    (``serving/http.py``'s ``main``), so that no first token waits on
    ``nvcc``.

Quickstart::

    server = AsyncLLMServer(LLMServer(cfg, params, opts, backend="paged",
                                      num_pages=64, max_slots=4))
    rid = await server.submit(prompt, SamplingParams(max_tokens=32))
    async for ev in server.stream(rid):
        ...                         # TokenEvents; last one has .finished
    out = await server.result(rid)  # RequestOutput
    await server.shutdown()
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import dataclasses
import queue
import threading

import torch

from repro_torch.core.sampling import SamplingParams
from repro_torch.serving.api import LLMServer, RequestOutput, TokenEvent


class AdmissionError(RuntimeError):
    """Submit refused: the backend's unscheduled queue is at
    ``max_queue_depth`` (the HTTP layer maps this to 429 + Retry-After)."""


class EngineClosedError(RuntimeError):
    """Submit refused: the engine is shutting down or has shut down."""


@dataclasses.dataclass
class _Failure:
    """In-band sentinel pushed to every open stream when the tick thread
    dies on an unexpected exception — streams re-raise it."""

    exc: BaseException


class AsyncLLMServer:
    """Asyncio facade over one :class:`~repro_torch.serving.api.LLMServer`.

    THREAD MODEL — two threads, one owner:

    * the **tick thread** (started in ``__init__``) is the backend's only
      driver. Its loop: drain the command queue, then if
      ``backend.pending`` run ONE ``backend.step()`` and fan the events
      out; otherwise block briefly waiting for a command. Every method
      here that touches the backend marshals a closure onto this thread
      and awaits its ``concurrent.futures.Future``.
    * the **event-loop thread** only ever reads per-request
      ``asyncio.Queue``s (filled via ``call_soon_threadsafe``) and awaits
      marshaled futures. The loop is captured on the first async call and
      must stay the same for the server's lifetime.
    * on a CUDA backend the tick thread runs inside ``torch.cuda.device``
      of the backend's device (module docstring).

    ``max_queue_depth`` bounds admission (see :class:`AdmissionError`);
    ``idle_wait_s`` is how long the tick thread parks per wait when there
    is no work — it bounds submit→first-tick latency on an idle server.

    A server of the sharded deployment raises ``NotImplementedError``: its
    ranks must each be handed every request, and an asyncio front over
    them is not ported yet (ROADMAP queue 1, item 8).
    """

    def __init__(self, server: LLMServer, *, max_queue_depth: int = 64,
                 idle_wait_s: float = 0.005):
        if getattr(server.backend, "deployment", None) == "sharded":
            raise NotImplementedError(
                "AsyncLLMServer over deployment='sharded': one front over "
                "the ranks of the sharded deployment is not ported yet "
                "(ROADMAP queue 1, item 8, the sharded deployment's fronts)")
        self.server = server
        self.max_queue_depth = max_queue_depth
        self.idle_wait_s = idle_wait_s
        self._loop: asyncio.AbstractEventLoop | None = None
        self._cmds: queue.SimpleQueue = queue.SimpleQueue()
        # All three written ONLY on the tick thread (submit/abort/metrics
        # closures + _dispatch run there), read anywhere:
        self._subs: dict = {}     # rid -> asyncio.Queue of TokenEvent
        self._live: set = set()   # rids submitted, not yet finished
        self._waiters: dict = {}  # rid -> [Future[RequestOutput]]
        self._closing = False     # no new admissions
        self._stopping = False    # tick thread exits once drained + idle
        # guards the enqueue-vs-thread-exit race: once the tick thread
        # flips _accepting under this lock, new commands run inline on
        # the caller instead of landing in a queue nobody drains
        self._accept_lock = threading.Lock()
        self._accepting = True
        self._error: BaseException | None = None
        self._device = self._tick_device(server)
        self._exit_fut: concurrent.futures.Future = concurrent.futures.Future()
        self._thread = threading.Thread(target=self._run,
                                        name="asyncllm-tick", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- public

    async def submit(self, prompt,
                     sampling: SamplingParams = SamplingParams()) -> int:
        """Admit one request; returns its rid. Raises
        :class:`AdmissionError` when the unscheduled queue is full and
        :class:`EngineClosedError` after :meth:`shutdown` began. The
        admission check and the submit run atomically on the tick thread,
        so concurrent submits can never jointly overshoot the bound."""
        q: asyncio.Queue = asyncio.Queue()

        def _do() -> int:
            if self._error is not None:
                raise EngineClosedError(
                    f"engine failed: {self._error!r}") from self._error
            if self._closing:
                raise EngineClosedError("engine is shut down")
            if self.server.queue_depth >= self.max_queue_depth:
                raise AdmissionError(
                    f"admission queue full ({self.max_queue_depth} "
                    f"unscheduled requests) — retry later")
            rid = self.server.submit(prompt, sampling)
            self._subs[rid] = q
            self._live.add(rid)
            return rid

        return await self._call(_do)

    async def stream(self, rid: int):
        """``async for ev in server.stream(rid)`` — the request's
        :class:`TokenEvent`s in position order; the last event has
        ``finished=True``. Single consumer per rid. Exiting early (client
        disconnect, ``break``, task cancellation) aborts the request so
        its pool pages free on the next tick."""
        q = self._subs.get(rid)
        if q is None:
            raise KeyError(f"rid {rid}: never submitted, already streamed, "
                           f"or released")
        finished = False
        try:
            while True:
                ev = await q.get()
                if isinstance(ev, _Failure):
                    raise ev.exc
                yield ev
                if ev.finished:
                    finished = True
                    return
        finally:
            self._subs.pop(rid, None)
            if not finished:
                self.abort_nowait(rid)

    async def result(self, rid: int) -> RequestOutput:
        """Await the request's :class:`RequestOutput` (finished OR
        aborted) without consuming its stream."""
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _register() -> None:
            out = self.server.outputs().get(rid)
            if out is not None:
                fut.set_result(out)
            elif self._error is not None:  # it will never finish
                fut.set_exception(self._error)
            elif rid in self._live:
                self._waiters.setdefault(rid, []).append(fut)
            else:
                fut.set_exception(
                    KeyError(f"rid {rid}: never submitted or released"))

        await self._call(_register)
        return await asyncio.wrap_future(fut)

    async def abort(self, rid: int) -> bool:
        """Cancel a request (confirmed): True if it was live. Its finish
        marker (reason ``"abort"``) still flushes to an open stream."""
        return await self._call(lambda: self.server.abort(rid))

    def abort_nowait(self, rid: int) -> None:
        """Fire-and-forget abort, safe from ANY context — including a
        generator ``finally`` running under ``GeneratorExit``, where no
        further ``await`` is allowed. This is the disconnect path."""
        with self._accept_lock:
            # after a tick-thread failure nothing runs on the backend any
            # more: a stream that ends BY the failure must not abort its
            # request into a finished output that ``result`` would return
            if self._accepting and self._error is None:
                self._cmds.put((lambda: self.server.abort(rid), None))
        # after shutdown the backend is drained — nothing left to free

    async def release(self, rid: int) -> bool:
        """Drop a finished request's retained output/metrics (the
        long-lived-server memory valve — see ``LLMServer.release``)."""
        def _do() -> bool:
            self._subs.pop(rid, None)
            self._waiters.pop(rid, None)
            return self.server.release(rid)
        return await self._call(_do)

    async def metrics(self) -> dict:
        """``LLMServer.metrics()`` computed on the tick thread (it reads
        the backend's retained outputs, which only that thread writes)."""
        return await self._call(self.server.metrics)

    async def shutdown(self, *, drain: bool = True) -> None:
        """Stop admission, then either let in-flight requests run to
        completion (``drain=True``) or abort them all (``drain=False`` —
        open streams still receive the abort finish markers), then stop
        and join the tick thread. Idempotent. Re-raises the exception that
        killed the tick thread, if one did."""
        def _close() -> None:
            self._closing = True
            if not drain:
                for rid in sorted(self._live):
                    self.server.abort(rid)

        await self._call(_close)
        self._stopping = True
        await asyncio.wrap_future(self._exit_fut)
        self._thread.join(timeout=5.0)  # at set_result it is already exiting
        if self._error is not None:
            raise self._error

    @property
    def queue_depth(self) -> int:
        """Unscheduled-request depth the admission bound is measured
        against (a cross-thread read of one int — advisory, exact only on
        the tick thread where :meth:`submit` re-checks it)."""
        return self.server.queue_depth

    @property
    def closed(self) -> bool:
        return self._closing

    @property
    def error(self) -> BaseException | None:
        """The exception that killed the tick thread, if any."""
        return self._error

    async def __aenter__(self) -> "AsyncLLMServer":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.shutdown(drain=exc == (None, None, None))

    # -------------------------------------------------------- tick thread

    @staticmethod
    def _tick_device(server: LLMServer):
        """The CUDA device the backend runs on, with its index fixed on the
        constructing thread (an index-less ``cuda`` means that thread's
        current device), or None off CUDA."""
        dev = getattr(server.backend, "device", None)
        if dev is None or dev.type != "cuda":
            return None
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def _run(self) -> None:
        scope = torch.cuda.device(self._device) \
            if self._device is not None else contextlib.nullcontext()
        with scope:
            self._tick_loop()

    def _tick_loop(self) -> None:
        try:
            while True:
                while True:  # commands first: submits join the next tick
                    try:
                        self._exec(self._cmds.get_nowait())
                    except queue.Empty:
                        break
                if self.server.pending:
                    for ev in self.server.backend.step():
                        self._dispatch(ev)
                    continue
                if self._stopping:
                    break
                try:  # idle: park until a command (or the next poll)
                    self._exec(self._cmds.get(timeout=self.idle_wait_s))
                except queue.Empty:
                    pass
        except BaseException as e:  # noqa: BLE001 — fan failure to clients
            self._fail(e)
        finally:
            self._closing = True
            with self._accept_lock:
                self._accepting = False  # later commands run caller-inline
            while True:  # commands that raced the flip drain here
                try:
                    self._exec(self._cmds.get_nowait())
                except queue.Empty:
                    break
            self._exit_fut.set_result(None)

    def _exec(self, cmd) -> None:
        fn, fut = cmd
        try:
            res = fn()
        except BaseException as e:  # noqa: BLE001 — surfaces via future
            if fut is not None:
                fut.set_exception(e)
            elif self._error is None:
                raise  # fire-and-forget abort failed: that IS an engine bug
        else:
            if fut is not None:
                fut.set_result(res)

    def _dispatch(self, ev: TokenEvent) -> None:
        if ev.finished:
            self._live.discard(ev.rid)
            waiters = self._waiters.pop(ev.rid, ())
            if waiters:
                out = self.server.outputs().get(ev.rid)
                for fut in waiters:
                    fut.set_result(out)
        q = self._subs.get(ev.rid)
        if q is not None and self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(q.put_nowait, ev)
            except RuntimeError:
                pass  # loop already closed: nobody is listening

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._closing = True
        for rid, waiters in self._waiters.items():
            for fut in waiters:
                if not fut.done():
                    fut.set_exception(exc)
        self._waiters.clear()
        if self._loop is not None:
            for q in list(self._subs.values()):
                try:
                    self._loop.call_soon_threadsafe(q.put_nowait,
                                                    _Failure(exc))
                except RuntimeError:
                    pass

    # ---------------------------------------------------------- marshaling

    def _call_future(self, fn) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._accept_lock:
            if self._accepting:
                self._cmds.put((fn, fut))
                return fut
        # post-shutdown: the backend is drained and single-threaded again
        # — run read-only surfaces (metrics, outputs) inline; submit
        # still refuses via the _closing check
        try:
            fut.set_result(fn())
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)
        return fut

    async def _call(self, fn):
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
        elif self._loop is not loop:
            raise RuntimeError(
                "AsyncLLMServer is bound to one event loop for its "
                "lifetime; build a new server per loop")
        return await asyncio.wrap_future(self._call_future(fn))
