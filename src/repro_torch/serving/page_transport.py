"""Movers of paged-KV bytes between memory domains (port of
``repro/serving/page_transport.py``: the host-swap and TAB-Q uplink movers,
the page stream, and the disaggregated deployment built on it).

:class:`PageTransport` keeps the accounting every mover shares: the bytes
moved, the transfers and the host seconds they took. The VALUES moved are
never touched, so the bit-identity of the mechanism underneath survives.
:class:`HostSwapTransport` is the scheduler's preempt/resume mover: device
pages → host snapshot → device pages on one pool
(``kv_pool.PagedKVPool.export_slot`` / ``restore_slot``).
:class:`TabqUplinkTransport` is the split engine's edge→cloud mover.
:class:`PageStreamTransport` ships a request's written int8 pages from a
prefill replica's pool into a decode replica's pool.

With ``telemetry=`` (a ``serving.telemetry.Tracer``) every transfer also
lands as one span (``t0``/``t1``/``bytes``/``rid``; swaps on the slot's
track, as ``"swap_out"`` and ``"swap_resume"``; the page stream on
``"transport"``, one span a pattern position), a bytes histogram and
running totals under ``transport.<kind>.*``; the uplink adds the
``"uplink"`` event on the ``"split:uplink"`` track.

:class:`DisaggregatedScheduler` is the ``deployment="disaggregated"`` of
``serving.api.LLMServer`` (DistServe/Splitwise-style serving): a
:class:`PrefillWorker` admits each request, prefills it and emits its first
token; its pages then stream into a :class:`DecodeWorker`'s own pool, and
the decode replica decodes it to the end. The handoff is the swap
export/restore round trip, so a greedy stream is the single scheduler's,
bit for bit, wherever the prefill was cut into the same pieces.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.device import device_scope
from repro_torch.models.transformer import RuntimeOpts
from repro_torch.serving.kv_pool import PagedKVPool


class PageTransport:
    """Base mover: bytes, transfers and host seconds for one transport
    kind, and with a tracer a span and a bytes histogram a transfer.
    Subclasses set ``kind`` and call :meth:`_record` once per transfer;
    with ``telemetry=None`` no tracer is touched."""

    kind = "transport"

    def __init__(self, telemetry=None):
        self.telemetry = telemetry
        self.bytes_moved = 0  # total payload BYTES across transfers
        self.transfers = 0
        # host seconds spent in transfers (on the tracer's clock when one
        # is attached, which is time.perf_counter unless a test injects one)
        self.seconds = 0.0

    def _now(self) -> float:
        tel = self.telemetry
        return tel.now() if tel is not None else time.perf_counter()

    def _record(self, name: str, t0: float, t1: float, nbytes: float,
                rid: int | None = None, track: str = "transport",
                **attrs) -> None:
        """Account one transfer that ran from ``t0`` to ``t1``: the
        counters, and with a tracer a span on ``track`` and the kind's
        bytes histogram and totals."""
        self.bytes_moved += int(nbytes)
        self.transfers += 1
        self.seconds += t1 - t0
        tel = self.telemetry
        if tel is None:
            return
        tel.add_span(name, t0, t1, track=track, rid=rid, bytes=int(nbytes),
                     transport=self.kind, **attrs)
        tel.metrics.count(f"transport.{self.kind}.transfers")
        tel.metrics.count(f"transport.{self.kind}.total_bytes", int(nbytes))
        tel.metrics.observe(f"transport.{self.kind}.bytes", float(nbytes))


class HostSwapTransport(PageTransport):
    """The preempt/resume mover: device pages ⇄ host snapshot on ONE pool,
    its spans ``"swap_out"`` and ``"swap_resume"`` on the slot's track. A
    swap-out copies to the host and so waits for the device."""

    kind = "host_swap"

    def swap_out(self, pool: PagedKVPool, slot: int, n_tokens: int,
                 rid: int | None = None) -> dict:
        t0 = self._now()
        snapshot = pool.export_slot(slot, n_tokens=n_tokens)
        self._record("swap_out", t0, self._now(),
                     pool.snapshot_bytes(snapshot), rid=rid,
                     track=f"slot{slot}")
        return snapshot

    def swap_in(self, pool: PagedKVPool, snapshot: dict,
                reserve_tokens: int | None = None,
                rid: int | None = None) -> int:
        nbytes = pool.snapshot_bytes(snapshot)
        t0 = self._now()
        slot = pool.restore_slot(snapshot, reserve_tokens=reserve_tokens)
        self._record("swap_resume", t0, self._now(), nbytes, rid=rid,
                     track=f"slot{slot}")
        return slot


class TabqUplinkTransport(PageTransport):
    """The split engine's edge→cloud mover of TS+TAB-Q activation payloads.
    The engine computes each payload (compression is model code); this
    class keeps the wire accounting, the payload's bits rounded up to whole
    bytes, one transfer a payload, and with a tracer the ``"uplink"`` event
    (its ``bits``, and ``attrs`` such as the stage) on ``"split:uplink"``."""

    kind = "tabq_uplink"

    def uplink(self, bits: float, rid: int | None = None, **attrs) -> None:
        t = self._now()
        if self.telemetry is not None:
            self.telemetry.event("uplink", track="split:uplink", rid=rid,
                                 t=t, bits=bits, **attrs)
        self._record("uplink", t, t, -(-int(bits) // 8), rid=rid, **attrs)


class PageStreamTransport(PageTransport):
    """Streams one request's written int8 pages, scales and position tags
    (the swap snapshot, as the pool stores them) from a prefill replica's
    pool into a decode replica's, one transfer and one ``"page_stream"``
    span a pattern position (``layer``, ``tokens``, ``bytes``, ``rid``):
    the reference ships the snapshot's per-position leaves one by one. The
    port's snapshot holds every layer in one tensor a leaf, layer
    ``block · len(pattern) + position``, so position p's share is the
    leaves' ``p::len(pattern)`` layers. The copy is the wire: the receiver
    gets tensors of its own, never views of the sender's, and the
    snapshot's bytes move from the sender's account to the receiver's
    (``discard_snapshot``, ``adopt_snapshot``). Both ends are host memory,
    whichever cards the two pools live on."""

    kind = "page_stream"

    def send(self, src_pool: PagedKVPool, dst_pool: PagedKVPool,
             snapshot: dict, rid: int | None = None) -> dict:
        if src_pool.page_size != dst_pool.page_size:
            raise ValueError(
                f"page stream needs matching page sizes: prefill pool has "
                f"{src_pool.page_size}, decode pool {dst_pool.page_size}")
        leaves = snapshot["data"]
        n_pos = len(src_pool.cfg.pattern)
        moved = tuple(torch.empty_like(leaf) for leaf in leaves)
        for layer in range(n_pos):
            t0 = self._now()
            nbytes = 0
            for dst, src in zip(moved, leaves):
                part = src[layer::n_pos]
                dst[layer::n_pos] = part
                nbytes += part.numel() * part.element_size()
            self._record("page_stream", t0, self._now(), nbytes, rid=rid,
                         layer=layer, tokens=snapshot["length"])
        out = {"length": snapshot["length"], "data": moved}
        src_pool.discard_snapshot(snapshot)
        dst_pool.adopt_snapshot(out)
        return out


class PrefillWorker:
    """The prefill replica: a whole ``Scheduler`` that admits, prefills and
    emits each request's first token, then hands it off. :meth:`harvest`
    extracts every slot past its prompt with a token and not finished;
    each extracted ``Request`` carries its tokens and its pages'
    snapshot."""

    def __init__(self, scheduler):
        self.scheduler = scheduler

    def tick(self) -> None:
        if self.scheduler.pending:
            self.scheduler.step()

    def harvest(self) -> list:
        sched = self.scheduler
        ready = [st.req.rid for st in sched.slots
                 if st is not None and not st.prefilling and st.generated
                 and not st.done]
        return [sched.extract(rid) for rid in ready]


class DecodeWorker:
    """The decode replica: a whole ``Scheduler`` that never ``submit``s. It
    ``inject``s streamed requests, restores their pages through the
    swap-resume admission and decodes them to the end."""

    def __init__(self, scheduler):
        self.scheduler = scheduler

    def accept(self, req) -> None:
        self.scheduler.inject(req)

    def tick(self) -> None:
        if self.scheduler.pending:
            self.scheduler.step()


class DisaggregatedScheduler:
    """Disaggregated serving behind the scheduler facade that
    ``serving.api.PagedBackend`` drives: a :class:`PrefillWorker` and a
    :class:`DecodeWorker`, each a ``Scheduler`` over its OWN pool, joined by
    a :class:`PageStreamTransport`.

    Each :meth:`step` runs one prefill-replica tick, extracts every request
    that finished its prompt (its first token already emitted: TTFT is a
    prefill-side quantity), streams its pages across, injects it into the
    decode replica and runs one decode-replica tick. Keyword arguments go
    to both schedulers; ``prefill_kwargs=`` and ``decode_kwargs=`` override
    them per side (``device=`` too: the replicas may sit on two cards, and
    each tick runs with its replica's card current). ``speculate_k`` is
    forced to 0 on the prefill side, which never decodes far. The two pools
    must share ``page_size`` (``ValueError``). The tracer goes to the
    prefill replica only, as in the reference; the transport records into
    it too. On one device the replicas share the weights: ``Scheduler``
    moves a tensor already on its device by reference.

    Single-driver, as ``Scheduler``: ``submit``, ``abort`` and ``step`` on
    one thread; the drains may run on another."""

    def __init__(self, cfg, params, opts: RuntimeOpts = RuntimeOpts(), *,
                 telemetry=None, prefill_kwargs: dict | None = None,
                 decode_kwargs: dict | None = None, **scheduler_kwargs):
        # scheduler.py imports this module (HostSwapTransport)
        from repro_torch.serving.scheduler import Scheduler

        self.transport = PageStreamTransport(telemetry=telemetry)
        pk = dict(scheduler_kwargs)
        pk["speculate_k"] = 0  # the prefill replica never decodes far
        pk.update(prefill_kwargs or {})
        dk = dict(scheduler_kwargs)
        dk.update(decode_kwargs or {})
        self.prefill = Scheduler(cfg, params, opts, telemetry=telemetry,
                                 **pk)
        self.decode = Scheduler(cfg, params, opts, telemetry=None, **dk)
        if self.prefill.pool.page_size != self.decode.pool.page_size:
            raise ValueError("prefill and decode pools must share page_size")
        self.device = self.prefill.device  # requests enter here
        self.workers = (PrefillWorker(self.prefill),
                        DecodeWorker(self.decode))

    # ------------------------------------------------- scheduler facade

    def submit(self, prompt, max_new_tokens=None, eos_id=None, *,
               prefix_key=None, prefix_len=None, priority=None,
               sampling=None) -> int:
        """Requests enter through the prefill replica, whose rids are the
        only ones: the decode replica only ``inject``s."""
        return self.prefill.submit(prompt, max_new_tokens, eos_id,
                                   prefix_key=prefix_key,
                                   prefix_len=prefix_len, priority=priority,
                                   sampling=sampling)

    @property
    def pending(self) -> bool:
        return self.prefill.pending or self.decode.pending

    def step(self) -> bool:
        """One disaggregated tick: prefill tick, harvest, page stream,
        inject, decode tick. Returns whether work remains."""
        pre, dec = self.workers
        with device_scope(self.prefill.device):
            pre.tick()
            handed = pre.harvest()
        for req in handed:
            req.snapshot = self.transport.send(
                self.prefill.pool, self.decode.pool, req.snapshot,
                rid=req.rid)
            dec.accept(req)
        with device_scope(self.decode.device):
            dec.tick()
        return self.pending

    def run(self) -> dict:
        while self.step():
            pass
        self.release_prefixes()
        return self.results

    def abort(self, rid: int) -> bool:
        return self.prefill.abort(rid) or self.decode.abort(rid)

    def drain_events(self) -> list:
        """The prefill replica's events first (each request's first
        tokens), then the decode replica's: a request's per-index order
        holds, because its handoff comes after its prefill-side tokens and
        before its first decode-side one."""
        return self.prefill.drain_events() + self.decode.drain_events()

    def drain_finished(self) -> list:
        return self.prefill.drain_finished() + self.decode.drain_finished()

    @property
    def results(self) -> dict:
        return {**self.prefill.results, **self.decode.results}

    @property
    def finish_reasons(self) -> dict:
        return {**self.prefill.finish_reasons, **self.decode.finish_reasons}

    def _release_dicts(self) -> tuple:
        """The retained dicts themselves (``results`` and
        ``finish_reasons`` above are merged copies: popping those would
        keep every result alive)."""
        return (self.prefill.results, self.prefill.finish_reasons,
                self.decode.results, self.decode.finish_reasons)

    def release_prefixes(self) -> None:
        self.prefill.release_prefixes()
        self.decode.release_prefixes()

    @property
    def stats(self):
        """Both replicas' ``SchedulerStats`` merged: counters sum, peaks
        take the max, dicts merge with the prefill side's entries winning
        (TTFT is a prefill-side quantity)."""
        merged = {}
        for f in dataclasses.fields(self.prefill.stats):
            a = getattr(self.prefill.stats, f.name)
            b = getattr(self.decode.stats, f.name)
            if isinstance(a, dict):
                merged[f.name] = {**b, **a}
            elif f.name.startswith("peak_"):
                merged[f.name] = max(a, b)
            else:
                merged[f.name] = a + b
        return type(self.prefill.stats)(**merged)
