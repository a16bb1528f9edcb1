"""Movers of paged-KV bytes between memory domains (port of
``repro/serving/page_transport.py``: the host-swap and TAB-Q uplink
movers).

:class:`PageTransport` keeps the accounting every mover shares: the bytes
moved, the transfers and the host seconds they took. The VALUES moved are
never touched, so the bit-identity of the mechanism underneath survives.
:class:`HostSwapTransport` is the scheduler's preempt/resume mover: device
pages → host snapshot → device pages on one pool
(``kv_pool.PagedKVPool.export_slot`` / ``restore_slot``).
:class:`TabqUplinkTransport` is the split engine's edge→cloud mover.

With ``telemetry=`` (a ``serving.telemetry.Tracer``) every transfer also
lands as one span (``t0``/``t1``/``bytes``/``rid``; swaps on the slot's
track, as ``"swap_out"`` and ``"swap_resume"``), a bytes histogram and
running totals under ``transport.<kind>.*``; the uplink adds the
``"uplink"`` event on the ``"split:uplink"`` track.

Not ported yet: the page-stream mover and the disaggregated scheduler
(ROADMAP queue 1, item 7, the disaggregated deployment).
"""

from __future__ import annotations

import time

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
