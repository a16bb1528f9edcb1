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

Not ported yet: the page-stream mover and the disaggregated scheduler
(ROADMAP queue 1, item 7, the disaggregated deployment), and the telemetry
spans and events the reference records per transfer (item 5, telemetry).
"""

from __future__ import annotations

import time

from repro_torch.serving.kv_pool import PagedKVPool


class PageTransport:
    """Base mover: bytes, transfers and host seconds for one transport
    kind. Subclasses set ``kind`` and call :meth:`_record` once per
    transfer."""

    kind = "transport"

    def __init__(self):
        self.bytes_moved = 0  # total payload BYTES across transfers
        self.transfers = 0
        self.seconds = 0.0  # host seconds spent in transfers

    def _record(self, t0: float, nbytes: int) -> None:
        """Account one transfer that started at host time ``t0``."""
        self.bytes_moved += int(nbytes)
        self.transfers += 1
        self.seconds += time.perf_counter() - t0


class HostSwapTransport(PageTransport):
    """The preempt/resume mover: device pages ⇄ host snapshot on ONE pool.
    A swap-out copies to the host and so waits for the device."""

    kind = "host_swap"

    def swap_out(self, pool: PagedKVPool, slot: int, n_tokens: int) -> dict:
        t0 = time.perf_counter()
        snapshot = pool.export_slot(slot, n_tokens=n_tokens)
        self._record(t0, pool.snapshot_bytes(snapshot))
        return snapshot

    def swap_in(self, pool: PagedKVPool, snapshot: dict,
                reserve_tokens: int | None = None) -> int:
        nbytes = pool.snapshot_bytes(snapshot)
        t0 = time.perf_counter()
        slot = pool.restore_slot(snapshot, reserve_tokens=reserve_tokens)
        self._record(t0, nbytes)
        return slot


class TabqUplinkTransport(PageTransport):
    """The split engine's edge→cloud mover of TS+TAB-Q activation payloads.
    The engine computes each payload (compression is model code); this
    class keeps the wire accounting, the payload's bits rounded up to whole
    bytes, one transfer a payload."""

    kind = "tabq_uplink"

    def uplink(self, bits: float) -> None:
        self._record(time.perf_counter(), -(-int(bits) // 8))
