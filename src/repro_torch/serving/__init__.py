"""Serving stack of the port: Engine, the paged pool and its scheduler,
LLMServer with its paged, fused and split backends, the disaggregated
deployment (``page_transport``), the async front end (``async_engine``)
and its HTTP/SSE service (``http``), and the telemetry (``telemetry``)
that all of them record into.

Importing this package loads only the telemetry (pure Python): the
disaggregated deployment's names below load their module at first use, the
rest is imported from its modules, and no kernel is built before a first
call."""

from repro_torch.serving.telemetry import (Histogram,  # noqa: F401
                                           MetricsRegistry, Span, TickRecord,
                                           Tracer)

_PAGE_TRANSPORT = ("DecodeWorker", "DisaggregatedScheduler",
                   "PageStreamTransport", "PrefillWorker")


def __getattr__(name):
    if name in _PAGE_TRANSPORT:
        from repro_torch.serving import page_transport
        return getattr(page_transport, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
