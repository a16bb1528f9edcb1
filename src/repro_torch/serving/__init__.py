"""Serving stack of the port: Engine, the paged pool and its scheduler,
LLMServer with its paged, fused and split backends, the async front end
(``async_engine``) and its HTTP/SSE service (``http``), and the telemetry
(``telemetry``) that all of them record into.

Importing this package loads only the telemetry (pure Python): the rest is
imported from its modules, and no kernel is built before a first call."""

from repro_torch.serving.telemetry import (Histogram,  # noqa: F401
                                           MetricsRegistry, Span, TickRecord,
                                           Tracer)
