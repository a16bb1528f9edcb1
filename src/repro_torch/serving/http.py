"""Stdlib-only HTTP/SSE service over :class:`AsyncLLMServer` (port of
``repro/serving/http.py``).

One asyncio-streams server (no frameworks — the repo's zero-dependency
telemetry precedent extends to networking), four endpoints:

================  ======  =====================================================
``/v1/completions``  POST  ``{"prompt": [ids], "max_tokens": 16, "stream":
                           true, ...}`` — any :class:`SamplingParams` field.
                           ``stream=true`` answers ``text/event-stream``: one
                           ``data: {json}`` frame per token (rid / index /
                           token / logprob), a final frame with
                           ``finish_reason``, then ``data: [DONE]``.
                           ``stream=false`` answers one JSON body with the
                           full token list, logprobs, finish reason, and the
                           request's measured ``ttft_s`` / ``e2e_s``.
``/v1/abort``        POST  ``{"rid": N}`` → ``{"aborted": bool}``.
``/v1/metrics``      GET   the flat ``LLMServer.metrics()`` SLO dict.
``/healthz``         GET   liveness + queue depth (503 once shut down).
================  ======  =====================================================

Error mapping: full admission queue → **429** with ``Retry-After``;
engine shut down → **503**; malformed request → **400**; unknown route →
**404**. Streaming responses send ``Connection: close`` and terminate by
EOF, so no chunked-encoding framing is needed; a client that disconnects
mid-stream is detected by EOF on its socket and the request is aborted —
its pool pages free on the next tick.

Run a demo server (tiny randomly initialized model — the serving plumbing
is real, the weights are not)::

    PYTHONPATH=src python -m repro_torch.serving.http --device cpu \
        --port 8035 --max-slots 4
    curl -N localhost:8035/v1/completions -d \
        '{"prompt": [1,2,3], "max_tokens": 8, "stream": true}'

``--device`` defaults to ``cuda`` and raises without a card, as every
entry point of the port does; on a card the demo builds and loads the
kernels the fused and paged backends launch (K1 to K4) before it binds
its port, so that no client's first token waits on a compiler.
``--backend``/``--deployment`` thread straight through to
:class:`~repro_torch.serving.api.LLMServer`: ``--deployment
disaggregated`` serves through a prefill replica and a decode replica on
the one device, joined by the page stream
(``page_transport.DisaggregatedScheduler``). ``--deployment sharded``
raises ``NotImplementedError``: one HTTP front over the ranks of the
sharded deployment, each of which must be handed every request, is not
ported yet (ROADMAP queue 1, item 8, the sharded deployment's fronts).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json

from repro_torch.core.sampling import SamplingParams
from repro_torch.serving.async_engine import (AdmissionError, AsyncLLMServer,
                                              EngineClosedError)

# SamplingParams fields settable straight from request JSON (prefix_key
# must be hashable — a JSON string/int is; lists are rejected by coercion)
_SAMPLING_FIELDS = ("max_tokens", "temperature", "top_k", "top_p", "seed",
                    "stop_token_ids", "eos_id", "priority", "prefix_key",
                    "prefix_len", "latency_hint", "speculate_k")

SSE_DONE = b"data: [DONE]\n\n"


def sse_frame(obj: dict) -> bytes:
    """One Server-Sent-Events frame: ``data: {json}\\n\\n``."""
    return b"data: " + json.dumps(obj).encode() + b"\n\n"


class SSEParser:
    """Incremental SSE decoder — feed raw socket bytes, get back the
    ``data:`` payloads (parsed JSON dicts; the ``[DONE]`` terminator comes
    back as the string ``"[DONE]"``). The inverse of :func:`sse_frame`,
    used by the load generator and the round-trip tests."""

    def __init__(self):
        self._buf = b""

    def feed(self, chunk: bytes) -> list:
        self._buf += chunk
        out = []
        while b"\n\n" in self._buf:
            frame, self._buf = self._buf.split(b"\n\n", 1)
            for line in frame.splitlines():
                if not line.startswith(b"data:"):
                    continue  # comments / other SSE fields
                payload = line[5:].strip()
                out.append("[DONE]" if payload == b"[DONE]"
                           else json.loads(payload))
        return out


def _event_json(ev) -> dict:
    d = {"rid": ev.rid, "index": ev.index, "token": ev.token}
    if ev.logprob is not None:
        d["logprob"] = ev.logprob
    if ev.finished:
        d["finished"] = True
        d["finish_reason"] = ev.finish_reason
    return d


def _parse_sampling(body: dict) -> SamplingParams:
    kw = {}
    for f in _SAMPLING_FIELDS:
        if body.get(f) is not None:
            kw[f] = body[f]
    if "stop_token_ids" in kw:
        kw["stop_token_ids"] = tuple(kw["stop_token_ids"])
    return SamplingParams(**kw)


class ServingHTTPServer:
    """The service layer: routes HTTP requests onto one
    :class:`AsyncLLMServer`. ``port=0`` binds an ephemeral port (read
    ``self.port`` after :meth:`start` — how the tests and the load-smoke
    CI job avoid port collisions)."""

    def __init__(self, engine: AsyncLLMServer, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self.host = host
        self.port = port
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    async def stop(self, *, shutdown_engine: bool = True,
                   drain: bool = True) -> None:
        """Stop accepting connections; optionally shut the engine down
        too (drain-then-stop by default)."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if shutdown_engine:
            await self.engine.shutdown(drain=drain)

    # ---------------------------------------------------------- plumbing

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, body = req
            if path == "/healthz" and method == "GET":
                code = 503 if self.engine.closed else 200
                await self._json(writer, code, {
                    "status": "closed" if self.engine.closed else "ok",
                    "queue_depth": self.engine.queue_depth})
            elif path == "/v1/metrics" and method == "GET":
                await self._json(writer, 200, await self.engine.metrics())
            elif path == "/v1/abort" and method == "POST":
                ok = await self.engine.abort(int(body["rid"]))
                await self._json(writer, 200, {"aborted": ok})
            elif path == "/v1/completions" and method == "POST":
                await self._completions(reader, writer, body)
            else:
                await self._json(writer, 404,
                                 {"error": f"no route {method} {path}"})
        except (ValueError, KeyError, TypeError) as e:
            try:
                await self._json(writer, 400, {"error": str(e)})
            except (ConnectionError, RuntimeError):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away mid-exchange
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            raise ValueError(f"malformed request line {line!r}")
        method, path = parts[0], parts[1]
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", 0))
        body = json.loads(await reader.readexactly(n)) if n else {}
        return method, path, body

    async def _completions(self, reader, writer, body: dict) -> None:
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise ValueError("'prompt' must be a non-empty token-id list")
        sp = _parse_sampling(body)
        try:
            rid = await self.engine.submit(prompt, sp)
        except AdmissionError as e:
            await self._json(writer, 429, {"error": str(e)},
                             extra_headers=(("Retry-After", "1"),))
            return
        except EngineClosedError as e:
            await self._json(writer, 503, {"error": str(e)})
            return
        if body.get("stream"):
            await self._stream_sse(reader, writer, rid)
        else:
            events = [ev async for ev in self.engine.stream(rid)]
            out = await self.engine.result(rid)
            await self._json(writer, 200, {
                "rid": rid,
                "tokens": [int(t) for t in out.tokens],
                "logprobs": [ev.logprob for ev in events
                             if not ev.finished],
                "finish_reason": out.finish_reason,
                "metrics": {"ttft_s": out.metrics.ttft_s,
                            "e2e_s": out.metrics.e2e_s},
            })

    async def _stream_sse(self, reader, writer, rid: int) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        agen = self.engine.stream(rid)
        # the client sends nothing after its request body, so a completed
        # read = EOF = disconnect; racing it against the token stream is
        # what turns a vanished client into abort(rid)
        eof = asyncio.ensure_future(reader.read(1))
        try:
            while True:
                nxt = asyncio.ensure_future(agen.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, eof}, return_when=asyncio.FIRST_COMPLETED)
                if nxt not in done:  # EOF won: client disconnected
                    nxt.cancel()
                    await asyncio.gather(nxt, return_exceptions=True)
                    return
                try:
                    ev = nxt.result()
                except StopAsyncIteration:
                    return
                writer.write(sse_frame(_event_json(ev)))
                await writer.drain()
                if ev.finished:
                    writer.write(SSE_DONE)
                    await writer.drain()
                    return
        finally:
            eof.cancel()
            await asyncio.gather(eof, return_exceptions=True)
            # closing the generator aborts rid if it has not finished
            await agen.aclose()

    async def _json(self, writer, code: int, obj: dict,
                    extra_headers=()) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests",
                  503: "Service Unavailable"}.get(code, "")
        payload = json.dumps(obj).encode()
        head = [f"HTTP/1.1 {code} {reason}",
                "Content-Type: application/json",
                f"Content-Length: {len(payload)}", "Connection: close"]
        head += [f"{k}: {v}" for k, v in extra_headers]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
        await writer.drain()


# ------------------------------------------------------------------ CLI


# the kernels the fused and paged backends launch: K1 to K4
SERVING_KERNELS = ("decode_attention", "paged_decode_attention",
                   "paged_prefill_attention", "varlen_attention")


def build_serving_kernels(device) -> None:
    """Build and load :data:`SERVING_KERNELS` on a CUDA ``device`` before
    a service takes traffic (kernels otherwise build at first use, with
    ``nvcc``, inside some client's request); nothing on the CPU."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import build

    build.build(*SERVING_KERNELS)
    for name in SERVING_KERNELS:
        build.load(name)


def _build_server(args):
    """A demo LLMServer on a tiny randomly initialized model on
    ``args.device`` — boots in seconds on the CPU; the serving layer under
    test is real."""
    if args.deployment == "sharded":
        raise NotImplementedError(
            "--deployment sharded: one HTTP front over the ranks of the "
            "sharded deployment is not ported yet (ROADMAP queue 1, item 8, "
            "the sharded deployment's fronts); LLMServer(deployment="
            "'sharded') serves one rank in process")
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import RuntimeOpts
    from repro_torch.params import init_params
    from repro_torch.serving.api import LLMServer

    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config(args.config).tiny(),
                              vocab_size=args.vocab)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device=device)
    opts = RuntimeOpts(q_chunk=16, kv_chunk=16, quantized_kv=True,
                       moe_capacity_factor=0.0)
    kwargs: dict = {"device": device}
    if args.backend == "paged":
        kwargs.update(deployment=args.deployment, num_pages=args.num_pages,
                      page_size=4, max_slots=args.max_slots,
                      auto_prefix=args.auto_prefix)
    return LLMServer(cfg, params, opts, backend=args.backend, **kwargs)


async def _amain(args) -> None:
    server = _build_server(args)
    build_serving_kernels(server.backend.device)
    engine = AsyncLLMServer(server, max_queue_depth=args.max_queue_depth)
    http = ServingHTTPServer(engine, args.host, args.port)
    await http.start()
    print(f"serving on http://{http.host}:{http.port}  "
          f"(backend={args.backend}, deployment={args.deployment})",
          flush=True)
    try:
        await http.serve_forever()
    except asyncio.CancelledError:
        pass
    finally:
        await http.stop()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8035)
    p.add_argument("--backend", default="paged",
                   choices=("paged", "fused"))
    p.add_argument("--deployment", default="fused",
                   choices=("fused", "sharded", "disaggregated"))
    p.add_argument("--config", default="llama2-7b")
    p.add_argument("--vocab", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-pages", type=int, default=64)
    p.add_argument("--max-slots", type=int, default=4)
    p.add_argument("--max-queue-depth", type=int, default=64)
    p.add_argument("--auto-prefix", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; without a card it "
                        "raises)")
    args = p.parse_args(argv)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
