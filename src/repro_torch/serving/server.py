"""AsyncCacheServer — the serving front-end that owns engine + scheduler
(PyTorch port of ``repro.serving.server``: the same host-side asyncio
code in front of the port's ``CachedEngine``).

Composes one ``CachedEngine`` with one ``AsyncScheduler`` (DESIGN.md §12)
behind two entry points:

  * **in-process**: ``await server.submit(...)`` / ``submit_request(...)``
    — what the load generators, benchmarks and tests drive;
  * **TCP (stdlib only)**: newline-delimited JSON over asyncio streams
    (``serve_tcp``) — one request object per line in, one response object
    per line out, pipelined: every line is scheduled as its own task, so a
    client that writes N lines before reading gets the same micro-batching
    and coalescing as N separate clients.

The wire format keeps to the engine's ``Request``/``Response`` fields::

    > {"id": 7, "query": "how do i sort a list in python",
       "category": "python_basics", "tenant": "acme"}
    < {"id": 7, "answer": ..., "cached": true, "score": 0.93,
       "latency_s": 0.004, "coalesced": false}

``tenant`` (optional, default "default") selects the isolation domain on a
multi-tenant engine (DESIGN.md §13): lookups/inserts stay inside that
tenant's slab region and coalescing never crosses tenants.

``session`` (optional) names a conversation on a session-enabled engine
(DESIGN.md §16): the request's lookup key is fused with the session's
prior-turn window, and the response line gains a ``context`` flag (true
when a non-empty window was fused in). A request line *without* the field
is today's stateless behaviour byte-for-byte — same Request defaults, same
response payload keys.

On a near-hit-enabled engine (a ``Synthesizer`` was attached, DESIGN.md
§17) every response line additionally carries ``near_hit`` (true when the
answer was synthesized from the band's top-k neighbours rather than served
verbatim or generated). Band-less engines emit exactly the pre-band
payload, byte for byte.

Responses may arrive out of request order (coalesced waiters resolve with
their leader's batch), so pipelined clients should send an ``id`` — it is
echoed verbatim in the matching response line.

Observability (DESIGN.md §18) rides the same additive discipline: a
request line with ``"explain": true`` gets ``why`` (decision attribution)
and ``trace_id`` on its response line; lines without the key get the
pre-observability payload byte for byte. ``GET /metrics`` — on the main
TCP port (sniffed off the first line) or on the dedicated
``serve_metrics`` HTTP listener — returns the Prometheus-style text
exposition; ``GET /traces`` and ``GET /events`` drain the retained
traces / the structured event ring as JSON lines.

Resilient serving (DESIGN.md §20) rides the same additive discipline:
``deadline_ms`` on a request line carries the caller's latency budget onto
``Request.deadline_ms`` (queue wait + retries never exceed it); on an
engine with a resilience config every response line gains ``degraded``
(true when the answer came from a cached neighbour because the backend
was unavailable); a shed rejection (``overload_policy="shed"``) answers
``{"error": ..., "overloaded": true}`` and a per-row backend failure
answers ``{"error": ...}`` for exactly the rows that needed the backend.

No third-party serving stack (HTTP frameworks, gRPC) is used — the repo's
offline constraint — but the seam is exactly where one would bolt on.
"""
from __future__ import annotations

import asyncio
import json

from repro_torch.obs.export import MetricsExporter
from repro_torch.serving.engine import CachedEngine, Request, Response
from repro_torch.serving.resilience import Overloaded
from repro_torch.serving.scheduler import AsyncScheduler, SchedulerConfig


class AsyncCacheServer:
    """Own the serving stack's lifecycle: start/stop, submit, TCP accept."""

    def __init__(self, engine: CachedEngine,
                 scheduler_config: SchedulerConfig | None = None):
        # one compiled shape end to end: the engine pads every admission
        # batch to its fixed batch size, so align it with the flush size
        cfg = scheduler_config or SchedulerConfig(
            max_batch=engine.batcher.batch_size)
        self.engine = engine
        self.scheduler = AsyncScheduler(engine, cfg)
        self.exporter = MetricsExporter(engine)
        self._tcp: asyncio.AbstractServer | None = None
        self._metrics_srv: asyncio.AbstractServer | None = None

    # -- lifecycle ------------------------------------------------------- #
    async def start(self) -> None:
        await self.scheduler.start()

    async def stop(self) -> None:
        if self._tcp is not None:
            self._tcp.close()
            await self._tcp.wait_closed()
            self._tcp = None
        if self._metrics_srv is not None:
            self._metrics_srv.close()
            await self._metrics_srv.wait_closed()
            self._metrics_srv = None
        await self.scheduler.stop()

    async def __aenter__(self) -> "AsyncCacheServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- in-process API --------------------------------------------------- #
    async def submit(self, query: str, *, category: str = "default",
                     source_id: int = -1, semantic_key: str = "",
                     tenant: str = "default", session: str = "",
                     explain: bool = False,
                     deadline_ms: float | None = None) -> Response:
        return await self.scheduler.submit(Request(
            query=query, category=category, source_id=source_id,
            semantic_key=semantic_key, tenant=tenant, session=session,
            explain=explain, deadline_ms=deadline_ms))

    async def submit_request(self, request: Request) -> Response:
        return await self.scheduler.submit(request)

    # -- TCP front-end ----------------------------------------------------- #
    async def serve_tcp(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Accept JSON-lines clients; returns the bound port (0 = ephemeral)."""
        self._tcp = await asyncio.start_server(self._handle, host, port)
        return self._tcp.sockets[0].getsockname()[1]

    # -- observability HTTP (stdlib-only, §18.4) ------------------------- #
    async def serve_metrics(self, host: str = "127.0.0.1",
                            port: int = 0) -> int:
        """Dedicated HTTP listener for ``/metrics`` / ``/traces`` /
        ``/events`` (``repro_torch.launch.serve --metrics-port``). Returns the
        bound port (0 = ephemeral)."""
        async def handle(reader, writer):
            line = await reader.readline()
            if line:
                await self._serve_http(line, reader, writer)
            else:
                writer.close()
        self._metrics_srv = await asyncio.start_server(handle, host, port)
        return self._metrics_srv.sockets[0].getsockname()[1]

    def _http_body(self, path: str) -> tuple[str | None, str]:
        if path.rstrip("/") == "/metrics" or path == "/":
            return self.exporter.render(), "text/plain; version=0.0.4"
        if path.rstrip("/") == "/traces":
            lines = [json.dumps(t, sort_keys=True)
                     for t in self.engine.tracer.drain()]
            return ("\n".join(lines) + ("\n" if lines else ""),
                    "application/x-ndjson")
        if path.rstrip("/") == "/events":
            if self.engine.events is None:
                return "", "application/x-ndjson"
            return self.engine.events.to_jsonl(), "application/x-ndjson"
        return None, ""

    async def _serve_http(self, request_line: bytes,
                          reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """Answer one HTTP/1.x GET and close — enough for any Prometheus-
        compatible scraper, with no HTTP framework (the offline constraint)."""
        try:
            parts = request_line.decode("latin-1").split()
            path = parts[1] if len(parts) > 1 else "/"
            while True:                       # drain request headers
                h = await reader.readline()
                if not h or h in (b"\r\n", b"\n"):
                    break
            body, ctype = self._http_body(path)
            status = "200 OK"
            if body is None:
                status, body, ctype = "404 Not Found", "not found\n", \
                    "text/plain"
            data = body.encode()
            writer.write(
                (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                 f"Content-Length: {len(data)}\r\n"
                 "Connection: close\r\n\r\n").encode() + data)
            await writer.drain()
        except (ConnectionError, OSError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        lock = asyncio.Lock()          # serialize writes, not serves

        async def one(line: bytes) -> None:
            req_id = None
            try:
                obj = json.loads(line)
                req_id = obj.get("id")
                resp = await self.submit(
                    obj["query"],
                    category=obj.get("category", "default"),
                    source_id=int(obj.get("source_id", -1)),
                    semantic_key=obj.get("semantic_key", ""),
                    tenant=obj.get("tenant", "default"),
                    session=obj.get("session", ""),
                    explain=bool(obj.get("explain", False)),
                    deadline_ms=None if obj.get("deadline_ms") is None
                    else float(obj["deadline_ms"]))
                payload = {"answer": resp.answer, "cached": resp.cached,
                           "score": resp.score, "latency_s": resp.latency_s,
                           "coalesced": resp.coalesced}
                if self.engine.resilience is not None:
                    # additive, gated on the resilience layer actually
                    # running — pre-§20 deployments keep the exact payload
                    payload["degraded"] = resp.degraded
                if "session" in obj:
                    # the context flag only exists for clients that opted
                    # into sessions — a sessionless request line gets
                    # exactly the pre-session payload, byte for byte
                    payload["context"] = resp.context
                if self.engine.synthesizer is not None:
                    # additive, gated on the server actually serving
                    # near-hits — band-less deployments keep the exact
                    # pre-band payload keys (§17.5)
                    payload["near_hit"] = resp.near_hit
                if obj.get("explain"):
                    # attribution is per-request opt-in (§18.3): only the
                    # lines that asked carry the extra keys, so non-opt-in
                    # clients keep the previous payload byte for byte
                    payload["why"] = resp.why
                    payload["trace_id"] = resp.trace_id
            except Overloaded as exc:  # shed (§20.5): explicit, retryable
                payload = {"error": str(exc), "overloaded": True}
            except Exception as exc:   # malformed line / scheduler stopped
                                       # / per-row BackendError (§20.2)
                payload = {"error": str(exc)}
            if req_id is not None:     # echo: responses can be out of order
                payload["id"] = req_id
            async with lock:
                writer.write(json.dumps(payload).encode() + b"\n")
                await writer.drain()

        # completed tasks discard themselves: a long-lived pipelined
        # connection must not accumulate one task object per line served
        tasks: set[asyncio.Task] = set()
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                if line.startswith(b"GET ") or line.startswith(b"HEAD "):
                    # /metrics scrape on the main port: an HTTP request
                    # line is never valid JSON, so the sniff is unambiguous
                    await self._serve_http(line, reader, writer)
                    return
                if line.strip():
                    t = asyncio.create_task(one(line))
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
        finally:
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
