"""Asyncio front end for :class:`~.gateway.ServingGateway`.

Counterpart of ``accelerate_tpu/serving/gateway_aio.py``, unchanged in
behaviour: the engine side of the PyTorch fleet is the same threads.

One OS thread, one event loop, thousands of concurrent SSE streams.
``ThreadingHTTPServer`` parks a whole thread (stack + scheduler slot)
on every open connection, which caps a gateway process at hundreds of
streams; here every connection is a coroutine and an open-but-idle SSE
stream costs a few KB of heap, so the same process multiplexes
thousands. The engine-facing side stays exactly as it was — threads:

* tokens cross from the engines' emitter threads onto the loop via
  ``loop.call_soon_threadsafe`` into a bounded per-stream
  :class:`asyncio.Queue` (:class:`_StreamBridge`; overflow spills to an
  ordered side deque touched only on the loop thread, so no token is
  ever dropped or reordered — the engine's own bounded
  ``emission_queue`` is the upstream flow control);
* request completion rides :meth:`~.router.FleetRequest
  .add_done_callback`, so no coroutine ever blocks the loop in
  ``FleetRequest.wait``. ``call_soon_threadsafe`` is FIFO per loop, and
  the engine emits every token before it finishes the request, so the
  done sentinel always lands *after* the last token.

The HTTP surface is deliberately identical to the threading front end
— same routes, same status-code mapping, same drain semantics — which
is enforced by sharing the admission path (``ServingGateway
.submit_or_error``) and the body parser / response shapers
(``parse_completion`` / ``summary_payload`` / ``completion_result``)
rather than by duplicated code. The server object duck-types the
``ThreadingHTTPServer`` surface the gateway lifecycle drives
(``server_address``, ``shutdown()``, ``server_close()``) plus a
``thread`` attribute.

Stdlib-only on purpose (``asyncio`` + streams): the repo takes no HTTP
framework dependency, and a minimal HTTP/1.1 parser (request line,
headers, ``Content-Length`` framing, keep-alive) is all the gateway
protocol needs.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import threading
from collections import deque
from http.client import responses as _HTTP_REASONS
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..observability import clean_trace_id, new_trace_id
from .gateway import (_STATUS_HTTP, _BadRequest, completion_result,
                      parse_completion, summary_payload)
from .request import RequestStatus

__all__ = ["AsyncioGatewayServer"]


class _StreamBridge:
    """Engine-thread → event-loop token conduit for one SSE stream.

    ``push_threadsafe`` is the ``on_token`` callback (runs on an engine
    emitter thread — must never block, or it head-of-line-blocks every
    stream that emitter serves); it hops onto the loop where ``_push``
    enqueues into a bounded :class:`asyncio.Queue`, spilling to an
    ordered deque when a slow client has let the queue fill. Queue and
    deque are touched only on the loop thread, so there is no lock and
    no race. ``finish_threadsafe`` rides the same FIFO, so the DONE
    sentinel is always delivered after every token that preceded it.
    """

    DONE = object()

    def __init__(self, loop: asyncio.AbstractEventLoop, maxsize: int):
        self._loop = loop
        self._q: asyncio.Queue = asyncio.Queue(maxsize)
        self._overflow: deque = deque()  # loop-thread only

    # -- engine side ------------------------------------------------------
    def push_threadsafe(self, tok):
        try:
            self._loop.call_soon_threadsafe(self._push, int(tok))
        except RuntimeError:
            pass  # loop closed mid-shutdown; the stream is dead anyway

    def finish_threadsafe(self, _fleet=None):
        try:
            self._loop.call_soon_threadsafe(self._push, self.DONE)
        except RuntimeError:
            pass

    # -- loop side --------------------------------------------------------
    def _push(self, item):
        if self._overflow or self._q.full():
            self._overflow.append(item)  # strict arrival order
        else:
            self._q.put_nowait(item)

    async def get(self):
        item = await self._q.get()
        while self._overflow and not self._q.full():
            self._q.put_nowait(self._overflow.popleft())
        return item


class AsyncioGatewayServer:
    """Event-loop HTTP front end behind ``ServingGateway``.

    Constructed by ``ServingGateway.start()`` when
    ``config.server == "asyncio"``; binds synchronously (the
    constructor returns with ``server_address`` resolved, or raises the
    bind error) and serves from a daemon thread running the loop.
    """

    def __init__(self, gateway):
        self.gateway = gateway
        self._loop = asyncio.new_event_loop()
        self._aio_server: Optional[asyncio.AbstractServer] = None
        self.server_address: Optional[tuple] = None
        self._started = threading.Event()
        self._startup_error: Optional[BaseException] = None
        self.thread = threading.Thread(
            target=self._run, name="serving-gateway-aio", daemon=True)
        self.thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("asyncio gateway did not bind within 30s")
        if self._startup_error is not None:
            raise self._startup_error

    # -- lifecycle (ThreadingHTTPServer duck-type) ------------------------
    def _run(self):
        asyncio.set_event_loop(self._loop)
        try:
            try:
                self._aio_server = self._loop.run_until_complete(
                    asyncio.start_server(
                        self._handle_conn, self.gateway.config.host,
                        self.gateway.config.port, backlog=2048))
                self.server_address = (
                    self._aio_server.sockets[0].getsockname()[:2])
            except BaseException as e:  # bind errors surface in __init__
                self._startup_error = e
                return
            finally:
                self._started.set()
            self._loop.run_forever()
            # shutdown() stopped the loop: reap every open connection.
            pending = asyncio.all_tasks(self._loop)
            for t in pending:
                t.cancel()
            if pending:
                self._loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            self._loop.run_until_complete(self._loop.shutdown_asyncgens())
        finally:
            self._loop.close()

    def shutdown(self):
        """Stop the listener, cancel open exchanges, join the loop
        thread. Idempotent; callable from any thread (the gateway's
        drain already waited for in-flight exchanges when graceful)."""
        if not self.thread.is_alive():
            return

        def _stop():
            if self._aio_server is not None:
                self._aio_server.close()
            self._loop.stop()

        with contextlib.suppress(RuntimeError):
            self._loop.call_soon_threadsafe(_stop)
        self.thread.join(timeout=10)

    def server_close(self):
        self.shutdown()

    # -- connection handling ----------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        try:
            while True:
                req = await self._read_head(reader)
                if req is None:
                    break
                close = await self._dispatch(req, reader, writer)
                await writer.drain()
                if close:
                    break
        except (ConnectionError, TimeoutError, asyncio.IncompleteReadError):
            pass  # client went away mid-exchange
        finally:
            with contextlib.suppress(Exception):
                writer.close()

    async def _read_head(self, reader):
        """Parse one request head: ``(method, target, version, headers)``
        with header names lowercased, or None on EOF / malformed head
        (the connection just closes — matching ``http.server``, which
        clients see as a dropped keep-alive, not an error page)."""
        try:
            line = await reader.readline()
        except (ValueError, ConnectionError):
            return None  # over-long request line
        if not line or line in (b"\r\n", b"\n"):
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, target = parts[0], parts[1]
        version = parts[2] if len(parts) > 2 else "HTTP/1.0"
        headers = {}
        while True:
            try:
                h = await reader.readline()
            except (ValueError, ConnectionError):
                return None
            if h in (b"\r\n", b"\n", b""):
                break
            name, sep, value = h.decode("latin-1").partition(":")
            if sep:
                headers[name.strip().lower()] = value.strip()
        return method, target, version, headers

    async def _dispatch(self, req, reader, writer) -> bool:
        """Route one request; returns True when the connection must
        close (SSE, framing errors, explicit ``Connection: close``)."""
        method, target, version, headers = req
        conn_hdr = headers.get("connection", "").lower()
        close = (conn_hdr == "close"
                 or (version == "HTTP/1.0" and conn_hdr != "keep-alive"))
        gw = self.gateway
        parsed = urlparse(target)
        path = parsed.path
        if method == "GET":
            if not self._conn_enter(writer, path):
                return True
            try:
                if path == "/healthz":
                    self._send_text(writer, 200, "ok\n", "/healthz")
                elif path == "/readyz":
                    if gw.ready:
                        self._send_text(writer, 200, "ready\n", "/readyz")
                    else:
                        if gw.draining:
                            body = "draining\n"
                        else:
                            fm = gw.replica_set.fleet_metrics()
                            looped = int(fm.get("replicas_crash_loop", 0))
                            body = ("no healthy replica"
                                    + (f" ({looped} crash-looped)" if looped
                                       else "") + "\n")
                        self._send_text(writer, 503, body, "/readyz",
                                        extra_headers=self._retry_after())
                elif path == "/metrics":
                    self._send_text(
                        writer, 200, gw.metrics_text(), "/metrics",
                        content_type="text/plain; version=0.0.4; "
                                     "charset=utf-8")
                elif path == "/debug/trace":
                    self._debug_trace(writer, parse_qs(parsed.query))
                else:
                    self._send_json(writer, 404, {"error": "not found"},
                                    path)
            finally:
                self._conn_exit()
            return close
        if method == "POST":
            if path != "/v1/completions":
                self._send_json(writer, 404, {"error": "not found"}, path)
                return close
            return await self._completions(reader, writer, headers, close)
        self._send_json(writer, 501,
                        {"error": f"unsupported method {method}"}, path)
        return True

    def _debug_trace(self, writer, query: dict):
        route = "/debug/trace"
        raw = (query.get("id") or [None])[0]
        tid = None
        if raw is not None:
            tid = clean_trace_id(raw)
            if tid is None:
                self._send_json(writer, 400, {"error": "invalid trace id"},
                                route)
                return
        trace = self.gateway.replica_set.chrome_trace(tid)
        if tid is not None and not any(
                ev.get("ph") != "M" for ev in trace["traceEvents"]):
            self._send_json(writer, 404, {"error": "trace not found",
                                          "trace_id": tid}, route)
            return
        self._send_text(writer, 200, json.dumps(trace), route,
                        content_type="application/json")

    # -- completions -------------------------------------------------------
    async def _completions(self, reader, writer, headers,
                           close: bool) -> bool:
        gw = self.gateway
        route = "/v1/completions"
        if not self._conn_enter(writer, route):
            return True
        # Minted before anything can fail so even a 4xx/5xx body carries
        # a correlation id (the client's own X-Request-Id when valid).
        trace_id = (clean_trace_id(headers.get("x-request-id"))
                    or new_trace_id())
        try:
            if gw.draining:
                self._send_json(writer, 503, {"error": "gateway draining"},
                                route, extra_headers=self._retry_after(),
                                trace_id=trace_id)
                return close
            try:
                length = int(headers.get("content-length", ""))
            except ValueError:
                # No framing: the body (if any) is unreadable -> close.
                self._send_json(writer, 400,
                                {"error": "Content-Length required"},
                                route, trace_id=trace_id)
                return True
            if length > gw.config.max_body_bytes:
                # Refused BEFORE reading the body into memory; the bytes
                # are still on the socket, so the connection closes.
                self._send_json(
                    writer, 413,
                    {"error": f"request body {length} bytes exceeds "
                              f"max_body_bytes ({gw.config.max_body_bytes})"},
                    route, trace_id=trace_id)
                return True
            raw = await reader.readexactly(length)
            try:
                body = json.loads(raw)
                if not isinstance(body, dict):
                    raise _BadRequest("request body must be a JSON object")
                spec = parse_completion(body, gw.config)
            except json.JSONDecodeError as e:
                self._send_json(writer, 400,
                                {"error": f"invalid JSON: {e}"},
                                route, trace_id=trace_id)
                return close
            except _BadRequest as e:
                self._send_json(writer, 400, {"error": str(e)}, route,
                                trace_id=trace_id)
                return close
            stream = spec.pop("stream")
            if stream:
                await self._stream_sse(reader, writer, spec, trace_id,
                                       length)
                return True  # SSE is EOF-terminated
            fleet, err = gw.submit_or_error(spec, trace_id)
            if err is not None:
                code, payload, hdrs = err
                self._send_json(writer, code, payload, route,
                                extra_headers=hdrs, body_bytes_in=length,
                                trace_id=trace_id)
                return close
            done_ev = asyncio.Event()
            fleet.add_done_callback(
                lambda _f: self._call_soon(done_ev.set))
            await done_ev.wait()  # deadline enforced engine-side (408)
            code, payload, hdrs = completion_result(
                fleet, gw.config.retry_after_s)
            self._send_json(writer, code, payload, route,
                            extra_headers=hdrs, body_bytes_in=length,
                            trace_id=trace_id)
            return close
        finally:
            self._conn_exit()

    async def _stream_sse(self, reader, writer, spec: dict, trace_id: str,
                          nbytes: int):
        """One SSE event per token, a final summary event, EOF. A broken
        client socket (detected by the parked ``reader.read``) cancels
        the request so its slot frees at the next scheduler pass. With
        ``sse_heartbeat_s`` set, ``: ping`` comment frames keep
        intermediaries from severing streams parked in a deep backlog."""
        gw = self.gateway
        route = "/v1/completions"
        bridge = _StreamBridge(self._loop, gw.config.stream_queue_tokens)
        fleet, err = gw.submit_or_error(spec, trace_id,
                                        on_token=bridge.push_threadsafe)
        if err is not None:
            code, payload, hdrs = err
            self._send_json(writer, code, payload, route,
                            extra_headers=hdrs, body_bytes_in=nbytes,
                            trace_id=trace_id)
            return
        fleet.add_done_callback(bridge.finish_threadsafe)
        writer.write((
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-cache\r\n"
            "Connection: close\r\n"
            f"X-Request-Id: {fleet.trace_id}\r\n\r\n").encode())
        heartbeat = gw.config.sse_heartbeat_s
        sent = 0
        code = 200
        # Parked read: resolves only when the client half-closes (b"").
        eof_task = self._loop.create_task(reader.read(1))
        get_task = None
        gw.stats.stream_enter()
        try:
            while True:
                if get_task is None:
                    get_task = self._loop.create_task(bridge.get())
                done, _ = await asyncio.wait(
                    {get_task, eof_task}, timeout=heartbeat,
                    return_when=asyncio.FIRST_COMPLETED)
                if get_task in done:
                    item = get_task.result()
                    get_task = None
                    if item is _StreamBridge.DONE:
                        break
                    writer.write(
                        f"data: {json.dumps({'token': item})}\n\n".encode())
                    await writer.drain()
                    sent += 1
                    continue
                if eof_task in done:
                    try:
                        stray = eof_task.result()
                    except Exception:
                        stray = b""
                    if stray:
                        # Pipelined bytes, not a hang-up; keep watching.
                        eof_task = self._loop.create_task(reader.read(1))
                        continue
                    fleet.cancel()
                    code = 499  # client closed; nothing more to write
                    return
                # Neither task fired within the heartbeat window.
                writer.write(b": ping\n\n")
                await writer.drain()
            code, status = _STATUS_HTTP[fleet.status]
            final = summary_payload(fleet, status)
            final["done"] = True
            if fleet.status is not RequestStatus.COMPLETED:
                final["error"] = (str(fleet.error)
                                  if fleet.error is not None else status)
            writer.write(f"data: {json.dumps(final)}\n\n".encode())
            await writer.drain()
        except ConnectionError:
            fleet.cancel()
            code = 499
        finally:
            for t in (get_task, eof_task):
                if t is not None:
                    t.cancel()
            gw.stats.stream_exit()
            gw.stats.record_response(route, code, body_bytes=nbytes)
            gw.stats.record_stream(sent)

    # -- plumbing ----------------------------------------------------------
    def _call_soon(self, fn, *args):
        try:
            self._loop.call_soon_threadsafe(fn, *args)
        except RuntimeError:
            pass  # loop closed mid-shutdown

    def _retry_after(self) -> dict:
        return {"Retry-After": f"{self.gateway.config.retry_after_s:g}"}

    def _conn_enter(self, writer, route: str) -> bool:
        """Take an in-flight slot (the SAME semaphore the threading
        front end uses, so tests and operators see one knob); refuse
        with 503 — and close, shedding front-end state — at the cap."""
        if not self.gateway._conn_slots.acquire(blocking=False):
            self.gateway.stats.record_conn_rejection()
            self._send_json(writer, 503,
                            {"error": "connection limit reached"},
                            route, extra_headers=self._retry_after())
            return False
        self.gateway.stats.inflight_enter()
        return True

    def _conn_exit(self):
        self.gateway.stats.inflight_exit()
        self.gateway._conn_slots.release()

    def _send_json(self, writer, code: int, payload: dict, route: str, *,
                   extra_headers: Optional[dict] = None,
                   body_bytes_in: int = 0,
                   trace_id: Optional[str] = None):
        if trace_id is not None:
            # Correlation id rides both channels: the JSON body (clients
            # that log payloads) and the X-Request-Id header (proxies).
            payload.setdefault("trace_id", trace_id)
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if trace_id is not None:
            headers["X-Request-Id"] = trace_id
        headers.update(extra_headers or {})
        self._write_head(writer, code, headers, len(body))
        writer.write(body)
        self.gateway.stats.record_response(route, code,
                                           body_bytes=body_bytes_in)

    def _send_text(self, writer, code: int, text: str, route: str,
                   content_type: str = "text/plain; charset=utf-8",
                   extra_headers: Optional[dict] = None):
        body = text.encode()
        headers = {"Content-Type": content_type}
        headers.update(extra_headers or {})
        self._write_head(writer, code, headers, len(body))
        writer.write(body)
        self.gateway.stats.record_response(route, code)

    @staticmethod
    def _write_head(writer, code: int, headers: dict, content_length: int):
        reason = _HTTP_REASONS.get(code, "")
        lines = [f"HTTP/1.1 {code} {reason}"]
        lines.extend(f"{k}: {v}" for k, v in headers.items())
        lines.append(f"Content-Length: {content_length}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode())
