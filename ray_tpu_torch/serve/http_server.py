"""Asyncio HTTP/1.1 server for the Serve data plane.

Replaces the thread-per-request stdlib server: one event loop handles all
connections (keep-alive, pipelined clients, slow readers) with a bounded
connection semaphore; blocking deployment-handle calls run on a bounded
executor so the loop never stalls; streaming responses bridge a blocking
generator into chunked transfer frames through an asyncio queue; shutdown
is graceful — stop accepting, drain in-flight requests up to a deadline,
then close.

(reference: python/ray/serve/_private/proxy.py:706 — uvicorn-based proxy
with graceful draining; uvicorn isn't in the image, so this is a minimal
native-asyncio equivalent.)
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

logger = logging.getLogger(__name__)


class _BadRequest(Exception):
    pass


class _PayloadTooLarge(Exception):
    """Declared Content-Length exceeds the configured cap — answered with
    413 WITHOUT reading the body, so an abusive client can't make the
    server buffer unbounded bytes per connection."""

    def __init__(self, limit: int):
        self.limit = limit


MAX_HEADER_BYTES = 64 * 1024


def _max_body_bytes() -> int:
    # read through the singleton each request: tests toggle the cap via
    # env + RayConfig.reset(), and the read is trivial next to a request
    from ray_tpu_torch._private.ray_config import RayConfig

    return RayConfig.instance().serve_max_http_body_bytes


def _observe_accept(seconds: float) -> None:
    """Executor dispatch wait (request fully read → handler running): the
    'accept' phase of the proxy breakdown. Queueing here means the bounded
    executor is the bottleneck, not the downstream handle."""
    try:
        from ray_tpu_torch.serve import request_context as rc

        rc.observe_phase(rc.PROXY_PHASE, "accept", seconds)
    except Exception as e:  # noqa: BLE001 — must never fail a request
        logger.debug("proxy accept-phase metric emit failed: %r", e)


class AsyncHTTPServer:
    """`handler(method, path, headers, body)` returns
    (status, content_type, payload_bytes) for plain responses or
    (status, content_type, iterator) where an iterator streams chunks
    (SSE-style, sent with chunked transfer encoding). The handler runs on
    the executor — it may block."""

    def __init__(self, handler: Callable, host: str = "127.0.0.1",
                 port: int = 0, *, max_connections: int = 1024,
                 executor_workers: int = 32, drain_grace_s: float = 10.0,
                 reuse_port: bool = False, sock=None):
        self.handler = handler
        self.host = host
        self.port = port
        # sharded-ingress plumbing: `reuse_port` lets N sibling servers
        # bind the same (host, port); `sock` serves from an already-bound
        # listen socket (the fd-passing fallback hands each shard a dup of
        # one shared acceptor). Mutually exclusive with each other.
        self._reuse_port = reuse_port
        self._sock = sock
        self.drain_grace_s = drain_grace_s
        self._max_connections = max_connections
        self._executor = ThreadPoolExecutor(
            max_workers=executor_workers, thread_name_prefix="serve-http")
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.base_events.Server | None = None
        self._inflight = 0
        self._inflight_zero = threading.Event()
        self._inflight_zero.set()
        self._stopping = False
        self._start_error: BaseException | None = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-http-loop")

    # ---------------------------------------------------------------- start

    def start(self) -> "AsyncHTTPServer":
        self._thread.start()
        if not self._started.wait(30.0):
            raise RuntimeError("HTTP server failed to start")
        if self._start_error is not None:
            raise self._start_error
        return self

    def _run(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self._serve())

    async def _serve(self):
        self._conn_sem = asyncio.Semaphore(self._max_connections)
        try:
            if self._sock is not None:
                self._sock.setblocking(False)
                self._server = await asyncio.start_server(
                    self._on_connection, sock=self._sock)
            elif self._reuse_port:
                self._server = await asyncio.start_server(
                    self._on_connection, self.host, self.port,
                    reuse_port=True)
            else:
                self._server = await asyncio.start_server(
                    self._on_connection, self.host, self.port)
        except OSError as e:  # bind failure surfaces to start() immediately
            self._start_error = e
            self._started.set()
            return
        self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        async with self._server:
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass
        # Python 3.10's Server.wait_closed() returns once the LISTENER
        # closes — it does not wait for open client connections. Returning
        # here would stop the event loop with in-flight handlers stranded
        # mid-await, their responses never written (the graceful-drain bug:
        # stop() then times out waiting for an inflight count that can
        # never reach zero). Park instead: the loop stays alive until
        # stop() has observed the drain and cancels every task, us included.
        try:
            await asyncio.Event().wait()
        except asyncio.CancelledError:
            pass

    # ------------------------------------------------------------ connection

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        async with self._conn_sem:
            try:
                while not self._stopping:
                    req = await self._read_request(reader)
                    if req is None:
                        break
                    method, path, headers, body = req
                    self._inflight += 1
                    self._inflight_zero.clear()
                    try:
                        keep = await self._respond(writer, reader, method,
                                                   path, headers, body)
                    finally:
                        self._inflight -= 1
                        if self._inflight == 0:
                            self._inflight_zero.set()
                    if not keep:
                        break
            except _BadRequest:
                try:
                    body = b'{"error": "bad request"}'
                    writer.write(
                        b"HTTP/1.1 400 X\r\nContent-Type: application/json\r\n"
                        + f"Content-Length: {len(body)}\r\n".encode()
                        + b"Connection: close\r\n\r\n" + body)
                    await writer.drain()
                except OSError:
                    pass  # client hung up before reading the 400
            except _PayloadTooLarge as e:
                # the oversized body was never read, so the connection is
                # desynchronized — answer and close, never keep-alive
                try:
                    body = json.dumps({
                        "error": "payload too large",
                        "max_body_bytes": e.limit}).encode()
                    writer.write(
                        b"HTTP/1.1 413 X\r\n"
                        b"Content-Type: application/json\r\n"
                        + f"Content-Length: {len(body)}\r\n".encode()
                        + b"Connection: close\r\n\r\n" + body)
                    await writer.drain()
                except OSError:
                    pass  # client hung up before reading the 413
            except (asyncio.IncompleteReadError, ConnectionResetError,
                    asyncio.LimitOverrunError, BrokenPipeError):
                pass
            finally:
                try:
                    writer.close()
                    await writer.wait_closed()
                except OSError:
                    pass  # peer already reset the connection

    async def _read_request(self, reader: asyncio.StreamReader):
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > MAX_HEADER_BYTES:
            return None
        lines = head.decode("latin1").split("\r\n")
        parts = lines[0].split()
        if len(parts) < 3:
            return None
        method, path = parts[0], parts[1]
        headers: dict[str, str] = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
        try:
            n = int(headers.get("content-length") or 0)
        except ValueError as e:
            raise _BadRequest from e
        if n < 0:
            raise _BadRequest
        limit = _max_body_bytes()
        if n > limit:
            raise _PayloadTooLarge(limit)
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    async def _respond(self, writer: asyncio.StreamWriter,
                       reader: asyncio.StreamReader, method: str,
                       path: str, headers: dict, body: bytes) -> bool:
        loop = asyncio.get_running_loop()
        _t_queued = time.perf_counter()

        def _run_handler():
            _observe_accept(time.perf_counter() - _t_queued)
            return self.handler(method, path, headers, body)

        extra: dict | None = None
        try:
            result = await loop.run_in_executor(self._executor, _run_handler)
            if len(result) == 4:  # optional extra headers (e.g. Retry-After)
                status, ctype, payload, extra = result
            else:
                status, ctype, payload = result
        except Exception as e:  # noqa: BLE001 — the server must answer
            payload = json.dumps(
                {"error": f"{type(e).__name__}: {e}"}).encode()
            status, ctype = 500, "application/json"
        keep = (headers.get("connection", "").lower() != "close"
                and not self._stopping)
        extra_hdrs = "".join(f"{k}: {v}\r\n" for k, v in (extra or {}).items())
        if isinstance(payload, (bytes, bytearray)):
            writer.write(
                f"HTTP/1.1 {status} X\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n{extra_hdrs}"
                f"Connection: {'keep-alive' if keep else 'close'}\r\n"
                f"\r\n".encode() + payload)
            await writer.drain()
            return keep
        # streaming: a blocking iterator bridged through an asyncio queue
        writer.write(
            f"HTTP/1.1 {status} X\r\nContent-Type: {ctype}\r\n"
            "Cache-Control: no-cache\r\nTransfer-Encoding: chunked\r\n"
            "Connection: close\r\n\r\n".encode())
        await writer.drain()
        q: asyncio.Queue = asyncio.Queue(maxsize=16)
        DONE = object()
        aborted = threading.Event()  # consumer gone: pump must not block

        def put_blocking(item) -> bool:
            while not aborted.is_set():
                fut = asyncio.run_coroutine_threadsafe(q.put(item), loop)
                try:
                    fut.result(timeout=0.5)
                    return True
                except concurrent.futures.TimeoutError:
                    fut.cancel()  # slow/dead consumer: re-check aborted
                    if fut.done() and not fut.cancelled():
                        return True  # the put landed as the timeout fired
                except Exception:
                    return False  # loop closed
            return False

        def pump():
            try:
                try:
                    for item in payload:
                        if not put_blocking(item):
                            return
                except Exception as e:  # noqa: BLE001 — surfaced as a chunk
                    put_blocking(e)
                put_blocking(DONE)
            finally:
                close = getattr(payload, "close", None)
                if close is not None:
                    try:
                        close()  # release the deployment generator
                    except Exception as e:  # noqa: BLE001 — user generator
                        logger.debug("stream generator close() raised "
                                     "during teardown: %r", e)

        self._executor.submit(pump)
        # half-closed-socket watch: an SSE client sends nothing after its
        # request, so any readability — EOF or stray bytes — means it went
        # away. Without this, a disconnect is only noticed at the next
        # chunk WRITE, which for a slow/stalled stream may be never; the
        # abort must interrupt the wait for the next item, not ride on it.
        disconnect = asyncio.ensure_future(reader.read(1))
        get_task: asyncio.Task | None = None
        item = None
        try:
            while True:
                get_task = asyncio.ensure_future(q.get())
                await asyncio.wait({get_task, disconnect},
                                   return_when=asyncio.FIRST_COMPLETED)
                if not get_task.done():
                    break  # client disconnected while the stream was quiet
                item = get_task.result()
                get_task = None
                if item is DONE:
                    break
                if isinstance(item, Exception):
                    chunk = (b"data: " + json.dumps(
                        {"error": f"{type(item).__name__}: {item}"}).encode()
                        + b"\n\n")
                else:
                    chunk = item if isinstance(item, (bytes, bytearray)) else str(item).encode()
                writer.write(f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                await writer.drain()
                if disconnect.done():
                    break  # write "succeeded" into a dead socket: stop
            if item is DONE and not disconnect.done():
                writer.write(b"0\r\n\r\n")
                await writer.drain()
        finally:
            # aborted unblocks the pump; closing its queue path makes the
            # pump's finally close the deployment generator, which carries
            # the cancel upstream (replica → engine slot/page reclaim)
            aborted.set()
            disconnect.cancel()
            if get_task is not None:
                get_task.cancel()
        return False

    # ----------------------------------------------------------------- stop

    def stop(self, graceful: bool = True) -> None:
        """Stop accepting; drain in-flight up to drain_grace_s; close."""
        self._stopping = True
        loop = self._loop
        if loop is None:
            return
        if self._server is not None:
            loop.call_soon_threadsafe(self._server.close)
        if graceful:
            self._inflight_zero.wait(self.drain_grace_s)

        def _cancel_all():
            for task in asyncio.all_tasks(loop):
                task.cancel()

        loop.call_soon_threadsafe(_cancel_all)
        self._executor.shutdown(wait=False)
        self._thread.join(timeout=5.0)
