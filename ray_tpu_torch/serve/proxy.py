"""HTTP proxy actor: the data-plane ingress.

(reference: python/ray/serve/_private/proxy.py — ProxyActor per node runs a
uvicorn HTTP server (:706) and a gRPC server (:530), routes by longest
matching route prefix, and forwards to DeploymentHandles. Here: an
asyncio HTTP/1.1 server (serve/http_server.py — keep-alive, bounded
connections, chunked SSE streaming, graceful drain on shutdown) inside the
proxy actor, JSON in/out, same longest-prefix routing. The binary RPC
ingress (serve/rpc_ingress.py) is the low-latency alternative path.)
"""

from __future__ import annotations

import json
import logging
import threading
import time

import ray_tpu_torch
from ray_tpu_torch._private.constants import (HTTP_DEADLINE_HEADER,
                                              SERVE_BODY_REF_KEY)
from ray_tpu_torch._private.ray_config import RayConfig
from ray_tpu_torch.exceptions import DeadlineExceededError, RequestShedError
from ray_tpu_torch.serve import request_context as rc
from ray_tpu_torch.serve.http_server import AsyncHTTPServer
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

PROXY_NAME = "SERVE_PROXY"


@ray_tpu_torch.remote
class ProxyActor:
    """One HTTP ingress process. Two modes:

    - **legacy single proxy** (default args): one actor owns the port,
      routes from a TTL-cached controller-RPC table. `serve.start()`'s
      original topology, kept bit-for-bit for `num_proxies=0`.
    - **plane shard** (`plane_nonce` set): one of N controller-managed
      workers sharing the port via SO_REUSEPORT (or an fd-passed acceptor
      where unavailable, `fd_sock_path`), routing from the controller's
      seqlock shm table (serve/proxy_plane.py) so the request path never
      blocks on a controller RPC, with phase telemetry batched per
      `RayConfig.serve_telemetry_flush_s` interval instead of per-request.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8000, *,
                 shard_index: int | None = None,
                 plane_nonce: str | None = None,
                 fd_sock_path: str | None = None):
        from ray_tpu_torch.serve.api import _get_controller

        self.controller = _get_controller()
        self._routes: dict[str, str] = {}
        self._version = -1
        self._table: dict | None = None  # last full routing table
        self._handles: dict[str, object] = {}
        self._lock = threading.Lock()
        self._routes_ts = 0.0  # last successful refresh (monotonic)
        # single-flight refresh state: one leader fetches, concurrent
        # version-miss refreshes wait on its event instead of stacking
        # their own controller round-trips
        self._sf_lock = threading.Lock()
        self._sf_event: threading.Event | None = None
        self._pending_table = None  # in-flight get_routing_table ref
        self._shard_index = shard_index
        self._plane_nonce = plane_nonce
        self._routes_shm = None
        self._batcher = None
        if plane_nonce is not None:
            from ray_tpu_torch.serve import handle as handle_mod
            from ray_tpu_torch.serve.proxy_plane import (attach_routing_shm,
                                                         receive_listener_fd)

            self._routes_shm = attach_routing_shm(plane_nonce)
            if self._routes_shm is None:
                logger.warning("proxy shard %s: routing shm segment absent, "
                               "falling back to controller-RPC routing",
                               shard_index)
            else:
                # in-process DeploymentHandle routers read replica tables
                # from the same shm snapshot instead of RPCing the
                # controller per deployment
                handle_mod.set_local_table_source(self._table_source)
            self._batcher = rc.PhaseBatcher(on_flush=self._flush_gauges)
            rc.set_phase_batcher(self._batcher)
            if fd_sock_path is not None:
                sock = receive_listener_fd(fd_sock_path)
                self.server = AsyncHTTPServer(
                    self._handle_request, host, port, sock=sock).start()
            else:
                self.server = AsyncHTTPServer(
                    self._handle_request, host, port, reuse_port=True).start()
        else:
            self.server = AsyncHTTPServer(
                self._handle_request, host, port).start()
        self.port = self.server.port
        if plane_nonce is not None:
            # push readiness like replicas push their fast-RPC addr; the
            # controller marks the row running and surfaces the address
            try:
                self.controller.note_proxy_ready.remote(
                    int(shard_index or 0), (self.server.host, self.port))
            except Exception as e:  # noqa: BLE001 — controller mid-restart
                logger.debug("note_proxy_ready push failed: %r", e)

    def address(self) -> tuple[str, int]:
        return self.server.host, self.port

    def check_health(self) -> bool:
        """Controller health probe (same contract as replica probes): an
        answer within the probe timeout is health, a hang or a dead actor
        triggers replacement."""
        return True

    # ---------------------------------------------------- shard-mode plumbing

    def _table_source(self, known_version: int):
        """Local table source for in-process handle routers: the last shm
        snapshot, or None when the caller's version is already current."""
        with self._lock:
            table = self._table
        if table is None or table.get("version", -1) == known_version:
            return None
        return table

    def _flush_gauges(self) -> None:
        """Piggybacked on the telemetry-flush interval: export how stale
        this shard's routing view is. Age counts from the controller's
        last PUBLISH (it republishes every reconcile pass), so a climbing
        gauge means the controller stopped reconciling."""
        shm = self._routes_shm
        if shm is None or not rc.metrics_enabled():
            return
        try:
            _ver, ts = shm.peek()
            if ts > 0:
                from ray_tpu_torch.util import metrics as met

                met.get_or_create(
                    met.Gauge, "ray_tpu_serve_routing_table_age_seconds",
                    "seconds since the serve controller last published the "
                    "routing table this proxy shard routes from",
                    tag_keys=("shard",)).set(
                        max(time.time() - ts, 0.0),
                        tags={"shard": str(self._shard_index)})
        except Exception as e:  # noqa: BLE001 — gauges are best-effort
            logger.debug("routing-age gauge failed: %r", e)

    # ------------------------------------------------------------- data plane

    def _handle_request(self, method: str, path: str, headers: dict,
                        body: bytes):
        """Runs on the HTTP server's executor (may block on the handle).

        Every request gets a request id; every Nth
        (`RayConfig.serve_span_sample_every`) additionally opens a root
        span whose context rides the handle into the replicas, so one
        request id yields one cross-process span tree. Either way a
        summary lands in the flight-recorder ring."""
        rid = rc.new_request_id()
        rec = {"request_id": rid, "component": "http_proxy",
               "path": path, "method": method, "ts": time.time(),
               "sampled": rc.sample_request()}
        t_in = time.perf_counter()
        deadline_ts = self._parse_deadline(headers)
        span = (tracing.begin_request_trace(rid, path=path, method=method)
                if rec["sampled"] else None)
        if self._wants_stream(headers, body):
            try:
                gen = self._dispatch_stream(path, method, body, rid, rec,
                                            deadline_ts)
            except Exception as e:  # noqa: BLE001 — the proxy must answer
                status, payload, extra = self._error_response(e)
                tracing.finish_request_trace(span, ok=False)
                rc.record_request(rec, t_in, status=status)
                if extra:
                    return status, "application/json", payload, extra
                return status, "application/json", payload
            # the stream outlives this dispatch thread: deactivate the
            # context here, close the root span (and record) when the
            # BODY completes so the root's duration covers the stream
            tracing.detach_request_trace(span)

            def sse():
                ok = False
                try:
                    for item in gen:
                        yield (b"data: "
                               + json.dumps(item, default=str).encode()
                               + b"\n\n")
                    yield b"data: [DONE]\n\n"
                    ok = True
                finally:
                    if not ok:
                        # abandoned mid-stream (client disconnect observed
                        # by the HTTP server, or a write failure): tell the
                        # replica — and through it the engine — to stop
                        # producing, so the decode slot and KV pages free
                        # in one step instead of at max_tokens
                        cancel = getattr(gen, "cancel", None)
                        if cancel is not None:
                            try:
                                cancel()
                            except Exception as e:  # noqa: BLE001
                                logger.debug("stream cancel failed: %r", e)
                        rc.count_cancellation("proxy")
                    tracing.finish_request_trace(span, ok=ok)
                    rc.record_request(rec, t_in,
                                      status="stream" if ok else "aborted")

            return 200, "text/event-stream", sse()
        ok = True
        extra = None
        ctype = "application/json"
        try:
            status, payload, ctype = self._dispatch(path, method, body, rid,
                                                    rec, deadline_ts)
        except Exception as e:  # noqa: BLE001
            ok = False
            status, payload, extra = self._error_response(e)
        finally:
            tracing.finish_request_trace(span, ok=ok)
        rc.record_request(rec, t_in, status=status)
        if extra:
            return status, ctype, payload, extra
        return status, ctype, payload

    @staticmethod
    def _parse_deadline(headers: dict) -> float | None:
        """`x-ray-tpu-deadline-s: <seconds of budget>` → absolute deadline.
        The absolute form rides the request envelope so every hop (handle,
        replica admission, engine decode loop) measures remaining budget
        against its own clock without accumulating per-hop latency."""
        raw = headers.get(HTTP_DEADLINE_HEADER)
        if not raw:
            return None
        try:
            budget = float(raw)
        except ValueError:
            return None  # malformed header: treat as no deadline
        return time.time() + max(budget, 0.0)

    @staticmethod
    def _error_response(e: Exception) -> tuple[int, bytes, dict | None]:
        """Map data-plane failures to HTTP: shed → 503 + Retry-After (the
        client should back off, not retry immediately), deadline → 504,
        anything else → 500."""
        payload = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
        if isinstance(e, RequestShedError):
            # the shedding component (router/replica) already counted it
            return 503, payload, {
                "Retry-After": f"{max(e.retry_after_s, 0.0):g}"}
        if isinstance(e, DeadlineExceededError):
            return 504, payload, None
        return 500, payload, None

    @staticmethod
    def _wants_stream(headers: dict, body: bytes) -> bool:
        if "text/event-stream" in (headers.get("accept") or ""):
            return True
        try:
            return bool(body and json.loads(body).get("stream"))
        except Exception:
            return False

    _ROUTE_TTL_S = 0.5

    def _refresh_routes(self, force: bool = False):
        """TTL-cached: the hot path must NOT pay a controller round-trip
        per request — at ~0.5 ms/RPC the single controller actor was the
        whole data plane's throughput cap (measured: 612 req/s sequential,
        781 at concurrency 16). A stale table is safe: routes are
        versioned, unknown paths force-refresh, and replica-death is
        handled at the handle layer, not here. (reference: the proxy keeps
        a pushed route table via long-poll, proxy.py route_table updates.)

        Plane shards never RPC here at all: the controller broadcasts the
        table through the seqlock shm segment, so a refresh is a header
        peek (+ a validated copy when the version moved). Falls back to
        the RPC path only if the segment disappears or wedges.

        The RPC path is **single-flight**: concurrent refreshes (a table
        bump under load used to stampede the controller with one fetch per
        request thread) elect one leader; version-miss (`force`) callers
        wait for the leader's fetch, everyone else keeps serving the
        cached routes."""
        if self._routes_shm is not None and self._refresh_from_shm(force):
            return
        if not force and time.monotonic() - self._routes_ts < self._ROUTE_TTL_S:
            return
        with self._sf_lock:
            ev = self._sf_event
            if ev is None:
                self._sf_event = ev = threading.Event()
                leader = True
            else:
                leader = False
        if not leader:
            if force:
                # a version miss must see the coalesced fetch's result —
                # bounded wait, then re-match against whatever landed
                ev.wait(1.5)
            return  # TTL refresh: stale is fine, the leader is on it
        try:
            self._fetch_table_once(force)
        finally:
            with self._sf_lock:
                self._sf_event = None
            ev.set()

    def _refresh_from_shm(self, force: bool) -> bool:
        """Refresh from the controller's shm broadcast. True = handled (the
        RPC path must not run); False = segment unusable, fall back."""
        shm = self._routes_shm
        try:
            if not force:
                ver, _ts = shm.peek()
                if ver == self._version:
                    return True  # current; peek cost only
            # force re-reads unconditionally: a miss may mean our local
            # apply raced a publish with an unchanged version counter
            table, ver, _ts = shm.read(-1 if force else self._version)
            self._routes_ts = time.monotonic()
            if table is not None:
                with self._lock:
                    self._version = table.get("version", ver)
                    self._routes = table.get("routes", {})
                    self._table = table
            return True
        except (TimeoutError, ValueError, OSError) as e:
            logger.warning("routing shm read failed (%r): falling back to "
                           "controller RPC", e)
            return False

    def _fetch_table_once(self, force: bool):
        """One leader's controller fetch (callers hold the single-flight
        slot). Outage-tolerant: on any failure keep the version-cached
        routes and re-resolve the controller for next time."""
        # if ANY refresh landed in the last 50 ms the table is as fresh as
        # a new RPC would give — don't re-fetch just because we won a race
        window = 0.05 if force else self._ROUTE_TTL_S
        if time.monotonic() - self._routes_ts < window:
            return
        try:
            # async fetch + short completion wait: route refreshes run
            # on the request path, so a controller mid-restart (whose
            # queued calls answer only after recovery) costs a bounded
            # pause, not seconds per request — the pending ref is
            # re-checked by later refreshes
            if self._pending_table is None:
                self._pending_table = \
                    self.controller.get_routing_table.remote(self._version)
            done, _ = ray_tpu_torch.wait([self._pending_table], num_returns=1,
                                   timeout=1.0 if force else 0.25)
            if not done:
                self._routes_ts = time.monotonic()
                return  # still in flight: serve the cached routes
            ref, self._pending_table = self._pending_table, None
            table = ray_tpu_torch.get(ref, timeout=5.0)
        except Exception:  # noqa: BLE001 — controller outage
            # controller killed and recreated under the same name: keep
            # serving the version-cached routes (requests go straight
            # to replicas) and re-resolve for the next refresh (single
            # attempt — this is the request path)
            from ray_tpu_torch.serve.api import _resolve_controller

            self._pending_table = None
            self._routes_ts = time.monotonic()  # don't hammer mid-outage
            try:
                self.controller = _resolve_controller(timeout_s=0.0)
            except RuntimeError:
                pass
            return
        self._routes_ts = time.monotonic()
        if table is not None:
            with self._lock:
                self._version = table["version"]
                self._routes = table["routes"]
                self._table = table

    def _parse_body(self, body: bytes, rec: dict):
        with rc.timed_phase(rc.PROXY_PHASE, "parse", rec, span="proxy:parse"):
            return json.loads(body) if body else None

    def _build_request(self, path: str, method: str, body: bytes,
                       request_id: str, rec: dict) -> dict:
        """Request envelope for the handle. Bodies at or above
        `RayConfig.serve_zero_copy_threshold_bytes` take the zero-copy
        lane: the raw bytes go into the arena object plane ONCE here and
        the envelope carries only the object-id hex — the fast-RPC frame
        (and any GCS hop) never sees the payload. The ref is pinned on
        `rec`, which outlives the downstream fetch (call_sync return /
        stream completion), so the object can't be released mid-read."""
        threshold = RayConfig.instance().serve_zero_copy_threshold_bytes
        if threshold > 0 and len(body) >= threshold:
            with rc.timed_phase(rc.PROXY_PHASE, "parse", rec,
                                span="proxy:parse"):
                ref = ray_tpu_torch.put(bytes(body))
            rec["_body_ref"] = ref  # keepalive until the request resolves
            request = {"path": path, "method": method, "body": None,
                       "request_id": request_id,
                       SERVE_BODY_REF_KEY: ref.hex()}
        else:
            request = {"path": path, "method": method,
                       "body": self._parse_body(body, rec),
                       "request_id": request_id}
        return request

    def _dispatch(self, path: str, method: str, body: bytes,
                  request_id: str, rec: dict,
                  deadline_ts: float | None = None):
        request = self._build_request(path, method, body, request_id, rec)
        with rc.timed_phase(rc.PROXY_PHASE, "route", rec, span="proxy:route"):
            handle = self._resolve_handle(path)
        if handle is None:
            return (404, json.dumps({"error": f"no route for {path}"}).encode(),
                    "application/json")
        if deadline_ts:
            request["deadline_ts"] = deadline_ts
        # replica-death failures retry on survivors, dropping the dead
        # replica from the router between attempts (see handle.call_sync);
        # the timeout is the configured ceiling, clamped further by the
        # request's own deadline inside call_sync
        with rc.timed_phase(rc.PROXY_PHASE, "handle", rec,
                            span="proxy:handle"):
            result = handle.call_sync(
                request,
                timeout_s=RayConfig.instance().serve_request_timeout_s,
                _routing_hint=self._routing_hint(request),
                _deadline_ts=deadline_ts)
        if isinstance(result, (bytes, bytearray)):
            # zero-copy result lane (replicas returning raw bytes arrive
            # via an object ref, already fetched by the handle): pass the
            # payload through verbatim instead of str()-mangling it
            return 200, bytes(result), "application/octet-stream"
        return 200, json.dumps(result, default=str).encode(), "application/json"

    @staticmethod
    def _routing_hint(request: dict) -> str | None:
        """Prompt text for prefix-aware routing (None falls back to pow2)."""
        body = request.get("body") or {}
        if isinstance(body, dict):
            if body.get("prompt"):
                return str(body["prompt"])
            msgs = body.get("messages")
            if msgs:
                return "".join(str(m.get("content", "")) for m in msgs)
        return None

    def _resolve_handle(self, path: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        self._refresh_routes()

        def _match():
            with self._lock:
                m = max((p for p in self._routes
                         if path == p or path.startswith(p.rstrip("/") + "/")
                         or p == "/"),
                        key=len, default=None)
                return self._routes.get(m) if m else None

        dep = _match()
        if dep is None:
            # unknown path: the cached table may predate a new app —
            # force one synchronous refresh before 404ing
            self._refresh_routes(force=True)
            dep = _match()
        if dep is None:
            return None
        handle = self._handles.get(dep)
        if handle is None:
            handle = self._handles[dep] = DeploymentHandle(dep, self.controller)
        return handle

    def _dispatch_stream(self, path: str, method: str, body: bytes,
                         request_id: str, rec: dict,
                         deadline_ts: float | None = None):
        request = self._build_request(path, method, body, request_id, rec)
        with rc.timed_phase(rc.PROXY_PHASE, "route", rec, span="proxy:route"):
            handle = self._resolve_handle(path)
        if handle is None:
            raise ValueError(f"no route for {path}")
        if deadline_ts:
            request["deadline_ts"] = deadline_ts
        return handle.options(stream=True, method_name="stream_request").remote(
            request, _routing_hint=self._routing_hint(request),
            _deadline_ts=deadline_ts)

    def shutdown(self):
        self.server.stop(graceful=True)
        if self._batcher is not None:
            rc.set_phase_batcher(None)
            self._batcher.close()  # final flush rides close()
        if self._routes_shm is not None:
            from ray_tpu_torch.serve import handle as handle_mod

            handle_mod.set_local_table_source(None)
            self._routes_shm.close()  # reader detach; creator unlinks
