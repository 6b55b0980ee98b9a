"""Replica actor: hosts one copy of a deployment's user callable.

(reference: python/ray/serve/_private/replica.py — UserCallableWrapper runs
the user method; replicas track ongoing requests for the router and the
autoscaler. Concurrency: the reference replica is an asyncio event loop with
max_ongoing_requests admission; here the actor runs with
max_concurrency=max_ongoing_requests threads.

Fast data plane: each replica also listens on a framed-RPC socket
(reference: the proxy speaks gRPC/HTTP directly into the replica's event
loop — serve/_private/replica.py handle_request over gRPC — NOT through a
per-request scheduler hop). DeploymentHandles connect once per replica and
pipeline rid-tagged request frames, bypassing task-submission machinery;
the actor-task path remains for streaming and as the fallback when no
address is known.)
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import ray_tpu_torch
from ray_tpu_torch._private.constants import SERVE_BODY_REF_KEY
from ray_tpu_torch._private.protocol import ConnectionClosed, MsgConnection, listen_tcp
from ray_tpu_torch._private.ray_config import RayConfig
from ray_tpu_torch.exceptions import (DeadlineExceededError, RequestCancelledError,
                                      RequestShedError)
from ray_tpu_torch.serve import request_context as _rc
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)

_replica_ctx = threading.local()


class _CancelHolder:
    """Per-request cancellation latch. The cancel RPC sets it (firing any
    registered callbacks) and the in-request `on_cancel` hook registers
    callbacks — in either order: registering after the cancel landed fires
    the callback immediately, so the replica↔engine handoff has no
    lost-cancel window."""

    __slots__ = ("_lock", "_cbs", "cancelled")

    def __init__(self):
        self._lock = threading.Lock()
        self._cbs: list = []
        self.cancelled = False

    def register(self, cb) -> None:
        with self._lock:
            if not self.cancelled:
                self._cbs.append(cb)
                return
        cb()  # cancel already landed: fire on the registrant's thread

    def cancel(self) -> None:
        with self._lock:
            if self.cancelled:
                return
            self.cancelled = True
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception as e:  # noqa: BLE001 — one bad callback must
                # not stop the rest of the request's teardown
                logger.warning("cancel callback raised: %r", e)


def on_cancel(callback) -> None:
    """Register a callback fired if THIS request is cancelled (client
    disconnect, explicit `DeploymentResponse.cancel()`, timed-out caller).
    Valid inside a replica handling a request — LLM servers use it to
    route the cancel into `engine.abort_request` — and a no-op elsewhere.
    If the cancel already landed, the callback fires immediately."""
    holder = getattr(_replica_ctx, "cancel_holder", None)
    if holder is not None:
        holder.register(callback)


def request_deadline() -> float | None:
    """Absolute wall-clock deadline (epoch seconds) of the request being
    handled, or None when the caller set none. Valid inside a replica."""
    return getattr(_replica_ctx, "deadline_ts", None) or None


def _node_ip() -> str:
    """This node's routable IP for fast-RPC advertisement. Env override
    first (multi-host agents set it), then hostname lookup, then loopback
    (single-host sessions)."""
    import socket

    ip = os.environ.get("RAY_TPU_TORCH_NODE_IP")
    if ip:
        return ip
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def get_multiplexed_model_id() -> str | None:
    """(reference: serve/api.py get_multiplexed_model_id — valid inside a
    replica handling a multiplexed request.)"""
    return getattr(_replica_ctx, "model_id", None)


@ray_tpu_torch.remote(concurrency_groups={"control": 2})
class ReplicaActor:
    def __init__(self, deployment_name: str, replica_tag: str,
                 callable_blob: bytes, init_args_blob: bytes,
                 user_config: dict | None = None,
                 max_ongoing_requests: int = 8,
                 max_queued_requests: int = -1):
        from ray_tpu_torch._private import serialization as ser

        self.deployment_name = deployment_name
        self.replica_tag = replica_tag
        target = ser.loads(callable_blob)
        args, kwargs = ser.loads(init_args_blob)
        if inspect.isclass(target):
            self.user = target(*args, **kwargs)
        else:
            self.user = target  # function deployment: called directly
        self._ongoing = 0
        self._pending = 0  # admission-queued (either plane), not yet running
        self._total = 0
        self._lock = threading.Lock()
        # overload shedding: bound the admission queue; -1 = unbounded
        # (reference: serve's max_queued_requests). Shed requests raise
        # RequestShedError, which the HTTP proxy maps to 503 + Retry-After.
        self._max_queued = int(max_queued_requests)
        # cancellation plane: cancel_key -> latch for in-flight requests,
        # plus tombstones for cancels that beat their request here (the
        # cancel frame can overtake a queued data frame)
        self._cancels: dict[str, _CancelHolder] = {}
        self._cancelled_keys: dict[str, float] = {}
        # zero-copy result lane keepalive: refs for oversized reply
        # payloads (shipped as object-id hex over fast-RPC) pinned here
        # until the caller has had its fetch window — dropping the ref at
        # reply-send would race the consumer's ray_tpu_torch.get
        self._result_refs: list[tuple[float, object]] = []
        # serve metrics on the cluster metrics plane (reference: serve
        # emits request count/latency per deployment into the metrics
        # agent; the Grafana serve dashboard targets these names)
        from ray_tpu_torch.util import metrics as _met

        tags = {"deployment": deployment_name, "replica": replica_tag}
        self._m_requests = _met.Counter(
            "ray_tpu_serve_requests_total", "serve requests handled",
            tag_keys=("deployment", "replica")).set_default_tags(tags)
        self._m_latency = _met.Histogram(
            "ray_tpu_serve_request_latency_ms", "serve request latency (ms)",
            boundaries=[1, 5, 10, 25, 50, 100, 250, 500, 1000, 5000],
            tag_keys=("deployment", "replica")).set_default_tags(tags)
        if user_config is not None:
            self.reconfigure(user_config)
        # fast data plane: framed-RPC listener + bounded execution pool.
        # ONE admission semaphore bounds user-code concurrency across BOTH
        # planes — without it, actor-plane max_concurrency threads plus the
        # RPC pool would double the configured max_ongoing_requests.
        self._admission = threading.BoundedSemaphore(
            max(1, max_ongoing_requests))
        self._rpc_addr: tuple | None = None
        self._rpc_stop = False
        try:
            self._rpc_sock = listen_tcp("0.0.0.0", 0)
            # advertise a ROUTABLE address: cross-node handles must not
            # connect to their own localhost (reference: replicas register
            # node_ip-based addresses, serve/_private/replica.py)
            self._rpc_addr = (_node_ip(),
                              self._rpc_sock.getsockname()[1])
            self._rpc_pool = ThreadPoolExecutor(
                max_workers=max(1, max_ongoing_requests),
                thread_name_prefix=f"replica-rpc-{replica_tag}")
            threading.Thread(target=self._rpc_accept, daemon=True,
                             name=f"replica-rpc-accept-{replica_tag}").start()
        except OSError:
            self._rpc_sock = None  # handles fall back to the actor plane
        self._push_addr()
        # out-of-band ongoing-count push: fast-plane requests never appear
        # in GCS actor task stats, so the autoscaler needs the replica's
        # own counters (reference: replicas push autoscaling metrics out of
        # band — serve/_private/replica.py metrics pusher)
        threading.Thread(target=self._stats_push_loop, daemon=True,
                         name=f"replica-stats-{replica_tag}").start()

    def _stats_push_loop(self):
        import time

        controller = None
        tick = 0
        while not self._rpc_stop:
            time.sleep(0.2)
            tick += 1
            with self._lock:
                val = self._ongoing + self._pending
            try:
                if controller is None:
                    from ray_tpu_torch.serve.api import _get_controller

                    controller = _get_controller()
                controller.note_replica_stats.remote(
                    self.deployment_name, self.replica_tag, val)
                # re-advertise the fast-RPC address periodically (not every
                # tick — that would double the controller's per-replica
                # message rate): the one-shot __init__ push can be lost
                # (controller restart, transient failure), which would
                # silently demote this replica to the slow actor plane
                # forever. ~5s of demotion is an acceptable healing window;
                # the controller only bumps the table version on CHANGE, so
                # the steady state stays free.
                if self._rpc_addr is not None and tick % 25 == 1:
                    controller.note_replica_addr.remote(
                        self.deployment_name, self.replica_tag,
                        self._rpc_addr)
            except Exception:
                controller = None  # controller restart: re-resolve
                # re-advertise the addr on the FIRST tick after the
                # re-resolve rather than up to 5s later — a recovered
                # controller restores addrs from its persisted rows, but a
                # RECREATED one (serve.shutdown + run race) starts empty
                tick = 0

    # ------------------------------------------------------- fast data plane

    def _push_addr(self):
        """Register the RPC address with the controller so routing tables
        carry it (fire-and-forget; the actor plane works without it)."""
        if self._rpc_addr is None:
            return
        try:
            from ray_tpu_torch.serve.api import _get_controller

            _get_controller().note_replica_addr.remote(
                self.deployment_name, self.replica_tag, self._rpc_addr)
        except Exception as e:  # noqa: BLE001 — actor plane still works
            # losing this push silently demotes the replica to the slow
            # actor plane until the stats loop re-advertises (~5s): worth
            # a log line, never worth failing __init__
            logger.debug("replica %s: fast-RPC addr push failed: %r",
                         self.replica_tag, e)

    def rpc_address(self) -> tuple | None:
        return self._rpc_addr

    def _rpc_accept(self):
        while not self._rpc_stop:
            try:
                raw, _ = self._rpc_sock.accept()
            except OSError:
                return
            raw.setsockopt(__import__("socket").IPPROTO_TCP,
                           __import__("socket").TCP_NODELAY, 1)
            conn = MsgConnection(raw)
            threading.Thread(target=self._rpc_conn_loop, args=(conn,),
                             daemon=True, name="replica-rpc-conn").start()

    def _rpc_conn_loop(self, conn: MsgConnection):
        """One recv loop per client connection; execution fans out to the
        bounded pool so rid-tagged requests pipeline."""
        try:
            while not self._rpc_stop:
                msg = conn.recv()
                if "method" not in msg and "cancel_key" in msg:
                    # control frame: cancel must jump the execution pool's
                    # queue (the request it targets may be stuck in it)
                    self.cancel_request(msg["cancel_key"])
                    continue
                self._rpc_pool.submit(self._rpc_execute, conn, msg)
        except (ConnectionClosed, OSError):
            pass

    def _rpc_execute(self, conn: MsgConnection, msg: dict):
        rid = msg.get("rid")
        try:
            if "args_ser" in msg:  # client's cloudpickle fallback lane
                from ray_tpu_torch._private import serialization as ser

                args, kwargs = ser.loads(msg["args_ser"])
            else:
                args, kwargs = tuple(msg.get("args") or ()), \
                    msg.get("kwargs") or {}
            # the fast plane has no task spec: a sampled request's trace
            # context rides the frame, activated here so user code (and
            # nested handle calls) chain under the caller's span. Named
            # distinctly from _record_phases' "replica:…" child (the
            # actor plane's equivalent wrapper is the task span, named by
            # method) so by-name span aggregation never double-counts.
            with _tracing.activate(
                    msg.get("trace_ctx"), kind="serve_rpc",
                    name=f"rpc:{self.deployment_name}.{msg['method']}"):
                result = self.handle_request(
                    msg["method"], args, kwargs, msg.get("model_id"),
                    cancel_key=msg.get("cancel_key"),
                    deadline_ts=msg.get("deadline_ts"))
            reply = self._build_reply(rid, result)
        except BaseException as e:  # noqa: BLE001 — shipped to the caller
            reply = {"rid": rid, "ok": False, "error": e,
                     "error_text": f"{type(e).__name__}: {e}"}
        try:
            conn.send(reply)
            return
        except (ConnectionClosed, OSError):
            return  # client gone: nothing to reply to
        except Exception as e:  # noqa: BLE001 — frame pickle rejected payload
            logger.debug("replica %s rid=%s: frame pickle rejected the "
                         "reply, retrying with cloudpickle: %r",
                         self.replica_tag, rid, e)
        # parity with the actor plane: stdlib pickle (the frame codec)
        # can't take lambdas/closures that cloudpickle can — retry the
        # payload through the runtime's serializer before giving up
        try:
            from ray_tpu_torch._private import serialization as ser

            if reply.get("ok"):
                conn.send({"rid": rid, "ok": True,
                           "result_ser": ser.dumps(reply["result"])})
            else:
                conn.send({"rid": rid, "ok": False,
                           "error_ser": ser.dumps(reply["error"])})
            return
        except (ConnectionClosed, OSError):
            return
        except Exception as e:  # noqa: BLE001 — truly unserializable
            logger.debug("replica %s rid=%s: cloudpickle also rejected the "
                         "reply, shipping a string stand-in: %r",
                         self.replica_tag, rid, e)
        # the rid MUST get a reply or the caller waits forever: ship a
        # plain-string stand-in for whatever refused to serialize
        try:
            conn.send({"rid": rid, "ok": False,
                       "error": TypeError(
                           "reply not serializable over fast-rpc: "
                           + (reply.get("error_text")
                              or type(reply.get("result")).__name__))})
        except Exception as e:  # noqa: BLE001 — caller times out instead
            logger.warning("replica %s rid=%s: could not deliver ANY "
                           "reply (caller will time out): %r",
                           self.replica_tag, rid, e)

    def _build_reply(self, rid, result) -> dict:
        """Reply envelope for one fast-RPC request. Byte payloads at or
        above `RayConfig.serve_zero_copy_threshold_bytes` take the
        zero-copy lane: the bytes go into the arena object plane and the
        frame carries only the object-id hex — the caller's `_Pending.wait`
        fetches them through shm. The ref is pinned in `_result_refs` for
        the caller's fetch window (dropping it at send would race the
        consumer's get)."""
        threshold = RayConfig.instance().serve_zero_copy_threshold_bytes
        if (threshold > 0 and isinstance(result, (bytes, bytearray))
                and len(result) >= threshold):
            try:
                ref = ray_tpu_torch.put(bytes(result))
                now = time.monotonic()
                with self._lock:
                    self._result_refs.append((now, ref))
                    while self._result_refs and (
                            now - self._result_refs[0][0] > 30.0
                            or len(self._result_refs) > 512):
                        self._result_refs.pop(0)
                return {"rid": rid, "ok": True, "result_ref": ref.hex()}
            except Exception as e:  # noqa: BLE001 — fall back to inline
                logger.debug("replica %s: zero-copy reply put failed, "
                             "inlining: %r", self.replica_tag, e)
        return {"rid": rid, "ok": True, "error_text": None, "result": result}

    def _unwrap_body_refs(self, args: tuple) -> tuple:
        """Zero-copy request lane, consumer side: a request envelope whose
        body crossed via the arena object plane carries the object-id hex
        under SERVE_BODY_REF_KEY — fetch the raw bytes (shm-local) and
        parse them into `body` before user code runs. No-op for inline
        envelopes, so both planes hand user code the identical request."""
        if not any(isinstance(a, dict) and SERVE_BODY_REF_KEY in a
                   for a in args):
            return args
        t0 = time.perf_counter()
        out = []
        for a in args:
            if isinstance(a, dict) and SERVE_BODY_REF_KEY in a:
                a = dict(a)
                raw = ray_tpu_torch.get(
                    ray_tpu_torch.ObjectRef(a.pop(SERVE_BODY_REF_KEY)),
                    timeout=30.0)
                a["body"] = json.loads(raw) if raw else None
            out.append(a)
        _rc.observe_phase(_rc.REPLICA_PHASE, "body_fetch",
                          time.perf_counter() - t0)
        return tuple(out)

    def _register_cancel(self, cancel_key: str | None) -> _CancelHolder:
        holder = _CancelHolder()
        if cancel_key:
            fire = False
            with self._lock:
                if self._cancelled_keys.pop(cancel_key, None) is not None:
                    fire = True  # the cancel frame beat this request here
                else:
                    self._cancels[cancel_key] = holder
            if fire:
                holder.cancel()
        return holder

    def _unregister_cancel(self, cancel_key: str | None) -> None:
        if cancel_key:
            with self._lock:
                self._cancels.pop(cancel_key, None)

    @ray_tpu_torch.method(concurrency_group="control")
    def cancel_request(self, cancel_key: str) -> bool:
        """Best-effort cancel of an in-flight request by its cancel key:
        fires the request's registered on_cancel callbacks (LLM servers
        route these into engine.abort_request) and interrupts its admission
        wait / stream loop. Unknown keys leave a tombstone so a cancel that
        overtakes its queued request still lands. Runs on the 'control'
        concurrency lane — a saturated replica must still take cancels."""
        with self._lock:
            holder = self._cancels.get(cancel_key)
            if holder is None:
                now = time.monotonic()
                self._cancelled_keys[cancel_key] = now
                for k in [k for k, t in self._cancelled_keys.items()
                          if now - t > 120.0]:
                    del self._cancelled_keys[k]
        if holder is None:
            return False
        holder.cancel()
        _rc.count_cancellation("replica")
        return True

    def _enter(self, cancel_key: str | None, deadline_ts: float | None):
        """Cross-plane admission shared by both request paths (fast-RPC
        pool threads and actor-plane threads share one
        max_ongoing_requests budget), with the PR's three refusals wired
        in: shed when the admission queue is at max_queued_requests,
        refuse once queue-wait spends the deadline budget, and interrupt
        the wait when a cancel lands. Raises WITHOUT holding the admission
        slot; on success the caller owns one slot (+ ongoing count) and
        must release both. Returns (holder, wait_s, wall_start)."""
        holder = self._register_cancel(cancel_key)
        t_q = time.perf_counter()
        w_q = time.time()
        acquired = self._admission.acquire(blocking=False)
        if not acquired:
            with self._lock:
                if 0 <= self._max_queued <= self._pending:
                    shed = True
                else:
                    shed = False
                    self._pending += 1
            if shed:
                self._unregister_cancel(cancel_key)
                _rc.count_shed("replica")
                raise RequestShedError(
                    f"deployment {self.deployment_name} replica "
                    f"{self.replica_tag}: admission queue full "
                    f"({self._pending} waiting >= max_queued_requests="
                    f"{self._max_queued})")
            try:
                if cancel_key is None and not deadline_ts:
                    self._admission.acquire()
                    acquired = True
                while not acquired:
                    if holder.cancelled:
                        raise RequestCancelledError(
                            f"request cancelled during queue wait on "
                            f"{self.deployment_name}")
                    remaining = _rc.deadline_remaining(deadline_ts)
                    if remaining is not None and remaining <= 0:
                        _rc.count_cancellation("replica")
                        raise DeadlineExceededError(
                            f"deadline expired after "
                            f"{time.perf_counter() - t_q:.3f}s queue wait "
                            f"on {self.deployment_name}")
                    acquired = self._admission.acquire(
                        timeout=0.02 if remaining is None
                        else min(0.02, remaining))
            finally:
                with self._lock:
                    self._pending -= 1
                if not acquired:
                    self._unregister_cancel(cancel_key)
        with self._lock:
            self._ongoing += 1
            self._total += 1
        _replica_ctx.model_id = None
        _replica_ctx.cancel_holder = holder
        _replica_ctx.deadline_ts = deadline_ts
        return holder, time.perf_counter() - t_q, w_q

    def _exit(self, cancel_key: str | None) -> None:
        _replica_ctx.model_id = None
        _replica_ctx.cancel_holder = None
        _replica_ctx.deadline_ts = None
        self._unregister_cancel(cancel_key)
        with self._lock:
            self._ongoing -= 1
        self._admission.release()

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       model_id: str | None = None,
                       cancel_key: str | None = None,
                       deadline_ts: float | None = None):
        args = self._unwrap_body_refs(args)
        holder, wait_s, w_q = self._enter(cancel_key, deadline_ts)
        _replica_ctx.model_id = model_id
        t0 = time.perf_counter()
        ok = True
        try:
            fn = getattr(self.user, method, None)
            if fn is None:
                raise AttributeError(
                    f"deployment {self.deployment_name} has no method {method!r}")
            return fn(*args, **kwargs)
        except BaseException:
            ok = False
            raise
        finally:
            self._exit(cancel_key)
            exec_s = time.perf_counter() - t0
            self._record_request(exec_s)
            self._record_phases(method, w_q, wait_s, exec_s, ok)

    def _record_request(self, elapsed_s: float) -> None:
        try:
            self._m_requests.inc()
            self._m_latency.observe(elapsed_s * 1e3)
        except Exception as e:  # noqa: BLE001 — must never fail a request
            logger.debug("replica %s: request metrics emit failed: %r",
                         self.replica_tag, e)

    def _record_phases(self, method: str, wall_start: float, wait_s: float,
                       exec_s: float, ok: bool) -> None:
        """Queue-wait vs execute split (always-on histograms) + one child
        span when this request's trace is active in the calling thread."""
        try:
            _rc.observe_phase(_rc.REPLICA_PHASE, "queue_wait", wait_s)
            _rc.observe_phase(_rc.REPLICA_PHASE, "execute", exec_s)
            _tracing.emit_child_span(
                f"replica:{self.deployment_name}.{method}",
                wall_start, wall_start + wait_s + exec_s, ok=ok,
                deployment=self.deployment_name, replica=self.replica_tag,
                queue_wait_s=round(wait_s, 6), execute_s=round(exec_s, 6))
        except Exception as e:  # noqa: BLE001 — must never fail a request
            logger.debug("replica %s: phase instrumentation failed: %r",
                         self.replica_tag, e)

    def handle_request_stream(self, method: str, args: tuple, kwargs: dict,
                              model_id: str | None = None,
                              cancel_key: str | None = None,
                              deadline_ts: float | None = None):
        """Streaming variant: the user method is a generator; each yielded
        item ships incrementally via the runtime's streaming-generator task
        (reference: serve replicas stream generator chunks back — replica.py).
        The admission slot is held for the stream's whole lifetime. A
        cancel landing mid-stream interrupts the loop between items and
        closes the user generator (GeneratorExit runs its finally hooks —
        the LLM servers abort their engine request there)."""
        args = self._unwrap_body_refs(args)
        holder, wait_s, w_q = self._enter(cancel_key, deadline_ts)
        _replica_ctx.model_id = model_id
        t0 = time.perf_counter()
        ok = True
        try:
            fn = getattr(self.user, method, None)
            if fn is None:
                raise AttributeError(
                    f"deployment {self.deployment_name} has no method {method!r}")
            gen = fn(*args, **kwargs)
            try:
                for item in gen:
                    if holder.cancelled:
                        raise RequestCancelledError(
                            f"request cancelled mid-stream on "
                            f"{self.deployment_name}")
                    yield item
            finally:
                # explicit close on EVERY exit (cancel, consumer gone,
                # error): the user generator's finally hooks release
                # engine slots/KV pages now, not at GC. Plain iterables
                # (a user method returning a list) have no close.
                close = getattr(gen, "close", None)
                if close is not None:
                    close()
        except BaseException:
            ok = False
            raise
        finally:
            self._exit(cancel_key)
            # latency here is the full stream duration — that IS the
            # request's occupancy of the replica
            exec_s = time.perf_counter() - t0
            self._record_request(exec_s)
            self._record_phases(method, w_q, wait_s, exec_s, ok)

    def ongoing(self) -> int:
        return self._ongoing

    def stats(self) -> dict:
        return {"replica": self.replica_tag, "ongoing": self._ongoing,
                "total": self._total}

    def reconfigure(self, user_config: dict) -> None:
        """(reference: replicas call the user's reconfigure() on user_config
        updates without restarting, serve/_private/replica.py.)"""
        fn = getattr(self.user, "reconfigure", None)
        if fn is not None:
            fn(user_config)

    @ray_tpu_torch.method(concurrency_group="control")
    def check_health(self) -> bool:
        """Controller-driven liveness probe. Dispatched through the
        'control' concurrency lane: the GCS schedules it past any backlog
        of queued data requests and the worker runs it on a dedicated
        thread pool — a saturated (but healthy) replica must answer its
        probes, or the controller would drain-and-replace it under
        ordinary heavy load."""
        fn = getattr(self.user, "check_health", None)
        if fn is not None:
            fn()
        return True

    def shutdown(self) -> None:
        self._rpc_stop = True
        if getattr(self, "_rpc_sock", None) is not None:
            try:
                self._rpc_sock.close()
            except OSError:
                pass  # already closed by the accept loop's error path
        fn = getattr(self.user, "__del__", None)
        if fn is not None:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — user teardown code
                logger.warning("replica %s: user __del__ raised during "
                               "shutdown: %r", self.replica_tag, e)
