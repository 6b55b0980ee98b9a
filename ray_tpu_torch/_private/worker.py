"""CoreWorker: the per-process runtime library embedded in driver and workers.

The port's copy of ray_tpu/_private/worker.py, the analogue of the
reference's core_worker
(reference: src/ray/core_worker/core_worker.h:170 — Put:485, Get:661,
Wait:701, SubmitTask:858, CreateActor:883, SubmitActorTask:940,
ExecuteTask:1482). One instance per process; the driver embeds one too (same
key inversion as the reference: the driver is a peer, not a thin client).
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
import time
import traceback
from typing import Any, Sequence

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_store import make_object_store
from ray_tpu_torch._private.protocol import ConnectionClosed, connect_address
from ray_tpu_torch._private.constants import (EXEC_LOOP_METHOD,
                                              TENSOR_TRANSPORT_ATTR)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    RayTaskError,
    RayTpuError,
    TaskCancelledError,
    WorkerCrashedError,
)

from ray_tpu_torch._private.ray_config import RayConfig as _RayConfig

INLINE_LIMIT = _RayConfig.get("inline_object_limit")
ARGS_INLINE_LIMIT = 4 * INLINE_LIMIT
MAX_RECON_ATTEMPTS = 4


# the process's CoreWorker, for ObjectRef lifecycle hooks (None in local
# mode and before init; distinct from _global_worker which is worker-only)
_ref_tracker = None

# thread-local capture: while serializing a value, ObjectRef.__reduce__
# appends every ref pickled inside, so stored containers can declare the
# refs they keep alive (reference: the serializer's contained-object-ids)
_reduce_capture = threading.local()


def _serialize_capturing(fn, *args):
    """Run a serialization call, returning (result, contained_ref_hexes)."""
    prev = getattr(_reduce_capture, "refs", None)
    _reduce_capture.refs = []
    try:
        out = fn(*args)
        return out, list(dict.fromkeys(_reduce_capture.refs))
    finally:
        _reduce_capture.refs = prev


def _trace_field() -> dict:
    """``{"trace_ctx": ...}`` for an outgoing spec when a trace is active
    in this task/thread, else ``{}`` (tracing off or no open trace)."""
    from ray_tpu_torch.util import tracing

    ctx = tracing.inject()
    return {"trace_ctx": ctx} if ctx else {}


class ObjectRef:
    """Handle to a (possibly pending) remote object. Refcounted: creating one
    registers a local reference, GC drops it; when a process's last local
    reference to an oid disappears the GCS is told, and an object whose
    references are all gone is freed cluster-wide.

    (reference: python/ray/includes/object_ref.pxi:37 + the distributed
    ReferenceCounter, src/ray/core_worker/reference_counter.h:43 — here the
    count is GCS-arbitered rather than owner-distributed.)
    """

    __slots__ = ("_hex", "_tracked")

    def __init__(self, hex_id: str):
        self._hex = hex_id
        tracker = _ref_tracker
        self._tracked = tracker is not None and tracker.incref(hex_id)

    def hex(self) -> str:
        return self._hex

    def __repr__(self):
        return f"ObjectRef({self._hex[:12]}…)"

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._hex == self._hex

    def __hash__(self):
        return hash(("ObjectRef", self._hex))

    def __reduce__(self):
        cap = getattr(_reduce_capture, "refs", None)
        if cap is not None:
            cap.append(self._hex)
        return (ObjectRef, (self._hex,))

    def __del__(self):
        if self._tracked:
            tracker = _ref_tracker
            if tracker is not None:
                try:
                    tracker.decref(self._hex)
                except Exception:
                    pass  # interpreter/worker teardown


class ObjectRefGenerator:
    """Iterator over the ObjectRefs of a `num_returns="streaming"` task;
    refs arrive as the producer yields, with producer-side backpressure.

    (reference: python/ray/_raylet.pyx:299 ObjectRefGenerator /
    _private/object_ref_generator.py — the substrate of Ray Data map tasks.)
    """

    def __init__(self, task_id: str, worker: "CoreWorker"):
        self._task_id = task_id
        self._worker = worker
        self._index = 0
        self._done = False

    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        return self.next_item()

    def next_item(self, timeout: float = 86400.0) -> ObjectRef:
        """next() with an explicit timeout: raises GetTimeoutError if the
        producer yields nothing in time (a hung — not dead — producer
        blocks plain next() indefinitely, like the reference's generators)."""
        if self._done:
            raise StopIteration
        reply = self._worker.rpc(
            {"type": "stream_next", "task_id": self._task_id,
             "index": self._index}, timeout=timeout)
        if reply.get("done"):
            self._done = True
            err = reply.get("error")
            if err is not None:
                raise ser.loads(err)
            raise StopIteration
        self._index += 1
        # consumption signal releases producer backpressure
        self._worker.send_no_reply(
            {"type": "stream_consumed", "task_id": self._task_id,
             "index": self._index})
        return ObjectRef(reply["oid"])

    def completed(self) -> bool:
        return self._done

    def __del__(self):
        try:
            self._worker.send_no_reply(
                {"type": "stream_release", "task_id": self._task_id})
        except Exception:
            pass


class _RefMarker:
    """Placeholder for a top-level ObjectRef argument; resolved pre-execution."""

    __slots__ = ("hex",)

    def __init__(self, hex_id: str):
        self.hex = hex_id


class _Future:
    __slots__ = ("event", "value")

    def __init__(self):
        self.event = threading.Event()
        self.value = None

    def set(self, value):
        self.value = value
        self.event.set()

    def wait(self, timeout=None):
        if not self.event.wait(timeout):
            raise GetTimeoutError("timed out waiting for reply")
        return self.value


class CoreWorker:
    def __init__(self, address: str, session_id: str | None, kind: str):
        self.kind = kind
        self.wid = WorkerID().hex()
        # named actors are scoped by namespace (reference: ray namespaces).
        # The DRIVER's namespace comes from init(namespace=...); inside a
        # task/actor call the SUBMITTER's namespace (spec["caller_ns"]) is
        # active, so nested named-actor creation/lookup lands where the
        # submitting driver expects.
        self.namespace = os.environ.get("RAY_TPU_TORCH_NAMESPACE") or "default"
        if address.startswith("/"):
            address = f"unix:{address}"
        self._address = address
        self._disconnecting = False
        self.conn = connect_address(address)
        self._rid = itertools.count(1)
        self._pending: dict[int, _Future] = {}
        self._pending_lock = threading.Lock()
        self.exec_queue: queue.SimpleQueue = queue.SimpleQueue()
        self._memory: dict[str, Any] = {}
        self._plasma_refs: dict[str, Any] = {}
        self._obj_waits: dict[str, _Future] = {}  # oid → outstanding wait future
        self.actors: dict[str, Any] = {}  # actor instances hosted by this process
        self._actor_pools: dict[str, Any] = {}  # actor_id → ThreadPoolExecutor
        self.current_actor_id: str | None = None  # one actor per process
        self._task_ctx = threading.local()  # per-thread: concurrent actors
        self._alive = True
        self.node_id = os.environ.get("RAY_TPU_TORCH_NODE_ID", "node-0")
        self.host_id = os.environ.get("RAY_TPU_TORCH_HOST_ID", "host-0")
        self._recv_thread = threading.Thread(target=self._recv_loop, daemon=True, name="cw-recv")
        self._recv_thread.start()
        if session_id is None:
            # joining an existing cluster by address: learn the session first
            session_id = self.rpc({"type": "get_session"})["session_id"]
        self.session_id = session_id
        # this host's store namespace: followers get their own (a real second
        # machine is naturally disjoint; on one box the env keeps it honest)
        self.store = make_object_store(
            os.environ.get("RAY_TPU_TORCH_STORE_NS", session_id))
        if hasattr(self.store, "on_evict"):
            # arena backend: a put that evict-spills LRU victims to disk
            # must tell the GCS those copies left tmpfs, or its per-host
            # accounting and the object directory's tier info go stale
            self.store.on_evict = self._report_evictions
        self._reported_evictions = 0  # store.evictions already counted
        self._fetcher = None  # lazy ObjectFetcher for cross-host pulls
        self._stream_acks: dict[str, int] = {}  # producing streams: consumed idx
        self._stream_events: dict[str, threading.Event] = {}
        self._stream_cancelled: set[str] = set()
        # this process's runtime-env fingerprint: set at spawn, used by the
        # scheduler to match tasks to compatible workers (reference: worker
        # pool keyed by runtime-env hash, worker_pool.h:280)
        self.renv_hash = ""
        renv_json = os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV")
        if renv_json:
            import json as _json

            from ray_tpu_torch.runtime_env import env_hash as _env_hash

            self.renv_hash = _env_hash(_json.loads(renv_json))
        self._renv_cache: dict[str, tuple[dict, str]] = {}
        self.default_runtime_env: dict | None = None  # job-level default
        from ray_tpu_torch._private.accelerators import current_worker_gpus
        from ray_tpu_torch._private.ray_config import RayConfig as _RC

        # direct-dispatch plane (reference: leased-worker task submission,
        # normal_task_submitter.h:81): workers serve leased callers on a
        # dedicated socket; every process can hold leases as a caller
        self._direct_enabled = _RC.get("direct_dispatch")
        self.direct_server = None
        if kind == "worker" and self._direct_enabled:
            from ray_tpu_torch._private.direct import DirectServer

            self.direct_server = DirectServer(self)
        # owner-side records for direct-task results: oid → entry; results
        # that never leave this process never touch the GCS at all
        self._owned: dict[str, dict] = {}
        self._owned_lock = threading.RLock()
        self._loc_cache: dict[str, tuple] = {}  # oid → (host, size) once ready
        self._status_cache: dict[str, str] = {}  # oid → "ready"|"error"
        self._flight_holds: dict[str, list[str]] = {}  # direct tid → held oids
        self._direct = None  # DirectDispatcher, created lazily on first use
        # deserialized task functions keyed by content sha (or raw blob for
        # legacy specs); shas this process already uploaded to the cluster
        # function store (reference: the worker's function table)
        self._func_cache: dict = {}
        self._shipped_fns: dict[str, float] = {}  # sha → last-verified ts
        self._submit_seq = 0  # every Nth GCS submit is synchronous

        reply = self.rpc({"type": "register", "wid": self.wid, "kind": kind,
                          "pid": os.getpid(), "node_id": self.node_id,
                          "host": self.host_id, "renv_hash": self.renv_hash,
                          "gpus": current_worker_gpus(),
                          **({"direct_addr": self.direct_server.address}
                             if self.direct_server else {})})
        if reply.get("ok") is False:
            raise RayTpuError(f"registration rejected: {reply.get('error')}")
        # reference counting: per-process local counts, process-level
        # transitions batched to the GCS (reference: reference_counter.h:43)
        self._local_refs: dict[str, int] = {}
        # reentrant: a cyclic-GC run triggered by an allocation inside
        # incref/decref can finalize an ObjectRef on the same thread, whose
        # __del__ re-enters decref while the lock is held
        self._ref_lock = threading.RLock()
        self._flush_order_lock = threading.Lock()
        self._reconnect_lock = threading.Lock()
        self._ref_deltas: dict[str, int] = {}
        from ray_tpu_torch._private.ray_config import RayConfig

        self._gc_enabled = RayConfig.get("auto_gc")
        self._ref_flush_thread = threading.Thread(
            target=self._ref_flush_loop, daemon=True, name="cw-refs")
        self._ref_flush_thread.start()
        global _ref_tracker
        _ref_tracker = self

    # -------------------------------------------------------------- refcounts

    def _gcs_invisible(self, oid: str) -> bool:
        """True for direct-task results that never left this process: the
        GCS has no entry for them, so ref transitions would be dropped there
        anyway — skipping them keeps the hot path free of GCS traffic."""
        ent = self._owned.get(oid)
        return (ent is not None and not ent.get("published")
                and ent.get("status") != "redirect")

    def incref(self, oid: str) -> bool:
        if not self._gc_enabled:
            return False
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) + 1
            self._local_refs[oid] = n
            if n == 1 and not self._gcs_invisible(oid):
                # first local ref in this process
                self._ref_deltas[oid] = self._ref_deltas.get(oid, 0) + 1
        return True

    def decref(self, oid: str) -> None:
        drop_cache = False
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n <= 0:
                self._local_refs.pop(oid, None)
                if not self._gcs_invisible(oid):
                    self._ref_deltas[oid] = self._ref_deltas.get(oid, 0) - 1
                drop_cache = True
            else:
                self._local_refs[oid] = n
        if drop_cache:
            self._memory.pop(oid, None)
            self._plasma_refs.pop(oid, None)
            self._obj_waits.pop(oid, None)
            with self._owned_lock:
                ent = self._owned.get(oid)
                # in-flight entries stay: the reply handler needs them (they
                # die with the flight if the user already dropped the ref)
                if ent is not None and ent.get("status") != "pending":
                    self._owned.pop(oid, None)

    def _ref_flush_loop(self):
        from ray_tpu_torch._private.ray_config import RayConfig

        cfg = RayConfig.instance()
        last_metrics = 0.0
        while self._alive:
            time.sleep(cfg.ref_flush_interval_s)
            self._flush_ref_deltas()
            now = time.time()
            if now - last_metrics >= cfg.metrics_report_interval_s:
                last_metrics = now
                self._flush_telemetry()

    def _report_evictions(self, oids: list) -> None:
        """on_evict hook (arena backend): fire-and-forget accounting update
        so GCS `tier_of`/tmpfs bookkeeping track local evict-to-spill."""
        try:
            self.send_no_reply({"type": "objects_evicted",
                                "host": self.host_id, "oids": list(oids)})
        except Exception:
            pass  # accounting drift is recoverable; the put must not fail

    def _record_store_metrics(self, _met) -> None:
        """Arena accounting → exported gauges/counter. Gauges carry a host
        tag — each host has its own arena, and an unlabeled series would
        flip-flop between hosts at newest-source-wins aggregation; within
        one host every process reports the same shared-header value. The
        eviction counter is per-process (this process's evict-spills) so
        source summation stays correct."""
        store = self.store
        if not hasattr(store, "used"):
            return  # file backend: no bounded arena to meter
        tags = {"host": self.host_id}
        _met.get_or_create(
            _met.Gauge, "ray_tpu_object_store_used",
            "bytes live in this host's shm arena",
        ).set(float(store.used()), tags=tags)
        _met.get_or_create(
            _met.Gauge, "ray_tpu_object_store_capacity",
            "shm arena data-region capacity in bytes",
        ).set(float(store.capacity()), tags=tags)
        delta = store.evictions - self._reported_evictions
        if delta > 0:
            _met.get_or_create(
                _met.Counter, "ray_tpu_object_store_evictions_total",
                "objects this process evict-spilled from the arena to disk",
            ).inc(delta, tags=tags)
            self._reported_evictions = store.evictions

    def _flush_telemetry(self):
        """Ship user metrics + task/profile events to the GCS (reference:
        task_event_buffer.h batching; metrics agent reporting)."""
        try:
            from ray_tpu_torch._private import task_events as _te
            from ray_tpu_torch.util import metrics as _met

            self._record_store_metrics(_met)
            events = _te.drain()
            if events:
                for ev in events:
                    ev["worker_id"] = self.wid
                self.send_no_reply({"type": "events_report", "events": events})
            reqs = _te.drain_request_log()
            if reqs:
                # serve flight-recorder entries -> the GCS request log
                # (bounded per flush by the ring size: only entries still
                # in the last-N ring ship)
                self.send_no_reply({"type": "request_log_report",
                                    "source": self.wid, "entries": reqs})
            from ray_tpu_torch._private import events as _cev
            cevs = _cev.drain()
            if cevs:
                # controller-side cluster events (serve/train controllers
                # run as actors in this process) -> the GCS event ring
                self.send_no_reply({"type": "cluster_events_report",
                                    "source": self.wid, "events": cevs})
            snap = _met.snapshot()
            if snap:
                self.send_no_reply({"type": "metrics_report",
                                    "source": self.wid, "metrics": snap})
        except ConnectionClosed:
            pass
        except Exception:
            pass  # telemetry must never take down the worker

    def _flush_ref_deltas(self):
        # _flush_order_lock spans snapshot AND send: without it, the periodic
        # flusher could snapshot deltas, get preempted, and an exec thread's
        # pre-task_done flush would see an empty dict and emit task_done
        # before the snapshot's +1s hit the wire (breaking the borrower
        # ordering guarantee in execute_task)
        with self._flush_order_lock:
            with self._ref_lock:
                deltas = dict(self._ref_deltas)
                self._ref_deltas.clear()
            # zero entries still ship: a +1/-1 that cancelled within one
            # flush window must still tell the GCS the object was referenced
            # (and is no longer) — otherwise it can never become freeable
            if deltas:
                try:
                    self.send_no_reply({"type": "ref_delta", "deltas": deltas})
                except ConnectionClosed:
                    pass

    # ------------------------------------------------------------------- rpc

    def rpc(self, msg: dict, timeout: float | None = 120.0) -> dict:
        rid = next(self._rid)
        msg["rid"] = rid
        fut = _Future()
        with self._pending_lock:
            self._pending[rid] = fut
        self.conn.send(msg)
        try:
            return fut.wait(timeout)
        finally:
            with self._pending_lock:
                self._pending.pop(rid, None)

    def rpc_async(self, msg: dict) -> _Future:
        rid = next(self._rid)
        msg["rid"] = rid
        fut = _Future()
        with self._pending_lock:
            self._pending[rid] = fut
        self.conn.send(msg)
        return fut

    def send_no_reply(self, msg: dict) -> None:
        self.conn.send(msg)

    def _recv_loop(self):
        try:
            while True:
                msg = self.conn.recv()
                if "rid" in msg and "type" not in msg:
                    with self._pending_lock:
                        fut = self._pending.pop(msg["rid"], None)
                    if fut is not None:
                        fut.set(msg)
                elif msg.get("type") == "exec":
                    self.exec_queue.put(msg["spec"])
                elif msg.get("type") == "exit":
                    self.exec_queue.put(None)
                elif msg.get("type") == "die":
                    # force-cancel: terminate immediately (reference: force-
                    # cancelled tasks kill their executor process)
                    os._exit(1)
                elif msg.get("type") == "kill_actor":
                    if msg["aid"] in self.actors:
                        os._exit(0)
                elif msg.get("type") == "log_line":
                    # remote-host worker logs republished via GCS
                    print(f"({msg['source']}) {msg['line']}", file=sys.stderr)
                elif msg.get("type") == "stream_ack":
                    # consumer progress: release producer backpressure
                    tid = msg["task_id"]
                    self._stream_acks[tid] = max(
                        self._stream_acks.get(tid, 0), msg["consumed"])
                    ev = self._stream_events.get(tid)
                    if ev is not None:
                        ev.set()
                elif msg.get("type") == "dump_stacks":
                    # on-demand live inspection (reference capability:
                    # dashboard reporter's py-spy/memray on-demand profiling)
                    import traceback as _tb

                    frames = sys._current_frames()
                    names = {t.ident: t.name for t in threading.enumerate()}
                    parts = []
                    for tid, frame in frames.items():
                        parts.append(f"--- thread {names.get(tid, tid)} ---")
                        parts.append("".join(_tb.format_stack(frame)))
                    try:
                        self.send_no_reply({"type": "stacks_reply",
                                            "token": msg["token"],
                                            "text": "\n".join(parts)})
                    except ConnectionClosed:
                        pass
                elif msg.get("type") == "profile":
                    # sampling profiler: collect collapsed stacks at `hz`
                    # for `duration_s`, reply via the stacks relay
                    def _profile(m=msg):
                        import collections as _c
                        import traceback as _tb

                        duration = min(float(m.get("duration_s", 5.0)), 60.0)
                        period = 1.0 / max(1.0, min(float(m.get("hz", 50.0)), 200.0))
                        counts: _c.Counter = _c.Counter()
                        samples = 0
                        end = time.monotonic() + duration
                        me = threading.get_ident()
                        while time.monotonic() < end:
                            for tid, frame in sys._current_frames().items():
                                if tid == me:
                                    continue
                                stack = []
                                f = frame
                                while f is not None:
                                    co = f.f_code
                                    stack.append(f"{co.co_name} "
                                                 f"({co.co_filename.rsplit('/', 1)[-1]}"
                                                 f":{f.f_lineno})")
                                    f = f.f_back
                                counts[";".join(reversed(stack))] += 1
                            samples += 1
                            time.sleep(period)
                        lines = [f"{n:6d}  {st}" for st, n in counts.most_common(40)]
                        text = (f"# {samples} samples over {duration:.1f}s "
                                f"(collapsed stacks, hottest first)\n"
                                + "\n".join(lines))
                        try:
                            self.send_no_reply({"type": "stacks_reply",
                                                "token": m["token"],
                                                "text": text})
                        except ConnectionClosed:
                            pass

                    threading.Thread(target=_profile, daemon=True,
                                     name="profiler").start()
                elif msg.get("type") == "free_device_tensors":
                    from ray_tpu_torch.experimental import device_objects

                    device_objects.free_device_tensors(
                        msg.get("tensor_ids", ()), worker=self)
                elif msg.get("type") == "do_export_tensor":
                    # device objects: another process needs one of our
                    # tensors; the export runs off the recv thread (it
                    # makes the device→host copy)
                    def _export(m=msg):
                        from ray_tpu_torch.experimental import device_objects

                        try:
                            oid = device_objects.export_to_store(
                                m["tensor_id"], self)
                            self.send_no_reply(
                                {"type": "export_tensor_done",
                                 "token": m["token"], "oid": oid})
                        except Exception as e:  # noqa: BLE001
                            try:
                                self.send_no_reply(
                                    {"type": "export_tensor_done",
                                     "token": m["token"], "oid": None,
                                     "error": repr(e)})
                            except ConnectionClosed:
                                pass

                    threading.Thread(target=_export, daemon=True,
                                     name="rdt-export").start()
                elif msg.get("type") == "stream_cancel":
                    # consumer released the generator: stop producing
                    tid = msg["task_id"]
                    self._stream_cancelled.add(tid)
                    ev = self._stream_events.get(tid)
                    if ev is not None:
                        ev.set()
                elif msg.get("type") == "lease_revoke":
                    # GCS has pending demand this leased worker could serve
                    if self._direct is not None:
                        try:
                            self._direct.revoke(msg["wid"])
                        except Exception:
                            pass
                elif msg.get("type") == "drain_notice":
                    # this worker's node is DRAINING (preemption notice /
                    # scale-down): record it process-wide so train sessions
                    # observe the "save a grace checkpoint now" flag at the
                    # next step boundary
                    _set_drain(msg)
        except ConnectionClosed:
            if self.kind == "driver" and not self._disconnecting:
                # drivers outlive a GCS restart: retry connect + re-register
                # within the configured window (reference: retryable grpc
                # clients + GCS fault tolerance, retryable_grpc_client.h).
                # If another thread already owns the reconnect, this stale
                # recv thread just exits — it must NOT mark the worker dead.
                if not self._reconnect_lock.acquire(blocking=False):
                    return
                try:
                    if self._try_reconnect():
                        return  # a fresh recv thread owns the new connection
                finally:
                    self._reconnect_lock.release()
            self._alive = False
            self.exec_queue.put(None)
            with self._pending_lock:
                for fut in self._pending.values():
                    fut.set({"ok": False, "error": "connection to GCS lost"})
                self._pending.clear()

    def _try_reconnect(self) -> bool:
        """Dial + re-register on a fresh connection. The register handshake
        runs synchronously on the candidate socket (no recv thread until it
        succeeds), so a drop mid-handshake can't spawn competing reconnect
        loops. Caller holds self._reconnect_lock."""
        from ray_tpu_torch._private.accelerators import current_worker_gpus
        from ray_tpu_torch._private.ray_config import RayConfig

        window = RayConfig.get("gcs_reconnect_timeout_s")
        # in-flight RPCs died with the old connection; fail them so callers
        # can retry at their level (their rids are unknown to the new GCS)
        with self._pending_lock:
            for fut in self._pending.values():
                fut.set({"ok": False, "error": "GCS connection reset; retry"})
            self._pending.clear()
        deadline = time.monotonic() + window
        while time.monotonic() < deadline and not self._disconnecting:
            conn = None
            try:
                conn = connect_address(self._address, timeout=2.0)
                rid = next(self._rid)
                conn.sock.settimeout(10.0)
                conn.send({"type": "register", "rid": rid, "wid": self.wid,
                           "kind": self.kind, "pid": os.getpid(),
                           "node_id": self.node_id, "host": self.host_id,
                           "renv_hash": self.renv_hash,
                           "gpus": current_worker_gpus()})
                reply = conn.recv()
                while reply.get("rid") != rid:
                    reply = conn.recv()  # skip stray non-handshake frames
                if not reply.get("ok"):
                    conn.close()
                    return False
                conn.sock.settimeout(None)
                self.conn = conn
                self._recv_thread = threading.Thread(
                    target=self._recv_loop, daemon=True, name="cw-recv")
                self._recv_thread.start()
                return True
            except (ConnectionClosed, OSError):
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:
                        pass
                time.sleep(0.2)
        return False

    # ----------------------------------------------------------------- tasks

    def _serialize_args(self, args: tuple, kwargs: dict) -> tuple[dict, list[str]]:
        deps: list[str] = []

        def mark(v):
            if isinstance(v, ObjectRef):
                deps.append(v.hex())
                return _RefMarker(v.hex())
            return v

        marked_args = tuple(mark(a) for a in args)
        marked_kwargs = {k: mark(v) for k, v in kwargs.items()}
        # refs nested inside args (top-level ones became _RefMarkers/deps):
        # the GCS holds them until the task completes
        payload, ref_holds = _serialize_capturing(
            ser.dumps, (marked_args, marked_kwargs))
        spec_part: dict = {}
        if ref_holds:
            spec_part["ref_holds"] = ref_holds
        if len(payload) > ARGS_INLINE_LIMIT:
            oid = ObjectID.for_put().hex()
            tier = self.store.put_parts(oid, [payload], len(payload))
            # pinned: no user ref ever exists for an args blob — the GCS
            # frees it with the task's retained lineage (or at actor death)
            self.send_no_reply({"type": "object_put", "oid": oid, "where": "shm",
                                "size": len(payload), "host": self.host_id,
                                "pin": True, "tier": tier})
            spec_part["args_oid"] = oid
        else:
            spec_part["args"] = payload
        return spec_part, deps

    def _prepare_runtime_env(self, runtime_env) -> tuple[dict, str]:
        """Normalize + package a runtime_env once per distinct input
        (reference: URI-cached packaging, runtime_env/packaging.py)."""
        if not runtime_env:
            runtime_env = self.default_runtime_env
            if not runtime_env:
                return {}, ""
        import json as _json

        from ray_tpu_torch import runtime_env as renv_mod

        key = _json.dumps(runtime_env, sort_keys=True, default=str)
        cached = self._renv_cache.get(key)
        if cached is None:
            norm = renv_mod.package(runtime_env, self.kv_put, self.kv_get)
            cached = (norm, renv_mod.env_hash(norm))
            self._renv_cache[key] = cached
        return cached

    def submit_task(
        self,
        func_blob: bytes,
        args: tuple,
        kwargs: dict,
        *,
        func_sha: str | None = None,
        num_returns: int = 1,
        resources: dict | None = None,
        max_retries: int = 0,
        name: str = "",
        strategy: dict | None = None,
        runtime_env: dict | None = None,
    ) -> list[ObjectRef]:
        task_id = TaskID().hex()
        spec_part, deps = self._serialize_args(args, kwargs)
        renv, rhash = self._prepare_runtime_env(runtime_env)
        # refs nested in args may be this process's unpublished direct-task
        # results: the GCS (and any borrower) must be able to resolve them
        self._publish_owned(spec_part.get("ref_holds", ()))
        # submitter's refs must be counted at the GCS before the task can
        # possibly complete: otherwise a borrower's death could free an
        # object whose only counted ref was the borrower's (the submitter's
        # +1 still in its 0.2s flush window)
        self._flush_ref_deltas()
        fn_field: dict
        if func_sha is not None:
            # content-addressed function store (reference: the GCS function
            # table with export-once semantics, function_manager.py): the
            # blob uploads once per cluster; every spec carries 20 bytes
            now = time.monotonic()
            # re-probe periodically even when memoized: the GCS function
            # store evicts past its budget, and a permanently-memoized sha
            # would then fail every future task using it
            if now - self._shipped_fns.get(func_sha, -1e9) > 60.0:
                key = "fn:" + func_sha
                # metadata-only existence probe — kv_get would pull the
                # whole blob just to discard it
                if not self.kv_keys(key):
                    self.kv_put(key, func_blob)
                self._shipped_fns[func_sha] = now
            fn_field = {"func_sha": func_sha}
        else:
            fn_field = {"func": func_blob}
        spec = {
            "kind": "task",
            "task_id": task_id,
            **fn_field,
            "deps": deps,
            "num_returns": num_returns,
            "resources": resources or {"CPU": 1.0},
            "max_retries": max_retries,
            "retries_used": 0,
            "name": name,
            "strategy": strategy,
            "caller_ns": self.effective_namespace(),
            **({"runtime_env": renv, "renv_hash": rhash} if rhash else {}),
            **_trace_field(),
            **spec_part,
        }
        # typed-spec validation at the submission boundary (reference:
        # TaskSpecification — malformed options fail HERE, at the caller)
        from ray_tpu_torch._private.task_spec import validate_task

        validate_task(spec)
        if (self._direct_enabled and strategy is None
                and isinstance(num_returns, int)
                and self._try_submit_direct(spec)):
            return [ObjectRef(f"{task_id}r{i:04d}") for i in range(num_returns)]
        self._prepare_gcs_deps(deps)
        # fire-and-forget (reference: .remote() never blocks on the control
        # plane); every Nth submit is synchronous so a flood of submissions
        # stays bounded by what the GCS has actually admitted
        self._submit_seq += 1
        if self._submit_seq % 512 == 0:
            self.rpc({"type": "submit_task", "spec": spec})
        else:
            self.send_no_reply({"type": "submit_task", "spec": spec})
        if num_returns == "streaming":
            return ObjectRefGenerator(task_id, self)
        return [ObjectRef(f"{task_id}r{i:04d}") for i in range(num_returns)]

    def submit_cross_lang_task(self, func_name: str, args: list, *,
                               lang: str, resources: dict | None = None):
        """Submit a task for a cross-language worker: args/results are
        JSON values, functions are referenced by NAME (reference: the
        C++/Java worker APIs call registered functions cross-language)."""
        task_id = TaskID().hex()
        spec = {
            "kind": "task",
            "task_id": task_id,
            "lang": lang,
            "func_name": func_name,
            "args": args,
            "deps": [],
            "num_returns": 1,
            "resources": resources or {"CPU": 1.0},
            "max_retries": 0,
            "retries_used": 0,
            "name": f"{lang}:{func_name}",
            "strategy": None,
        }
        # always the GCS path: leases/direct push are Python-worker planes
        self.rpc({"type": "submit_task", "spec": spec})
        return ObjectRef(f"{task_id}r0000")

    # -------------------------------------------------------- direct path
    # Lease-based caller→worker submission (reference: leased-worker task
    # pushes, normal_task_submitter.h:81; locality via lease_policy.h).

    def _dispatcher(self):
        if self._direct is None:
            from ray_tpu_torch._private.direct import DirectDispatcher

            self._direct = DirectDispatcher(self)
        return self._direct

    def _classify_deps(self, deps):
        """Decide direct-eligibility from dependency state. Returns None
        (→ GCS path) or (inline_deps, required_lease, prefer_host)."""
        inline_deps: dict[str, bytes] = {}
        required_lease = None
        prefer_host = None
        best = -1
        disp = self._direct
        promised: list[str] = []  # sent after _owned_lock is released
        try:
            for d in deps:
                with self._owned_lock:
                    ent = self._owned.get(d)
                    if ent is not None:
                        st = ent.get("status")
                        if st == "pending":
                            # chain: runnable only on the dep's own lease (the
                            # worker computes the dep first, in order)
                            lease = disp.by_wid.get(ent.get("lease") or "") if disp else None
                            if lease is None or lease.dead or (
                                    required_lease is not None
                                    and lease is not required_lease):
                                return None
                            required_lease = lease
                            if not ent.get("publish_on_done"):
                                # safety net: if anything else ends up waiting
                                # on this oid at the GCS, the publish will come
                                ent["publish_on_done"] = True
                                self.incref(d)
                                promised.append(d)
                            continue
                        if st == "redirect":
                            return None  # GCS owns this task now
                        if st == "error":
                            return None  # error propagation is the GCS path's job
                        if ent.get("where") == "inline":
                            if not ent.get("published"):
                                inline_deps[d] = ent["inline"]
                            continue
                        if ent.get("size", 0) > best:
                            best, prefer_host = ent["size"], ent.get("host")
                        continue
                if d in self._memory or d in self._plasma_refs:
                    continue  # materialized locally → ready cluster-wide
                lc = self._loc_cache.get(d)
                if lc is None:
                    return None  # unknown readiness → let the GCS queue it
                host, size = lc
                if host is not None and size > best:
                    best, prefer_host = size, host
            return inline_deps, required_lease, prefer_host
        finally:
            # let the GCS fail the stub if this process dies before
            # delivering the promised publish
            for d in promised:
                self.send_no_reply({"type": "will_publish",
                                    "oid": d, "wid": self.wid})

    def _prepare_gcs_deps(self, deps):
        """Before a GCS-path submit: make every dep resolvable there."""
        self._publish_owned(deps)

    def _publish_owned(self, oids):
        """Ensure this process's direct-task results are visible at the GCS
        (called whenever such a ref escapes this process)."""
        for oid in oids:
            msg = None
            with self._owned_lock:
                ent = self._owned.get(oid)
                if ent is None or ent.get("published"):
                    continue
                st = ent.get("status")
                if st == "pending":
                    if not ent.get("publish_on_done"):
                        ent["publish_on_done"] = True
                        self.incref(oid)
                        # let the GCS fail the stub if this process dies
                        # before delivering the promised publish (sent
                        # outside the lock, below)
                        msg = {"type": "will_publish", "oid": oid,
                               "wid": self.wid}
                elif st == "redirect":
                    continue
                else:
                    # flip to GCS-visible atomically with re-emitting the
                    # suppressed +1 (incref/decref consult _gcs_invisible
                    # under _ref_lock, so holding it here closes the race —
                    # same pattern as _redirect_to_gcs)
                    with self._ref_lock:
                        ent["published"] = True
                        if self._local_refs.get(oid, 0) > 0:
                            self._ref_deltas[oid] = self._ref_deltas.get(oid, 0) + 1
                    if ent.get("where") == "inline":
                        msg = {"type": "object_put", "oid": oid, "where": "inline",
                               "inline": ent["inline"], "size": ent.get("size", 0),
                               "is_error": st == "error",
                               "contained": ent.get("contained") or None}
            if msg is not None:
                self.send_no_reply(msg)

    def _try_submit_direct(self, spec: dict) -> bool:
        disp = self._dispatcher()
        cls = self._classify_deps(spec.get("deps", ()))
        if cls is None:
            return False
        inline_deps, required_lease, prefer_host = cls
        from ray_tpu_torch._private.direct import shape_key

        key = shape_key(spec["resources"], spec.get("renv_hash", ""))
        if inline_deps:
            spec["inline_deps"] = inline_deps
        spec["_direct"] = True  # task events carry this so GCS counters see it
        tid = spec["task_id"]
        holds = list(spec.get("deps", ())) + list(spec.get("ref_holds", ()))
        for d in holds:
            self.incref(d)
        self._flight_holds[tid] = holds
        with self._owned_lock:
            for i in range(spec["num_returns"]):
                self._owned[f"{tid}r{i:04d}"] = {
                    "status": "pending", "fut": _Future(), "lease": None,
                    "task_id": tid, "published": False}
        spec.pop("strategy", None)
        if not disp.submit_or_queue(key, spec, spec["resources"],
                                    spec.get("renv_hash", ""), prefer_host,
                                    required_lease):
            # no pool for this shape: roll back, the GCS path runs it
            for d in self._flight_holds.pop(tid, ()):
                self.decref(d)
            with self._owned_lock:
                for i in range(spec["num_returns"]):
                    self._owned.pop(f"{tid}r{i:04d}", None)
            spec.pop("inline_deps", None)
            spec.pop("_direct", None)  # GCS path counts it; avoid doubling
            return False
        return True

    def _note_direct_lease(self, spec: dict, wid: str) -> None:
        """Record which lease a direct spec was pushed to (dep-chaining)."""
        tid = spec["task_id"]
        with self._owned_lock:
            for i in range(spec["num_returns"]):
                ent = self._owned.get(f"{tid}r{i:04d}")
                if ent is not None:
                    ent["lease"] = wid

    def _direct_cancelled_local(self, spec: dict) -> None:
        """A spec cancelled straight out of the caller's local queue."""
        for d in self._flight_holds.pop(spec["task_id"], ()):
            self.decref(d)
        publish_later: list[str] = []
        with self._owned_lock:
            self._owned_fail_locked(
                spec, TaskCancelledError("task was cancelled"), publish_later)
        self._publish_owned(publish_later)
        for oid in publish_later:
            self.decref(oid)

    def _redirect_to_gcs(self, spec: dict) -> None:
        """Hand a direct spec over to the GCS path (lease pool collapsed or
        worker-death retry): its return objects become GCS-owned."""
        tid = spec["task_id"]
        publish_later: list[str] = []
        # deps whose blobs ride in inline_deps were never published; the GCS
        # gates dispatch on their readiness, so publish them now
        self._publish_owned(spec.get("deps", ()))
        with self._owned_lock:
            for i in range(spec["num_returns"]):
                oid = f"{tid}r{i:04d}"
                ent = self._owned.get(oid)
                if ent is None:
                    continue
                if ent.pop("publish_on_done", False):
                    self.decref(oid)
                # flip to GCS-visible atomically with re-emitting the
                # suppressed +1 (decref takes _ref_lock before consulting
                # _gcs_invisible, so holding it here closes the race)
                with self._ref_lock:
                    ent["status"] = "redirect"
                    if self._local_refs.get(oid, 0) > 0:
                        self._ref_deltas[oid] = self._ref_deltas.get(oid, 0) + 1
                ent["fut"].set({"ready": False, "redirect": True})
        spec["strategy"] = None
        spec.pop("_cancelled", None)
        spec.pop("_direct", None)  # the GCS path counts it from here on
        try:
            self.rpc({"type": "submit_task", "spec": spec})
        except Exception:
            with self._owned_lock:
                # entries are "redirect" now; recreate minimal error records
                for i in range(spec["num_returns"]):
                    oid = f"{tid}r{i:04d}"
                    if oid in self._owned:
                        self._owned.pop(oid)
            # the GCS is gone: getters will fail on their own RPCs
        for d in self._flight_holds.pop(tid, ()):
            self.decref(d)

    def _on_direct_done(self, lease, spec: dict, done: dict):
        tid = spec["task_id"]
        err = done.get("error")
        contained = done.get("contained") or {}
        published = set(done.get("published") or ())
        publish_later: list[str] = []
        with self._owned_lock:
            if done.get("cancelled"):
                self._owned_fail_locked(
                    spec, TaskCancelledError("task was cancelled"),
                    publish_later)
            else:
                for res in done.get("results") or ():
                    oid, where, inline, size = res[:4]
                    ent = self._owned.get(oid)
                    if ent is None:
                        continue  # every ref already dropped
                    was_published = oid in published
                    ent.update(
                        status="error" if err is not None else "ready",
                        where=where, inline=inline, size=size,
                        host=lease.host,
                        contained=list(contained.get(oid) or ()))
                    if was_published:
                        # worker registered it at the GCS (shm/contained):
                        # flip visibility and surface this process's
                        # suppressed refs atomically (see _redirect_to_gcs)
                        with self._ref_lock:
                            ent["published"] = True
                            if self._local_refs.get(oid, 0) > 0:
                                self._ref_deltas[oid] = \
                                    self._ref_deltas.get(oid, 0) + 1
                    else:
                        ent["published"] = False
                    if ent.pop("publish_on_done", False):
                        publish_later.append(oid)
                    ent["fut"].set({"ready": True})
        for d in self._flight_holds.pop(tid, ()):
            self.decref(d)
        self._publish_owned(publish_later)
        for oid in publish_later:
            self.decref(oid)  # the publish_on_done guard ref

    def _owned_fail_locked(self, spec: dict, exc, publish_later: list):
        """Mark a direct task's return objects errored (owned-side analogue
        of the GCS's _fail_task_objects). Caller holds _owned_lock."""
        blob = ser.dumps(exc)
        tid = spec["task_id"]
        for i in range(spec["num_returns"]):
            oid = f"{tid}r{i:04d}"
            ent = self._owned.get(oid)
            if ent is None:
                continue
            ent.update(status="error", where="inline", inline=blob,
                       size=len(blob), contained=[], published=False)
            if ent.pop("publish_on_done", False):
                publish_later.append(oid)
            ent["fut"].set({"ready": True})

    def _direct_task_failed(self, spec: dict, lease):
        """The leased worker died with this spec in flight."""
        tid = spec["task_id"]
        publish_later: list[str] = []
        if spec.pop("_cancelled", False):
            for d in self._flight_holds.pop(tid, ()):
                self.decref(d)
            with self._owned_lock:
                self._owned_fail_locked(
                    spec, TaskCancelledError("task was cancelled"),
                    publish_later)
        elif (spec.get("retries_used", 0) < spec.get("max_retries", 0)
              and self._alive):
            # hand the retry to the GCS: it owns queuing, spawn, and any
            # further retries (reference: task resubmission on worker death)
            spec["retries_used"] = spec.get("retries_used", 0) + 1
            self._redirect_to_gcs(spec)
            return
        else:
            for d in self._flight_holds.pop(tid, ()):
                self.decref(d)
            # the GCS may know more (e.g. the memory monitor killed it);
            # fetched lazily and cached per lease so N failed specs cost one
            # short RPC, and retry/cancel paths never pay it
            if lease.death_reason is None:
                try:
                    lease.death_reason = self.rpc(
                        {"type": "worker_death_reason", "wid": lease.wid},
                        timeout=2.0).get("reason") or ""
                except Exception:
                    lease.death_reason = ""
            why = lease.death_reason or f"worker {lease.wid} died"
            with self._owned_lock:
                self._owned_fail_locked(
                    spec, WorkerCrashedError(why), publish_later)
        self._publish_owned(publish_later)
        for oid in publish_later:
            self.decref(oid)

    def create_actor(
        self,
        cls_blob: bytes,
        args: tuple,
        kwargs: dict,
        *,
        resources: dict | None = None,
        max_restarts: int = 0,
        max_task_retries: int = 0,
        name: str | None = None,
        namespace: str | None = None,
        strategy: dict | None = None,
        max_concurrency: int = 1,
        runtime_env: dict | None = None,
        concurrency_groups: dict | None = None,
        concurrency_group_methods: dict | None = None,
        class_name: str | None = None,
    ) -> str:
        actor_id = ActorID().hex()
        task_id = TaskID().hex()
        spec_part, deps = self._serialize_args(args, kwargs)
        renv, rhash = self._prepare_runtime_env(runtime_env)
        self._publish_owned(spec_part.get("ref_holds", ()))
        self._prepare_gcs_deps(deps)
        self._flush_ref_deltas()  # see submit_task: count refs before submit
        spec = {
            "kind": "actor_create",
            "task_id": task_id,
            "actor_id": actor_id,
            "func": cls_blob,
            "deps": deps,
            "num_returns": 0,
            "resources": resources or {"CPU": 1.0},
            "max_restarts": max_restarts,
            "max_task_retries": max_task_retries,
            "name": name,
            # human-readable class for state/timeline labels (the GCS only
            # ever sees the pickled blob otherwise)
            "class_name": class_name,
            "namespace": namespace or self.effective_namespace(),
            "strategy": strategy,
            # the GCS gates dispatch on total concurrency: named groups
            # add their limits on top of the default pool (reference:
            # concurrency groups have independent limits)
            "max_concurrency": max_concurrency + sum(
                (concurrency_groups or {}).values()),
            "concurrency_groups": concurrency_groups or {},
            # method → group map: lets the GCS dispatch group methods
            # through their own lane (see _dispatch_actor_grouped_locked)
            "concurrency_group_methods": concurrency_group_methods or {},
            **({"runtime_env": renv, "renv_hash": rhash} if rhash else {}),
            **_trace_field(),
            **spec_part,
        }
        from ray_tpu_torch._private.task_spec import validate_actor

        validate_actor(spec)
        reply = self.rpc({"type": "create_actor", "spec": spec})
        if not reply.get("ok"):
            raise ValueError(reply.get("error") or "actor creation rejected")
        return actor_id

    def submit_actor_task(
        self,
        actor_id: str,
        method_name: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        max_task_retries: int | None = None,
        backpressure: int | None = None,
    ) -> list[ObjectRef]:
        task_id = TaskID().hex()
        spec_part, deps = self._serialize_args(args, kwargs)
        self._publish_owned(spec_part.get("ref_holds", ()))
        self._prepare_gcs_deps(deps)
        self._flush_ref_deltas()  # see submit_task: count refs before submit
        spec = {
            "kind": "actor_task",
            "task_id": task_id,
            "actor_id": actor_id,
            "method": method_name,
            "deps": deps,
            "num_returns": num_returns,
            "resources": {},
            "caller_ns": self.effective_namespace(),
            **_trace_field(),
            **spec_part,
        }
        if max_task_retries is not None:
            # per-spec override of the actor's death-retry budget (the
            # compiled-DAG exec loop pins 0: a lost loop must fail, not be
            # replayed on the restarted actor — see gcs worker-death path)
            spec["max_task_retries"] = int(max_task_retries)
        if backpressure is not None:
            spec["backpressure"] = backpressure  # _stream_results' window
        if num_returns == "streaming":
            # stream state must exist before the generator polls: stay sync
            reply = self.rpc({"type": "actor_task", "spec": spec})
            if not reply.get("ok"):
                raise ActorDiedError(reply.get("error")
                                     or f"actor {actor_id[:8]} is dead")
            return ObjectRefGenerator(task_id, self)
        # async push: one-way send — a dead actor fails the result objects
        # and the error surfaces at get(), same as the reference
        self.send_no_reply({"type": "actor_task_async", "spec": spec})
        return [ObjectRef(f"{task_id}r{i:04d}") for i in range(num_returns)]

    def wait_actor_ready(self, actor_id: str, timeout: float | None = None):
        reply = self.rpc({"type": "wait_actor_ready", "aid": actor_id}, timeout=timeout or 120.0)
        if not reply.get("ok"):
            raise ActorDiedError(reply.get("error") or "actor failed to start")

    def kill_actor(self, actor_id: str, no_restart: bool = True):
        self.rpc({"type": "kill_actor", "aid": actor_id, "no_restart": no_restart})

    # ---------------------------------------------------------------- objects

    def put(self, value: Any, pin: bool = False) -> ObjectRef:
        """Store a value; `pin=True` exempts it from automatic GC (for
        infrastructure objects handed around by raw id, e.g. channels)."""
        oid = ObjectID.for_put().hex()
        (parts, total), contained = _serialize_capturing(ser.dumps_into, value)
        self._publish_owned(contained)  # nested direct-result refs escape
        if total <= INLINE_LIMIT:
            blob = b"".join(bytes(p) if not isinstance(p, bytes) else p for p in parts)
            self.send_no_reply({"type": "object_put", "oid": oid, "where": "inline",
                                "inline": blob, "size": total, "pin": pin,
                                "contained": contained})
        else:
            tier = self.store.put_parts(oid, parts, total)
            self.send_no_reply({"type": "object_put", "oid": oid, "where": "shm",
                                "size": total, "host": self.host_id, "pin": pin,
                                "contained": contained, "tier": tier})
        return ObjectRef(oid)

    def _ensure_local(self, oid: str, reply: dict) -> dict:
        """Guarantee `oid` is readable in this process (inline payload or a
        local store copy), pulling cross-host and triggering lineage
        reconstruction as needed. Returns the final wait_object reply.
        (reference: object_recovery_manager.h:41.)"""
        for _ in range(MAX_RECON_ATTEMPTS):
            if reply["where"] == "inline":
                return reply
            if self.store.contains(oid) or self._pull_remote(oid, reply):
                return reply
            # every advertised copy is gone (host died / store evicted): ask
            # the GCS to reconstruct from lineage, then wait again
            action = self.rpc({"type": "object_lost", "oid": oid})["action"]
            if action in ("reconstructing", "pending", "ready"):
                reply = self.rpc({"type": "wait_object", "oid": oid},
                                 timeout=600.0)
                continue
            raise ObjectLostError(
                f"object {oid[:12]}… lost: all copies gone and no lineage "
                f"to reconstruct it (action={action})")
        raise ObjectLostError(
            f"object {oid[:12]}… unrecoverable after "
            f"{MAX_RECON_ATTEMPTS} reconstruction attempts")

    def _materialize(self, oid: str, reply: dict) -> Any:
        reply = self._ensure_local(oid, reply)
        if reply["where"] == "inline":
            value = self._loads_restoring(reply["inline"])
        else:
            plasma = self.store.get(oid)
            self._plasma_refs[oid] = plasma
            value = self._loads_restoring(plasma.buf, owner=plasma)
        if reply["status"] == "error":
            raise value
        self._memory[oid] = value
        return value

    def _loads_restoring(self, buf, owner=None):
        """Deserialize, resolving device-object markers when (and only
        when) the payload constructed one during unpickling: exact detection
        at any nesting depth. `owner` is the store pin wrapper backing
        `buf`: zero-copy arrays and CPU tensors tether it so the arena slot
        cannot be recycled while they are alive, even after the ref itself
        is freed."""
        from ray_tpu_torch.experimental.device_objects import (marker_capture,
                                                               restore)

        with marker_capture() as saw:
            value = ser.loads(buf, owner=owner)
        if saw():
            value = restore(value, self)
        return value

    def _pull_remote(self, oid: str, reply: dict) -> bool:
        """Object is in shm on another host: chunk-pull it into the local
        store and register the new copy (reference: pull-on-demand,
        object_manager.h:128). Returns False when no copy is reachable."""
        from ray_tpu_torch._private.object_transfer import ObjectFetcher

        if self._fetcher is None:
            self._fetcher = ObjectFetcher(self.store)
        locations = reply.get("locations") or []
        for host, addr in locations:
            if host == self.host_id or not addr:
                continue
            tier = self._fetcher.fetch(oid, addr)
            if tier:
                if tier not in ("shm", "spill"):
                    # fetch dedup'd into a concurrent pull: ask the store
                    # which tier the winner actually landed on
                    tier = self.store.tier_of(oid) or "shm"
                self.send_no_reply({"type": "object_put", "oid": oid,
                                    "where": "shm", "size": reply.get("size", 0),
                                    "host": self.host_id, "tier": tier})
                return True
        return False

    def get_object(self, oid: str, timeout: float | None = None) -> Any:
        if oid in self._memory:
            return self._memory[oid]
        ent = self._owned.get(oid)
        if ent is not None and ent.get("status") != "redirect":
            # a direct-task result this process owns: no GCS round-trip
            if not ent["fut"].event.is_set() and self._direct is not None:
                self._direct.flush()  # it may still be in the local queue
            ent["fut"].wait(timeout if timeout is not None else 86400.0)
            with self._owned_lock:
                ent = self._owned.get(oid, ent)
                st = ent.get("status")
                where, inline = ent.get("where"), ent.get("inline")
            if st in ("ready", "error") and where == "inline":
                value = self._loads_restoring(inline)
                if st == "error":
                    raise value
                self._memory[oid] = value
                return value
            if st == "ready" and where == "shm":
                if self.store.contains(oid):
                    plasma = self.store.get(oid)
                    self._plasma_refs[oid] = plasma
                    value = self._loads_restoring(plasma.buf, owner=plasma)
                    self._memory[oid] = value
                    return value
                if (ent.get("host") or self.host_id) == self.host_id:
                    # the owned local copy vanished (deleted, or evicted
                    # without a spill). wait_object would park forever: an
                    # unpublished direct result has no GCS entry to wait on.
                    # Drive the pull/reconstruct loop instead — object_lost
                    # replays the retained lineage spec.
                    reply = {"ready": True, "status": st, "where": where,
                             "inline": None, "size": ent.get("size", 0),
                             "locations": []}
                    return self._materialize(oid, reply)
            # redirected to the GCS (retry) or a remote shm copy: fall through
        reply = self.rpc({"type": "wait_object", "oid": oid},
                         timeout=timeout if timeout is not None else 86400.0)
        self._note_locations(oid, reply)
        return self._materialize(oid, reply)

    def _note_locations(self, oid: str, reply: dict) -> None:
        """Cache readiness + primary host of a GCS-known object; direct
        submission uses this for locality-aware lease targeting."""
        if not reply.get("ready") or reply.get("status") == "pending":
            return
        host = None
        locs = reply.get("locations") or ()
        if locs:
            host = locs[0][0]
        self._loc_cache[oid] = (host, reply.get("size", 0))
        if reply.get("status") in ("ready", "error"):
            self._status_cache[oid] = reply["status"]
            if len(self._status_cache) > 4096:
                for k in list(self._status_cache)[:1024]:
                    self._status_cache.pop(k, None)
        if len(self._loc_cache) > 4096:
            for k in list(self._loc_cache)[:1024]:
                self._loc_cache.pop(k, None)

    def error_of(self, oid: str):
        """The exception a ready-but-errored object carries, or None.

        `wait()` reports errored objects as ready, so a completion poll
        that forwards "ready" refs downstream would forward poison; this
        probe answers error-ness WITHOUT fetching successful payloads
        (error blobs are always inline, and `_note_locations` caches the
        status of every ref wait() resolved, so the healthy path is
        RPC-free). Never raises — an unreachable GCS is inconclusive and
        returns None, leaving the error to surface at the eventual
        `get()`. Call only on refs `wait()` already reported ready: the
        fallback RPC blocks until the object resolves."""
        if oid in self._memory:
            return None  # only successful gets land in _memory
        ent = self._owned.get(oid)
        if ent is not None and ent.get("status") != "redirect":
            st = ent.get("status")
            if st == "ready":
                return None
            if st == "error":
                try:
                    return self._loads_restoring(ent.get("inline"))
                except Exception as exc:
                    return exc
        if self._status_cache.get(oid) == "ready":
            return None
        try:
            # short timeout: callers hold the contract that the ref is
            # already wait()-ready, so the GCS answers immediately — and
            # this runs inside the executor's pump loop, where a long
            # block per cache-missed ref would stall driver-side dispatch
            reply = self.rpc({"type": "wait_object", "oid": oid},
                             timeout=2.0)
        except Exception:
            return None
        self._note_locations(oid, reply)
        if reply.get("status") != "error":
            return None
        try:
            if reply.get("inline") is not None:
                return self._loads_restoring(reply["inline"])
            self._materialize(oid, reply)  # errored objects raise here
        except Exception as exc:
            return exc
        return WorkerCrashedError(
            f"object {oid[:12]}… errored but its payload is unavailable")

    def get(self, refs, timeout: float | None = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for r in refs:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            out.append(self.get_object(r.hex(), timeout=remaining))
        return out[0] if single else out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1, timeout: float | None = None):
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        if self._direct is not None:
            self._direct.flush()  # some refs may still sit in the local queue
        futures: list[tuple[ObjectRef, _Future | None]] = []
        for r in refs:
            oid = r.hex()
            if oid in self._memory:
                futures.append((r, None))
                continue
            ent = self._owned.get(oid)
            if ent is not None and ent.get("status") != "redirect":
                futures.append((r, ent["fut"]))
                continue
            # one outstanding GCS waiter per object, however often wait() polls
            fut = self._obj_waits.get(oid)
            if fut is None:
                fut = self.rpc_async({"type": "wait_object", "oid": oid})
                self._obj_waits[oid] = fut
            futures.append((r, fut))
        deadline = None if timeout is None else time.monotonic() + timeout

        def is_ready(f: _Future | None) -> bool:
            # a "connection lost" error reply is NOT object-ready
            return f is None or (f.event.is_set() and bool(f.value.get("ready")))

        while True:
            # an owned fut can resolve to a redirect (direct task handed to
            # the GCS on retry): swap in a GCS waiter for it
            for idx, (r, f) in enumerate(futures):
                if (f is not None and f.event.is_set()
                        and isinstance(f.value, dict)
                        and f.value.get("redirect")):
                    oid = r.hex()
                    nf = self._obj_waits.get(oid)
                    if nf is None:
                        nf = self.rpc_async({"type": "wait_object", "oid": oid})
                        self._obj_waits[oid] = nf
                    futures[idx] = (r, nf)
            ready = [r for r, f in futures if is_ready(f)]
            if len(ready) >= num_returns or (deadline is not None and time.monotonic() >= deadline):
                break
            if not self._alive:
                break
            time.sleep(0.002)
        ready_set = set()
        for r, f in futures:
            if is_ready(f) and len(ready_set) < num_returns:
                ready_set.add(r.hex())
        ready = [r for r in refs if r.hex() in ready_set]
        not_ready = [r for r in refs if r.hex() not in ready_set]
        for r in ready:
            fut = self._obj_waits.pop(r.hex(), None)
            if fut is not None and fut.event.is_set():
                self._note_locations(r.hex(), fut.value)
        return ready, not_ready

    def cancel_task(self, ref: ObjectRef, force: bool = False) -> bool:
        """Cancel the task producing `ref` (reference: ray.cancel —
        CoreWorker::CancelTask). Queued tasks are dequeued; running ones are
        interrupted only with force=True (worker SIGKILL + normal
        death/retry bookkeeping, with retries suppressed)."""
        tid = ref.hex()[:-5]  # strip the rNNNN return suffix
        if self._direct is not None:
            r = self._direct.cancel(tid, force)
            if r is not None:
                return r
        reply = self.rpc({"type": "cancel_task", "task_id": tid,
                          "force": force})
        return bool(reply.get("cancelled"))

    def free(self, refs: Sequence[ObjectRef]):
        oids = [r.hex() for r in refs]
        for oid in oids:
            self._memory.pop(oid, None)
            self._plasma_refs.pop(oid, None)
            self._obj_waits.pop(oid, None)
            self._status_cache.pop(oid, None)
            with self._owned_lock:
                self._owned.pop(oid, None)
            self.store.delete(oid)
        self.rpc({"type": "free_objects", "oids": oids})

    # ------------------------------------------------------------------- kv

    def kv_put(self, key: str, value: bytes):
        self.rpc({"type": "kv_put", "key": key, "value": value})

    def kv_get(self, key: str) -> bytes | None:
        return self.rpc({"type": "kv_get", "key": key})["value"]

    def kv_keys(self, prefix: str = "") -> list[str]:
        return self.rpc({"type": "kv_keys", "prefix": prefix})["keys"]

    def kv_del(self, key: str):
        self.rpc({"type": "kv_del", "key": key})

    def effective_namespace(self) -> str:
        """The submitter's namespace inside a task, the driver's outside."""
        return getattr(self._task_ctx, "namespace", None) or self.namespace

    def get_named_actor(self, name: str,
                        namespace: str | None = None) -> str | None:
        reply = self.rpc({"type": "get_named_actor", "name": name,
                          "namespace": namespace or self.effective_namespace()})
        if reply.get("state") == "dead":
            # a dead actor's name is a tombstone (the GCS lets a new actor
            # claim it): callers must see "no such actor", not a handle
            # every call on which fails — e.g. serve._get_controller after
            # a shutdown must CREATE, and restarting actors still resolve
            return None
        return reply["aid"]

    # ------------------------------------------------------- placement groups

    def create_pg(self, pg_id: str, bundles: list[dict], strategy: str, name: str = ""):
        reply = self.rpc({"type": "create_pg", "spec": {
            "pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name}})
        if not reply.get("ok"):
            from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError

            raise PlacementGroupUnschedulableError(reply.get("error") or "pg rejected")

    def remove_pg(self, pg_id: str):
        self.rpc({"type": "remove_pg", "pg_id": pg_id})

    def pg_wait(self, pg_id: str, timeout: float | None = None) -> bool:
        try:
            reply = self.rpc({"type": "pg_wait", "pg_id": pg_id},
                             timeout=timeout if timeout is not None else 86400.0)
        except GetTimeoutError:
            return False
        return bool(reply.get("ok"))

    def pg_table(self) -> dict:
        return self.rpc({"type": "pg_table"})["table"]

    def get_named_pg(self, name: str) -> str | None:
        return self.rpc({"type": "get_named_pg", "name": name})["pg_id"]

    def add_node(self, node_id: str, resources: dict, labels: dict | None = None):
        self.rpc({"type": "add_node", "node_id": node_id, "resources": resources,
                  "labels": labels or {}})

    def remove_node(self, node_id: str):
        self.rpc({"type": "remove_node", "node_id": node_id})

    def list_nodes(self) -> list[dict]:
        return self.rpc({"type": "list_nodes"})["nodes"]

    def cluster_state(self) -> dict:
        return self.rpc({"type": "cluster_state"})["state"]

    # -------------------------------------------------------------- execution

    def _resolve_args(self, spec: dict) -> tuple[tuple, dict]:
        if "args_oid" in spec:
            oid = spec["args_oid"]
            if not self.store.contains(oid):
                # oversized args submitted from another host: pull (with the
                # same lost-object recovery as normal gets)
                reply = self.rpc({"type": "wait_object", "oid": oid}, timeout=300.0)
                self._ensure_local(oid, reply)
            plasma = self.store.get(oid)
            args, kwargs = self._loads_restoring(plasma.buf)
        else:
            args, kwargs = self._loads_restoring(spec["args"])
        inline_deps = spec.get("inline_deps") or {}

        def resolve(oid: str):
            if oid in self._memory:
                return self._memory[oid]
            # direct-path blobs: the caller attached its unpublished results
            blob = inline_deps.get(oid)
            if blob is not None:
                value = self._loads_restoring(blob)
                self._memory[oid] = value
                return value
            # chained direct task: the predecessor ran in THIS process
            ds = self.direct_server
            if ds is not None:
                rec = ds.recent.get(oid)
                if rec is not None:
                    where, inline, is_err = rec
                    if where == "inline" and inline is not None:
                        value = self._loads_restoring(inline)
                        if is_err:
                            raise value
                        self._memory[oid] = value
                        return value
                    if self.store.contains(oid):
                        plasma = self.store.get(oid)
                        self._plasma_refs[oid] = plasma
                        value = self._loads_restoring(plasma.buf)
                        if is_err:
                            raise value
                        self._memory[oid] = value
                        return value
            return self.get_object(oid)

        args = tuple(resolve(a.hex) if isinstance(a, _RefMarker) else a for a in args)
        kwargs = {k: resolve(v.hex) if isinstance(v, _RefMarker) else v for k, v in kwargs.items()}
        return args, kwargs

    @property
    def current_task_id(self) -> str | None:
        return getattr(self._task_ctx, "task_id", None)

    def _stream_results(self, spec: dict, out) -> None:
        """Drive a streaming task: each yielded value becomes its own object,
        reported incrementally; the producer pauses when it runs more than
        `backpressure` items ahead of the consumer (reference:
        _raylet.pyx:299 streaming generators with backpressure)."""
        task_id = spec["task_id"]
        bp = int(spec.get("backpressure") or 16)
        from ray_tpu_torch._private.ray_config import RayConfig

        stall_budget = RayConfig.instance().stream_stall_timeout_s
        produced = 0
        stalled = False
        try:
            for val in out:
                if task_id in self._stream_cancelled:
                    break  # consumer dropped the generator
                oid = f"{task_id}s{produced:06d}"
                (parts, total), refs = _serialize_capturing(ser.dumps_into, val)
                msg = {"type": "stream_item", "wid": self.wid, "task_id": task_id,
                       "oid": oid, "size": total, "contained": refs}
                if total <= INLINE_LIMIT:
                    blob = b"".join(bytes(p) if not isinstance(p, bytes) else p
                                    for p in parts)
                    msg.update(where="inline", inline=blob)
                else:
                    tier = self.store.put_parts(oid, parts, total)
                    msg.update(where="shm", host=self.host_id, tier=tier)
                self.send_no_reply(msg)
                produced += 1
                stalled = False
                stall_t = 0.0
                while True:
                    if (task_id in self._stream_cancelled
                            or produced - self._stream_acks.get(task_id, 0) <= bp):
                        break
                    ev = self._stream_events.setdefault(task_id, threading.Event())
                    ev.clear()
                    if produced - self._stream_acks.get(task_id, 0) <= bp:
                        break  # ack raced the clear
                    # wait in short slices: any ack progress resets the stall
                    # clock, so only a consumer with NO progress for the whole
                    # budget fails the stream (budget 0 = wait forever while
                    # the GCS connection lives — reference blocks indefinitely)
                    if ev.wait(5.0):
                        stall_t = 0.0
                        continue
                    stall_t += 5.0
                    if stall_budget and stall_t >= stall_budget:
                        stalled = True  # consumer gone/stalled: stop, don't
                        break           # produce unboundedly past it
                if stalled:
                    break
            if stalled:
                # a merely-slow consumer must see an ERROR, not a clean
                # StopIteration with silently truncated results
                err = ser.dumps(RayTaskError(
                    spec.get("name") or "stream", "",
                    TimeoutError(
                        f"streaming producer stalled: consumer took no item "
                        f"for {stall_budget:.0f}s with the producer {bp} items "
                        f"ahead (produced {produced})")))
                self.send_no_reply({"type": "stream_end", "wid": self.wid,
                                    "task_id": task_id, "error": err})
            else:
                self.send_no_reply({"type": "stream_end", "wid": self.wid,
                                    "task_id": task_id, "error": None})
        finally:
            self._stream_acks.pop(task_id, None)
            self._stream_events.pop(task_id, None)
            self._stream_cancelled.discard(task_id)

    def execute_spec(self, spec: dict) -> dict:
        """Run a task spec to completion and return the task_done-shaped
        report (results, error, contained, device_tensors) WITHOUT sending
        it anywhere — the GCS exec path and the direct-dispatch path differ
        only in where the report goes."""
        kind = spec["kind"]
        error_blob = None
        results = []
        contained_map: dict = {}
        _extract_dev = False
        _dev_map: dict = {}  # oid → tensor ids contained in THAT result
        self._task_ctx.task_id = spec["task_id"]
        self._task_ctx.namespace = spec.get("caller_ns")
        strat = spec.get("strategy") or {}
        self._task_ctx.pg_id = (strat.get("pg_id")
                                if strat.get("kind") == "pg" else None)
        _t_exec0 = time.time()
        # trace propagation: the spec's injected context becomes the parent
        # of this task's span, and the span is current while user code runs
        # so nested .remote() calls chain under it (reference:
        # tracing_helper.py:165 _DictPropagator extract-before-execute)
        from ray_tpu_torch.util import tracing as _tracing

        _tspan = _tracing.begin_task_span(spec.get("trace_ctx"))
        try:
            args, kwargs = self._resolve_args(spec)
            if kind == "task":
                key = spec.get("func_sha") or spec["func"]
                func = self._func_cache.get(key)
                if func is None:
                    blob = spec.get("func")
                    if blob is None:
                        blob = self.kv_get("fn:" + spec["func_sha"])
                        if blob is None:
                            raise RayTpuError(
                                f"function {spec['func_sha']} missing from "
                                "the cluster function store")
                    func = ser.loads(blob)
                    if len(self._func_cache) > 256:
                        self._func_cache.clear()
                    self._func_cache[key] = func
                out = func(*args, **kwargs)
            elif kind == "actor_create":
                cls = ser.loads(spec["func"])
                instance = cls(*args, **kwargs)
                self.actors[spec["actor_id"]] = instance
                self.current_actor_id = spec["actor_id"]
                from ray_tpu_torch._private.actor_executor import ActorExecutor

                # concurrency groups + threaded/async execution
                # (reference: concurrency_group_manager.h, fiber.h async
                # actors, actor_scheduling_queue.h)
                self._actor_pools[spec["actor_id"]] = ActorExecutor(
                    instance,
                    max_concurrency=int(spec.get("max_concurrency") or 1),
                    concurrency_groups=spec.get("concurrency_groups") or {})
                out = None
            elif kind == "actor_task":
                instance = self.actors[spec["actor_id"]]
                if spec["method"] == EXEC_LOOP_METHOD:
                    # compiled-DAG channel plane: the provisioned per-actor
                    # loop runs as a (long-lived) actor task so teardown
                    # joins it through the normal result path (reference:
                    # compiled_dag_node.py do_exec_tasks). The executor is
                    # passed so async ops run on the actor's own event loop.
                    from ray_tpu_torch.dag.channel_execution import \
                        actor_exec_loop

                    out = actor_exec_loop(
                        instance, *args,
                        _execer=self._actor_pools.get(spec["actor_id"]),
                        **kwargs)
                else:
                    method = getattr(instance, spec["method"])
                    import inspect as _inspect

                    if _inspect.iscoroutinefunction(
                            getattr(method, "__func__", method)):
                        # async method reached execute_task directly (pool
                        # routing already ran it on the loop when enabled)
                        execer = self._actor_pools.get(spec["actor_id"])
                        out = execer.run_coroutine_sync(method(*args, **kwargs))
                    else:
                        out = method(*args, **kwargs)
                    if getattr(getattr(method, "__func__", method),
                               TENSOR_TRANSPORT_ATTR, None):
                        _extract_dev = True
            else:
                raise RayTpuError(f"unknown task kind {kind}")
            n = spec["num_returns"]
            if n == "streaming":
                self._stream_results(spec, out)
                values = []
                n = 0
            else:
                values = [out] if n == 1 else (list(out) if n > 0 else [])
            if isinstance(n, int) and n > 1 and len(values) != n:
                raise ValueError(f"task declared num_returns={n} but returned {len(values)} values")
            if _extract_dev:
                # device objects: returned tensors stay in this process;
                # only small markers cross the control plane. Extraction is
                # PER RETURN VALUE so the GCS can free each result's
                # registry entries independently (freeing return 0 must not
                # drop tensors still referenced by a live return 1).
                from ray_tpu_torch.experimental import device_objects

                for i in range(len(values)):
                    values[i], tids = device_objects.extract(values[i], self.wid)
                    if tids:
                        _dev_map[f"{spec['task_id']}r{i:04d}"] = tids
            for i, val in enumerate(values):
                oid = f"{spec['task_id']}r{i:04d}"
                (parts, total), refs = _serialize_capturing(ser.dumps_into, val)
                if refs:
                    contained_map[oid] = refs
                if total <= INLINE_LIMIT:
                    blob = b"".join(bytes(p) if not isinstance(p, bytes) else p for p in parts)
                    results.append((oid, "inline", blob, total))
                else:
                    tier = self.store.put_parts(oid, parts, total)
                    results.append((oid, "shm", None, total, tier))
        except Exception as e:  # noqa: BLE001 — task errors must be captured, not crash the worker
            tb = traceback.format_exc()
            wrapped = RayTaskError(spec.get("name") or spec.get("method", kind), tb, e)
            try:
                blob = ser.dumps(wrapped)
            except Exception:
                # the cause (or a return value) wasn't picklable; keep the traceback
                wrapped = RayTaskError(spec.get("name") or spec.get("method", kind), tb, None)
                blob = ser.dumps(wrapped)
            error_blob = repr(e)
            if spec["num_returns"] == "streaming":
                # mid-stream failure: already-yielded items stay readable,
                # the consumer's next() raises the error
                self.send_no_reply({"type": "stream_end", "wid": self.wid,
                                    "task_id": spec["task_id"], "error": blob})
                results = []
            else:
                results = [
                    (f"{spec['task_id']}r{i:04d}", "inline", blob, len(blob))
                    for i in range(spec["num_returns"])
                ]
        finally:
            self._task_ctx.task_id = None
            self._task_ctx.namespace = None
            self._task_ctx.pg_id = None
            _tracing.end_task_span(
                _tspan, name=spec.get("name") or spec.get("method") or kind,
                task_id=spec["task_id"], kind=kind, ok=error_blob is None)
            # drop arg-value caches this task materialized unless user code
            # in this process also holds refs to them
            for dep in spec.get("deps", ()):
                with self._ref_lock:
                    held = self._local_refs.get(dep, 0) > 0
                if not held:
                    self._memory.pop(dep, None)
                    self._plasma_refs.pop(dep, None)
        from ray_tpu_torch._private import task_events as _te

        _te.emit("task:execute", task_id=spec["task_id"],
                 name=spec.get("name") or spec.get("method") or kind,
                 start=_t_exec0, end=time.time(), kind=kind,
                 ok=error_blob is None, direct=spec.get("_direct", False),
                 **({"error": error_blob} if error_blob else {}))
        lite = {k: spec.get(k) for k in ("task_id", "kind", "actor_id", "resources", "num_returns", "max_retries", "retries_used")}
        # flush ref deltas BEFORE task_done on the same ordered connection:
        # refs this task deserialized/retained must reach the GCS before it
        # releases the task's system holds, or a borrowed ref could be freed
        # under us (reference: borrower protocol, reference_counter.h:43)
        self._flush_ref_deltas()
        done = {"type": "task_done", "wid": self.wid, "spec": lite,
                "task_id": spec["task_id"],
                "results": results, "error": error_blob,
                "contained": contained_map}
        if _dev_map:
            # registry lifetime rides each result object: the GCS tells us to
            # drop a result's device entries when THAT object is freed
            done["device_tensors"] = _dev_map
        return done

    def register_direct_results(self, spec: dict, done: dict, server) -> None:
        """After a direct task: make the outputs that need cluster-level
        bookkeeping visible at the GCS — shm results (locations, spilling,
        lineage for reconstruction) and inline results carrying nested refs
        (the GCS must hold those for future borrowers). Pure-inline results
        stay caller-local: zero GCS traffic on the hot path."""
        results = done.get("results") or ()
        contained = done.get("contained") or {}
        is_err = done.get("error") is not None
        published: list[str] = []
        any_shm = False
        for res in results:
            oid, where, inline, size = res[:4]
            server.note_recent(oid, where, inline, is_err)
            tier = res[4] if len(res) > 4 else "shm"
            if where == "shm":
                any_shm = True
                self.send_no_reply({
                    "type": "object_put", "oid": oid, "where": "shm",
                    "size": size, "host": self.host_id, "tier": tier,
                    "is_error": is_err,
                    "contained": contained.get(oid) or None})
                published.append(oid)
            elif contained.get(oid):
                self.send_no_reply({
                    "type": "object_put", "oid": oid, "where": "inline",
                    "inline": inline, "size": size, "is_error": is_err,
                    "contained": contained.get(oid)})
                published.append(oid)
        if (any_shm and spec.get("kind") == "task"
                and isinstance(spec.get("num_returns"), int)):
            # shm outputs are evictable/losable: retain lineage so the GCS
            # can reconstruct them (inline results die with their owner)
            lin = {k: v for k, v in spec.items() if k != "_cancelled"}
            self.send_no_reply({"type": "direct_lineage", "spec": lin})
        if published:
            done["published"] = published

    def execute_task(self, spec: dict) -> None:
        done = self.execute_spec(spec)
        self.send_no_reply(done)

    def exec_loop(self):
        """Main loop of worker processes (driver never calls this)."""
        while True:
            spec = self.exec_queue.get()
            if spec is None:
                return
            if (spec["kind"] == "actor_task"
                    and spec.get("method") == EXEC_LOOP_METHOD):
                # compiled-DAG exec loop: blocks until teardown, so it gets
                # a dedicated thread — other actors hosted by this process
                # must stay schedulable behind it. Actor serialization is
                # NOT weakened: the GCS dispatches ≤ max_concurrency tasks
                # per actor, and the loop occupies a slot for its lifetime,
                # so a plain actor's normal calls queue until teardown
                # rather than racing the loop.
                threading.Thread(target=self.execute_task, args=(spec,),
                                 daemon=True, name="dag-channel-loop").start()
                continue
            execer = (self._actor_pools.get(spec.get("actor_id"))
                      if spec["kind"] == "actor_task" else None)
            if execer is not None:
                execer.submit(spec, self.execute_task)
            else:
                self.execute_task(spec)

    def disconnect(self):
        global _ref_tracker
        if _ref_tracker is self:
            _ref_tracker = None
        self._disconnecting = True
        self._alive = False
        if self._direct is not None:
            try:
                self._direct.shutdown()
            except Exception:
                pass
        if self.direct_server is not None:
            try:
                self.direct_server.stop()
            except Exception:
                pass
        try:
            self._flush_ref_deltas()
        except Exception:
            pass
        if hasattr(self.store, "release_pid_pins") and self.kind != "driver":
            # clean-exit pin release: views this process still holds must
            # not keep blocking arena eviction after it is gone. Driver
            # processes are excluded: the pid-keyed sweep would also revoke
            # pins held by the in-process object server / GCS head store
            # (same pid, other ArenaStore instances), which may still be
            # serving a chunked send during shutdown.
            try:
                self.store.release_pid_pins()
            except Exception:
                pass
        try:
            self.conn.close()
        except Exception:
            pass


_global_worker: CoreWorker | None = None

# Process-wide drain state, set by the GCS `drain_notice` push when this
# worker's node enters DRAINING (preemption notice, autoscaler scale-down,
# `ray_tpu_torch drain`). Train sessions poll drain_info() at step boundaries to
# trigger the preemption-grace checkpoint.
_drain_event = threading.Event()
_drain_info: dict | None = None


def _set_drain(msg: dict) -> None:
    global _drain_info
    if _drain_info is None:
        _drain_info = {"node_id": msg.get("node_id"),
                       "reason": msg.get("reason"),
                       "grace_s": msg.get("grace_s"),
                       "ts": time.time()}
    _drain_event.set()


def _reset_drain() -> None:
    """Forget the previous session's drain notice (called from
    shutdown()): the notice names a node of a cluster that no longer
    exists, and a fresh init() in the same process would otherwise see a
    phantom preemption on its first train step."""
    global _drain_info
    _drain_info = None
    _drain_event.clear()


def drain_info() -> dict | None:
    """The drain notice this process received, or None. Sticky for the
    session lifetime: a draining node never un-drains while its cluster
    is alive."""
    return _drain_info


def drain_requested() -> bool:
    return _drain_event.is_set()


def get_global_worker() -> CoreWorker:
    if _global_worker is None:
        raise RayTpuError("ray_tpu_torch.init() has not been called in this process")
    return _global_worker


def set_global_worker(w: CoreWorker | None):
    global _global_worker
    _global_worker = w
