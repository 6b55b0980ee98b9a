"""Direct task dispatch: lease-based caller→worker submission.

The GCS grants a caller a *lease* on an idle worker; task specs then flow
directly caller→worker over a dedicated connection, and results flow straight
back — the central scheduler is off the per-task hot path entirely. Plain
tasks with ready dependencies ride this plane; anything needing cluster-level
decisions (placement strategies, queuing, actor state, streaming) stays on
the GCS path, and a failed lease attempt falls back to it too (spillback).

Locality: the caller targets its lease request at the host holding a task's
largest dependency, so big arguments never cross hosts.

(reference: src/ray/core_worker/task_submission/normal_task_submitter.h:81 —
lease request + direct task push with pipelining; lease_policy.h —
locality-aware lease targeting; src/ray/raylet/scheduling/
cluster_lease_manager.h:41 — lease grant/spillback. The reference leases
from per-node raylets; here the GCS arbitrates grants but task bytes never
touch it.)
"""

from __future__ import annotations

import collections
import os
import socket
import threading
import time

from ray_tpu_torch._private.protocol import (ConnectionClosed, MsgConnection,
                                       connect_address, listen_tcp)

# per-lease submission pipeline depth (reference: max_tasks_in_flight_per_worker)
MAX_INFLIGHT = 16
# how long a lease may sit unused at the caller before being returned
LEASE_IDLE_S = 2.0
# min delay between failed lease attempts for one shape (exponential to _MAX)
LEASE_RETRY_MIN_S = 0.02
LEASE_RETRY_MAX_S = 1.0


def shape_key(resources: dict, renv_hash: str) -> tuple:
    return (tuple(sorted((resources or {}).items())), renv_hash)


class DirectServer:
    """Worker-side: accepts leased-caller connections and executes specs.

    One caller connection is active per lease. A recv thread parses frames
    and feeds a local queue; a single exec thread drains it in order, so
    queued-but-unstarted tasks can be cancelled out of the queue while a
    long task runs (reference: ray.cancel dequeues leased-worker tasks)."""

    def __init__(self, core):
        self.core = core
        adv = os.environ.get("RAY_TPU_TORCH_HOST_IP", "127.0.0.1")
        self.sock = listen_tcp("0.0.0.0", 0)
        self.address = f"{adv}:{self.sock.getsockname()[1]}"
        self._stopped = False
        # small result cache so a chained task submitted to the same lease can
        # resolve its predecessor's output without any GCS hop
        self.recent: collections.OrderedDict[str, tuple] = collections.OrderedDict()
        self.recent_cap = 4096
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True, name="direct-accept")
        self._accept_thread.start()

    def _accept(self):
        while not self._stopped:
            try:
                s, _ = self.sock.accept()
            except OSError:
                return
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(MsgConnection(s),),
                             daemon=True, name="direct-serve").start()

    def note_recent(self, oid: str, where: str, inline, is_error: bool) -> None:
        self.recent[oid] = (where, inline, is_error)
        while len(self.recent) > self.recent_cap:
            self.recent.popitem(last=False)

    def _serve(self, conn: MsgConnection):
        import queue as _q

        core = self.core
        queue: collections.deque = collections.deque()
        wakeups: _q.SimpleQueue = _q.SimpleQueue()  # C-level block/wake
        cancelled: set[str] = set()
        running: list = [None]  # task_id of the spec being executed
        closed = threading.Event()
        token = [None]

        # replies coalesce while more work is queued: one frame (and one
        # caller wakeup) covers a whole pipelined burst — the dominant cost
        # per trivial task is syscalls + context switches, not work. A 1 ms
        # micro-flusher bounds reply latency so a buffered fast result never
        # waits behind a long-running successor.
        out: list = []
        out_lock = threading.Lock()
        out_event = threading.Event()

        def flush() -> bool:
            with out_lock:
                batch, out[:] = list(out), []
            if not batch:
                return True
            try:
                if len(batch) == 1:
                    conn.send({"rid": batch[0][0], "done": batch[0][1]})
                else:
                    conn.send({"dones": batch})
            except ConnectionClosed:
                return False
            return True

        def flusher_loop():
            while not closed.is_set():
                out_event.wait(0.5)
                out_event.clear()
                if closed.is_set():
                    return
                time.sleep(0.001)
                flush()

        def exec_loop():
            while True:
                wakeups.get()
                if closed.is_set() and not queue:
                    flush()
                    return
                try:
                    rid, spec = queue.popleft()
                except IndexError:
                    if not queue and not flush():
                        return
                    continue  # its spec was cancelled out of the queue
                tid = spec["task_id"]
                if tid in cancelled:
                    cancelled.discard(tid)
                    if not queue and not flush():
                        return
                    continue  # cancel reply already sent by the recv side
                running[0] = tid
                done = core.execute_spec(spec)
                running[0] = None
                core.register_direct_results(spec, done, self)
                with out_lock:
                    out.append((rid, {k: done.get(k) for k in
                                      ("task_id", "results", "error",
                                       "contained", "published")}))
                    n_out = len(out)
                if n_out == 1:
                    out_event.set()  # arm the micro-flusher
                if queue and n_out < 32:
                    continue
                if not flush():
                    return

        exec_thread = threading.Thread(target=exec_loop, daemon=True,
                                       name="direct-exec")
        exec_thread.start()
        threading.Thread(target=flusher_loop, daemon=True,
                         name="direct-flush").start()
        try:
            while True:
                msg = conn.recv()
                t = msg.get("type")
                if t == "exec_direct":
                    if msg.get("token") is not None:
                        token[0] = msg["token"]
                    queue.append((msg["rid"], msg["spec"]))
                    wakeups.put(1)
                elif t == "exec_direct_batch":
                    if msg.get("token") is not None:
                        token[0] = msg["token"]
                    for rid_spec in msg["items"]:
                        queue.append(rid_spec)
                        wakeups.put(1)
                elif t == "cancel_direct":
                    tid = msg["task_id"]
                    hit = False
                    for item in list(queue):
                        if item[1]["task_id"] == tid:
                            try:
                                queue.remove(item)
                            except ValueError:
                                break  # exec thread won the race
                            cancelled.add(tid)
                            try:
                                conn.send({"rid": item[0], "done": {
                                    "task_id": tid, "cancelled": True}})
                            except ConnectionClosed:
                                pass
                            hit = True
                            break
                    if not hit and running[0] == tid and msg.get("force"):
                        # force-cancel the running task: this process dies
                        # (reference: force-cancelled tasks kill the executor)
                        try:
                            conn.send({"rid": msg["rid"], "cancelled": True})
                        except ConnectionClosed:
                            pass
                        os._exit(1)
                    try:
                        conn.send({"rid": msg["rid"], "cancelled": hit})
                    except ConnectionClosed:
                        pass
                elif t == "bye":
                    break
        except ConnectionClosed:
            pass
        finally:
            closed.set()
            wakeups.put(1)
            out_event.set()
            exec_thread.join(timeout=300.0)
            try:
                conn.close()
            except Exception:
                pass
            # tell the GCS this lease ended (idempotent: token-guarded); the
            # clean `bye` path also sends return_lease from the caller, and
            # whichever lands first wins
            if token[0] is not None:
                try:
                    core.send_no_reply({"type": "lease_released",
                                        "wid": core.wid, "token": token[0]})
                except Exception:
                    pass

    def stop(self):
        self._stopped = True
        try:
            self.sock.close()
        except OSError:
            pass


class _Lease:
    __slots__ = ("wid", "addr", "host", "node", "token", "conn", "inflight",
                 "last_used", "last_done", "dead", "draining", "key", "lock",
                 "death_reason")

    def __init__(self, wid, addr, host, node, token, conn, key):
        self.wid = wid
        self.addr = addr
        self.host = host
        self.node = node
        self.token = token
        self.conn = conn
        self.key = key
        self.inflight: dict[str, dict] = {}  # task_id → spec
        self.last_used = time.monotonic()
        self.last_done = 0.0
        self.dead = False
        self.draining = False
        self.death_reason: str | None = None
        self.lock = threading.Lock()

    def cap(self, now: float) -> int:
        """Adaptive pipeline depth: pipeline deep only while the worker is
        visibly turning tasks over; behind a long-running task, cap at 1 so
        waiting work stays schedulable elsewhere (and visible as backlog —
        reference: work is stolen back from slow leased workers)."""
        if now - self.last_done <= 0.25:
            return MAX_INFLIGHT  # short-task regime: completions are fresh
        return 1


class DirectDispatcher:
    """Caller-side lease pool, local submission queue, and direct pushes.

    Specs that pass eligibility but find no lease headroom wait in a local
    per-shape queue (reference: the submitter queues tasks awaiting leases)
    and are pumped onto leases as replies drain. If the pool for a shape
    vanishes, queued specs are re-routed to the GCS path."""

    QUEUE_CAP = 4096

    def __init__(self, core):
        self.core = core
        self.lock = threading.RLock()
        self.leases: dict[tuple, list[_Lease]] = {}
        self.by_wid: dict[str, _Lease] = {}
        self.local_queue: dict[tuple, collections.deque] = {}
        self._next_try: dict[tuple, float] = {}
        self._backoff: dict[tuple, float] = {}
        import itertools

        self._rid = itertools.count(1)  # next() is atomic under the GIL
        self._pending: dict[int, object] = {}  # rid → _Future for cancels
        self.submitted = 0  # stats (tests assert the fast path engaged)
        self._maint = threading.Thread(target=self._maintenance_loop,
                                       daemon=True, name="direct-maint")
        self._maint.start()

    def _maintenance_loop(self):
        # lease upkeep runs on its OWN thread: _grow blocks on a GCS RPC and
        # must never stall the caller's refcount-flush cadence
        while getattr(self.core, "_alive", True):
            time.sleep(0.2)
            try:
                self.reap_idle()
            except Exception:
                pass

    # ------------------------------------------------------------ leasing

    def _grow(self, key: tuple, resources: dict, renv_hash: str,
              prefer_host: str | None) -> None:
        now = time.monotonic()
        with self.lock:
            if now < self._next_try.get(key, 0.0):
                return
            # optimistic: push the next attempt out before dropping the lock
            self._next_try[key] = now + self._backoff.get(key, LEASE_RETRY_MIN_S)
        try:
            # pool width tracks the machine: on small boxes extra worker
            # processes just contend for the same cores
            count = max(2, min(4, os.cpu_count() or 1))
            with self.lock:
                backlog = len(self.local_queue.get(key) or ())
            reply = self.core.rpc({"type": "lease_workers",
                                   "resources": dict(resources or {}),
                                   "renv_hash": renv_hash, "count": count,
                                   "backlog": backlog,
                                   "prefer_host": prefer_host}, timeout=30.0)
        except Exception:
            return
        grants = reply.get("leases") or ()
        with self.lock:
            if grants:
                self._backoff[key] = LEASE_RETRY_MIN_S
                self._next_try[key] = 0.0
            else:
                self._backoff[key] = min(
                    LEASE_RETRY_MAX_S,
                    self._backoff.get(key, LEASE_RETRY_MIN_S) * 2)
                self._next_try[key] = time.monotonic() + self._backoff[key]
        for g in grants:
            try:
                conn = connect_address(g["addr"], timeout=10.0)
            except (OSError, ConnectionClosed):
                # worker unreachable: hand the lease straight back
                try:
                    self.core.send_no_reply(
                        {"type": "return_lease",
                         "tokens": {g["wid"]: g["token"]}})
                except Exception:
                    pass
                continue
            lease = _Lease(g["wid"], g["addr"], g["host"], g["node"],
                           g["token"], conn, key)
            with self.lock:
                self.leases.setdefault(key, []).append(lease)
                self.by_wid[lease.wid] = lease
            threading.Thread(target=self._recv_loop, args=(lease,),
                             daemon=True, name="direct-recv").start()
        if grants:
            self.pump(key)

    def _candidates(self, key: tuple, host: str | None = None) -> list[_Lease]:
        """Live leases for `key` with pipeline headroom (optionally on one
        host). Takes and releases self.lock."""
        now = time.monotonic()
        with self.lock:
            return [l for l in self.leases.get(key, ())
                    if not l.dead and not l.draining
                    and (host is None or l.host == host)
                    and len(l.inflight) < l.cap(now)]

    def pick(self, key: tuple, resources: dict, renv_hash: str,
             prefer_host: str | None) -> _Lease | None:
        """A lease with pipeline headroom, preferring `prefer_host`."""
        cands = self._candidates(key)
        if not cands:
            self._grow(key, resources, renv_hash, prefer_host)
            cands = self._candidates(key)
            if not cands:
                return None
        if prefer_host is not None:
            local = [l for l in cands if l.host == prefer_host]
            if local:
                cands = local
            else:
                # no lease on the preferred host yet: try to get one there
                self._grow(key, resources, renv_hash, prefer_host)
                fresh = self._candidates(key, host=prefer_host)
                if fresh:
                    cands = fresh
        return min(cands, key=lambda l: len(l.inflight))

    # --------------------------------------------------------- submission

    def submit_or_queue(self, key: tuple, spec: dict, resources: dict,
                        renv_hash: str, prefer_host: str | None,
                        required_lease: "_Lease | None") -> bool:
        """Park the spec in the local queue (coalesced sends — frame
        syscalls, not task work, dominate trivial tasks); pump when a burst
        accumulates. Locality-targeted specs ship immediately instead.
        False → caller should use the GCS path."""
        if prefer_host is not None and required_lease is None:
            # big-dep task: route straight at the dep's host
            lease = self.pick(key, resources, renv_hash, prefer_host)
            if lease is not None:
                return self._send(lease, spec)
        if required_lease is not None:
            if required_lease.dead:
                return False
            if not self._enqueue(key, spec, required_lease.wid):
                return False
        else:
            with self.lock:
                live = any(not l.dead for l in self.leases.get(key, ()))
            if not live:
                self._grow(key, resources, renv_hash, prefer_host)
                with self.lock:
                    live = any(not l.dead for l in self.leases.get(key, ()))
                if not live:
                    return False
            if not self._enqueue(key, spec, None):
                return False
        with self.lock:
            depth = len(self.local_queue.get(key, ()))
        if depth >= MAX_INFLIGHT:
            self.pump(key)
        return True

    def flush(self) -> None:
        """Push every queued spec out now — called when the caller is about
        to block on results."""
        with self.lock:
            keys = [k for k, q in self.local_queue.items() if q]
        for key in keys:
            self.pump(key)

    def _enqueue(self, key: tuple, spec: dict, pin: str | None) -> bool:
        with self.lock:
            q = self.local_queue.setdefault(key, collections.deque())
            if len(q) >= self.QUEUE_CAP:
                return False
            q.append((spec, pin))
        return True

    def _send(self, lease: _Lease, spec: dict) -> bool:
        rid = next(self._rid)
        with lease.lock:
            if lease.dead:
                return False
            lease.inflight[spec["task_id"]] = spec
            lease.last_used = time.monotonic()
        self.core._note_direct_lease(spec, lease.wid)
        try:
            lease.conn.send({"type": "exec_direct", "rid": rid, "spec": spec,
                             "token": lease.token})
        except ConnectionClosed:
            with lease.lock:
                lease.inflight.pop(spec["task_id"], None)
            self._fail_lease(lease)
            return False
        self.submitted += 1
        return True

    def _send_batch(self, lease: _Lease, specs: list[dict]) -> bool:
        items = []
        with lease.lock:
            if lease.dead:
                return False
            for spec in specs:
                items.append((next(self._rid), spec))
                lease.inflight[spec["task_id"]] = spec
            lease.last_used = time.monotonic()
        for spec in specs:
            self.core._note_direct_lease(spec, lease.wid)
        try:
            lease.conn.send({"type": "exec_direct_batch", "items": items,
                             "token": lease.token})
        except ConnectionClosed:
            with lease.lock:
                for spec in specs:
                    lease.inflight.pop(spec["task_id"], None)
            self._fail_lease(lease)
            return False
        self.submitted += len(specs)
        return True

    def pump(self, key: tuple) -> None:
        """Drain the local queue onto leases with headroom (FIFO). Runs of
        compatible specs ship as ONE frame per lease (syscalls, not task
        work, dominate trivial-task cost)."""
        while True:
            route_to_gcs = None
            lease = None
            batch: list[tuple] = []
            with self.lock:
                q = self.local_queue.get(key)
                if not q:
                    return
                spec, pin = q[0]
                now = time.monotonic()
                if pin is not None:
                    l = self.by_wid.get(pin)
                    if l is None or l.dead:
                        q.popleft()
                        route_to_gcs = spec  # pinned lease died before send
                    elif len(l.inflight) < MAX_INFLIGHT:
                        # chains must stay put: ignore the adaptive cap
                        lease = l  # draining is fine too
                    else:
                        return  # head is blocked on its pinned lease
                else:
                    cands = [l for l in self.leases.get(key, ())
                             if not l.dead and not l.draining
                             and len(l.inflight) < l.cap(now)]  # under lock
                    if not cands:
                        return
                    lease = min(cands, key=lambda l: len(l.inflight))
                if lease is not None:
                    room = (MAX_INFLIGHT if pin is not None
                            else lease.cap(now)) - len(lease.inflight)
                    while q and room > 0:
                        spec, pin = q[0]
                        if pin is not None and pin != lease.wid:
                            break  # next item needs a different lease
                        q.popleft()
                        batch.append((spec, pin))
                        room -= 1
            if route_to_gcs is not None:
                self.core._redirect_to_gcs(route_to_gcs)
                continue
            if not batch:
                return
            if not self._send_batch(lease, [s for s, _ in batch]):
                with self.lock:
                    q = self.local_queue.setdefault(key, collections.deque())
                    for item in reversed(batch):
                        q.appendleft(item)
                # _send marked the lease dead; loop re-evaluates

    def cancel(self, task_id: str, force: bool) -> bool | None:
        """None → not a direct task; bool → cancel outcome."""
        # still in the local queue: drop it before it ever leaves
        with self.lock:
            for key, q in self.local_queue.items():
                for item in q:
                    if item[0]["task_id"] == task_id:
                        q.remove(item)
                        self.core._direct_cancelled_local(item[0])
                        return True
        with self.lock:
            lease = next((l for ls in self.leases.values() for l in ls
                          if task_id in l.inflight), None)
        if lease is None:
            return None
        spec = lease.inflight.get(task_id)
        if spec is not None:
            spec["_cancelled"] = True
        rid = next(self._rid)
        from ray_tpu_torch._private.worker import _Future

        fut = _Future()
        self._pending[rid] = fut
        try:
            lease.conn.send({"type": "cancel_direct", "rid": rid,
                             "task_id": task_id, "force": force})
            reply = fut.wait(30.0)
        except Exception:
            # force-kill closes the connection; the lease failure path marks
            # the task cancelled (spec["_cancelled"] above)
            return True if force else False
        finally:
            self._pending.pop(rid, None)
        if spec is not None and not reply.get("cancelled"):
            spec.pop("_cancelled", None)
        return bool(reply.get("cancelled"))

    # ------------------------------------------------------------ receive

    def _recv_loop(self, lease: _Lease):
        try:
            while True:
                msg = lease.conn.recv()
                rid = msg.get("rid")
                fut = self._pending.pop(rid, None) if rid is not None else None
                if fut is not None and "done" not in msg:
                    fut.set(msg)  # cancel reply
                    continue
                dones = msg.get("dones")
                if dones is None:
                    done = msg.get("done")
                    if done is None:
                        continue
                    dones = [(rid, done)]
                for _rid, done in dones:
                    tid = done["task_id"]
                    with lease.lock:
                        spec = lease.inflight.pop(tid, None)
                    if spec is not None:
                        self.core._on_direct_done(lease, spec, done)
                lease.last_used = lease.last_done = time.monotonic()
                self.pump(lease.key)
                with self.lock:
                    drained = lease.draining and not lease.inflight
                if drained:
                    self._return_lease(lease)
        except ConnectionClosed:
            self._fail_lease(lease)

    # ---------------------------------------------------------- lifecycle

    def _unlink(self, lease: _Lease) -> list[dict]:
        with self.lock:
            lease.dead = True
            self.by_wid.pop(lease.wid, None)
            ls = self.leases.get(lease.key)
            if ls and lease in ls:
                ls.remove(lease)
            with lease.lock:
                pending = list(lease.inflight.values())
                lease.inflight.clear()
        return pending

    def _fail_lease(self, lease: _Lease):
        if lease.dead:
            return
        pending = self._unlink(lease)
        try:
            lease.conn.close()
        except Exception:
            pass
        for spec in pending:
            self.core._direct_task_failed(spec, lease)
        self.pump(lease.key)

    def _return_lease(self, lease: _Lease):
        if lease.dead:
            return
        self._unlink(lease)
        try:
            lease.conn.send({"type": "bye"})
        except ConnectionClosed:
            pass
        try:
            lease.conn.close()
        except Exception:
            pass
        try:
            self.core.send_no_reply({"type": "return_lease",
                                     "tokens": {lease.wid: lease.token}})
        except Exception:
            pass

    def revoke(self, wid: str):
        """GCS wants this worker back (pending demand it can serve)."""
        lease = self.by_wid.get(wid)
        if lease is None:
            return
        with self.lock:
            lease.draining = True
            idle = not lease.inflight
        if idle:
            self._return_lease(lease)

    def reap_idle(self):
        """Periodic: pump backlogs, widen pools under them, return leases
        idle past LEASE_IDLE_S."""
        with self.lock:
            backlogged = [k for k, q in self.local_queue.items() if q]
        for key in backlogged:
            self.pump(key)
            self._grow(key, dict(key[0]), key[1], None)
        now = time.monotonic()
        with self.lock:
            busy_keys = {k for k, q in self.local_queue.items() if q}
            idle = [l for ls in self.leases.values() for l in ls
                    if not l.dead and not l.inflight and l.key not in busy_keys
                    and now - l.last_used > LEASE_IDLE_S]
        for lease in idle:
            self._return_lease(lease)

    def shutdown(self):
        with self.lock:
            all_leases = [l for ls in self.leases.values() for l in ls]
            queued = [item for q in self.local_queue.values() for item in q]
            self.local_queue.clear()
        for spec, _pin in queued:
            try:
                self.core._redirect_to_gcs(spec)
            except Exception:
                pass
        for lease in all_leases:
            self._return_lease(lease)
