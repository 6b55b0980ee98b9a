"""DeploymentHandle: the Python-native way to call a deployment.

(reference: python/ray/serve/handle.py:692 DeploymentHandle →
_private/router.py:877 AsyncioRouter.assign_request → power-of-two-choices
replica selection (request_router/pow_2_router.py:27). Here the router keeps
a client-side in-flight count per replica (decremented when the response is
resolved or garbage-collected) and picks the lighter of two random replicas.)
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import weakref

import ray_tpu_torch
from ray_tpu_torch._private.protocol import ConnectionClosed
from ray_tpu_torch.actor import ActorHandle
from ray_tpu_torch.exceptions import DeadlineExceededError, RequestShedError
from ray_tpu_torch.serve import request_context as _rc
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)

ROUTING_REFRESH_S = 1.0

# process-local routing-table source (proxy shards install one backed by
# the controller's shm broadcast): fn(known_version) -> full table dict, or
# None when known_version is already current. When set, in-process routers
# refresh from it instead of RPCing the controller — the sharded proxy's
# request path never blocks on a controller round-trip.
_local_table_source = None


def set_local_table_source(fn) -> None:
    global _local_table_source
    _local_table_source = fn


def _new_cancel_key() -> str:
    """Per-request cancellation address: rides the request to the replica,
    and a later cancel frame / cancel_request() call quotes it back."""
    return os.urandom(8).hex()


def _channel_dead_error():
    """The fast-RPC connection to a replica broke (replica death or
    network): surfaced as ActorDiedError so every retry/drop path treats
    it exactly like an actor-plane replica death."""
    from ray_tpu_torch.exceptions import ActorDiedError

    return ActorDiedError("serve fast-rpc channel to replica closed")


class _Pending:
    """A rid's in-flight slot on a _FastChannel."""

    __slots__ = ("event", "reply", "chan", "rid", "cancel_key")

    def __init__(self, chan=None, rid=None, cancel_key=None):
        self.event = threading.Event()
        self.reply = None
        self.chan = chan
        self.rid = rid
        self.cancel_key = cancel_key

    def wait(self, timeout_s: float | None):
        if not self.event.wait(timeout_s):
            # unregister: a long-lived channel must not accumulate
            # abandoned waiters (and their eventual replies) forever
            if self.chan is not None:
                with self.chan._lock:
                    self.chan._waiters.pop(self.rid, None)
                # a timed-out caller must not leave the replica doing dead
                # work: best-effort cancel so the replica/engine stop and
                # the admission slot frees (the reply, if any, is dropped)
                self.chan.send_cancel(self.cancel_key)
                _rc.count_cancellation("handle")
            raise TimeoutError(f"fast-rpc call timed out after {timeout_s}s")
        if self.reply is None:  # woken by channel death
            raise _channel_dead_error()
        if "result_ref" in self.reply:
            # zero-copy result lane: payloads above the threshold ride the
            # arena object plane — the frame carries only the object-id
            # hex, the bytes move through shm on this fetch
            import ray_tpu_torch

            return ray_tpu_torch.get(ray_tpu_torch.ObjectRef(self.reply["result_ref"]),
                               timeout=30.0)
        if "result_ser" in self.reply or "error_ser" in self.reply:
            # cloudpickle fallback lane (payload the frame codec refused)
            from ray_tpu_torch._private import serialization as ser

            if self.reply.get("ok"):
                return ser.loads(self.reply["result_ser"])
            raise ser.loads(self.reply["error_ser"])
        if self.reply.get("ok"):
            return self.reply.get("result")
        raise self.reply.get("error")


class _FastChannel:
    """One persistent framed connection to a replica's RPC listener;
    rid-tagged requests pipeline, a single recv thread resolves waiters.
    (reference: the Serve proxy holds persistent gRPC streams into
    replicas — serve/_private/replica.py — instead of paying a scheduler
    round-trip per request.)"""

    def __init__(self, addr: tuple):
        from ray_tpu_torch._private.protocol import connect_tcp

        self._conn = connect_tcp(addr[0], addr[1], timeout=5.0)
        self._lock = threading.Lock()
        self._next_rid = 0
        self._waiters: dict[int, _Pending] = {}
        self.dead = False
        threading.Thread(target=self._recv_loop, daemon=True,
                         name="serve-fast-recv").start()

    def _recv_loop(self):
        try:
            while True:
                msg = self._conn.recv()
                with self._lock:
                    w = self._waiters.pop(msg.get("rid"), None)
                if w is not None:
                    w.reply = msg
                    w.event.set()
        except Exception:  # noqa: BLE001 — any break means channel death
            self.dead = True
            with self._lock:
                waiters, self._waiters = list(self._waiters.values()), {}
            for w in waiters:  # wake: their replies will never arrive
                w.event.set()

    def submit(self, method: str, args: tuple, kwargs: dict,
               model_id: str | None, trace_ctx: dict | None = None,
               cancel_key: str | None = None,
               deadline_ts: float | None = None) -> _Pending:
        if self.dead:
            raise _channel_dead_error()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            w = _Pending(self, rid, cancel_key)
            self._waiters[rid] = w
        msg = {"rid": rid, "method": method, "args": args,
               "kwargs": kwargs, "model_id": model_id}
        if cancel_key:
            msg["cancel_key"] = cancel_key
        if deadline_ts:
            msg["deadline_ts"] = deadline_ts
        if trace_ctx:
            # the fast plane bypasses task specs, so the sampled request's
            # context rides the frame itself (the replica activates it
            # around execution — replica._rpc_execute)
            msg["trace_ctx"] = trace_ctx
        try:
            self._conn.send(msg)
        except (ConnectionClosed, ConnectionError, OSError) as e:
            with self._lock:
                self._waiters.pop(rid, None)
            self.dead = True
            raise _channel_dead_error() from e
        except Exception:  # noqa: BLE001 — frame codec rejected the args
            # serialization failure, NOT transport death: retry through
            # cloudpickle (parity with the actor plane, which serializes
            # lambdas/closures fine) without poisoning the channel
            from ray_tpu_torch._private import serialization as ser

            try:
                fb = {"rid": rid, "method": method,
                      "args_ser": ser.dumps((args, kwargs)),
                      "model_id": model_id}
                if cancel_key:
                    fb["cancel_key"] = cancel_key
                if deadline_ts:
                    fb["deadline_ts"] = deadline_ts
                self._conn.send(fb)
            except (ConnectionClosed, ConnectionError, OSError) as e:
                with self._lock:
                    self._waiters.pop(rid, None)
                self.dead = True
                raise _channel_dead_error() from e
            except Exception:
                with self._lock:
                    self._waiters.pop(rid, None)
                raise  # truly unserializable: surface to the caller as-is
        if self.dead:
            # the recv loop may have died (and drained waiters) between our
            # registration and now — make sure this waiter can't hang
            with self._lock:
                self._waiters.pop(rid, None)
            w.event.set()
        return w

    def send_cancel(self, cancel_key: str | None):
        """Best-effort control frame: no rid, no reply expected. The
        replica's conn loop dispatches it straight to cancel_request
        without occupying an rpc-pool slot (a saturated pool is exactly
        when cancels matter most)."""
        if not cancel_key or self.dead:
            return
        try:
            self._conn.send({"cancel_key": cancel_key})
        except (ConnectionClosed, ConnectionError, OSError):
            self.dead = True
        except Exception as e:  # noqa: BLE001 — cancel is best-effort
            logger.debug("cancel frame send failed: %r", e)

    def call(self, method: str, args: tuple, kwargs: dict,
             model_id: str | None, timeout_s: float,
             trace_ctx: dict | None = None,
             cancel_key: str | None = None,
             deadline_ts: float | None = None):
        return self.submit(method, args, kwargs, model_id, trace_ctx,
                           cancel_key, deadline_ts).wait(timeout_s)


_channels: dict[tuple, _FastChannel] = {}
_channels_lock = threading.Lock()


def _get_channel(addr: tuple) -> _FastChannel:
    addr = tuple(addr)
    with _channels_lock:
        ch = _channels.get(addr)
    if ch is not None and not ch.dead:
        return ch
    # connect OUTSIDE the lock — a slow/unreachable replica must not stall
    # every other channel lookup. A racing duplicate connect is benign.
    ch = _FastChannel(addr)  # raises OSError if unreachable
    with _channels_lock:
        _channels[addr] = ch
    return ch


class DeploymentResponse:
    """(reference: serve/handle.py DeploymentResponse — resolvable future;
    passing it to another .remote() call chains without blocking.)"""

    def __init__(self, ref, on_done, cancel=None):
        self._ref = ref
        self._cancel = cancel
        self._finalizer = weakref.finalize(self, on_done)

    def result(self, timeout_s: float | None = None):
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout_s)
        finally:
            self._finalizer()

    def cancel(self):
        """Best-effort: tell the replica to stop this request (interrupt
        its queue wait / engine generation) and release the router slot.
        The caller may still observe a completed result if the reply was
        already in flight."""
        c, self._cancel = self._cancel, None
        if c is not None:
            c()
        self._finalizer()

    def _to_object_ref(self):
        return self._ref


class _FastResponse:
    """DeploymentResponse equivalent for the fast-RPC plane: resolves a
    rid-tagged reply instead of an object ref. Chaining into another
    .remote() materializes through the object store on demand."""

    def __init__(self, pending: "_Pending", on_done, cancel=None):
        self._pending = pending
        self._cancel = cancel
        self._finalizer = weakref.finalize(self, on_done)

    def result(self, timeout_s: float | None = None):
        try:
            return self._pending.wait(timeout_s)
        finally:
            self._finalizer()

    def cancel(self):
        c, self._cancel = self._cancel, None
        if c is not None:
            c()
        # unregister the waiter so a late reply doesn't accumulate
        chan, rid = self._pending.chan, self._pending.rid
        if chan is not None:
            with chan._lock:
                chan._waiters.pop(rid, None)
        self._finalizer()

    def _to_object_ref(self):
        return ray_tpu_torch.put(self.result())


class DeploymentResponseGenerator:
    """Streaming response: iterates values as the replica yields them.

    (reference: serve handles return DeploymentResponseGenerator for
    stream=True — serve/handle.py; transport here is the runtime's
    streaming-generator task.)"""

    def __init__(self, ref_gen, on_done, item_timeout_s: float | None = None,
                 cancel=None):
        self._gen = ref_gen
        self._item_timeout_s = item_timeout_s
        self._cancel = cancel
        self._finalizer = weakref.finalize(self, on_done)

    def __iter__(self):
        return self

    def cancel(self):
        """Abandon the stream mid-flight: fire the replica-side cancel (so
        the generator — and through it the engine — stops producing), close
        the transport generator, and release the router slot."""
        c, self._cancel = self._cancel, None
        if c is not None:
            c()
        close = getattr(self._gen, "close", None)
        if close is not None:
            try:
                close()
            except Exception as e:  # noqa: BLE001 — teardown is best-effort
                logger.debug("stream close failed: %r", e)
        self._finalizer()

    close = cancel  # generator-protocol alias (contextlib.closing etc.)

    def __next__(self):
        try:
            ref = next(self._gen)
        except StopIteration:
            self._finalizer()
            raise
        except Exception:
            self._finalizer()
            raise
        # per-ITEM timeout: a wedged replica mid-stream must surface as an
        # error to the consumer (e.g. the PD proxy), not hang it forever
        try:
            return ray_tpu_torch.get(ref, timeout=self._item_timeout_s)
        except Exception:
            # release the router's in-flight slot NOW — deferring to GC
            # keeps the wedged replica's count elevated while the caller
            # handles (and retains a traceback reference to) the error
            self._finalizer()
            raise


class _Router:
    def __init__(self, deployment_full_name: str, controller):
        self.name = deployment_full_name
        self.controller = controller  # may be None: resolved lazily by name
        self.version = -1
        self.replicas: list[str] = []
        self.addrs: dict[str, tuple] = {}  # replica actor_id -> fast-RPC addr
        self.inflight: dict[str, int] = {}
        # per-replica client-side admission window (max_ongoing +
        # max_queued when the deployment bounds its queue, else None =
        # unbounded): pick() sheds instead of queueing when EVERY replica
        # is already at the window from this client's perspective
        self.window: int | None = None
        self._lock = threading.Lock()
        self._last_refresh = 0.0
        self._pending_table = None  # in-flight get_routing_table ref
        self._prefix_policy = None  # created when the table asks for it

    def _controller_handle(self):
        c = self.controller
        if c is not None:
            return c
        from ray_tpu_torch.serve.api import _resolve_controller

        # single resolve attempt (timeout 0): _refresh runs on the REQUEST
        # path, so an outage must cost one fast lookup, not a retry loop
        self.controller = _resolve_controller(timeout_s=0.0)
        return self.controller

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < ROUTING_REFRESH_S:
            return
        self._last_refresh = now
        with self._lock:  # snapshot: version is written under this lock
            known_version = self.version
        src = _local_table_source
        if src is not None:
            # shm-backed source (proxy shards): version-checked local read,
            # no controller RPC on the request path. A source failure falls
            # back to the cached table, same as an RPC outage would.
            try:
                table = src(known_version)
            except Exception as e:  # noqa: BLE001 — keep serving cached
                logger.debug("local table source failed: %r", e)
                return
            if table is not None:
                self._apply_table(table)
            return
        try:
            # the table fetch is ASYNC with a short completion wait: during
            # a controller outage (crash-restart queues the call) pick()
            # must keep serving from the version-cached table after a
            # bounded pause, not hang for the restart's duration. An
            # unanswered fetch stays pending and is re-checked by the next
            # refresh tick.
            if self._pending_table is None:
                self._pending_table = self._controller_handle() \
                    .get_routing_table.remote(known_version)
            done, _ = ray_tpu_torch.wait([self._pending_table], num_returns=1,
                                   timeout=1.0 if force else 0.25)
            if not done:
                return  # still in flight: serve the cached table
            ref, self._pending_table = self._pending_table, None
            table = ray_tpu_torch.get(ref, timeout=5.0)
        except Exception:  # noqa: BLE001 — controller outage
            # the controller was killed and recreated under the same name
            # (or the call died with it): KEEP SERVING from the cached
            # table — replicas are routed direct, no controller on the
            # request path — and re-resolve the controller next refresh
            self._pending_table = None
            self.controller = None
            return
        if table is None:
            return
        self._apply_table(table)

    def _apply_table(self, table: dict):
        with self._lock:
            self.version = table["version"]
            dep = table["deployments"].get(self.name)
            self.replicas = dep["replicas"] if dep else []
            self.addrs = dict(dep.get("replica_addrs") or {}) if dep else {}
            mq = dep.get("max_queued", -1) if dep else -1
            self.window = (dep.get("max_ongoing", 8) + mq
                           if dep and mq >= 0 else None)
            self.inflight = {r: self.inflight.get(r, 0) for r in self.replicas}
            if dep and dep.get("request_router") == "prefix_aware" \
                    and self._prefix_policy is None:
                from ray_tpu_torch.serve.request_router import PrefixAwarePolicy

                self._prefix_policy = PrefixAwarePolicy()

    def pick(self, hint: str | None = None) -> str:
        """Power-of-two-choices on client-side in-flight counts; deployments
        configured with request_router="prefix_aware" prefer the replica
        that last served the request's prompt prefix (KV reuse)."""
        self._refresh()
        deadline = time.monotonic() + 30.0
        backoff = 0.02
        while not self.replicas:
            if time.monotonic() > deadline:
                raise RuntimeError(f"no replicas for deployment {self.name}")
            time.sleep(backoff)
            backoff = min(backoff * 2, 0.5)  # don't hammer the controller
            self._refresh(force=True)
        with self._lock:
            if self.window is not None and self.replicas and all(
                    self.inflight.get(r, 0) >= self.window
                    for r in self.replicas):
                # every replica already holds a full admission window of
                # this client's requests: queueing more just builds dead
                # backlog — shed fast so the caller can back off / retry
                _rc.count_shed("router")
                raise RequestShedError(
                    f"deployment {self.name}: all {len(self.replicas)} "
                    f"replica(s) at in-flight window {self.window}")

            def pow2():
                if len(self.replicas) == 1:
                    return self.replicas[0]
                a, b = random.sample(self.replicas, 2)
                return a if self.inflight.get(a, 0) <= self.inflight.get(b, 0) else b

            if self._prefix_policy is not None:
                choice = self._prefix_policy.pick(
                    self.replicas, self.inflight, hint, pow2)
            else:
                choice = pow2()
            self.inflight[choice] = self.inflight.get(choice, 0) + 1
            return choice

    def done(self, replica: str):
        with self._lock:
            if replica in self.inflight and self.inflight[replica] > 0:
                self.inflight[replica] -= 1

    def drop(self, replica: str):
        """Replica died: force a table refresh next pick."""
        with self._lock:
            self.replicas = [r for r in self.replicas if r != replica]
            self.addrs.pop(replica, None)
            if self._prefix_policy is not None:
                self._prefix_policy.on_replica_dead(replica)
        self._last_refresh = 0.0


class DeploymentHandle:
    def __init__(self, deployment_full_name: str, controller=None,
                 method_name: str = "__call__", multiplexed_model_id: str | None = None,
                 stream: bool = False,
                 stream_item_timeout_s: float | None = None):
        from ray_tpu_torch.serve.api import _get_controller

        self._name = deployment_full_name
        if controller is None:
            # a handle may be (de)serialized on a worker while the
            # controller is mid-recreation: resolve lazily in the router
            # instead of failing construction
            try:
                controller = _get_controller()
            except RuntimeError:
                controller = None
        self._controller = controller
        self._method = method_name
        self._model_id = multiplexed_model_id
        self._stream = stream
        self._stream_item_timeout_s = stream_item_timeout_s
        self._router = _Router(deployment_full_name, self._controller)

    def options(self, *, method_name: str | None = None,
                multiplexed_model_id: str | None = None,
                stream: bool | None = None,
                stream_item_timeout_s: float | None = None,
                **_ignored) -> "DeploymentHandle":
        h = DeploymentHandle.__new__(DeploymentHandle)
        h._name = self._name
        h._controller = self._controller
        h._method = method_name or self._method
        h._model_id = multiplexed_model_id or self._model_id
        h._stream = self._stream if stream is None else stream
        h._stream_item_timeout_s = (self._stream_item_timeout_s
                                    if stream_item_timeout_s is None
                                    else stream_item_timeout_s)
        h._router = self._router  # share in-flight state across method views
        return h

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return self.options(method_name=name)

    def _send_cancel(self, replica_id: str, cancel_key: str | None):
        """Best-effort cancel delivery: fast-RPC control frame when the
        replica has a channel, actor-plane cancel_request otherwise. Never
        raises — cancellation losing a race with completion is fine."""
        if not cancel_key:
            return
        addr = self._router.addrs.get(replica_id)
        if addr is not None:
            try:
                _get_channel(addr).send_cancel(cancel_key)
                return
            except OSError as e:
                logger.debug("fast cancel to %s failed: %r", replica_id, e)
        try:
            ActorHandle(replica_id).cancel_request.remote(cancel_key)
        except Exception as e:  # noqa: BLE001 — replica may be gone already
            logger.debug("actor cancel to %s failed: %r", replica_id, e)

    def call_sync(self, *args, timeout_s: float = 60.0,
                  _routing_hint=None, _deadline_ts: float | None = None,
                  **kwargs):
        """Submit AND wait, retrying replica-death failures on surviving
        replicas (reference: Serve's proxy retries requests whose replica
        died). Semantics are AT-LEAST-ONCE: a replica may have executed the
        request's side effects before dying, so only the client's answer is
        known lost — non-idempotent deployments should dedup by request id.
        All attempts share ONE deadline (timeout_s total, not per attempt),
        so a caller's budget can't silently stretch 4x. Unlike
        remote().result(), a death observed at RESULT time also drops the
        replica from the router before re-picking; without that, retries
        keep landing on the same dead replica until the table refreshes."""
        import time as _time

        from ray_tpu_torch.exceptions import (ActorDiedError, GetTimeoutError,
                                              WorkerCrashedError)

        if _deadline_ts:
            budget = _rc.deadline_remaining(_deadline_ts)
            if budget <= 0:
                # per-hop refusal: don't ship work downstream that can't
                # finish inside the caller's deadline
                _rc.count_cancellation("handle")
                raise DeadlineExceededError(
                    f"call_sync to {self._name}: deadline already expired "
                    f"({-budget:.3f}s past) before dispatch")
            timeout_s = min(timeout_s, budget)
        deadline = _time.monotonic() + timeout_s
        last: Exception | None = None
        tctx = _tracing.inject()  # None unless this request was sampled
        for _ in range(4):
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                if last is None:
                    last = GetTimeoutError(
                        f"call_sync to {self._name} timed out after "
                        f"{timeout_s}s before any attempt completed")
                break
            t_pick = _time.perf_counter()
            cancel_key = _new_cancel_key()  # fresh per attempt: a retry
            # must not be killable by the previous attempt's stale cancel
            replica_id = self._router.pick(_routing_hint)
            # ONE release per attempt, in the outer finally: return,
            # continue and raise all route through it, so nothing between
            # pick() and the transport call (phase observes, address
            # lookup) can strand the router's in-flight slot — the slot
            # leak class the resource-leak static check flags
            try:
                _rc.observe_phase(_rc.HANDLE_PHASE, "pick",
                                  _time.perf_counter() - t_pick)
                t_rtt = _time.perf_counter()
                ch = None
                addr = self._router.addrs.get(replica_id)
                if addr is not None:
                    try:
                        ch = _get_channel(addr)
                    except OSError:
                        # unroutable from THIS host (not replica death):
                        # the actor plane below still works — don't drop it
                        ch = None
                if ch is not None:
                    # fast data plane: one framed round-trip on a
                    # persistent socket, no per-request task submission
                    try:
                        result = ch.call(self._method, args, kwargs,
                                         self._model_id, remaining, tctx,
                                         cancel_key, _deadline_ts)
                        _rc.observe_phase(_rc.HANDLE_PHASE, "rtt",
                                          _time.perf_counter() - t_rtt)
                        return result
                    except TimeoutError as e:
                        last = e
                        continue  # deadline loop exits when budget spent
                    except ActorDiedError as e:
                        # transport failures surface ONLY as
                        # ActorDiedError (submit/recv wrap socket errors)
                        # — a user exception that happens to subclass
                        # OSError must NOT be read as replica death and
                        # drop a healthy replica
                        last = e
                        self._router.drop(replica_id)
                        continue
                replica = ActorHandle(replica_id)
                try:
                    ref = replica.handle_request.remote(
                        self._method, args, kwargs, self._model_id,
                        cancel_key, _deadline_ts)
                except Exception as e:  # submission failed: replica gone
                    last = e
                    self._router.drop(replica_id)
                    continue
                try:
                    result = ray_tpu_torch.get(ref, timeout=remaining)
                    _rc.observe_phase(_rc.HANDLE_PHASE, "rtt",
                                      _time.perf_counter() - t_rtt)
                    return result
                except GetTimeoutError as e:
                    # the caller's budget is spent but the replica is still
                    # executing: best-effort cancel so the admission slot
                    # and engine resources free now, not at completion
                    self._send_cancel(replica_id, cancel_key)
                    _rc.count_cancellation("handle")
                    if _deadline_ts:
                        raise DeadlineExceededError(str(e)) from e
                    raise
                except (ActorDiedError, WorkerCrashedError) as e:
                    last = e
                    self._router.drop(replica_id)
            finally:
                self._router.done(replica_id)
        if _deadline_ts and isinstance(last, TimeoutError) \
                and not isinstance(last, DeadlineExceededError):
            # the budget that ran out WAS the request's deadline: surface
            # it as such (the HTTP proxy maps this to 504, not 500)
            raise DeadlineExceededError(str(last)) from last
        raise last

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.worker import ObjectRef

        args = tuple(a._to_object_ref()
                     if isinstance(a, (DeploymentResponse, _FastResponse))
                     else a for a in args)
        kwargs = {k: (v._to_object_ref()
                      if isinstance(v, (DeploymentResponse, _FastResponse))
                      else v)
                  for k, v in kwargs.items()}
        hint = kwargs.pop("_routing_hint", None)
        deadline_ts = kwargs.pop("_deadline_ts", None)
        # object-ref arguments need the task plane's ref resolution — the
        # fast channel ships plain values only
        has_refs = (any(isinstance(a, ObjectRef) for a in args)
                    or any(isinstance(v, ObjectRef) for v in kwargs.values()))
        last_err = None
        tctx = _tracing.inject()  # None unless this request was sampled
        for _ in range(3):  # retry on replica death with a fresh table
            t_pick = time.perf_counter()
            cancel_key = _new_cancel_key()
            replica_id = self._router.pick(hint)
            # on success the slot's release rides the response object's
            # on_done closure; every OTHER exit from this attempt —
            # handled submit failures below, but also an unexpected raise
            # from instrumentation or response construction — must
            # release it here, or the dead attempt skews pow2 routing
            # against this replica forever
            try:
                _rc.observe_phase(_rc.HANDLE_PHASE, "pick",
                                  time.perf_counter() - t_pick)
                if not self._stream and not has_refs:
                    addr = self._router.addrs.get(replica_id)
                    ch = None
                    if addr is not None:
                        try:
                            ch = _get_channel(addr)
                        except OSError:
                            ch = None  # unroutable: actor plane below
                    if ch is not None:
                        try:
                            pending = ch.submit(
                                self._method, args, kwargs,
                                self._model_id, tctx, cancel_key,
                                deadline_ts)
                            return _FastResponse(
                                pending,
                                lambda r=replica_id: self._router.done(r),
                                lambda r=replica_id, k=cancel_key:
                                    self._send_cancel(r, k))
                        except Exception as e:  # channel down: drop+retry
                            last_err = e
                            self._router.done(replica_id)
                            self._router.drop(replica_id)
                            continue
                replica = ActorHandle(replica_id)
                try:
                    if self._stream:
                        gen = replica.handle_request_stream.options(
                            num_returns="streaming").remote(
                            self._method, args, kwargs, self._model_id,
                            cancel_key, deadline_ts)
                        return DeploymentResponseGenerator(
                            gen, lambda r=replica_id: self._router.done(r),
                            self._stream_item_timeout_s,
                            lambda r=replica_id, k=cancel_key:
                                self._send_cancel(r, k))
                    ref = replica.handle_request.remote(
                        self._method, args, kwargs, self._model_id,
                        cancel_key, deadline_ts)
                    return DeploymentResponse(
                        ref, lambda r=replica_id: self._router.done(r),
                        lambda r=replica_id, k=cancel_key:
                            self._send_cancel(r, k))
                except Exception as e:
                    last_err = e
                    self._router.done(replica_id)
                    self._router.drop(replica_id)
            except BaseException:
                self._router.done(replica_id)
                raise
        raise RuntimeError(f"could not assign request to {self._name}: {last_err}")

    def __reduce__(self):
        return (DeploymentHandle,
                (self._name, None, self._method, self._model_id, self._stream,
                 self._stream_item_timeout_s))
