"""Public API implementation: init/shutdown/remote/get/put/wait/kill.

(reference: python/ray/_private/worker.py — init:1427, shutdown:2072,
get:2821, plus the @ray.remote decorator plumbing.)
"""

from __future__ import annotations

import atexit
import inspect
import os
import threading
from typing import Any, Sequence

from ray_tpu_torch._private.local_mode import LocalWorker
from ray_tpu_torch._private.node import Node
from ray_tpu_torch._private.worker import CoreWorker, ObjectRef, set_global_worker
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.exceptions import RayTpuError
from ray_tpu_torch.remote_function import RemoteFunction

_lock = threading.RLock()
_node: Node | None = None
_worker = None  # CoreWorker | LocalWorker
_is_worker_process = False
_namespace_env_set = False  # init(namespace=...) exported the env var


def _get_worker():
    global _worker
    with _lock:
        if _worker is None:
            # inside a worker subprocess, the global CoreWorker is set by worker_main
            from ray_tpu_torch._private.worker import _global_worker as gw

            if gw is not None:
                return gw
            init()
        return _worker


def is_initialized() -> bool:
    from ray_tpu_torch._private.worker import _global_worker as gw

    return _worker is not None or gw is not None


def init(
    *,
    address: str | None = None,
    local_mode: bool = False,
    num_cpus: float | None = None,
    num_gpus: float | None = None,
    resources: dict | None = None,
    num_workers: int = 0,
    max_workers: int = 16,
    ignore_reinit_error: bool = True,
    runtime_env: dict | None = None,
    namespace: str | None = None,
):
    """Start a new session, or join an existing one with `address=` (a GCS
    `host:port` / `unix:<path>`, or env RAY_TPU_TORCH_ADDRESS — how submitted jobs
    and remote drivers attach; reference: ray.init(address=...)).
    Returns a context dict."""
    global _node, _worker
    with _lock:
        if _worker is not None:
            if ignore_reinit_error:
                return {"session_id": getattr(_node, "session_id", "local")}
            raise RayTpuError("ray_tpu_torch already initialized")
        if local_mode or os.environ.get("RAY_TPU_TORCH_LOCAL_MODE") == "1":
            _worker = LocalWorker()
            if namespace:
                _worker.namespace = namespace
            set_global_worker(None)
            return {"session_id": "local"}
        global _namespace_env_set
        if namespace:
            # the driver's namespace scopes its named actors; exported so
            # worker processes spawned for this session inherit it
            # (reference: ray.init(namespace=...))
            os.environ["RAY_TPU_TORCH_NAMESPACE"] = namespace
            _namespace_env_set = True
        address = address or os.environ.get("RAY_TPU_TORCH_ADDRESS")
        if address:
            _worker = CoreWorker(address, os.environ.get("RAY_TPU_TORCH_SESSION"),
                                 kind="driver")
            if namespace:
                _worker.namespace = namespace
            if runtime_env:
                _worker.default_runtime_env = runtime_env
            atexit.register(shutdown)
            return {"session_id": _worker.session_id, "address": address}
        _node = Node(
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            num_workers=num_workers,
            max_workers=max_workers,
        )
        _worker = CoreWorker(_node.socket_path, _node.session_id, kind="driver")
        if namespace:
            _worker.namespace = namespace
        if runtime_env:
            # job-level default: every task/actor without its own runtime_env
            # inherits it (reference: ray.init(runtime_env=...))
            _worker.default_runtime_env = runtime_env
        atexit.register(shutdown)
        if num_workers:
            # block until the pre-spawned pool registers (slow interpreters on
            # small hosts otherwise make scheduling look nondeterministic)
            import time as _time

            deadline = _time.monotonic() + 60.0
            while _time.monotonic() < deadline:
                if _worker.cluster_state()["num_workers"] >= num_workers:
                    break
                # fine-grained poll: a 50ms step quantizes every session
                # start to multiples of it (worker boot is ~300-500ms, so
                # 10ms shaves a mean ~20-40ms off every init in the suite)
                _time.sleep(0.01)
        return {"session_id": _node.session_id, "session_dir": _node.session_dir}


def shutdown():
    global _node, _worker
    with _lock:
        if _worker is not None and isinstance(_worker, CoreWorker):
            _worker.disconnect()
        if _node is not None:
            _node.shutdown()
        _node = None
        _worker = None
        # don't leak this driver's namespace into the next init() in the
        # same process (test isolation) — but never clobber an env var the
        # USER exported themselves
        global _namespace_env_set
        if _namespace_env_set:
            os.environ.pop("RAY_TPU_TORCH_NAMESPACE", None)
            _namespace_env_set = False
        # same isolation story for the node-drain notice: it names a node
        # of the session that just ended, and would read as a phantom
        # preemption to the next init()'s train sessions
        from ray_tpu_torch._private.worker import _reset_drain

        _reset_drain()
        try:
            atexit.unregister(shutdown)
        except Exception:
            pass


def remote(*args, **kwargs):
    """@remote decorator for functions and classes, with or without options."""

    def decorate(obj):
        if inspect.isclass(obj):
            return ActorClass(obj, **kwargs)
        return RemoteFunction(obj, **kwargs)

    if len(args) == 1 and not kwargs and (callable(args[0]) or inspect.isclass(args[0])):
        return decorate(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return decorate


def get(refs, *, timeout: float | None = None):
    if getattr(refs, "__dag_future__", False):
        # compiled-DAG futures (channel plane returns no ObjectRefs at all)
        return refs.result(timeout=timeout)
    if (isinstance(refs, (list, tuple))
            and any(getattr(r, "__dag_future__", False) for r in refs)):
        # lists may mix DAG futures and ObjectRefs; the timeout applies
        # per element (futures resolve in submission order anyway)
        return [get(r, timeout=timeout) for r in refs]
    return _get_worker().get(refs, timeout=timeout)


def put(value: Any) -> ObjectRef:
    return _get_worker().put(value)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1, timeout: float | None = None):
    if any(getattr(r, "__dag_future__", False) for r in refs):
        # channel-plane DAG futures have no ObjectRefs; poll their done()
        # (non-blocking) alongside ordinary refs with wait(timeout=0)
        import time as _time

        worker = _get_worker()
        deadline = (None if timeout is None
                    else _time.monotonic() + timeout)
        want = min(num_returns, len(refs))
        while True:
            ready = [r for r in refs
                     if (r.done() if getattr(r, "__dag_future__", False)
                         else bool(worker.wait([r], num_returns=1,
                                               timeout=0)[0]))]
            if len(ready) >= want or (
                    deadline is not None
                    and _time.monotonic() >= deadline):
                ready = ready[:num_returns]
                ready_ids = {id(r) for r in ready}
                return ready, [r for r in refs if id(r) not in ready_ids]
            _time.sleep(0.005)
    return _get_worker().wait(refs, num_returns=num_returns, timeout=timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _get_worker().kill_actor(actor.actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: str | None = None) -> ActorHandle:
    aid = _get_worker().get_named_actor(name, namespace=namespace)
    if aid is None:
        ns = namespace or _get_worker().namespace
        raise ValueError(f"no actor named {name!r} in namespace {ns!r}")
    return ActorHandle(aid)


def cancel(ref: ObjectRef, *, force: bool = False) -> bool:
    """Cancel the task that produces `ref` (reference: ray.cancel).
    Queued → dequeued, outputs raise a cancellation error. Running →
    interrupted only with force=True (the worker process is killed; the
    task is NOT retried)."""
    w = _get_worker()
    if not hasattr(w, "cancel_task"):
        return False  # local mode runs tasks synchronously
    return w.cancel_task(ref, force=force)


def free(refs: Sequence[ObjectRef]):
    _get_worker().free(refs)


def cluster_resources() -> dict:
    return _get_worker().cluster_state()["total_resources"]


def available_resources() -> dict:
    return _get_worker().cluster_state()["available_resources"]


def cluster_state() -> dict:
    return _get_worker().cluster_state()


def nodes() -> list:
    return _get_worker().list_nodes()


def timeline(filename: str | None = None) -> list:
    """All task events collected by the GCS (reference: ray.timeline() —
    with `filename`, a chrome://tracing JSON is written there too)."""
    w = _get_worker()
    events = (w.rpc({"type": "task_events"}).get("events", [])
              if hasattr(w, "rpc") else [])  # local mode keeps no store
    if hasattr(w, "rpc"):
        # cluster event log rides along as ctrl:<node> rows in the export
        events = events + w.rpc({"type": "list_events"}).get("events", [])
    if filename:
        # write even when empty: callers open the promised file next.
        # Actor rows labeled class/name, like `ray_tpu_torch timeline`.
        from ray_tpu_torch._private.task_events import (export_chrome_trace,
                                                  fetch_worker_names)

        export_chrome_trace(events, filename,
                            fetch_worker_names(w.rpc)
                            if hasattr(w, "rpc") else {})
    return events


class RuntimeContext:
    """(reference: ray.runtime_context.RuntimeContext — ids, namespace,
    accelerator assignment for the calling task/actor/driver.)"""

    def __init__(self, worker):
        self._w = worker

    @property
    def was_current_actor_restarted(self):
        return False

    def get_actor_id(self):
        return getattr(self._w, "current_actor_id", None)

    def get_task_id(self):
        return getattr(self._w, "current_task_id", None)

    def get_worker_id(self):
        return getattr(self._w, "wid", None)

    def get_node_id(self):
        return getattr(self._w, "node_id", "node-0")

    def get_job_id(self):
        return os.environ.get("RAY_TPU_TORCH_JOB_ID") or getattr(
            self._w, "session_id", None)

    @property
    def namespace(self) -> str:
        eff = getattr(self._w, "effective_namespace", None)
        return eff() if callable(eff) else getattr(
            self._w, "namespace", "default")

    def get_accelerator_ids(self) -> dict:
        """GPUs the scheduler granted THIS process (reference:
        get_accelerator_ids / get_gpu_ids). Reads the GCS's own binding
        env, which is set regardless of the CUDA_VISIBLE_DEVICES opt-out."""
        from ray_tpu_torch._private import accelerators

        return {"GPU": [str(c) for c in accelerators.current_worker_gpus()]}

    def get_placement_group_id(self):
        """The PG the CURRENT task was scheduled into, if any (stashed
        from the executing spec's scheduling strategy)."""
        ctx = getattr(self._w, "_task_ctx", None)
        return getattr(ctx, "pg_id", None) if ctx is not None else None


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(_get_worker())
