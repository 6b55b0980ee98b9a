"""DAG nodes: build lazily with .bind(), run with .execute() or compile.

The port's copy of ray_tpu/dag/dag_node.py.

(reference: python/ray/dag/dag_node.py (base), input_node.py:InputNode,
output_node.py:MultiOutputNode, class_node.py (actor-method binding),
compiled_dag_node.py:805 CompiledDAG — compile pre-plans a static execution
schedule (topological, per-actor serialized) so repeated executions skip
graph traversal and argument re-resolution (:2002 _build_execution_schedule).

Execution maps each node to the existing task/actor planes: FunctionNode →
task submit, ClassMethodNode → ordered actor submit; intermediate values
never return to the driver — downstream nodes consume upstream ObjectRefs.)
"""

from __future__ import annotations

from typing import Any

import ray_tpu_torch


class DAGNode:
    def __init__(self, args: tuple, kwargs: dict):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # ------------------------------------------------------------- traversal

    def _upstream(self) -> list["DAGNode"]:
        ups = [a for a in self._bound_args if isinstance(a, DAGNode)]
        ups += [v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)]
        return ups

    def _topo(self) -> list["DAGNode"]:
        order: list[DAGNode] = []
        seen: set[int] = set()

        def visit(n: DAGNode):
            if id(n) in seen:
                return
            seen.add(id(n))
            for u in n._upstream():
                visit(u)
            order.append(n)

        visit(self)
        return order

    # ------------------------------------------------------------- execution

    def _resolve(self, values: dict, input_value) -> tuple[tuple, dict]:
        def sub(a):
            return values[id(a)] if isinstance(a, DAGNode) else a

        args = tuple(sub(a) for a in self._bound_args)
        kwargs = {k: sub(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs

    def _submit(self, args: tuple, kwargs: dict):
        raise NotImplementedError

    def execute(self, input_value: Any = None):
        """Eager one-shot execution; returns ObjectRef(s) of this node."""
        values: dict[int, Any] = {}
        for node in self._topo():
            if isinstance(node, InputNode):
                values[id(node)] = input_value
            elif isinstance(node, MultiOutputNode):
                values[id(node)] = [values[id(u)] for u in node._upstream()]
            else:
                args, kwargs = node._resolve(values, input_value)
                values[id(node)] = node._submit(args, kwargs)
        return values[id(self)]

    def experimental_compile(self, *, max_inflight_executions: int = 10,
                             enable_channel_execution: bool = True,
                             channel_buffer_bytes: int = 1 << 20,
                             enable_retry: bool = False) -> "CompiledDAG":
        """Compile the graph for repeated steady-state execution. When the
        topology allows (actor-method nodes only, every actor on the
        driver's host), per-actor execution loops are provisioned over
        mutable-shm channels and each step skips the task-submission
        control plane entirely; otherwise the cached-schedule submit path
        is used (`CompiledDAG.fallback_reason` says why).

        `enable_retry` mirrors `max_task_retries` semantics for the channel
        plane's exec-loop recovery: when an actor with restart budget dies
        mid-step, the driver retains each in-flight input row and REPLAYS
        it over the rewired plane (execution becomes at-least-once on
        surviving actors; results stay exactly-once at the driver). Default
        off: in-flight steps then surface per-step errors naming the dead
        node while the recovered DAG keeps serving later executions."""
        return CompiledDAG(self,
                           max_inflight_executions=max_inflight_executions,
                           enable_channel_execution=enable_channel_execution,
                           channel_buffer_bytes=channel_buffer_bytes,
                           enable_retry=enable_retry)


class InputNode(DAGNode):
    """(reference: dag/input_node.py — context-manager style `with InputNode()
    as inp:`.)"""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _submit(self, args, kwargs):
        return self._fn.remote(*args, **kwargs)


class ClassMethodNode(DAGNode):
    def __init__(self, actor_method, args, kwargs):
        super().__init__(args, kwargs)
        self._method = actor_method

    def _submit(self, args, kwargs):
        return self._method.remote(*args, **kwargs)


class MultiOutputNode(DAGNode):
    """(reference: dag/output_node.py — groups several leaves.)"""

    def __init__(self, outputs: list[DAGNode]):
        super().__init__(tuple(outputs), {})


class AwaitableDAGFuture:
    """Shared future protocol for both execution planes: marks the handle
    for `ray_tpu_torch.get()` resolution and adapts blocking `.result()`
    to `await` (subclasses provide `result`)."""

    __dag_future__ = True  # ray_tpu_torch.get() resolves these via .result()

    def __await__(self):
        import asyncio

        # get_event_loop() is deprecated and raises on 3.12 without a
        # running loop; awaiting implies one is running
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(None, self.result)
        return fut.__await__()


class DAGFuture(AwaitableDAGFuture):
    """Handle to one in-flight compiled-DAG execution: blocking `.result()`
    or `await` (reference: compiled execute_async returns an awaitable,
    compiled_dag_node.py:2627)."""

    def __init__(self, output):
        self._output = output

    def _refs(self):
        return (self._output if isinstance(self._output, list)
                else [self._output])

    def done(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs(),
                                      num_returns=len(self._refs()),
                                      timeout=0)
        return len(ready) == len(self._refs())

    def result(self, timeout: float | None = None):
        vals = ray_tpu_torch.get(self._refs(), timeout=timeout)
        return vals if isinstance(self._output, list) else vals[0]

    @property
    def refs(self):
        return self._output


class CompiledDAG:
    """(reference: dag/compiled_dag_node.py:805 — the compiled form caches
    a static execution schedule; execute()/execute_async() are the
    steady-state entry points (:2546, :2627); in-flight executions overlap
    up to max_inflight_executions, pipelining the actors.)

    Two execution planes:
    - channel plane (default when eligible): per-actor exec loops over
      mutable-shm channels, provisioned once at compile time — a step is
      one channel write + one channel read, no task submission at all;
    - submit plane (fallback): the cached schedule is replayed through
      `.remote()` per step. `fallback_reason` records why."""

    def __init__(self, root: DAGNode, *, max_inflight_executions: int = 10,
                 enable_channel_execution: bool = True,
                 channel_buffer_bytes: int = 1 << 20,
                 enable_retry: bool = False):
        import uuid

        self._root = root
        self._max_inflight = max(1, int(max_inflight_executions))
        self._inflight: list[DAGFuture] = []
        self._torn = False
        self._dag_id = f"dag-{uuid.uuid4().hex[:12]}"
        # static schedule, computed once: topological, with per-actor op
        # lists so repeated executions skip traversal entirely
        # (reference: _build_execution_schedule, compiled_dag_node.py:2002)
        self._schedule = root._topo()
        self._input_nodes = [n for n in self._schedule if isinstance(n, InputNode)]
        self._channel = None
        self._fallback_reason: str | None = None
        if enable_channel_execution:
            from ray_tpu_torch.dag.channel_execution import try_build

            self._channel, self._fallback_reason = try_build(
                root, self._schedule, max_inflight=self._max_inflight,
                buffer_bytes=channel_buffer_bytes, dag_id=self._dag_id,
                enable_retry=enable_retry)
        else:
            self._fallback_reason = "channel execution disabled by caller"
        # observability: every compile registers its metadata in the GCS
        # DAG table (state API `list_compiled_dags`); teardown
        # deregisters, driver death retires
        self._registered = False
        self._register()

    @property
    def dag_id(self) -> str:
        return self._dag_id

    @property
    def uses_channels(self) -> bool:
        return self._channel is not None

    @property
    def fallback_reason(self) -> str | None:
        return self._fallback_reason

    # ------------------------------------------------------------- registry

    def _registry_record(self) -> dict:
        import time

        nodes = []
        for i, n in enumerate(self._schedule):
            label = ""
            if isinstance(n, FunctionNode):
                label = getattr(n._fn, "__name__", "fn")
            elif isinstance(n, ClassMethodNode):
                label = (f"{getattr(n._method, '_method_name', '?')}"
                         f"@actor:{getattr(n._method, '_actor_id', '?')[:8]}")
            nodes.append({"index": i, "type": type(n).__name__,
                          "label": label,
                          "deps": [self._schedule.index(u)
                                   for u in n._upstream()]})
        actors: list[str] = []
        for n in self._schedule:
            if isinstance(n, ClassMethodNode):
                aid = getattr(n._method, "_actor_id", None)
                if aid and aid not in actors:
                    actors.append(aid)
        ch = self._channel
        return {
            "dag_id": self._dag_id,
            "plane": "channels" if ch is not None else "submit",
            "fallback_reason": self._fallback_reason,
            "nodes": nodes,
            "actors": actors,
            "channels": len(ch._all_chans) if ch is not None else 0,
            "topology": list(ch.topology) if ch is not None else [],
            "max_inflight": self._max_inflight,
            "sample_every": getattr(ch, "_sample", 0) if ch is not None else 0,
            "created_at": time.time(),
        }

    def _register(self) -> None:
        try:
            from ray_tpu_torch._private.api import _get_worker

            w = _get_worker()
            if getattr(w, "rpc", None) is None:
                return  # local mode: no GCS to register with
            w.rpc({"type": "dag_register", "dag": self._registry_record()})
            self._registered = True
        except Exception:  # noqa: BLE001 — observability must not break compile
            pass

    def _deregister(self) -> None:
        if not self._registered:
            return
        self._registered = False
        try:
            from ray_tpu_torch._private.api import _get_worker

            _get_worker().rpc({"type": "dag_deregister",
                               "dag_id": self._dag_id})
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass

    def _submit_once(self, input_value):
        values: dict[int, Any] = {}
        for node in self._schedule:
            if isinstance(node, InputNode):
                values[id(node)] = input_value
            elif isinstance(node, MultiOutputNode):
                values[id(node)] = [values[id(u)] for u in node._upstream()]
            else:
                args, kwargs = node._resolve(values, input_value)
                values[id(node)] = node._submit(args, kwargs)
        return values[id(self._root)]

    def _reap_inflight(self):
        self._inflight = [f for f in self._inflight if not f.done()]
        while len(self._inflight) >= self._max_inflight:
            # backpressure: wait on the oldest execution's refs without
            # materializing its outputs on the driver
            oldest = self._inflight[0]
            ray_tpu_torch.wait(oldest._refs(),
                               num_returns=len(oldest._refs()))
            self._inflight = [f for f in self._inflight if not f.done()]

    def _channel_execute(self, input_value):
        """One channel-plane submission, degrading THIS DAG to the submit
        path when the executor reports an unrecoverable actor death.
        Returns (handled, future)."""
        from ray_tpu_torch.dag.channel_execution import _PlaneDegraded

        try:
            return True, self._channel.execute(input_value)
        except _PlaneDegraded as e:
            self._degrade_to_submit(e.reason)
            return False, None

    def _degrade_to_submit(self, reason: str) -> None:
        """An actor died beyond recovery (no restart budget, cross-host
        restart, or a timed-out rewire): the channel plane was dismantled,
        but the DAG keeps serving on the cached-schedule submit path —
        degrade, don't brick. `fallback_reason` records the death."""
        import logging

        ex, self._channel = self._channel, None
        self._fallback_reason = reason
        logging.getLogger(__name__).warning(
            "compiled DAG %s: channel plane degraded to the submit path "
            "(%s)", self._dag_id, reason)
        try:
            # idempotent on a degraded executor: joins the already-exited
            # loops fast, releases the occupancy claims, retires the
            # driver-side metric series, re-unlinks the shm files
            ex.teardown(raise_on_error=False)
        except Exception:  # noqa: BLE001 — degrade must leave a usable DAG
            pass
        if self._registered:
            self._registered = False
            self._register()  # refresh plane/fallback_reason in the GCS

    def execute(self, input_value: Any = None):
        """Submit one execution. Channel plane → a ChannelDAGFuture
        (`.result()` / `await` / `ray_tpu_torch.get()`); submit plane → the
        output ObjectRef(s). Executions overlap up to the cap."""
        if self._torn:
            raise ValueError(f"compiled DAG {self._dag_id} was torn down")
        if self._channel is not None:
            handled, fut = self._channel_execute(input_value)
            if handled:
                return fut
        self._reap_inflight()
        out = self._submit_once(input_value)
        self._inflight.append(DAGFuture(out))
        return out

    def execute_async(self, input_value: Any = None):
        """Submit one execution; returns a future (`.result()`/`await`)."""
        if self._torn:
            raise ValueError(f"compiled DAG {self._dag_id} was torn down")
        if self._channel is not None:
            handled, fut = self._channel_execute(input_value)
            if handled:
                return fut
        self._reap_inflight()
        fut = DAGFuture(self._submit_once(input_value))
        self._inflight.append(fut)
        return fut

    def visualize(self) -> str:
        """Text rendering of the static schedule (reference: CompiledDAG
        visualize)."""
        lines = []
        for i, n in enumerate(self._schedule):
            kind = type(n).__name__
            deps = [self._schedule.index(u) for u in n._upstream()]
            label = ""
            if isinstance(n, FunctionNode):
                label = getattr(n._fn, "__name__", "fn")
            elif isinstance(n, ClassMethodNode):
                label = (f"{getattr(n._method, '_actor_id', '?')[:8]}."
                         f"{getattr(n._method, '_method_name', '?')}")
            lines.append(f"{i:3d} {kind:16s} {label:24s} deps={deps}")
        if self._channel is not None:
            s = self._channel.stats
            lines.append(f"plane: channels ({s['actors']} exec loops, "
                         f"{s['channels']} shm channels)")
        else:
            lines.append(f"plane: submit ({self._fallback_reason})")
        return "\n".join(lines)

    def teardown(self, raise_on_error: bool = False):
        """Stop the channel plane (close channels, join exec loops, unlink
        /dev/shm files) and settle in-flight submit-plane executions.
        Errors from in-flight steps are logged once; `raise_on_error=True`
        re-raises the first one."""
        if self._torn:
            return
        self._torn = True
        self._deregister()
        errors: list[Exception] = []
        if self._channel is not None:
            errors.extend(e for _aid, e in
                          self._channel.teardown(raise_on_error=False))
        for f in self._inflight:
            try:
                f.result(timeout=5)
            except Exception as e:  # noqa: BLE001 — collected, logged below
                errors.append(e)
        self._inflight = []
        self._schedule = []
        if errors:
            import logging

            logging.getLogger(__name__).warning(
                "CompiledDAG.teardown: %d in-flight execution error(s); "
                "first: %r", len(errors), errors[0])
            if raise_on_error:
                raise errors[0]


def _function_bind(self, *args, **kwargs) -> FunctionNode:
    return FunctionNode(self, args, kwargs)


def _method_bind(self, *args, **kwargs) -> ClassMethodNode:
    return ClassMethodNode(self, args, kwargs)


# graft .bind onto the existing handle types (the reference defines bind on
# RemoteFunction and ActorMethod the same way)
from ray_tpu_torch.actor import ActorMethod  # noqa: E402
from ray_tpu_torch.remote_function import RemoteFunction  # noqa: E402

RemoteFunction.bind = _function_bind
ActorMethod.bind = _method_bind
