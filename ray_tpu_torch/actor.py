"""ActorClass / ActorHandle / ActorMethod.

(reference: python/ray/actor.py — ActorClass:1188, ActorHandle:1857. Actor
method calls are ordered per handle, matching the reference's sequential
actor submit queue, src/ray/core_worker/task_submission/sequential_actor_submit_queue.h.)
"""

from __future__ import annotations

from typing import Any

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.constants import (CONCURRENCY_GROUP_ATTR,
                                              TENSOR_TRANSPORT_ATTR)
from ray_tpu_torch.remote_function import _build_resources


def method(*, concurrency_group: str | None = None,
           tensor_transport: str | None = None):
    """Per-method options on actor classes (reference: @ray.method,
    python/ray/actor.py). `concurrency_group` routes the method to a named
    pool declared via @remote(concurrency_groups={...});
    `tensor_transport="device"` keeps returned torch tensors in the owner's
    memory (its card's, for CUDA tensors) and passes them by reference
    (reference: RDT @ray.method(tensor_transport=...),
    gpu_object_manager.py:84). The JAX package's alias "tpu" is refused.
    Return arity is set per call with `.options(num_returns=N)`."""

    def decorate(fn):
        if concurrency_group is not None:
            setattr(fn, CONCURRENCY_GROUP_ATTR, concurrency_group)
        if tensor_transport is not None:
            if tensor_transport != "device":
                raise ValueError(f"tensor_transport must be 'device', got "
                                 f"{tensor_transport!r}")
            setattr(fn, TENSOR_TRANSPORT_ATTR, tensor_transport)
        return fn

    return decorate


class ActorMethod:
    def __init__(self, actor_id: str, method_name: str, num_returns: int = 1,
                 backpressure: int | None = None):
        self._actor_id = actor_id
        self._method_name = method_name
        self._num_returns = num_returns
        self._backpressure = backpressure

    def options(self, *, num_returns=None,
                _generator_backpressure_num_objects=None,
                **_ignored) -> "ActorMethod":
        """`_generator_backpressure_num_objects` (reference: Ray's option of
        that name): how many items a ``num_returns="streaming"`` producer
        may run ahead of its consumer; None keeps the runtime's 16."""
        return ActorMethod(
            self._actor_id, self._method_name,
            self._num_returns if num_returns is None else num_returns,
            self._backpressure if _generator_backpressure_num_objects is None
            else int(_generator_backpressure_num_objects))

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.api import _get_worker

        refs = _get_worker().submit_actor_task(
            self._actor_id, self._method_name, args, kwargs,
            num_returns=self._num_returns, backpressure=self._backpressure,
        )
        if self._num_returns == "streaming":
            return refs  # an ObjectRefGenerator
        return refs[0] if self._num_returns == 1 else refs


class ActorHandle:
    def __init__(self, actor_id: str):
        self._actor_id = actor_id

    @property
    def actor_id(self) -> str:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self._actor_id, name)

    def __repr__(self):
        return f"ActorHandle({self._actor_id[:8]}…)"

    def __reduce__(self):
        # Handles rebind to the receiving process's global worker; the GCS
        # routes calls by actor id regardless of which process submits.
        return (ActorHandle, (self._actor_id,))

    def __ray_ready__(self, timeout: float | None = None):
        from ray_tpu_torch._private.api import _get_worker

        _get_worker().wait_actor_ready(self._actor_id, timeout=timeout)
        return True


_UNSET = object()


class ActorClass:
    def __init__(self, cls, *, num_cpus=None, num_gpus=None, resources=None,
                 max_restarts=0, max_task_retries=0, name=None,
                 namespace=None, lifetime=None,
                 scheduling_strategy=None,
                 max_concurrency=1, runtime_env=None, concurrency_groups=None):
        self._cls = cls
        self._opts = {"num_cpus": num_cpus, "num_gpus": num_gpus, "resources": resources}
        self._resources = _build_resources(num_cpus, num_gpus, resources)
        self._max_restarts = max_restarts
        self._max_task_retries = max_task_retries
        self._name = name
        self._namespace = namespace
        self._strategy = scheduling_strategy
        self._max_concurrency = max_concurrency
        self._runtime_env = runtime_env
        self._concurrency_groups = dict(concurrency_groups or {})
        self._blob: bytes | None = None
        self.__name__ = getattr(cls, "__name__", "Actor")

    def _get_blob(self):
        if self._blob is None:
            ref = ser.class_ref_or_none(self._cls)
            self._blob = ser.dumps(ref if ref is not None else self._cls)
        return self._blob

    def options(self, *, num_cpus=None, num_gpus=None, resources=None,
                max_restarts=None, max_task_retries=None, name=None,
                namespace=None, lifetime=None,
                scheduling_strategy=_UNSET, max_concurrency=None,
                runtime_env=_UNSET, concurrency_groups=None,
                **_ignored) -> "ActorClass":
        ac = ActorClass(
            self._cls,
            num_cpus=self._opts["num_cpus"] if num_cpus is None else num_cpus,
            num_gpus=self._opts["num_gpus"] if num_gpus is None else num_gpus,
            resources=self._opts["resources"] if resources is None else resources,
            max_restarts=self._max_restarts if max_restarts is None else max_restarts,
            max_task_retries=(self._max_task_retries if max_task_retries
                              is None else max_task_retries),
            name=name if name is not None else self._name,
            namespace=namespace if namespace is not None else self._namespace,
            lifetime=lifetime,
            scheduling_strategy=(self._strategy if scheduling_strategy is _UNSET
                                 else scheduling_strategy),
            max_concurrency=(self._max_concurrency if max_concurrency is None
                             else max_concurrency),
            runtime_env=(self._runtime_env if runtime_env is _UNSET
                         else runtime_env),
            concurrency_groups=(self._concurrency_groups
                                if concurrency_groups is None
                                else concurrency_groups),
        )
        ac._blob = self._blob
        return ac

    def _concurrency_group_methods(self) -> dict:
        """method name → declared concurrency group (@ray_tpu_torch.method). The
        map ships in the create spec so the GCS can dispatch group methods
        through their own lane instead of the default FIFO — a control call
        (e.g. a serve health probe) must not wait behind a saturated data
        queue."""
        out = {}
        for klass in reversed(getattr(self._cls, "__mro__", (self._cls,))):
            for name, fn in vars(klass).items():
                group = getattr(fn, CONCURRENCY_GROUP_ATTR, None)
                if group is not None:
                    out[name] = group
        return out

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch._private.api import _get_worker
        from ray_tpu_torch.util.scheduling_strategies import strategy_to_spec

        worker = _get_worker()
        actor_id = worker.create_actor(
            self._get_blob() if worker.kind != "local" else self._cls,
            args,
            kwargs,
            resources=self._resources,
            max_restarts=self._max_restarts,
            max_task_retries=self._max_task_retries,
            name=self._name,
            namespace=self._namespace,
            strategy=strategy_to_spec(self._strategy),
            max_concurrency=self._max_concurrency,
            runtime_env=self._runtime_env,
            concurrency_groups=self._concurrency_groups,
            concurrency_group_methods=self._concurrency_group_methods(),
            class_name=getattr(self._cls, "__name__", None),
        )
        return ActorHandle(actor_id)

    def __call__(self, *args, **kwargs):
        raise TypeError("Actor classes must be instantiated with .remote()")

    @property
    def cls(self):
        return self._cls
