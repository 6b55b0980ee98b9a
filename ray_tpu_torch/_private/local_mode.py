"""Local mode: the whole API executed inline in the driver process.

(reference: ray.init(local_mode=True) — used for fast library tests, e.g.
serve's local_testing_mode, serve/_private/local_testing_mode.py:244.)
Implements the same surface as CoreWorker, so the public API layer does not
branch on mode.
"""

from __future__ import annotations

import traceback
from typing import Any, Sequence

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch._private.worker import ObjectRef
from ray_tpu_torch.exceptions import ActorDiedError, RayTaskError


class LocalWorker:
    kind = "local"

    def __init__(self):
        self._objects: dict[str, tuple[bool, Any]] = {}  # oid -> (is_error, value)
        self.actors: dict[str, Any] = {}
        self._named: dict[str, str] = {}
        self._dead_actors: set[str] = set()

    # objects
    def put(self, value: Any, pin: bool = False) -> ObjectRef:
        oid = ObjectID.for_put().hex()
        self._objects[oid] = (False, value)
        return ObjectRef(oid)

    def get_object(self, oid: str, timeout=None) -> Any:
        is_error, value = self._objects[oid]
        if is_error:
            raise value
        return value

    def get(self, refs, timeout=None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        out = [self.get_object(r.hex()) for r in refs]
        return out[0] if single else out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1, timeout=None):
        return list(refs[:num_returns]), list(refs[num_returns:])

    def free(self, refs):
        for r in refs:
            self._objects.pop(r.hex(), None)

    # tasks
    def _run(self, fn, args, kwargs, task_id: str, num_returns: int, name: str):
        try:
            out = fn(*args, **kwargs)
            values = [out] if num_returns == 1 else (list(out) if num_returns else [])
            for i, v in enumerate(values):
                self._objects[f"{task_id}r{i:04d}"] = (False, v)
        except Exception as e:  # noqa: BLE001
            wrapped = RayTaskError(name, traceback.format_exc(), e)
            for i in range(num_returns):
                self._objects[f"{task_id}r{i:04d}"] = (True, wrapped)
        return [ObjectRef(f"{task_id}r{i:04d}") for i in range(num_returns)]

    def submit_task(self, func_blob, args, kwargs, *, func_sha=None, num_returns=1, resources=None,
                    max_retries=0, name="", strategy=None, runtime_env=None):
        fn = ser.loads(func_blob) if isinstance(func_blob, bytes) else func_blob
        args = tuple(self.get_object(a.hex()) if isinstance(a, ObjectRef) else a for a in args)
        kwargs = {k: self.get_object(v.hex()) if isinstance(v, ObjectRef) else v for k, v in kwargs.items()}
        return self._run(fn, args, kwargs, TaskID().hex(), num_returns, name)

    # actors
    def create_actor(self, cls_blob, args, kwargs, *, resources=None, max_restarts=0, max_task_retries=0,
                     name=None, namespace=None, strategy=None,
                     max_concurrency=1, runtime_env=None,
                     concurrency_groups=None, concurrency_group_methods=None,
                     class_name=None):
        cls = ser.loads(cls_blob) if isinstance(cls_blob, bytes) else cls_blob
        aid = ActorID().hex()
        args = tuple(self.get_object(a.hex()) if isinstance(a, ObjectRef) else a for a in args)
        kwargs = {k: self.get_object(v.hex()) if isinstance(v, ObjectRef) else v for k, v in kwargs.items()}
        self.actors[aid] = cls(*args, **kwargs)
        if name:
            self._named[(namespace or self.namespace, name)] = aid
        return aid

    def submit_actor_task(self, actor_id, method_name, args, kwargs, *,
                          num_returns=1, max_task_retries=None,
                          backpressure=None):
        # backpressure: a stream's window; here a generator runs in process
        if actor_id in self._dead_actors:
            # match cluster mode: dead-actor submission yields refs whose
            # get() raises (the reference errors at get, not .remote())
            tid = TaskID().hex()
            err = ActorDiedError(f"actor {actor_id[:8]} is dead")
            n = num_returns if isinstance(num_returns, int) else 1
            for i in range(n):
                self._objects[f"{tid}r{i:04d}"] = (True, err)
            return [ObjectRef(f"{tid}r{i:04d}") for i in range(n)]
        instance = self.actors[actor_id]
        args = tuple(self.get_object(a.hex()) if isinstance(a, ObjectRef) else a for a in args)
        kwargs = {k: self.get_object(v.hex()) if isinstance(v, ObjectRef) else v for k, v in kwargs.items()}
        return self._run(getattr(instance, method_name), args, kwargs, TaskID().hex(),
                         num_returns, method_name)

    def wait_actor_ready(self, actor_id, timeout=None):
        if actor_id in self._dead_actors:
            raise ActorDiedError("actor is dead")

    def kill_actor(self, actor_id, no_restart=True):
        self.actors.pop(actor_id, None)
        self._dead_actors.add(actor_id)

    namespace = "default"

    def effective_namespace(self):
        return self.namespace

    def get_named_actor(self, name, namespace=None):
        # namespace-scoped exactly like cluster mode: local-mode tests must
        # not silently resolve across namespaces
        return self._named.get((namespace or self.namespace, name))

    # kv
    def __init_kv(self):
        if not hasattr(self, "_kv"):
            self._kv = {}
        return self._kv

    def kv_put(self, key, value):
        self.__init_kv()[key] = value

    def kv_get(self, key):
        return self.__init_kv().get(key)

    def kv_keys(self, prefix=""):
        return [k for k in self.__init_kv() if k.startswith(prefix)]

    def kv_del(self, key):
        self.__init_kv().pop(key, None)

    # placement groups: trivially satisfied inline
    def create_pg(self, pg_id, bundles, strategy, name=""):
        if not hasattr(self, "_pgs"):
            self._pgs = {}
        self._pgs[pg_id] = {"name": name, "state": "created", "strategy": strategy,
                            "bundles": bundles, "bundle_nodes": ["node-0"] * len(bundles)}
        from ray_tpu_torch._private.gcs import pg_ready_oid

        self._objects[pg_ready_oid(pg_id)] = (False, True)
        if name:
            self.__init_kv()[f"__pg_name:{name}"] = pg_id

    def remove_pg(self, pg_id):
        if hasattr(self, "_pgs") and pg_id in self._pgs:
            self._pgs[pg_id]["state"] = "removed"

    def pg_wait(self, pg_id, timeout=None):
        return hasattr(self, "_pgs") and self._pgs.get(pg_id, {}).get("state") == "created"

    def pg_table(self):
        return dict(getattr(self, "_pgs", {}))

    def get_named_pg(self, name):
        return self.__init_kv().get(f"__pg_name:{name}")

    def add_node(self, node_id, resources, labels=None):
        pass

    def remove_node(self, node_id):
        pass

    def list_nodes(self):
        return [{"node_id": "node-0", "alive": True, "labels": {},
                 "total": {"CPU": 1.0}, "available": {"CPU": 1.0}}]

    def cluster_state(self):
        return {
            "total_resources": {"CPU": 1.0},
            "available_resources": {"CPU": 1.0},
            "num_workers": 0,
            "num_actors": len(self.actors),
            "pending_tasks": 0,
            "task_counter": {},
            "actors": {},
        }

    def disconnect(self):
        pass
