"""WorkerGroup: the set of actor workers that run one training job.

(reference: train/v2/_internal/execution/worker_group/worker_group.py:104 —
placement-group-backed actor group (:397), train fn run in a thread per
worker (thread_runner.py), polled by the controller.) Counterpart of
ray_tpu/train/worker_group.py; a worker's "GPU" share is its `num_gpus`.
"""

from __future__ import annotations

import os
import threading
import traceback

import ray_tpu_torch
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.sync import SyncActor
from ray_tpu_torch.util.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


@ray_tpu_torch.remote
class TrainWorker:
    """One training worker. Runs the user's train fn in a daemon thread so the
    actor stays responsive to poll() calls.
    (reference: worker_group/worker.py + thread_runner.py.)"""

    def __init__(self, rank: int, world_size: int, env: dict | None = None):
        self.rank = rank
        self.world_size = world_size
        os.environ.update(env or {})
        self._thread: threading.Thread | None = None
        self._status = "idle"
        self._error: str | None = None
        self._session = None
        self._preempt_info: dict | None = None

    def metadata(self) -> dict:
        import socket

        import ray_tpu_torch._private.worker as w

        try:
            ip = socket.gethostbyname(socket.gethostname())
        except OSError:
            ip = "127.0.0.1"
        return {"rank": self.rank, "pid": os.getpid(), "ip": ip,
                "node_id": getattr(w._global_worker, "node_id", "node-0")}

    def start_train_fn(self, train_fn_blob: bytes, config: dict,
                       context: dict, backend_blob: bytes | None) -> None:
        from ray_tpu_torch._private import serialization as ser

        os.environ.update(context.get("env", {}))
        train_fn = ser.loads(train_fn_blob)
        backend = ser.loads(backend_blob) if backend_blob else None
        self._session = session_mod.init_session(
            rank=self.rank, world_size=self.world_size,
            local_rank=context.get("local_rank", self.rank),
            local_world_size=context.get("local_world_size", self.world_size),
            node_rank=context.get("node_rank", 0),
            experiment_dir=context["experiment_dir"],
            experiment_name=context["experiment_name"],
            datasets=context.get("datasets"),
            checkpoint=context.get("checkpoint"),
            sync_actor=context.get("sync_actor"),
            start_iteration=context.get("start_iteration", 0),
            storage_backend=context.get("storage_backend"),
            fail_on_persist_error=context.get("fail_on_persist_error", False),
            storage_retry=context.get("storage_retry"),
        )
        self._status = "running"
        self._error = None

        import inspect

        takes_config = bool(inspect.signature(train_fn).parameters)

        def run():
            try:
                if backend is not None:
                    backend.on_training_start()
                train_fn(config) if takes_config else train_fn()
                self._status = "finished"
            except session_mod._StopTraining:
                self._status = "finished"
            except session_mod._Preempted as e:
                # the grace checkpoint landed; the controller restarts the
                # attempt on surviving nodes without spending failure budget
                self._preempt_info = dict(e.info)
                self._status = "preempted"
            except BaseException:  # noqa: BLE001 — surfaced via poll()
                self._error = traceback.format_exc()
                self._status = "errored"

        self._thread = threading.Thread(target=run, daemon=True, name="train_fn")
        self._thread.start()

    def poll(self) -> dict:
        import time

        s = self._session
        reports = s.drain_reports() if s else []
        # progress rides as an age so the controller never compares a worker
        # wall-clock timestamp against its own clock
        return {"status": self._status, "error": self._error,
                "reports": reports,
                "stop_observed": bool(s is not None and s.stop_observed),
                "progress_age_s": (time.time() - s.last_progress
                                   if s is not None else None),
                "preempted": self._preempt_info}

    def request_stop(self) -> None:
        if self._session:
            self._session.stop_requested = True

    def shutdown_worker(self) -> None:
        session_mod.shutdown_session()


class WorkerGroup:
    """Controller-side handle to the actor group + its placement group."""

    def __init__(self, scaling_config, backend_config=None):
        self.scaling = scaling_config
        self.backend = backend_config
        self.pg = None
        self.sync_actor = None
        self.workers: list = []

    def start(self) -> None:
        n = self.scaling.num_workers
        self.pg = placement_group(self.scaling.bundles(),
                                  strategy=self.scaling.strategy)
        self.pg.wait(timeout_seconds=60.0)
        self.sync_actor = SyncActor.options(num_cpus=0.1).remote(n)
        self.workers = [
            TrainWorker.options(
                num_cpus=self.scaling.bundle().get("CPU", 1.0),
                num_gpus=self.scaling.bundle().get("GPU", 0.0) or None,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg, placement_group_bundle_index=i),
            ).remote(i, n, {})
            for i in range(n)
        ]
        # rank 0's host is the rendezvous coordinator for torch process
        # groups (reference: worker_group.py resolves the master
        # address from the rank-0 worker, not the driver)
        meta = ray_tpu_torch.get([w.metadata.remote() for w in self.workers])
        self.coordinator_ip = meta[0].get("ip", "127.0.0.1")

    def start_training(self, train_fn_blob: bytes, config: dict,
                      base_context: dict, backend_blob: bytes | None,
                      dataset_shards: dict[int, dict] | None = None) -> None:
        n = self.scaling.num_workers
        for rank, w in enumerate(self.workers):
            ctx = dict(base_context)
            ctx["sync_actor"] = self.sync_actor
            ctx["datasets"] = (dataset_shards or {}).get(rank, {})
            ctx["env"] = (self.backend.env_for_worker(rank, n, self.coordinator_ip)
                          if self.backend else {})
            w.start_train_fn.remote(train_fn_blob, config, ctx, backend_blob)

    def poll(self) -> list[dict]:
        return ray_tpu_torch.get([w.poll.remote() for w in self.workers], timeout=60.0)

    def shutdown(self) -> None:
        # actors are per-attempt: kill them so their processes and PG shares
        # are released (a crashed attempt's train thread must not keep
        # writing checkpoints concurrently with the next attempt)
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.sync_actor is not None:
            try:
                ray_tpu_torch.kill(self.sync_actor)
            except Exception:
                pass
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
        self.workers, self.sync_actor, self.pg = [], None, None
