"""Per-worker training session: the in-train-fn API surface.

(reference: train/v2/api/train_fn_utils.py — report/get_context/
get_checkpoint/get_dataset_shard; context.py TrainContext. The session is
process-global inside a training worker; report() persists the checkpoint
synchronously to storage and enqueues the metrics for the controller to
drain on its next poll.)
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any

from ray_tpu_torch.train import storage as storage_mod
from ray_tpu_torch.train._checkpoint import Checkpoint

logger = logging.getLogger(__name__)

_session: "TrainSession | None" = None
_session_lock = threading.Lock()


class TrainContext:
    """(reference: train/v2/api/context.py — rank/size accessors.)"""

    def __init__(self, session: "TrainSession"):
        self._s = session

    def get_world_size(self) -> int:
        return self._s.world_size

    def get_world_rank(self) -> int:
        return self._s.rank

    def get_local_rank(self) -> int:
        return self._s.local_rank

    def get_local_world_size(self) -> int:
        return self._s.local_world_size

    def get_node_rank(self) -> int:
        return self._s.node_rank

    def get_experiment_name(self) -> str:
        return self._s.experiment_name

    def get_trial_name(self) -> str:  # Tune compatibility
        return self._s.experiment_name


class TrainSession:
    def __init__(self, *, rank: int, world_size: int, local_rank: int,
                 local_world_size: int, node_rank: int, experiment_dir: str,
                 experiment_name: str, datasets: dict | None = None,
                 checkpoint: Checkpoint | None = None, sync_actor=None,
                 start_iteration: int = 0,
                 storage_backend: "storage_mod.StorageBackend | None" = None,
                 fail_on_persist_error: bool = False,
                 storage_retry: "storage_mod.RetryConfig | None" = None):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.local_world_size = local_world_size
        self.node_rank = node_rank
        self.experiment_dir = experiment_dir
        self.experiment_name = experiment_name
        self.datasets = datasets or {}
        self.starting_checkpoint = checkpoint
        self.sync_actor = sync_actor
        # storage backend the experiment prefix lives on; checkpoints are
        # two-phase-committed through it (local backend ≈ the old copytree)
        self.storage_backend = storage_backend or storage_mod.LocalBackend()
        self.fail_on_persist_error = fail_on_persist_error
        self.storage_retry = storage_retry or storage_mod.DEFAULT_RETRY
        self.persist_retries = 0   # total retry count, bounded per-op by
        self.persist_failures = 0  # storage_retry.max_attempts
        # restarted attempts continue numbering past the resume checkpoint so
        # checkpoint_NNNNNN dirs are never overwritten across attempts
        self.iteration = start_iteration
        self.reports: list[dict] = []   # drained by TrainWorker.poll
        self._lock = threading.Lock()
        self.stop_requested = False
        # stop_observed tells the controller the train fn actually reached a
        # step boundary after request_stop — a stopping rank is idle by
        # design, not hung, so the watchdog must not count it
        self.stop_observed = False
        # per-step progress heartbeat: stamped at every report(); the
        # watchdog clock starts at session init so a rank wedged before its
        # first step is detected too
        self.last_progress = time.time()
        self.preempt_info: dict | None = None  # set once a grace ckpt landed
        self._coll_seq: dict[str, int] = {}  # per-key collective call counter

    # ------------------------------------------------------------------ api

    def report(self, metrics: dict, checkpoint: Checkpoint | None = None) -> None:
        self.last_progress = time.time()
        idx = self.iteration
        persisted = None
        drain = self._drain_notice()
        if checkpoint is not None:
            persisted = self._persist(checkpoint, idx, metrics)
        # a drain notice + a checkpoint that actually landed = the
        # preemption-grace checkpoint: this step is durable, so exiting the
        # attempt here loses zero steps
        preempted = drain is not None and persisted is not None
        with self._lock:
            # persist_failed distinguishes "tried and degraded" from
            # "metrics-only report": one failed rank vetoes registration of
            # the whole checkpoint on the controller side
            rep = {"iter": idx, "rank": self.rank,
                   "metrics": dict(metrics),
                   "checkpoint_dir": persisted,
                   "persist_failed": (checkpoint is not None
                                      and persisted is None),
                   "storage_retries": self.persist_retries}
            if preempted:
                rep["preempt_checkpoint"] = True
            self.reports.append(rep)
        self.iteration += 1
        if preempted:
            self.preempt_info = {"iter": idx, "node_id": drain.get("node_id"),
                                 "reason": drain.get("reason")}
            self._count_preempt_checkpoint()
            raise _Preempted(self.preempt_info)
        if self.stop_requested:
            self.stop_observed = True
            raise _StopTraining()

    @staticmethod
    def _drain_notice() -> dict | None:
        """The node's sticky drain notice (None while not draining); pushed
        into the worker process by the GCS on node_drain."""
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod.drain_info()

    def _count_preempt_checkpoint(self) -> None:
        from ray_tpu_torch.util import metrics as met

        try:
            met.get_or_create(
                met.Counter, "ray_tpu_train_preempt_checkpoints_total",
                "Preemption-grace checkpoints persisted after a drain notice.",
                tag_keys=("rank",)).inc(tags={"rank": self.rank})
        except Exception:  # noqa: BLE001 — metrics must never fail a report
            logger.debug("preempt-checkpoint counter inc failed", exc_info=True)

    def _persist(self, checkpoint: Checkpoint, idx: int,
                 metrics: dict) -> str | None:
        """Two-phase-commit this rank's checkpoint shard to storage. Returns
        the checkpoint prefix, or None when persisting failed past the retry
        budget and the run is configured to degrade instead of die."""
        backend = self.storage_backend
        ckpt_prefix = storage_mod.join_path(self.experiment_dir,
                                            f"checkpoint_{idx:06d}")
        dest = storage_mod.join_path(ckpt_prefix, f"rank_{self.rank}")
        # world_size rides the manifest so recovery's completeness fallback
        # compares against the WRITING attempt's size, not a later elastic
        # downsize that would make a vetoed partial checkpoint look whole
        meta = {"metrics": dict(metrics), "iteration": idx, "rank": self.rank,
                "world_size": self.world_size}
        try:
            with checkpoint.as_directory() as src:
                if (backend.is_local and checkpoint.backend.is_local
                        and os.path.abspath(src) == os.path.abspath(dest)):
                    # already in place (user wrote straight into storage):
                    # still write manifest + commit so recovery can trust it
                    self._commit_in_place(dest, meta)
                else:
                    stats = storage_mod.persist_directory(
                        backend, src, dest, retry=self.storage_retry, meta=meta)
                    self.persist_retries += stats.retries
            return ckpt_prefix
        except storage_mod.StorageError as e:
            self.persist_failures += 1
            if self.fail_on_persist_error:
                raise
            logger.warning(
                "rank %d: persisting checkpoint_%06d failed past the retry "
                "budget, continuing without it (fail_on_persist_error=False): "
                "%s", self.rank, idx, e)
            return None

    def _commit_in_place(self, dest: str, meta: dict) -> None:
        files = storage_mod.scan_local_files(dest)
        self.persist_retries += storage_mod.write_manifest_and_commit(
            self.storage_backend, dest, files, meta, retry=self.storage_retry)

    def drain_reports(self) -> list[dict]:
        with self._lock:
            out, self.reports = self.reports, []
        return out


class _StopTraining(Exception):
    """Raised inside report() when the controller asked the run to stop."""


class _Preempted(Exception):
    """Raised inside report() once a drain-notice-triggered grace checkpoint
    has durably landed: this node is going away, so the worker exits the
    attempt at the step boundary and the controller restarts elsewhere from
    that checkpoint with zero lost steps."""

    def __init__(self, info: dict | None = None):
        self.info = dict(info or {})
        super().__init__("node draining: preemption-grace checkpoint saved")


def init_session(**kwargs) -> TrainSession:
    global _session
    with _session_lock:
        _session = TrainSession(**kwargs)
        return _session


def shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active — this API is only valid inside a "
            "train_loop_per_worker launched by a Trainer.")
    return _session


# ------------------------------------------------------- public module API


def report(metrics: dict, checkpoint: Checkpoint | None = None) -> None:
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return TrainContext(get_session())


def get_checkpoint() -> Checkpoint | None:
    return get_session().starting_checkpoint


def get_dataset_shard(name: str = "train"):
    return get_session().datasets.get(name)


def report_opt_state(opt_state, rank: int | None = None) -> int:
    """Record this worker's optimizer-state footprint as the
    ``ray_tpu_train_opt_state_bytes`` gauge (per-rank tag), using
    train/optim.py's `optimizer_state_bytes`. The CoreWorker flusher ships
    it into the GCS aggregate, so a ZeRO-sharded run's ~W x smaller
    per-replica state is observable in `metrics_snapshot` — not just in
    the bench. Callable from any train fn (and called automatically by
    zero.ZeroShardedOptimizer); outside a session, pass `rank`.
    Returns the byte count."""
    from ray_tpu_torch.train.optim import optimizer_state_bytes
    from ray_tpu_torch.util import metrics as met

    nbytes = (opt_state if isinstance(opt_state, int)
              else optimizer_state_bytes(opt_state))
    if rank is None:
        rank = _session.rank if _session is not None else 0
    gauge = met.get_or_create(
        met.Gauge, "ray_tpu_train_opt_state_bytes",
        "Optimizer-state bytes held by this training worker.",
        tag_keys=("rank",))
    gauge.set(nbytes, {"rank": rank})
    return nbytes


def _next_coll_key(s: TrainSession, key: str) -> str:
    # every rank calls collectives in the same program order, so a per-key
    # sequence number keeps repeated calls within one iteration distinct
    seq = s._coll_seq.get(key, 0)
    s._coll_seq[key] = seq + 1
    return f"{key}:{seq}"


def collective_barrier(key: str = "barrier") -> None:
    """All workers of the group rendezvous. (reference:
    collective_impl.py barrier:32.)"""
    from ray_tpu_torch.train import sync

    s = get_session()
    sync.barrier(s.sync_actor, _next_coll_key(s, key), s.rank)


def broadcast_from_rank_zero(data: Any = None, key: str = "bcast") -> Any:
    """(reference: collective_impl.py broadcast_from_rank_zero:16.)"""
    from ray_tpu_torch.train import sync

    s = get_session()
    return sync.broadcast_from_rank_zero(
        s.sync_actor, _next_coll_key(s, key), s.rank, data)
