"""TrainController: the detached actor that owns a training run.

(reference: train/v2/_internal/execution/controller/controller.py:99 — the
async control loop at :474-499 drives INITIALIZING → SCHEDULING → RUNNING →
(RESTARTING | ERRORED | FINISHED); failure decisions from
failure_handling/default.py:24, scaling decisions from scaling_policy/fixed.py:13.)
"""

from __future__ import annotations

import os
import time

import ray_tpu_torch
from ray_tpu_torch.train import storage as storage_mod
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train.worker_group import WorkerGroup

POLL_INTERVAL_S = 0.05


@ray_tpu_torch.remote
class TrainController:
    def __init__(self, train_fn_blob: bytes, config: dict,
                 scaling_config_blob: bytes, run_config_blob: bytes,
                 backend_blob: bytes | None, datasets_blob: bytes | None):
        from ray_tpu_torch._private import serialization as ser

        self.train_fn_blob = train_fn_blob
        self.config = config or {}
        self.scaling = ser.loads(scaling_config_blob)
        self.run_config = ser.loads(run_config_blob)
        self.backend_blob = backend_blob
        self.datasets = ser.loads(datasets_blob) if datasets_blob else {}
        self.state = "INITIALIZING"
        self.current_workers = self.scaling.num_workers
        self.ckpt_manager = CheckpointManager(self.run_config.checkpoint_config)
        self.failures = 0
        self.latest_metrics: dict = {}
        # one entry per attempt: outcome + reason (hang/preemption forensics)
        self.attempt_log: list[dict] = []
        # sessions reset their cumulative retry counters on restart, so the
        # run total = sum of completed attempts + the live attempt's high-water
        self._retries_prev_attempts = 0
        self._attempt_retries = 0
        self._iter_buffer: dict[int, dict[int, dict]] = {}  # iter → rank → report
        # the storage backend the run's experiment prefix lives on; fault
        # knobs from the storage_path URI query stay on this instance (an
        # explicit run_config.storage_backend — e.g. a nested Train-in-Tune
        # run inheriting its parent's instance — overrides URI dispatch)
        self._storage, self._exp_dir = storage_mod.resolve_run_storage(
            self.run_config)

    def get_state(self) -> str:
        return self.state

    def get_attempt_log(self) -> list[dict]:
        return list(self.attempt_log)

    def run(self) -> dict:
        exp_dir = self._exp_dir
        self._storage.makedirs(exp_dir)
        max_failures = self.run_config.failure_config.max_failures
        error = None
        while True:
            # size THIS attempt first: recovery's completeness fallback
            # compares rank-dir counts against the attempt's world size
            scaling = self._resolve_scaling()
            self._recover_checkpoints_from_storage(exp_dir)
            from ray_tpu_torch._private import serialization as ser

            self.state = "SCHEDULING"
            self._iter_buffer.clear()  # a crashed attempt's partial iters are void
            backend = ser.loads(self.backend_blob) if self.backend_blob else None
            group = WorkerGroup(scaling, backend)
            try:
                group.start()
                self._start_training(group, exp_dir)
                self.state = "RUNNING"
                outcome, error = self._poll_until_done(group)
            except Exception as e:  # noqa: BLE001 — group startup/poll failure
                outcome, error = "errored", f"{type(e).__name__}: {e}"
            finally:
                group.shutdown()
                self._retries_prev_attempts += self._attempt_retries
                self._attempt_retries = 0
            self.attempt_log.append({
                "attempt": len(self.attempt_log) + 1,
                "outcome": outcome,
                "workers": self.current_workers,
                "error": error,
            })
            # controller-side cluster event, shipped to the GCS by the host
            # worker's telemetry flusher (cluster_events_report)
            from ray_tpu_torch._private import constants as _const
            from ray_tpu_torch._private.events import emit_event
            emit_event(
                _const.EVENT_TRAIN_ATTEMPT,
                severity=(_const.EVENT_SEVERITY_ERROR if outcome == "errored"
                          else _const.EVENT_SEVERITY_INFO),
                message=f"train attempt {len(self.attempt_log)} "
                        f"{outcome} with {self.current_workers} workers"
                        + (f": {error}" if error else ""),
                source="train-controller",
                attempt=len(self.attempt_log), outcome=outcome,
                workers=self.current_workers, error=error)
            if outcome == "finished":
                self.state = "FINISHED"
                break
            if outcome == "preempted":
                # a node drain is not a failure: the grace checkpoint is
                # durable (zero lost steps), so restart on the surviving
                # nodes without spending the max_failures budget
                self.state = "RESTARTING"
                continue
            self.failures += 1
            if max_failures >= 0 and self.failures > max_failures:
                self.state = "ERRORED"
                break
            self.state = "RESTARTING"  # resume from latest checkpoint
        latest = self.ckpt_manager.latest_checkpoint
        best = self.ckpt_manager.best_checkpoints
        return {
            "state": self.state,
            "metrics": self.latest_metrics,
            "checkpoint": latest,
            "best_checkpoints": best,
            "error": error if self.state == "ERRORED" else None,
            "path": exp_dir,
            "failures": self.failures,
            "attempts": list(self.attempt_log),
            "storage_retries": self._retries_prev_attempts + self._attempt_retries,
        }

    def _resolve_scaling(self):
        """Elastic restart sizing: with min_workers set, size this attempt
        to what the cluster can place right now, in
        [min_workers, num_workers] (reference: elastic ScalingPolicy —
        train/v2/.../scaling_policy; resize happens at attempt boundaries)."""
        import dataclasses

        sc = self.scaling
        if sc.min_workers is None:
            self.current_workers = sc.num_workers
            return sc
        avail = ray_tpu_torch.available_resources()
        per = sc.bundle()
        fit = min((int(avail.get(k, 0.0) // v)
                   for k, v in per.items() if v > 0),
                  default=sc.num_workers)
        n = max(sc.min_workers, min(sc.num_workers, fit))
        self.current_workers = n
        return dataclasses.replace(sc, num_workers=n)

    def _recover_checkpoints_from_storage(self, exp_dir: str) -> None:
        """Register committed checkpoints already on storage that the poll
        loop never saw — a worker that died with reports undrained, or a
        prior controller incarnation on a *different* host. Checkpoints are
        the durable record; controller memory is not.
        (reference: checkpoints live in StorageContext-managed storage and
        survive worker loss — v2/_internal/execution/storage.py.)

        Trust comes from the two-phase commit: every rank prefix must carry
        its commit marker AND a validating manifest. A torn dir (crash
        mid-upload: some files present, no marker / sizes off) is never
        registered, regardless of its checkpoint_* name."""
        tracked = {t.checkpoint.path for t in self.ckpt_manager._tracked}
        for path, meta in storage_mod.list_committed_checkpoints(
                self._storage, exp_dir, self.current_workers, skip=tracked):
            metrics = meta.get("metrics") or dict(self.latest_metrics)
            self.ckpt_manager.register(
                Checkpoint(path, backend=self._storage), dict(metrics))

    def _start_training(self, group: WorkerGroup, exp_dir: str) -> None:
        name = self.run_config.name or os.path.basename(exp_dir)
        shards: dict[int, dict] = {}
        if self.datasets:
            n = self.current_workers
            split_ds = {}
            for ds_name, ds in self.datasets.items():
                split_ds[ds_name] = ds.streaming_split(n)
            for rank in range(n):
                shards[rank] = {k: v[rank] for k, v in split_ds.items()}
        latest = self.ckpt_manager.latest_checkpoint
        start_iteration = 0
        if latest is not None:
            # continue numbering past the resume point: checkpoint_NNNNNN of a
            # prior attempt must never be overwritten by the next one
            base = os.path.basename(latest.path)
            if base.startswith("checkpoint_"):
                start_iteration = int(base.split("_")[1]) + 1
        ctx = {
            "experiment_dir": exp_dir,
            "experiment_name": name,
            "checkpoint": latest,
            "start_iteration": start_iteration,
            "local_world_size": self.current_workers,
            "node_rank": 0,
            # workers persist through the controller's backend instance so
            # URI fault knobs apply uniformly across the run
            "storage_backend": self._storage,
            "fail_on_persist_error": self.run_config.fail_on_persist_error,
        }
        group.start_training(self.train_fn_blob, self.config, ctx,
                             self.backend_blob, shards)

    def _poll_until_done(self, group: WorkerGroup) -> tuple[str, str | None]:
        n = self.current_workers
        hang_timeout = getattr(self.run_config.failure_config,
                               "hang_timeout_s", None)
        while True:
            try:
                polls = group.poll()
            except Exception as e:  # worker actor died (node/process loss)
                return "errored", f"worker group failure: {type(e).__name__}: {e}"
            for p in polls:
                for rep in p["reports"]:
                    self._iter_buffer.setdefault(rep["iter"], {})[rep["rank"]] = rep
            self._consume_complete_iters(n)
            statuses = [p["status"] for p in polls]
            if any(s == "errored" for s in statuses):
                err = next(p["error"] for p in polls if p["status"] == "errored")
                return "errored", err
            if any(s == "preempted" for s in statuses):
                # at least one rank landed its drain-grace checkpoint and
                # exited; drain whatever the others reported, then restart
                info = next((p.get("preempted") for p in polls
                             if p["status"] == "preempted"), None) or {}
                return "preempted", (
                    f"node {info.get('node_id')!r} draining "
                    f"({info.get('reason')}): grace checkpoint saved at "
                    f"iter {info.get('iter')}")
            if all(s == "finished" for s in statuses):
                self._consume_complete_iters(n)
                return "finished", None
            if hang_timeout is not None:
                # a rank that observed request_stop is idle by design; every
                # other running rank must report() within hang_timeout_s
                stuck = [
                    i for i, p in enumerate(polls)
                    if p["status"] == "running"
                    and not p.get("stop_observed")
                    and (p.get("progress_age_s") or 0.0) > hang_timeout]
                if stuck:
                    self._record_hang()
                    return "hung", (
                        f"hang watchdog: rank(s) {stuck} made no step "
                        f"progress for > {hang_timeout}s; killing the "
                        f"attempt and restarting from the latest checkpoint")
            time.sleep(POLL_INTERVAL_S)

    @staticmethod
    def _record_hang() -> None:
        from ray_tpu_torch.util import metrics as met

        try:
            met.get_or_create(
                met.Counter, "ray_tpu_train_hangs_detected_total",
                "Training attempts killed by the hang watchdog.").inc()
        except Exception:  # noqa: BLE001 — metrics must never mask the hang
            import logging

            logging.getLogger(__name__).debug(
                "hang counter inc failed", exc_info=True)

    def _consume_complete_iters(self, n: int) -> None:
        for idx in sorted(self._iter_buffer):
            ranks = self._iter_buffer[idx]
            if len(ranks) < n:
                break  # iteration not complete on all ranks yet
            rank0 = ranks.get(0) or next(iter(ranks.values()))
            self.latest_metrics = rank0["metrics"]
            self._attempt_retries = max(
                self._attempt_retries,
                sum(r.get("storage_retries", 0) for r in ranks.values()))
            ckpt_dir = next((r["checkpoint_dir"] for r in ranks.values()
                             if r["checkpoint_dir"]), None)
            # a rank whose persist degraded past the retry budget vetoes the
            # whole checkpoint: registering (and COMPLETE-marking) a prefix
            # missing that rank's shard would hand recovery a torn resume
            # point (metrics-only reports don't veto — they never tried)
            degraded = any(r.get("persist_failed") for r in ranks.values())
            if ckpt_dir and not degraded:
                self.ckpt_manager.register(
                    Checkpoint(ckpt_dir, backend=self._storage),
                    rank0["metrics"])
            elif ckpt_dir:
                try:  # clear the vetoed prefix: a downsized retry may reuse
                    # this index, and leftover shards from the aborted
                    # attempt must not mix into (or torn-poison) its commit
                    self._storage.delete_prefix(ckpt_dir)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            del self._iter_buffer[idx]
