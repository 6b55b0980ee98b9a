"""Tuner + the trial-driving event loop.

(reference: python/ray/tune/tuner.py:43 (fit:312) and
tune/execution/tune_controller.py:68 — the controller event loop starts trial
actors, consumes their results, applies scheduler decisions, and snapshots
experiment state. Trials here run in TrainWorker actors (the same
run-fn-in-a-thread runner Train uses), one worker per trial.)
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable

import ray_tpu_torch
from ray_tpu_torch.train import storage as storage_mod
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.worker_group import TrainWorker
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune import search as search_mod
from ray_tpu_torch.tune.trial import ERROR, PENDING, RUNNING, TERMINATED, Trial

POLL_INTERVAL_S = 0.05


@dataclass
class TuneConfig:
    """(reference: tune/tune_config.py — metric/mode/num_samples/search_alg/
    scheduler/max_concurrent_trials; `stop` mirrors air.RunConfig(stop=...).)"""

    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    search_alg: search_mod.Searcher | None = None
    scheduler: sched_mod.TrialScheduler | None = None
    max_concurrent_trials: int = 4
    stop: dict | None = None
    time_budget_s: float | None = None


@dataclass
class TuneResult:
    metrics: dict
    config: dict
    checkpoint: Checkpoint | None
    path: str
    error: str | None = None

    @property
    def trial_id(self) -> str:
        return os.path.basename(self.path)


class ResultGrid:
    """(reference: tune/result_grid.py — get_best_result/num_errors/len.)"""

    def __init__(self, results: list[TuneResult], metric: str | None, mode: str):
        self._results = results
        self._metric, self._mode = metric, mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> TuneResult:
        return self._results[i]

    @property
    def errors(self) -> list[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: str | None = None, mode: str | None = None) -> TuneResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set TuneConfig.metric or pass one)")
        ok = [r for r in self._results if metric in r.metrics]
        if not ok:
            raise ValueError("no trial reported metric " + metric)
        return (max if mode == "max" else min)(ok, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([{**r.metrics, **{f"config/{k}": v for k, v in r.config.items()}}
                             for r in self._results])


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: dict | None = None,
                 tune_config: TuneConfig | None = None,
                 run_config: RunConfig | None = None):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig(name="tune_run")
        self._restore_summaries: list[dict] | None = None

    @classmethod
    def restore(cls, path: str, trainable: Callable, *,
                param_space: dict | None = None,
                tune_config: TuneConfig | None = None,
                run_config: RunConfig | None = None) -> "Tuner":
        """Resume a crashed/interrupted experiment from its snapshot:
        finished trials keep their results without re-running, unfinished
        trials restart from their latest checkpoint, and the remaining
        sample budget is generated fresh. `path` may be a storage URI —
        a fresh Tuner on a different host resumes from the same prefix
        (reference: tune/execution/experiment_state.py + Tuner.restore)."""
        backend, base = storage_mod.get_storage_backend(path)
        state_path = storage_mod.join_path(base, "experiment_state.json")
        bak_path = storage_mod.join_path(base, "experiment_state.bak.json")
        if not backend.exists(state_path) and not backend.exists(bak_path):
            raise FileNotFoundError(  # wrong path fails fast, unretried
                f"no experiment snapshot at {state_path}")
        try:
            summaries = json.loads(storage_mod.with_retry(
                backend.read_bytes, state_path, op="read experiment state"))
        except (storage_mod.StorageError, ValueError):
            # canonical snapshot torn mid-overwrite: the backup slot holds
            # the previous good generation — but surface the original
            # corruption when no backup generation was ever written
            if not backend.exists(bak_path):
                raise
            summaries = json.loads(storage_mod.with_retry(
                backend.read_bytes, bak_path, op="read snapshot backup"))
        # the search space / tune config were pickled at fit() start
        # (reference: tuner.pkl written by Tuner for restore)
        pkl_path = storage_mod.join_path(base, "tuner.pkl")
        if (param_space is None or tune_config is None) and backend.exists(pkl_path):
            import cloudpickle

            saved = cloudpickle.loads(storage_mod.with_retry(
                backend.read_bytes, pkl_path, op="read tuner.pkl"))
            param_space = param_space or saved.get("param_space")
            tune_config = tune_config or saved.get("tune_config")
        if run_config is None:
            # keep the original URI (query knobs included) for the root so
            # the restored run reconstructs the same backend behavior
            name = storage_mod.basename(path)
            root = storage_mod.parent(path)
            _b, _q, query = path.partition("?")
            run_config = RunConfig(
                name=name, storage_path=root + (_q + query if query else ""))
        tuner = cls(trainable, param_space=param_space,
                    tune_config=tune_config, run_config=run_config)
        tuner._restore_summaries = summaries
        return tuner

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        backend, exp_dir = storage_mod.resolve_run_storage(self.run_config)
        backend.makedirs(exp_dir)
        try:  # durable search space for Tuner.restore (reference: tuner.pkl)
            import cloudpickle

            storage_mod.with_retry(
                backend.write_bytes,
                storage_mod.join_path(exp_dir, "tuner.pkl"),
                cloudpickle.dumps({"param_space": self.param_space,
                                   "tune_config": self.tune_config}),
                op="write tuner.pkl")
        except Exception:
            pass  # unpicklable user objects: restore needs explicit args
        restored_done: list[Trial] = []
        restored_pending: list[Trial] = []
        if self._restore_summaries:
            for s in self._restore_summaries:
                t = Trial(trial_id=s["trial_id"], config=s["config"],
                          experiment_dir=exp_dir,
                          last_result=s.get("last_result") or {},
                          iteration=s.get("iteration", 0),
                          error=s.get("error"))
                ckpt_path = s.get("checkpoint_path")
                if ckpt_path and backend.exists(ckpt_path):
                    t.latest_checkpoint = Checkpoint(ckpt_path, backend=backend)
                if s["status"] == TERMINATED:
                    t.status = TERMINATED
                    restored_done.append(t)
                else:
                    t.status = PENDING
                    restored_pending.append(t)
        # the searcher replays the FULL variant space; the loop skips
        # suggestions whose config matches a restored trial (exact for grid
        # search, which enumerates deterministically; unseeded random
        # domains may regenerate up to num_samples fresh configs)
        searcher = tc.search_alg or search_mod.BasicVariantGenerator(
            self.param_space, num_samples=tc.num_samples)
        if tc.metric:
            searcher.set_search_properties(tc.metric, tc.mode)
        scheduler = tc.scheduler or sched_mod.FIFOScheduler()
        scheduler.set_search_properties(tc.metric or "_none_", tc.mode)
        loop = _TuneLoop(self._as_train_fn(), exp_dir, searcher, scheduler, tc,
                         restored_done=restored_done,
                         restored_pending=restored_pending,
                         storage_backend=backend,
                         fail_on_persist_error=self.run_config.fail_on_persist_error)
        trials = loop.run()
        results = [
            TuneResult(metrics=t.last_result, config=t.config,
                       checkpoint=t.latest_checkpoint, path=t.trial_dir,
                       error=t.error)
            for t in trials
        ]
        return ResultGrid(results, tc.metric, tc.mode)

    def _as_train_fn(self) -> Callable:
        t = self.trainable
        from ray_tpu_torch.train.trainer import DataParallelTrainer

        if isinstance(t, DataParallelTrainer):
            # Train-in-Tune: each trial runs a full (nested) trainer.fit with
            # the trial config merged into train_loop_config.
            # (reference: Train runs as a single-trial Tune job, SURVEY §2.4.)
            def run_trainer(config):
                import copy

                from ray_tpu_torch.train import session as sess

                trainer = copy.copy(t)
                trainer.config = {**t.config, **config.get("train_loop_config", config)}
                s = sess.get_session()
                trainer.run_config = RunConfig(
                    name="nested", storage_path=s.experiment_dir,
                    failure_config=t.run_config.failure_config,
                    checkpoint_config=t.run_config.checkpoint_config,
                    # inherit the trial's live backend (fault knobs and all):
                    # the session's experiment_dir is the query-stripped URI
                    storage_backend=s.storage_backend,
                    fail_on_persist_error=s.fail_on_persist_error)
                result = trainer.fit()
                sess.report(result.metrics)

            return run_trainer
        return t


class _TuneLoop:
    def __init__(self, train_fn, exp_dir, searcher, scheduler, tc: TuneConfig,
                 restored_done: list[Trial] | None = None,
                 restored_pending: list[Trial] | None = None,
                 storage_backend: "storage_mod.StorageBackend | None" = None,
                 fail_on_persist_error: bool = False):
        from ray_tpu_torch._private import serialization as ser

        self.fn_blob = ser.dumps(train_fn)
        self.exp_dir = exp_dir
        self.storage = storage_backend or storage_mod.LocalBackend()
        self.fail_on_persist_error = fail_on_persist_error
        self.searcher = searcher
        self.scheduler = scheduler
        self.tc = tc
        # finished trials from a restored snapshot keep their results
        self.trials: list[Trial] = list(restored_done or [])
        self._restored_pending = list(restored_pending or [])
        # configs already covered by the snapshot: matching searcher
        # suggestions are consumed without creating a duplicate trial
        self._restored_configs: list[dict] = [
            t.config for t in self.trials + self._restored_pending]
        self._exhausted = False
        self._seq = len(self.trials) + len(self._restored_pending)
        self._dirty = False

    # ------------------------------------------------------------- lifecycle

    def run(self) -> list[Trial]:
        deadline = (time.monotonic() + self.tc.time_budget_s
                    if self.tc.time_budget_s else None)
        while True:
            self._maybe_launch()
            self._poll()
            self._snapshot()
            live = [t for t in self.trials if t.status == RUNNING]
            if deadline and time.monotonic() > deadline:
                for t in live:
                    self._terminate(t)
                break
            if not live and self._exhausted:
                break
            time.sleep(POLL_INTERVAL_S)
        return self.trials

    def _maybe_launch(self):
        # restored unfinished trials restart first, from their checkpoints
        while self._restored_pending:
            running = sum(1 for t in self.trials if t.status == RUNNING)
            if running >= self.tc.max_concurrent_trials:
                return
            trial = self._restored_pending.pop(0)
            self.trials.append(trial)
            self._start(trial, checkpoint=trial.latest_checkpoint)
        while not self._exhausted:
            running = sum(1 for t in self.trials if t.status == RUNNING)
            if running >= self.tc.max_concurrent_trials:
                return
            cfg = self.searcher.suggest(f"trial_{self._seq:04d}")
            if cfg is None:
                self._exhausted = True
                return
            if cfg == "PENDING":
                return
            if cfg in self._restored_configs:
                self._restored_configs.remove(cfg)
                continue  # already covered by the restored snapshot
            trial = Trial(trial_id=f"trial_{self._seq:04d}", config=cfg,
                          experiment_dir=self.exp_dir)
            self._seq += 1
            self.trials.append(trial)
            self._start(trial)

    def _start(self, trial: Trial, checkpoint: Checkpoint | None = None):
        if trial.runner is None:
            trial.runner = TrainWorker.options(num_cpus=1.0).remote(0, 1, {})
        ctx = {"experiment_dir": trial.trial_dir, "experiment_name": trial.trial_id,
               "checkpoint": checkpoint, "local_world_size": 1, "node_rank": 0,
               # continue numbering past prior iterations so a PBT restart
               # never overwrites this trial's earlier checkpoint_* dirs
               "start_iteration": trial.iteration,
               # per-trial storage prefix rides the experiment's backend
               "storage_backend": self.storage,
               "fail_on_persist_error": self.fail_on_persist_error}
        trial.runner.start_train_fn.remote(self.fn_blob, trial.config, ctx, None)
        trial.status = RUNNING
        trial.stopping = False
        self._dirty = True

    def _terminate(self, trial: Trial, error: str | None = None):
        trial.status = ERROR if error else TERMINATED
        trial.error = error
        self._dirty = True
        if trial.runner is not None:
            try:
                ray_tpu_torch.kill(trial.runner)
            except Exception:
                pass
            trial.runner = None
        self.searcher.on_trial_complete(trial.trial_id, trial.last_result,
                                        error=bool(error))
        self.scheduler.on_complete(trial, trial.last_result)

    # ----------------------------------------------------------------- polling

    def _poll(self):
        for trial in self.trials:
            if trial.status != RUNNING:
                continue
            try:
                p = ray_tpu_torch.get(trial.runner.poll.remote(), timeout=30.0)
            except Exception as e:  # runner actor died
                self._terminate(trial, error=f"{type(e).__name__}: {e}")
                continue
            for rep in p["reports"]:
                self._on_report(trial, rep)
            if trial.status != RUNNING:
                continue  # stopped by scheduler decision above
            if p["status"] == "errored":
                self._terminate(trial, error=p["error"])
            elif p["status"] == "finished":
                if trial.exploit_from is not None:
                    self._exploit(trial)
                else:
                    self._terminate(trial)

    def _on_report(self, trial: Trial, rep: dict):
        if trial.stopping:
            return  # decision already made; late reports don't move the result
        trial.iteration += 1
        result = dict(rep["metrics"])
        result.setdefault("training_iteration", trial.iteration)
        trial.last_result = result
        self._dirty = True
        if rep["checkpoint_dir"]:
            trial.latest_checkpoint = Checkpoint(rep["checkpoint_dir"],
                                                 backend=self.storage)
        if self._should_stop(result):
            self._request_stop(trial)
            return
        decision = self.scheduler.on_result(trial, result)
        if decision == sched_mod.STOP:
            self._request_stop(trial)
        elif trial.exploit_from is not None and not trial.stopping:
            trial.stopping = True
            trial.runner.request_stop.remote()  # restart with exploited state

    def _should_stop(self, result: dict) -> bool:
        for k, v in (self.tc.stop or {}).items():
            if k in result and result[k] >= v:
                return True
        return False

    def _request_stop(self, trial: Trial):
        # graceful: the session raises _StopTraining at the next report();
        # the runner may already be finished, which _poll handles either way.
        trial.exploit_from = None
        trial.explore_config = None
        if trial.runner is not None:
            trial.runner.request_stop.remote()
            trial.stopping = True
        else:
            self._terminate(trial)

    def _exploit(self, trial: Trial):
        """PBT hand-off: restart this trial from the donor's checkpoint with
        the explored config. (reference: tune/schedulers/pbt.py _exploit.)"""
        donor: Trial = trial.exploit_from
        trial.exploit_from = None
        trial.config = trial.explore_config or dict(donor.config)
        trial.explore_config = None
        # kill the old runner rather than reuse it: its train thread stops
        # only at its next report() and could still write checkpoints into
        # the trial dir concurrently with the new session
        if trial.runner is not None:
            try:
                ray_tpu_torch.kill(trial.runner)
            except Exception:
                pass
            trial.runner = None
        self._start(trial, checkpoint=donor.latest_checkpoint)

    # ---------------------------------------------------------------- state

    def _snapshot(self):
        """(reference: tune/execution/experiment_state.py — periodic
        experiment-state snapshot enabling Tuner.restore.)"""
        if not self._dirty:
            return
        self._dirty = False
        payload = json.dumps([t.summary() for t in self.trials],
                             default=str).encode()
        try:  # snapshots are advisory: retried, and a persistent storage
            # outage must not kill live trials — the next snapshot catches up
            storage_mod.with_retry(
                self.storage.write_bytes,
                storage_mod.join_path(self.exp_dir, "experiment_state.json"),
                payload, op="snapshot")
        except storage_mod.StorageError:
            self._dirty = True  # rewrite on the next loop tick
            return
        try:  # second slot: a torn/interrupted overwrite of the canonical
            # key must not lose the last good snapshot (restore falls back)
            storage_mod.with_retry(
                self.storage.write_bytes,
                storage_mod.join_path(self.exp_dir, "experiment_state.bak.json"),
                payload, op="snapshot backup")
        except storage_mod.StorageError:
            pass
