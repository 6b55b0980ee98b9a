"""The port's training fault tolerance against the JAX package's.

Twins of tests/test_train_chaos.py: collective peer death (survivors name
the dead rank, the group stays poisoned), a group whose peers never come,
an elastic restart after a death inside a collective, a node drain's grace
checkpoint with zero lost steps, the hang watchdog, and the session's
stop flag. Each test starts both runtimes afresh, as the reference's
fixtures do, with each package's own config flags (``RAY_TPU_*`` and the
port's ``RAY_TPU_TORCH_*``), and holds both sides to what the reference
asserts; a side kills only its own runtime's processes.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np
import pytest

from torch_twins import env_name, same, start_sessions, sub

pytestmark = pytest.mark.train_chaos

OP_TIMEOUT_S = 60.0
DETECT_BUDGET_S = 15.0  # < 25% of the op timeout (acceptance criterion)


@pytest.fixture
def liveness_pkgs(monkeypatch):
    import ray_tpu
    import ray_tpu_torch

    for rt in (ray_tpu, ray_tpu_torch):
        monkeypatch.setenv(env_name(rt, "COLLECTIVE_LIVENESS_INTERVAL_S"),
                           "0.25")
    pkgs = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


@pytest.fixture
def train_pkgs():
    pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=12)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _chaos_ring(rt):
    pkg = rt.__name__

    @rt.remote
    class ChaosRing:
        def init_collective_group(self, world_size, rank, backend,
                                  group_name):
            import importlib

            self.col = importlib.import_module(pkg + ".util.collective")
            self.rank = rank
            self.g = group_name
            self.col.init_collective_group(world_size, rank, backend=backend,
                                           group_name=group_name)
            return os.getpid()

        def allreduce(self, n, delay=0.0):
            if delay:
                time.sleep(delay)
            x = np.full((n,), float(self.rank + 1), np.float32)
            out = self.col.allreduce(x, group_name=self.g, timeout=60.0)
            return float(out[0])

    return ChaosRing


def test_sigkill_mid_allreduce_names_dead_rank(liveness_pkgs):
    def scn(rt):
        exc = sub(rt, "exceptions")
        world = 3
        actors = [_chaos_ring(rt).remote() for _ in range(world)]
        pids = rt.get([a.init_collective_group.remote(world, i, "host",
                                                      "chaos_g")
                       for i, a in enumerate(actors)])
        refs = [a.allreduce.remote(1 << 18, 30.0 if i == 2 else 0.0)
                for i, a in enumerate(actors)]
        time.sleep(0.5)
        killed_at = time.monotonic()
        os.kill(pids[2], signal.SIGKILL)
        seen = []
        for ref in refs[:2]:
            with pytest.raises(exc.RayTaskError) as ei:
                rt.get(ref, timeout=DETECT_BUDGET_S + 5.0)
            cause = ei.value.cause
            seen.append((type(cause).__name__, 2 in cause.dead_ranks,
                         "2" in str(cause)))
        detect_ok = time.monotonic() - killed_at < DETECT_BUDGET_S
        t0 = time.monotonic()
        with pytest.raises(exc.RayTaskError) as ei:
            rt.get(actors[0].allreduce.remote(1 << 18), timeout=10.0)
        return (seen, detect_ok, type(ei.value.cause).__name__,
                time.monotonic() - t0 < 5.0)

    same(liveness_pkgs, scn, ([("CollectiveError", True, True)] * 2, True,
                              "CollectiveError", True), serve_cleanup=False)


def test_group_create_timeout_names_missing_ranks(liveness_pkgs):
    def scn(rt):
        with pytest.raises(TimeoutError) as ei:
            sub(rt, "util.collective").init_collective_group(
                3, 0, group_name="never_formed", timeout=1.5)
        return "rank(s) [1, 2]" in str(ei.value)

    same(liveness_pkgs, scn, True, serve_cleanup=False)


def test_collective_death_elastic_restart_converges(liveness_pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, sub(rt, "train")
        marker = str(tmp_path / f"{pkg}_killed_once")

        def train_fn(config):
            import importlib
            import tempfile

            tr = importlib.import_module(pkg + ".train")
            col = importlib.import_module(pkg + ".util.collective")
            ctx = tr.get_context()
            rank, world = ctx.get_world_rank(), ctx.get_world_size()
            start = 0
            ckpt = tr.get_checkpoint()
            if ckpt is not None:
                with ckpt.as_directory() as d:
                    with open(os.path.join(d, "rank_0", "iter.txt")) as f:
                        start = int(f.read()) + 1
            group = f"elastic-{start}-{world}"
            col.init_collective_group(world, rank, group_name=group)
            for i in range(start, 4):
                if rank == 1 and i == 2 and not os.path.exists(
                        config["marker"]):
                    open(config["marker"], "w").close()
                    os._exit(1)
                x = np.full((1 << 18,), float(rank + 1), np.float32)
                out = col.allreduce(x, group_name=group, timeout=60.0)
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "iter.txt"), "w") as f:
                        f.write(str(i))
                    tr.report({"iter": i, "allreduced": float(out[0]),
                               "world": world},
                              checkpoint=tr.Checkpoint.from_directory(d))

        t0 = time.monotonic()
        result = train.DataParallelTrainer(
            train_fn, train_loop_config={"marker": marker},
            scaling_config=train.ScalingConfig(num_workers=2, min_workers=1),
            run_config=train.RunConfig(
                name="coll_death", storage_path=str(tmp_path / pkg),
                failure_config=train.FailureConfig(max_failures=2)),
        ).fit()
        errored = [a for a in result.attempts if a["outcome"] == "errored"]
        m = result.metrics
        return (result.error, os.path.exists(marker), m["iter"],
                m["allreduced"] == sum(r + 1 for r in range(m["world"])),
                bool(errored),
                bool(errored) and ("CollectiveError" in errored[0]["error"]
                                   or "ActorDiedError" in
                                   errored[0]["error"]),
                time.monotonic() - t0 < 45.0)

    same(liveness_pkgs, scn, (None, True, 3, True, True, True, True),
         serve_cleanup=False, sequential=True)


@pytest.fixture
def drain_clusters():
    import ray_tpu
    import ray_tpu_torch

    clusters = []
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
        clusters.append(sub(rt, "cluster_utils").Cluster(head_node_args=dict(
            num_cpus=16, num_workers=2, max_workers=16)))
    yield (ray_tpu, ray_tpu_torch), clusters
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()


def test_drain_grace_checkpoint_zero_lost_steps(drain_clusters, tmp_path):
    pkgs, clusters = drain_clusters
    total = 12

    def scn(rt):
        pkg, train = rt.__name__, sub(rt, "train")
        cluster = clusters[pkgs.index(rt)]
        api = sub(rt, "_private.api")
        step_log = str(tmp_path / f"{pkg}_steps.log")
        node1 = cluster.add_node(num_cpus=4, resources={"SLOT": 1})

        def train_fn(config):
            import importlib
            import tempfile
            import time as _t

            tr = importlib.import_module(pkg + ".train")
            rank = tr.get_context().get_world_rank()
            start = 0
            ckpt = tr.get_checkpoint()
            if ckpt is not None:
                with ckpt.as_directory() as d:
                    shard = sorted(x for x in os.listdir(d)
                                   if x.startswith("rank_"))[0]
                    with open(os.path.join(d, shard, "iter.txt")) as f:
                        start = int(f.read()) + 1
            for i in range(start, config["total"]):
                _t.sleep(0.12)
                with open(config["log"], "a") as f:
                    f.write(f"{rank}:{i}\n")
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "iter.txt"), "w") as f:
                        f.write(str(i))
                    tr.report({"iter": i, "resumed_from": start},
                              checkpoint=tr.Checkpoint.from_directory(d))

        trainer = train.DataParallelTrainer(
            train_fn, train_loop_config={"total": total, "log": step_log},
            scaling_config=train.ScalingConfig(
                num_workers=2, min_workers=1,
                resources_per_worker={"CPU": 1.0, "SLOT": 1.0}),
            run_config=train.RunConfig(
                name="drain", storage_path=str(tmp_path / pkg),
                failure_config=train.FailureConfig(max_failures=0)),
        )
        box = {}
        t = threading.Thread(target=lambda: box.update(r=trainer.fit()),
                             daemon=True)
        t.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if os.path.exists(step_log) and \
                    len(open(step_log).readlines()) >= 3:
                break
            time.sleep(0.05)
        else:
            return "training never started making progress"
        cluster.add_node(num_cpus=4, resources={"SLOT": 2})
        reply = api._get_worker().rpc(
            {"type": "node_drain", "node_id": node1, "grace_s": 30.0,
             "reason": "test-preemption"})
        nodes = {n["node_id"]: n for n in api._get_worker().list_nodes()}
        t.join(timeout=90.0)
        if t.is_alive():
            return "fit() did not complete after the drain"
        result = box["r"]
        rank0 = [int(line.split(":")[1])
                 for line in open(step_log).read().splitlines()
                 if line.startswith("0:")]
        return (bool(reply.get("ok")), nodes[node1]["draining"],
                result.error, result.metrics["iter"],
                result.metrics["resumed_from"] > 0,
                any(a["outcome"] == "preempted" for a in result.attempts),
                sorted(rank0) == list(range(total)),
                len(rank0) == len(set(rank0)))

    same(pkgs, scn, (True, True, None, total - 1, True, True, True, True),
         serve_cleanup=False, sequential=True)


def test_hang_watchdog_detects_and_restarts(train_pkgs, tmp_path):
    hang_timeout = 2.0

    def scn(rt):
        pkg, train = rt.__name__, sub(rt, "train")
        marker = str(tmp_path / f"{pkg}_hung_once")

        def train_fn(config):
            import importlib
            import tempfile
            import time as _t

            tr = importlib.import_module(pkg + ".train")
            rank = tr.get_context().get_world_rank()
            start = 0
            ckpt = tr.get_checkpoint()
            if ckpt is not None:
                with ckpt.as_directory() as d:
                    with open(os.path.join(d, "rank_0", "iter.txt")) as f:
                        start = int(f.read()) + 1
            for i in range(start, 4):
                if rank == 0 and i == 2 and not os.path.exists(
                        config["marker"]):
                    open(config["marker"], "w").close()
                    _t.sleep(3600)  # wedge: never reaches report()
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "iter.txt"), "w") as f:
                        f.write(str(i))
                    tr.report({"iter": i},
                              checkpoint=tr.Checkpoint.from_directory(d))

        t0 = time.monotonic()
        result = train.DataParallelTrainer(
            train_fn, train_loop_config={"marker": marker},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(
                name="hang", storage_path=str(tmp_path / pkg),
                failure_config=train.FailureConfig(
                    max_failures=1, hang_timeout_s=hang_timeout)),
        ).fit()
        elapsed = time.monotonic() - t0
        hung = [a for a in result.attempts if a["outcome"] == "hung"]
        return (result.error, result.metrics["iter"], os.path.exists(marker),
                bool(hung), bool(hung) and "hang watchdog" in hung[0]["error"],
                bool(hung) and "rank" in hung[0]["error"],
                elapsed < hang_timeout + 30.0)

    same(train_pkgs, scn, (None, 3, True, True, True, True, True),
         serve_cleanup=False, sequential=True)


def test_stop_observed_flag_set_at_step_boundary(tmp_path):
    import ray_tpu
    import ray_tpu_torch

    got = []
    for rt in (ray_tpu, ray_tpu_torch):
        session_mod = sub(rt, "train.session")
        s = session_mod.TrainSession(
            rank=0, world_size=1, local_rank=0, local_world_size=1,
            node_rank=0, experiment_dir=str(tmp_path / rt.__name__),
            experiment_name="unit")
        s.report({"iter": 0})
        before = s.stop_observed
        s.stop_requested = True
        with pytest.raises(session_mod._StopTraining):
            s.report({"iter": 1})
        got.append((before, s.stop_observed, s.last_progress <= time.time()))
    assert got == [(False, True, True)] * 2
