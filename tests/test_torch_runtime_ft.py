"""The port's streaming generators, chaos recovery and GCS fault tolerance
against the JAX package's.

Twins of tests/test_streaming_generators.py, tests/test_chaos.py and
tests/test_gcs_fault_tolerance.py: each scenario runs through ``ray_tpu``
and ``ray_tpu_torch`` (one session per package, both in this process, the
two scenarios on two threads) and both must give the same result. Serve
stands on these paths: streaming generators (handle streams), restartable
named actors (the controller) and the GCS's persisted tables.

Chaos scenarios SIGKILL workers. Each side finds its victims through its
own runtime's worker table (``list_workers``), never by a process-name
glob that could catch the other runtime's workers.
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import sys
import threading
import time

import pytest

from torch_twins import pid_of_actor, same, start_sessions, sub, twin, \
    worker_pids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stop(pkgs):
    for rt in pkgs:
        rt.shutdown()


# ------------------------------------------------ test_streaming_generators


class TestStreamingGenerators:
    @pytest.fixture(scope="class")
    def pkgs(self):
        pkgs = start_sessions(num_cpus=4, num_workers=2, max_workers=6)
        yield pkgs
        _stop(pkgs)

    def test_stream_basic(self, pkgs):
        def scn(rt):
            @rt.remote(num_returns="streaming")
            def gen(n):
                for i in range(n):
                    yield i * 10

            return [rt.get(ref) for ref in gen.remote(5)]

        same(pkgs, scn, [0, 10, 20, 30, 40], serve_cleanup=False)

    def test_stream_incremental_arrival(self, pkgs):
        """Early items are consumable long before the producer finishes."""
        def scn(rt):
            @rt.remote(num_returns="streaming")
            def slow_gen():
                import time as _t

                for i in range(4):
                    yield i
                    _t.sleep(0.8)

            g = slow_gen.remote()
            t0 = time.monotonic()
            first = rt.get(next(iter(g)))
            first_latency = time.monotonic() - t0
            rest = [rt.get(r) for r in g]
            return first, first_latency < 2.5, rest

        same(pkgs, scn, (0, True, [1, 2, 3]), serve_cleanup=False)

    def test_stream_large_items_via_shm(self, pkgs):
        def scn(rt):
            @rt.remote(num_returns="streaming")
            def blocks(n):
                import numpy as np

                for i in range(n):
                    yield np.full((50_000,), i, dtype=np.float64)  # 400 KB

            return [float(rt.get(r)[0]) for r in blocks.remote(6)]

        same(pkgs, scn, [0.0, 1.0, 2.0, 3.0, 4.0, 5.0], serve_cleanup=False)

    def test_stream_error_mid_way(self, pkgs):
        def scn(rt):
            @rt.remote(num_returns="streaming")
            def fails():
                yield 1
                yield 2
                raise ValueError("boom mid-stream")

            it = iter(fails.remote())
            got = [rt.get(next(it)), rt.get(next(it))]
            try:
                next(it)
            except rt.exceptions.RayTaskError as e:
                return got, type(e).__name__, type(e.cause).__name__
            return got, None, None

        same(pkgs, scn, ([1, 2], "RayTaskError", "ValueError"),
             serve_cleanup=False)

    def test_stream_backpressure(self, pkgs):
        """Producer must not run unboundedly ahead of a slow consumer."""
        def scn(rt):
            @rt.remote(num_returns="streaming")
            def fast_gen():
                import time as _t

                for i in range(64):
                    yield (i, _t.monotonic())

            it = iter(fast_gen.remote())
            first_i, _ = rt.get(next(it))
            time.sleep(2.0)  # the consumer stalls
            return [first_i] + [rt.get(r)[0] for r in it]

        same(pkgs, scn, list(range(64)), serve_cleanup=False)

    def test_stream_empty(self, pkgs):
        def scn(rt):
            @rt.remote(num_returns="streaming")
            def empty():
                return
                yield  # pragma: no cover

            return list(empty.remote())

        same(pkgs, scn, [], serve_cleanup=False)

    def test_stream_as_task_pipeline(self, pkgs):
        """Refs from a stream feed downstream tasks without materializing."""
        def scn(rt):
            @rt.remote(num_returns="streaming")
            def produce(n):
                import numpy as np

                for i in range(n):
                    yield np.full((30_000,), i, dtype=np.float64)

            @rt.remote
            def consume(arr):
                return float(arr.sum())

            return rt.get([consume.remote(r) for r in produce.remote(4)])

        same(pkgs, scn, [0.0, 30_000.0, 60_000.0, 90_000.0],
             serve_cleanup=False)


# --------------------------------------------------------------- test_chaos


def _kill(pid: int) -> bool:
    try:
        os.kill(pid, signal.SIGKILL)
        return True
    except ProcessLookupError:
        return False


class TestChaos:
    @pytest.fixture(scope="class")
    def pkgs(self):
        pkgs = start_sessions(num_cpus=8, num_workers=4, max_workers=12)
        yield pkgs
        _stop(pkgs)

    def test_tasks_converge_under_worker_slaughter(self, pkgs):
        """Kill a random worker of the side's own runtime every 0.5 s while
        60 retryable tasks run."""
        def scn(rt):
            @rt.remote(max_retries=20)
            def compute(i):
                import time as _t

                _t.sleep(0.25)
                return i * i

            stop = threading.Event()
            kills = []

            def killer():
                while not stop.is_set():
                    pids = worker_pids(rt)
                    if pids and _kill(random.choice(pids)):
                        kills.append(1)
                    stop.wait(0.5)

            t = threading.Thread(target=killer, daemon=True)
            t.start()
            try:
                refs = [compute.remote(i) for i in range(60)]
                results = rt.get(refs, timeout=180)
            finally:
                stop.set()
                t.join(timeout=5)
            return results, bool(kills)

        same(pkgs, scn, ([i * i for i in range(60)], True),
             serve_cleanup=False)

    def test_actor_calls_survive_restarts(self, pkgs):
        """An infinitely-restartable actor keeps serving across SIGKILLs;
        the caller retries in-flight failures (at-least-once)."""
        def scn(rt):
            @rt.remote(max_restarts=-1)
            class Echo:
                def pid(self):
                    import os

                    return os.getpid()

                def double(self, x):
                    return 2 * x

            a = Echo.remote()
            seen_pids = set()
            for round_no in range(6):
                deadline = time.monotonic() + 60
                while True:
                    try:
                        seen_pids.add(rt.get(a.pid.remote(), timeout=30))
                        assert rt.get(a.double.remote(round_no),
                                      timeout=30) == 2 * round_no
                        break
                    except Exception:
                        if time.monotonic() > deadline:
                            raise
                        time.sleep(0.3)
                if round_no % 2 == 0:
                    for pid in list(seen_pids):
                        _kill(pid)
            rt.kill(a, no_restart=True)
            return len(seen_pids) >= 2

        same(pkgs, scn, True, serve_cleanup=False)

    def test_max_task_retries_inflight_calls_survive_restart(self, pkgs):
        """In-flight method calls lost to a SIGKILL are retried on the
        restarted actor: the caller's get() resolves."""
        def scn(rt):
            @rt.remote(max_restarts=-1, max_task_retries=-1)
            class Slow:
                def pid(self):
                    import os

                    return os.getpid()

                def compute(self, x):
                    import time as _t

                    _t.sleep(1.0)
                    return x * 10

            a = Slow.remote()
            victim = rt.get(a.pid.remote(), timeout=60)
            ref = a.compute.remote(7)  # in flight while the pid dies
            time.sleep(0.3)
            _kill(victim)
            out = rt.get(ref, timeout=120), \
                rt.get(a.pid.remote(), timeout=60) != victim
            rt.kill(a, no_restart=True)
            return out

        same(pkgs, scn, (70, True), serve_cleanup=False)

    def test_zero_task_retries_inflight_calls_fail(self, pkgs):
        def scn(rt):
            @rt.remote(max_restarts=-1)  # max_task_retries defaults to 0
            class Slow:
                def pid(self):
                    import os

                    return os.getpid()

                def compute(self, x):
                    import time as _t

                    _t.sleep(1.0)
                    return x * 10

            a = Slow.remote()
            victim = rt.get(a.pid.remote(), timeout=60)
            ref = a.compute.remote(7)
            time.sleep(0.3)
            _kill(victim)
            # fails fast with the actor-death error (a bare timeout would
            # mean the no-budget path requeued the call)
            try:
                rt.get(ref, timeout=120)
                failed = None
            except Exception as e:  # noqa: BLE001 — the class is the result
                failed = type(e).__name__
            out = failed, rt.get(a.compute.remote(2), timeout=120)
            rt.kill(a, no_restart=True)
            return out

        same(pkgs, scn, ("ActorDiedError", 20), serve_cleanup=False)


_DELAY_SCRIPT = """
import os, sys
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
import {pkg} as rt
rt.init(num_cpus=4, num_workers=2, max_workers=4)

@rt.remote
def add(a, b):
    return a + b

refs = [add.remote(i, i) for i in range(30)]
assert rt.get(refs, timeout=120) == [2 * i for i in range(30)]

@rt.remote
class Acc:
    def __init__(self): self.n = 0
    def inc(self):
        self.n += 1
        return self.n

a = Acc.remote()
vals = [rt.get(a.inc.remote(), timeout=60) for _ in range(10)]
assert vals == list(range(1, 11)), vals
rt.shutdown()
print("DELAY-CHAOS-OK")
"""

_DROP_SCRIPT = """
import os, sys
sys.path.insert(0, {repo!r})
os.environ["JAX_PLATFORMS"] = "cpu"
import {pkg} as rt
rt.init(num_cpus=4, num_workers=2, max_workers=4)

@rt.remote(num_returns="streaming")
def gen(n):
    for i in range(n):
        yield i

out = [rt.get(r) for r in gen.remote(25)]
assert out == list(range(25)), out
rt.shutdown()
print("DROP-CHAOS-OK")
"""


def _run_scripts(script: str, env_suffix: str, value: str) -> list:
    """The script through each package in its own process, with the
    package's own testing env var (RAY_TPU_<suffix> / RAY_TPU_TORCH_
    <suffix>) set; both processes at once."""
    procs = []
    for pkg, prefix in (("ray_tpu", "RAY_TPU_"),
                        ("ray_tpu_torch", "RAY_TPU_TORCH_")):
        env = dict(os.environ)
        env[prefix + env_suffix] = value
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script.format(repo=REPO, pkg=pkg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO))
    out = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stdout + stderr
        out.append(stdout.strip().splitlines()[-1])
    return out


def test_workload_correct_under_message_delay():
    """Latency injection on every control-plane send; results still
    exact."""
    assert _run_scripts(_DELAY_SCRIPT, "TESTING_MSG_DELAY_MS", "5") == \
        ["DELAY-CHAOS-OK"] * 2


def test_droppable_message_chaos():
    """Dropping best-effort messages (log lines, stream acks) must not
    break correctness."""
    assert _run_scripts(_DROP_SCRIPT, "TESTING_MSG_DROP",
                        "log_line,stream_ack:0.5") == ["DROP-CHAOS-OK"] * 2


# -------------------------------------------------- test_gcs_fault_tolerance


@pytest.fixture
def ft_pkgs(tmp_path, monkeypatch):
    """Both runtimes with their GCS tables persisted to sqlite files."""
    import ray_tpu
    import ray_tpu_torch

    monkeypatch.setenv("RAY_TPU_GCS_STORAGE_PATH", str(tmp_path / "j.db"))
    monkeypatch.setenv("RAY_TPU_TORCH_GCS_STORAGE_PATH",
                       str(tmp_path / "t.db"))
    for rt in (ray_tpu, ray_tpu_torch):
        sub(rt, "_private.ray_config").RayConfig.reset()
    pkgs = start_sessions(num_cpus=4, num_workers=1, max_workers=8)
    yield pkgs
    _stop(pkgs)
    monkeypatch.undo()
    for rt in pkgs:
        sub(rt, "_private.ray_config").RayConfig.reset()


def _crash_and_restart_gcs(rt):
    node = sub(rt, "_private.api")._node
    node.gcs.crash_for_testing()
    time.sleep(0.3)
    node.restart_gcs()
    # this process's reconnect loop re-registers within its window
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            if rt.cluster_resources():
                return
        except Exception:  # noqa: BLE001 — still reconnecting
            pass
        time.sleep(0.2)
    raise TimeoutError("driver did not reconnect to the restarted GCS")


def test_gcs_storage_roundtrip(tmp_path):
    def scn(rt):
        GcsStorage = sub(rt, "_private.gcs_storage").GcsStorage
        path = str(tmp_path / f"{rt.__name__}.db")
        st = GcsStorage(path)
        st.put("kv", "a", b"1")
        st.put("kv", "b", {"x": [1, 2]})
        st.delete("kv", "a")
        got = st.get("kv", "a"), st.get("kv", "b")
        st.close()
        st2 = GcsStorage(path)
        items = dict(st2.items("kv"))
        st2.close()
        return got, items

    import ray_tpu
    import ray_tpu_torch

    same((ray_tpu, ray_tpu_torch), scn,
         ((None, {"x": [1, 2]}), {"b": {"x": [1, 2]}}), serve_cleanup=False)


def test_kv_and_named_pg_survive_gcs_restart(ft_pkgs):
    def scn(rt):
        w = sub(rt, "_private.api")._worker
        w.kv_put("jobs:demo", b"payload")
        pg = sub(rt, "util.placement_group").placement_group(
            [{"CPU": 1}], strategy="PACK", name="ft_pg")
        assert pg.wait(timeout_seconds=30)

        _crash_and_restart_gcs(rt)

        kv = w.kv_get("jobs:demo")
        names = {v.get("name") for v in w.pg_table().values()}
        deadline = time.time() + 30
        replaced = False
        while time.time() < deadline and not replaced:
            replaced = any(v.get("name") == "ft_pg"
                           and v.get("state") == "created"
                           for v in w.pg_table().values())
            time.sleep(0.2)
        return kv, "ft_pg" in names, replaced

    same(ft_pkgs, scn, (b"payload", True, True), serve_cleanup=False)


def test_named_actor_respawns_after_gcs_restart(ft_pkgs):
    def scn(rt):
        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

        c = Counter.options(name="ft_counter", max_restarts=-1).remote()
        before = [rt.get(c.incr.remote(), timeout=30) for _ in range(2)]

        _crash_and_restart_gcs(rt)

        # same identity, fresh state: restarted from its creation spec
        h = rt.get_actor("ft_counter")
        return before, rt.get(h.incr.remote(), timeout=60)

    same(ft_pkgs, scn, ([1, 2], 1), serve_cleanup=False)


def test_killed_actor_stays_dead_after_restart(ft_pkgs):
    def scn(rt):
        @rt.remote
        class A:
            def ping(self):
                return "pong"

        a = A.options(name="ft_dead", max_restarts=-1).remote()
        pong = rt.get(a.ping.remote(), timeout=30)
        rt.kill(a, no_restart=True)
        time.sleep(0.5)

        _crash_and_restart_gcs(rt)

        try:
            rt.get_actor("ft_dead")
            lookup = None
        except Exception as e:  # noqa: BLE001 — the class is the result
            lookup = type(e).__name__
        return pong, lookup

    same(ft_pkgs, scn, ("pong", "ValueError"), serve_cleanup=False)


def test_actor_pids_come_from_each_runtimes_own_table(ft_pkgs):
    """The chaos twins' victim lookup: an actor's pid, read from its own
    runtime's worker table, is that runtime's worker and not the other's."""
    def scn(rt):
        @rt.remote
        class P:
            def pid(self):
                import os

                return os.getpid()

        a = P.remote()
        pid = rt.get(a.pid.remote(), timeout=60)
        found = pid_of_actor(rt, a.actor_id)
        rt.kill(a)
        return pid == found, pid

    (ja, jpid), (ta, tpid) = twin(ft_pkgs, scn, serve_cleanup=False)
    assert ja and ta and jpid != tpid
