"""The port's multi-host runtime against the JAX package's.

Twins of tests/test_multihost.py (follower hosts, cross-host object pulls,
host failure, a remote driver over TCP, resource views), of the two
host-loss cases of tests/test_object_lifecycle.py, and of the cross-host
cases of tests/test_collective_ring.py, tests/test_data_groupby_join.py and
tests/test_device_objects.py (slow, as their originals are). A follower
HOST is a real node-agent subprocess (``Cluster.add_host``) with its own
shm namespace, joined over TCP, as in the reference's strategy
(tests/test_multihost.py:1-6).

Each scenario makes its own cluster and runs through ``ray_tpu`` and then
``ray_tpu_torch`` (one after the other, tests/torch_twins.py); the two
sides agree: payload bytes by sha256, host and node ids, error class
names. Each side reads its own env names (``RAY_TPU_HOST_ID`` and the
port's ``RAY_TPU_TORCH_HOST_ID``) and leak-checks only its own segments.
"""

from __future__ import annotations

import glob
import hashlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_twins import env_name, is_port, same, sub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkgs():
    import ray_tpu
    import ray_tpu_torch

    return ray_tpu, ray_tpu_torch


def _both(scenario, want=None, **head):
    """scenario(rt, cluster) on a fresh cluster of each package in turn
    (head: 2 CPUs, 1 worker, up to 8), shut down after each side."""
    kw = dict(num_cpus=2, num_workers=1, max_workers=8)
    kw.update(head)

    def scn(rt):
        rt.shutdown()
        cluster = sub(rt, "cluster_utils").Cluster(head_node_args=kw)
        try:
            return scenario(rt, cluster)
        finally:
            cluster.shutdown()

    return same(_pkgs(), scn, want, sequential=True, serve_cleanup=False,
                timeout=300)


def _on(rt, node_id, soft=False):
    return sub(rt, "util.scheduling_strategies").NodeAffinitySchedulingStrategy(
        node_id=node_id, soft=soft)


def _sha(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _gcs(rt):
    return sub(rt, "_private.api")._node.gcs


def _hosts_of(rt, oid) -> list:
    with _gcs(rt).lock:
        return sorted(_gcs(rt).objects[oid].get("hosts", ()))


def _segments(rt, sid) -> list:
    """This package's shm segments of session `sid` (its own prefix)."""
    prefix = sub(rt, "_private.constants").SHM_SESSION_PREFIX
    return sorted(glob.glob(f"/dev/shm/{prefix}{sid}_*"))


def _wait_hosts(rt, oid, n, timeout=10.0) -> list:
    """The object's host set once it has `n` hosts (a pull registers the
    new copy with a one-way message), or as it stands at the timeout."""
    deadline = time.monotonic() + timeout
    got = _hosts_of(rt, oid)
    while len(got) < n and time.monotonic() < deadline:
        time.sleep(0.02)
        got = _hosts_of(rt, oid)
    return got


def _alive(rt, node_id):
    return next((n["alive"] for n in rt.nodes() if n["node_id"] == node_id),
                None)


def _wait_dead(rt, node_id, timeout=30.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _alive(rt, node_id) is False:
            return True
        time.sleep(0.1)
    return False


# ------------------------------------------------ tests/test_multihost.py


def test_follower_host_registers_and_runs_tasks():
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)
        key = env_name(rt, "HOST_ID")
        node_key = env_name(rt, "NODE_ID")

        @rt.remote
        def where_am_i():
            import os

            return {"host": os.environ.get(key, "host-0"),
                    "node": os.environ.get(node_key, "node-0")}

        info = rt.get(where_am_i.options(
            scheduling_strategy=_on(rt, host)).remote(), timeout=60)
        nodes = {n["node_id"]: n for n in rt.nodes()}
        return info, host, nodes[host]["alive"], nodes[host]["total"]

    _both(scn, ({"host": "host-1", "node": "host-1"}, "host-1", True,
                {"CPU": 2.0}))


def test_cross_host_object_pull_to_driver():
    """The object lives in the follower's namespace; the driver's get pulls
    it over TCP and registers the head's copy with the GCS."""
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)

        @rt.remote
        def put_big_array(n):
            import numpy as np

            return rt.put(np.full((n,), 7, dtype=np.float32))

        inner = rt.get(put_big_array.options(
            scheduling_strategy=_on(rt, host)).remote(300_000), timeout=60)
        before = _hosts_of(rt, inner.hex())
        arr = rt.get(inner, timeout=60)  # ~1.2 MB: the shm path
        return arr.shape, float(arr[0]), _sha(arr), before, \
            _wait_hosts(rt, inner.hex(), 2)

    _both(scn)


def test_cross_host_object_pull_to_worker():
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)

        @rt.remote
        def sum_array(arr):
            return float(arr.sum())

        big = np.arange(400_000, dtype=np.float64)  # ~3.2 MB in the head
        ref = rt.put(big)
        total = rt.get(sum_array.options(
            scheduling_strategy=_on(rt, host)).remote(ref), timeout=60)
        return total == float(big.sum()), _wait_hosts(rt, ref.hex(), 2)

    _both(scn, (True, ["host-0", "host-1"]))


def test_two_followers_object_flow():
    """host-b pulls an object living on host-a; a head worker then pulls it
    too, and the bytes are the same everywhere."""
    def scn(rt, cluster):
        h1 = cluster.add_host(num_cpus=1, host_id="host-a")
        h2 = cluster.add_host(num_cpus=1, host_id="host-b")

        @rt.remote
        def put_big_array(n):
            import numpy as np

            return rt.put(np.full((n,), 7, dtype=np.float32))

        @rt.remote
        def digest(arr):
            import hashlib

            return float(arr.sum()), hashlib.sha256(arr.tobytes()).hexdigest()

        inner = rt.get(put_big_array.options(
            scheduling_strategy=_on(rt, h1)).remote(200_000), timeout=60)
        on_b = rt.get(digest.options(
            scheduling_strategy=_on(rt, h2)).remote(inner), timeout=60)
        on_head = rt.get(digest.options(
            scheduling_strategy=_on(rt, "node-0")).remote(inner), timeout=60)
        return on_b, on_head, _wait_hosts(rt, inner.hex(), 3)

    _both(scn)


def test_large_task_result_from_follower():
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)

        @rt.remote
        def make_big(n):
            import numpy as np

            # over the inline limit: the task-result shm path
            return np.full((n,), 3, dtype=np.float32)

        arr = rt.get(make_big.options(
            scheduling_strategy=_on(rt, host)).remote(100_000), timeout=60)
        return arr.shape, float(arr[-1]), _sha(arr)

    _both(scn)


def test_oversized_args_to_follower():
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)

        @rt.remote
        def sum_array(arr):
            return float(arr.sum())

        big = np.ones((200_000,), dtype=np.float64)  # > the inline limit
        return rt.get(sum_array.options(
            scheduling_strategy=_on(rt, host)).remote(big), timeout=60)

    _both(scn, 200_000.0)


def test_host_failure_fails_its_node():
    """Killing the agent fails the host's node; after shutdown no segment
    of the session (the follower's namespace included) is left."""
    sids = {}

    def scn(rt, cluster):
        sids[rt.__name__] = sub(rt, "_private.api")._node.session_id
        host = cluster.add_host(num_cpus=1)
        alive = _alive(rt, host)
        cluster.remove_host(host)
        return alive, _wait_dead(rt, host)

    _both(scn, (True, True))
    for rt in _pkgs():
        assert _segments(rt, sids[rt.__name__]) == []


def test_host_failure_retries_its_task_on_the_head():
    """A task running on a follower whose agent is killed is retried (its
    worker died with the host) and finishes on the head."""
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=1)
        key = env_name(rt, "HOST_ID")

        @rt.remote(max_retries=1)
        def slow_where(started_flag):
            import os
            import time

            if os.environ.get(key, "host-0") != "host-0":
                open(started_flag, "w").close()
                time.sleep(60)
            return os.environ.get(key, "host-0")

        flag = os.path.join(sub(rt, "_private.api")._node.session_dir,
                            "started")
        ref = slow_where.options(
            scheduling_strategy=_on(rt, host, soft=True)).remote(flag)
        deadline = time.monotonic() + 60
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.05)
        started = os.path.exists(flag)
        cluster.remove_host(host)
        return started, rt.get(ref, timeout=120), _wait_dead(rt, host)

    _both(scn, (True, "host-0", True))


def test_remote_driver_joins_by_tcp_address():
    def scn(rt, cluster):
        address = sub(rt, "_private.api")._node.address
        script = (
            f"import {rt.__name__} as rt\n"
            f"rt.init(address={address!r})\n"
            "@rt.remote\n"
            "def f(x):\n"
            "    return x * 3\n"
            "print('joined-result', rt.get(f.remote(14), timeout=60))\n"
        )
        env = dict(os.environ)
        env.pop(env_name(rt, "ADDRESS"), None)
        env.pop(env_name(rt, "STORE_NS"), None)
        r = subprocess.run([sys.executable, "-c", script],
                           capture_output=True, text=True, timeout=120,
                           env=env, cwd=REPO)
        assert r.returncode == 0, r.stdout + r.stderr
        return "joined-result 42" in r.stdout

    _both(scn, True)


def test_sigterm_drains_the_follower_node():
    """SIGTERM to a follower's agent (a preemption notice) drains its node
    through the GCS; the agent keeps serving."""
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=1)
        cluster._agents[host].send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        row = {}
        while time.monotonic() < deadline:
            row = next(n for n in rt.nodes() if n["node_id"] == host)
            if row.get("draining"):
                break
            time.sleep(0.1)
        return (row.get("draining"), row.get("drain_reason"), row["alive"],
                cluster._agents[host].poll())

    _both(scn, (True, "SIGTERM", True, None))


@pytest.mark.slow
def test_resource_view_deltas_reach_gcs():
    """Follower agents broadcast periodic resource-view deltas (reference:
    ray_syncer RESOURCE_VIEW) that surface per node in list_nodes."""
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)
        deadline = time.time() + 20
        view = None
        while time.time() < deadline:
            row = next(n for n in rt.nodes() if n["node_id"] == host)
            if row.get("host_view"):
                view = row["host_view"]
                break
            time.sleep(0.3)
        assert view, "no resource view arrived from the follower agent"
        return (0.0 < view["mem_usage"] < 1.0, view["num_worker_procs"] >= 0,
                view["age_s"] < 10 and not view["stale"])

    _both(scn, (True, True, True))


# ----------------------------------------- tests/test_object_lifecycle.py


def test_reconstruction_after_host_loss():
    """The only copy dies with its host; lineage re-runs the task (its hard
    affinity to the dead node dropped) and the bytes come back equal."""
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)

        @rt.remote
        def make_data(n):
            import numpy as np

            return np.full((n,), 5, dtype=np.float64)

        ref = make_data.options(
            scheduling_strategy=_on(rt, host)).remote(200_000)
        ready, _ = rt.wait([ref], num_returns=1, timeout=30)
        only = _hosts_of(rt, ref.hex())
        cluster.remove_host(host)
        time.sleep(0.5)
        arr = rt.get(ref, timeout=60)
        return bool(ready), only, arr.shape, float(arr[0]), _sha(arr)

    _both(scn)


def test_put_object_lost_is_an_error():
    """put() objects have no lineage: losing the only copy is a hard
    error, of the same class in both packages."""
    def scn(rt, cluster):
        host = cluster.add_host(num_cpus=2)

        @rt.remote
        def putter(n):
            import numpy as np

            return rt.put(np.ones((n,), dtype=np.float64))

        inner = rt.get(putter.options(
            scheduling_strategy=_on(rt, host)).remote(200_000), timeout=30)
        cluster.remove_host(host)
        time.sleep(0.5)
        lost = sub(rt, "exceptions").ObjectLostError
        with pytest.raises(lost) as ei:
            rt.get(inner, timeout=30)
        return type(ei.value).__name__

    _both(scn, "ObjectLostError")


# -------------------------------- cross-host cases of the slow modules


@pytest.mark.slow
def test_ring_collective_cross_host():
    """A 2-rank group split across two follower hosts: the payload bytes
    move host to host through the object plane
    (tests/test_collective_ring.py::test_ring_collective_cross_host)."""
    def scn(rt, cluster):
        pkg = rt.__name__
        h1 = cluster.add_host(num_cpus=2, host_id="col-a")
        h2 = cluster.add_host(num_cpus=2, host_id="col-b")

        @rt.remote
        class RingWorker:
            def init_collective_group(self, world_size, rank, backend,
                                      group_name):
                import importlib

                self.col = importlib.import_module(pkg + ".util.collective")
                self.col.init_collective_group(
                    world_size, rank, backend=backend, group_name=group_name)
                self.rank, self.g = rank, group_name

            def big_allreduce(self, n):
                import numpy as np

                x = np.full((n,), float(self.rank + 1), np.float32)
                out = self.col.allreduce(x, group_name=self.g, timeout=120.0)
                return float(out[0]), float(out[-1]), tuple(out.shape)

        w0 = RingWorker.options(scheduling_strategy=_on(rt, h1)).remote()
        w1 = RingWorker.options(scheduling_strategy=_on(rt, h2)).remote()
        sub(rt, "util.collective").create_collective_group(
            [w0, w1], 2, [0, 1], group_name="xhost")
        return rt.get([w.big_allreduce.remote(1 << 19) for w in (w0, w1)],
                      timeout=240)

    _both(scn, [(3.0, 3.0, (1 << 19,))] * 2, num_cpus=4)


@pytest.mark.slow
def test_groupby_multihost():
    """Hash partitions and aggregate tasks run across a follower host
    (tests/test_data_groupby_join.py::test_groupby_multihost)."""
    def scn(rt, cluster):
        cluster.add_host(num_cpus=2)
        rows = [{"k": i % 5, "v": float(i)} for i in range(500)]
        out = sub(rt, "data").from_items(rows).groupby("k").sum("v").take_all()
        got = sorted((int(r["k"]), float(r["sum(v)"])) for r in out)
        return got == [(k, sum(x["v"] for x in rows if x["k"] == k))
                       for k in range(5)]

    _both(scn, True)


@pytest.mark.slow
def test_device_object_across_follower_hosts():
    """A device object made on one follower host, consumed on another: the
    owner host-stages it once and the consumer's host pulls the bytes
    through the object plane
    (tests/test_device_objects.py::test_device_object_across_follower_hosts).
    The JAX package's producer returns a jax.Array, the port's a tensor."""
    def scn(rt, cluster):
        port = is_port(rt)
        key = env_name(rt, "HOST_ID")
        h1 = cluster.add_host(num_cpus=2, host_id="rdt-a")
        h2 = cluster.add_host(num_cpus=2, host_id="rdt-b")

        @rt.remote
        class Producer:
            @rt.method(tensor_transport="device")
            def make(self, n):
                if port:
                    import torch

                    return torch.arange(float(n))
                import jax.numpy as jnp

                return jnp.arange(float(n))

        @rt.remote
        class Consumer:
            def total(self, arr):
                import os

                return os.environ.get(key), float(arr.sum())

        p = Producer.options(scheduling_strategy=_on(rt, h1)).remote()
        c = Consumer.options(scheduling_strategy=_on(rt, h2)).remote()
        return rt.get(c.total.remote(p.make.remote(4096)), timeout=120)

    _both(scn, ("rdt-b", float(np.arange(4096.0).sum())))


# ------------------------------------------------ the port's agent alone


def test_node_agent_never_imports_torch():
    """The agent needs no tensor and no CUDA context: importing its module
    (what ``python -m ray_tpu_torch._private.node_agent`` runs first)
    leaves torch out of sys.modules, and a live agent that has spawned a
    worker and served a pull has mapped no torch library."""
    code = ("import sys\n"
            "import ray_tpu_torch._private.node_agent\n"
            "print('torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    rt.shutdown()
    cluster = Cluster(head_node_args=dict(num_cpus=2, num_workers=1,
                                          max_workers=8))
    try:
        host = cluster.add_host(num_cpus=1)

        @rt.remote
        def make(n):
            import numpy as np

            return np.ones((n,), dtype=np.float32)

        arr = rt.get(make.options(scheduling_strategy=_on(rt, host)).remote(
            100_000), timeout=60)
        assert float(arr.sum()) == 100_000.0
        with open(f"/proc/{cluster._agents[host].pid}/maps") as f:
            libs = {line.split()[-1] for line in f if ".so" in line}
        # the port's own host libraries live under ray_tpu_torch/build/
        assert not [p for p in libs if "/torch/" in p or "libtorch" in p
                    or "libc10" in p], sorted(libs)
    finally:
        cluster.shutdown()


def test_port_remove_host_takes_its_workers(tmp_path):
    """The port's remove_host loses the whole host: the agent and every
    worker it spawned die together (one process group), a busy worker
    too, where the JAX package kills the agent alone and its workers exit
    after their current task."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster

    rt.shutdown()
    cluster = Cluster(head_node_args=dict(num_cpus=2, num_workers=1,
                                          max_workers=8))
    try:
        host = cluster.add_host(num_cpus=1)
        flag = str(tmp_path / "busy")

        @rt.remote(max_retries=0)
        def busy(path):
            import os
            import time

            with open(path + ".tmp", "w") as f:
                f.write(str(os.getpid()))
            os.replace(path + ".tmp", path)
            time.sleep(60)

        busy.options(scheduling_strategy=_on(rt, host)).remote(flag)
        deadline = time.monotonic() + 60
        while not os.path.exists(flag) and time.monotonic() < deadline:
            time.sleep(0.05)
        with open(flag) as f:
            worker = int(f.read())
        cluster.remove_host(host)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and _state(worker) not in (
                "gone", "Z"):
            time.sleep(0.05)
        assert _state(worker) in ("gone", "Z")
    finally:
        cluster.shutdown()


def _state(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0]
    except OSError:
        return "gone"
