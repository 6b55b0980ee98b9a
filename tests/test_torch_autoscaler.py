"""The port's twins of tests/test_autoscaler.py, against ray_tpu_torch:
the reconciler (demand-driven scale-up, min floors, idle scale-down,
crash-restart recovery) and the LocalNodeProvider, whose agents are the
port's follower node agents; with the port-side check that a "GPU"
resource becomes the agent's ``--num-gpus``.

(reference capability: autoscaler v2 reconciler — autoscaler/v2/autoscaler.py:47,
resource_demand_scheduler.py:100 bin-packing; fake provider pattern from
autoscaler/_private/fake_multi_node/.)
"""

from __future__ import annotations

import time
from typing import Dict, List

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import api as _api
from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeType
from ray_tpu_torch.autoscaler.node_provider import NodeProvider


class FakeProvider(NodeProvider):
    """Records launches/terminations without real processes."""

    def __init__(self):
        self.nodes: Dict[str, str] = {}
        self._n = 0

    def create_node(self, node_type, resources, labels):
        self._n += 1
        nid = f"fake-{self._n}"
        self.nodes[nid] = node_type
        return nid

    def terminate_node(self, node_id):
        self.nodes.pop(node_id, None)

    def non_terminated_nodes(self):
        return list(self.nodes)


@pytest.fixture
def session():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_workers=1, max_workers=8)
    yield
    ray_tpu_torch.shutdown()


def _mk(provider, types, **kw):
    return Autoscaler(f"unix:{_api._node.socket_path}", provider, types,
                      idle_timeout_s=kw.pop("idle_timeout_s", 0.2),
                      drain_grace_s=kw.pop("drain_grace_s", 0.0), **kw)


def test_scale_up_on_pending_demand(session):
    # saturate: demand 8 CPUs on a 2-CPU cluster
    @ray_tpu_torch.remote(num_cpus=2)
    def hog():
        time.sleep(30)

    refs = [hog.remote() for _ in range(4)]
    time.sleep(0.5)
    provider = FakeProvider()
    a = _mk(provider, [NodeType("cpu4", {"CPU": 4}, max_nodes=5)])
    actions = a.reconcile_once()
    # 3 unmet 2-CPU demands (one fits the 2-CPU head when idle... at least
    # one new node must be planned; bin-packing puts 2 demands per cpu4 node)
    assert actions["launched"], actions
    assert len(provider.nodes) >= 1
    a.stop()
    del refs


def test_min_nodes_floor(session):
    provider = FakeProvider()
    a = _mk(provider, [NodeType("warm", {"CPU": 2}, min_nodes=2, max_nodes=4)])
    actions = a.reconcile_once()
    assert len([x for x in actions["launched"] if x[0] == "warm"]) == 2
    # floor is maintained, never terminated below min
    time.sleep(0.3)
    actions2 = a.reconcile_once()
    assert not actions2["terminated"]
    assert len(provider.nodes) == 2
    a.stop(terminate_nodes=False)


def test_idle_scale_down(session):
    provider = FakeProvider()
    nt = NodeType("burst", {"CPU": 4}, min_nodes=0, max_nodes=3)
    # grace 0: fake nodes never join the GCS, and this test wants the idle
    # clock running from the first pass
    a = _mk(provider, [nt], idle_timeout_s=0.2, node_startup_grace_s=0.0)
    # manually launch one (as if demand had spiked earlier)
    a._launch(nt)
    assert len(provider.nodes) == 1
    a.reconcile_once()  # idle clock starts
    time.sleep(0.3)
    actions = a.reconcile_once()
    assert actions["terminated"], "idle above-min node must be terminated"
    assert len(provider.nodes) == 0
    a.stop()


def test_max_nodes_cap(session):
    @ray_tpu_torch.remote(num_cpus=4)
    def big():
        time.sleep(30)

    refs = [big.remote() for _ in range(10)]
    time.sleep(0.5)
    provider = FakeProvider()
    a = _mk(provider, [NodeType("cpu4", {"CPU": 4}, max_nodes=2)])
    a.reconcile_once()
    assert len(provider.nodes) <= 2
    a.stop()
    del refs


class OwnedFakeProvider(FakeProvider):
    """FakeProvider that recognizes its own nodes, enabling the leak sweep."""

    def owns_node(self, node_id):
        return node_id.startswith("fake-")


def test_restart_adopts_persisted_instances(session):
    """A fresh Autoscaler over the same GCS + provider (the crash-restart
    path) rebuilds from the persisted instance table: still-alive nodes are
    adopted, nothing is relaunched for them."""
    provider = FakeProvider()
    types = [NodeType("warm", {"CPU": 2}, min_nodes=2, max_nodes=4)]
    a1 = _mk(provider, types)
    actions = a1.reconcile_once()
    assert len(actions["launched"]) == 2
    a1.stop(terminate_nodes=False)  # "crash": records stay in the GCS table

    a2 = _mk(provider, types)
    actions = a2.reconcile_once()
    assert sorted(n for _, n in actions["adopted"]) == sorted(provider.nodes)
    assert actions["launched"] == [], "adopted nodes must not be relaunched"
    assert len(provider.nodes) == 2
    a2.stop(terminate_nodes=False)


def test_reap_vanished_and_sweep_leaked(session):
    """Records whose node vanished are reaped; provider nodes with no
    record (a leak from a crash mid-launch) are terminated by the sweep."""
    provider = OwnedFakeProvider()
    nt = NodeType("burst", {"CPU": 2}, min_nodes=0, max_nodes=4)
    a = _mk(provider, [nt])
    n1 = a._launch(nt)
    n2 = a._launch(nt)
    provider.nodes.pop(n1)                 # externally died (e.g. preempted)
    provider.nodes["fake-leak"] = "burst"  # exists, but no record claims it
    actions = a.reconcile_once()
    assert ("burst", n1) in actions["reaped"]
    assert actions["swept"] == ["fake-leak"]
    assert set(provider.nodes) == {n2}
    a.stop()


def test_idle_not_racing_node_startup(session):
    """A just-launched node that hasn't joined the GCS yet must not be
    idle-terminated out from under its own startup: the idle clock only
    starts once it joins or overstays node_startup_grace_s."""
    provider = FakeProvider()
    nt = NodeType("burst", {"CPU": 4}, min_nodes=0, max_nodes=3)
    a = _mk(provider, [nt], idle_timeout_s=0.05, node_startup_grace_s=60.0)
    a._launch(nt)
    a.reconcile_once()
    time.sleep(0.15)                       # way past idle_timeout_s
    actions = a.reconcile_once()
    assert not actions["terminated"], "idle-killed a node still starting up"
    assert len(provider.nodes) == 1
    a.stop()


class FlakyProvider(FakeProvider):
    """First create fails with a cooldown-carrying error, then succeeds."""

    def __init__(self, cooldown_s=0.3):
        super().__init__()
        self.cooldown_s = cooldown_s
        self.failures_left = 1
        self.create_calls = 0

    def create_node(self, node_type, resources, labels):
        self.create_calls += 1
        if self.failures_left > 0:
            self.failures_left -= 1
            e = RuntimeError("zone stockout (injected)")
            e.cooldown_s = self.cooldown_s
            raise e
        return super().create_node(node_type, resources, labels)


def test_launch_failure_cooldown_lifecycle(session):
    """Cooldown suppresses launches while active, expires on schedule, the
    relaunch succeeds, and the stale error drops out of the summary."""
    provider = FlakyProvider(cooldown_s=0.3)
    a = _mk(provider, [NodeType("warm", {"CPU": 2}, min_nodes=1, max_nodes=2)])
    actions = a.reconcile_once()
    assert actions["launched"] == []
    assert "stockout" in actions["launch_failures"]["warm"]
    assert provider.create_calls == 1

    actions = a.reconcile_once()           # still cooling: no hot retry
    assert provider.create_calls == 1
    assert "warm" in actions["launch_failures"]

    time.sleep(0.35)                       # cooldown expires
    actions = a.reconcile_once()
    assert len(actions["launched"]) == 1
    assert provider.create_calls == 2
    assert actions["launch_failures"] == {}, "stale error must be dropped"
    assert len(provider.nodes) == 1
    a.stop()


def test_interrupted_terminate_reissued_on_restart(session):
    """A crash between the TERMINATING persist and the cloud call must
    re-issue the (idempotent) terminate after restart, not leak the node."""
    from ray_tpu_torch.autoscaler import instance_manager as im

    provider = FakeProvider()
    nt = NodeType("burst", {"CPU": 2}, min_nodes=0, max_nodes=2)
    a1 = _mk(provider, [nt])
    nid = a1._launch(nt)
    a1._im.transition(a1._im.by_node(nid), im.TERMINATING)
    a1.stop(terminate_nodes=False)  # "crash" right before terminate_node

    a2 = _mk(provider, [nt])
    actions = a2.reconcile_once()
    assert ("burst", nid) in actions["terminated"]
    assert provider.nodes == {}
    a2.stop()


def test_launch_cooldown_survives_restart(session):
    """ALLOCATION_FAILED records persist, so a restarted reconciler keeps
    suppressing hot relaunches of a quota/stockout-limited type."""
    provider = FlakyProvider(cooldown_s=60.0)
    types = [NodeType("warm", {"CPU": 2}, min_nodes=1, max_nodes=2)]
    a1 = _mk(provider, types)
    a1.reconcile_once()             # launch fails; cooldown persisted
    assert provider.create_calls == 1
    a1.stop(terminate_nodes=False)

    a2 = _mk(provider, types)
    actions = a2.reconcile_once()
    assert actions["launched"] == []
    assert "warm" in actions["launch_failures"]
    assert provider.create_calls == 1, "restart must not forget the cooldown"
    a2.stop(terminate_nodes=False)


class AdoptionRequiredProvider(FakeProvider):
    """Models LocalNodeProvider's restart blindness: a fresh incarnation
    cannot see nodes launched pre-crash until adopt_node re-attaches."""

    def __init__(self, cloud):
        super().__init__()
        self.cloud = cloud              # shared across "incarnations"
        self.attached = set()

    def create_node(self, node_type, resources, labels):
        nid = super().create_node(node_type, resources, labels)
        self.cloud[nid] = node_type
        self.attached.add(nid)
        return nid

    def terminate_node(self, node_id):
        super().terminate_node(node_id)
        self.cloud.pop(node_id, None)
        self.attached.discard(node_id)

    def non_terminated_nodes(self):
        return [n for n in self.cloud if n in self.attached]

    def adopt_node(self, node_id, data):
        if node_id in self.cloud:
            self.attached.add(node_id)
            return True
        return False


def test_interrupted_terminate_readopted_then_reissued(session):
    """When the provider needs adoption to even SEE pre-crash nodes (like
    LocalNodeProvider), a TERMINATING record must still be re-attached on
    recovery — otherwise the sync step mistakes the invisible node for a
    vanished one, deletes the record, and orphans the node forever."""
    cloud = {}
    p1 = AdoptionRequiredProvider(cloud)
    nt = NodeType("burst", {"CPU": 2}, min_nodes=0, max_nodes=2)
    a1 = _mk(p1, [nt])
    nid = a1._launch(nt)
    from ray_tpu_torch.autoscaler import instance_manager as im

    a1._im.transition(a1._im.by_node(nid), im.TERMINATING)
    a1.stop(terminate_nodes=False)  # crash before the cloud call

    a2 = _mk(AdoptionRequiredProvider(cloud), [nt])  # fresh incarnation
    actions = a2.reconcile_once()
    assert ("burst", nid) in actions["terminated"]
    assert cloud == {}, "orphaned the node instead of re-terminating"
    assert a2._im.instances() == []
    a2.stop()


def test_failing_terminate_blocks_overlaunch(session):
    """A node stuck TERMINATING (cloud terminate failing every pass) still
    occupies its max_nodes slot — the reconciler must not launch past the
    cap while provider reality still holds the node."""
    @ray_tpu_torch.remote(num_cpus=2)
    def hog():
        time.sleep(30)

    refs = [hog.remote() for _ in range(4)]
    time.sleep(0.5)

    class OutageProvider(FakeProvider):
        def terminate_node(self, node_id):
            raise RuntimeError("cloud API outage")

    provider = OutageProvider()
    nt = NodeType("cpu4", {"CPU": 4}, max_nodes=1)
    a = _mk(provider, [nt])
    nid = a._launch(nt)
    from ray_tpu_torch.autoscaler import instance_manager as im

    a._im.transition(a._im.by_node(nid), im.TERMINATING)
    actions = a.reconcile_once()
    assert actions["launched"] == [], actions
    assert list(provider.nodes) == [nid]
    inst, = a._im.instances()
    assert inst.state == im.TERMINATING  # still retrying next pass
    a.stop(terminate_nodes=False)
    del refs


def test_reissued_terminate_not_double_swept(session):
    """A terminate re-issued from the TERMINATING sync must drop the node
    from the pass's live view — the leak sweep in the same pass must not
    terminate it a second time or report it as swept."""
    from ray_tpu_torch.autoscaler import instance_manager as im

    class CountingProvider(OwnedFakeProvider):
        def __init__(self):
            super().__init__()
            self.terminate_calls = []

        def terminate_node(self, node_id):
            self.terminate_calls.append(node_id)
            super().terminate_node(node_id)

    provider = CountingProvider()
    nt = NodeType("burst", {"CPU": 2}, min_nodes=0, max_nodes=2)
    a = _mk(provider, [nt])
    nid = a._launch(nt)
    a._im.transition(a._im.by_node(nid), im.TERMINATING)  # crash pre-cloud
    actions = a.reconcile_once()
    assert ("burst", nid) in actions["terminated"]
    assert actions["swept"] == [], actions
    assert provider.terminate_calls == [nid], "terminated twice"
    a.stop()


def test_stop_before_first_reconcile_terminates_persisted_nodes(session):
    """stop(terminate_nodes=True) before any reconcile pass must still
    tear down a previous incarnation's persisted nodes, not just the empty
    in-memory view."""
    provider = FakeProvider()
    types = [NodeType("warm", {"CPU": 2}, min_nodes=1, max_nodes=2)]
    a1 = _mk(provider, types)
    a1.reconcile_once()
    assert len(provider.nodes) == 1
    a1.stop(terminate_nodes=False)     # records persist

    a2 = _mk(provider, types)          # SIGTERMed before its first pass
    a2.stop(terminate_nodes=True)
    assert provider.nodes == {}, "early stop leaked the predecessor's node"

    a3 = _mk(provider, types)          # table must be clean too
    actions = a3.reconcile_once()
    assert actions["adopted"] == []
    assert len(actions["launched"]) == 1  # floor relaunches fresh
    a3.stop()


def test_stop_terminates_nodes_even_with_dead_gcs(session):
    """The monitor stops BECAUSE the head died (ConnectionClosed exit):
    teardown must still release provider nodes even though no transition
    can be persisted anymore."""
    provider = FakeProvider()
    nt = NodeType("burst", {"CPU": 2}, min_nodes=0, max_nodes=2)
    a = _mk(provider, [nt])
    a._launch(nt)
    a._conn.close()  # the GCS is gone
    a.stop(terminate_nodes=True)
    assert provider.nodes == {}, "dead GCS must not leak provider nodes"


def test_local_provider_orphans_visible_through_pid_registry(tmp_path):
    """An agent spawned by a provider incarnation that crashed before any
    record carried its pid must still be visible to a FRESH incarnation
    (on-disk pid registry) so the reconciler's leak sweep can kill it."""
    from ray_tpu_torch.autoscaler.node_provider import _pid_alive

    addr = "unix:/tmp/ray-tpu-no-such-gcs-orphan.sock"
    reg = str(tmp_path / "registry.json")
    p1 = LocalNodeProvider(addr, registry_path=reg)
    nid = p1.create_node("w", {"CPU": 1.0}, {})
    pid = p1._procs[nid].pid

    p2 = LocalNodeProvider(addr, registry_path=reg)  # fresh incarnation
    assert nid in p2.non_terminated_nodes(), "orphan invisible to sweep"
    assert p2.owns_node(nid)
    p2.terminate_node(nid)                           # the sweep's call
    deadline = time.time() + 10
    while time.time() < deadline and _pid_alive(pid):
        time.sleep(0.05)
    assert not _pid_alive(pid), "orphan agent survived the sweep"
    assert p2.non_terminated_nodes() == []
    p1.non_terminated_nodes()  # reap the zombie in THIS (parent) process


def test_local_provider_recovers_pid_from_provisional_entry(tmp_path):
    """A crash BETWEEN Popen and the registry pid write leaves a
    provisional (pid-less) entry; a fresh incarnation recovers the pid by
    the agent's unique --host-id in /proc cmdlines, making even that
    narrowest orphan window sweepable."""
    import json as _json
    import subprocess
    import sys

    addr = "unix:/tmp/ray-tpu-no-such-gcs-prov.sock"
    reg_path = tmp_path / "registry.json"
    nid = "as-w-provisional1"
    reg_path.write_text(_json.dumps(
        {nid: {"pid": None, "created_at": time.time()}}))
    # stand-in for the orphan agent: carries the node_agent module token
    # and host id in its argv (the real agent exits fast on a bad address)
    orphan = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(120)",
         "ray_tpu_torch._private.node_agent", "--host-id", nid],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        p2 = LocalNodeProvider(addr, registry_path=str(reg_path))
        assert nid in p2.non_terminated_nodes(), "orphan pid not recovered"
        # the recovered entry is now a full (pid, start-time) identity
        ent = p2._registry()[nid]
        assert ent["pid"] == orphan.pid and ent["pid_start"] is not None
        p2.terminate_node(nid)
        orphan.wait(timeout=10)  # our child here: reap it
        assert p2.non_terminated_nodes() == []
    finally:
        if orphan.poll() is None:
            orphan.kill()
            orphan.wait(timeout=10)


def test_local_provider_adopt_rejects_recycled_pid():
    """(pid, start_time) identifies the process: a pid recycled to an
    unrelated process while the reconciler was down must NOT be adopted
    (it would be SIGTERMed on scale-down)."""
    import os

    from ray_tpu_torch.autoscaler.node_provider import _pid_start_time

    provider = LocalNodeProvider("unix:/tmp/ray-tpu-no-such-gcs.sock")
    me, start = os.getpid(), _pid_start_time(os.getpid())
    assert start is not None
    assert not provider.adopt_node("as-w-x", {"pid": me,
                                              "pid_start": start - 1})
    assert provider.adopt_node("as-w-y", {"pid": me, "pid_start": start})
    provider._adopted.clear()  # never terminate_node our own test process


def test_local_provider_reaps_exited_procs():
    """Exited node-agent subprocesses must be collected and dropped on
    listing — not accumulated as zombie processes / dead Popen entries."""
    provider = LocalNodeProvider("unix:/tmp/ray-tpu-no-such-gcs.sock")
    nid = provider.create_node("w", {"CPU": 1.0}, {})
    p = provider._procs[nid]
    p.kill()
    deadline = time.time() + 10
    while provider.non_terminated_nodes() and time.time() < deadline:
        time.sleep(0.05)
    assert provider.non_terminated_nodes() == []
    assert provider._procs == {}, "dead proc entry never reaped"
    assert p.returncode is not None, "child never wait()ed (zombie)"


def test_local_provider_joins_real_cluster(session):
    """End-to-end: the LocalNodeProvider launches a real node agent that
    registers with the GCS and runs tasks."""
    provider = LocalNodeProvider(_api._node.address)
    a = Autoscaler(f"unix:{_api._node.socket_path}", provider,
                   [NodeType("worker", {"CPU": 2}, min_nodes=1, max_nodes=2)])
    try:
        a.reconcile_once()  # min floor launches one agent
        deadline = time.time() + 30
        while time.time() < deadline:
            if ray_tpu_torch.cluster_resources().get("CPU", 0) >= 4:
                break
            time.sleep(0.3)
        assert ray_tpu_torch.cluster_resources().get("CPU", 0) >= 4, \
            "autoscaled node never joined"
    finally:
        a.stop()


# ------------------------------------------------------- port-side checks


def test_local_provider_launches_a_gpu_host_and_kills_its_group(
        monkeypatch, tmp_path):
    """A node type's "GPU" becomes the port agent's --num-gpus, the agent
    leads a process group of its own, and terminate_node SIGKILLs that
    group once the agent's orderly stop (SIGINT) has had its grace: no
    process the agent started outlives it."""
    import subprocess

    from ray_tpu_torch.autoscaler import node_provider as np_

    launched = {}
    real_popen = subprocess.Popen
    pid_file = tmp_path / "grandchild.pid"

    def fake_popen(cmd, **kw):
        launched["cmd"], launched["kw"] = cmd, kw
        # an agent whose child ignores SIGINT: only the group kill ends it
        return real_popen(
            ["sh", "-c", f'trap "" INT; sleep 60 & echo $! > {pid_file}; '
                         f'wait'], **kw)

    monkeypatch.setattr(np_.subprocess, "Popen", fake_popen)
    monkeypatch.setattr(np_, "STOP_GRACE_S", 0.5)
    provider = LocalNodeProvider("unix:/tmp/no-such-gcs.sock",
                                 registry_path=str(tmp_path / "reg.json"))
    nid = provider.create_node("gpu", {"CPU": 2.0, "GPU": 1.0}, {})
    cmd = launched["cmd"]
    assert cmd[1:3] == ["-m", "ray_tpu_torch._private.node_agent"]
    assert cmd[cmd.index("--num-gpus") + 1] == "1.0"
    assert cmd[cmd.index("--num-cpus") + 1] == "2.0"
    assert cmd[cmd.index("--host-id") + 1] == nid
    assert nid.startswith("as-gpu-")
    assert launched["kw"].get("start_new_session") is True
    deadline = time.monotonic() + 10
    while not pid_file.exists() or not pid_file.read_text().strip():
        assert time.monotonic() < deadline
        time.sleep(0.05)
    grandchild = int(pid_file.read_text())
    provider.terminate_node(nid)
    deadline = time.monotonic() + 10
    while np_._pid_alive(grandchild) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not np_._pid_alive(grandchild), "the agent's child outlived it"
    assert provider.non_terminated_nodes() == []


class HeadBackedProvider(FakeProvider):
    """FakeProvider whose nodes stand for the head node in the GCS's view:
    the head's load decides whether they are busy."""

    def node_joined(self, node_id, gcs_node_ids):
        return "node-0" in set(gcs_node_ids)


def test_a_node_holding_work_is_not_idle_terminated(session):
    """Idle is nothing pending and nothing holding resources on the node:
    a node whose task holds a CPU, or while a demand waits, keeps its idle
    clock stopped; once the work is done it idles out (the reference
    drains on zero unmet demand alone)."""
    from ray_tpu_torch.autoscaler import instance_manager as im

    @ray_tpu_torch.remote(num_cpus=1)
    def hold(s):
        time.sleep(s)

    provider = HeadBackedProvider()
    nt = NodeType("burst", {"CPU": 2}, min_nodes=0, max_nodes=2)
    a = _mk(provider, [nt], idle_timeout_s=0.2, node_startup_grace_s=0.0)
    nid = a._launch(nt)
    a.reconcile_once()                       # joined: RUNNING
    ref = hold.remote(3.0)
    deadline = time.monotonic() + 10
    while not a._demand().get("busy_node_ids"):
        assert time.monotonic() < deadline, "the task never started"
        time.sleep(0.05)
    for _ in range(3):
        time.sleep(0.3)                      # past idle_timeout_s
        actions = a.reconcile_once()
        assert not actions["terminated"] and not actions["drained"]
    assert a._im.by_node(nid).state == im.RUNNING
    ray_tpu_torch.get(ref, timeout=30)
    deadline = time.monotonic() + 10
    while nid in provider.nodes:
        assert time.monotonic() < deadline, "the idle node was kept"
        a.reconcile_once()
        time.sleep(0.1)
    a.stop()
