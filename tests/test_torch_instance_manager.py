"""The port's twins of tests/test_instance_manager.py, against
ray_tpu_torch: the autoscaler instance state machine (validated
transitions, write-through persistence, restart rebuild) and the port's
GCS-backed instance table.

(reference capability: autoscaler v2 instance manager —
autoscaler/v2/instance_manager/{instance_manager,instance_storage}.py:
every instance mutation is validated against the state machine and persisted
before the caller proceeds, which is what makes the reconciler
crash-restartable.)
"""

from __future__ import annotations

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import api as _api
from ray_tpu_torch.autoscaler import instance_manager as im


# -- pure state machine ------------------------------------------------------


def test_full_lifecycle_happy_path():
    mgr = im.InstanceManager(im.MemoryInstanceStorage())
    inst = mgr.create("worker")
    assert inst.state == im.REQUESTED and inst.node_id is None

    inst = mgr.transition(inst, im.ALLOCATED, node_id="n-1",
                          launch_time=time.time())
    inst = mgr.transition(inst, im.RUNNING)
    inst = mgr.transition(inst, im.IDLE_TRACKED, idle_since=time.time())
    inst = mgr.transition(inst, im.RUNNING, idle_since=None)  # demand returned
    inst = mgr.transition(inst, im.IDLE_TRACKED, idle_since=time.time())
    inst = mgr.transition(inst, im.TERMINATING)
    inst = mgr.transition(inst, im.TERMINATED)
    assert mgr.instances() == []           # terminal records leave the table
    assert mgr.storage.list() == []


def test_invalid_transitions_raise():
    mgr = im.InstanceManager(im.MemoryInstanceStorage())
    inst = mgr.create("worker")
    with pytest.raises(im.InvalidTransition):
        mgr.transition(inst, im.RUNNING)   # REQUESTED must ALLOCATE first
    inst = mgr.transition(inst, im.ALLOCATED, node_id="n-1")
    with pytest.raises(im.InvalidTransition):
        mgr.transition(inst, im.ALLOCATED)  # no self-loop
    inst = mgr.transition(inst, im.TERMINATING)
    with pytest.raises(im.InvalidTransition):
        mgr.transition(inst, im.RUNNING)   # termination is one-way


def test_write_through_ordering():
    """create()/transition() persist BEFORE returning — the caller orders
    provider side-effects after the record is durable."""
    store = im.MemoryInstanceStorage()
    mgr = im.InstanceManager(store)
    inst = mgr.create("worker")
    assert store.records[inst.instance_id]["state"] == im.REQUESTED

    mgr.transition(inst, im.ALLOCATED, node_id="n-9")
    rec = store.records[inst.instance_id]
    assert rec["state"] == im.ALLOCATED and rec["node_id"] == "n-9"

    # a failed persist must leave the in-memory view unchanged
    class Exploding(im.MemoryInstanceStorage):
        def put(self, record):
            raise OSError("gcs away")

    mgr2 = im.InstanceManager(Exploding())
    with pytest.raises(OSError):
        mgr2.create("worker")
    assert mgr2.instances() == []


def test_load_rebuilds_from_shared_storage():
    """Two managers over one storage model a restarted reconciler."""
    store = im.MemoryInstanceStorage()
    m1 = im.InstanceManager(store)
    a = m1.transition(m1.create("warm"), im.ALLOCATED, node_id="n-a",
                      launch_time=123.0, provider_data={"pid": 42})
    m1.transition(a, im.RUNNING)
    f = m1.create("cold")
    m1.transition(f, im.ALLOCATION_FAILED, cooldown_until=999.0,
                  error="quota")

    m2 = im.InstanceManager(store)
    loaded = {i.instance_id: i for i in m2.load()}
    assert len(loaded) == 2
    ra = loaded[a.instance_id]
    assert (ra.state, ra.node_id, ra.launch_time) == (im.RUNNING, "n-a", 123.0)
    assert ra.provider_data == {"pid": 42}
    rf = loaded[f.instance_id]
    assert rf.state == im.ALLOCATION_FAILED
    assert (rf.cooldown_until, rf.error) == (999.0, "quota")
    assert m2.counts() == {"warm": 1}      # ALLOCATION_FAILED isn't capacity


def test_counts_and_queries():
    mgr = im.InstanceManager(im.MemoryInstanceStorage())
    r = mgr.create("a")
    al = mgr.transition(mgr.create("a"), im.ALLOCATED, node_id="n-1")
    mgr.transition(mgr.create("b"), im.ALLOCATED, node_id="n-2")
    assert mgr.counts() == {"a": 2, "b": 1}
    assert mgr.by_node("n-1").instance_id == al.instance_id
    assert mgr.by_node("n-404") is None
    assert {i.instance_id for i in mgr.instances(im.REQUESTED)} == \
        {r.instance_id}


# -- GCS-backed table --------------------------------------------------------


@pytest.fixture
def ft_session(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_GCS_STORAGE_PATH", str(tmp_path / "gcs.db"))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_workers=1, max_workers=4)
    yield
    ray_tpu_torch.shutdown()


def _gcs_rpc():
    """A synchronous RPC callable against the live GCS, as the autoscaler's
    GcsInstanceStorage uses."""
    from ray_tpu_torch._private.protocol import connect_address

    conn = connect_address(f"unix:{_api._node.socket_path}")
    rid = [0]

    def rpc(msg):
        rid[0] += 1
        msg["rid"] = rid[0]
        conn.send(msg)
        while True:
            reply = conn.recv()
            if reply.get("rid") == rid[0]:
                return reply

    rpc.close = conn.close
    return rpc


def test_gcs_instance_table_roundtrip(ft_session):
    rpc = _gcs_rpc()
    try:
        store = im.GcsInstanceStorage(rpc)
        mgr = im.InstanceManager(store)
        inst = mgr.transition(mgr.create("warm"), im.ALLOCATED,
                              node_id="n-rt", provider_data={"pid": 7})
        recs = store.list()
        assert len(recs) == 1
        assert recs[0]["node_id"] == "n-rt"
        mgr.transition(mgr.transition(inst, im.TERMINATING), im.TERMINATED)
        assert store.list() == []
    finally:
        rpc.close()


def test_instances_survive_gcs_restart(ft_session):
    """The instances table is write-through to sqlite: a crashed-and-
    restarted GCS still serves the records (so a monitor restarting AFTER a
    head failover still converges from persisted state)."""
    rpc = _gcs_rpc()
    try:
        mgr = im.InstanceManager(im.GcsInstanceStorage(rpc))
        inst = mgr.transition(mgr.create("warm"), im.ALLOCATED,
                              node_id="n-ft", launch_time=7.5)
    finally:
        rpc.close()

    node = _api._node
    node.gcs.crash_for_testing()
    time.sleep(0.3)
    node.restart_gcs()
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            if ray_tpu_torch.cluster_resources():
                break
        except Exception:
            pass
        time.sleep(0.2)

    rpc = _gcs_rpc()
    try:
        recs = im.GcsInstanceStorage(rpc).list()
        assert len(recs) == 1
        got = im.Instance.from_dict(recs[0])
        assert (got.instance_id, got.state, got.node_id, got.launch_time) == \
            (inst.instance_id, im.ALLOCATED, "n-ft", 7.5)
    finally:
        rpc.close()
