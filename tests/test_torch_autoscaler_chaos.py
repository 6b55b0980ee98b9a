"""The port's twins of tests/test_autoscaler_chaos.py, against
ray_tpu_torch: SIGKILL the port's monitor mid-reconcile and assert the
restarted converge loop recovers with zero leaked nodes.

(reference capability: autoscaler v2's crash-restartable reconciler —
instance_manager/reconciler.py rebuilds from the persisted instance table
and reconciles it against cloud ground truth; the Ray paper's
fault-tolerance story applied to the control plane itself.)

The headline test kills the monitor process at the worst possible point:
AFTER the provider created the node but BEFORE the ALLOCATED transition
persisted (the FakeFileNodeProvider's die_after_create hook SIGKILLs the
process between the two). The restarted monitor, against the same GCS
store, must resolve the stale REQUESTED record, sweep the orphaned provider
node, and converge to the target count — no leak, no double-launch for the
same backlog. The long randomized kill loop stays behind `-m slow` so
tier-1 stays fast.
"""

from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import api as _api

pytestmark = pytest.mark.autoscaler_chaos


def _instance_table(address):
    from ray_tpu_torch._private.protocol import connect_address

    conn = connect_address(address)
    try:
        conn.send({"type": "instance_list", "rid": 1})
        while True:
            reply = conn.recv()
            if reply.get("rid") == 1:
                return reply["instances"]
    finally:
        conn.close()


def _cloud(state_path):
    try:
        with open(state_path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"nodes": {}, "creates": 0}


def _write_config(tmp_path, state_path, *, die_after_create=0, min_nodes=2):
    cfg = {
        "provider": {"type": "fake_file", "path": str(state_path),
                     "die_after_create": die_after_create},
        "node_types": {"worker": {"resources": {"CPU": 4},
                                  "min_nodes": min_nodes, "max_nodes": 4}},
        "interval_s": 0.1,
        "idle_timeout_s": 3600,
    }
    p = tmp_path / f"scaling-{die_after_create}.json"
    p.write_text(json.dumps(cfg))
    return p


def _spawn_monitor(address, cfg_path):
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.monitor",
         "--address", address, "--autoscaling-config", str(cfg_path),
         "--keep-nodes-on-exit"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _assert_converged(address, state_path, target, timeout=60):
    """Cluster reaches `target` nodes with a 1:1 node↔record mapping (zero
    leaked provider nodes, zero dangling records) and STAYS there."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        cloud = _cloud(state_path)
        recs = _instance_table(address)
        live = {r["node_id"] for r in recs
                if r["state"] in ("ALLOCATED", "RUNNING", "IDLE_TRACKED")}
        if len(cloud["nodes"]) == target and set(cloud["nodes"]) == live:
            break
        time.sleep(0.1)
    else:
        raise AssertionError(
            f"never converged: cloud={_cloud(state_path)} "
            f"table={_instance_table(address)}")
    creates = _cloud(state_path)["creates"]
    time.sleep(0.5)  # several reconcile intervals: must be a fixed point
    cloud = _cloud(state_path)
    recs = _instance_table(address)
    assert len(cloud["nodes"]) == target, cloud
    assert cloud["creates"] == creates, "kept launching after convergence"
    assert {r["node_id"] for r in recs} == set(cloud["nodes"]), (recs, cloud)
    return cloud


@pytest.fixture
def chaos_session(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_GCS_STORAGE_PATH", str(tmp_path / "gcs.db"))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, num_workers=1, max_workers=4)
    yield _api._node.address
    ray_tpu_torch.shutdown()


def test_monitor_killed_between_create_and_persist_recovers(
        tmp_path, chaos_session):
    address = chaos_session
    state_path = tmp_path / "cloud.json"

    # phase A: the fault hook SIGKILLs the monitor after create_node commits
    # the node to the provider state file but before ALLOCATED persists
    cfg = _write_config(tmp_path, state_path, die_after_create=1)
    proc = _spawn_monitor(address, cfg)
    proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL, proc.returncode

    # the durable record of the crash: one orphaned provider node, and an
    # instance table whose only record is the pre-create REQUESTED persist
    cloud = _cloud(state_path)
    assert len(cloud["nodes"]) == 1 and cloud["creates"] == 1, cloud
    recs = _instance_table(address)
    assert [r["state"] for r in recs] == ["REQUESTED"], recs
    assert recs[0]["node_id"] is None, recs

    # phase B: restart against the same GCS store (the .died marker disarms
    # the fault hook). Recovery must resolve the REQUESTED record, sweep the
    # orphan, and land on exactly min_nodes=2.
    cfg2 = _write_config(tmp_path, state_path, die_after_create=0)
    proc2 = _spawn_monitor(address, cfg2)
    try:
        cloud = _assert_converged(address, state_path, target=2)
        # no double-launch: the orphan was swept (1 create) and the floor
        # needed two fresh nodes — never a 4th create for the same backlog
        assert cloud["creates"] == 3, cloud
        assert all(n.startswith("ff-worker-") for n in cloud["nodes"])
    finally:
        proc2.kill()
        proc2.wait(timeout=10)


@pytest.mark.slow
def test_randomized_kill_loop_converges(tmp_path, chaos_session):
    """Repeatedly SIGKILL the monitor at random points in its reconcile
    loop; the final incarnation must converge to the exact target with a
    1:1 node↔record mapping — whatever interleaving the kills produced."""
    address = chaos_session
    state_path = tmp_path / "cloud.json"
    cfg = _write_config(tmp_path, state_path, min_nodes=2)
    rng = random.Random(0xC0FFEE)

    for _ in range(6):
        proc = _spawn_monitor(address, cfg)
        time.sleep(rng.uniform(0.05, 0.7))
        proc.kill()
        proc.wait(timeout=10)

    proc = _spawn_monitor(address, cfg)
    try:
        cloud = _assert_converged(address, state_path, target=2, timeout=90)
        # every surviving node is accounted for; sweeps may have raised
        # `creates` past 2, but convergence pinned the fleet at the target
        assert len(cloud["nodes"]) == 2
    finally:
        proc.kill()
        proc.wait(timeout=10)
