"""The port's twins of tests/test_cluster_services.py, against
ray_tpu_torch: the per-host runtime-env agent and the standalone
autoscaler monitor (``python -m ray_tpu_torch._private.monitor``), with
the port-side checks: the monitor refuses the GCE TPU providers by name,
and GPU demand the cluster cannot hold waits while a monitor is attached
and fails fast again once it detaches.

(reference: python/ray/_private/runtime_env/agent/ — env creation runs in
a per-node agent process, deduplicated and observable;
autoscaler/_private/monitor.py — the autoscaler loop is its own OS
process spawned by `ray start --head`.)
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import runtime_env_agent as rea


@pytest.fixture
def agent(tmp_path):
    os.makedirs(tmp_path / "logs", exist_ok=True)
    a = rea.RuntimeEnvAgent(str(tmp_path / "agent.sock"))
    t = threading.Thread(target=a.serve_forever, daemon=True)
    t.start()
    yield a
    a.stop()


def test_agent_dedups_concurrent_builds(agent, monkeypatch):
    """N concurrent get_or_create calls for the same env run ONE build."""
    builds = []
    ev = threading.Event()

    def fake_build(renv):
        builds.append(renv)
        ev.wait(timeout=5)  # hold so all callers overlap
        return {"python": "/fake/python"}

    monkeypatch.setattr(rea, "_build", fake_build)
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        rea.get_or_create(agent.socket_path, {"pip": ["x==1"]})))
        for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    ev.set()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 4
    assert all(r["python"] == "/fake/python" for r in results)
    assert len(builds) == 1, "concurrent identical envs must share a build"


def test_agent_reports_build_failure(agent, monkeypatch):
    def broken(renv):
        raise ValueError("no such package: definitely-not-real")

    monkeypatch.setattr(rea, "_build", broken)
    with pytest.raises(RuntimeError, match="definitely-not-real"):
        rea.get_or_create(agent.socket_path, {"pip": ["definitely-not-real"]})
    # status surfaces the failure
    from ray_tpu_torch._private.protocol import connect_unix

    conn = connect_unix(agent.socket_path)
    conn.send({"t": "list", "rid": 1})
    envs = conn.recv()["envs"]
    conn.close()
    assert any(e["state"] == "failed" for e in envs.values())


def test_agent_failure_does_not_poison_key(agent, monkeypatch):
    """A transient build failure must not be cached: the next request for
    the same env retries and can succeed."""
    calls = []

    def flaky(renv):
        calls.append(1)
        if len(calls) == 1:
            raise OSError("transient network failure")
        return {"python": "/fixed/python"}

    monkeypatch.setattr(rea, "_build", flaky)
    with pytest.raises(RuntimeError, match="transient"):
        rea.get_or_create(agent.socket_path, {"pip": ["flaky==1"]})
    got = rea.get_or_create(agent.socket_path, {"pip": ["flaky==1"]})
    assert got["python"] == "/fixed/python"
    assert len(calls) == 2


def test_agent_rejects_conda_plus_pip(agent):
    with pytest.raises(RuntimeError, match="cannot combine"):
        rea.get_or_create(agent.socket_path,
                          {"conda": "base", "pip": ["x"]})


def test_agent_subprocess_lifecycle(tmp_path):
    """AgentHandle starts a real agent subprocess; ping answers; a no-op
    env resolves to the current interpreter."""
    os.makedirs(tmp_path / "logs", exist_ok=True)
    h = rea.AgentHandle(str(tmp_path))
    sock = h.ensure()
    assert os.path.exists(sock)
    reply = rea.get_or_create(sock, {})  # no pip/conda -> base interpreter
    assert reply["python"] == sys.executable
    pid_before = h.proc.pid
    assert h.ensure() == sock            # idempotent, same process
    assert h.proc.pid == pid_before
    h.stop()
    assert h.proc is None


def test_monitor_config_loading_json(tmp_path):
    from ray_tpu_torch._private.monitor import build_node_types, load_config

    cfg = {"provider": {"type": "local"},
           "node_types": {"w": {"resources": {"CPU": 2}, "min_nodes": 1,
                                "max_nodes": 3, "labels": {"pool": "warm"}}},
           "interval_s": 0.5}
    p = tmp_path / "scaling.json"
    p.write_text(json.dumps(cfg))
    assert load_config(str(p)) == cfg
    nts = build_node_types(cfg)
    assert len(nts) == 1 and nts[0].name == "w"
    assert (nts[0].min_nodes, nts[0].max_nodes) == (1, 3)
    assert nts[0].resources == {"CPU": 2}
    assert nts[0].labels == {"pool": "warm"}
    with pytest.raises(ValueError, match="no node_types"):
        build_node_types({"provider": {"type": "local"}})


def test_monitor_config_loading_yaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    from ray_tpu_torch._private.monitor import build_node_types, load_config

    p = tmp_path / "scaling.yaml"
    p.write_text(yaml.safe_dump(
        {"provider": {"type": "local"},
         "node_types": {"w": {"resources": {"CPU": 2}, "max_nodes": 5}}}))
    cfg = load_config(str(p))
    assert cfg["provider"] == {"type": "local"}
    nts = build_node_types(cfg)
    assert nts[0].max_nodes == 5 and nts[0].min_nodes == 0


def test_monitor_builds_fake_file_provider(tmp_path):
    from ray_tpu_torch._private.monitor import build_provider
    from ray_tpu_torch.autoscaler import FakeFileNodeProvider

    p = build_provider(
        {"provider": {"type": "fake_file",
                      "path": str(tmp_path / "cloud.json"),
                      "die_after_create": 2}}, "unix:/unused")
    assert isinstance(p, FakeFileNodeProvider)
    assert p.die_after_create == 2
    assert p.non_terminated_nodes() == []


@pytest.mark.slow
def test_monitor_process_scales_cluster(tmp_path):
    """The standalone monitor process (fake provider) observes queued
    demand from a live head and adds provider nodes."""
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, num_workers=1, max_workers=4)
    from ray_tpu_torch._private import api as _api

    address = _api._node.address
    cfg = {"provider": {"type": "local"},
           "node_types": {"cpu": {"resources": {"CPU": 4},
                                  "max_nodes": 3}},
           "interval_s": 0.2, "idle_timeout_s": 3600}
    cfg_path = tmp_path / "scaling.json"
    cfg_path.write_text(json.dumps(cfg))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.monitor",
         "--address", address, "--autoscaling-config", str(cfg_path),
         "--keep-nodes-on-exit"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        @ray_tpu_torch.remote(num_cpus=4)
        def big():
            return os.environ.get("RAY_TPU_TORCH_NODE_ID")

        # 4-CPU demand cannot fit the 1-CPU head: the monitor must launch
        # a virtual 4-CPU node and the task must then run on it
        ref = big.remote()
        node_id = ray_tpu_torch.get(ref, timeout=90)
        assert node_id is not None and node_id != "node-0"
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        ray_tpu_torch.shutdown()


# ------------------------------------------------------- port-side checks


@pytest.mark.parametrize("kind", ["gce_tpu", "fake_gce_tpu"])
def test_monitor_refuses_the_gce_tpu_providers_by_name(kind):
    """One TPU slice per node over tpu.googleapis.com is left out of the
    port by decision (ROADMAP.md: a slice has no GPU counterpart); the
    refusal names the card's provider, gce_gpu."""
    from ray_tpu_torch._private.monitor import build_provider

    with pytest.raises(NotImplementedError, match=kind) as ei:
        build_provider({"provider": {"type": kind, "project": "p",
                                     "zone": "z"}}, "unix:/unused")
    assert "left out by decision" in str(ei.value)
    assert "'gce_gpu'" in str(ei.value)


def test_infeasible_gpu_demand_waits_while_a_monitor_is_attached():
    """A GPU placement group on a cluster with no GPU fails fast; while an
    autoscaler is attached it waits (a launched node may hold it); once the
    monitor's connection drops, fail-fast is back."""
    from ray_tpu_torch._private import api as _api
    from ray_tpu_torch._private.protocol import connect_address
    from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=1, num_gpus=0, num_workers=0, max_workers=2)
    try:
        with pytest.raises(PlacementGroupUnschedulableError):
            placement_group([{"GPU": 1}])
        conn = connect_address(_api._node.address)
        conn.send({"type": "autoscaler_attach", "rid": 1})
        assert conn.recv()["ok"]
        pg = placement_group([{"GPU": 1}])
        assert not pg.wait(0.3)
        remove_placement_group(pg)
        conn.close()
        deadline = time.monotonic() + 10
        while True:
            try:
                pg = placement_group([{"GPU": 1}])
            except PlacementGroupUnschedulableError:
                break
            remove_placement_group(pg)
            assert time.monotonic() < deadline, "fail-fast never came back"
            time.sleep(0.05)
    finally:
        ray_tpu_torch.shutdown()
