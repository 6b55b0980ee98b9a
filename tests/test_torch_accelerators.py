"""GPU-granular scheduling in the port against the JAX package's TPU chips.

Twins of tests/test_accelerators.py: the JAX package fakes a 4-chip host
with RAY_TPU_CHIPS=4 and binds chips through TPU_VISIBLE_CHIPS; the port
fakes a 4-GPU host with RAY_TPU_TORCH_GPUS=4 and binds GPUs through
CUDA_VISIBLE_DEVICES. Each test runs the same scenario through both (one
module-scoped session per package) and asserts the same ids. Plus GPU
detection without torch, the runtime context, and the device rule inside a
GPU worker that sees no card.
"""

from __future__ import annotations

from functools import partial

import os

import pytest

from torch_twins import same, twin


def _port(rt):
    return rt.__name__ == "ray_tpu_torch"


def _acc(rt, n):
    return {"num_gpus" if _port(rt) else "num_tpus": n}


def _visible_env(rt):
    return "CUDA_VISIBLE_DEVICES" if _port(rt) else "TPU_VISIBLE_CHIPS"


@pytest.fixture(scope="module")
def pkgs():
    import ray_tpu
    import ray_tpu_torch

    saved = {k: os.environ.get(k) for k in ("RAY_TPU_CHIPS",
                                            "RAY_TPU_TORCH_GPUS")}
    os.environ["RAY_TPU_CHIPS"] = "4"
    os.environ["RAY_TPU_TORCH_GPUS"] = "4"
    out = (ray_tpu, ray_tpu_torch)
    try:
        for rt in out:
            rt.shutdown()
            rt.init(num_cpus=8, num_workers=0, max_workers=8, **_acc(rt, 4))
        yield out
    finally:
        for rt in out:
            rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


_twin = partial(twin, serve_cleanup=False)
_same = partial(same, serve_cleanup=False)


def _actor_class(rt):
    env = _visible_env(rt)

    @rt.remote(**_acc(rt, 1))
    class DeviceActor:
        def ids(self):
            import os

            raw = os.environ.get(env, "")
            return sorted(int(c) for c in raw.split(",") if c != "")

    return DeviceActor


def _ids_task(rt, **opts):
    env = _visible_env(rt)

    @rt.remote(**opts)
    def ids():
        import os

        raw = os.environ.get(env, "")
        return sorted(int(c) for c in raw.split(",") if c != "")

    return ids


def _scn_reclaim_idle(rt):
    one = len(rt.get(_ids_task(rt, **_acc(rt, 1)).remote(), timeout=120))
    big = _actor_class(rt).options(**_acc(rt, 4)).remote()
    ids = rt.get(big.ids.remote(), timeout=60.0)
    rt.kill(big)
    return one, ids


def test_idle_device_workers_reclaimed_for_bigger_demand(pkgs):
    """Twin of the reference's test on the port alone: a finished 1-device
    task leaves an idle 1-device worker; a 4-device actor needs the whole
    pool, so the idle binding is reclaimed. The JAX package's GCS retires
    one mismatched idle worker a pass, and the workers its first task may
    leave idle can outnumber that: its actor then waits forever (the
    reference test times out that way under load; ROADMAP.md Queue 3), so
    its side is not run here. test_every_idle_device_worker_reclaimed_in_
    one_pass pins the case deterministically."""
    import ray_tpu_torch

    assert _scn_reclaim_idle(ray_tpu_torch) == (1, [0, 1, 2, 3])


def _scn_disjoint(rt):
    Actor = _actor_class(rt)
    actors = [Actor.remote() for _ in range(4)]
    seen = rt.get([a.ids.remote() for a in actors], timeout=120)
    for a in actors:
        rt.kill(a)
    return [len(c) for c in seen], sorted(c[0] for c in seen)


def test_one_device_actors_get_disjoint_devices(pkgs):
    _same(pkgs, _scn_disjoint, ([1, 1, 1, 1], [0, 1, 2, 3]))


def _scn_multi(rt):
    got = rt.get(_ids_task(rt, **_acc(rt, 2)).remote(), timeout=120)
    return len(got), set(got) <= {0, 1, 2, 3}


def test_task_gets_multiple_devices(pkgs):
    _same(pkgs, _scn_multi, (2, True))


def _scn_released_on_death(rt):
    Actor = _actor_class(rt)
    actors = [Actor.remote() for _ in range(4)]
    first = rt.get([a.ids.remote() for a in actors], timeout=120)
    rt.kill(actors[0])
    fresh = Actor.remote()
    ids = rt.get(fresh.ids.remote(), timeout=60.0)
    for a in actors[1:] + [fresh]:
        rt.kill(a)
    return ids == first[0]  # the freed device, rebound


def test_devices_released_on_actor_death(pkgs):
    _same(pkgs, _scn_released_on_death, True)


def test_every_idle_device_worker_reclaimed_in_one_pass(pkgs):
    """Four idle 1-GPU workers and a 4-GPU actor: the GCS retires all four
    in the pass that registers the demand (their exits trigger no later
    pass). The JAX package's GCS retires one worker a pass and the actor
    then waits forever, so this runs on the port alone."""
    import ray_tpu_torch as rt

    @rt.remote(num_gpus=1)
    def hold(t):
        import os
        import time

        time.sleep(t)
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    ids = rt.get([hold.remote(1.0) for _ in range(4)], timeout=120)
    assert sorted(ids) == ["0", "1", "2", "3"]
    big = _actor_class(rt).options(num_gpus=4).remote()
    try:
        assert rt.get(big.ids.remote(), timeout=30.0) == [0, 1, 2, 3]
    finally:
        rt.kill(big)


def _scn_cpu_alongside(rt):
    return rt.get(_ids_task(rt).remote(), timeout=120)


def test_cpu_tasks_keep_running_alongside_device_tasks(pkgs):
    _same(pkgs, _scn_cpu_alongside, [])


def _scn_fractional(rt):
    return rt.get(_ids_task(rt, **_acc(rt, 0.5)).remote(), timeout=120)


def test_fractional_device_unisolated(pkgs):
    _same(pkgs, _scn_fractional, [])  # shares, no binding


def test_num_devices_must_be_integral_above_one():
    import ray_tpu
    import ray_tpu_torch

    for rt in (ray_tpu, ray_tpu_torch):
        with pytest.raises(ValueError, match="must be an integer"):
            rt.remote(**_acc(rt, 1.5))(lambda: None)


def _scn_hidden(rt):
    name = "CUDA_VISIBLE_DEVICES" if _port(rt) else "JAX_PLATFORMS"

    @rt.remote
    def env():
        import os

        return os.environ.get(name)

    return rt.get(env.remote(), timeout=120)


def test_cpu_worker_is_hidden_from_the_device(pkgs):
    """A worker with no grant cannot reach a card: the JAX package hard-sets
    JAX_PLATFORMS=cpu, the port CUDA_VISIBLE_DEVICES to nothing."""
    jax_side, port_side = _twin(pkgs, _scn_hidden)
    assert jax_side == "cpu"
    assert port_side == ""


def _scn_context(rt):
    @rt.remote(**_acc(rt, 1))
    def ctx():
        ids = rt.get_runtime_context().get_accelerator_ids()
        return {k.replace("TPU", "GPU"): len(v) for k, v in ids.items()}

    return rt.get(ctx.remote(), timeout=120), rt.cluster_resources().get(
        "GPU" if _port(rt) else "TPU")


def test_runtime_context_names_the_grant(pkgs):
    _same(pkgs, _scn_context, ({"GPU": 1}, 4.0))


def test_gpu_worker_that_sees_no_card_raises(pkgs):
    """The device rule holds inside a worker: a num_gpus=1 task on this
    host (simulated GPUs, no CUDA) that asks for the card raises instead
    of computing on the CPU."""
    import ray_tpu_torch as rt

    @rt.remote(num_gpus=1)
    def on_card():
        import torch

        from ray_tpu_torch import resolve_device

        return str(torch.zeros(1, device=resolve_device()).device)

    with pytest.raises(rt.exceptions.RayTaskError) as ei:
        rt.get(on_card.remote(), timeout=120)
    assert "no CUDA device" in str(ei.value.cause)


def test_gpu_detection_without_torch(monkeypatch, tmp_path):
    """The env override first, then the driver's proc entries, then
    nvidia-smi -L; never torch."""
    import subprocess
    import sys

    from ray_tpu_torch._private import accelerators as acc

    code = ("import sys; from ray_tpu_torch._private import accelerators; "
            "accelerators.detect_num_gpus(); print('torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))
    assert r.stdout.strip() == "False", r.stderr
    monkeypatch.setenv("RAY_TPU_TORCH_GPUS", "3")
    assert acc.detect_num_gpus() == 3
    monkeypatch.delenv("RAY_TPU_TORCH_GPUS")
    procs = [str(tmp_path / f"0000:{i:02x}:00.0") for i in range(2)]
    monkeypatch.setattr(acc.glob, "glob", lambda pat: procs
                        if pat == "/proc/driver/nvidia/gpus/*" else [])
    assert acc.detect_num_gpus() == 2
    monkeypatch.setattr(acc.glob, "glob", lambda pat: [])
    monkeypatch.setattr(acc.shutil, "which", lambda name: "/bin/nvidia-smi")
    out = "GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-1)\n"
    monkeypatch.setattr(acc.subprocess, "run", lambda *a, **k:
                        subprocess.CompletedProcess(a, 0, out, ""))
    assert acc.detect_num_gpus() == 1
    monkeypatch.setattr(acc.shutil, "which", lambda name: None)
    assert acc.detect_num_gpus() == 0


def test_spawn_env_binds_or_hides():
    from ray_tpu_torch._private import accelerators as acc

    env = {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}
    acc.apply_gpu_env(env, (2, 3))
    assert env["CUDA_VISIBLE_DEVICES"] == "2,3"
    assert env[acc.WORKER_GPUS_ENV] == "2,3"
    acc.hide_gpus(env)
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert acc.WORKER_GPUS_ENV not in env
    assert acc.gpus_required({"GPU": 0.5}) == 0
    assert acc.gpus_required({"GPU": 2.0}) == 2


def test_pod_utilities(monkeypatch):
    """Twin of the reference's test for what has a GPU counterpart (a GCE
    GPU VM is one host: no pod name, worker count or slice-head resource):
    the host's device count under the env override, and no device bound to
    the driver's process."""
    from ray_tpu.util.accelerators import tpu
    from ray_tpu_torch.util.accelerators import gpu

    monkeypatch.setenv("RAY_TPU_CHIPS", "4")
    monkeypatch.setenv("RAY_TPU_TORCH_GPUS", "4")
    assert tpu.get_num_tpu_chips_on_node() == gpu.get_num_gpus_on_node() == 4
    monkeypatch.setenv("RAY_TPU_TORCH_GPUS", "2")
    assert gpu.get_num_gpus_on_node() == 2
    monkeypatch.delenv("RAY_TPU_TORCH_WORKER_GPUS", raising=False)
    assert gpu.get_current_process_visible_gpu_ids() == []


def _scn_visible_ids(rt):
    """The util function's ids inside a 2-device task: the grant."""
    mod, fn = (("ray_tpu_torch.util.accelerators.gpu",
                "get_current_process_visible_gpu_ids") if _port(rt) else
               ("ray_tpu.util.accelerators.tpu",
                "get_current_process_visible_chip_ids"))

    @rt.remote(**_acc(rt, 2))
    def ids():
        import importlib

        return sorted(getattr(importlib.import_module(mod), fn)())

    got = rt.get(ids.remote(), timeout=120)
    return len(got), len(set(got)), all(0 <= i < 4 for i in got)


def test_visible_device_ids_of_a_worker(pkgs):
    _same(pkgs, _scn_visible_ids, want=(2, 2, True))
