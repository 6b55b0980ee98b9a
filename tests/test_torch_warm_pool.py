"""Twins of tests/test_warm_pool.py against the port's runtime.

The GCS keeps a configurable floor of idle no-env CPU workers
(``RAY_TPU_TORCH_WARM_POOL_SIZE``), replenished through the ordinary spawn
machinery: the pool fills and serves a cold task by dispatch, refills
after actors pin its workers, and stays empty by default. Same scenarios,
polls and bounds as the reference's; a worker holding a card is left out
as the reference leaves out one holding TPU chips.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.ray_config import RayConfig


def _idle_plain_workers():
    from ray_tpu_torch._private.api import _get_worker

    reply = _get_worker().rpc({"type": "list_workers"})
    return [x for x in reply.get("workers", [])
            if x.get("kind") == "worker" and x.get("idle")
            and not x.get("gpus")]


def _wait_idle_count(n, timeout=45):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if len(_idle_plain_workers()) >= n:
            return True
        time.sleep(0.2)
    return False


@pytest.fixture
def warm_session():
    os.environ["RAY_TPU_TORCH_WARM_POOL_SIZE"] = "2"
    RayConfig.reset()
    ray_tpu_torch.init(num_cpus=4, num_workers=0, max_workers=4)
    yield
    ray_tpu_torch.shutdown()
    os.environ.pop("RAY_TPU_TORCH_WARM_POOL_SIZE", None)
    RayConfig.reset()


@pytest.mark.slow
def test_warm_pool_prefills_and_serves_cold_task_fast(warm_session):
    assert _wait_idle_count(2), "warm pool never filled"

    @ray_tpu_torch.remote
    def f():
        return os.getpid()

    t0 = time.perf_counter()
    pid = ray_tpu_torch.get(f.remote(), timeout=30)
    latency = time.perf_counter() - t0
    assert pid > 0
    # a spawn-path cold task costs ~2s+ (fork + imports) on one core; a
    # warm dispatch is tens of ms — generous bound for 1-core noise
    assert latency < 1.0, f"cold first task took {latency:.2f}s (spawn path?)"


@pytest.mark.slow
def test_warm_pool_replenishes_after_consumption(warm_session):
    """Actors pin their workers permanently, so the refill below can ONLY
    come from the warm floor — a plain burst would leave its demand-spawned
    workers idle and pass trivially."""
    assert _wait_idle_count(2), "warm pool never filled"

    @ray_tpu_torch.remote
    class Pin:
        def ping(self):
            return "up"

    actors = [Pin.remote() for _ in range(2)]
    assert ray_tpu_torch.get([a.ping.remote() for a in actors],
                             timeout=60) == ["up", "up"]
    # both warm workers are now actor-pinned (not idle); the floor must
    # respawn fresh idle workers with no pending plain-task demand at all
    assert _wait_idle_count(2), \
        "warm pool not replenished after actors consumed it"


@pytest.mark.slow
def test_no_warm_pool_by_default():
    ray_tpu_torch.init(num_cpus=4, num_workers=0, max_workers=4)
    try:
        time.sleep(2.0)
        assert _idle_plain_workers() == []
    finally:
        ray_tpu_torch.shutdown()
