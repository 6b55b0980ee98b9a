"""Twins of tests/test_memory_monitor.py against the port's runtime.

The host memory monitor and its worker-killing policy
(``ray_tpu_torch/_private/memory_monitor.py``; the GCS runs one for the
head host, each node agent one for its own): the usage and RSS readers on
the real /proc, a kill over the threshold and none under it, and a
session under faked pressure (``RAY_TPU_TORCH_TESTING_MEM_USAGE_FILE``)
that kills a task's worker, retries it once pressure clears, and names
memory in the error of a task with no retries left. Same scenarios,
polls and bounds as the reference's; the port's env names.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.memory_monitor import (MemoryMonitor,
                                                   host_memory_usage,
                                                   proc_rss_bytes)
from ray_tpu_torch._private.ray_config import RayConfig


def test_usage_and_rss_read_real_proc():
    u = host_memory_usage()
    assert 0.0 < u < 1.0
    assert proc_rss_bytes(os.getpid()) > 1 << 20  # this interpreter > 1MB


def test_monitor_kills_over_threshold(tmp_path):
    gauge = tmp_path / "usage"
    gauge.write_text("0.99")
    os.environ["RAY_TPU_TORCH_TESTING_MEM_USAGE_FILE"] = str(gauge)
    killed = []
    try:
        import subprocess
        import sys

        p = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
        mon = MemoryMonitor(
            threshold=0.95, period_s=0.05,
            pick_victim=lambda: (p.pid, "test victim")
            if p.poll() is None else None,
            on_kill=lambda pid, why: killed.append((pid, why))).start()
        deadline = time.monotonic() + 10
        while p.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        mon.stop()
        assert p.poll() is not None, "victim should have been SIGKILLed"
        assert killed and killed[0][0] == p.pid
        assert "threshold" in killed[0][1]
        # under threshold → no kill
        gauge.write_text("0.10")
        mon2 = MemoryMonitor(threshold=0.95, period_s=0.05,
                             pick_victim=lambda: (os.getpid(), "self!"))
        mon2.start()
        time.sleep(0.3)
        mon2.stop()
        assert mon2.kills == 0
    finally:
        os.environ.pop("RAY_TPU_TORCH_TESTING_MEM_USAGE_FILE", None)


@pytest.fixture
def oom_session(tmp_path):
    gauge = tmp_path / "usage"
    gauge.write_text("0.99")
    os.environ["RAY_TPU_TORCH_TESTING_MEM_USAGE_FILE"] = str(gauge)
    os.environ["RAY_TPU_TORCH_MEMORY_MONITOR_REFRESH_MS"] = "50"
    RayConfig.reset()
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_workers=1, max_workers=4)
    yield gauge
    ray_tpu_torch.shutdown()
    os.environ.pop("RAY_TPU_TORCH_TESTING_MEM_USAGE_FILE", None)
    os.environ.pop("RAY_TPU_TORCH_MEMORY_MONITOR_REFRESH_MS", None)
    RayConfig.reset()


@pytest.mark.slow
def test_memory_pressure_survived_via_kills(oom_session):
    """A memory-hog pipeline survives: the monitor kills the task's worker
    instead of letting the host OOM, and the retry succeeds once pressure
    clears."""

    @ray_tpu_torch.remote(max_retries=8)
    def hog():
        time.sleep(1.0)
        return "survived"

    ref = hog.remote()
    time.sleep(0.6)  # at least one kill cycle under 99% usage
    oom_session.write_text("0.10")  # pressure clears; the retry completes
    assert ray_tpu_torch.get(ref, timeout=60) == "survived"


@pytest.mark.slow
def test_memory_kill_error_mentions_memory(oom_session):
    @ray_tpu_torch.remote(max_retries=0)
    def hog():
        time.sleep(30)
        return "never"

    ref = hog.remote()
    from ray_tpu_torch.exceptions import WorkerCrashedError

    with pytest.raises(WorkerCrashedError, match="memory"):
        ray_tpu_torch.get(ref, timeout=60)
