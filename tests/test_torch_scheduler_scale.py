"""Twins of tests/test_scheduler_scale.py against the port's runtime.

The GCS's pending queue sharded by (resource shape, renv_hash)
(``ray_tpu_torch/_private/gcs.py`` ``_PendingShards``): shards and the
misc list, FIFO within a shard, the queued-ness multiset, and a deep
queue behind blocked workers that still takes submissions fast. Same
scenarios and bounds as the reference's; the port's env names.
"""

import os
import tempfile
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.gcs import _PendingShards


def _spec(tid, res=None, strategy=None, renv=""):
    return {"kind": "task", "task_id": tid, "resources": res or {"CPU": 1.0},
            "strategy": strategy, "renv_hash": renv, "num_returns": 1}


def test_pending_shards_basic():
    q = _PendingShards()
    assert not q and len(q) == 0
    q.append(_spec("a"))
    q.append(_spec("b", res={"CPU": 2.0}))
    q.append(_spec("c", strategy={"kind": "pg", "pg_id": "p"}))
    assert len(q) == 3 and q
    assert len(q.shards) == 2  # two resource shapes
    assert len(q.misc) == 1  # strategy spec
    assert {s["task_id"] for s in q} == {"a", "b", "c"}
    assert q.is_queued("a") and not q.is_queued("zz")
    removed = q.remove_task_id("a")
    assert [s["task_id"] for s in removed] == ["a"]
    assert len(q) == 2 and not q.is_queued("a")


def test_pending_shards_fifo_within_shard():
    q = _PendingShards()
    for i in range(5):
        q.append(_spec(f"t{i}"))
    q.appendleft(_spec("front"))
    (key, dq), = q.shards.items()
    assert [s["task_id"] for s in dq] == ["front"] + [f"t{i}"
                                                      for i in range(5)]


def test_pending_shards_note_consumed_multiset():
    q = _PendingShards()
    q.append(_spec("dup"))
    q.append(_spec("dup"))
    q.note_consumed("dup")
    assert q.is_queued("dup")  # one copy still queued
    q.note_consumed("dup")
    assert not q.is_queued("dup")
    q.note_consumed("dup")  # over-consume is a no-op
    assert not q.is_queued("dup")


@pytest.mark.slow
def test_deep_queue_submission_stays_fast():
    """Submitting behind blocked workers must not collapse to O(queue)
    per submit. Floor is deliberately conservative for a 1-core machine
    (measured ~8-14k/s; pre-fix was ~300/s)."""
    os.environ["RAY_TPU_TORCH_DIRECT_DISPATCH"] = "0"
    from ray_tpu_torch._private.ray_config import RayConfig

    RayConfig.reset()
    try:
        ray_tpu_torch.init(num_cpus=2, num_workers=2, max_workers=2)

        @ray_tpu_torch.remote
        def blocker(path):
            open(path, "w").close()
            while not os.path.exists(path + ".go"):
                time.sleep(0.05)
            return "ok"

        @ray_tpu_torch.remote
        def noop():
            return 0

        d = tempfile.mkdtemp(prefix="deepq")
        marks = [os.path.join(d, f"b{i}") for i in range(2)]
        blockers = [blocker.remote(m) for m in marks]
        deadline = time.time() + 30
        while not all(os.path.exists(m) for m in marks):
            assert time.time() < deadline, "blockers never started"
            time.sleep(0.05)

        n = 5000
        t0 = time.perf_counter()
        refs = [noop.remote() for _ in range(n)]
        rate = n / (time.perf_counter() - t0)
        for m in marks:
            open(m + ".go", "w").close()
        assert ray_tpu_torch.get(blockers) == ["ok", "ok"]
        assert ray_tpu_torch.get(refs) == [0] * n
        assert rate > 1500, f"deep-queue submit collapsed: {rate:.0f}/s"
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TORCH_DIRECT_DISPATCH", None)
        RayConfig.reset()
