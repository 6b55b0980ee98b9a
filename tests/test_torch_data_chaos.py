"""The port's Data under fault injection against the JAX package's:
SIGKILL map-pool actors mid-stream and delete a block's only shm copy
mid-pipeline; the executor must recover bit-exact.

Twins of tests/test_data_chaos.py (slow and ``data_chaos`` there, so here
too), run on both packages and compared (tests/torch_twins.py). Each side
finds its victims through its own runtime's worker table
(``list_workers``), and checks for leaks only its own session's
segments (``/dev/shm/rtpu_<session>*`` and the port's
``/dev/shm/rtpt_<session>*``).
"""

from __future__ import annotations

import glob
import os
import signal

import numpy as np
import pytest

from torch_twins import rpc, same, start_sessions, sub

pytestmark = [pytest.mark.data_chaos, pytest.mark.slow]


@pytest.fixture
def pkgs():
    pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=10)
    sessions = [(rt, sub(rt, "_private.constants"),
                 sub(rt, "_private.api")._node.session_id) for rt in pkgs]
    yield pkgs
    for rt in pkgs:
        rt.shutdown()
    for rt, c, sid in sessions:
        leaked = glob.glob(f"{c.SHM_DIR}/{c.SHM_SESSION_PREFIX}{sid}*")
        assert not leaked, f"/dev/shm segment leak: {leaked}"


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False, timeout=300)


def _actor_rows(rt):
    rows = rpc(rt, {"type": "list_workers"}).get("workers", [])
    return {r["actor_id"]: r for r in rows
            if r.get("actor_id") and not r.get("dead")}


def _sigkill_actor(rt, actor) -> int:
    pid = _actor_rows(rt)[actor._actor_id]["pid"]
    os.kill(pid, signal.SIGKILL)
    return pid


def _metric_total(rt, name: str) -> float:
    return sum(value for m in sub(rt, "util.metrics").snapshot()
               if m["name"] == name for _tags, value in m["series"])


def _slow_triple():
    # closure (not a module-level def): the worker can't import this
    # test module, so the UDF must pickle by value with no globals
    def fn(batch):
        import time as _t

        _t.sleep(0.15)  # keep work in flight when the SIGKILL lands
        return {"id": batch["id"], "v": batch["id"] * 3.0}

    return fn


def _pool_pipeline(rt, concurrency=2):
    return sub(rt, "data").range(1000, parallelism=8).map_batches(
        _slow_triple(), compute="actors", concurrency=concurrency)


def _drain_batches(rt, ds, kill_after=None):
    """Every iter_batches row; optionally SIGKILL one NEW pool actor right
    after the first batch arrives."""
    pre = set(_actor_rows(rt)) if kill_after is not None else set()
    ids, vals, killed = [], [], False
    for batch in ds.iter_batches(batch_size=100):
        ids.append(np.asarray(batch["id"]))
        vals.append(np.asarray(batch["v"]))
        if kill_after is not None and not killed:
            fresh = {aid: r for aid, r in _actor_rows(rt).items()
                     if aid not in pre}
            assert fresh, "no live map-pool actor found to kill"
            os.kill(next(iter(fresh.values()))["pid"], signal.SIGKILL)
            killed = True
    assert kill_after is None or killed
    return np.concatenate(ids), np.concatenate(vals)


class _Taker:
    """Consume executor items while the generator is live."""

    def __init__(self, rt, ex):
        self.rt, self.ex, self.blocks = rt, ex, []

    def __call__(self, item):
        ex = self.ex
        got = (sub(self.rt, "data.execution")._robust_get(item, rng=ex._rng)
               if hasattr(item, "hex") else item)
        ex._free_if_owned(item)
        self.blocks.extend(got if isinstance(got, list) else [got])


def test_sigkill_pool_actor_mid_iter_batches_bit_exact(pkgs):
    """SIGKILL a map-pool actor mid-`iter_batches`: the run finishes
    bit-exact vs an unkilled run, with supervision visible in the
    replacement/retry counters and the data.* event log."""
    def scn(rt):
        events = sub(rt, "_private.events")
        want_ids, want_vals = _drain_batches(rt, _pool_pipeline(rt))
        events.reset()
        retries0 = _metric_total(rt, "ray_tpu_data_block_retries_total")
        repl0 = _metric_total(rt, "ray_tpu_data_actor_replacements_total")
        got_ids, got_vals = _drain_batches(rt, _pool_pipeline(rt),
                                           kill_after=1)
        etypes = {e["etype"] for e in events.recent()}
        return (np.array_equal(got_ids, want_ids),
                np.array_equal(got_vals, want_vals), want_ids.tolist(),
                _metric_total(rt, "ray_tpu_data_actor_replacements_total")
                > repl0,
                _metric_total(rt, "ray_tpu_data_block_retries_total")
                > retries0,
                "data.actor_replaced" in etypes, "data.block_retry" in etypes)

    out = _same(pkgs, scn)
    assert out[:2] == (True, True) and all(out[3:])


def test_pool_restored_to_target_size_after_kill(pkgs):
    """Kill a pool actor by handle, finish the run, and inspect the pool:
    back at target size, one replacement consumed, zero errored blocks."""
    def scn(rt):
        ex = sub(rt, "data.execution").StreamingExecutor(
            _pool_pipeline(rt)._stages())
        take = _Taker(rt, ex)
        gen = ex.execute()
        try:
            take(next(gen))
            pool = next(iter(ex._actor_pools))
            _sigkill_actor(rt, pool.actors[0])
            for item in gen:
                take(item)
        finally:
            ex.release_owned()
        ids = np.concatenate([np.asarray(b["id"]) for b in take.blocks])
        return (np.array_equal(ids, np.arange(1000)), len(pool.actors),
                pool.replacements >= 1, ex.errored_blocks, not ex.owned)

    _same(pkgs, scn, (True, 2, True, 0, True))


def test_dead_actor_multi_task_batch_failure(pkgs):
    """SIGKILL an actor holding several in-flight payloads: they all come
    back errored in one wait batch and each is classified once."""
    def scn(rt):
        stages = _pool_pipeline(rt, concurrency=1)._stages()
        stage = next(s for s in stages if s.compute == "actors")
        stage.max_in_flight = 4  # 4 payloads in flight on the ONE actor
        ex = sub(rt, "data.execution").StreamingExecutor(stages)
        take = _Taker(rt, ex)
        gen = ex.execute()
        try:
            take(next(gen))
            pool = next(iter(ex._actor_pools))
            one = len(pool.actors)
            while len(pool._outstanding) < 2:
                take(next(gen))  # pump until >= 2 payloads share the actor
            _sigkill_actor(rt, pool.actors[0])
            for item in gen:
                take(item)
        finally:
            ex.release_owned()
        ids = np.concatenate([np.asarray(b["id"]) for b in take.blocks])
        vals = np.concatenate([np.asarray(b["v"]) for b in take.blocks])
        return (one, np.array_equal(ids, np.arange(1000)),
                np.array_equal(vals, np.arange(1000) * 3.0),
                pool.replacements >= 1, ex.errored_blocks, not ex.owned)

    _same(pkgs, scn, (1, True, True, True, 0, True))


def _widen():
    def fn(batch):
        import numpy as _np

        n = len(batch["id"])
        # 64 float64 columns per row: every block is past the inline
        # limit, so results live as shm segments with lineage
        return {"id": batch["id"],
                "pad": _np.ones((n, 64), dtype=_np.float64)}

    return fn


def test_lost_block_copies_refilled_by_lineage(pkgs):
    """Destroy a finished result block's only copy mid-stream, before the
    consumer reads it: the consume path replays the retained lineage spec
    and refills the block bit-exact."""
    def scn(rt):
        ex = sub(rt, "data.execution").StreamingExecutor(
            sub(rt, "data").range(1000, parallelism=4).map_batches(
                _widen())._stages())
        w = sub(rt, "_private.api")._worker
        take = _Taker(rt, ex)
        gen = ex.execute()
        deleted = None
        try:
            take(next(gen))
            for item in gen:
                if (deleted is None and hasattr(item, "hex")
                        and w.store.contains(item.hex())):
                    oid = item.hex()
                    w.store.delete(oid)
                    w._memory.pop(oid, None)
                    w._plasma_refs.pop(oid, None)
                    w._status_cache.pop(oid, None)
                    deleted = oid
                take(item)
        finally:
            ex.release_owned()
        ids = np.concatenate([np.asarray(b["id"]) for b in take.blocks])
        return (deleted is not None,
                np.array_equal(np.sort(ids), np.arange(1000)),
                all(b["pad"].shape[1] == 64
                    and float(b["pad"].sum()) == b["pad"].size
                    for b in take.blocks), ex.errored_blocks)

    _same(pkgs, scn, (True, True, True, 0))
