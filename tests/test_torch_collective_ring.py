"""The port's host-plane ring collectives against the JAX package's.

Twins of tests/test_collective_ring.py (all but
``test_ring_collective_cross_host``, which needs follower hosts: its twin
is in tests/test_torch_multihost.py): large host tensors ride the object store by ref, the
rendezvous actor carries only small messages, odd sizes take the padded
path, and destroying a group releases its actor. Each scenario runs
through both runtimes (one module-scoped session each, tests/torch_twins.py)
and returns what the reference test asserts.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from torch_twins import kill_made, same, start_sessions, sub

BIG = 1 << 19  # 2 MB float32 — over RING_MIN_BYTES


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    """Both runtimes; then every actor the scenario made is killed."""
    try:
        return same(pkgs, scn, want, serve_cleanup=False)
    finally:
        kill_made(pkgs, _made)


_made: dict = {}


def _ring_worker(rt):
    """The reference's RingWorker, on package `rt` (defined here, so a
    worker unpickles it by value and never imports this file)."""
    pkg = rt.__name__

    @rt.remote
    class RingWorker:
        def init_collective_group(self, world_size, rank, backend,
                                  group_name):
            import importlib

            self.col = importlib.import_module(pkg + ".util.collective")
            self.col.init_collective_group(world_size, rank, backend=backend,
                                           group_name=group_name)
            self.rank = rank
            self.g = group_name

        def big_allreduce(self, n, op="sum"):
            x = np.full((n,), float(self.rank + 1), np.float32)
            out = self.col.allreduce(x, op=op, group_name=self.g,
                                     timeout=120.0)
            return float(out[0]), float(out[-1]), tuple(out.shape)

        def big_allreduce_2d(self, rows, cols):
            x = np.full((rows, cols), float(self.rank + 1), np.float64)
            out = self.col.allreduce(x, op="mean", group_name=self.g,
                                     timeout=120.0)
            return float(out[0, 0]), tuple(out.shape)

        def big_allgather(self, n):
            x = np.full((n,), float(self.rank), np.float32)
            outs = self.col.allgather(x, group_name=self.g, timeout=120.0)
            return [float(o[0]) for o in outs]

        def big_broadcast(self, n):
            payload = (np.arange(n, dtype=np.float32)
                       if self.rank == 0 else None)
            out = self.col.broadcast(payload, src_rank=0, group_name=self.g,
                                     timeout=120.0)
            return float(out[-1]), tuple(out.shape)

        def odd_allreduce(self, n):
            x = np.full((n,), 1.0, np.float32)
            out = self.col.allreduce(x, group_name=self.g, timeout=120.0)
            return float(out.sum()), tuple(out.shape)

        def odd_allreduce_ops(self, n):
            base = np.arange(n, dtype=np.float32)
            x = base + float(self.rank)
            out = {}
            for op in ("sum", "mean", "max", "min"):
                got = self.col.allreduce(x, op=op, group_name=self.g,
                                         timeout=120.0)
                out[op] = (float(got[0]), float(got[n // 2]),
                           float(got[-1]), str(got.dtype), tuple(got.shape))
            return out

        def mean_dtype(self, n, dtype):
            x = np.full((n,), float(self.rank + 1), dtype)
            out = self.col.allreduce(x, op="mean", group_name=self.g,
                                     timeout=120.0)
            return str(out.dtype), float(out[0]), float(out[-1])

        def destroy(self):
            import importlib

            cmod = importlib.import_module(pkg + ".util.collective.collective")
            self.col.destroy_collective_group(self.g)
            return self.g in cmod._groups

    return RingWorker


def _mkgroup(rt, n, name):
    workers = [_ring_worker(rt).remote() for _ in range(n)]
    _made.setdefault(rt.__name__, []).extend(workers + [name])
    sub(rt, "util.collective").create_collective_group(
        workers, n, list(range(n)), group_name=name)
    return workers


def test_ring_allreduce_matches_small_path(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "ring2")
        return rt.get([w.big_allreduce.remote(BIG) for w in ws], timeout=180)

    _same(pkgs, scn, [(3.0, 3.0, (BIG,))] * 2)


def test_ring_allreduce_mean_2d_and_odd_sizes(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "ringodd")
        a = rt.get([w.big_allreduce_2d.remote(1024, 513) for w in ws],
                   timeout=180)
        b = rt.get([w.odd_allreduce.remote(BIG + 3) for w in ws],
                   timeout=180)
        return a, b

    _same(pkgs, scn, ([(1.5, (1024, 513))] * 2,
                      [(2.0 * (BIG + 3), (BIG + 3,))] * 2))


def test_ring_allgather_and_broadcast_by_ref(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "ringag")
        a = rt.get([w.big_allgather.remote(BIG) for w in ws], timeout=180)
        b = rt.get([w.big_broadcast.remote(BIG) for w in ws], timeout=180)
        return a, b

    _same(pkgs, scn, ([[0.0, 1.0]] * 2, [(float(BIG - 1), (BIG,))] * 2))


def test_ring_padded_path_all_ops(pkgs):
    n = BIG + 3

    def scn(rt):
        ws = _mkgroup(rt, 2, "ringops")
        return rt.get([w.odd_allreduce_ops.remote(n) for w in ws],
                      timeout=240)

    got = _same(pkgs, scn)
    for ops in got:
        assert ops["sum"][:3] == (1.0, 2.0 * (n // 2) + 1.0,
                                  2.0 * (n - 1) + 1.0)
        assert ops["sum"][4] == (n,)
        assert ops["mean"][:3] == (0.5, n // 2 + 0.5, n - 1 + 0.5)
        assert ops["max"][:3] == (1.0, n // 2 + 1.0, float(n))
        assert ops["max"][3] == "float32"
        assert ops["min"][:3] == (0.0, float(n // 2), float(n - 1))
        assert ops["min"][4] == (n,)


def test_ring_mean_preserves_float_dtype(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "ringdt")
        return [rt.get([w.mean_dtype.remote(n, dtype) for w in ws],
                       timeout=240)
                for dtype, n in (("float32", BIG + 1),
                                 ("float64", BIG // 2 + 1))]

    _same(pkgs, scn, [[("float32", 1.5, 1.5)] * 2,
                      [("float64", 1.5, 1.5)] * 2])


def test_destroy_collective_group_releases_everything(pkgs):
    def scn(rt):
        list_actors = sub(rt, "util.state").list_actors
        ws = _mkgroup(rt, 2, "ringgone")
        rt.get([w.big_allreduce.remote(BIG) for w in ws], timeout=180)
        name = "__collective::ringgone"
        was_alive = any(a.get("name") == name
                        and a.get("state").lower() == "alive"
                        for a in list_actors())
        still_member = rt.get([w.destroy.remote() for w in ws], timeout=60)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            alive = [a for a in list_actors()
                     if a.get("name") == name
                     and a.get("state", "").lower() == "alive"]
            if not alive:
                break
            time.sleep(0.2)
        try:
            rt.get_actor(name, namespace="_system")
            lookup = "found"
        except ValueError:
            lookup = "ValueError"
        ws2 = _mkgroup(rt, 2, "ringgone")
        again = rt.get([w.big_allreduce.remote(BIG) for w in ws2],
                       timeout=180)
        return was_alive, still_member, bool(alive), lookup, again

    _same(pkgs, scn, (True, [False, False], False, "ValueError",
                      [(3.0, 3.0, (BIG,))] * 2))
