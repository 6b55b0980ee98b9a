"""The port's distributed all-to-all against the JAX package's: shuffle,
sort and repartition as partition + merge task graphs, ordered streaming
and the executor's count and byte gates.

Twins of tests/test_data_shuffle.py, run on both packages and compared
(tests/torch_twins.py).
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_twins import is_port, same, start_sessions, sub

# the reference marks its module slow (tests/conftest.py _SLOW_MODULES)
pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=8, num_workers=2, max_workers=8)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False)


def _data(rt):
    return sub(rt, "data")


def _rows_of(rt, exe, col="id"):
    out = []
    for item in exe.execute():
        got = rt.get(item) if hasattr(item, "hex") else item
        for b in (got if isinstance(got, list) else [got]):
            out.extend(int(x) for x in b.get(col, ()))  # empty partitions
    return out


def test_sort_distributed_correctness(pkgs):
    def scn(rt):
        ds = _data(rt).range(5000, parallelism=8).random_shuffle(
            seed=7).sort("id")
        return [int(r["id"]) for r in ds.iter_rows()] == list(range(5000))

    _same(pkgs, scn, True)


def test_sort_descending(pkgs):
    def scn(rt):
        ds = _data(rt).range(1000, parallelism=4).sort("id", descending=True)
        return [int(r["id"]) for r in ds.iter_rows()]

    _same(pkgs, scn, list(range(999, -1, -1)))


def test_streaming_preserves_dataset_order(pkgs):
    """Row order out of the executor equals dataset order, with the first
    task a hard straggler and parallelism above the count gate."""
    def scn(rt):
        ds = _data(rt).range(200, parallelism=24).map(
            lambda r: __import__("time").sleep(
                0.4 if int(r["id"]) == 0 else 0.001) or r)
        return [int(r["id"]) for r in ds.iter_rows()]

    _same(pkgs, scn, list(range(200)))


def test_byte_budget_backpressure_completes(pkgs):
    """A byte budget far smaller than the dataset throttles dispatch and
    never deadlocks or drops blocks."""
    def scn(rt):
        ex = sub(rt, "data.execution")
        ds = _data(rt).range(16, parallelism=8).map_batches(
            lambda b: {"id": b["id"],
                       "payload": np.zeros((len(b["id"]), 131072),
                                           np.float64)},
            batch_size=1)
        exe = ex.StreamingExecutor(ex.build_stages(ds._op.chain(), 8),
                                   max_queued_bytes=1 << 20)
        return len(_rows_of(rt, exe))

    _same(pkgs, scn, 16)


def test_barrier_input_exempt_from_gates(pkgs):
    """A shuffle whose input exceeds both the count gate and the byte
    budget still completes: barrier input is exempt from the gates."""
    def scn(rt):
        ex = sub(rt, "data.execution")
        ds = _data(rt).range(40, parallelism=40).map_batches(
            lambda b: {"id": b["id"],
                       "payload": np.zeros((len(b["id"]), 16384),
                                           np.float64)},
            batch_size=1).random_shuffle(seed=1)
        exe = ex.StreamingExecutor(ex.build_stages(ds._op.chain(), 40),
                                   max_queued=16, max_queued_bytes=1 << 20)
        return sorted(_rows_of(rt, exe))

    _same(pkgs, scn, list(range(40)))


def test_shuffle_preserves_multiset(pkgs):
    def scn(rt):
        rd = _data(rt)
        ds = rd.range(3000, parallelism=6).random_shuffle(seed=3)
        ds2 = rd.range(3000, parallelism=6).random_shuffle(seed=3)
        order1 = [int(r["id"]) for r in ds.iter_rows()]
        order2 = [int(r["id"]) for r in ds2.iter_rows()]
        return (sorted(order1) == list(range(3000)), order1 == order2,
                order1 != list(range(3000)), order1)

    # the same seed gives the same permutation in both packages
    assert _same(pkgs, scn)[:3] == (True, True, True)


def test_repartition_balances_rows(pkgs):
    def scn(rt):
        ds = _data(rt).range(1000, parallelism=5).repartition(4)
        return (sorted(int(r["id"]) for r in ds.iter_rows()),
                len(list(ds.iter_blocks())))

    _same(pkgs, scn, (list(range(1000)), 4))


def test_driver_never_materializes_shuffle_blocks(pkgs, monkeypatch):
    """The executor must not get() data blocks during a distributed
    barrier, only the tiny sort samples and row counts."""
    pulled = {}

    def spy(rt):
        real_get = rt.get
        name = rt.__name__

        def spy_get(refs, **kw):
            out = real_get(refs, **kw)
            for v in (out if isinstance(out, list) else [out]):
                if isinstance(v, list) and v and isinstance(v[0], dict):
                    nbytes = sum(getattr(col, "nbytes", 0) for b in v
                                 if isinstance(b, dict) for col in b.values())
                    if nbytes > 100_000:
                        pulled.setdefault(name, []).append(nbytes)
            return out

        return spy_get

    for rt in pkgs:
        monkeypatch.setattr(sub(rt, "data.execution").__dict__[
            "ray_tpu_torch" if is_port(rt) else "ray_tpu"], "get", spy(rt))

    def scn(rt):
        ds = _data(rt).range(200_000, parallelism=8).random_shuffle(seed=1)
        total = 0
        for batch in ds.iter_batches(batch_size=50_000):
            total += len(batch["id"])
        return total, pulled.get(rt.__name__, [])

    _same(pkgs, scn, (200_000, []))
