"""The port's Data against the JAX package's: blocks, the logical plan, the
streaming executor, sources and sinks.

Twins of tests/test_data.py. Each scenario runs through ``ray_tpu`` and
``ray_tpu_torch`` (one session per package, both in this process, the two
scenarios on two threads; see tests/torch_twins.py) and both must return
the same observations, which must also be what the reference test asserts.
Pure units run on both packages in turn (``pair``). UDFs are defined
inside the scenario, so they pickle by value. The twin of
``iter_jax_batches`` compares the port's ``iter_device_batches(device=
"cpu")`` with the JAX package's arrays as numpy.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import pandas  # noqa: F401 — loaded before the twins' threads import it
import pyarrow.csv  # noqa: F401
import pyarrow.parquet  # noqa: F401
import pytest

from torch_twins import pair, plain, same, start_sessions, sub


def _data(rt):
    return sub(rt, "data")


# ---------------------------------------------------------------- pure units


def test_block_accessor_basics():
    def scn(rt):
        BlockAccessor = sub(rt, "data.block").BlockAccessor
        b = {"a": np.arange(10), "b": np.arange(10) * 2}
        acc = BlockAccessor(b)
        rows = list(acc.iter_rows())
        return (acc.num_rows(), acc.slice(2, 4)["a"].tolist(),
                plain(rows[3]), acc.size_bytes() > 0)

    pair(scn, (10, [2, 3], {"a": 3, "b": 6}, True))


def test_rows_to_block_and_concat():
    def scn(rt):
        blk = sub(rt, "data.block")
        b1 = blk.rows_to_block([{"x": 1}, {"x": 2}])
        b2 = blk.rows_to_block([{"x": 3}])
        return blk.concat_blocks([b1, b2])["x"].tolist()

    pair(scn, [1, 2, 3])


def test_rebatch_exact_and_remainder():
    def scn(rt):
        ex = sub(rt, "data.execution")
        BlockAccessor = sub(rt, "data.block").BlockAccessor
        blocks = [{"v": np.arange(7)}, {"v": np.arange(7, 10)}]
        return [BlockAccessor(b).num_rows() for b in ex._rebatch(blocks, 4)]

    pair(scn, [4, 4, 2])


def test_fusion_builds_single_stage():
    def scn(rt):
        rd, L = _data(rt), sub(rt, "data.logical")
        ds = rd.range(10).map_batches(lambda b: b).map(lambda r: r).filter(
            lambda r: True)
        stages = sub(rt, "data.execution").build_stages(
            L.optimize(ds._op.chain()), 4)
        return len(stages), "Read" in stages[0].name, stages[0].name

    pair(scn)


def test_limit_pushdown_caps_read_tasks():
    def scn(rt):
        rd, L = _data(rt), sub(rt, "data.logical")
        ds = rd.range(1000, parallelism=10).limit(5)
        ops = L.optimize(ds._op.chain())
        read = next(o for o in ops if isinstance(o, L.Read))
        stages = sub(rt, "data.execution").build_stages(ops, 10)
        return read.limit, len(stages[0].read_tasks)

    pair(scn, (5, 1))


# ------------------------------------------------------------------------ e2e


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=2, max_workers=6)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def test_map_batches_e2e(pkgs):
    def scn(rt):
        ds = _data(rt).range(1000).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2})
        return ds.count(), [int(r["sq"]) for r in ds.limit(5).take_all()]

    same(pkgs, scn, (1000, [0, 1, 4, 9, 16]), serve_cleanup=False)


def test_map_filter_flat_map(pkgs):
    def scn(rt):
        rd = _data(rt)
        evens = rd.range(100).filter(lambda r: r["id"] % 2 == 0).count()
        flat = rd.range(3).flat_map(
            lambda r: [{"v": r["id"]}, {"v": r["id"]}]).count()
        ds = rd.range(3).map(lambda r: {"y": r["id"] + 1})
        return evens, flat, sorted(int(r["y"]) for r in ds.take_all())

    same(pkgs, scn, (50, 6, [1, 2, 3]), serve_cleanup=False)


def test_sort_shuffle_repartition(pkgs):
    def scn(rt):
        rd = _data(rt)
        items = [{"x": i} for i in [3, 1, 2]]
        up = [r["x"] for r in rd.from_items(items).sort("x").take_all()]
        down = [r["x"] for r in rd.from_items(items).sort(
            "x", descending=True).take_all()]
        sh = sorted(int(r["id"]) for r in
                    rd.range(50).random_shuffle(seed=0).take_all())
        blocks = list(rd.range(100).repartition(5).iter_blocks())
        return plain((up, down)), sh == list(range(50)), len(blocks)

    same(pkgs, scn, (([1, 2, 3], [3, 2, 1]), True, 5), serve_cleanup=False)


def test_iter_batches_sizes(pkgs):
    def scn(rt):
        rd = _data(rt)
        return ([len(b["id"]) for b in rd.range(100).iter_batches(
                    batch_size=32)],
                [len(b["id"]) for b in rd.range(100).iter_batches(
                    batch_size=32, drop_last=True)])

    same(pkgs, scn, ([32, 32, 32, 4], [32, 32, 32]), serve_cleanup=False)


def test_batch_formats(pkgs):
    def scn(rt):
        rd = _data(rt)
        pdf = next(iter(rd.range(10).iter_batches(batch_size=10,
                                                  batch_format="pandas")))
        tbl = next(iter(rd.range(10).iter_batches(batch_size=10,
                                                  batch_format="pyarrow")))
        return list(pdf.columns), tbl.num_rows

    same(pkgs, scn, (["id"], 10), serve_cleanup=False)


def test_column_ops(pkgs):
    def scn(rt):
        ds = _data(rt).range(10).add_column("double", lambda b: b["id"] * 2)
        ds3 = ds.select_columns(["id"]).rename_columns({"id": "idx"})
        return (int(ds.take(1)[0]["double"]),
                set(ds.drop_columns(["id"]).take(1)[0].keys()),
                set(ds3.take(1)[0].keys()))

    same(pkgs, scn, (0, {"double"}, {"idx"}), serve_cleanup=False)


def test_parquet_roundtrip(pkgs):
    def scn(rt):
        rd = _data(rt)
        with tempfile.TemporaryDirectory() as d:
            files = rd.range(20, parallelism=2).write_parquet(d)
            back = rd.read_parquet(d)
            return (len(files), all(os.path.exists(f) for f in files),
                    sorted(int(r["id"]) for r in back.take_all()))

    same(pkgs, scn, (2, True, list(range(20))), serve_cleanup=False)


def test_csv_json_roundtrip(pkgs):
    def scn(rt):
        rd = _data(rt)
        with tempfile.TemporaryDirectory() as d:
            rd.from_items([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}]).write_csv(d)
            csv = sorted(plain((r["a"], r["b"])) for r in
                         rd.read_csv(d).take_all())
        with tempfile.TemporaryDirectory() as d:
            rd.from_items([{"a": 1}, {"a": 2}]).write_json(d)
            js = sorted(int(r["a"]) for r in rd.read_json(d).take_all())
        return csv, js

    same(pkgs, scn, ([(1, "x"), (2, "y")], [1, 2]), serve_cleanup=False)


def test_from_pandas_arrow_numpy(pkgs):
    def scn(rt):
        import pandas as pd
        import pyarrow as pa

        rd = _data(rt)
        return (rd.from_pandas(pd.DataFrame({"x": [1, 2]})).count(),
                rd.from_arrow(pa.table({"x": [1, 2, 3]})).count(),
                rd.from_numpy(np.zeros((4, 2))).count())

    same(pkgs, scn, (2, 3, 4), serve_cleanup=False)


def test_union_and_split(pkgs):
    def scn(rt):
        rd = _data(rt)
        return (rd.range(10).union(rd.range(5)).count(),
                [s.count() for s in rd.range(100).split(4)])

    out = same(pkgs, scn, serve_cleanup=False)
    assert out[0] == 15 and sum(out[1]) == 100 and len(out[1]) == 4


def test_streaming_split_consumes_everything(pkgs):
    def scn(rt):
        its = _data(rt).range(100, parallelism=4).streaming_split(2)
        seen = []
        for it in its:
            for b in it.iter_batches(batch_size=None):
                seen.extend(b["id"].tolist())
        return len(seen), sorted(seen)

    same(pkgs, scn, (100, list(range(100))), serve_cleanup=False)


def test_iter_jax_batches_prefetch(pkgs):
    """The JAX package's iter_jax_batches against the port's
    iter_device_batches on the CPU: the same batches, as numpy."""
    def scn(rt):
        ds = _data(rt).range(64)
        if rt.__name__ == "ray_tpu_torch":
            got = list(ds.iter_device_batches(batch_size=16, prefetch=2,
                                              device="cpu"))
            got = [{k: v.numpy() for k, v in b.items()} for b in got]
        else:
            got = [{k: np.asarray(v) for k, v in b.items()}
                   for b in ds.iter_jax_batches(batch_size=16, prefetch=2)]
        # the values agree; the dtypes do not: JAX without x64 narrows
        # int64 to int32, the port keeps the host batch's int64
        want_dtype = "int64" if rt.__name__ == "ray_tpu_torch" else "int32"
        return (len(got), int(got[0]["id"].sum()),
                [plain(b["id"]) for b in got],
                str(got[0]["id"].dtype) == want_dtype)

    out = same(pkgs, scn, serve_cleanup=False)
    assert out[:2] == (4, sum(range(16))) and out[3]


@pytest.mark.parametrize("prefetch,drop_last", [(0, True), (2, False)])
def test_iter_device_batches_window_drop_last_and_dtypes(pkgs, prefetch,
                                                         drop_last):
    """The port's iter_device_batches keeps the reference's window (batches
    pulled from the host before the first is handed out), drop_last and
    host-side dtypes."""
    def scn(rt):
        import types

        ds = _data(rt).range(40)
        pulled = []
        host = type(ds).iter_batches

        def counting(self, **kw):
            for b in host(self, **kw):
                pulled.append(len(b["id"]))
                yield b

        ds.iter_batches = types.MethodType(counting, ds)
        kw = dict(batch_size=16, prefetch=prefetch, drop_last=drop_last,
                  dtypes={"id": np.float32})
        if rt.__name__ == "ray_tpu_torch":
            it = ds.iter_device_batches(device="cpu", **kw)
            host_of = lambda t: t.numpy()  # noqa: E731
        else:
            it = ds.iter_jax_batches(**kw)
            host_of = np.asarray
        first = next(it)
        window = list(pulled)
        got = [host_of(b["id"]) for b in [first, *it]]
        return window, [plain(a) for a in got], [str(a.dtype) for a in got]

    window, ids, dtypes = same(pkgs, scn, serve_cleanup=False)
    n = 2 if drop_last else 3
    assert len(window) == min(prefetch + 1, n) and len(ids) == n
    assert set(dtypes) == {"float32"}


def test_materialize_and_schema(pkgs):
    def scn(rt):
        rd = _data(rt)
        mat = rd.range(10).materialize()
        return mat.count(), mat.num_blocks() >= 1, rd.range(10).schema()

    same(pkgs, scn, (10, True, {"id": "int64"}), serve_cleanup=False)


def test_backpressure_bounded_inflight(pkgs):
    def scn(rt):
        ds = _data(rt).range(2000, parallelism=16).map_batches(lambda b: b)
        ex = sub(rt, "data.execution").StreamingExecutor(ds._stages(),
                                                         max_queued=2)
        BlockAccessor = sub(rt, "data.block").BlockAccessor
        total = 0
        for item in ex.execute():
            got = rt.get(item) if hasattr(item, "hex") else item
            for b in got if isinstance(got, list) else [got]:
                total += BlockAccessor(b).num_rows()
        return total

    same(pkgs, scn, 2000, serve_cleanup=False)


def test_map_batches_actor_pool_stateful(pkgs):
    """compute="actors": a callable-class UDF instantiates once per pool
    actor."""
    def scn(rt):
        class AddPid:
            def __init__(self):
                import os as _os

                self.pid = _os.getpid()  # once per actor
                self.calls = 0

            def __call__(self, batch):
                import numpy as _np

                self.calls += 1
                n = len(batch["id"])
                return {"id": batch["id"], "pid": _np.full(n, self.pid),
                        "call": _np.full(n, self.calls)}

        rows = list(_data(rt).range(64).map_batches(
            AddPid, batch_size=8, compute="actors",
            concurrency=2).iter_rows())
        return (len(rows), 1 <= len({int(r["pid"]) for r in rows}) <= 2,
                max(int(r["call"]) for r in rows) > 1)

    same(pkgs, scn, (64, True, True), serve_cleanup=False)


def test_map_batches_actor_pool_autoscaling_tuple(pkgs):
    """concurrency=(min, max): the pool starts at min, grows under backlog,
    routes by load, and results stay correct."""
    def scn(rt):
        class Slow:
            def __call__(self, batch):
                import os as _os
                import time as _time

                import numpy as _np

                _time.sleep(0.05)
                return {"id": batch["id"] * 10,
                        "pid": _np.full(len(batch["id"]), _os.getpid())}

        rows = list(_data(rt).range(128).map_batches(
            Slow, batch_size=8, compute="actors",
            concurrency=(1, 3)).iter_rows())
        return (sorted(int(r["id"]) for r in rows),
                1 <= len({int(r["pid"]) for r in rows}) <= 3)

    same(pkgs, scn, ([i * 10 for i in range(128)], True),
         serve_cleanup=False)


def test_read_text_and_iter_torch_batches(pkgs, tmp_path):
    import torch

    (tmp_path / "a.txt").write_text("alpha\n\nbeta\n")
    (tmp_path / "b.txt").write_text("gamma\n")

    def scn(rt):
        rd = _data(rt)
        rows = sorted(r["text"] for r in rd.read_text(str(tmp_path)).take_all())
        batches = list(rd.range(10).iter_torch_batches(batch_size=4))
        return (rows, all(isinstance(b["id"], torch.Tensor) for b in batches),
                int(sum(b["id"].sum() for b in batches)))

    same(pkgs, scn, (["alpha", "beta", "gamma"], True, sum(range(10))),
         serve_cleanup=False)


def test_from_torch_dataset(pkgs):
    def scn(rt):
        import torch.utils.data as tud

        class Squares(tud.Dataset):
            def __len__(self):
                return 12

            def __getitem__(self, i):
                return {"x": i, "sq": i * i}

        rows = sorted(_data(rt).from_torch(Squares()).take_all(),
                      key=lambda r: r["x"])
        return len(rows), int(rows[5]["sq"])

    same(pkgs, scn, (12, 25), serve_cleanup=False)


def test_global_aggregates(pkgs):
    def scn(rt):
        rd = _data(rt)
        ds = rd.from_items([{"v": float(i)} for i in range(100)])
        with pytest.raises(Exception, match="not in dataset columns") as ei:
            ds.sum("nope")
        return (plain((ds.sum("v"), ds.min("v"), ds.max("v"), ds.mean("v"))),
                rd.from_items([]).sum("v"), rd.range(0).take_all(),
                type(ei.value).__name__)

    out = same(pkgs, scn, serve_cleanup=False)
    assert out[:3] == ((sum(range(100)), 0.0, 99.0, sum(range(100)) / 100),
                       None, [])
