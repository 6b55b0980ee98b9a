"""The port's groupby/aggregate and join against the JAX package's: the
distributed hash shuffle into per-partition aggregate and join tasks.

Twins of tests/test_data_groupby_join.py, run on both packages and
compared (tests/torch_twins.py). ``test_groupby_multihost`` (slow in the
reference) runs its partitions across a follower host made by
``Cluster.add_host``; its twin is in tests/test_torch_multihost.py, with
the other cross-host cases.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from torch_twins import plain, same, start_sessions, sub

ROWS = [{"k": ["a", "b", "c"][i % 3], "v": float(i), "w": i * 2}
        for i in range(60)]


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=2, max_workers=4)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False)


def _data(rt):
    return sub(rt, "data")


def _agg(rt):
    return sub(rt, "data.aggregate")


def _by_key(out, key="k"):
    return {r[key]: plain(r) for r in out}


def test_groupby_count_sum(pkgs):
    def scn(rt):
        A = _agg(rt)
        out = _data(rt).from_items(ROWS).groupby("k").aggregate(
            A.Count(), A.Sum("v")).take_all()
        return len(out), _by_key(out)

    n, got = _same(pkgs, scn)
    assert n == 3
    for g in "abc":
        expect = [r["v"] for r in ROWS if r["k"] == g]
        assert got[g]["count()"] == len(expect)
        assert got[g]["sum(v)"] == pytest.approx(sum(expect))


def test_groupby_min_max_mean_std_quantile(pkgs):
    def scn(rt):
        A = _agg(rt)
        return _by_key(_data(rt).from_items(ROWS).groupby("k").aggregate(
            A.Min("v"), A.Max("v"), A.Mean("v"), A.Std("v"),
            A.Quantile("v", q=0.5)).take_all())

    got = _same(pkgs, scn)
    for g in "abc":
        vs = [r["v"] for r in ROWS if r["k"] == g]
        assert got[g]["min(v)"] == min(vs)
        assert got[g]["max(v)"] == max(vs)
        assert got[g]["mean(v)"] == pytest.approx(sum(vs) / len(vs))
        assert got[g]["std(v)"] == pytest.approx(np.std(vs, ddof=1))
        assert got[g]["quantile(v)"] == pytest.approx(np.quantile(vs, 0.5))


def test_groupby_multi_key_and_numeric_keys(pkgs):
    rows = [{"a": i % 2, "b": i % 3, "v": i} for i in range(36)]

    def scn(rt):
        out = _data(rt).from_items(rows).groupby(["a", "b"]).sum("v")
        return sorted(plain((r["a"], r["b"], r["sum(v)"]))
                      for r in out.take_all())

    out = _same(pkgs, scn)
    assert len(out) == 6
    for a, b, s in out:
        assert s == sum(x["v"] for x in rows if x["a"] == a and x["b"] == b)


def test_groupby_after_map(pkgs):
    def scn(rt):
        ds = _data(rt).from_items(ROWS).map(lambda r: {**r, "v": r["v"] * 10})
        return _by_key(ds.groupby("k").mean("v").take_all())["a"]["mean(v)"]

    vs = [r["v"] * 10 for r in ROWS if r["k"] == "a"]
    assert _same(pkgs, scn) == pytest.approx(sum(vs) / len(vs))


def test_map_groups(pkgs):
    def scn(rt):
        def top1(group):
            import numpy as _np

            i = int(_np.argmax(_np.asarray(group["v"])))
            return {"k": _np.asarray(group["k"])[i:i + 1],
                    "v": _np.asarray(group["v"])[i:i + 1]}

        out = _data(rt).from_items(ROWS).groupby("k").map_groups(
            top1).take_all()
        return len(out), {g: r["v"] for g, r in _by_key(out).items()}

    _same(pkgs, scn, (3, {g: max(r["v"] for r in ROWS if r["k"] == g)
                          for g in "abc"}))


def test_unique(pkgs):
    def scn(rt):
        return sorted(_data(rt).from_items(ROWS).unique("k"))

    _same(pkgs, scn, ["a", "b", "c"])


def test_join_inner(pkgs):
    def scn(rt):
        rd = _data(rt)
        left = rd.from_items([{"id": i, "x": i * 1.0} for i in range(20)])
        right = rd.from_items([{"id": i, "y": i * 10} for i in range(10, 30)])
        return sorted(plain((r["id"], r["x"], r["y"]))
                      for r in left.join(right, on="id").take_all())

    _same(pkgs, scn, [(i, float(i), i * 10) for i in range(10, 20)])


def test_join_left_right_outer(pkgs):
    def scn(rt):
        rd = _data(rt)
        left = rd.from_items([{"id": i, "x": float(i)} for i in range(6)])
        right = rd.from_items([{"id": i, "y": i * 10} for i in range(3, 9)])
        lo = left.join(right, on="id", how="left").take_all()
        ro = left.join(right, on="id", how="right").take_all()
        oo = left.join(right, on="id", how="outer").take_all()
        return (len(lo), all(math.isnan(r["y"]) for r in lo if r["id"] < 3),
                len(ro), sorted(int(r["id"]) for r in ro),
                sorted(int(r["id"]) for r in oo))

    _same(pkgs, scn, (6, True, 6, [3, 4, 5, 6, 7, 8], list(range(9))))


def test_join_duplicate_keys_and_suffixes(pkgs):
    def scn(rt):
        rd = _data(rt)
        left = rd.from_items([{"id": 1, "v": 1.0}, {"id": 1, "v": 2.0}])
        right = rd.from_items([{"id": 1, "v": 10.0}, {"id": 1, "v": 20.0}])
        out = left.join(right, on="id", suffixes=("_l", "_r")).take_all()
        return len(out), {plain((r["v_l"], r["v_r"])) for r in out}

    _same(pkgs, scn, (4, {(1.0, 10.0), (1.0, 20.0), (2.0, 10.0),
                          (2.0, 20.0)}))


def test_join_mixed_key_dtypes(pkgs):
    """int64 keys on one side, float64 on the other must still co-locate."""
    def scn(rt):
        rd = _data(rt)
        left = rd.from_items([{"id": i, "x": i} for i in range(8)])
        right = rd.from_items([{"id": float(i), "y": i * 3} for i in range(8)])
        out = left.join(right, on="id").take_all()
        return len(out), all(r["y"] == int(r["id"]) * 3 for r in out)

    _same(pkgs, scn, (8, True))


def test_join_right_column_shadows_key(pkgs):
    """A right non-key column named like the left join key gets suffixed
    instead of overwriting the key output."""
    def scn(rt):
        rd = _data(rt)
        left = rd.from_items([{"id": i, "x": i} for i in range(4)])
        right = rd.from_items([{"rid": i, "id": i * 100} for i in range(4)])
        out = left.join(right, on="id", right_on="rid",
                        suffixes=("", "_r")).take_all()
        return sorted(plain((r["id"], r["id_r"])) for r in out)

    _same(pkgs, scn, [(i, i * 100) for i in range(4)])


def test_join_different_key_names(pkgs):
    def scn(rt):
        rd = _data(rt)
        left = rd.from_items([{"lid": i, "x": i} for i in range(5)])
        right = rd.from_items([{"rid": i, "y": i * 2} for i in range(5)])
        out = left.join(right, on="lid", right_on="rid").take_all()
        return sorted(plain((r["lid"], r["y"])) for r in out)

    _same(pkgs, scn, [(i, i * 2) for i in range(5)])
