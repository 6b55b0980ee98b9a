"""The port's Avro, Arrow IPC, Delta Lake and Iceberg datasources against
the JAX package's.

Twins of tests/test_data_lakehouse.py, run on both packages and compared
(tests/torch_twins.py). Each side writes its own copy of a table; a table
the test builds by hand is built once and read by both.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pandas  # noqa: F401 — loaded before the twins' threads import it
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from torch_twins import pair, plain, same, start_sessions, sub


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=2)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False)


def _data(rt):
    return sub(rt, "data")


def _avro(rt):
    return sub(rt, "data.avro")


# ---------------------------------------------------------------- avro


def test_avro_roundtrip_via_dataset(pkgs, tmp_path):
    rows = [{"id": i, "name": f"r{i}", "score": i * 0.5,
             "flag": i % 2 == 0, "payload": bytes([i])} for i in range(50)]

    def scn(rt):
        rd = _data(rt)
        out = str(tmp_path / rt.__name__)
        files = rd.from_items(rows).write_avro(out)
        back = sorted(rd.read_avro(out).take_all(), key=lambda r: r["id"])
        return (bool(files), all(f.endswith(".avro") for f in files),
                len(back), plain(back[3]))

    _same(pkgs, scn, (True, True, 50, rows[3]))


def test_avro_codecs_and_schema(tmp_path):
    rows = [{"a": -(2 ** 40), "b": [1.5, 2.5], "c": None}]

    def scn(rt):
        out = []
        for codec in ("null", "deflate"):
            p = str(tmp_path / f"{rt.__name__}_{codec}.avro")
            _avro(rt).write_avro_file(p, rows, codec=codec)
            got, meta = _avro(rt).read_avro_file(p)
            out.append((got, meta["avro.codec"].decode()))
        return out

    pair(scn, [(rows, "null"), (rows, "deflate")])


def test_zip_positional_columns(pkgs):
    def scn(rt):
        rd = _data(rt)
        a = rd.range(6)
        b = rd.range(6).map(lambda r: {"sq": int(r["id"]) ** 2, "id": -1})
        z = sorted(a.zip(b).take_all(), key=lambda r: r["id"])
        with pytest.raises(ValueError, match="equal-length"):
            rd.range(3).zip(rd.range(5)).take_all()
        return plain(z[3])

    _same(pkgs, scn, {"id": 3, "sq": 9, "id_1": -1})


def test_to_pandas_to_arrow(pkgs):
    def scn(rt):
        rd = _data(rt)
        ds = rd.range(10).map(lambda r: {"id": r["id"],
                                         "x": float(r["id"]) * 2})
        df = ds.to_pandas()
        return (len(df), sorted(df["x"]), rd.range(5).to_arrow().num_rows,
                rd.from_items([]).to_pandas().empty)

    _same(pkgs, scn, (10, [i * 2.0 for i in range(10)], 5, True))


def test_arrow_ipc_roundtrip(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        out = str(tmp_path / rt.__name__)
        ds = rd.range(100).map(lambda r: {"id": r["id"],
                                          "sq": int(r["id"]) ** 2})
        files = ds.write_arrow(out)
        return bool(files), sorted(int(r["sq"]) for r in
                                   rd.read_arrow(out).take_all())

    _same(pkgs, scn, (True, [i * i for i in range(100)]))


# ---------------------------------------------------------------- delta


def test_delta_create_append_overwrite(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        table = str(tmp_path / rt.__name__ / "t")
        rd.from_items([{"x": i, "y": float(i)} for i in range(10)]) \
            .write_delta(table)
        first = (os.path.exists(os.path.join(table, "_delta_log",
                                             f"{0:020d}.json")),
                 sorted(int(r["x"]) for r in rd.read_delta(table).take_all()))
        rd.from_items([{"x": i, "y": float(i)} for i in range(10, 15)]) \
            .write_delta(table, mode="append")
        appended = sorted(int(r["x"]) for r in rd.read_delta(table).take_all())
        rd.from_items([{"x": 99, "y": 9.9}]).write_delta(table,
                                                         mode="overwrite")
        return first, appended, [int(r["x"]) for r in
                                 rd.read_delta(table).take_all()]

    _same(pkgs, scn, ((True, list(range(10))), list(range(15)), [99]))


def test_delta_partitioned_write_and_partition_filter(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        table = str(tmp_path / rt.__name__ / "pt")
        rd.from_items([{"k": i % 3, "v": i} for i in range(30)]).write_delta(
            table, partition_cols=["k"])
        log = os.path.join(table, "_delta_log", f"{0:020d}.json")
        adds = [json.loads(ln)["add"] for ln in open(log) if '"add"' in ln]
        got = rd.read_delta(table, filter="k == 1").take_all()
        got_v = rd.read_delta(table, columns=["v"]).take_all()
        return ({a["partitionValues"]["k"] for a in adds}, len(got),
                all(r["k"] == 1 for r in got), "k" not in got_v[0],
                len(got_v))

    _same(pkgs, scn, ({"0", "1", "2"}, 10, True, True, 30))


def test_delta_partitioned_append_preserves_data(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        table = str(tmp_path / rt.__name__ / "pa")
        rd.from_items([{"k": i % 2, "v": i} for i in range(10)]) \
            .write_delta(table, partition_cols=["k"])
        rd.from_items([{"k": i % 2, "v": 100 + i} for i in range(4)]) \
            .write_delta(table, mode="append", partition_cols=["k"])
        return sorted(int(r["v"]) for r in rd.read_delta(table).take_all())

    _same(pkgs, scn, sorted(list(range(10)) + [100, 101, 102, 103]))


def test_delta_partition_in_filter(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        table = str(tmp_path / rt.__name__ / "pin")
        rd.from_items([{"k": i % 3, "v": i} for i in range(12)]) \
            .write_delta(table, partition_cols=["k"])
        got = rd.read_delta(table, filter=[("k", "in", [0, 2])]).take_all()
        return sorted({int(r["k"]) for r in got}), len(got)

    _same(pkgs, scn, ([0, 2], 8))


def test_avro_mixed_and_ragged_rows(tmp_path):
    def scn(rt):
        A = _avro(rt)
        p = str(tmp_path / f"{rt.__name__}_mix.avro")
        A.write_avro_file(p, [{"a": 1}, {"a": 2.5}])
        got, _ = A.read_avro_file(p)
        p2 = str(tmp_path / f"{rt.__name__}_ragged.avro")
        A.write_avro_file(p2, [{"a": 1}, {"a": 2, "b": 9}])
        got2, _ = A.read_avro_file(p2)
        with pytest.raises(TypeError, match="incompatible"):
            A.write_avro_file(str(tmp_path / f"{rt.__name__}_bad.avro"),
                              [{"a": 1}, {"a": "text"}])
        return got, got2

    pair(scn, ([{"a": 1.0}, {"a": 2.5}],
               [{"a": 1, "b": None}, {"a": 2, "b": 9}]))


def test_delta_checkpoint_replay(pkgs, tmp_path):
    """A parquet checkpoint + later JSON commits replay correctly."""
    def scn(rt):
        rd = _data(rt)
        table = str(tmp_path / rt.__name__ / "ck")
        rd.from_items([{"x": 1}]).write_delta(table)              # v0
        rd.from_items([{"x": 2}]).write_delta(table)              # v1
        adds, meta = sub(rt, "data.lakehouse")._replay_delta_log(table)
        log = os.path.join(table, "_delta_log")
        ck_rows = [{"add": {**a, "partitionValues": None}, "metaData": None}
                   for a in adds]
        ck_rows.append({"add": None, "metaData": {
            **meta, "format": None, "configuration": None}})
        pq.write_table(pa.Table.from_pylist(ck_rows),
                       os.path.join(log, f"{1:020d}.checkpoint.parquet"))
        with open(os.path.join(log, "_last_checkpoint"), "w") as f:
            json.dump({"version": 1, "size": len(ck_rows)}, f)
        os.unlink(os.path.join(log, f"{0:020d}.json"))
        os.unlink(os.path.join(log, f"{1:020d}.json"))
        rd.from_items([{"x": 3}]).write_delta(table)              # v2 json
        return sorted(int(r["x"]) for r in rd.read_delta(table).take_all())

    _same(pkgs, scn, [1, 2, 3])


# -------------------------------------------------------------- iceberg


def _build_iceberg_table(root: str, write_avro_file) -> str:
    """A minimal Iceberg v1 table: parquet data files, avro manifest +
    manifest list, metadata.json with two snapshots."""
    table = os.path.join(root, "ice")
    os.makedirs(os.path.join(table, "data"), exist_ok=True)
    os.makedirs(os.path.join(table, "metadata"), exist_ok=True)
    for i, lo in enumerate((0, 50)):
        pq.write_table(pa.table({"id": np.arange(lo, lo + 50),
                                 "val": np.arange(lo, lo + 50) * 2.0}),
                       os.path.join(table, "data", f"d{i}.parquet"))
    # an orphan data file referenced only by a DELETED manifest entry
    pq.write_table(pa.table({"id": np.asarray([999]),
                             "val": np.asarray([0.0])}),
                   os.path.join(table, "data", "dead.parquet"))
    manifest_schema = {
        "type": "record", "name": "manifest_entry", "fields": [
            {"name": "status", "type": "int"},
            {"name": "data_file", "type": {
                "type": "record", "name": "r2", "fields": [
                    {"name": "file_path", "type": "string"},
                    {"name": "file_format", "type": "string"},
                    {"name": "record_count", "type": "long"},
                ]}},
        ]}
    entries = [
        {"status": 1, "data_file": {
            "file_path": f"file://{table}/data/d0.parquet",
            "file_format": "PARQUET", "record_count": 50}},
        {"status": 1, "data_file": {
            "file_path": os.path.join(table, "data", "d1.parquet"),
            "file_format": "PARQUET", "record_count": 50}},
        {"status": 2, "data_file": {          # DELETED: must be skipped
            "file_path": os.path.join(table, "data", "dead.parquet"),
            "file_format": "PARQUET", "record_count": 1}},
    ]
    mpath = os.path.join(table, "metadata", "m1.avro")
    write_avro_file(mpath, entries, manifest_schema)
    mlist_schema = {
        "type": "record", "name": "manifest_file", "fields": [
            {"name": "manifest_path", "type": "string"},
            {"name": "manifest_length", "type": "long"},
        ]}
    mlpath = os.path.join(table, "metadata", "snap-2.avro")
    write_avro_file(mlpath, [{"manifest_path": mpath,
                              "manifest_length": os.path.getsize(mpath)}],
                    mlist_schema)
    m0 = os.path.join(table, "metadata", "m0.avro")
    write_avro_file(m0, entries[:1], manifest_schema)
    ml0 = os.path.join(table, "metadata", "snap-1.avro")
    write_avro_file(ml0, [{"manifest_path": m0,
                           "manifest_length": os.path.getsize(m0)}],
                    mlist_schema)
    meta = {"format-version": 1, "current-snapshot-id": 2,
            "snapshots": [{"snapshot-id": 1, "manifest-list": ml0},
                          {"snapshot-id": 2, "manifest-list": mlpath}]}
    with open(os.path.join(table, "metadata", "v1.metadata.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(table, "metadata", "version-hint.text"), "w") as f:
        f.write("1")
    return table


def _iceberg(rt, tmp_path):
    """Each package writes the table's avro files with its own writer."""
    root = tmp_path / rt.__name__
    root.mkdir(exist_ok=True)
    return _build_iceberg_table(str(root), _avro(rt).write_avro_file)


def test_iceberg_read(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        table = _iceberg(rt, tmp_path)
        got = sorted(int(r["id"]) for r in rd.read_iceberg(table).take_all())
        vals = rd.read_iceberg(table, columns=["val"],
                               filter="val >= 100").take_all()
        return (got, all(set(r) == {"val"} for r in vals),
                sorted(float(r["val"]) for r in vals))

    _same(pkgs, scn, (list(range(100)), True,
                      [float(v) for v in range(100, 200, 2)]))


def test_iceberg_snapshot_time_travel(pkgs, tmp_path):
    def scn(rt):
        table = _iceberg(rt, tmp_path)
        old = _data(rt).read_iceberg(table, snapshot_id=1)
        return sorted(int(r["id"]) for r in old.take_all())

    _same(pkgs, scn, list(range(50)))
