"""The port's Data breadth against the JAX package's: parquet projection and
predicate pushdown, sharded-archive readers (TFRecord, WebDataset),
partitioned writes, SQL reads and the image pipeline onto the device.

Twins of tests/test_data_breadth.py, run on both packages and compared
(tests/torch_twins.py). The image pipeline's twin feeds the port's
``iter_device_batches(device="cpu")`` where the reference feeds
``iter_jax_batches``.
"""

from __future__ import annotations

import gc
import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from torch_twins import pair, plain, same, start_sessions, sub


def _data(rt):
    return sub(rt, "data")


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=2)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False)


@pytest.fixture(scope="module")
def pq_dir(tmp_path_factory):
    """Two files, multiple row groups each, columns id/val/tag."""
    d = tmp_path_factory.mktemp("pq")
    for f in range(2):
        ids = np.arange(f * 100, (f + 1) * 100)
        t = pa.table({"id": ids, "val": ids * 2,
                      "tag": ["even" if i % 2 == 0 else "odd" for i in ids]})
        pq.write_table(t, d / f"f{f}.parquet", row_group_size=25)
    return str(d)


# ----------------------------------------------------------- expressions


def test_parse_filter_grammar():
    def scn(rt):
        parse_filter = sub(rt, "data.expressions").parse_filter
        out = [parse_filter(e) for e in (
            "a > 3", "a >= 3 and b == 'x'", "3 < a", "tag in ('a', 'b')")]
        for bad in ("a > b", "f(x) > 1", "a > 1 or b > 2",
                    "__import__('os')", "a > 1 > 2"):
            with pytest.raises(ValueError):
                parse_filter(bad)
        return out

    pair(scn, [[("a", ">", 3)], [("a", ">=", 3), ("b", "==", "x")],
               [("a", ">", 3)], [("tag", "in", ("a", "b"))]])


def test_compile_predicate_mask():
    def scn(rt):
        m = sub(rt, "data.expressions").compile_predicate(
            "x >= 2 and tag != 'skip'")
        return m({"x": np.array([1, 2, 3]),
                  "tag": np.array(["a", "skip", "b"])}).tolist()

    pair(scn, [False, False, True])


# ------------------------------------------------- parquet pushdown rules


def test_projection_pushed_into_parquet_read(pkgs, pq_dir):
    def scn(rt):
        L = sub(rt, "data.logical")
        ds = _data(rt).read_parquet(pq_dir).select_columns(["id"])
        ops = L.optimize(ds._op.chain())
        rows = ds.take_all()
        return ([type(o).__name__ for o in ops], ops[0].datasource.columns,
                set(rows[0]), len(rows))

    _same(pkgs, scn, (["Read"], ["id"], {"id"}, 200))


def test_predicate_pushed_into_parquet_read(pkgs, pq_dir):
    def scn(rt):
        L = sub(rt, "data.logical")
        ds = _data(rt).read_parquet(pq_dir).filter(expr="id >= 150")
        ops = L.optimize(ds._op.chain())
        return ([type(o).__name__ for o in ops], ops[0].datasource.filters,
                ds.count(), "FilterExpr" in ds.stats().splitlines()[-1])

    _same(pkgs, scn, (["Read"], [("id", ">=", 150)], 50, False))


def test_read_parquet_filter_prunes_row_groups(pkgs, pq_dir):
    """The pushed filter reads strictly fewer rows than the files hold."""
    f = sorted(glob.glob(os.path.join(pq_dir, "*.parquet")))[0]
    assert pq.read_table(f, filters=[("id", ">=", 90)]).num_rows == 10

    def scn(rt):
        ds = _data(rt).read_parquet(pq_dir, filter="id >= 190")
        return sorted(int(r["id"]) for r in ds.take_all())

    _same(pkgs, scn, list(range(190, 200)))


def test_pushdown_not_applied_when_column_projected_away(pkgs, pq_dir):
    def scn(rt):
        L = sub(rt, "data.logical")
        ds = (_data(rt).read_parquet(pq_dir).select_columns(["val"])
              .filter(expr="id > 5"))
        ops = L.optimize(ds._op.chain())
        with pytest.raises(Exception) as ei:
            ds.take_all()
        return (any(isinstance(o, L.FilterExpr) for o in ops),
                type(ei.value).__name__)

    assert _same(pkgs, scn)[0]


def test_filter_expr_runs_as_stage_for_non_parquet(pkgs):
    def scn(rt):
        ds = _data(rt).from_items([{"x": i} for i in range(10)]).filter(
            expr="x >= 7")
        return sorted(int(r["x"]) for r in ds.take_all())

    _same(pkgs, scn, [7, 8, 9])


def test_filter_validates_args(pkgs):
    def scn(rt):
        ds = _data(rt).range(3)
        for kw in ({}, {"fn": lambda r: True, "expr": "x > 1"},
                   {"expr": "__import__('os').system('x') > 1"}):
            with pytest.raises(ValueError):
                ds.filter(**kw)
        return True

    _same(pkgs, scn, True)


def test_projection_stage_for_non_columnar_source(pkgs):
    def scn(rt):
        rows = _data(rt).from_items([{"a": 1, "b": 2}] * 4).select_columns(
            ["a"]).take_all()
        return [set(r) for r in rows]

    _same(pkgs, scn, [{"a"}] * 4)


def test_sibling_datasets_not_corrupted_by_pushdown(pkgs, pq_dir):
    def scn(rt):
        base = _data(rt).read_parquet(pq_dir)
        narrow = base.select_columns(["id"])
        return set(narrow.take(1)[0]), set(base.take(1)[0])

    _same(pkgs, scn, ({"id"}, {"id", "val", "tag"}))


# ------------------------------------------------------ tfrecord archives


def test_tfrecord_roundtrip(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        out = str(tmp_path / rt.__name__ / "tfr")
        rows = [{"label": i, "name": f"s{i}", "score": [0.5, float(i)]}
                for i in range(20)]
        files = rd.from_items(rows).write_tfrecords(out)
        back = rd.read_tfrecords(out).take_all()
        by_label = {int(r["label"]): r for r in back}
        return (bool(files), all(f.endswith(".tfrecord") for f in files),
                sorted(by_label), plain(by_label[3]["name"]),
                plain(by_label[3]["score"]))

    out = _same(pkgs, scn)
    assert out[:4] == (True, True, list(range(20)), b"s3")
    assert out[4] == pytest.approx([0.5, 3.0])


def test_tfrecord_crc_detects_corruption(tmp_path):
    def scn(rt):
        arch = sub(rt, "data.archive")
        p = str(tmp_path / f"{rt.__name__}.tfrecord")
        arch.write_tfrecord_file(p, [b"hello world"])
        blob = bytearray(open(p, "rb").read())
        blob[14] ^= 0xFF  # flip a payload byte
        open(p, "wb").write(bytes(blob))
        with pytest.raises(ValueError, match="crc") as ei:
            list(arch.iter_tfrecords(p))
        return str(ei.value).replace(p, "<path>")

    pair(scn)


def test_tfrecord_raw_and_callable_decode(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        p = str(tmp_path / f"{rt.__name__}.tfrecord")
        sub(rt, "data.archive").write_tfrecord_file(p, [b"a", b"bb"])
        raw = rd.read_tfrecords(p, decode=None).take_all()
        sized = rd.read_tfrecords(p, decode=lambda b: {"n": len(b)}).take_all()
        return [r["bytes"] for r in raw], sorted(int(r["n"]) for r in sized)

    _same(pkgs, scn, ([b"a", b"bb"], [1, 2]))


# ---------------------------------------------------- webdataset archives


def test_webdataset_roundtrip_and_grouping(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        out = str(tmp_path / rt.__name__ / "wds")
        rows = [{"__key__": f"{i:04d}", "npy": np.full((4, 4), i, np.uint8),
                 "cls": i, "txt": f"caption {i}"} for i in range(12)]
        files = rd.from_items(rows).write_webdataset(out)
        back = rd.read_webdataset(out).take_all()
        s = {r["__key__"]: r for r in back}["0007"]
        return (bool(files), all(f.endswith(".tar") for f in files),
                len(back), int(s["cls"]), s["txt"],
                np.array_equal(s["npy"], np.full((4, 4), 7, np.uint8)))

    _same(pkgs, scn, (True, True, 12, 7, "caption 7", True))


def test_webdataset_undecoded_bytes(pkgs, tmp_path):
    def scn(rt):
        rd = _data(rt)
        out = str(tmp_path / rt.__name__ / "w2")
        rd.from_items([{"__key__": "k0", "txt": "hi"}]).write_webdataset(out)
        return rd.read_webdataset(out, decode=False).take_all()[0]["txt"]

    _same(pkgs, scn, b"hi")


# ----------------------------------------------------- partitioned writes


def test_write_parquet_partitioned(pkgs, tmp_path):
    def scn(rt):
        rows = [{"split": "train" if i % 3 else "test", "id": i}
                for i in range(30)]
        out = str(tmp_path / rt.__name__ / "part")
        files = _data(rt).from_items(rows).write_parquet(
            out, partition_cols=["split"])
        t = pq.read_table(os.path.join(out, "split=test"))
        return (bool(files), os.path.isdir(os.path.join(out, "split=train")),
                os.path.isdir(os.path.join(out, "split=test")),
                set(t.column_names), sorted(t.column("id").to_pylist()))

    _same(pkgs, scn, (True, True, True, {"id"},
                      [i for i in range(30) if i % 3 == 0]))


# --------------------------------------------------------- image pipeline


def test_sharded_archive_image_pipeline_to_jax(pkgs, tmp_path):
    """Sharded archives → decode/normalize → the device iterator with
    prefetch: the JAX package's iter_jax_batches against the port's
    iter_device_batches on the CPU, batch for batch."""
    def scn(rt):
        rd = _data(rt)
        out = str(tmp_path / rt.__name__ / "imgs")
        rows = [{"__key__": f"{i:05d}",
                 "npy": (np.ones((8, 8, 3), np.uint8) * (i % 255)),
                 "cls": i % 10} for i in range(64)]
        shards = rd.from_items(rows).write_webdataset(out)

        def normalize(batch):
            import numpy as _np

            imgs = _np.stack(list(batch["npy"])).astype(_np.float32) / 255.0
            return {"image": imgs, "label": _np.asarray(batch["cls"])}

        ds = rd.read_webdataset(out).map_batches(normalize)
        if rt.__name__ == "ray_tpu_torch":
            it = ds.iter_device_batches(batch_size=16, prefetch=2,
                                        drop_last=True, device="cpu")
            batches = [{k: v.numpy() for k, v in b.items()} for b in it]
        else:
            it = ds.iter_jax_batches(batch_size=16, prefetch=2,
                                     drop_last=True)
            batches = [{k: np.asarray(v) for k, v in b.items()} for b in it]
        images = np.concatenate([b["image"] for b in batches])
        order = np.argsort(images.reshape(len(images), -1)[:, 0],
                           kind="stable")
        return (bool(shards), [b["image"].shape for b in batches],
                [str(b["image"].dtype) for b in batches],
                sum(b["label"].shape[0] for b in batches),
                images[order].tobytes())

    out = _same(pkgs, scn)
    assert out[1] == [(16, 8, 8, 3)] * 4 and set(out[2]) == {"float32"}
    assert out[3] == 64


def test_iter_torch_batches_writable(pkgs):
    """Tensors handed out must be writable (no UserWarning on read-only
    shm-backed arrays)."""
    def scn(rt):
        import warnings

        total = 0
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            for b in _data(rt).range(100).iter_torch_batches(batch_size=50):
                b["id"] += 1  # in-place mutation must be safe
                total += int(b["id"].sum())
        return total

    # warning filters are process-wide and catch_warnings is not
    # thread-safe: the sides run one after the other, and garbage earlier
    # tests left (a dead session's sockets) is collected first, so no
    # finalizer's ResourceWarning becomes an error inside the block
    gc.collect()
    same(pkgs, scn, sum(range(1, 101)), serve_cleanup=False,
         sequential=True)


# ------------------------------------------- review-found edge cases (r4)


def test_consecutive_projects_keep_error_semantics(pkgs):
    def scn(rt):
        rd = _data(rt)
        ds = (rd.from_items([{"a": 1, "b": 2}] * 3)
              .select_columns(["a"]).select_columns(["b"]))
        with pytest.raises(Exception) as ei:  # 'b' was already dropped
            ds.take_all()
        narrowing = (rd.from_items([{"a": 1, "b": 2}] * 3)
                     .select_columns(["a", "b"]).select_columns(["a"]))
        return type(ei.value).__name__, [set(r) for r in narrowing.take_all()]

    assert _same(pkgs, scn)[1] == [{"a"}] * 3


def test_webdataset_directory_keys_stay_distinct(pkgs, tmp_path):
    import io
    import tarfile

    p = tmp_path / "dirs.tar"
    with tarfile.open(p, "w") as tf:
        for d, v in (("train", 1), ("val", 2)):
            data = str(v).encode()
            info = tarfile.TarInfo(f"{d}/0001.cls")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))

    def scn(rt):
        rows = _data(rt).read_webdataset(str(p)).take_all()
        return len(rows), {r["__key__"]: int(r["cls"]) for r in rows}

    _same(pkgs, scn, (2, {"train/0001": 1, "val/0001": 2}))


def test_tfrecord_optional_features_pad_to_none(pkgs, tmp_path):
    def scn(rt):
        arch = sub(rt, "data.archive")
        p = str(tmp_path / f"{rt.__name__}_opt.tfrecord")
        arch.write_tfrecord_file(p, [arch.encode_example({"a": 1,
                                                          "extra": 2.5}),
                                     arch.encode_example({"a": 2})])
        by_a = {int(r["a"]): r for r in _data(rt).read_tfrecords(p).take_all()}
        return plain(by_a[1]["extra"]), by_a[2]["extra"]

    out = _same(pkgs, scn)
    assert out[0] == pytest.approx(2.5) and out[1] is None


def test_example_parser_accepts_unpacked_fields():
    import struct

    def varint(n):
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    def ld(field, payload):
        return varint(field << 3 | 2) + varint(len(payload)) + payload

    unpacked_ints = (varint(1 << 3 | 0) + varint(7) + varint(1 << 3 | 0)
                     + varint(9))
    unpacked_floats = (varint(1 << 3 | 5) + struct.pack("<f", 0.5)
                       + varint(1 << 3 | 5) + struct.pack("<f", 1.5))
    entries = (ld(1, ld(1, b"ints") + ld(2, ld(3, unpacked_ints)))
               + ld(1, ld(1, b"floats") + ld(2, ld(2, unpacked_floats))))
    rec = ld(1, entries)

    def scn(rt):
        row = sub(rt, "data.archive").parse_example(rec)
        return plain(row["ints"]), plain(row["floats"])

    out = pair(scn)
    assert out[0] == [7, 9] and out[1] == pytest.approx([0.5, 1.5])


def test_partition_values_sanitized(pkgs, tmp_path):
    def scn(rt):
        out = str(tmp_path / rt.__name__ / "sane")
        _data(rt).from_items([{"tag": "a/b", "id": 1},
                              {"tag": None, "id": 2}]).write_parquet(
            out, partition_cols=["tag"])
        return sorted(os.listdir(out))

    dirs = _same(pkgs, scn)
    assert "tag=a%2Fb" in dirs and "tag=__HIVE_DEFAULT_PARTITION__" in dirs


# ------------------------------------------------------------ sql reads


def test_read_sql_roundtrip(pkgs, tmp_path):
    import sqlite3

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE metrics (id INTEGER, name TEXT, v REAL)")
    conn.executemany("INSERT INTO metrics VALUES (?, ?, ?)",
                     [(i, f"m{i}", i * 0.5) for i in range(50)])
    conn.commit()
    conn.close()

    def scn(rt):
        import sqlite3 as _sqlite3

        rd = _data(rt)
        factory = lambda: _sqlite3.connect(db)  # noqa: E731
        rows = rd.read_sql("SELECT * FROM metrics WHERE id >= ? ORDER BY id",
                           factory, params=(10,)).take_all()
        ds4 = rd.read_sql("SELECT * FROM metrics ORDER BY id", factory,
                          parallelism=4)
        empty = rd.read_sql("SELECT * FROM metrics WHERE id > 999",
                            factory, parallelism=4).take_all()
        return (len(rows), plain(rows[0]),
                sorted(int(r["id"]) for r in ds4.take_all()), empty)

    _same(pkgs, scn, (40, {"id": 10, "name": "m10", "v": 5.0},
                      list(range(50)), []))
