"""Datasources and sinks: pluggable readers/writers producing ReadTasks.

(reference: python/ray/data/read_api.py + _internal/datasource/* — each
datasource yields ReadTasks, one per file/fragment, executed as remote tasks
by the streaming executor.)
"""

from __future__ import annotations

import glob as _glob
import os
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from ray_tpu_torch.data.block import Block, rows_to_block


@dataclass
class ReadTask:
    """A zero-arg callable returning a list of blocks, plus size metadata."""

    fn: Callable[[], list]
    num_rows: int | None = None
    input_files: list = field(default_factory=list)

    def __call__(self) -> list:
        return self.fn()


class Datasource:
    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError


def round_robin(items: list, parallelism: int) -> list[list]:
    """Split `items` into ≤parallelism non-empty groups, round-robin — the
    shared grouping for every per-file/per-fragment datasource."""
    if not items:
        return []
    groups: list[list] = [[] for _ in
                          range(max(1, min(parallelism, len(items))))]
    for i, it in enumerate(items):
        groups[i % len(groups)].append(it)
    return [g for g in groups if g]


class RangeDatasource(Datasource):
    """(reference: read_api.py range():245)"""

    def __init__(self, n: int, *, column: str = "id"):
        self.n = n
        self.column = column

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if self.n == 0:
            return []  # empty range: no read tasks (step would be 0)
        parallelism = max(1, min(parallelism, self.n))
        step = (self.n + parallelism - 1) // parallelism
        tasks = []
        for start in range(0, self.n, step):
            end = min(start + step, self.n)
            col = self.column

            def fn(start=start, end=end):
                return [{col: np.arange(start, end)}]

            tasks.append(ReadTask(fn, num_rows=end - start))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: list):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        n = len(self.items)
        if n == 0:
            return []  # empty dataset: no read tasks (step would be 0)
        parallelism = max(1, min(parallelism, n))
        step = (n + parallelism - 1) // parallelism
        tasks = []
        for start in range(0, n, step):
            chunk = self.items[start:start + step]

            def fn(chunk=chunk):
                return [rows_to_block(chunk)]

            tasks.append(ReadTask(fn, num_rows=len(chunk)))
        return tasks


def _expand_paths(paths, suffixes: tuple[str, ...]) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for suf in suffixes:
                out.extend(sorted(_glob.glob(os.path.join(p, f"*{suf}"))))
        elif _glob.has_magic(p):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def _read_with_retries(reader: Callable, path: str) -> list:
    """One file read with bounded transient-IO retries (jittered backoff).

    Runs INSIDE the read task, so a flaky filesystem degrades to latency
    instead of failing the block; the executor's per-block retry above it
    only sees errors that survived this budget. A persistent failure
    carries per-file attribution (the path and attempt count), and
    `FileNotFoundError` is never retried — a missing file will not
    reappear."""
    import random as _random
    import time as _time

    from ray_tpu_torch._private.ray_config import RayConfig

    cfg = RayConfig.instance()
    retries = cfg.data_read_retries if cfg.data_fault_tolerance else 0
    base = cfg.data_read_retry_backoff_s
    attempt = 0
    while True:
        try:
            return reader(path)
        except FileNotFoundError:
            raise
        except OSError as exc:
            if attempt >= retries:
                # re-raise as the SAME subclass: upstream handlers dispatch
                # on the OSError subtype (PermissionError vs ConnectionError
                # vs ...), which a bare OSError wrapper would collapse
                msg = (f"read of {path!r} failed after {attempt + 1} "
                       f"attempt(s): {exc}")
                try:
                    wrapped = type(exc)(msg)
                except Exception:
                    wrapped = OSError(msg)  # exotic constructor signature
                raise wrapped from exc
            _time.sleep(_random.uniform(
                0.0, min(base * (2 ** attempt), base * 8.0)))
            attempt += 1


class FileDatasource(Datasource):
    suffixes: tuple[str, ...] = ()

    def __init__(self, paths):
        self.paths = _expand_paths(paths, self.suffixes)

    def read_file(self, path: str) -> list:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        tasks = []
        for grp in round_robin(self.paths, parallelism):

            def fn(grp=grp, reader=self.read_file):
                blocks = []
                for path in grp:
                    blocks.extend(_read_with_retries(reader, path))
                return blocks

            tasks.append(ReadTask(fn, input_files=grp))
        return tasks


class ParquetDatasource(FileDatasource):
    """Columnar reads with projection (column pruning) and predicate
    pushdown: `columns` prunes at the IO layer, `filters` (pyarrow DNF
    conjunction, e.g. [("x", ">", 3)]) prunes whole row groups via their
    min/max statistics before any decode (reference:
    data/_internal/datasource/parquet_datasource.py)."""

    suffixes = (".parquet",)
    supports_projection = True
    supports_predicates = True

    def __init__(self, paths, columns=None, filters=None):
        super().__init__(paths)
        self.columns = list(columns) if columns else None
        self.filters = list(filters) if filters else None

    def read_file(self, path: str) -> list:
        import pyarrow.parquet as pq

        table = pq.read_table(path, columns=self.columns,
                              filters=self.filters)
        from ray_tpu_torch.data.block import normalize_block

        return [normalize_block(table)]


class CSVDatasource(FileDatasource):
    suffixes = (".csv",)

    def read_file(self, path: str) -> list:
        import pyarrow.csv as pacsv

        from ray_tpu_torch.data.block import normalize_block

        return [normalize_block(pacsv.read_csv(path))]


class JSONDatasource(FileDatasource):
    suffixes = (".json", ".jsonl")

    def read_file(self, path: str) -> list:
        import json

        rows = []
        with open(path) as f:
            text = f.read().strip()
        if text.startswith("["):
            rows = json.loads(text)
        else:
            for line in text.splitlines():
                if line.strip():
                    rows.append(json.loads(line))
        return [rows_to_block(rows)]


class NumpyDatasource(FileDatasource):
    suffixes = (".npy",)

    def read_file(self, path: str) -> list:
        return [{"data": np.load(path)}]


class TextDatasource(FileDatasource):
    """One row per line: {"text": line} (reference: read_api.py read_text)."""

    suffixes = (".txt", ".text", ".log", ".md")

    def __init__(self, paths, *, drop_empty_lines: bool = True,
                 encoding: str = "utf-8"):
        super().__init__(paths)
        self.drop_empty = drop_empty_lines
        self.encoding = encoding

    def read_file(self, path: str) -> list:
        with open(path, encoding=self.encoding, errors="replace") as f:
            lines = f.read().splitlines()
        if self.drop_empty:
            lines = [ln for ln in lines if ln.strip()]
        return [{"text": lines}] if lines else []


class BinaryDatasource(FileDatasource):
    suffixes = ()

    def read_file(self, path: str) -> list:
        with open(path, "rb") as f:
            return [{"bytes": [f.read()], "path": [path]}]


class ImageDatasource(FileDatasource):
    """Decoded image files → {"image": HWC uint8 array, "path"} rows.
    (reference: read_api.py read_images:1048)"""

    suffixes = (".png", ".jpg", ".jpeg", ".bmp")

    def __init__(self, paths, size: tuple[int, int] | None = None):
        super().__init__(paths)
        self.size = size

    def read_file(self, path: str) -> list:
        try:
            from PIL import Image
        except ImportError as e:  # pillow is optional in this image
            raise ImportError("read_images requires pillow") from e

        img = Image.open(path).convert("RGB")
        if self.size is not None:
            img = img.resize(self.size)
        arr = np.asarray(img)
        return [{"image": arr[None, ...], "path": [path]}]


class AvroDatasource(FileDatasource):
    """Avro object container files → rows, via the dependency-free codec in
    data/avro.py (reference: read_api.py read_avro — fastavro-backed there)."""

    suffixes = (".avro",)

    def read_file(self, path: str) -> list:
        from ray_tpu_torch.data.avro import read_avro_file
        from ray_tpu_torch.data.block import rows_to_block

        records, _ = read_avro_file(path)
        return [rows_to_block(records)] if records else []


class ArrowDatasource(FileDatasource):
    """Arrow IPC / Feather V2 files (reference capability: Dataset
    round-trips through Arrow; file-level IPC reads are the natural host
    interchange for zero-copy numpy columns)."""

    suffixes = (".arrow", ".feather", ".ipc")

    def read_file(self, path: str) -> list:
        import pyarrow as pa

        from ray_tpu_torch.data.block import normalize_block

        with pa.memory_map(path) as src:
            try:
                table = pa.ipc.open_file(src).read_all()
            except pa.ArrowInvalid:
                src.seek(0)
                table = pa.ipc.open_stream(src).read_all()
        return [normalize_block(table)]


class AudioDatasource(FileDatasource):
    """Audio files → {"amplitude": (channels, samples) float32 in [-1, 1],
    "sample_rate", "path"} rows, matching the reference's row shape
    (_internal/datasource/audio_datasource.py: soundfile always_2d read
    transposed to channels-first). WAV/AIFF/AU decode here dependency-free
    via the stdlib (soundfile is absent from this image); other containers
    raise with a clear message instead of importing a missing backend."""

    suffixes = (".wav", ".wave", ".aiff", ".aif", ".au")

    def read_file(self, path: str) -> list:
        ext = os.path.splitext(path)[1].lower()
        if ext in (".wav", ".wave"):
            sr, amp = _decode_wav(path)
        elif ext in (".aiff", ".aif"):
            sr, amp = _decode_aiff(path)
        else:
            sr, amp = _decode_au(path)
        return [{"amplitude": amp[None, ...], "sample_rate": [sr],
                 "path": [path]}]


def _pcm_to_float(raw: bytes, sampwidth: int, nchannels: int,
                  big_endian: bool = False,
                  signed8: bool = False) -> np.ndarray:
    """Interleaved integer PCM → (channels, samples) float32 in [-1, 1].

    8-bit convention differs by container: WAV stores unsigned bytes
    (recentred here), AIFF/AU store signed (signed8=True)."""
    order = ">" if big_endian else "<"
    if sampwidth == 1:
        if signed8:
            x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
        else:
            x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
    elif sampwidth == 2:
        x = np.frombuffer(raw, dtype=f"{order}i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        if big_endian:
            b = b[:, ::-1]
        x = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
        x /= float(1 << 23)
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype=f"{order}i4").astype(np.float32)
        x /= float(1 << 31)
    else:
        raise ValueError(f"unsupported PCM sample width {sampwidth}")
    if nchannels > 1:
        x = x.reshape(-1, nchannels).T
    else:
        x = x[None, :]
    return np.ascontiguousarray(x)


def _decode_wav(path: str):
    import wave

    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
        amp = _pcm_to_float(raw, w.getsampwidth(), w.getnchannels())
        return w.getframerate(), amp


def _decode_aiff(path: str):
    try:
        import aifc
    except ImportError as e:  # removed in Python 3.13 (PEP 594)
        raise ValueError(
            f"cannot decode {path!r}: the stdlib 'aifc' module is gone on "
            "this interpreter (PEP 594); convert to WAV or install an "
            "audio backend") from e

    with aifc.open(path, "rb") as a:
        raw = a.readframes(a.getnframes())
        amp = _pcm_to_float(raw, a.getsampwidth(), a.getnchannels(),
                            big_endian=True, signed8=True)
        return int(a.getframerate()), amp


def _decode_au(path: str):
    try:
        import sunau
    except ImportError as e:  # removed in Python 3.13 (PEP 594)
        raise ValueError(
            f"cannot decode {path!r}: the stdlib 'sunau' module is gone on "
            "this interpreter (PEP 594); convert to WAV or install an "
            "audio backend") from e

    with sunau.open(path, "rb") as a:
        raw = a.readframes(a.getnframes())
        amp = _pcm_to_float(raw, a.getsampwidth(), a.getnchannels(),
                            big_endian=True, signed8=True)
        return int(a.getframerate()), amp


class VideoDatasource(FileDatasource):
    """Video files → one row per decoded frame: {"frame": HWC uint8 RGB,
    "frame_index", "path"} (+ "frame_timestamp" seconds when requested),
    matching the reference's row shape
    (_internal/datasource/video_datasource.py — decord there; OpenCV is
    the decoder available in this image). ``frame_step=k`` keeps every
    k-th frame so long clips can subsample at the IO layer."""

    suffixes = (".mp4", ".mkv", ".mov", ".avi", ".webm", ".m4v", ".mpeg",
                ".mpg")

    def __init__(self, paths, *, include_timestamps: bool = False,
                 frame_step: int = 1, frames_per_block: int = 64):
        super().__init__(paths)
        self.include_timestamps = include_timestamps
        self.frame_step = max(1, int(frame_step))
        self.frames_per_block = max(1, int(frames_per_block))

    def read_file(self, path: str) -> list:
        try:
            import cv2
        except ImportError as e:
            raise ImportError("read_videos requires opencv (cv2)") from e

        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise ValueError(f"could not open video {path!r}")
        blocks: list = []
        frames, idxs, stamps = [], [], []

        def flush():
            if not frames:
                return
            block = {"frame": np.stack(frames),
                     "frame_index": np.asarray(idxs),
                     "path": [path] * len(frames)}
            if self.include_timestamps:
                block["frame_timestamp"] = np.asarray(stamps)
            blocks.append(block)
            frames.clear(); idxs.clear(); stamps.clear()

        i = 0
        try:
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                if i % self.frame_step == 0:
                    if self.include_timestamps:
                        stamps.append(cap.get(cv2.CAP_PROP_POS_MSEC) / 1e3)
                    frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
                    idxs.append(i)
                    # bound resident uncompressed frames: a long clip must
                    # stream out as multiple blocks, not one giant stack
                    if len(frames) >= self.frames_per_block:
                        flush()
                i += 1
        finally:
            cap.release()
        flush()
        return blocks


class HudiDatasource(Datasource):
    """Apache Hudi copy-on-write SNAPSHOT reads, dependency-free
    (reference: _internal/datasource/hudi_datasource.py — hudi-python
    there, absent from this image, so the table protocol is implemented
    directly like data/lakehouse.py does for Delta/Iceberg).

    Protocol: ``.hoodie/`` holds the commit timeline — ``<ts>.commit``
    JSON files (completed commits only; ``.inflight``/``.requested`` are
    pending) whose ``partitionToWriteStats`` lists the parquet base file
    each write produced per file group. A snapshot is, per file group
    (fileId), the base file of the LATEST completed commit ≤ the
    requested instant. Columns/filters push down into the parquet reads."""

    def __init__(self, table_uri: str, *, columns=None, filters=None,
                 as_of: str | None = None):
        self.table_uri = table_uri
        self.columns = list(columns) if columns else None
        self.filters = list(filters) if filters else None
        self.as_of = as_of  # instant ts string: time-travel cutoff

    def _snapshot_files(self) -> list[str]:
        import json

        tl_dir = os.path.join(self.table_uri, ".hoodie")
        if not os.path.isdir(tl_dir):
            raise FileNotFoundError(
                f"not a Hudi table (no .hoodie timeline): {self.table_uri!r}")
        instants = sorted(
            f for f in os.listdir(tl_dir)
            if f.endswith(".commit") or f.endswith(".replacecommit"))
        latest: dict[str, tuple[str, str]] = {}  # fileId → (ts, relpath)
        for fname in instants:
            ts = fname.split(".")[0]
            if self.as_of is not None and ts > self.as_of:
                continue
            with open(os.path.join(tl_dir, fname)) as f:
                meta = json.load(f)
            # clustering / insert_overwrite (replacecommit): the replaced
            # file groups leave the snapshot entirely — without this, their
            # rows would appear alongside the rewritten copies
            for fids in (meta.get("partitionToReplaceFileIds") or {}).values():
                for fid in fids:
                    latest.pop(fid, None)
            for stats in (meta.get("partitionToWriteStats") or {}).values():
                for st in stats:
                    fid, rel = st.get("fileId"), st.get("path")
                    if fid and rel and ts >= latest.get(fid, ("",))[0]:
                        latest[fid] = (ts, rel)
        return [os.path.join(self.table_uri, rel)
                for _, rel in sorted(latest.values())]

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        files = self._snapshot_files()
        if not files:
            return []
        inner = ParquetDatasource(files, columns=self.columns,
                                  filters=self.filters)
        return inner.get_read_tasks(parallelism)


class LanceDatasource(Datasource):
    """Lance dataset reads, one ReadTask per fragment, with column
    projection and filter pushdown into the scanner (reference:
    _internal/datasource/lance_datasource.py:19). The ``lance`` package is
    not in this image and the columnar format has no offline spec to
    reimplement, so this connector is import-gated exactly like the
    reference (``_check_import``); it activates unchanged where pylance
    is installed."""

    def __init__(self, uri: str, *, columns=None, filter: str | None = None,
                 scanner_options: dict | None = None):
        try:
            import lance  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "read_lance requires the 'lance' package (pylance), which "
                "is not available in this environment") from e
        self.uri = uri
        self.scanner_options = dict(scanner_options or {})
        if columns is not None:
            self.scanner_options["columns"] = list(columns)
        if filter is not None:
            self.scanner_options["filter"] = filter

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        import lance

        from ray_tpu_torch.data.block import normalize_block

        ds = lance.dataset(uri=self.uri)
        fragment_ids = [f.fragment_id for f in ds.get_fragments()]
        tasks = []
        for grp in round_robin(fragment_ids, parallelism):

            def fn(grp=grp, uri=self.uri, opts=self.scanner_options):
                import lance as _lance

                d = _lance.dataset(uri=uri)
                frags = [f for f in d.get_fragments()
                         if f.fragment_id in grp]
                table = d.scanner(fragments=frags, **opts).to_table()
                return [normalize_block(table)]

            tasks.append(ReadTask(fn))
        return tasks


# --------------------------------------------------------------------- writes


def write_parquet_block(block: Block, path: str, index: int) -> str:
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.parquet")
    pq.write_table(BlockAccessor(block).to_arrow(), out)
    return out


def write_csv_block(block: Block, path: str, index: int) -> str:
    import pyarrow.csv as pacsv

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.csv")
    pacsv.write_csv(BlockAccessor(block).to_arrow(), out)
    return out


def write_json_block(block: Block, path: str, index: int) -> str:
    import json

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.jsonl")
    with open(out, "w") as f:
        for row in BlockAccessor(block).iter_rows():
            f.write(json.dumps({k: _json_safe(v) for k, v in row.items()}) + "\n")
    return out


def write_avro_block(block: Block, path: str, index: int) -> str:
    from ray_tpu_torch.data.avro import write_avro_file
    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.avro")
    write_avro_file(out, list(BlockAccessor(block).iter_rows()))
    return out


def write_arrow_block(block: Block, path: str, index: int) -> str:
    import pyarrow as pa

    from ray_tpu_torch.data.block import BlockAccessor

    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, f"part-{index:05d}.arrow")
    table = BlockAccessor(block).to_arrow()
    with pa.OSFile(out, "wb") as sink:
        with pa.ipc.new_file(sink, table.schema) as writer:
            writer.write_table(table)
    return out


def write_parquet_partitioned(block: Block, path: str, index: int,
                              partition_cols: list[str]) -> list[str]:
    """Hive-style partitioned write: rows fan out to
    `col1=val1/col2=val2/part-<index>.parquet`, partition columns dropped
    from the files (they're encoded in the directory names — reference:
    Dataset.write_parquet(partition_cols=...))."""
    import pyarrow.parquet as pq

    from ray_tpu_torch.data.block import BlockAccessor, rows_to_block

    groups: dict[tuple, list] = {}
    for row in BlockAccessor(block).iter_rows():
        key = tuple(row[c] for c in partition_cols)
        groups.setdefault(key, []).append(
            {k: v for k, v in row.items() if k not in partition_cols})
    out: list[str] = []
    for key, rows in groups.items():
        sub = os.path.join(path, *(
            f"{c}={_part_str(v)}" for c, v in zip(partition_cols, key)))
        os.makedirs(sub, exist_ok=True)
        f = os.path.join(sub, f"part-{index:05d}.parquet")
        pq.write_table(BlockAccessor(rows_to_block(rows)).to_arrow(), f)
        out.append(f)
    return out


def _part_str(v: Any) -> str:
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        return "__HIVE_DEFAULT_PARTITION__"  # hive's null sentinel
    from urllib.parse import quote

    # url-encode separators so values like "a/b" or "x=y" stay one
    # directory component a hive-aware reader parses back losslessly
    return quote(str(v), safe="")


def _json_safe(v: Any):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


class SQLDatasource(Datasource):
    """Rows from any DBAPI-2.0 connection (reference:
    data/_internal/datasource/sql_datasource.py — a connection FACTORY plus
    a query; partitions read disjoint row ranges via OFFSET/LIMIT when a
    parallelism > 1 is requested and the dialect supports it)."""

    def __init__(self, sql: str, connection_factory: Callable,
                 *, params: tuple = ()):
        self.sql = sql
        self.connection_factory = connection_factory
        self.params = tuple(params)

    def _read(self, suffix: str = "", extra: tuple = ()) -> list:
        conn = self.connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(self.sql + suffix, self.params + extra)
            cols = [d[0] for d in cur.description]
            rows = [dict(zip(cols, r)) for r in cur.fetchall()]
        finally:
            conn.close()
        return rows

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if parallelism <= 1:
            return [ReadTask(lambda: [rows_to_block(r)]
                             if (r := self._read()) else [])]
        # count once, then hand each task a disjoint OFFSET/LIMIT window —
        # the reference's sharded-read strategy for partitionable dialects
        conn = self.connection_factory()
        try:
            cur = conn.cursor()
            # the derived-table alias is REQUIRED by postgres/mysql and
            # harmless on sqlite
            cur.execute(f"SELECT COUNT(*) FROM ({self.sql}) AS _sub",
                        self.params)
            total = int(cur.fetchone()[0])
        finally:
            conn.close()
        if total == 0:
            return []
        parallelism = max(1, min(parallelism, total))
        step = (total + parallelism - 1) // parallelism
        tasks = []
        for start in range(0, total, step):
            limit = min(step, total - start)

            def fn(start=start, limit=limit):
                rows = self._read(" LIMIT ? OFFSET ?", (limit, start))
                return [rows_to_block(rows)] if rows else []

            tasks.append(ReadTask(fn, num_rows=limit))
        return tasks
