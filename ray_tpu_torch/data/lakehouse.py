"""Lakehouse table formats: Delta Lake and Apache Iceberg.

Both are implemented over this package's own parquet + avro IO rather than
the `deltalake` / `pyiceberg` wheels the reference delegates to
(reference: python/ray/data/read_api.py read_delta / read_iceberg,
_internal/datasource/{delta,iceberg}_datasource.py — neither wheel is in
this image, and the formats themselves are small enough to speak natively):

- Delta: the `_delta_log/` transaction log (JSON commits + optional parquet
  checkpoints) is replayed into the active file set; reads push column
  projection and row-group predicates into the underlying parquet scans;
  writes produce real commits other Delta readers accept (protocol 1/2,
  metaData on create, add actions with partition values).
- Iceberg: `metadata/*.metadata.json` -> snapshot -> manifest-list (avro)
  -> manifests (avro) -> data files; deleted entries are dropped. The avro
  manifests are decoded by ray_tpu_torch.data.avro.
"""

from __future__ import annotations

import glob as _glob
import json
import os
import time
import uuid
from typing import Any

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, normalize_block
from ray_tpu_torch.data.datasource import Datasource, ReadTask, round_robin

# ------------------------------------------------------------------- delta


def _delta_log_dir(table: str) -> str:
    return os.path.join(table, "_delta_log")


def _replay_delta_log(table: str) -> tuple[list[dict], dict]:
    """Replay the transaction log → (active add actions, metaData)."""
    log = _delta_log_dir(table)
    if not os.path.isdir(log):
        raise FileNotFoundError(f"{table}: no _delta_log — not a Delta table")
    adds: dict[str, dict] = {}
    meta: dict = {}
    start_version = -1
    ckpt_file = os.path.join(log, "_last_checkpoint")
    if os.path.exists(ckpt_file):
        with open(ckpt_file) as f:
            ckpt = json.load(f)
        start_version = int(ckpt["version"])
        import pyarrow.parquet as pq

        ckpt_path = os.path.join(
            log, f"{start_version:020d}.checkpoint.parquet")
        for row in pq.read_table(ckpt_path).to_pylist():
            if row.get("add"):
                a = row["add"]
                adds[a["path"]] = a
            if row.get("metaData"):
                meta = row["metaData"]
    for path in sorted(_glob.glob(os.path.join(log, "*.json"))):
        version = int(os.path.basename(path).split(".")[0])
        if version <= start_version:
            continue
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                action = json.loads(line)
                if "add" in action:
                    adds[action["add"]["path"]] = action["add"]
                elif "remove" in action:
                    adds.pop(action["remove"]["path"], None)
                elif "metaData" in action:
                    meta = action["metaData"]
    return list(adds.values()), meta


def _partition_caster(meta: dict):
    """Partition values are stored as strings in the log; cast them back
    per the table schema."""
    types: dict[str, str] = {}
    try:
        schema = json.loads(meta.get("schemaString", "{}"))
        for f in schema.get("fields", []):
            types[f["name"]] = f.get("type", "string")
    except (ValueError, TypeError):
        pass

    def cast(col: str, v: str | None):
        if v is None:
            return None
        t = types.get(col, "string")
        if t in ("long", "integer", "short", "byte"):
            return int(v)
        if t in ("double", "float"):
            return float(v)
        if t == "boolean":
            return v == "true"
        return v

    return cast


class DeltaDatasource(Datasource):
    supports_projection = True
    supports_predicates = True

    def __init__(self, table: str, columns=None, filters=None):
        self.table = table
        self.columns = list(columns) if columns else None
        self.filters = list(filters) if filters else None
        self.adds, self.meta = _replay_delta_log(table)

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if not self.adds:
            return []
        cast = _partition_caster(self.meta)
        tasks = []
        for grp in round_robin(self.adds, parallelism):

            def fn(grp=grp, table=self.table, columns=self.columns,
                   filters=self.filters, cast=cast):
                import pyarrow.parquet as pq

                blocks = []
                for a in grp:
                    part = a.get("partitionValues") or {}
                    cols = ([c for c in columns if c not in part]
                            if columns else None)
                    filt = ([f for f in filters if f[0] not in part]
                            if filters else None) or None
                    table_path = os.path.join(table, a["path"])
                    t = pq.read_table(table_path, columns=cols, filters=filt)
                    blk = normalize_block(t)
                    n = BlockAccessor(blk).num_rows()
                    for col, v in part.items():
                        if columns and col not in columns:
                            continue
                        blk[col] = np.asarray([cast(col, v)] * n)
                    # partition-column predicates: evaluate on constants
                    if filters:
                        for col, op, val in filters:
                            if col not in part:
                                continue
                            cv = cast(col, part[col])
                            # lazy dispatch: a dict literal would evaluate
                            # every branch (e.g. `cv in val` with scalar val)
                            keep = {"=": lambda: cv == val,
                                    "==": lambda: cv == val,
                                    "!=": lambda: cv != val,
                                    ">": lambda: cv > val,
                                    ">=": lambda: cv >= val,
                                    "<": lambda: cv < val,
                                    "<=": lambda: cv <= val,
                                    "in": lambda: cv in val,
                                    "not in": lambda: cv not in val}[op]()
                            if not keep:
                                blk = {k: v[:0] for k, v in blk.items()}
                                break
                    blocks.append(blk)
                return blocks

            tasks.append(ReadTask(fn, input_files=[a["path"] for a in grp]))
        return tasks


def write_delta(ds, table: str, *, mode: str = "append",
                partition_cols: list[str] | None = None) -> list[str]:
    """Commit the dataset to a Delta table (create or append). Returns the
    data file paths written. `mode="overwrite"` logically removes the
    previous active files in the same commit."""
    from ray_tpu_torch.data.datasource import (write_parquet_block,
                                         write_parquet_partitioned)

    log = _delta_log_dir(table)
    os.makedirs(log, exist_ok=True)
    existing = sorted(_glob.glob(os.path.join(log, "*.json")))
    last = (int(os.path.basename(existing[-1]).split(".")[0])
            if existing else -1)
    # after log cleanup only the checkpoint may remain: it also pins the
    # version floor, or a new commit would silently shadow history
    ckpt_file = os.path.join(log, "_last_checkpoint")
    if os.path.exists(ckpt_file):
        with open(ckpt_file) as f:
            last = max(last, int(json.load(f)["version"]))
    version = last + 1
    prior_adds: list[dict] = []
    if mode == "overwrite" and version > 0:
        prior_adds, _ = _replay_delta_log(table)
    elif mode not in ("append", "overwrite"):
        raise ValueError(f"mode must be append|overwrite, got {mode!r}")

    files: list[str] = []
    parts: dict[str, dict] = {}
    first_block: Block | None = None
    for i, b in enumerate(ds.iter_blocks()):
        acc = BlockAccessor(b)
        if not acc.num_rows():
            continue
        if first_block is None:
            first_block = b
        if partition_cols:
            written = write_parquet_partitioned(b, table, i, partition_cols)
            for w in written:
                # commit-unique rename: partitioned filenames are only
                # block-indexed, so a later commit writing the same
                # partition would overwrite this commit's physical file
                unique = os.path.join(
                    os.path.dirname(w),
                    f"part-{version:05d}-{uuid.uuid4().hex[:12]}-"
                    f"{os.path.basename(w)[len('part-'):]}")
                os.replace(w, unique)
                rel = os.path.relpath(unique, table)
                pv = {}
                for seg in rel.split(os.sep)[:-1]:
                    if "=" in seg:
                        k, _, v = seg.partition("=")
                        pv[k] = v
                parts[rel] = pv
                files.append(unique)
        else:
            w = write_parquet_block(b, table, i)
            # unique names: delta file sets are immutable across commits
            unique = os.path.join(
                table, f"part-{version:05d}-{uuid.uuid4().hex[:12]}-{i:05d}"
                       ".parquet")
            os.replace(w, unique)
            parts[os.path.relpath(unique, table)] = {}
            files.append(unique)

    now_ms = int(time.time() * 1000)
    actions: list[dict] = []
    if version == 0:
        fields = []
        if first_block is not None:
            for k, v in first_block.items():
                arr = np.asarray(v[:1]) if len(v) else np.asarray(v)
                kind = (
                    "long" if arr.dtype.kind in "iu" else
                    "double" if arr.dtype.kind == "f" else
                    "boolean" if arr.dtype.kind == "b" else "string")
                fields.append({"name": str(k), "type": kind,
                               "nullable": True, "metadata": {}})
        actions.append({"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}})
        actions.append({"metaData": {
            "id": str(uuid.uuid4()),
            "format": {"provider": "parquet", "options": {}},
            "schemaString": json.dumps({"type": "struct", "fields": fields}),
            "partitionColumns": partition_cols or [],
            "configuration": {}, "createdTime": now_ms}})
    for a in prior_adds:
        actions.append({"remove": {"path": a["path"], "dataChange": True,
                                   "deletionTimestamp": now_ms}})
    for rel, pv in parts.items():
        actions.append({"add": {
            "path": rel, "partitionValues": pv,
            "size": os.path.getsize(os.path.join(table, rel)),
            "modificationTime": now_ms, "dataChange": True}})
    actions.append({"commitInfo": {"timestamp": now_ms,
                                   "operation": "WRITE",
                                   "engineInfo": "ray_tpu_torch"}})
    commit = os.path.join(log, f"{version:020d}.json")
    with open(commit + ".tmp", "w") as f:
        for a in actions:
            f.write(json.dumps(a) + "\n")
    os.replace(commit + ".tmp", commit)
    return files


# ----------------------------------------------------------------- iceberg


def _iceberg_current_metadata(table: str) -> dict:
    mdir = os.path.join(table, "metadata")
    hint = os.path.join(mdir, "version-hint.text")
    path = None
    if os.path.exists(hint):
        with open(hint) as f:
            v = f.read().strip()
        for cand in (f"v{v}.metadata.json", f"{v}.metadata.json"):
            if os.path.exists(os.path.join(mdir, cand)):
                path = os.path.join(mdir, cand)
                break
    if path is None:
        cands = sorted(_glob.glob(os.path.join(mdir, "*.metadata.json")))
        if not cands:
            raise FileNotFoundError(
                f"{table}: no metadata/*.metadata.json — not an Iceberg table")
        path = cands[-1]
    with open(path) as f:
        return json.load(f)


def _localize(path: str, table: str) -> str:
    """Iceberg stores absolute URIs; map file:// (and bare absolute paths
    recorded under a different root) onto this table directory."""
    if path.startswith("file://"):
        path = path[len("file://"):]
    if os.path.exists(path):
        return path
    # re-root: find the table's basename inside the recorded path
    base = os.path.basename(os.path.normpath(table))
    idx = path.find(f"/{base}/")
    if idx >= 0:
        cand = os.path.join(table, path[idx + len(base) + 2:])
        if os.path.exists(cand):
            return cand
    return path


def iceberg_data_files(table: str, *, snapshot_id: int | None = None) -> list[dict]:
    """List live data files for a snapshot: [{path, format, record_count}]."""
    from ray_tpu_torch.data.avro import read_avro_file

    meta = _iceberg_current_metadata(table)
    snap_id = snapshot_id if snapshot_id is not None else meta.get(
        "current-snapshot-id")
    snaps = {s["snapshot-id"]: s for s in meta.get("snapshots", [])}
    if snap_id is None or snap_id == -1 or snap_id not in snaps:
        return []
    snap = snaps[snap_id]
    manifests: list[str] = []
    if "manifest-list" in snap:
        records, _ = read_avro_file(_localize(snap["manifest-list"], table))
        manifests = [r["manifest_path"] for r in records]
    else:  # v1 tables may inline the manifest paths
        manifests = list(snap.get("manifests", []))
    out: list[dict] = []
    for mpath in manifests:
        entries, _ = read_avro_file(_localize(mpath, table))
        for e in entries:
            if e.get("status") == 2:  # DELETED
                continue
            df = e["data_file"]
            out.append({"path": _localize(df["file_path"], table),
                        "format": df.get("file_format", "PARQUET"),
                        "record_count": df.get("record_count")})
    return out


class IcebergDatasource(Datasource):
    supports_projection = True
    supports_predicates = True

    def __init__(self, table: str, columns=None, filters=None,
                 snapshot_id: int | None = None):
        self.files = iceberg_data_files(table, snapshot_id=snapshot_id)
        self.columns = list(columns) if columns else None
        self.filters = list(filters) if filters else None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        if not self.files:
            return []
        tasks = []
        for grp in round_robin(self.files, parallelism):

            def fn(grp=grp, columns=self.columns, filters=self.filters):
                import pyarrow.parquet as pq

                blocks = []
                for f in grp:
                    if f["format"].upper() != "PARQUET":
                        raise ValueError(
                            f"unsupported iceberg data file format "
                            f"{f['format']!r} (parquet only)")
                    blocks.append(normalize_block(pq.read_table(
                        f["path"], columns=columns, filters=filters)))
                return blocks

            tasks.append(ReadTask(
                fn, num_rows=sum(f.get("record_count") or 0 for f in grp) or None,
                input_files=[f["path"] for f in grp]))
        return tasks
