"""Dataset: the lazy, streaming dataset API.

(reference: python/ray/data/dataset.py:167 — map_batches:450,
streaming_split:1854, iter_batches:5163, materialize:5994; read_api.py for
the read_* constructors. Execution is deferred: transformations append
logical ops; consumption builds fused physical stages and streams blocks
through the ray_tpu_torch task runtime.)
"""

from __future__ import annotations

import builtins
import collections
from typing import Any, Callable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks, rows_to_block
from ray_tpu_torch.data.datasource import (
    BinaryDatasource,
    TextDatasource,
    CSVDatasource,
    Datasource,
    ImageDatasource,
    ItemsDatasource,
    JSONDatasource,
    NumpyDatasource,
    ParquetDatasource,
    RangeDatasource,
    write_arrow_block,
    write_avro_block,
    write_csv_block,
    write_json_block,
    write_parquet_block,
    write_parquet_partitioned,
)
from ray_tpu_torch.data.execution import (
    StreamingExecutor,
    _rebatch,
    _robust_get,
    build_stages,
    iter_result_blocks,
)

DEFAULT_PARALLELISM = 8


class Dataset:
    def __init__(self, last_op: L.LogicalOp, exec_opts: dict | None = None):
        self._op = last_op
        # execution policy (on_block_error / max_errored_blocks), threaded
        # through every derived Dataset so execute_options() set early in
        # a chain governs the eventual consumption
        self._exec_opts: dict = dict(exec_opts or {})

    # ------------------------------------------------------------ transforms

    def _append(self, op: L.LogicalOp) -> "Dataset":
        op.input = self._op
        return Dataset(op, self._exec_opts)

    def execute_options(self, *, on_block_error: str | None = None,
                        max_errored_blocks: int | None = None) -> "Dataset":
        """Dataset with updated fault-handling policy for UDF errors:
        `on_block_error` "raise" (default) surfaces the first errored
        block, "skip" drops-and-counts up to `max_errored_blocks`
        (-1 = unlimited). System faults (dead actors, lost blocks) are
        always retried and never consult these knobs."""
        opts = dict(self._exec_opts)
        if on_block_error is not None:
            opts["on_block_error"] = on_block_error
        if max_errored_blocks is not None:
            opts["max_errored_blocks"] = max_errored_blocks
        return Dataset(self._op, opts)

    def map_batches(self, fn: Callable, *, batch_size: int | None = None,
                    batch_format: str = "numpy", fn_kwargs: dict | None = None,
                    num_cpus: float = 1.0, num_gpus: float = 0.0,
                    concurrency: int | None = None, compute: str = "tasks") -> "Dataset":
        if compute not in ("tasks", "actors"):
            raise ValueError(
                f"compute must be 'tasks' or 'actors', got {compute!r}")
        return self._append(L.MapBatches(
            fn, batch_size=batch_size, batch_format=batch_format,
            fn_kwargs=fn_kwargs or {}, num_cpus=num_cpus, num_gpus=num_gpus,
            concurrency=concurrency, compute=compute))

    def map(self, fn: Callable) -> "Dataset":
        return self._append(L.MapRows(fn, kind="map"))

    def filter(self, fn: Callable | None = None, *,
               expr: str | None = None) -> "Dataset":
        """Row predicate (callable) or expression string. Expressions
        (`expr="label >= 3 and split == 'train'"`) vectorize over batches
        and push down into parquet reads as row-group pruning (reference:
        Dataset.filter(expr=...) pushes into the read)."""
        if (fn is None) == (expr is None):
            raise ValueError("filter() takes exactly one of fn or expr")
        if expr is not None:
            from ray_tpu_torch.data.expressions import parse_filter

            parse_filter(expr)  # fail fast on bad grammar at plan time
            return self._append(L.FilterExpr(expr))
        return self._append(L.MapRows(fn, kind="filter"))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._append(L.MapRows(fn, kind="flat_map"))

    def limit(self, n: int) -> "Dataset":
        return self._append(L.Limit(n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._append(L.Repartition(num_blocks))

    def random_shuffle(self, *, seed: int | None = None) -> "Dataset":
        return self._append(L.RandomShuffle(seed))

    def sort(self, key: str, *, descending: bool = False) -> "Dataset":
        return self._append(L.Sort(key, descending))

    def union(self, *others: "Dataset") -> "Dataset":
        refs = [ray_tpu_torch.put(list(self._materialize_blocks()))]
        for o in others:
            refs.append(ray_tpu_torch.put(list(o._materialize_blocks())))
        return Dataset(L.InputBlocks(refs=refs))

    def zip(self, other: "Dataset") -> "Dataset":
        """Positionally combine columns of two equal-length datasets
        (reference: Dataset.zip). Duplicate column names from `other` get
        a `_1` suffix. Row order follows each dataset's block order; both
        sides stream through the driver for alignment (like the
        reference, zip is a materializing operation)."""
        import itertools as _it

        out_blocks: list[Block] = []
        rows_l = self.iter_rows()
        rows_r = other.iter_rows()
        batch: list[dict] = []
        for left, right in _it.zip_longest(rows_l, rows_r):
            if left is None or right is None:
                raise ValueError(
                    "Dataset.zip requires equal-length datasets")
            row = dict(left)
            for k, v in right.items():
                name = k
                suffix = 0
                while name in row:  # never clobber an existing column
                    suffix += 1
                    name = f"{k}_{suffix}"
                row[name] = v
            batch.append(row)
            if len(batch) >= 1024:
                out_blocks.append(rows_to_block(batch))
                batch = []
        if batch:
            out_blocks.append(rows_to_block(batch))
        # one ref per block: a single ref would collapse every downstream
        # stage to one task regardless of dataset size
        return Dataset(L.InputBlocks(
            refs=[ray_tpu_torch.put([b]) for b in out_blocks]))

    def groupby(self, key) -> "GroupedData":
        """Group by one column (or a list of columns); aggregate with the
        returned handle (reference: Dataset.groupby, data/grouped_data.py:23)."""
        return GroupedData(self, [key] if isinstance(key, str) else list(key))

    def join(self, other: "Dataset", on, *, right_on=None, how: str = "inner",
             suffixes: tuple = ("", "_r"),
             num_partitions: int | None = None) -> "Dataset":
        """Distributed hash join (reference: Dataset.join,
        data/_internal/execution/operators/join.py:54).

        how: "inner" | "left" | "right" | "outer"."""
        on = [on] if isinstance(on, str) else list(on)
        right_on = on if right_on is None else (
            [right_on] if isinstance(right_on, str) else list(right_on))
        if how not in ("inner", "left", "right", "outer"):
            raise ValueError(f"unsupported join type {how!r}")
        return self._append(L.Join(
            right_last=other._op, on=on, right_on=right_on, how=how,
            suffixes=tuple(suffixes), num_partitions=num_partitions))

    def sum(self, on: str):
        """Global sum of one column (reference: Dataset.sum). Reduction
        runs in the read/map tasks; only per-block scalars reach the
        driver."""
        return self._global_agg(on, "sum")

    def min(self, on: str):
        return self._global_agg(on, "min")

    def max(self, on: str):
        return self._global_agg(on, "max")

    def mean(self, on: str):
        """Global mean of one column (reference: Dataset.mean)."""
        out = self._global_agg(on, "mean")
        return out

    def _global_agg(self, on: str, op: str):
        # per-block partial aggregation ships ONE scalar row per block to
        # the driver instead of the block itself
        def partial(batch):
            if on not in batch:
                raise KeyError(
                    f"column {on!r} not in dataset columns "
                    f"{sorted(batch)}")
            arr = np.asarray(batch[on])
            if op == "mean":
                return {"_s": np.asarray([arr.astype(np.float64).sum()]),
                        "_n": np.asarray([arr.size])}
            return {"_v": np.asarray([getattr(arr, op)()])}

        reduced = self.map_batches(partial, batch_size=None)
        if op == "mean":
            total, count = 0.0, 0
            for row in reduced.iter_rows():
                total += float(row["_s"])
                count += int(row["_n"])
            return total / count if count else None
        out = None
        for row in reduced.iter_rows():
            v = row["_v"]
            if out is None:
                out = v
            elif op == "sum":
                out = out + v
            elif op == "min":
                out = min(out, v)
            else:
                out = max(out, v)
        return None if out is None else out.item() if hasattr(out, "item") else out

    def unique(self, column: str) -> list:
        """Distinct values of one column."""
        out = self.groupby(column).count().take_all()
        return [r[column] for r in out]

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch

        return self.map_batches(add)

    def drop_columns(self, cols: list[str]) -> "Dataset":
        def drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}

        return self.map_batches(drop)

    def select_columns(self, cols: list[str]) -> "Dataset":
        # a real logical op (not an opaque map) so the optimizer can push
        # the projection into columnar reads as IO pruning
        return self._append(L.Project(list(cols)))

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        def rename(batch):
            return {mapping.get(k, k): v for k, v in batch.items()}

        return self.map_batches(rename)

    # ----------------------------------------------------------- consumption

    def _stages(self):
        ops = L.optimize(self._op.chain())
        return build_stages(ops, DEFAULT_PARALLELISM)

    def iter_blocks(self) -> Iterator[Block]:
        yield from iter_result_blocks(self._stages(), **self._exec_opts)

    def _materialize_blocks(self) -> list[Block]:
        return list(self.iter_blocks())

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator[Any]:
        for b in _rebatch(self.iter_blocks(), batch_size):
            if drop_last and batch_size is not None and BlockAccessor(b).num_rows() < batch_size:
                continue
            yield _format_batch(b, batch_format)

    def iter_rows(self) -> Iterator[dict]:
        for b in self.iter_blocks():
            yield from BlockAccessor(b).iter_rows()

    def iter_device_batches(self, *, batch_size: int = 256, device=None,
                            prefetch: int = 2, drop_last: bool = True,
                            dtypes: dict | None = None) -> Iterator[dict]:
        """Batches as torch tensors on `device`, with async host→device
        prefetch: the counterpart of the JAX package's `iter_jax_batches`.

        `device` resolves as every entry point does: ``cuda`` unless the
        caller asks for the CPU, and it raises with no card and no
        `device=`. The window is the reference's: up to ``prefetch + 1``
        batches are in flight before the first is yielded. On the card a
        batch is staged in pinned host memory and copied with
        ``non_blocking=True`` on a side stream; the consumer's current
        stream waits on that copy's event, so the host never blocks on
        PCIe. `dtypes` casts columns on the host, as the reference does.

        (reference: data/iterator.py iter_torch_batches:269 moves batches to
        GPU with a prefetch window.)"""
        import torch

        from ray_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        pending: collections.deque = collections.deque()
        for batch in self.iter_batches(batch_size=batch_size, drop_last=drop_last):
            arrs = {k: np.asarray(v) for k, v in batch.items()}
            if dtypes:
                arrs = {k: (v.astype(dtypes[k]) if k in dtypes else v) for k, v in arrs.items()}
            pending.append(_to_device(torch, arrs, dev, side))
            while len(pending) > prefetch:
                yield _consume(torch, dev, *pending.popleft())
        while pending:
            yield _consume(torch, dev, *pending.popleft())

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           dtypes: dict | None = None) -> Iterator[dict]:
        """Batches as torch tensors on the CPU, with no prefetch window, as
        in the JAX package (reference: data/iterator.py
        iter_torch_batches:269); `iter_device_batches` puts them on the
        card."""
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                arr = np.asarray(v)
                if arr.dtype.kind in "OUS":
                    out[k] = list(arr)  # strings/bytes/objects stay python
                    continue
                arr = np.ascontiguousarray(arr)
                if not arr.flags.writeable:
                    # zero-copy views of read-only shm blocks: hand users a
                    # writable tensor, not silent UB on in-place mutation
                    arr = arr.copy()
                t = torch.from_numpy(arr)
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t
            yield out

    def take(self, n: int = 20) -> list[dict]:
        out: list[dict] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> list[dict]:
        return list(self.iter_rows())

    def to_pandas(self):
        """Materialize the whole dataset as one pandas DataFrame
        (reference: Dataset.to_pandas)."""
        import pandas as pd

        frames = [BlockAccessor(b).to_pandas() for b in self.iter_blocks()
                  if BlockAccessor(b).num_rows()]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow(self):
        """Materialize as a single pyarrow Table (reference:
        Dataset.to_arrow_refs, driver-side variant)."""
        import pyarrow as pa

        tables = [BlockAccessor(b).to_arrow() for b in self.iter_blocks()
                  if BlockAccessor(b).num_rows()]
        if not tables:
            return pa.table({})
        return pa.concat_tables(tables)

    def count(self) -> int:
        return sum(BlockAccessor(b).num_rows() for b in self.iter_blocks())

    def schema(self) -> dict[str, str] | None:
        for b in self.iter_blocks():
            if BlockAccessor(b).num_rows():
                return BlockAccessor(b).schema()
        return None

    def materialize(self) -> "MaterializedDataset":
        blocks = self._materialize_blocks()
        refs = [ray_tpu_torch.put([b]) for b in blocks]
        return MaterializedDataset(L.InputBlocks(refs=refs), blocks_meta=[
            BlockAccessor(b).num_rows() for b in blocks])

    def split(self, n: int) -> list["Dataset"]:
        blocks = self._materialize_blocks()
        merged = concat_blocks(blocks)
        acc = BlockAccessor(merged)
        total = acc.num_rows()
        shards = []
        step = total // n
        for i in builtins.range(n):
            start = i * step
            end = total if i == n - 1 else (i + 1) * step
            shards.append(Dataset(L.InputBlocks(refs=[ray_tpu_torch.put([acc.slice(start, end)])])))
        return shards

    def streaming_split(self, n: int, *, equal: bool = True) -> list["DataIterator"]:
        """N coordinated iterators backed by one shared executor actor.
        (reference: dataset.py streaming_split:1854 + output_splitter.py)"""
        coordinator = _SplitCoordinator.options(name=None).remote(
            self._op, n, self._exec_opts)
        return [DataIterator(coordinator, i) for i in builtins.range(n)]

    # ---------------------------------------------------------------- writes

    def write_parquet(self, path: str,
                      partition_cols: list[str] | None = None) -> list[str]:
        """Parquet files under `path`; with `partition_cols`, hive-style
        `col=value/` subdirectories whose files omit the partition columns
        (reference: Dataset.write_parquet(partition_cols=...))."""
        if not partition_cols:
            return self._write(path, write_parquet_block)
        files: list[str] = []
        for i, b in enumerate(self.iter_blocks()):
            if BlockAccessor(b).num_rows():
                files.extend(write_parquet_partitioned(
                    b, path, i, partition_cols))
        return files

    def write_tfrecords(self, path: str) -> list[str]:
        """One .tfrecord file per block; rows become tf.train.Example
        records (see data/archive.py encode_example)."""
        import os as _os

        from ray_tpu_torch.data.archive import encode_example, write_tfrecord_file

        files = []
        for i, b in enumerate(self.iter_blocks()):
            acc = BlockAccessor(b)
            if not acc.num_rows():
                continue
            _os.makedirs(path, exist_ok=True)
            out = _os.path.join(path, f"part-{i:05d}.tfrecord")
            write_tfrecord_file(out, (encode_example(r)
                                      for r in acc.iter_rows()))
            files.append(out)
        return files

    def write_webdataset(self, path: str) -> list[str]:
        """One .tar shard per block (WebDataset layout)."""
        from ray_tpu_torch.data.archive import write_webdataset_shard

        files = []
        for i, b in enumerate(self.iter_blocks()):
            acc = BlockAccessor(b)
            if acc.num_rows():
                files.append(write_webdataset_shard(
                    path, acc.iter_rows(), index=i))
        return files

    def write_csv(self, path: str) -> list[str]:
        return self._write(path, write_csv_block)

    def write_json(self, path: str) -> list[str]:
        return self._write(path, write_json_block)

    def write_avro(self, path: str) -> list[str]:
        """One Avro object container file per block (data/avro.py codec)."""
        return self._write(path, write_avro_block)

    def write_arrow(self, path: str) -> list[str]:
        """One Arrow IPC file per block."""
        return self._write(path, write_arrow_block)

    def write_delta(self, table: str, *, mode: str = "append",
                    partition_cols: list[str] | None = None) -> list[str]:
        """Commit to a Delta Lake table: parquet data files plus a
        `_delta_log` JSON commit (create/append/overwrite — see
        data/lakehouse.py)."""
        from ray_tpu_torch.data.lakehouse import write_delta

        return write_delta(self, table, mode=mode,
                           partition_cols=partition_cols)

    def _write(self, path: str, writer) -> list[str]:
        files = []
        for i, b in enumerate(self.iter_blocks()):
            if BlockAccessor(b).num_rows():
                files.append(writer(b, path, i))
        return files

    def stats(self) -> str:
        ops = [type(o).__name__ for o in self._op.chain()]
        stages = self._stages()
        return (f"logical: {' -> '.join(ops)}\n"
                f"physical: {' -> '.join(s.name for s in stages)}")

    def __repr__(self):
        return f"Dataset({' -> '.join(type(o).__name__ for o in self._op.chain())})"


def _to_device(torch, arrs: dict, dev, side):
    """Start one batch's host→device copy; returns (tensors, event). On the
    CPU the tensors are writable copies and there is no event."""
    if side is None:
        return {k: torch.from_numpy(np.array(a, copy=True, order="C"))
                for k, a in arrs.items()}, None
    out = {}
    with torch.cuda.stream(side):
        for k, a in arrs.items():
            host = torch.empty(a.shape, pin_memory=True,
                               dtype=torch.from_numpy(a[:0].ravel()).dtype)
            host.numpy()[...] = a  # the one host copy: into pinned memory
            out[k] = host.to(dev, non_blocking=True)
        event = side.record_event()
    return out, event


def _consume(torch, dev, out: dict, event) -> dict:
    """Hand a prefetched batch to the consumer: its current stream waits
    on the copy's event, and the caching allocator learns that the
    tensors are used there (they were allocated on the side stream)."""
    if event is not None:
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(event)
        for t in out.values():
            t.record_stream(cur)
    return out


class GroupedData:
    """Handle returned by Dataset.groupby: terminal aggregation methods
    append a GroupByAgg (or MapGroups) op to the plan.

    (reference: python/ray/data/grouped_data.py:23 — aggregate, count, sum,
    min, max, mean, std, map_groups.)"""

    def __init__(self, ds: Dataset, keys: list):
        self._ds = ds
        self._keys = keys

    def aggregate(self, *aggs) -> Dataset:
        from ray_tpu_torch.data.aggregate import AggregateFn

        for a in aggs:
            if not isinstance(a, AggregateFn):
                raise TypeError(f"expected AggregateFn, got {type(a)}")
        return self._ds._append(L.GroupByAgg(keys=self._keys, aggs=list(aggs)))

    def count(self) -> Dataset:
        from ray_tpu_torch.data.aggregate import Count

        return self.aggregate(Count(alias_name="count()"))

    def sum(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(on))

    def min(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(on))

    def max(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(on))

    def mean(self, on: str) -> Dataset:
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(on))

    def std(self, on: str, ddof: int = 1) -> Dataset:
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(on, ddof=ddof))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy") -> Dataset:
        """Apply fn to each whole group; fn receives the group's rows as one
        batch and returns a batch (dict of columns) or list of rows."""
        return self._ds._append(L.MapGroups(keys=self._keys, fn=fn,
                                            batch_format=batch_format))


class MaterializedDataset(Dataset):
    def __init__(self, op, blocks_meta=None):
        super().__init__(op)
        self._blocks_meta = blocks_meta or []

    def num_blocks(self) -> int:
        return len(self._blocks_meta)


def _format_batch(block: Block, batch_format: str):
    if batch_format == "numpy":
        return BlockAccessor(block).to_numpy()
    if batch_format == "pandas":
        return BlockAccessor(block).to_pandas()
    if batch_format == "pyarrow":
        return BlockAccessor(block).to_arrow()
    if batch_format in (None, "native"):
        return block
    raise ValueError(f"unknown batch_format {batch_format!r}")


@ray_tpu_torch.remote
class _SplitCoordinator:
    """Actor running the shared executor for streaming_split consumers.

    (reference: _internal/execution/streaming_executor takes this role via
    OutputSplitter, execution/operators/output_splitter.py — blocks are
    routed round-robin to N registered consumers with per-split queues.)"""

    def __init__(self, last_op, n: int, exec_opts: dict | None = None):
        self.n = n
        stages = build_stages(L.optimize(last_op.chain()), DEFAULT_PARALLELISM)
        self._queues: list[collections.deque] = [collections.deque() for _ in builtins.range(n)]
        self._ex = StreamingExecutor(stages, **(exec_opts or {}))
        self._gen = self._ex.execute()
        self._rr = 0
        self._done = False

    def _pump_until(self, split: int) -> None:
        while not self._queues[split] and not self._done:
            try:
                item = next(self._gen)
            except StopIteration:
                self._done = True
                return
            got = _robust_get(item) if hasattr(item, "hex") else item
            self._ex._free_if_owned(item)
            blocks = got if isinstance(got, list) else [got]
            for b in blocks:
                if BlockAccessor(b).num_rows():
                    self._queues[self._rr % self.n].append(b)
                    self._rr += 1

    def get_next(self, split: int):
        self._pump_until(split)
        if self._queues[split]:
            return self._queues[split].popleft()
        return None  # exhausted


class DataIterator:
    """Per-consumer handle for one split of a streaming_split.

    (reference: data/iterator.py DataIterator — iter_batches on a shard.)"""

    def __init__(self, coordinator, split: int):
        self._coord = coordinator
        self._split = split

    def iter_blocks(self) -> Iterator[Block]:
        while True:
            ref = self._coord.get_next.remote(self._split)
            block = ray_tpu_torch.get(ref)
            ray_tpu_torch.free([ref])  # actor-returned copies are single-consumer
            if block is None:
                return
            yield block

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy") -> Iterator[Any]:
        for b in _rebatch(self.iter_blocks(), batch_size):
            yield _format_batch(b, batch_format)

    def iter_rows(self) -> Iterator[dict]:
        for b in self.iter_blocks():
            yield from BlockAccessor(b).iter_rows()


# ------------------------------------------------------------------- readers


def range(n: int, *, parallelism: int = -1) -> Dataset:  # noqa: A001 — mirrors reference name
    return Dataset(L.Read(RangeDatasource(n), parallelism))


def from_items(items: list, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(ItemsDatasource(items), parallelism))


def read_parquet(paths, *, columns=None, filter: str | list | None = None,
                 parallelism: int = -1) -> Dataset:
    """`columns` prunes at IO; `filter` (expression string or pyarrow DNF
    tuples) prunes row groups by their statistics before decode."""
    filters = None
    if isinstance(filter, str):
        from ray_tpu_torch.data.expressions import parse_filter

        filters = parse_filter(filter)
    elif filter:
        filters = list(filter)
    return Dataset(L.Read(ParquetDatasource(paths, columns, filters),
                          parallelism))


def read_tfrecords(paths, *, decode="example", verify_crc: bool = True,
                   parallelism: int = -1) -> Dataset:
    """Sharded .tfrecord archives; `decode="example"` parses tf.train
    .Example features, None yields raw {"bytes": ...} rows, or pass a
    callable (reference: read_api.py read_tfrecords)."""
    from ray_tpu_torch.data.archive import TFRecordDatasource

    return Dataset(L.Read(TFRecordDatasource(
        paths, decode=decode, verify_crc=verify_crc), parallelism))


def read_webdataset(paths, *, decode: bool = True,
                    parallelism: int = -1) -> Dataset:
    """WebDataset-style .tar shards: files sharing a basename prefix form
    one sample (reference: read_api.py read_webdataset)."""
    from ray_tpu_torch.data.archive import WebDatasetDatasource

    return Dataset(L.Read(WebDatasetDatasource(paths, decode=decode),
                          parallelism))


def read_csv(paths, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(CSVDatasource(paths), parallelism))


def read_json(paths, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(JSONDatasource(paths), parallelism))


def read_numpy(paths, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(NumpyDatasource(paths), parallelism))


def read_binary_files(paths, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(BinaryDatasource(paths), parallelism))


def read_images(paths, *, size=None, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(ImageDatasource(paths, size), parallelism))


def read_sql(sql: str, connection_factory, *, params: tuple = (),
             parallelism: int = 1) -> Dataset:
    """Query any DBAPI database (reference: read_api.py read_sql). Pass
    parallelism > 1 only for dialects where `LIMIT ? OFFSET ?` over the
    query is stable (e.g. an ORDER BY in `sql`)."""
    from ray_tpu_torch.data.datasource import SQLDatasource

    return Dataset(L.Read(SQLDatasource(sql, connection_factory,
                                        params=params), parallelism))


def read_avro(paths, *, parallelism: int = -1) -> Dataset:
    """Avro object container files (reference: read_api.py read_avro)."""
    from ray_tpu_torch.data.datasource import AvroDatasource

    return Dataset(L.Read(AvroDatasource(paths), parallelism))


def read_arrow(paths, *, parallelism: int = -1) -> Dataset:
    """Arrow IPC / Feather V2 files."""
    from ray_tpu_torch.data.datasource import ArrowDatasource

    return Dataset(L.Read(ArrowDatasource(paths), parallelism))


def read_audio(paths, *, parallelism: int = -1) -> Dataset:
    """Audio files → {"amplitude": (C, N) float32, "sample_rate", "path"}
    rows (reference: read_api.py read_audio — soundfile there; WAV/AIFF/AU
    decode dependency-free here)."""
    from ray_tpu_torch.data.datasource import AudioDatasource

    return Dataset(L.Read(AudioDatasource(paths), parallelism))


def read_videos(paths, *, include_timestamps: bool = False,
                frame_step: int = 1, parallelism: int = -1) -> Dataset:
    """Video files → one row per frame: {"frame": HWC uint8 RGB,
    "frame_index", "path"} (reference: read_api.py read_videos — decord
    there; OpenCV here)."""
    from ray_tpu_torch.data.datasource import VideoDatasource

    return Dataset(L.Read(VideoDatasource(
        paths, include_timestamps=include_timestamps,
        frame_step=frame_step), parallelism))


def read_hudi(table_uri: str, *, columns=None, filter=None,
              as_of: str | None = None, parallelism: int = -1) -> Dataset:
    """Apache Hudi copy-on-write snapshot read: `.hoodie` commit timeline
    → latest base parquet per file group, columns/filter pushed into the
    parquet scans; `as_of` time-travels to an instant (reference:
    read_api.py read_hudi)."""
    from ray_tpu_torch.data.datasource import HudiDatasource

    return Dataset(L.Read(HudiDatasource(
        table_uri, columns=columns, filters=_parse_filter_arg(filter),
        as_of=as_of), parallelism))


def read_lance(uri: str, *, columns=None, filter: str | None = None,
               scanner_options: dict | None = None,
               parallelism: int = -1) -> Dataset:
    """Lance dataset, one read task per fragment (reference: read_api.py
    read_lance:4044). Requires the `lance` package (import-gated, absent
    from this image)."""
    from ray_tpu_torch.data.datasource import LanceDatasource

    return Dataset(L.Read(LanceDatasource(
        uri, columns=columns, filter=filter,
        scanner_options=scanner_options), parallelism))


def _parse_filter_arg(filter):
    if isinstance(filter, str):
        from ray_tpu_torch.data.expressions import parse_filter

        return parse_filter(filter)
    return list(filter) if filter else None


def read_delta(table: str, *, columns=None, filter=None,
               parallelism: int = -1) -> Dataset:
    """Delta Lake table: replays `_delta_log` (JSON commits + parquet
    checkpoint) into the active file set; `columns`/`filter` push down
    into the parquet scans and partition values (reference: read_api.py
    read_delta)."""
    from ray_tpu_torch.data.lakehouse import DeltaDatasource

    return Dataset(L.Read(DeltaDatasource(
        table, columns, _parse_filter_arg(filter)), parallelism))


def read_iceberg(table: str, *, columns=None, filter=None,
                 snapshot_id: int | None = None,
                 parallelism: int = -1) -> Dataset:
    """Apache Iceberg table: metadata.json → snapshot → avro manifest list
    → avro manifests → parquet data files (reference: read_api.py
    read_iceberg). Local/file:// warehouses."""
    from ray_tpu_torch.data.lakehouse import IcebergDatasource

    return Dataset(L.Read(IcebergDatasource(
        table, columns, _parse_filter_arg(filter), snapshot_id),
        parallelism))


def read_datasource(ds: Datasource, *, parallelism: int = -1) -> Dataset:
    return Dataset(L.Read(ds, parallelism))


def read_text(paths, *, parallelism: int = -1, drop_empty_lines: bool = True,
              encoding: str = "utf-8") -> Dataset:
    """One row per line: {"text": ...} (reference: read_api.py read_text)."""
    return Dataset(L.Read(TextDatasource(paths, drop_empty_lines=drop_empty_lines,
                                         encoding=encoding), parallelism))


def from_huggingface(hf_dataset, *, parallelism: int = -1) -> Dataset:
    """Materialize a Hugging Face ``datasets.Dataset`` (reference:
    read_api.py from_huggingface — arrow-backed conversion). Batched arrow
    extraction, not row loops; ``DatasetDict`` callers pick a split first."""
    if isinstance(hf_dataset, dict):  # DatasetDict subclasses dict
        raise ValueError(
            "from_huggingface expects one split (e.g. ds['train']), got a "
            f"DatasetDict with splits {list(hf_dataset.keys())}")
    # select/shuffle/train_test_split keep the FULL table in .data and
    # record the view in a lazy _indices mapping — materialize it or the
    # handoff would silently return all rows in original order
    if getattr(hf_dataset, "_indices", None) is not None:
        hf_dataset = hf_dataset.flatten_indices()
    try:
        table = hf_dataset.data.table  # arrow-backed: zero-copy handoff
    except AttributeError:
        table = None
    import pyarrow as pa

    if isinstance(table, pa.Table):
        return from_arrow(table)
    return from_items([dict(r) for r in hf_dataset],
                      parallelism=parallelism)


def from_torch(torch_dataset, *, parallelism: int = -1) -> Dataset:
    """Materialize a map-style torch Dataset (reference: read_api.py
    from_torch). Rows become {"item": sample} (or dict samples verbatim)."""
    items = []
    for i in builtins.range(len(torch_dataset)):  # module range() is a reader
        sample = torch_dataset[i]
        items.append(sample if isinstance(sample, dict) else {"item": sample})
    return from_items(items, parallelism=parallelism)


def from_numpy(arr) -> Dataset:
    return Dataset(L.InputBlocks(refs=[ray_tpu_torch.put([{"data": np.asarray(arr)}])]))


def from_pandas(df) -> Dataset:
    from ray_tpu_torch.data.block import normalize_block

    return Dataset(L.InputBlocks(refs=[ray_tpu_torch.put([normalize_block(df)])]))


def from_arrow(table) -> Dataset:
    from ray_tpu_torch.data.block import normalize_block

    return Dataset(L.InputBlocks(refs=[ray_tpu_torch.put([normalize_block(table)])]))
