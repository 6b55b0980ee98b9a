"""Physical plan + streaming executor.

Stages are fused chains of block transforms executed as remote tasks over the
ray_tpu_torch runtime; the executor is a driver-side scheduling loop with bounded
per-stage concurrency and bounded output queues (backpressure), pulling
blocks through the pipeline as the consumer iterates.

(reference: python/ray/data/_internal/execution/streaming_executor.py:64 —
the _scheduling_loop_step:444 select/dispatch/process loop;
operators/map_operator.py:68 for task-pool maps; backpressure policies under
execution/backpressure_policy/. Ours is deliberately simpler: per-stage
in-flight caps + output-queue caps give the same streaming property.)
"""

from __future__ import annotations

import collections
import heapq
import itertools
import logging
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private import constants as const
from ray_tpu_torch._private.ray_config import RayConfig
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks, rows_to_block
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    DataBlockError,
    ObjectLostError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

# Retry taxonomy: SYSTEM errors are the runtime's fault — the task never
# (fully) ran because its actor/worker died or an input copy vanished —
# and resubmission from the retained input is safe and invisible.
# Everything else reached the UDF and is an APPLICATION error, governed by
# the on_block_error policy (reference: Ray Data's task retry vs
# max_errored_blocks split).
_SYSTEM_ERRORS = (ActorDiedError, WorkerCrashedError, ObjectLostError)


def _is_system_error(exc) -> bool:
    if isinstance(exc, _SYSTEM_ERRORS):
        return True
    return isinstance(getattr(exc, "cause", None), _SYSTEM_ERRORS)


def _backoff_delay(attempt: int, base: float, rng) -> float:
    """Full-jitter exponential backoff, capped at 8x base (rng is
    injectable so tests pin the schedule)."""
    return rng.uniform(0.0, min(base * (2 ** attempt), base * 8.0))


def _ref_error(ref):
    """The exception a wait()-ready ref carries, or None. `wait` reports
    errored objects as ready, so completion polls must probe before
    forwarding a ref downstream — via the owner's status cache, never by
    fetching successful payloads."""
    if not hasattr(ref, "hex"):
        return None
    try:
        from ray_tpu_torch._private.api import _get_worker

        return _get_worker().error_of(ref.hex())
    except Exception:
        return None


def _actor_dead(actor) -> bool:
    """GCS `actor_info` liveness probe (the same poll the collectives
    use): dead only on a positive answer — an RPC failure is inconclusive
    and must never condemn a healthy actor."""
    try:
        from ray_tpu_torch._private.api import _get_worker

        info = _get_worker().rpc(
            {"type": "actor_info", "aid": actor._actor_id}, timeout=10.0)
    except Exception:
        return False
    return (not info.get("found")) or info.get("state") == "dead"


def _emit_data_event(etype: str, message: str, **fields) -> None:
    try:
        from ray_tpu_torch._private.events import emit_event

        emit_event(etype, severity=const.EVENT_SEVERITY_WARNING,
                   message=message, **fields)
    except Exception:  # noqa: BLE001 — telemetry must not kill the pipeline
        pass


def _robust_get(refs, *, rng=None):
    """Driver-side barrier `get` riding lineage recovery: a lost copy is
    reconstructed inside the worker's `_ensure_local` loop, and the rare
    `ObjectLostError` that still escapes (reconstruction racing eviction)
    gets a bounded, jittered re-get before surfacing."""
    cfg = RayConfig.instance()
    if not cfg.data_fault_tolerance:
        return ray_tpu_torch.get(refs)
    rng = rng if rng is not None else random.Random()
    attempt = 0
    while True:
        try:
            return ray_tpu_torch.get(refs)
        except ObjectLostError:
            if attempt >= cfg.data_max_block_retries:
                raise
            time.sleep(_backoff_delay(attempt, cfg.data_retry_backoff_s,
                                      rng))
            attempt += 1


# Transform fns operate on list[Block] → list[Block]; a stage fuses several.


def _rows_transform(fn: Callable, kind: str) -> Callable:
    def transform(blocks: list[Block]) -> list[Block]:
        out = []
        for b in blocks:
            acc = BlockAccessor(b)
            if kind == "map":
                out.append(rows_to_block([fn(r) for r in acc.iter_rows()]))
            elif kind == "filter":
                out.append(rows_to_block([r for r in acc.iter_rows() if fn(r)]))
            else:  # flat_map
                rows: list = []
                for r in acc.iter_rows():
                    rows.extend(fn(r))
                out.append(rows_to_block(rows))
        return out

    return transform


def _batches_transform(fn: Callable, batch_size: int | None, batch_format: str,
                       fn_kwargs: dict) -> Callable:
    from ray_tpu_torch.data.block import normalize_block

    # a CLASS fn is a stateful UDF: instantiate lazily, once per process —
    # expensive setup (model load) happens once per map actor/worker
    # (reference: ActorPoolMapOperator with callable-class UDFs)
    is_class_fn = isinstance(fn, type)
    state: dict = {}

    def transform(blocks: list[Block]) -> list[Block]:
        if is_class_fn and "inst" not in state:
            state["inst"] = fn()
        call = state["inst"] if is_class_fn else fn
        out = []
        for b in _rebatch(blocks, batch_size):
            if batch_format == "pandas":
                b = BlockAccessor(b).to_pandas()
            elif batch_format == "pyarrow":
                b = BlockAccessor(b).to_arrow()
            else:
                b = BlockAccessor(b).to_numpy()
            res = call(b, **fn_kwargs)
            out.append(normalize_block(res))
        return out

    return transform


def _rebatch(blocks: list[Block], batch_size: int | None) -> Iterator[Block]:
    if batch_size is None:
        yield from (b for b in blocks if BlockAccessor(b).num_rows() > 0)
        return
    buf: list[Block] = []
    buffered = 0
    for b in blocks:
        n = BlockAccessor(b).num_rows()
        if n == 0:
            continue
        buf.append(b)
        buffered += n
        while buffered >= batch_size:
            merged = concat_blocks(buf)
            acc = BlockAccessor(merged)
            yield acc.slice(0, batch_size)
            rest = acc.slice(batch_size, acc.num_rows())
            buf = [rest] if BlockAccessor(rest).num_rows() else []
            buffered = BlockAccessor(rest).num_rows() if buf else 0
    if buffered:
        yield concat_blocks(buf)


@dataclass
class Stage:
    """A fused physical stage: source tasks or a transform over input refs."""

    name: str
    transforms: list[Callable] = field(default_factory=list)
    read_tasks: list | None = None        # source stage if set
    input_refs: list | None = None        # pre-materialized source
    all_to_all: Callable | None = None    # driver-side barrier stage if set
    a2a_refs: Callable | None = None      # distributed barrier: refs -> refs
    resources: dict = field(default_factory=lambda: {"CPU": 1.0})
    max_in_flight: int = 8
    concurrency: object = None  # int or (min, max) for actor pools
    compute: str = "tasks"  # "tasks" | "actors" (stateful UDF pool)

    def run_chain(self, blocks: list[Block]) -> list[Block]:
        for t in self.transforms:
            blocks = t(blocks)
        return blocks


def _stage_task(transforms: list[Callable]):
    def run(payload) -> list[Block]:
        blocks = payload() if callable(payload) else payload
        for t in transforms:
            blocks = t(blocks)
        return blocks

    return run


def build_stages(ops: list[L.LogicalOp], default_parallelism: int) -> list[Stage]:
    """Logical ops → fused physical stages.
    (reference: _internal/planner/planner.py + rules/operator_fusion.py)"""
    stages: list[Stage] = []
    cur: Stage | None = None

    def flush():
        nonlocal cur
        if cur is not None:
            stages.append(cur)
            cur = None

    for op in ops:
        if isinstance(op, L.Read):
            flush()
            par = op.parallelism if op.parallelism > 0 else default_parallelism
            tasks = op.datasource.get_read_tasks(par)
            if op.limit is not None:
                tasks = _cap_read_tasks(tasks, op.limit)
            cur = Stage(name="Read", read_tasks=list(tasks))
        elif isinstance(op, L.InputBlocks):
            flush()
            cur = Stage(name="Input", input_refs=list(op.refs))
        elif isinstance(op, L.MapBatches):
            t = _batches_transform(op.fn, op.batch_size, op.batch_format, op.fn_kwargs)
            res = {"CPU": op.num_cpus}
            if op.num_gpus:
                res["GPU"] = op.num_gpus
            if (cur is not None and cur.all_to_all is None
                    and res == cur.resources
                    and cur.compute == (op.compute or "tasks")):
                cur.name += "->MapBatches"
                cur.transforms.append(t)
            else:
                flush()
                conc = op.concurrency or 8
                # (min, max) tuples configure an autoscaling actor pool
                # (reference: concurrency=(m, n) on map_batches)
                mif = max(conc) if isinstance(conc, (tuple, list)) else conc
                cur = Stage(name="MapBatches", transforms=[t], resources=res,
                            max_in_flight=mif, concurrency=conc,
                            compute=op.compute or "tasks")
        elif isinstance(op, L.MapRows):
            t = _rows_transform(op.fn, op.kind)
            if cur is not None and cur.all_to_all is None:
                cur.name += f"->{op.kind}"
                cur.transforms.append(t)
            else:
                flush()
                cur = Stage(name=op.kind, transforms=[t])
        elif isinstance(op, L.Project):
            cols = list(op.cols)
            t = _batches_transform(
                lambda batch, _c=cols: {k: batch[k] for k in _c},
                None, "numpy", {})
            if cur is not None and cur.all_to_all is None:
                cur.name += "->Project"
                cur.transforms.append(t)
            else:
                flush()
                cur = Stage(name="Project", transforms=[t])
        elif isinstance(op, L.FilterExpr):
            from ray_tpu_torch.data.expressions import compile_predicate

            pred = compile_predicate(op.expr)

            def fexpr(batch, _p=pred):
                m = _p(batch)
                return {k: np.asarray(v)[m] for k, v in batch.items()}

            t = _batches_transform(fexpr, None, "numpy", {})
            if cur is not None and cur.all_to_all is None:
                cur.name += "->FilterExpr"
                cur.transforms.append(t)
            else:
                flush()
                cur = Stage(name="FilterExpr", transforms=[t])
        elif isinstance(op, L.Limit):
            flush()
            stages.append(Stage(name="Limit", all_to_all=_limit_fn(op.n)))
        elif isinstance(op, L.Repartition):
            flush()
            stages.append(Stage(name="Repartition", a2a_refs=_dist_repartition_refs(op.num_blocks)))
        elif isinstance(op, L.RandomShuffle):
            flush()
            stages.append(Stage(name="RandomShuffle", a2a_refs=_dist_shuffle_refs(op.seed)))
        elif isinstance(op, L.Sort):
            flush()
            stages.append(Stage(name="Sort", a2a_refs=_dist_sort_refs(op.key, op.descending)))
        elif isinstance(op, L.GroupByAgg):
            from ray_tpu_torch._private import serialization as ser

            flush()
            stages.append(Stage(
                name="GroupByAgg",
                a2a_refs=_dist_groupby_refs(op.keys, ser.dumps(op.aggs))))
        elif isinstance(op, L.MapGroups):
            from ray_tpu_torch._private import serialization as ser

            flush()
            stages.append(Stage(
                name="MapGroups",
                a2a_refs=_dist_groupby_refs(op.keys, ser.dumps(op.fn),
                                            map_groups=True)))
        elif isinstance(op, L.Join):
            flush()
            stages.append(Stage(name="Join", a2a_refs=_dist_join_refs(op)))
        elif isinstance(op, L.Union):
            pass  # handled at Dataset level by ref concatenation
        else:
            raise TypeError(f"unknown logical op {op}")
    flush()
    if not stages:
        stages = [Stage(name="Input", input_refs=[])]
    return stages


def _cap_read_tasks(tasks, n):
    out, left = [], n
    for t in tasks:
        if left <= 0:
            break
        out.append(t)
        if t.num_rows is not None:
            left -= t.num_rows
    return out


def _limit_fn(n: int):
    def cut(all_blocks: list[Block]) -> list[list[Block]]:
        out, left = [], n
        for b in all_blocks:
            if left <= 0:
                break
            acc = BlockAccessor(b)
            take = min(left, acc.num_rows())
            out.append(acc.slice(0, take))
            left -= take
        return [out]

    return cut


def _repartition_fn(k: int):
    def repart(all_blocks: list[Block]) -> list[list[Block]]:
        merged = concat_blocks(all_blocks)
        total = BlockAccessor(merged).num_rows()
        step = max(1, (total + k - 1) // k)
        acc = BlockAccessor(merged)
        return [[acc.slice(i, min(i + step, total))] for i in range(0, total, step)] or [[{}]]

    return repart


def _shuffle_fn(seed):
    def shuf(all_blocks: list[Block]) -> list[list[Block]]:
        merged = concat_blocks(all_blocks)
        acc = BlockAccessor(merged)
        n = acc.num_rows()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        out = {k: (np.asarray(v)[perm] if isinstance(v, np.ndarray) else [v[i] for i in perm])
               for k, v in merged.items()}
        return [[out]]

    return shuf


def _sort_fn(key: str, descending: bool):
    def srt(all_blocks: list[Block]) -> list[list[Block]]:
        merged = concat_blocks(all_blocks)
        idx = np.argsort(np.asarray(merged[key]), kind="stable")
        if descending:
            idx = idx[::-1]
        out = {k: (np.asarray(v)[idx] if isinstance(v, np.ndarray) else [v[i] for i in idx])
               for k, v in merged.items()}
        return [[out]]

    return srt


# ------------------------------------------------------------- distributed
# Task-based all-to-all: map tasks partition each input, reduce tasks merge
# one partition each — the driver only routes ObjectRefs, blocks never
# materialize on it (reference: data/_internal/execution/operators/
# hash_shuffle.py).


def _as_blocks(payload) -> list[Block]:
    return payload if isinstance(payload, list) else [payload]


def _take_rows(block: Block, idx) -> Block:
    return {k: (np.asarray(v)[idx] if isinstance(v, np.ndarray)
                else [v[i] for i in idx])
            for k, v in block.items()}


def _split_by_assignment(merged: Block, assign: np.ndarray, w: int):
    parts = []
    for j in range(w):
        idx = np.nonzero(assign == j)[0]
        parts.append([_take_rows(merged, idx)])
    return tuple(parts) if w > 1 else parts[0]


@ray_tpu_torch.remote
def _rows_of(payload) -> int:
    return sum(BlockAccessor(b).num_rows() for b in _as_blocks(payload))


@ray_tpu_torch.remote
def _sample_keys(payload, key: str, k: int):
    merged = concat_blocks(_as_blocks(payload))
    arr = np.asarray(merged.get(key, []))
    if arr.size <= k:
        return arr
    sel = np.random.default_rng(0).choice(arr.size, size=k, replace=False)
    return arr[sel]


@ray_tpu_torch.remote
def _split_random(payload, w: int, seed, salt: int):
    merged = concat_blocks(_as_blocks(payload))
    n = BlockAccessor(merged).num_rows()
    rng = np.random.default_rng(None if seed is None else seed * 100_003 + salt)
    return _split_by_assignment(merged, rng.integers(0, w, n), w)


@ray_tpu_torch.remote
def _split_range(payload, w: int, key: str, boundaries):
    merged = concat_blocks(_as_blocks(payload))
    vals = np.asarray(merged.get(key, []))
    assign = np.searchsorted(np.asarray(boundaries), vals, side="right")
    return _split_by_assignment(merged, assign, w)


@ray_tpu_torch.remote
def _split_offsets(payload, w: int, start: int, bounds):
    merged = concat_blocks(_as_blocks(payload))
    n = BlockAccessor(merged).num_rows()
    global_idx = np.arange(start, start + n)
    assign = np.searchsorted(np.asarray(bounds), global_idx, side="right")
    return _split_by_assignment(merged, assign, w)


@ray_tpu_torch.remote
def _merge_plain(*parts):
    blocks = [b for p in parts for b in _as_blocks(p) if BlockAccessor(b).num_rows()]
    return [concat_blocks(blocks)] if blocks else [{}]


@ray_tpu_torch.remote
def _merge_shuffled(seed, j: int, *parts):
    merged = concat_blocks([b for p in parts for b in _as_blocks(p)])
    n = BlockAccessor(merged).num_rows()
    rng = np.random.default_rng(None if seed is None else seed * 7 + j)
    return [_take_rows(merged, rng.permutation(n))]


@ray_tpu_torch.remote
def _merge_sorted(key: str, descending: bool, *parts):
    merged = concat_blocks([b for p in parts for b in _as_blocks(p)])
    idx = np.argsort(np.asarray(merged.get(key, [])), kind="stable")
    if descending:
        idx = idx[::-1]
    return [_take_rows(merged, idx)]


def _normalize_parts(handle, w: int):
    """options(num_returns=w) returns a single ref for w==1."""
    return handle if isinstance(handle, list) else [handle]


# ------------------------------------------------- groupby / join (hashed)
# (reference: data/grouped_data.py:23 groupby/aggregate over a hash shuffle,
# _internal/execution/operators/hash_shuffle.py + join.py:54)


def _row_hashes(cols, n: int) -> np.ndarray:
    """Stable per-row hash of the key columns (same value → same partition)."""
    import zlib

    h = np.zeros(n, dtype=np.uint64)
    for c in cols:
        a = np.asarray(c)
        if a.dtype.kind in "iubf":
            # ALL numerics hash through float64 so equal values co-locate
            # across dtypes (int64 5 must meet float64 5.0 in a join);
            # precision collisions just share a partition, which is fine
            az = a.astype(np.float64)
            az = np.where(az == 0.0, 0.0, az)  # -0.0 and 0.0 must co-locate
            v = az.view(np.uint64)
        else:
            v = np.fromiter((zlib.crc32(str(x).encode()) for x in a),
                            dtype=np.uint64, count=n)
        h = h * np.uint64(1099511628211) + v
    return h


@ray_tpu_torch.remote
def _split_hash(payload, w: int, keys: list):
    merged = concat_blocks(_as_blocks(payload))
    if not merged:
        return tuple([{}] for _ in range(w)) if w > 1 else [{}]
    n = BlockAccessor(merged).num_rows()
    cols = [merged[k] for k in keys]
    assign = (_row_hashes(cols, n) % np.uint64(w)).astype(np.int64)
    return _split_by_assignment(merged, assign, w)


def _group_sorted(merged: Block, keys: list):
    """Sort rows into group order; return (sorted block, group starts,
    group counts)."""
    n = BlockAccessor(merged).num_rows()
    cols = [np.asarray(merged[k]) for k in keys]
    order = np.lexsort(tuple(reversed(cols)))
    srt = _take_rows(merged, order)
    scols = [np.asarray(srt[k]) for k in keys]
    if n == 0:
        return srt, np.asarray([], dtype=np.int64), np.asarray([], dtype=np.int64)
    newgrp = np.zeros(n, dtype=bool)
    newgrp[0] = True
    for c in scols:
        newgrp[1:] |= c[1:] != c[:-1]
    starts = np.nonzero(newgrp)[0]
    counts = np.diff(np.concatenate([starts, [n]]))
    return srt, starts, counts


@ray_tpu_torch.remote
def _agg_partition(keys: list, aggs_blob: bytes, *parts):
    from ray_tpu_torch._private import serialization as ser

    aggs = ser.loads(aggs_blob)
    blocks = [b for p in parts for b in _as_blocks(p) if BlockAccessor(b).num_rows()]
    if not blocks:
        return [{}]
    srt, starts, counts = _group_sorted(concat_blocks(blocks), keys)
    out: Block = {k: np.asarray(srt[k])[starts] for k in keys}
    for agg in aggs:
        col = np.asarray(srt[agg.on]) if agg.on else None
        vals = agg.compute(col, starts, counts)
        out[agg.alias] = vals if isinstance(vals, list) else np.asarray(vals)
    return [out]


@ray_tpu_torch.remote
def _map_groups_partition(keys: list, fn_blob: bytes, *parts):
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.data.block import rows_to_block

    fn = ser.loads(fn_blob)
    blocks = [b for p in parts for b in _as_blocks(p) if BlockAccessor(b).num_rows()]
    if not blocks:
        return [{}]
    srt, starts, counts = _group_sorted(concat_blocks(blocks), keys)
    n = BlockAccessor(srt).num_rows()
    ends = np.concatenate([starts[1:], [n]])
    outs = []
    for s, e in zip(starts, ends):
        group = {k: (np.asarray(v)[s:e] if isinstance(v, np.ndarray)
                     else v[s:e]) for k, v in srt.items()}
        res = fn(group)
        if isinstance(res, dict):
            outs.append(res)
        else:  # list of rows
            outs.append(rows_to_block(list(res)))
    return [concat_blocks(outs)] if outs else [{}]


@ray_tpu_torch.remote
def _join_partition(on: list, right_on: list, how: str, suffixes: tuple,
                    n_left: int, *parts):
    lparts, rparts = parts[:n_left], parts[n_left:]
    lb = [b for p in lparts for b in _as_blocks(p) if BlockAccessor(b).num_rows()]
    rb = [b for p in rparts for b in _as_blocks(p) if BlockAccessor(b).num_rows()]
    left = concat_blocks(lb) if lb else {}
    right = concat_blocks(rb) if rb else {}
    ln = BlockAccessor(left).num_rows() if left else 0
    rn = BlockAccessor(right).num_rows() if right else 0

    lkeys = list(zip(*[np.asarray(left[k]) for k in on])) if ln else []
    rkeys = list(zip(*[np.asarray(right[k]) for k in right_on])) if rn else []
    rindex: dict = {}
    for i, k in enumerate(rkeys):
        rindex.setdefault(k, []).append(i)

    li_out: list[int] = []
    ri_out: list[int] = []   # -1 = no right match
    r_matched = np.zeros(rn, dtype=bool)
    for i, k in enumerate(lkeys):
        hits = rindex.get(k)
        if hits:
            for j in hits:
                li_out.append(i)
                ri_out.append(j)
                r_matched[j] = True
        elif how in ("left", "outer"):
            li_out.append(i)
            ri_out.append(-1)
    if how in ("right", "outer"):
        for j in np.nonzero(~r_matched)[0]:
            li_out.append(-1)
            ri_out.append(int(j))
    if not li_out:
        return [{}]
    li = np.asarray(li_out)
    ri = np.asarray(ri_out)

    ls, rs = suffixes
    lcols = list(left.keys()) if ln else []
    rcols = [c for c in (right.keys() if rn else []) if c not in right_on]
    out: Block = {}

    def gather(col_vals, idx, n_src):
        arr = np.asarray(col_vals)
        missing = idx < 0
        if not missing.any():
            return arr[idx]
        if arr.dtype.kind in "fiub":
            res = np.full(len(idx), np.nan, dtype=np.float64)
            res[~missing] = arr[idx[~missing]].astype(np.float64)
            return res
        res = np.empty(len(idx), dtype=object)
        res[~missing] = arr[idx[~missing]]
        return res

    # join keys: from the left side, falling back to the right for
    # right/outer rows with no left match
    for kl, kr in zip(on, right_on):
        kv = gather(left[kl], li, ln) if ln else None
        if how in ("right", "outer") and rn:
            rv = gather(right[kr], ri, rn)
            if kv is None:
                kv = rv
            else:
                miss = li < 0
                if miss.any():
                    kv = np.asarray(kv, dtype=object)
                    kv[miss] = np.asarray(rv, dtype=object)[miss]
        out[kl] = kv
    for c in lcols:
        if c in on:
            continue
        name = c + (ls if c in rcols else "")
        out[name] = gather(left[c], li, ln)
    for c in rcols:
        # suffix on ANY collision with an already-emitted left column —
        # including the join keys, which a right non-key column may shadow
        name = c + (rs if (c in lcols or c in on) else "")
        out[name] = gather(right[c], ri, rn)
    return [out]


def _dist_groupby_refs(keys: list, aggs_blob: bytes, map_groups: bool = False):
    def run(inputs: list) -> list:
        if not inputs:
            return []
        w = len(inputs)
        parts = [_normalize_parts(
            _split_hash.options(num_returns=w).remote(it, w, keys), w)
            for it in inputs]
        task = _map_groups_partition if map_groups else _agg_partition
        return [task.remote(keys, aggs_blob, *[p[j] for p in parts])
                for j in range(w)]

    return run


def _dist_join_refs(op):
    """op: logical.Join — the right plan executes to refs inside the stage
    (a barrier anyway), then both sides hash-shuffle into w partitions and
    one join task merges each."""

    def run(inputs: list) -> list:
        from ray_tpu_torch.data import logical as L

        right_stages = build_stages(L.optimize(op.right_last.chain()), 8)
        ex = StreamingExecutor(right_stages)
        right_refs = []
        try:
            for item in ex.execute():
                if not hasattr(item, "hex"):
                    item = ray_tpu_torch.put(item if isinstance(item, list) else [item])
                else:
                    ex.owned.discard(item.hex())  # ownership moves to this stage
                right_refs.append(item)
        finally:
            ex.release_owned()
        w = op.num_partitions or max(len(inputs), len(right_refs), 1)
        lparts = [_normalize_parts(
            _split_hash.options(num_returns=w).remote(it, w, op.on), w)
            for it in inputs]
        rparts = [_normalize_parts(
            _split_hash.options(num_returns=w).remote(it, w, op.right_on), w)
            for it in right_refs]
        return [_join_partition.remote(
            op.on, op.right_on, op.how, op.suffixes, len(lparts),
            *[p[j] for p in lparts], *[p[j] for p in rparts])
            for j in range(w)]

    return run


def _dist_shuffle_refs(seed):
    def run(inputs: list) -> list:
        if not inputs:
            return []
        w = len(inputs)
        parts = [_normalize_parts(
            _split_random.options(num_returns=w).remote(it, w, seed, i), w)
            for i, it in enumerate(inputs)]
        return [_merge_shuffled.remote(seed, j, *[p[j] for p in parts])
                for j in range(w)]

    return run


def _dist_sort_refs(key: str, descending: bool):
    def run(inputs: list) -> list:
        if not inputs:
            return []
        w = len(inputs)
        # sample pass → range boundaries (small arrays; fine on the
        # driver); the get rides lineage recovery like every barrier get
        samples = _robust_get(
            [_sample_keys.remote(it, key, 64) for it in inputs])
        allk = np.sort(np.concatenate([np.asarray(s) for s in samples])
                       if samples else np.asarray([]))
        if allk.size == 0 or w == 1:
            return [_merge_sorted.remote(key, descending, *inputs)]
        bounds = allk[[min(allk.size - 1, int(allk.size * j / w))
                       for j in range(1, w)]]
        parts = [_normalize_parts(
            _split_range.options(num_returns=w).remote(it, w, key, bounds), w)
            for it in inputs]
        out = [_merge_sorted.remote(key, descending, *[p[j] for p in parts])
               for j in range(w)]
        # global order = partition order; descending reverses partitions too
        return out[::-1] if descending else out

    return run


def _dist_repartition_refs(k: int):
    def run(inputs: list) -> list:
        if not inputs:
            return []
        counts = _robust_get([_rows_of.remote(it) for it in inputs])
        total = sum(counts)
        bounds = [round(total * (j + 1) / k) for j in range(k - 1)]
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).tolist()
        parts = [_normalize_parts(
            _split_offsets.options(num_returns=k).remote(it, k, int(starts[i]), bounds), k)
            for i, it in enumerate(inputs)]
        return [_merge_plain.remote(*[p[j] for p in parts]) for j in range(k)]

    return run


@ray_tpu_torch.remote
class _MapPoolActor:
    """Stateful map worker: holds the stage's transform chain (a callable-
    class UDF instantiates ONCE here) and applies it per input."""

    def __init__(self, transforms_blob: bytes):
        from ray_tpu_torch._private import serialization as ser

        self._run = _stage_task(ser.loads(transforms_blob))

    def run(self, payload):
        return self._run(payload)


class _ActorPool:
    """Least-loaded autoscaling pool exposing the task-API shape
    (`.remote(payload)`): dispatch routes to the actor with the fewest
    outstanding inputs, the pool grows toward max_size while every actor is
    backed up, and idle actors above min_size are released. The executor
    reports completions via note_done() (reference:
    execution/operators/actor_pool_map_operator.py:47 — load-based routing
    + pool autoscaling)."""

    IDLE_RELEASE_S = 10.0

    def __init__(self, stage: "Stage", size, min_size: int | None = None):
        from ray_tpu_torch._private import serialization as ser

        if isinstance(size, (tuple, list)):
            min_size, size = int(size[0]), int(size[1])
        self.min_size = max(1, int(min_size if min_size is not None else size))
        self.max_size = max(self.min_size, int(size))
        res = stage.resources
        blob = ser.dumps(stage.transforms)
        self._cls = _MapPoolActor.options(
            num_cpus=res.get("CPU", 1.0),
            num_gpus=res.get("GPU", 0.0) or None)
        self._blob = blob
        self._stage_name = stage.name
        self.actors = [self._cls.remote(blob) for _ in range(self.min_size)]
        self._outstanding: dict[str, int] = {}  # ref hex → actor index
        self._load = [0] * len(self.actors)
        self._idle_since = [time.monotonic()] * len(self.actors)
        cfg = RayConfig.instance()
        # lifetime dead-actor replacement budget (-1 = unlimited); FT off
        # pins it to 0 so a dead actor is dropped, never respawned
        self._restart_budget = (cfg.data_actor_restart_budget
                                if cfg.data_fault_tolerance else 0)
        self.replacements = 0

    def remote(self, payload):
        # grow whenever every live actor is already busy — the executor
        # caps total outstanding at max_size, so requiring a deeper backlog
        # would plateau the pool below the requested maximum
        if (len(self.actors) < self.max_size
                and self._load and min(self._load) >= 1):
            self.actors.append(self._cls.remote(self._blob))
            self._load.append(0)
            self._idle_since.append(time.monotonic())
        idx = min(range(len(self.actors)), key=lambda i: self._load[i])
        self._load[idx] += 1
        ref = self.actors[idx].run.remote(payload)
        self._outstanding[ref.hex()] = idx
        return ref

    def note_done(self, ref_hex: str) -> None:
        idx = self._outstanding.pop(ref_hex, None)
        if idx is None or idx >= len(self.actors):
            return
        self._load[idx] -= 1
        now = time.monotonic()
        if self._load[idx] == 0:
            self._idle_since[idx] = now
        # release ONE idle actor above min (newest first) per completion
        if len(self.actors) > self.min_size:
            for i in range(len(self.actors) - 1, self.min_size - 1, -1):
                if (self._load[i] == 0
                        and now - self._idle_since[i] > self.IDLE_RELEASE_S):
                    a = self.actors.pop(i)
                    self._load.pop(i)
                    self._idle_since.pop(i)
                    # reindex outstanding entries above i
                    for k, v in list(self._outstanding.items()):
                        if v > i:
                            self._outstanding[k] = v - 1
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:
                        pass
                    break

    def note_failed(self, ref_hex: str) -> tuple[list[str], int]:
        """A task this pool dispatched came back errored: release its
        slot, probe the actor that ran it, and if dead, replace it within
        the restart budget. Returns (orphaned ref hexes — the dead actor's
        OTHER in-flight tasks, for the executor to re-dispatch from its
        retained payloads — and how many actors were replaced)."""
        idx = self._outstanding.pop(ref_hex, None)
        if idx is None or idx >= len(self.actors):
            return [], 0
        self._load[idx] -= 1
        if self._load[idx] == 0:
            self._idle_since[idx] = time.monotonic()
        if not _actor_dead(self.actors[idx]):
            return [], 0  # plain task failure on a live actor
        return self._replace(idx)

    def _replace(self, idx: int) -> tuple[list[str], int]:
        orphans = [k for k, v in self._outstanding.items() if v == idx]
        for k in orphans:
            del self._outstanding[k]
        dead = self.actors.pop(idx)
        self._load.pop(idx)
        self._idle_since.pop(idx)
        for k, v in list(self._outstanding.items()):
            if v > idx:
                self._outstanding[k] = v - 1
        try:
            ray_tpu_torch.kill(dead)  # reap the corpse's GCS record
        except Exception:
            pass
        replaced = 0
        if self._restart_budget != 0:
            if self._restart_budget > 0:
                self._restart_budget -= 1
            self.actors.append(self._cls.remote(self._blob))
            self._load.append(0)
            self._idle_since.append(time.monotonic())
            self.replacements += 1
            replaced = 1
        if not self.actors:
            raise DataBlockError(
                f"map-actor pool for stage {self._stage_name!r} has no "
                f"survivors and its restart budget is exhausted",
                stage=self._stage_name, kind="system")
        return orphans, replaced

    def shutdown(self):
        for a in self.actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


_pipeline_seq = itertools.count(1)  # collision-free pipeline tags


def _pipeline_metrics() -> tuple:
    """Process-wide executor gauges/counters (concurrent executors share
    them, distinguished by a pipeline tag). Looked up in the registry at
    each executor's start (``get_or_create``), so a registry cleared in
    between gets them registered anew; the JAX package keeps them in a
    module-level cache, which a cleared registry leaves recording into
    metrics no snapshot shows."""
    from ray_tpu_torch.util import metrics as _met

    tag = ("pipeline",)
    return (
        _met.get_or_create(_met.Gauge, "ray_tpu_data_bytes_in_flight",
                           "queued bytes across executor stages",
                           tag_keys=tag),
        _met.get_or_create(_met.Gauge, "ray_tpu_data_blocks_queued",
                           "queued items across executor stages",
                           tag_keys=tag),
        _met.get_or_create(_met.Counter, "ray_tpu_data_backpressure_waits",
                           "dispatches deferred by queue/byte backpressure",
                           tag_keys=tag),
        _met.get_or_create(_met.Counter, "ray_tpu_data_block_retries_total",
                           "block tasks resubmitted after SYSTEM errors "
                           "(actor death / worker crash / lost object)",
                           tag_keys=tag),
        _met.get_or_create(_met.Counter,
                           "ray_tpu_data_actor_replacements_total",
                           "dead map-pool actors replaced by supervision",
                           tag_keys=tag),
        _met.get_or_create(_met.Counter, "ray_tpu_data_blocks_errored_total",
                           "blocks permanently errored by UDF raises "
                           "(skipped or surfaced per on_block_error)",
                           tag_keys=tag),
    )


class StreamingExecutor:
    """Pull-based streaming executor: yields lists of blocks as they finish.

    Backpressure: per-stage `max_in_flight` remote tasks + `max_queued`
    finished-but-unconsumed outputs; upstream dispatch stalls while a
    downstream queue is full.
    """

    def __init__(self, stages: list[Stage], *, max_queued: int = 16,
                 max_queued_bytes: int | None = None,
                 on_block_error: str | None = None,
                 max_errored_blocks: int | None = None, rng=None):
        self.stages = stages
        self.max_queued = max_queued
        cfg = RayConfig.instance()
        # APPLICATION-error policy (UDF raises): "raise" surfaces the
        # first errored block; "skip" drops-and-counts until
        # max_errored_blocks is exceeded (-1 = unlimited). SYSTEM errors
        # never consult either — they are retried, and only a retry
        # budget exhaustion raises.
        self.on_block_error = (on_block_error if on_block_error is not None
                               else cfg.data_on_block_error)
        if self.on_block_error not in ("raise", "skip"):
            raise ValueError(
                f"on_block_error must be 'raise' or 'skip', "
                f"got {self.on_block_error!r}")
        self.max_errored_blocks = (
            max_errored_blocks if max_errored_blocks is not None
            else cfg.data_max_errored_blocks)
        self._rng = rng if rng is not None else random.Random()
        self.errored_blocks = 0
        self.errored_block_ids: list = []
        # reservation-style memory backpressure (reference:
        # data/_internal/execution/resource_manager.py — operator output
        # budgets in BYTES, not just counts): dispatch into a queue stalls
        # while its object-store-resident bytes exceed the budget, so one
        # stage producing huge blocks cannot OOM the store no matter how
        # small max_queued is. Sizes come from the local store's metadata
        # (free for refs this driver produced); unknown sizes count 0, so
        # the byte gate degrades to the count gate, never deadlocks.
        import os as _os

        self.max_queued_bytes = (
            max_queued_bytes if max_queued_bytes is not None
            else int(_os.environ.get("RAY_TPU_TORCH_DATA_MAX_QUEUED_BYTES",
                                     256 << 20)))
        # refs produced by THIS execution (not caller-owned input refs); safe
        # to free once consumed — keeps streaming memory bounded instead of
        # pinning every block in the driver for the run's lifetime
        self.owned: set[str] = set()

    def _free_if_owned(self, item) -> None:
        if hasattr(item, "hex") and item.hex() in self.owned:
            self.owned.discard(item.hex())
            try:
                ray_tpu_torch.free([item])
            except Exception:  # noqa: BLE001 — cleanup must not kill the stream
                pass

    def release_owned(self) -> None:
        """Free every ref this execution still owns (idempotent).

        The teardown half of the owned-ref ledger: `execute()` calls it
        from its `finally` so an error or abandoned iteration never
        strands store segments, and consumers that construct an executor
        must call it on every path — graft_check's resource-leak pair
        (`StreamingExecutor` / `release_owned`) holds them to it."""
        if not self.owned:
            return
        from ray_tpu_torch._private.worker import ObjectRef

        refs = [ObjectRef(h) for h in self.owned]
        self.owned.clear()
        try:
            ray_tpu_torch.free(refs)
        except Exception:  # noqa: BLE001 — cleanup must not kill teardown
            pass

    def execute(self) -> Iterator[list]:
        """Yield ObjectRefs of list[Block] results of the final stage."""
        remote_cache: dict[int, Any] = {}
        actor_pools: list = []
        self._actor_pools = actor_pools  # introspection (chaos tests)

        def stage_remote(i: int, stage: Stage):
            if i not in remote_cache:
                res = stage.resources
                if stage.compute == "actors":
                    # stateful UDF pool (reference: ActorPoolMapOperator,
                    # execution/operators/actor_pool_map_operator.py:47):
                    # one actor per concurrency slot, round-robin dispatch
                    pool = _ActorPool(stage,
                                      size=stage.concurrency
                                      or stage.max_in_flight)
                    actor_pools.append(pool)
                    remote_cache[i] = pool
                else:
                    remote_cache[i] = ray_tpu_torch.remote(
                        num_cpus=res.get("CPU", 1.0),
                        num_gpus=res.get("GPU", 0.0) or None,
                    )(_stage_task(stage.transforms))
            return remote_cache[i]

        # Coalesce [source(+fused maps)] [a2a] [maps] ... into pipeline phases.
        first = self.stages[0]
        rest = self.stages[1:]

        source_payloads: collections.deque = collections.deque()
        if first.read_tasks is not None:
            source_payloads.extend(first.read_tasks)
            source_is_refs = False
        else:
            source_payloads.extend(first.input_refs or [])
            source_is_refs = True

        # state per downstream stage
        in_flight: list[dict] = [{} for _ in rest]  # ref -> None
        queues: list[collections.deque] = [collections.deque() for _ in range(len(rest) + 1)]
        src_in_flight: dict = {}

        # Submission-order sequence tags. Completions enter queues in
        # COMPLETION order (nondeterministic under load); map stages don't
        # care, but barrier stages salt their partition tasks by positional
        # index, so a reordered input list would silently change e.g. a
        # seeded random_shuffle's permutation. Tags flow through map stages
        # (the output ref inherits the input's tag) and barriers sort by
        # them before fanning out.
        import itertools as _it

        seq_counter = _it.count()
        seq_of: dict[str, int] = {}

        def _skey(item) -> str:
            return item.hex() if hasattr(item, "hex") else str(id(item))

        def _tag(item) -> None:
            seq_of[_skey(item)] = next(seq_counter)

        def _inherit(new_item, old_item) -> None:
            seq_of[_skey(new_item)] = seq_of.pop(_skey(old_item),
                                                 next(seq_counter))

        def _ordered(items):
            return sorted(items, key=lambda it: seq_of.get(_skey(it), 1 << 60))

        # byte accounting for the reservation-style backpressure: size
        # looked up ONCE at enqueue (local-store metadata for refs, block
        # sizes for materialized lists), remembered until dequeue
        qbytes = [0] * (len(rest) + 1)
        size_of: dict[str, int] = {}

        def _nbytes(item) -> int:
            if hasattr(item, "hex"):
                try:
                    from ray_tpu_torch._private.api import _get_worker

                    return _get_worker().store.size(item.hex())
                except Exception:  # remote/inline/unknown: count 0
                    return 0
            blocks = item if isinstance(item, list) else [item]
            try:
                return sum(BlockAccessor(b).size_bytes() for b in blocks)
            except Exception:
                return 0

        # pipeline observability on the cluster metrics plane (reference:
        # Data's dashboard metrics tab — operator bytes/queue gauges);
        # process-wide gauges tagged per pipeline, updated at the same
        # sites that maintain the byte accounting
        (m_bytes, m_blocks, m_bp, m_retries, m_replacements,
         m_errored) = _pipeline_metrics()
        pipeline_tag = {"pipeline": f"exec-{next(_pipeline_seq)}"}
        bp_blocked = [False] * (len(rest) + 1)  # per-queue deferral state
        # per-pipeline counter tallies, folded into the stable
        # {"pipeline": "_retired"} aggregate at teardown: cumulative
        # *_total counters must outlive the pipeline that earned them,
        # while the per-pipeline series still retires (bounded cardinality)
        tally = {"bp": 0.0, "retries": 0.0, "repl": 0.0, "errored": 0.0}

        # ---- fault handling state ----
        cfg = RayConfig.instance()
        ft_on = cfg.data_fault_tolerance
        max_retries = cfg.data_max_block_retries
        backoff_s = cfg.data_retry_backoff_s
        rng = self._rng
        # block id = the block's submission-order sequence tag, which
        # `_inherit` threads through every map stage — so the attempt
        # count follows the BLOCK, not any one task ref, and a poison
        # payload bouncing between replacement actors stays bounded
        attempts: dict[int, int] = {}
        retry_heap: list = []  # (due, tiebreak, stage idx | -1=source, item)
        retry_tick = _it.count()

        def _probe_ready(ready):
            """Split wait()-ready refs into (ok, [(ref, exc)])."""
            if not ft_on:
                return ready, []
            ok, bad = [], []
            for r in ready:
                exc = _ref_error(r)
                (ok.append(r) if exc is None else bad.append((r, exc)))
            return ok, bad

        def _drop_item(item) -> None:
            # forget a permanently-dead block's input: its tag must leave
            # seq_of or the ordered-emission min-live gate stalls forever
            seq_of.pop(_skey(item), None)
            size_of.pop(_skey(item), None)
            self._free_if_owned(item)

        def _handle_failure(stage_idx: int, stage_name: str, ref, item,
                            exc) -> None:
            """One dispatched block task came back errored: classify, then
            resubmit the retained input (SYSTEM, within budget), skip the
            block (APPLICATION under the skip policy), or raise."""
            _inherit(item, ref)  # the block id follows the input back
            bid = seq_of.get(_skey(item), -1)
            self.owned.discard(ref.hex())
            try:
                ray_tpu_torch.free([ref])
            except Exception:
                pass
            if _is_system_error(exc):
                done = attempts.get(bid, 0)
                if done < max_retries:
                    attempts[bid] = done + 1
                    tally["retries"] += 1
                    try:
                        m_retries.inc(tags=pipeline_tag)
                    except Exception:
                        pass
                    _emit_data_event(
                        const.EVENT_DATA_BLOCK_RETRY,
                        f"block {bid} stage {stage_name!r}: retry "
                        f"{done + 1}/{max_retries} after {type(exc).__name__}",
                        block_id=bid, stage=stage_name)
                    logger.warning(
                        "data: retrying block %s in stage %r "
                        "(attempt %d/%d) after %r",
                        bid, stage_name, done + 1, max_retries, exc)
                    heapq.heappush(
                        retry_heap,
                        (time.monotonic()
                         + _backoff_delay(done, backoff_s, rng),
                         next(retry_tick), stage_idx, item))
                    return
                _drop_item(item)
                raise DataBlockError(
                    f"block {bid} failed in stage {stage_name!r} after "
                    f"{done} retries: {exc!r}", block_id=bid,
                    stage=stage_name, kind="system") from exc
            # APPLICATION error (the UDF itself raised)
            if self.on_block_error == "skip":
                self.errored_blocks += 1
                self.errored_block_ids.append(bid)
                tally["errored"] += 1
                try:
                    m_errored.inc(tags=pipeline_tag)
                except Exception:
                    pass
                _emit_data_event(
                    const.EVENT_DATA_BLOCK_ERRORED,
                    f"block {bid} stage {stage_name!r} skipped: "
                    f"{type(exc).__name__}",
                    block_id=bid, stage=stage_name)
                logger.warning(
                    "data: skipping errored block %s in stage %r "
                    "(%d skipped so far): %r",
                    bid, stage_name, self.errored_blocks, exc)
                _drop_item(item)
                if 0 <= self.max_errored_blocks < self.errored_blocks:
                    raise DataBlockError(
                        f"{self.errored_blocks} errored blocks exceed "
                        f"max_errored_blocks={self.max_errored_blocks} "
                        f"(last: block {bid} in stage {stage_name!r}: "
                        f"{exc!r})", block_id=bid, stage=stage_name,
                        kind="application") from exc
                return
            _drop_item(item)
            raise DataBlockError(
                f"block {bid} failed in stage {stage_name!r}: UDF raised "
                f"{exc!r}", block_id=bid, stage=stage_name,
                kind="application") from exc

        def _note_replacements(pool, stage_name: str, n: int) -> None:
            if not n:
                return
            tally["repl"] += float(n)
            try:
                m_replacements.inc(float(n), tags=pipeline_tag)
            except Exception:
                pass
            _emit_data_event(
                const.EVENT_DATA_ACTOR_REPLACED,
                f"stage {stage_name!r}: replaced {n} dead map-pool "
                f"actor(s) ({pool.replacements} lifetime)",
                stage=stage_name)
            logger.warning(
                "data: replaced %d dead map-pool actor(s) in stage %r",
                n, stage_name)

        def _pending_retries_before(i: int) -> bool:
            # a pending retry for the source or any stage < i means the
            # barrier at i has NOT seen all of its input yet
            return any(entry[2] < i for entry in retry_heap)

        def _note_queues() -> None:
            try:
                m_bytes.set(float(sum(qbytes)), pipeline_tag)
                m_blocks.set(float(sum(len(dq) for dq in queues)),
                             pipeline_tag)
            except Exception:
                pass

        def _q_add(j: int, item) -> None:
            n = _nbytes(item)
            size_of[_skey(item)] = n
            qbytes[j] += n
            queues[j].append(item)
            _note_queues()

        def _q_pop(j: int):
            # min-tag-first: dispatching the oldest pending work bounds how
            # far ahead out-of-order completions can run (smaller ordered-
            # emission buffer, stragglers never starve behind newer items)
            # removal is by INDEX: deque.remove would compare payloads
            # with == (ambiguous for block lists holding numpy arrays).
            # Single O(n) enumerate pass — indexing a deque is O(n) itself.
            idx, item = min(enumerate(queues[j]),
                            key=lambda p: seq_of.get(_skey(p[1]), 1 << 60))
            del queues[j][idx]
            qbytes[j] -= size_of.pop(_skey(item), 0)
            _note_queues()
            return item

        def _q_clear(j: int) -> None:
            for item in queues[j]:
                key = _skey(item)
                size_of.pop(key, None)
                seq_of.pop(key, None)  # a leaked tag would stall ordered
                # emission at the consumer (min-live-tag gate) forever
            queues[j].clear()
            qbytes[j] = 0

        def _q_room(j: int) -> bool:
            # a queue feeding a BARRIER stage is exempt from both gates:
            # the barrier consumes only after upstream fully drains, so
            # capping its input (by count or bytes) deadlocks the pipeline
            # the moment the dataset outgrows the cap. Barrier inputs are
            # store-resident refs; accumulation is the design.
            if j < len(rest) and is_barrier(rest[j]):
                return True
            # the FINAL queue is also exempt: ordered emission holds items
            # until every smaller tag lands, so capping it deadlocks when
            # >= max_queued out-of-order results pile up ahead of one
            # straggler (the gate blocks the straggler's dispatch, the
            # ordering gate blocks emission). Min-tag-first dispatch below
            # keeps the out-of-order horizon small in practice.
            if j == len(queues) - 1:
                return True
            room = (len(queues[j]) < self.max_queued
                    and qbytes[j] < self.max_queued_bytes)
            # edge-triggered: count DEFERRAL EPISODES, not poll frequency —
            # the pump loop re-probes a full queue every tick, which would
            # otherwise inflate the counter at spin rate
            if not room and not bp_blocked[j]:
                bp_blocked[j] = True
                tally["bp"] += 1
                try:
                    m_bp.inc(tags=pipeline_tag)
                except Exception:
                    pass
            elif room:
                bp_blocked[j] = False
            return room

        def is_barrier(s: Stage) -> bool:
            return s.all_to_all is not None or s.a2a_refs is not None

        a2a_done = [False] * len(rest)

        def pump() -> None:
            # due retries re-enter the normal dispatch queues first: a
            # source payload returns to the head of the backlog, a map
            # input back to its stage queue (min-tag-first dispatch then
            # favors it — the retried block is the oldest pending work)
            if retry_heap:
                now = time.monotonic()
                deferred = []
                while retry_heap and retry_heap[0][0] <= now:
                    entry = heapq.heappop(retry_heap)
                    _, _, j, item = entry
                    if j < 0:
                        source_payloads.appendleft(item)
                    elif _q_room(j):
                        _q_add(j, item)
                    else:
                        # queue full: the retry stays parked on the heap
                        # (already due, so the next pump re-probes) rather
                        # than overshooting the max_queued/byte budgets —
                        # barrier gating and all_done() still see it pending
                        deferred.append(entry)
                for entry in deferred:
                    heapq.heappush(retry_heap, entry)

            # source dispatch
            while (source_payloads and len(src_in_flight) < first.max_in_flight
                   and _q_room(0)):
                payload = source_payloads.popleft()
                if source_is_refs and not first.transforms:
                    _tag(payload)
                    _q_add(0, payload)
                    continue
                fn = stage_remote(-1, first)
                ref = fn.remote(payload)
                # a retried payload already carries its block tag; fresh
                # payloads are tagged here, at first dispatch
                if _skey(payload) in seq_of:
                    _inherit(ref, payload)
                else:
                    _tag(ref)
                self.owned.add(ref.hex())
                # the payload is RETAINED while in flight: resubmission
                # after a SYSTEM failure needs it
                src_in_flight[ref.hex()] = (ref, payload)

            # poll source completions
            if src_in_flight:
                refs = [r for r, _ in src_in_flight.values()]
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
                ok, bad = _probe_ready(ready)
                for r in ok:
                    src_in_flight.pop(r.hex(), None)
                    _q_add(0, r)
                for r, exc in bad:
                    _, payload = src_in_flight.pop(r.hex())
                    _handle_failure(-1, first.name, r, payload, exc)

            # downstream stages
            for i, stage in enumerate(rest):
                if is_barrier(stage):
                    # barrier: wait until everything upstream drained —
                    # including blocks parked on the retry heap, which
                    # will re-enter an upstream queue when due
                    upstream_done = (not source_payloads and not src_in_flight
                                     and all(not f for f in in_flight[:i])
                                     and all(not queues[j] or j == i for j in range(i + 1))
                                     and not _pending_retries_before(i))
                    if a2a_done[i] or not upstream_done or not _upstream_a2a_done(i):
                        continue
                    inputs = _ordered(queues[i])
                    _q_clear(i)
                    if stage.a2a_refs is not None:
                        # distributed: hand refs to the partition/merge task
                        # graph; blocks never touch the driver
                        in_refs = []
                        for item in inputs:
                            if hasattr(item, "hex"):
                                in_refs.append(item)
                            else:
                                r = ray_tpu_torch.put(item if isinstance(item, list) else [item])
                                self.owned.add(r.hex())
                                in_refs.append(r)
                        for r in stage.a2a_refs(in_refs):
                            self.owned.add(r.hex())
                            _tag(r)
                            _q_add(i + 1, r)
                        # inputs: drop our handles only — the partition tasks
                        # hold them as deps; manual free here would race arg
                        # resolution. Auto-GC reclaims after the tasks finish.
                        for item in in_refs:
                            self.owned.discard(item.hex())
                    else:
                        blocks: list[Block] = []
                        for item in inputs:
                            # lineage-backed: a block whose only copy was
                            # lost is reconstructed inside the get
                            got = (_robust_get(item, rng=rng)
                                   if hasattr(item, "hex") else item)
                            blocks.extend(got if isinstance(got, list) else [got])
                            self._free_if_owned(item)
                        for out_blocks in stage.all_to_all(blocks):
                            _tag(out_blocks)
                            _q_add(i + 1, out_blocks)  # plain lists, not refs
                    a2a_done[i] = True
                    continue
                # map stage
                while (queues[i] and len(in_flight[i]) < stage.max_in_flight
                       and _q_room(i + 1)):
                    item = _q_pop(i)
                    fn = stage_remote(i, stage)
                    ref = fn.remote(item)
                    _inherit(ref, item)
                    self.owned.add(ref.hex())
                    in_flight[i][ref.hex()] = (ref, item)
                if in_flight[i]:
                    refs = [r for r, _ in in_flight[i].values()]
                    ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=0)
                    pool = remote_cache.get(i)
                    ok, bad = _probe_ready(ready)
                    for r in ok:
                        _, consumed = in_flight[i].pop(r.hex())
                        self._free_if_owned(consumed)
                        if hasattr(pool, "note_done"):
                            pool.note_done(r.hex())
                        _q_add(i + 1, r)
                    for r, exc in bad:
                        # default pop: a second failed task of the same dead
                        # actor may already have been handled as an orphan of
                        # the first — each failure is classified exactly once
                        entry = in_flight[i].pop(r.hex(), None)
                        if entry is None:
                            continue
                        _, item = entry
                        if hasattr(pool, "note_failed"):
                            # pool supervision: probe + replace the dead
                            # actor, then re-dispatch every OTHER payload
                            # it held from our retained inputs (each one
                            # consumes a retry attempt, so a poison
                            # payload cannot ping-pong forever)
                            orphans, replaced = pool.note_failed(r.hex())
                            _note_replacements(pool, stage.name, replaced)
                            for oh in orphans:
                                oe = in_flight[i].pop(oh, None)
                                if oe is not None:
                                    _handle_failure(
                                        i, stage.name, oe[0], oe[1],
                                        ActorDiedError(
                                            "map-pool actor died with "
                                            "this block in flight"))
                        _handle_failure(i, stage.name, r, item, exc)

        def _upstream_a2a_done(i):
            return all(a2a_done[j] for j, s in enumerate(rest[:i]) if is_barrier(s))

        def all_done() -> bool:
            return (not source_payloads and not src_in_flight and not retry_heap
                    and all(not f for f in in_flight)
                    and all(not q for q in queues[:-1])
                    and all(a2a_done[i] for i, s in enumerate(rest) if is_barrier(s)))

        def _pop_in_order():
            """Yieldable final items, SUBMISSION order (reference: Ray Data
            preserves block order end to end). An item may leave only when
            no smaller sequence tag is live anywhere upstream — tags are
            monotonic, future dispatches always tag higher, so the minimum
            live tag being ours proves nothing earlier can still arrive."""
            last = len(queues) - 1
            while queues[last]:
                min_live = min(seq_of.values(), default=None)
                # index-based removal: == on block payloads is unsafe;
                # single enumerate pass (deque indexing is O(n))
                idx, head = min(enumerate(queues[last]),
                                key=lambda p: seq_of.get(
                                    _skey(p[1]), 1 << 60))
                if (min_live is not None
                        and seq_of.get(_skey(head), 1 << 60) > min_live):
                    return  # something earlier is still in flight upstream
                del queues[last][idx]
                qbytes[last] -= size_of.pop(_skey(head), 0)
                seq_of.pop(_skey(head), None)
                _note_queues()
                yield head

        idle_spin = 0.0
        try:
            while True:
                pump()
                if queues[-1]:
                    emitted = False
                    for item in _pop_in_order():
                        emitted = True
                        yield item
                    if emitted:
                        idle_spin = 0.0
                        continue
                if all_done():
                    # defensive: flush any remaining final items in tag
                    # order — nothing upstream can produce anymore, so the
                    # min-live gate no longer applies
                    last = len(queues) - 1
                    for item in sorted(queues[last],
                                       key=lambda it: seq_of.get(
                                           _skey(it), 1 << 60)):
                        yield item
                    queues[last].clear()
                    return
                time.sleep(min(0.05, 0.001 + idle_spin))
                idle_spin = min(0.05, idle_spin + 0.002)
        finally:
            # retire this pipeline's labelsets once it stops (normal end,
            # consumer abandonment, or error) — stale series would both
            # mislead /metrics and accumulate one labelset per lifetime
            # pipeline in a long-lived driver. Counters first fold into a
            # stable {"pipeline": "_retired"} aggregate: a *_total counter
            # that vanished with its pipeline could never be scraped
            # reliably, while gauges are point-in-time and just retire.
            try:
                for met, key in ((m_bp, "bp"), (m_retries, "retries"),
                                 (m_replacements, "repl"),
                                 (m_errored, "errored")):
                    if tally[key]:
                        met.inc(tally[key], tags={"pipeline": "_retired"})
                m_bytes.remove(pipeline_tag)
                m_blocks.remove(pipeline_tag)
                m_bp.remove(pipeline_tag)
                m_retries.remove(pipeline_tag)
                m_replacements.remove(pipeline_tag)
                m_errored.remove(pipeline_tag)
            except Exception:
                pass
            for pool in actor_pools:
                pool.shutdown()
            # every exception/abandonment path releases the owned-ref
            # ledger — yielded-but-unconsumed and in-flight outputs never
            # strand store segments
            self.release_owned()


def iter_result_blocks(stages: list[Stage], **exec_opts) -> Iterator[Block]:
    """Execute and yield individual blocks (driver-side materialized)."""
    ex = StreamingExecutor(stages, **exec_opts)
    try:
        for item in ex.execute():
            got = (_robust_get(item, rng=ex._rng)
                   if hasattr(item, "hex") else item)
            ex._free_if_owned(item)
            if isinstance(got, list):
                yield from got
            else:
                yield got
    finally:
        ex.release_owned()
