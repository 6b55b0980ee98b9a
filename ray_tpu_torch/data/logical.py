"""Logical plan: lazy operator DAG + rewrite rules.

(reference: python/ray/data/_internal/logical/operators/* for the op
vocabulary and _internal/logical/rules/{operator_fusion,limit_pushdown}.py
for the rules mirrored here.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ray_tpu_torch.data.datasource import Datasource


class LogicalOp:
    input: "LogicalOp | None" = None

    def chain(self) -> list["LogicalOp"]:
        ops: list[LogicalOp] = []
        cur: LogicalOp | None = self
        while cur is not None:
            ops.append(cur)
            cur = cur.input
        return list(reversed(ops))


@dataclass
class Read(LogicalOp):
    datasource: Datasource
    parallelism: int = -1
    input: LogicalOp | None = None
    limit: int | None = None  # pushed-down row cap


@dataclass
class InputBlocks(LogicalOp):
    """Pre-materialized blocks (from_blocks / from_pandas / union output)."""

    refs: list = field(default_factory=list)
    input: LogicalOp | None = None


@dataclass
class MapBatches(LogicalOp):
    fn: Callable
    input: LogicalOp | None = None
    batch_size: int | None = None
    fn_kwargs: dict = field(default_factory=dict)
    compute: str = "tasks"  # "tasks" | "actors"
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    concurrency: int | None = None
    batch_format: str = "numpy"


@dataclass
class MapRows(LogicalOp):
    fn: Callable
    input: LogicalOp | None = None
    kind: str = "map"  # map | filter | flat_map


@dataclass
class Project(LogicalOp):
    """Column selection — pushes into columnar reads as IO pruning.
    (reference: _internal/logical/rules/projection_pushdown.py)"""

    cols: list = field(default_factory=list)
    input: LogicalOp | None = None


@dataclass
class FilterExpr(LogicalOp):
    """Expression filter (see data/expressions.py) — pushes into parquet
    reads as row-group pruning when directly above the Read."""

    expr: str = ""
    input: LogicalOp | None = None


@dataclass
class Limit(LogicalOp):
    n: int
    input: LogicalOp | None = None


@dataclass
class Repartition(LogicalOp):
    num_blocks: int
    input: LogicalOp | None = None


@dataclass
class RandomShuffle(LogicalOp):
    seed: int | None = None
    input: LogicalOp | None = None


@dataclass
class Sort(LogicalOp):
    key: str
    descending: bool = False
    input: LogicalOp | None = None


@dataclass
class Union(LogicalOp):
    others: list = field(default_factory=list)  # list[LogicalOp]
    input: LogicalOp | None = None


@dataclass
class GroupByAgg(LogicalOp):
    """Hash-shuffle by key columns, then aggregate each partition.
    (reference: data/grouped_data.py:23 + hash_shuffle.py)"""

    keys: list = field(default_factory=list)   # list[str]
    aggs: list = field(default_factory=list)   # list[AggregateFn]
    input: LogicalOp | None = None


@dataclass
class MapGroups(LogicalOp):
    """Hash-shuffle by key columns, then apply fn per group."""

    keys: list = field(default_factory=list)
    fn: Callable = None
    input: LogicalOp | None = None
    batch_format: str = "numpy"


@dataclass
class Join(LogicalOp):
    """Distributed hash join against another dataset's plan.
    (reference: data/_internal/execution/operators/join.py:54)"""

    right_last: LogicalOp = None               # other dataset's plan tail
    on: list = field(default_factory=list)     # left key columns
    right_on: list = field(default_factory=list)
    how: str = "inner"                         # inner | left | right | outer
    suffixes: tuple = ("", "_r")
    num_partitions: int | None = None
    input: LogicalOp | None = None


# ----------------------------------------------------------------- optimizer


def apply_limit_pushdown(ops: list[LogicalOp]) -> list[LogicalOp]:
    """Move a Limit below strictly row-preserving ops (MapRows kind="map"
    only — map_batches/filter/flat_map may change row counts) and into Read
    as a row cap. (reference: _internal/logical/rules/limit_pushdown.py)"""
    out = list(ops)
    changed = True
    while changed:
        changed = False
        for i in range(1, len(out)):
            if isinstance(out[i], Limit):
                prev = out[i - 1]
                if isinstance(prev, MapRows) and prev.kind == "map":
                    out[i - 1], out[i] = out[i], out[i - 1]
                    changed = True
                elif isinstance(prev, Read) and prev.limit is None:
                    prev.limit = out[i].n
                    # keep the Limit too: reads are per-task capped, the
                    # executor still needs the global cut
    return out


def apply_projection_pushdown(ops: list[LogicalOp]) -> list[LogicalOp]:
    """Project directly above a projection-capable Read becomes IO column
    pruning; the Project op disappears. Consecutive Projects collapse to
    the outermost (it sees only what earlier ones kept).
    (reference: _internal/logical/rules/projection_pushdown.py)"""
    import copy

    out = list(ops)
    i = 1
    while i < len(out):
        op = out[i]
        prev = out[i - 1]
        if (isinstance(op, Project) and isinstance(prev, Read)
                and getattr(prev.datasource, "supports_projection", False)
                and prev.datasource.columns is None):
            # plans share datasource objects across sibling datasets:
            # mutate a copy, not the original
            ds = copy.copy(prev.datasource)
            ds.columns = list(op.cols)
            prev.datasource = ds
            out.pop(i)
            continue
        if (isinstance(op, Project) and isinstance(prev, Project)
                and set(op.cols) <= set(prev.cols)):
            # collapse only when the outer projection is a subset — an
            # outer col the inner already dropped must still KeyError at
            # runtime, not silently resurrect from the source
            out.pop(i - 1)
            continue
        i += 1
    return out


def apply_predicate_pushdown(ops: list[LogicalOp]) -> list[LogicalOp]:
    """FilterExpr directly above a predicate-capable Read prunes row
    groups at the IO layer instead of running as a stage."""
    import copy

    from ray_tpu_torch.data.expressions import parse_filter

    out = list(ops)
    i = 1
    while i < len(out):
        op = out[i]
        prev = out[i - 1]
        if (isinstance(op, FilterExpr) and isinstance(prev, Read)
                and getattr(prev.datasource, "supports_predicates", False)):
            conj = parse_filter(op.expr)
            cols = prev.datasource.columns
            if cols is not None and not all(c in cols for c in
                                            (t[0] for t in conj)):
                # a projection already dropped a filter column: keep the
                # stage so the user still sees the KeyError they wrote
                i += 1
                continue
            ds = copy.copy(prev.datasource)
            ds.filters = (list(ds.filters) + conj) if ds.filters else conj
            prev.datasource = ds
            out.pop(i)
            continue
        i += 1
    return out


def optimize(ops: list[LogicalOp]) -> list[LogicalOp]:
    # operate on copies: plans are shared between sibling datasets derived
    # from the same source, and rules mutate ops (e.g. Read.limit)
    import copy

    out = [copy.copy(op) for op in ops]
    # pushdowns can unlock each other (a pushed filter makes a Project
    # adjacent to the Read and vice versa): iterate to fixpoint
    while True:
        n = len(out)
        out = apply_projection_pushdown(out)
        out = apply_predicate_pushdown(out)
        if len(out) == n:
            break
    return apply_limit_pushdown(out)
