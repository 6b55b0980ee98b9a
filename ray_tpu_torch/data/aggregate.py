"""Aggregation functions for Dataset.groupby.

Vectorized over sorted groups: the reduce task sorts its hash partition by
the group keys once, then every aggregator computes all its groups with one
`ufunc.reduceat` pass (host friendly: numpy, no per-row Python).

(reference: python/ray/data/aggregate.py — Count/Sum/Min/Max/Mean/Std/
AbsMax/Quantile/Unique over grouped data, python/ray/data/grouped_data.py:23.)
"""

from __future__ import annotations

import numpy as np


class AggregateFn:
    """Base aggregator. `on` is the input column (None = whole row count).
    Subclasses implement `compute(col, starts, counts)` returning one value
    per group; `col` is the column sorted in group order."""

    name = "agg"

    def __init__(self, on: str | None = None, alias_name: str | None = None):
        self.on = on
        self.alias = alias_name or (f"{self.name}({on})" if on else f"{self.name}()")

    def compute(self, col: np.ndarray, starts: np.ndarray,
                counts: np.ndarray):
        raise NotImplementedError


class Count(AggregateFn):
    name = "count"

    def compute(self, col, starts, counts):
        return counts


class Sum(AggregateFn):
    name = "sum"

    def compute(self, col, starts, counts):
        return np.add.reduceat(col, starts)


class Min(AggregateFn):
    name = "min"

    def compute(self, col, starts, counts):
        return np.minimum.reduceat(col, starts)


class Max(AggregateFn):
    name = "max"

    def compute(self, col, starts, counts):
        return np.maximum.reduceat(col, starts)


class AbsMax(AggregateFn):
    name = "abs_max"

    def compute(self, col, starts, counts):
        return np.maximum.reduceat(np.abs(col), starts)


class Mean(AggregateFn):
    name = "mean"

    def compute(self, col, starts, counts):
        return np.add.reduceat(col, starts) / counts


class Std(AggregateFn):
    name = "std"

    def __init__(self, on: str | None = None, ddof: int = 1,
                 alias_name: str | None = None):
        super().__init__(on, alias_name)
        self.ddof = ddof

    def compute(self, col, starts, counts):
        col = col.astype(np.float64, copy=False)
        s = np.add.reduceat(col, starts)
        ss = np.add.reduceat(col * col, starts)
        var = (ss - s * s / counts) / np.maximum(counts - self.ddof, 1)
        var = np.maximum(var, 0.0)  # numeric noise can go slightly negative
        out = np.sqrt(var)
        return np.where(counts > self.ddof, out, np.nan)


class Quantile(AggregateFn):
    name = "quantile"

    def __init__(self, on: str | None = None, q: float = 0.5,
                 alias_name: str | None = None):
        super().__init__(on, alias_name)
        self.q = q

    def compute(self, col, starts, counts):
        ends = np.concatenate([starts[1:], [len(col)]])
        return np.asarray([np.quantile(col[s:e], self.q)
                           for s, e in zip(starts, ends)])


class Unique(AggregateFn):
    name = "unique"

    def compute(self, col, starts, counts):
        ends = np.concatenate([starts[1:], [len(col)]])
        return [np.unique(col[s:e]) for s, e in zip(starts, ends)]
