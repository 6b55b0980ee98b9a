"""Blocks: the unit of data exchanged between dataset operators.

A block is a column-batch: `dict[str, np.ndarray | list]`. Simple rows are
normalized into an `{"item": ...}` column, matching the reference's treatment
of non-tabular data. Arrow tables interop via to_arrow/from_arrow.

(reference: python/ray/data/block.py — Block = Arrow/Pandas table; the
BlockAccessor idiom is mirrored here. We default to numpy-backed columns
because the consumers are device copies of tensors, not Arrow compute.)
"""

from __future__ import annotations

from typing import Any, Iterable, Iterator

import numpy as np

Block = dict  # dict[str, np.ndarray | list]

ITEM_COL = "item"


def _col_len(v) -> int:
    return len(v)


class BlockAccessor:
    """Uniform view over a block (reference: data/block.py BlockAccessor)."""

    def __init__(self, block: Block):
        self._b = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        if not self._b:
            return 0
        return _col_len(next(iter(self._b.values())))

    def size_bytes(self) -> int:
        total = 0
        for v in self._b.values():
            if isinstance(v, np.ndarray):
                total += v.nbytes
            else:
                total += sum(len(x) if isinstance(x, (bytes, str)) else 8 for x in v)
        return total

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self._b.items()}

    def iter_rows(self) -> Iterator[dict]:
        n = self.num_rows()
        keys = list(self._b.keys())
        for i in range(n):
            yield {k: self._b[k][i] for k in keys}

    def to_arrow(self):
        import pyarrow as pa

        return pa.table({k: list(v) if not isinstance(v, np.ndarray) else v
                         for k, v in self._b.items()})

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self._b)

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self._b.items()}

    def schema(self) -> dict[str, str]:
        out = {}
        for k, v in self._b.items():
            if isinstance(v, np.ndarray):
                out[k] = str(v.dtype)
            elif len(v):
                out[k] = type(v[0]).__name__
            else:
                out[k] = "unknown"
        return out


def normalize_block(data: Any) -> Block:
    """Coerce rows / arrays / tables into the canonical column-batch form."""
    if isinstance(data, dict):
        return data
    try:
        import pyarrow as pa

        if isinstance(data, pa.Table):
            return {name: data.column(name).to_numpy(zero_copy_only=False)
                    for name in data.column_names}
    except ImportError:
        pass
    try:
        import pandas as pd

        if isinstance(data, pd.DataFrame):
            return {c: data[c].to_numpy() for c in data.columns}
    except ImportError:
        pass
    if isinstance(data, np.ndarray):
        return {ITEM_COL: data}
    raise TypeError(f"cannot interpret {type(data)} as a block")


def rows_to_block(rows: Iterable[Any]) -> Block:
    rows = list(rows)
    if not rows:
        return {}
    if isinstance(rows[0], dict):
        # key UNION over all rows (first-seen order): a column appearing
        # only in later rows must not be silently dropped, and a row
        # missing a column fills with None instead of raising KeyError
        keys: dict = {}
        for r in rows:
            for k in r:
                keys.setdefault(k)
        out = {}
        for k in keys:
            vals = [r.get(k) for r in rows]
            try:
                out[k] = np.asarray(vals)
            except (ValueError, TypeError):
                out[k] = vals
        return out
    try:
        return {ITEM_COL: np.asarray(rows)}
    except (ValueError, TypeError):
        return {ITEM_COL: rows}


def concat_blocks(blocks: list[Block]) -> Block:
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
    if not blocks:
        return {}
    if len(blocks) == 1:
        return blocks[0]
    keys: dict = {}  # union across blocks, first-seen order
    for b in blocks:
        for k in b:
            keys.setdefault(k)
    out: Block = {}
    for k in keys:
        vals = [b[k] if k in b
                else [None] * BlockAccessor(b).num_rows() for b in blocks]
        if all(isinstance(v, np.ndarray) for v in vals):
            out[k] = np.concatenate(vals)
        else:
            merged: list = []
            for v in vals:
                merged.extend(list(v))
            out[k] = merged
    return out
