"""Filter expressions: one string both the executor and datasources
understand, so predicates can run as a batch filter OR be pushed into a
parquet read's row-group pruning.

Supported grammar (parsed with `ast`, never eval'd): AND-chains of
comparisons between a column name and a literal —
``"label >= 3 and split == 'train'"``; also ``in`` / ``not in`` with
list/tuple/set literals. This mirrors the subset pyarrow's
``filters=[(col, op, val), ...]`` accepts (reference capability:
data reads push predicates into parquet fragments,
python/ray/data/_internal/datasource/parquet_datasource.py).
"""

from __future__ import annotations

import ast
from typing import Any, Callable

import numpy as np

_OPS = {
    ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
    ast.Gt: ">", ast.GtE: ">=", ast.In: "in", ast.NotIn: "not in",
}


def parse_filter(expr: str) -> list[tuple[str, str, Any]]:
    """``"a > 3 and b == 'x'"`` → ``[("a", ">", 3), ("b", "==", "x")]``
    (pyarrow DNF conjunction). Raises ValueError on anything outside the
    grammar — filters never execute arbitrary code."""
    try:
        tree = ast.parse(expr, mode="eval").body
    except SyntaxError as e:
        raise ValueError(f"bad filter expression {expr!r}: {e}") from e
    out: list[tuple[str, str, Any]] = []
    _collect(tree, out, expr)
    return out


def _collect(node: ast.AST, out: list, expr: str) -> None:
    if isinstance(node, ast.BoolOp) and isinstance(node.op, ast.And):
        for v in node.values:
            _collect(v, out, expr)
        return
    if not isinstance(node, ast.Compare) or len(node.ops) != 1:
        raise ValueError(
            f"unsupported filter {expr!r}: only AND-chains of single "
            "comparisons (col <op> literal) are allowed")
    op_t = type(node.ops[0])
    if op_t not in _OPS:
        raise ValueError(f"unsupported operator in filter {expr!r}")
    left, right = node.left, node.comparators[0]
    col, lit, flipped = _classify(left, right, expr)
    op = _OPS[op_t]
    if flipped:
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if op in ("in", "not in"):
            raise ValueError(f"'in' needs the column on the left: {expr!r}")
    out.append((col, op, lit))


def _classify(left, right, expr):
    if isinstance(left, ast.Name):
        return left.id, _literal(right, expr), False
    if isinstance(right, ast.Name):
        return right.id, _literal(left, expr), True
    raise ValueError(f"filter {expr!r} needs a bare column name on one side")


def _literal(node, expr):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError) as e:
        raise ValueError(f"non-literal operand in filter {expr!r}") from e


def compile_predicate(expr: str) -> Callable[[dict], np.ndarray]:
    """Batch-level predicate: {col: array} → boolean mask. Used when the
    filter can't be pushed into the read (non-parquet source, or an op in
    between changed the rows)."""
    conj = parse_filter(expr)

    def mask(batch: dict) -> np.ndarray:
        m: np.ndarray | None = None
        for col, op, lit in conj:
            v = np.asarray(batch[col])
            if op == "==":
                part = v == lit
            elif op == "!=":
                part = v != lit
            elif op == "<":
                part = v < lit
            elif op == "<=":
                part = v <= lit
            elif op == ">":
                part = v > lit
            elif op == ">=":
                part = v >= lit
            elif op == "in":
                part = np.isin(v, list(lit))
            else:  # not in
                part = ~np.isin(v, list(lit))
            m = part if m is None else (m & part)
        if m is None:
            raise ValueError(f"empty filter {expr!r}")
        return m

    return mask
