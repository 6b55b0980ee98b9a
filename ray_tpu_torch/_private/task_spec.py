"""Typed task/actor/placement-group specifications.

(reference: src/ray/common/task/task_spec.h — TaskSpecification wraps the
wire message with typed accessors and VALIDATES at construction, so a
malformed submission fails at the caller with a clear error instead of
surfacing as a scheduler crash three hops later. The wire format here
stays the framed-protocol dict — these dataclasses are the typed front:
`validate_*` runs at the submission boundary, and the dataclass views give
tooling a stable schema for introspection.)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from ray_tpu_torch._private.constants import EXEC_LOOP_METHOD  # noqa: F401 — re-export:
# the exec-loop method name moved to the shared constants module; existing
# importers (worker.py, dag/channel_execution.py historical sites) keep
# resolving it from here.

VALID_STRATEGY_KINDS = ("pg", "node_affinity", "node_label")
_MAX_NAME = 512


class SpecError(ValueError):
    """A malformed submission, reported at the caller."""


def _check_resources(res: Any, where: str) -> None:
    if res is None:
        return
    if not isinstance(res, dict):
        raise SpecError(f"{where}: resources must be a dict, got "
                        f"{type(res).__name__}")
    for k, v in res.items():
        if not isinstance(k, str) or not k:
            raise SpecError(f"{where}: resource names must be non-empty "
                            f"strings, got {k!r}")
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise SpecError(f"{where}: resource {k!r} must be numeric, got "
                            f"{type(v).__name__}")
        if not math.isfinite(v):
            # NaN/inf would survive `v < 0` (False for NaN) and then blow
            # up inside the GCS fixed-point quantization under the
            # scheduler lock — the exact crash this boundary exists to stop.
            raise SpecError(f"{where}: resource {k!r} must be finite, got {v}")
        if v < 0:
            raise SpecError(f"{where}: resource {k!r} is negative ({v})")
        if k == "GPU" and float(v) != int(v) and v > 1:
            raise SpecError(f"{where}: accelerator {k!r} must be fractional "
                            f"<= 1 or a whole number, got {v}")


def _check_strategy(strategy: Any, where: str) -> None:
    if strategy is None:
        return
    if not isinstance(strategy, dict) or "kind" not in strategy:
        raise SpecError(f"{where}: strategy must be a dict with a 'kind'")
    kind = strategy["kind"]
    if kind not in VALID_STRATEGY_KINDS:
        raise SpecError(f"{where}: unknown strategy kind {kind!r} "
                        f"(valid: {VALID_STRATEGY_KINDS})")
    if kind == "pg":
        if not strategy.get("pg_id"):
            raise SpecError(f"{where}: pg strategy needs pg_id")
        b = strategy.get("bundle", -1)
        if not isinstance(b, int) or b < -1:
            raise SpecError(f"{where}: pg bundle index must be an int >= -1")
    if kind == "node_affinity" and not strategy.get("node_id"):
        raise SpecError(f"{where}: node_affinity strategy needs node_id")
    if kind == "node_label":
        hard = strategy.get("hard", {})
        if not isinstance(hard, dict):
            raise SpecError(f"{where}: node_label 'hard' must be a dict")


def _check_common(spec: dict, where: str) -> None:
    if not spec.get("task_id"):
        raise SpecError(f"{where}: missing task_id")
    name = spec.get("name")
    if name is not None and (not isinstance(name, str)
                             or len(name) > _MAX_NAME):
        raise SpecError(f"{where}: name must be a string under "
                        f"{_MAX_NAME} chars")
    _check_resources(spec.get("resources"), where)
    _check_strategy(spec.get("strategy"), where)


def validate_task(spec: dict) -> dict:
    """Validate a task submission dict; returns it unchanged on success."""
    where = f"task {spec.get('name') or spec.get('task_id')}"
    _check_common(spec, where)
    nr = spec.get("num_returns", 1)
    if nr != "streaming" and (not isinstance(nr, int) or nr < 0):
        raise SpecError(f"{where}: num_returns must be an int >= 0 or "
                        f"'streaming', got {nr!r}")
    mr = spec.get("max_retries", 0)
    if not isinstance(mr, int) or mr < -1:
        raise SpecError(f"{where}: max_retries must be an int >= -1")
    if not isinstance(spec.get("deps", []), (list, tuple)):
        raise SpecError(f"{where}: deps must be a list")
    return spec


def validate_actor(spec: dict) -> dict:
    where = f"actor {spec.get('name') or spec.get('actor_id')}"
    _check_common(spec, where)
    if not spec.get("actor_id"):
        raise SpecError(f"{where}: missing actor_id")
    mr = spec.get("max_restarts", 0)
    if not isinstance(mr, int) or mr < -1:
        raise SpecError(f"{where}: max_restarts must be an int >= -1")
    mtr = spec.get("max_task_retries", 0)
    if not isinstance(mtr, int) or mtr < -1:
        raise SpecError(f"{where}: max_task_retries must be an int >= -1")
    mc = spec.get("max_concurrency", 1)
    if not isinstance(mc, int) or mc < 1:
        raise SpecError(f"{where}: max_concurrency must be an int >= 1")
    return spec


def validate_pg(spec: dict) -> dict:
    where = f"placement group {spec.get('name') or spec.get('pg_id')}"
    if not spec.get("pg_id"):
        raise SpecError(f"{where}: missing pg_id")
    bundles = spec.get("bundles")
    if not isinstance(bundles, (list, tuple)) or not bundles:
        raise SpecError(f"{where}: bundles must be a non-empty list")
    for i, b in enumerate(bundles):
        _check_resources(b, f"{where} bundle[{i}]")
        if not b:
            raise SpecError(f"{where}: bundle[{i}] is empty")
    from ray_tpu_torch._private.pg_policy import STRATEGIES

    strat = spec.get("strategy", "PACK")
    if strat not in STRATEGIES:
        raise SpecError(f"{where}: unknown PG strategy {strat!r} "
                        f"(valid: {sorted(STRATEGIES)})")
    return spec


# --------------------------------------------------------- dataclass views


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Typed read view over a task wire dict."""

    task_id: str
    name: str | None
    resources: dict
    num_returns: int | str
    max_retries: int
    deps: tuple
    strategy: dict | None
    language: str
    runtime_env_hash: str

    @classmethod
    def from_wire(cls, spec: dict) -> "TaskSpec":
        validate_task(spec)
        return cls(task_id=spec["task_id"], name=spec.get("name"),
                   resources=dict(spec.get("resources") or {}),
                   num_returns=spec.get("num_returns", 1),
                   max_retries=spec.get("max_retries", 0),
                   deps=tuple(spec.get("deps") or ()),
                   strategy=spec.get("strategy"),
                   language=spec.get("lang", "py"),
                   runtime_env_hash=spec.get("renv_hash", ""))


@dataclasses.dataclass(frozen=True)
class ActorSpec:
    actor_id: str
    name: str | None
    resources: dict
    max_restarts: int
    max_task_retries: int
    max_concurrency: int
    strategy: dict | None

    @classmethod
    def from_wire(cls, spec: dict) -> "ActorSpec":
        validate_actor(spec)
        return cls(actor_id=spec["actor_id"], name=spec.get("name"),
                   resources=dict(spec.get("resources") or {}),
                   max_restarts=spec.get("max_restarts", 0),
                   max_task_retries=spec.get("max_task_retries", 0),
                   max_concurrency=spec.get("max_concurrency", 1),
                   strategy=spec.get("strategy"))
