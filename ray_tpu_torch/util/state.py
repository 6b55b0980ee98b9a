"""Programmatic cluster-state API.

(reference: python/ray/util/state — ``list_actors``/``list_nodes``/
``list_tasks``/``list_objects``/``list_workers``/``list_placement_groups``
/``list_jobs`` + ``summarize_tasks``, the SDK twin of ``ray list ...``.
Here each call is one GCS RPC from the CURRENT driver's connection —
``ray_tpu_torch list`` (scripts/cli.py:86) reads the same tables out-of-process.)

Filters follow the reference's predicate tuples: ``[("state", "=",
"ALIVE")]`` with ``=``/``!=`` operators against the row dicts.
"""

from __future__ import annotations

import fnmatch
from typing import Any, List, Optional, Tuple


def _worker():
    from ray_tpu_torch._private.api import _get_worker

    return _get_worker()


def validate_filters(filters) -> None:
    for _key, op, _want in (filters or ()):
        if op not in ("=", "!="):
            raise ValueError(f"unsupported filter op {op!r} (use '=' '!=')")


def matches_filters(row: dict, filters) -> bool:
    """One row against the reference-style predicate tuples. Shared by the
    client-side `_apply` and the GCS's server-side list_objects filter, so
    the two planes can never disagree on semantics."""
    for key, op, want in (filters or ()):
        got = row.get(key)
        eq = (str(got) == str(want)
              or (isinstance(want, str) and "*" in want
                  and fnmatch.fnmatch(str(got), want)))
        if eq if op == "!=" else not eq:
            return False
    return True


def _apply(rows: list, filters, limit: int) -> list:
    validate_filters(filters)
    if filters:
        rows = [r for r in rows if matches_filters(r, filters)]
    # limit <= 0 means unbounded, matching the GCS list handlers — slicing
    # to [:0] would ship the whole table only to return nothing
    return rows[:limit] if limit > 0 else rows


def list_nodes(*, filters: Optional[List[Tuple]] = None,
               limit: int = 1000) -> list:
    return _apply(_worker().rpc({"type": "list_nodes"})["nodes"],
                  filters, limit)


def list_workers(*, filters: Optional[List[Tuple]] = None,
                 limit: int = 1000) -> list:
    return _apply(_worker().rpc({"type": "list_workers"})["workers"],
                  filters, limit)


def list_actors(*, filters: Optional[List[Tuple]] = None,
                limit: int = 1000) -> list:
    state = _worker().rpc({"type": "cluster_state"})["state"]
    rows = [{"actor_id": aid, **info}
            for aid, info in (state.get("actors") or {}).items()]
    return _apply(rows, filters, limit)


def list_placement_groups(*, filters: Optional[List[Tuple]] = None,
                          limit: int = 1000) -> list:
    table = _worker().rpc({"type": "pg_table"})["table"]
    rows = [{"placement_group_id": k, **v} for k, v in table.items()]
    return _apply(rows, filters, limit)


def list_tasks(*, filters: Optional[List[Tuple]] = None,
               limit: int = 1000) -> list:
    rows = _worker().rpc({"type": "task_events"}).get("events", [])
    return _apply(rows, filters, limit)


def list_objects(*, filters: Optional[List[Tuple]] = None,
                 limit: int = 1000) -> list:
    # filters are pushed SERVER-side (the GCS applies matches_filters
    # before its limit cut): applying the limit before the filters would
    # return fewer than `limit` matching rows while more matches exist,
    # and fetching the whole table instead would marshal every object row
    # under the GCS lock
    validate_filters(filters)
    rows = _worker().rpc({
        "type": "list_objects", "limit": limit,
        "filters": [list(f) for f in (filters or ())],
    }).get("objects", [])
    return _apply(rows, filters, limit)


def list_jobs(*, filters: Optional[List[Tuple]] = None,
              limit: int = 1000) -> list:
    import json as _json

    w = _worker()
    keys = w.rpc({"type": "kv_keys", "prefix": "job:"})["keys"]
    rows = []
    for k in keys:
        v = w.rpc({"type": "kv_get", "key": k}).get("value")
        if not v:
            continue
        try:
            rows.append(_json.loads(v) if isinstance(v, (str, bytes)) else v)
        except (ValueError, TypeError):
            pass
    return _apply(rows, filters, limit)


def summarize_task_events(events: list) -> dict:
    """Aggregate raw task events into per-name counts/failures/time —
    shared by the in-process API below and the out-of-process
    ``ray_tpu_torch summary`` CLI."""
    summary: dict = {}
    for e in events:
        if e.get("event") and e["event"] != "task:execute":
            continue
        name = e.get("name") or "(unnamed)"
        rec = summary.setdefault(name, {"count": 0, "failed": 0,
                                        "total_s": 0.0})
        rec["count"] += 1
        if e.get("ok") is False or e.get("error"):
            rec["failed"] += 1
        if e.get("start") and e.get("end"):
            rec["total_s"] += e["end"] - e["start"]
    for rec in summary.values():
        rec["total_s"] = round(rec["total_s"], 4)
    return summary


def summarize_tasks() -> dict:
    """Counts per (name, kind, ok) over the retained task-event window
    (reference: ``ray summary tasks`` / summarize_tasks)."""
    return summarize_task_events(
        _worker().rpc({"type": "task_events"}).get("events", []))


def list_compiled_dags(*, filters: Optional[List[Tuple]] = None,
                       limit: int = 1000) -> list:
    """Compiled DAGs currently registered in the GCS (registered at
    `experimental_compile`, deregistered at `teardown()` / driver death).
    Rows carry plane ("channels"/"submit"), fallback_reason, nodes, actors,
    and channel topology."""
    rows = _worker().rpc({"type": "dag_list"}).get("dags", [])
    return _apply(rows, filters, limit)


def summarize_dag_metrics(snapshot: dict, dag_id: str) -> dict:
    """Per-node step-phase stats for one DAG, from a GCS metrics snapshot
    ({name: {kind, series: {source: [(tags, hist_state)]}}}). Pure — shared
    by the in-process API below and the out-of-process `ray_tpu_torch dag` CLI."""
    out: dict = {}
    for name, rec in snapshot.items():
        if not name.startswith("ray_tpu_dag_step_") or rec.get(
                "kind") != "histogram":
            continue
        phase = name[len("ray_tpu_dag_step_"):].rsplit("_seconds", 1)[0]
        for series in (rec.get("series") or {}).values():
            for tags, st in series:
                td = {k: v for k, v in (tuple(t) for t in tags)}
                if td.get("dag_id") != dag_id:
                    continue
                node = out.setdefault(td.get("node", "?"), {})
                agg = node.setdefault(phase, {"count": 0, "total_s": 0.0})
                agg["count"] += st.get("count", 0)
                agg["total_s"] += st.get("sum", 0.0)
    for node in out.values():
        for agg in node.values():
            agg["mean_s"] = round(
                agg["total_s"] / agg["count"], 9) if agg["count"] else 0.0
            agg["total_s"] = round(agg["total_s"], 6)
    return out


def summarize_dag(dag_id: str) -> Optional[dict]:
    """One DAG's registry record plus per-node step-phase timing aggregated
    from the always-on `ray_tpu_dag_step_*` histograms."""
    for rec in list_compiled_dags(filters=[("dag_id", "=", dag_id)], limit=1):
        snap = _worker().rpc({"type": "metrics_snapshot"}).get("metrics", {})
        return {"dag": rec, "steps": summarize_dag_metrics(snap, dag_id)}
    return None


def list_requests(*, filters: Optional[List[Tuple]] = None,
                  limit: int = 1000) -> list:
    """The serve flight-recorder log: recent request summaries (request_id,
    path, component, duration_s, per-phase seconds) shipped to the GCS by
    every serving process. Answers "what did the last N requests cost"
    without span-sampling luck."""
    rows = _worker().rpc({"type": "list_requests"}).get("requests", [])
    return _apply(rows, filters, limit)


def list_events(*, filters: Optional[List[Tuple]] = None, limit: int = 1000,
                severity: str = "", etype: str = "", node: str = "",
                after_seq: int = 0) -> list:
    """The structured cluster event log (node/actor/PG lifecycle,
    autoscaler transitions, serve reconciles, train attempts). severity is
    a MINIMUM bound ("WARNING" → WARNING+ERROR); etype/node are exact
    matches; after_seq is the follow-mode watermark. All four (plus the
    limit) are applied SERVER-side against the GCS ring — the reference-
    style predicate `filters` then refine client-side."""
    rows = _worker().rpc({
        "type": "list_events", "limit": limit, "severity": severity,
        "etype": etype, "node": node, "after_seq": after_seq,
    }).get("events", [])
    return _apply(rows, filters, limit)


def explain(target: str) -> dict:
    """Why is this actor/placement-group pending? Returns the scheduler's
    decision trace (queue wait, attempts, chosen node) and — while the
    target is pending — the live per-node rejection table naming each
    node's blocking reason (resources/label/affinity/draining)."""
    return _worker().rpc({"type": "sched_explain", "target": target})


def get_request_trace(request_id: str) -> Optional[dict]:
    """The sampled span tree for one serve request (trace id == request
    id), or None when that request wasn't sampled — fall back to
    :func:`list_requests` for its flight-recorder summary."""
    from ray_tpu_torch.util import tracing

    return tracing.get_trace(request_id)


def get_actor(actor_id: str) -> Optional[dict]:
    for row in list_actors(filters=[("actor_id", "=", actor_id)], limit=1):
        return row
    return None


def get_node(node_id: str) -> Optional[dict]:
    for row in list_nodes(filters=[("node_id", "=", node_id)], limit=1):
        return row
    return None


__all__ = [
    "explain",
    "get_actor", "get_node", "get_request_trace", "list_actors",
    "list_compiled_dags", "list_events",
    "list_jobs", "list_nodes", "list_objects", "list_placement_groups",
    "list_requests",
    "list_tasks", "list_workers", "summarize_dag", "summarize_dag_metrics",
    "summarize_task_events", "summarize_tasks",
]
