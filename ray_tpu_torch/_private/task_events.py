"""Task/profile event buffering and chrome-trace timeline export.

Reference capability: workers emit ProfileEvents batched by TaskEventBuffer
to the GCS task-event store, exported by `ray timeline` as a chrome trace
(reference: src/ray/core_worker/profile_event.h,
src/ray/core_worker/task_event_buffer.h, src/ray/gcs/gcs_task_manager.h;
gated by RAY_CONFIG enable_timeline, ray_config_def.h:615).

Design: each process keeps a bounded buffer of timeline spans; the
CoreWorker's background flusher ships batches to the GCS piggybacked on the
refcount-delta channel, the GCS appends them to its task-event deque, and
``ray_tpu_torch timeline`` renders everything as chrome://tracing JSON
(one row per worker process).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from contextlib import contextmanager

from .ray_config import RayConfig

_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=10000)
_enabled: bool | None = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = RayConfig.instance().enable_timeline
        with _lock:
            _buffer.__init__(maxlen=RayConfig.instance().task_events_max)
    return _enabled


def emit(event: str, *, task_id: str = "", name: str = "",
         start: float | None = None, end: float | None = None,
         **extra) -> None:
    """Record one completed span (start/end in time.time() seconds)."""
    if not enabled():
        return
    rec = {"event": event, "task_id": task_id, "name": name,
           "pid": os.getpid(), "start": start, "end": end}
    if extra:
        rec.update(extra)
    with _lock:
        _buffer.append(rec)


@contextmanager
def span(event: str, *, task_id: str = "", name: str = "", **extra):
    if not enabled():
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        emit(event, task_id=task_id, name=name, start=t0, end=time.time(),
             **extra)


def drain() -> list:
    """Pop all buffered events (called by the worker's flush loop)."""
    with _lock:
        out = list(_buffer)
        _buffer.clear()
    return out


# ------------------------------------------------------- flight recorder

# In-process ring of the last N serve request summaries (always-on, unlike
# span sampling): a slow request can be explained after the fact without
# sampling luck. The worker flusher ships new entries to the GCS request
# log at the metrics cadence; the ring itself answers local inspection.
_req_lock = threading.Lock()
_req_ring: collections.deque | None = None
_req_seq = 0
_req_flushed_seq = 0


def _ring() -> collections.deque:
    global _req_ring
    if _req_ring is None:
        _req_ring = collections.deque(maxlen=max(
            1, RayConfig.instance().serve_flight_recorder_size))
    return _req_ring


def record_request(summary: dict) -> None:
    """Append one request summary ({request_id, path, phases, ...}) to the
    flight-recorder ring."""
    global _req_seq
    rec = dict(summary)
    rec.setdefault("pid", os.getpid())
    with _req_lock:
        _req_seq += 1
        rec["seq"] = _req_seq
        _ring().append(rec)


def recent_requests() -> list:
    """The ring's current contents, oldest first (local inspection/tests)."""
    with _req_lock:
        return [dict(r) for r in (_req_ring or ())]


def drain_request_log() -> list:
    """Entries recorded since the last drain that are STILL in the ring
    (older ones already rotated out — exactly the last-N semantics). Called
    by the worker's telemetry flusher."""
    global _req_flushed_seq
    with _req_lock:
        out = [dict(r) for r in (_req_ring or ())
               if r["seq"] > _req_flushed_seq]
        if out:
            _req_flushed_seq = out[-1]["seq"]
    return out


def reset_request_log() -> None:
    """Test helper: drop the ring so a new RayConfig size takes effect."""
    global _req_ring, _req_seq, _req_flushed_seq
    with _req_lock:
        _req_ring = None
        _req_seq = 0
        _req_flushed_seq = 0


def normalize_events(events: list) -> list:
    """Normalize GCS-side completion records (ts only) into zero-length
    spans so every export path renders them identically — the chrome-trace
    renderer drops events without start/end."""
    for ev in events:
        if "start" not in ev and "ts" in ev:
            ev["start"] = ev["ts"]
            ev["end"] = ev["ts"]
            # cluster events carry an etype; task completions don't
            ev.setdefault("event", ev.get("etype") or "task:done")
            if ev.get("etype"):
                ev.setdefault("name", ev["etype"])
            ev.setdefault("worker_id", ev.get("worker", ""))
    return events


def export_chrome_trace(events: list, filename: str,
                        worker_names: dict | None = None) -> None:
    """One exporter for CLI / dashboard / api.timeline: normalize + render
    + write."""
    with open(filename, "w") as f:
        f.write(to_chrome_trace(normalize_events(list(events)),
                                worker_names))


def worker_display_names(workers: list, actors: dict) -> dict:
    """wid → human label for timeline rows: actor workers are labeled with
    the actor's class/name from the GCS actor table instead of a bare
    pid/wid, so e.g. compiled-DAG exec-loop rows read as `Stage:my_actor`
    rather than an opaque id. `workers` is the list_workers RPC rows,
    `actors` the cluster_state actor map."""
    names: dict = {}
    for w in workers or ():
        aid = w.get("actor_id")
        if not aid:
            continue
        info = (actors or {}).get(aid) or {}
        cls = info.get("class") or "Actor"
        label = (f"{cls}:{info['name']}" if info.get("name")
                 else f"{cls}@{aid[:8]}")
        names[w["wid"]] = f"{label} (pid {w.get('pid')})"
    return names


def fetch_worker_names(rpc) -> dict:
    """worker_display_names over any GCS request/reply callable (driver
    worker, dashboard client, CLI client). Labels are decoration: any RPC
    failure yields {} rather than failing the export."""
    try:
        return worker_display_names(
            rpc({"type": "list_workers"}).get("workers", []),
            rpc({"type": "cluster_state"})["state"].get("actors", {}))
    except Exception:
        return {}


def to_chrome_trace(events: list, worker_names: dict | None = None) -> str:
    """Render GCS-collected events as chrome://tracing 'traceEvents' JSON.

    Rows: one per (worker-id, pid) — except compiled-DAG step spans, which
    carry a `dag_id` and are grouped under one row per DAG (tid = DAG node)
    so a pipeline's steps line up regardless of which worker ran them, and
    serve/PD request spans, which carry a `request_id` and group under one
    row per request (tid = emitting pid) so one request's cross-process
    phases line up as a timeline. Durations become complete ('X') events
    with microsecond timestamps, matching what chrome://tracing / Perfetto
    ingests from the reference's `ray timeline` output.
    """
    worker_names = worker_names or {}
    trace = []
    for ev in events:
        if ev.get("start") is None:
            continue
        wid = ev.get("worker_id", "") or str(ev.get("pid", 0))
        if ev.get("dag_id"):
            row = f"dag:{ev['dag_id']}"
            tid = ev.get("node") or ev.get("pid", 0)
        elif ev.get("request_id"):
            row = f"req:{ev['request_id']}"
            tid = ev.get("pid", 0)
        elif ev.get("etype"):
            # control-plane cluster events (node/actor/PG lifecycle): one
            # row per node so a node's control transitions line up next to
            # the task rows of the workers it hosted
            row = f"ctrl:{ev.get('node') or 'cluster'}"
            tid = ev["etype"]
        else:
            row = worker_names.get(wid, wid)
            tid = ev.get("pid", 0)
        trace.append({
            "name": ev.get("name") or ev.get("event", ""),
            "cat": ev.get("event", "task"),
            "ph": "X",
            "ts": ev["start"] * 1e6,
            "dur": max(0.0, ((ev.get("end") or ev["start"]) - ev["start"])) * 1e6,
            "pid": row,
            "tid": tid,
            "args": {k: v for k, v in ev.items()
                     if k not in ("start", "end", "name", "event", "pid")},
        })
    return json.dumps({"traceEvents": trace, "displayTimeUnit": "ms"})
