"""Structured cluster event log — producer-side buffering + shared filters.

Reference capability: the reference's export API / cluster event log
(python/ray/_private/event/, src/ray/gcs/gcs_server — node/actor/PG
lifecycle transitions recorded as typed events readable from the state
API) that makes "why is my actor pending" answerable from the control
store rather than from log spelunking (Ray, arXiv 1712.05889: the control
store is the debuggability backbone).

Design mirrors the task-event plane (task_events.py): each producer
process keeps a bounded ring of typed, severity-tagged event records;
drain() hands the not-yet-flushed suffix to the CoreWorker telemetry
flusher (drain-once, sequence-gated — same discipline as the flight
recorder), which ships batches to the GCS on the `cluster_events_report`
RPC. The GCS keeps its own ring (plus the sqlite `events` table for INFO+
so events survive a GCS restart) and answers `list_events` with the
server-side filtering implemented here.

Event-type / severity / field-name strings are wire protocol and live in
_private/constants.py; the `event-type-literal` graft_check forbids
re-spelled type literals at emit_event() call sites outside that module.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Optional

from . import constants as const
from .ray_config import RayConfig

_lock = threading.Lock()
_ring: Optional[collections.deque] = None
_seq = 0
_flushed_seq = 0
_enabled: Optional[bool] = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = RayConfig.instance().cluster_events
    return _enabled


def _buf() -> collections.deque:
    global _ring
    if _ring is None:
        _ring = collections.deque(maxlen=max(
            1, RayConfig.instance().cluster_events_ring_size))
    return _ring


def make_event(etype: str, *, severity: str = const.EVENT_SEVERITY_INFO,
               node: str = "", message: str = "", source: str = "",
               **fields) -> dict:
    """Build one event envelope (no buffering). GCS-side emission uses this
    directly so its ring and the producer rings share one record shape."""
    rec = {
        const.EVENT_FIELD_TYPE: etype,
        const.EVENT_FIELD_SEVERITY: severity,
        const.EVENT_FIELD_TS: time.time(),
        const.EVENT_FIELD_SOURCE: source or f"pid:{os.getpid()}",
        const.EVENT_FIELD_NODE: node,
        const.EVENT_FIELD_MESSAGE: message,
    }
    if fields:
        rec.update(fields)
    return rec


def emit_event(etype: str, *, severity: str = const.EVENT_SEVERITY_INFO,
               node: str = "", message: str = "", **fields) -> None:
    """Record one cluster event into this process's ring (controller-side
    producers: serve controller, train controller). The event type must be
    a constants.py EVENT_* name — literals here fail the
    event-type-literal static check."""
    global _seq
    if not enabled():
        return
    rec = make_event(etype, severity=severity, node=node, message=message,
                     **fields)
    with _lock:
        _seq += 1
        rec[const.EVENT_FIELD_SEQ] = _seq
        _buf().append(rec)


def drain() -> list:
    """Events recorded since the last drain that are STILL in the ring
    (drain-once; older entries rotated out carry the last-N semantics).
    Called by the CoreWorker telemetry flusher."""
    global _flushed_seq
    with _lock:
        out = [dict(r) for r in (_ring or ())
               if r[const.EVENT_FIELD_SEQ] > _flushed_seq]
        if out:
            _flushed_seq = out[-1][const.EVENT_FIELD_SEQ]
    return out


def recent() -> list:
    """The ring's current contents, oldest first (local inspection/tests)."""
    with _lock:
        return [dict(r) for r in (_ring or ())]


def reset() -> None:
    """Test helper: drop the ring + cached enable flag so a new RayConfig
    takes effect."""
    global _ring, _seq, _flushed_seq, _enabled
    with _lock:
        _ring = None
        _seq = 0
        _flushed_seq = 0
        _enabled = None


def severity_rank(severity: str) -> int:
    """Orderable severity (unknown strings sort highest so they are never
    filtered out by a min-severity bound)."""
    try:
        return const.EVENT_SEVERITIES.index(severity)
    except ValueError:
        return len(const.EVENT_SEVERITIES)


def filter_events(rows: list, *, min_severity: str = "", etype: str = "",
                  node: str = "", after_seq: int = 0, limit: int = 0) -> list:
    """Server-side event filtering shared by the GCS `list_events` handler
    and local consumers: min-severity bound, exact type / node match,
    seq watermark (drives `ray_tpu_torch events --follow` polling), newest-N
    limit (applied LAST so `--limit` means "the newest N that match")."""
    out = rows
    if after_seq:
        out = [r for r in out if r.get(const.EVENT_FIELD_SEQ, 0) > after_seq]
    if min_severity:
        floor = severity_rank(min_severity)
        out = [r for r in out
               if severity_rank(r.get(const.EVENT_FIELD_SEVERITY, "")) >= floor]
    if etype:
        out = [r for r in out if r.get(const.EVENT_FIELD_TYPE) == etype]
    if node:
        out = [r for r in out if r.get(const.EVENT_FIELD_NODE) == node]
    if limit and limit > 0:
        out = out[-limit:]
    return [dict(r) for r in out]
