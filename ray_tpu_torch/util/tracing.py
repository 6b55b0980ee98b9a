"""Distributed trace-context propagation across task/actor boundaries.

Reference capability: python/ray/util/tracing/tracing_helper.py:165 — Ray's
``_DictPropagator`` injects the OpenTelemetry span context into every
task/actor spec (``_ray_trace_ctx``) and workers extract it before running
user code, so spans emitted in different processes share one trace with
correct parentage.

Design here: no OTel dependency (not in the image). A W3C-traceparent-
compatible context — ``trace_id`` (16 bytes hex) + ``span_id`` (8 bytes
hex) — lives in a ``contextvars`` slot. Submission sites call
:func:`inject` to stamp ``spec["trace_ctx"]``; the executor wraps user code
in :func:`activate`, which (a) makes the incoming context the parent of a
fresh span so *nested* submissions chain correctly, and (b) emits the
finished span on the existing task-event channel (``task_events``), where
the GCS already aggregates events from every worker. :func:`get_trace`
pulls the event log and reassembles the tree for one trace id.

Spans ride the task-event plumbing rather than a second channel on purpose:
one ordered, batched, already-flushed path (reference analogy: Ray batches
profile events through TaskEventBuffer instead of a live exporter).
"""

from __future__ import annotations

import contextvars
import os
import time
from contextlib import contextmanager

from ray_tpu_torch._private.ray_config import RayConfig

_current: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "ray_tpu_trace_ctx", default=None)

def enabled() -> bool:
    # read through the singleton each call (no module cache): tests toggle
    # the flag via RayConfig.reset(), and the attribute read is trivia
    # next to arg pickling on the submit path
    return RayConfig.instance().enable_tracing


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def current_context() -> dict | None:
    """The active span context in this task/thread, or None."""
    return _current.get()


def inject() -> dict | None:
    """Context dict to stamp into an outgoing spec (None = no active trace).

    Mirrors _DictPropagator.inject_current_context (tracing_helper.py:168):
    the CURRENT span becomes the remote task's parent. Gated on an ACTIVE
    context rather than the global `enable_tracing` flag: a context only
    exists when a root was opened — by :func:`trace` (which checks the
    flag) or by per-request sampling (:func:`request_trace`, gated by
    `serve_span_sample_every`) — so presence IS the sampling decision.
    """
    ctx = _current.get()
    if ctx is None:
        return None
    out = {"trace_id": ctx["trace_id"], "parent_span_id": ctx["span_id"]}
    if "request_id" in ctx:
        out["request_id"] = ctx["request_id"]
    return out


def to_traceparent(ctx: dict) -> str:
    """W3C ``traceparent`` header form of a span context."""
    return f"00-{ctx['trace_id']}-{ctx['span_id']}-01"


@contextmanager
def trace(name: str = "trace"):
    """Open a root span in the driver: everything submitted inside becomes
    part of one trace. Yields the root context (carries ``trace_id``)."""
    if not enabled():
        yield {"trace_id": "", "span_id": ""}
        return
    ctx = {"trace_id": _new_id(16), "span_id": _new_id(8)}
    tok = _current.set(ctx)
    t0 = time.time()
    try:
        yield ctx
    finally:
        _current.reset(tok)
        _emit_span(name=name, kind="root", ctx=ctx, parent_span_id="",
                   start=t0, end=time.time(), ok=True)


def _child_ctx(trace_ctx: dict) -> dict:
    ctx = {"trace_id": trace_ctx["trace_id"], "span_id": _new_id(8)}
    if "request_id" in trace_ctx:
        ctx["request_id"] = trace_ctx["request_id"]
    return ctx


@contextmanager
def activate(trace_ctx: dict | None, *, name: str, task_id: str = "",
             kind: str = "task"):
    """Executor-side: run user code under a fresh child span of the
    propagated context. Emits the span on exit (ok=False if user code
    raised). No-op when the spec carries no context (the context's
    presence already encodes the root's sampling decision — see inject)."""
    if not trace_ctx:
        yield
        return
    ctx = _child_ctx(trace_ctx)
    tok = _current.set(ctx)
    t0 = time.time()
    ok = True
    try:
        yield
    except BaseException:
        ok = False
        raise
    finally:
        _current.reset(tok)
        _emit_span(name=name, kind=kind, ctx=ctx,
                   parent_span_id=trace_ctx.get("parent_span_id", ""),
                   start=t0, end=time.time(), ok=ok, task_id=task_id)


def _emit_span(*, name: str, kind: str, ctx: dict, parent_span_id: str,
               start: float, end: float, ok: bool, task_id: str = "",
               **extra) -> None:
    from ray_tpu_torch._private import task_events

    if "request_id" in ctx:
        # serve request spans carry the request id so to_chrome_trace can
        # group the whole cross-process tree under one `req:<id>` row
        extra.setdefault("request_id", ctx["request_id"])
    task_events.emit(
        "trace:span", task_id=task_id, name=name, start=start, end=end,
        trace_id=ctx["trace_id"], span_id=ctx["span_id"],
        parent_span_id=parent_span_id, span_kind=kind, ok=ok, **extra)


def begin_task_span(trace_ctx: dict | None):
    """Non-context-manager form of :func:`activate` for executors that
    already own a try/finally (worker.execute_spec). Returns an opaque
    handle for :func:`end_task_span`, or None when the spec carries no
    context (no root was opened upstream, so nothing was sampled)."""
    if not trace_ctx:
        return None
    ctx = _child_ctx(trace_ctx)
    tok = _current.set(ctx)
    return (tok, ctx, trace_ctx.get("parent_span_id", ""), time.time())


def end_task_span(handle, *, name: str, task_id: str, kind: str,
                  ok: bool) -> None:
    if handle is None:
        return
    tok, ctx, parent, t0 = handle
    _current.reset(tok)
    _emit_span(name=name, kind=kind, ctx=ctx, parent_span_id=parent,
               start=t0, end=time.time(), ok=ok, task_id=task_id)


# ------------------------------------------------------- serve request spans


def begin_request_trace(request_id: str, **extra) -> list:
    """Open the root span for one SAMPLED serve request. The trace id IS
    the request id (both are 16 random bytes hex), so `ray_tpu_torch trace show
    <request_id>` needs no lookup table, and every span in the tree carries
    ``request_id`` for per-request chrome-trace rows. Unlike :func:`trace`
    this ignores `enable_tracing`: the caller (the HTTP proxy) already made
    the sampling decision via `serve_span_sample_every`.

    Split begin/detach/finish (instead of one context manager) because a
    STREAMING request outlives its dispatch thread: the proxy detaches the
    context when dispatch returns the generator, and finishes the root —
    with the real end time — when the stream body completes."""
    ctx = {"trace_id": request_id, "span_id": _new_id(8),
           "request_id": request_id}
    return [_current.set(ctx), ctx, time.time(), extra]


def detach_request_trace(handle) -> None:
    """Deactivate the request context on the dispatch thread (idempotent).
    The root span is NOT emitted yet — finish_request_trace does that."""
    if handle and handle[0] is not None:
        _current.reset(handle[0])
        handle[0] = None


def finish_request_trace(handle, *, ok: bool = True,
                         name: str = "serve:request") -> None:
    """Emit the root span with the request's real end time. Safe from any
    thread (detaches first if the dispatch thread never did)."""
    if not handle:
        return
    detach_request_trace(handle)
    _tok, ctx, t0, extra = handle
    _emit_span(name=name, kind="root", ctx=ctx, parent_span_id="",
               start=t0, end=time.time(), ok=ok, **extra)


@contextmanager
def request_trace(request_id: str, *, name: str = "serve:request", **extra):
    """Context-manager form of begin/finish for same-thread request scopes."""
    handle = begin_request_trace(request_id, **extra)
    ok = True
    try:
        yield handle[1]
    except BaseException:
        ok = False
        raise
    finally:
        finish_request_trace(handle, ok=ok, name=name)


def emit_span_for(parent_ctx: dict | None, name: str, start: float,
                  end: float, *, ok: bool = True, kind: str = "phase",
                  **extra) -> None:
    """Emit a completed child span under an EXPLICIT parent context —
    for phase spans measured with their own start/end stamps, and for
    helper threads (e.g. the KV sender) that hold a captured context
    instead of the contextvar. Accepts both an ACTIVE context (its
    span_id is the parent) and an inject()ed one (parent_span_id already
    names the parent). No-op without a parent."""
    if not parent_ctx or not parent_ctx.get("trace_id"):
        return
    parent = (parent_ctx.get("span_id")
              or parent_ctx.get("parent_span_id", ""))
    _emit_span(name=name, kind=kind, ctx=_child_ctx(parent_ctx),
               parent_span_id=parent, start=start, end=end,
               ok=ok, **extra)


def emit_child_span(name: str, start: float, end: float, *, ok: bool = True,
                    **extra) -> None:
    """emit_span_for under the ACTIVE context (no-op when no trace is
    active in this task/thread) — the cheap per-phase emission guard on
    the serving path: one contextvar read when unsampled."""
    ctx = _current.get()
    if ctx is not None:
        emit_span_for(ctx, name, start, end, ok=ok, **extra)


# --------------------------------------------------------------- assembly


def span_events(events: list, trace_id: str) -> list[dict]:
    return [e for e in events
            if e.get("event") == "trace:span" and e.get("trace_id") == trace_id]


def assemble(events: list, trace_id: str) -> dict | None:
    """Rebuild one trace's span tree from GCS-collected task events.

    Returns ``{"trace_id", "root": {span..., "children": [...]}}`` or None
    if the trace has no spans. Orphan spans (parent not collected yet)
    attach under the root so the tree is always complete.
    """
    spans = span_events(events, trace_id)
    if not spans:
        return None
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    root = None
    orphans = []
    for s in by_id.values():
        parent = s.get("parent_span_id") or ""
        if parent and parent in by_id:
            by_id[parent]["children"].append(s)
        elif s.get("span_kind") == "root":
            root = s
        else:
            orphans.append(s)
    if root is None:
        # driver root not flushed yet: synthesize one so callers still get
        # a connected tree
        root = {"span_id": "", "name": "(root)", "span_kind": "root",
                "trace_id": trace_id, "children": []}
    for s in orphans:
        root["children"].append(s)
    for s in by_id.values():
        s["children"].sort(key=lambda c: c.get("start") or 0)
    return {"trace_id": trace_id, "root": root}


def get_trace(trace_id: str) -> dict | None:
    """Fetch the cluster-wide event log from the GCS and reassemble the
    tree for ``trace_id``. Driver-side helper; flushes local spans first."""
    from ray_tpu_torch._private.api import _get_worker

    w = _get_worker()
    # local spans (e.g. the driver root) sit in this process's buffer until
    # the background flusher runs — push them now so the tree is complete
    w._flush_telemetry()
    events = w.rpc({"type": "task_events"}).get("events", [])
    return assemble(events, trace_id)
