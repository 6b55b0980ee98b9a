"""Per-request observability for the serve/PD data plane.

One module owns the three request-path instruments (tentpole: end-to-end
request tracing + phase attribution):

- **phase histograms** — always-on, pre-bound (`Histogram.bind`, the
  compiled-DAG fast path) per (metric, phase) labelset, gated by
  `RayConfig.serve_metrics`. One histogram family per layer so dashboards
  can slice the serving hot path: proxy accept/parse/route/handle, handle
  pick/RTT, replica queue-wait/execute, engine queue-wait/prefill/
  admission-wait/inter-token,
  PD per-page transfer waits.
- **request ids + span sampling** — every request entering the HTTP proxy
  gets a 16-byte id; every Nth (`RayConfig.serve_span_sample_every`) opens
  a `tracing.request_trace` root whose context propagates through handles
  (fast-RPC frames and actor-plane specs alike) so one request id yields
  one cross-process span tree.
- **flight recorder** — request summaries appended to the in-process ring
  (`task_events.record_request`), shipped to the GCS request log by the
  worker flusher, surfaced as `ray_tpu_torch trace list` / `GET /api/requests`.

(reference: python/ray/util/tracing/tracing_helper.py:165 — trace context
in every task/actor spec; serve's per-phase latency metrics in
serve/_private/proxy.py + replica.py.)
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager

from ray_tpu_torch._private.ray_config import RayConfig

# histogram families (EXPECTED_METRICS in tools/graft_check — a rename
# fails tier-1, not a scrape)
PROXY_PHASE = "ray_tpu_serve_proxy_phase_seconds"
HANDLE_PHASE = "ray_tpu_serve_handle_phase_seconds"
REPLICA_PHASE = "ray_tpu_serve_replica_phase_seconds"
ENGINE_PHASE = "ray_tpu_llm_engine_phase_seconds"
PD_PHASE = "ray_tpu_llm_pd_phase_seconds"

# sub-ms-resolving buckets: the serving phases this instruments range from
# ~10 µs (router pick) to seconds (decode)
_PHASE_BOUNDS = (0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_lock = threading.Lock()
_hists: dict | None = None           # metric name -> live Histogram
_bound: dict = {}                    # (metric, phase) -> BoundHistogram
_sample_counter = itertools.count()


def metrics_enabled() -> bool:
    # read through the singleton each call: tests/benches toggle via
    # RayConfig.reset(), and the read is trivial next to a request
    return RayConfig.instance().serve_metrics


def _make_histograms() -> dict:
    from ray_tpu_torch.util import metrics as met

    kw = dict(boundaries=list(_PHASE_BOUNDS), tag_keys=("phase",))
    return {
        PROXY_PHASE: met.get_or_create(
            met.Histogram, "ray_tpu_serve_proxy_phase_seconds",
            "serve HTTP proxy request phases (accept = executor dispatch "
            "wait, parse, route, handle = downstream RTT)", **kw),
        HANDLE_PHASE: met.get_or_create(
            met.Histogram, "ray_tpu_serve_handle_phase_seconds",
            "DeploymentHandle phases (pick = router choice incl. "
            "no-replica wait, rtt = submit->reply)", **kw),
        REPLICA_PHASE: met.get_or_create(
            met.Histogram, "ray_tpu_serve_replica_phase_seconds",
            "replica request phases (queue_wait = admission-semaphore "
            "wait, execute = user callable)", **kw),
        ENGINE_PHASE: met.get_or_create(
            met.Histogram, "ray_tpu_llm_engine_phase_seconds",
            "engine request phases (queue_wait = submit->the pass that "
            "starts its admission, prefill = that pass->first token, "
            "admission_wait = submit->decode-slot bind, inter_token = gap "
            "between emitted tokens)", **kw),
        PD_PHASE: met.get_or_create(
            met.Histogram, "ray_tpu_llm_pd_phase_seconds",
            "PD transfer-plane phases (transfer_wait = reader-side "
            "per-page channel wait, transfer_send_wait = sender-side "
            "per-page backpressure wait)", **kw),
    }


def phase_observer(metric: str, phase: str):
    """BoundHistogram for one (metric, phase) labelset, or None when serve
    metrics are off. The cache is registry-aware: after a test clears the
    metrics registry the stale bound objects are rebuilt instead of
    recording into orphans no snapshot exports (the get_or_create
    contract)."""
    if not metrics_enabled():
        return None
    global _hists
    from ray_tpu_torch.util import metrics as met

    b = _bound.get((metric, phase))
    if b is not None and met._registry.get(metric) is b._hist:
        return b
    with _lock:
        if _hists is None or met._registry.get(metric) is not _hists.get(metric):
            _hists = _make_histograms()
            _bound.clear()
        b = _bound.get((metric, phase))
        if b is None:
            b = _bound[(metric, phase)] = _hists[metric].bind({"phase": phase})
        return b


def observe_phase(metric: str, phase: str, seconds: float,
                  rec: dict | None = None) -> None:
    """Record one phase duration into its pre-bound histogram (no-op when
    serve metrics are off) and, when a flight-recorder entry is being
    assembled, into its ``phases`` map. When a process-wide PhaseBatcher is
    installed (proxy shards), the observe is buffered and flushed on an
    interval instead of hitting the bound histogram inline."""
    batcher = _batcher
    if batcher is not None:
        batcher.add(metric, phase, seconds)
    else:
        b = phase_observer(metric, phase)
        if b is not None:
            b.observe(seconds)
    if rec is not None:
        rec.setdefault("phases", {})[phase] = round(seconds, 6)


# --------------------------------------------------------- batched telemetry

_batcher = None  # process-wide PhaseBatcher (proxy shards install one)


class PhaseBatcher:
    """Interval-flushed phase telemetry for the proxy hot path.

    Per-request inline observes cost a registry probe + bound-cache lookup
    each; a proxy shard doing tens of thousands of requests/s pays that
    four times per request. The batcher makes the request-path cost one
    ``list.append`` (atomic under the GIL — no lock on the hot side) and
    moves the histogram updates to a flush thread that drains the buffer
    every ``RayConfig.serve_telemetry_flush_s`` seconds, grouping by
    (metric, phase) so each flush touches each bound histogram once per
    batch. ``on_flush`` lets the owner piggyback gauge updates (routing
    table age, shard stats) on the same interval — one timer, one batch.
    """

    def __init__(self, flush_s: float | None = None, on_flush=None):
        cfg = RayConfig.instance()
        self._flush_s = cfg.serve_telemetry_flush_s if flush_s is None \
            else flush_s
        self._on_flush = on_flush
        self._buf: list = []        # (metric, phase, seconds) triples
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-phase-batcher")
        self._thread.start()

    def add(self, metric: str, phase: str, seconds: float) -> None:
        self._buf.append((metric, phase, seconds))

    def _loop(self) -> None:
        while not self._stop.wait(self._flush_s):
            self.flush()
        self.flush()  # final drain so shutdown loses nothing

    def flush(self) -> None:
        # swap-then-drain: appends racing the swap land in the new list
        buf, self._buf = self._buf, []
        if buf and metrics_enabled():
            grouped: dict = {}
            for metric, phase, seconds in buf:
                grouped.setdefault((metric, phase), []).append(seconds)
            for (metric, phase), vals in grouped.items():
                b = phase_observer(metric, phase)
                if b is not None:
                    for v in vals:
                        b.observe(v)
        if self._on_flush is not None:
            try:
                self._on_flush()
            except Exception as e:  # pragma: no cover - gauges best-effort
                import logging

                logging.getLogger(__name__).debug("on_flush failed: %r", e)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def set_phase_batcher(batcher: PhaseBatcher | None) -> None:
    """Install (or clear) the process-wide batcher ``observe_phase`` routes
    through. Proxy shards install one at startup; everything else keeps
    the inline path."""
    global _batcher
    _batcher = batcher


@contextmanager
def timed_phase(metric: str, phase: str, rec: dict | None = None, *,
                span: str | None = None, **span_extra):
    """Time a block as one phase: histogram observe + flight-recorder entry
    + (when a trace is active and `span` is named) a child span."""
    t0 = time.perf_counter()
    w0 = time.time()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        observe_phase(metric, phase, dt, rec)
        if span is not None:
            from ray_tpu_torch.util import tracing

            tracing.emit_child_span(span, w0, w0 + dt, **span_extra)


# ------------------------------------------------------------- request ids


def new_request_id() -> str:
    """16 random bytes hex — the same format as a trace id, because for
    sampled requests it IS the trace id."""
    return os.urandom(16).hex()


def sample_request() -> bool:
    """Every Nth request entering a proxy opens a full span tree
    (`RayConfig.serve_span_sample_every`; 0 = never). Counter is
    per-process; the first request is always sampled so short sessions
    still yield a timeline."""
    every = RayConfig.instance().serve_span_sample_every
    if every <= 0 or not metrics_enabled():
        return False
    return next(_sample_counter) % every == 0


# ------------------------------------------------- deadlines + admission


def deadline_remaining(deadline_ts: float | None) -> float | None:
    """Seconds of budget left before an absolute wall-clock deadline, or
    None when no deadline is set. Non-positive means already expired —
    callers refuse work they cannot finish (per-hop deadline refusal)."""
    if not deadline_ts:
        return None
    return deadline_ts - time.time()


def count_cancellation(stage: str) -> None:
    """Count one request cancellation at the stage where it took effect
    (`proxy` = client disconnect observed / deadline refusal at dispatch,
    `handle` = timed-out caller's best-effort cancel, `replica` =
    queue-wait interruption or deadline refusal at admission, `engine` =
    mid-stream slot/page reclaim, `pd` = decode-tier transfer abort).
    Stages attribute where cancels land, they do not dedupe one request.
    Must never fail a request: metrics are best-effort."""
    if not metrics_enabled():
        return
    try:
        from ray_tpu_torch.util import metrics as met

        met.get_or_create(
            met.Counter, "ray_tpu_serve_request_cancellations_total",
            "serve requests cancelled (client disconnect, explicit "
            "cancel(), timed-out caller, deadline expiry), by the stage "
            "that applied the cancel",
            tag_keys=("stage",)).inc(tags={"stage": stage})
    except Exception as e:  # pragma: no cover - metrics must not fail requests
        import logging

        logging.getLogger(__name__).debug("cancel metric failed: %r", e)


def count_shed(component: str) -> None:
    """Count one request refused by admission control (`router` =
    client-side in-flight window saturated, `replica` = admission queue at
    max_queued_requests). Best-effort, never fails the shed path."""
    if not metrics_enabled():
        return
    try:
        from ray_tpu_torch.util import metrics as met

        met.get_or_create(
            met.Counter, "ray_tpu_serve_requests_shed_total",
            "serve requests shed by admission control instead of queued "
            "(surfaced to HTTP clients as 503 + Retry-After)",
            tag_keys=("component",)).inc(tags={"component": component})
    except Exception as e:  # pragma: no cover - metrics must not fail requests
        import logging

        logging.getLogger(__name__).debug("shed metric failed: %r", e)


# --------------------------------------------------------- flight recorder


def record_request(rec: dict, t0: float, *, status) -> None:
    """Finalize one request's flight-recorder entry (duration + status) and
    append it to the in-process ring. No-op when serve metrics are off."""
    if not metrics_enabled():
        return
    from ray_tpu_torch._private import task_events

    rec["duration_s"] = round(time.perf_counter() - t0, 6)
    rec["status"] = status
    task_events.record_request(rec)
