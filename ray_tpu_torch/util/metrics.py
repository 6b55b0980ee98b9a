"""User-facing metrics API: Counter / Gauge / Histogram.

The port's own copy of ray_tpu/util/metrics.py. Metrics are recorded into
a process-local registry; the CoreWorker's background flusher ships deltas
to the GCS, which aggregates across the session and renders a Prometheus
text scrape (``to_prometheus``). Metric names are shared with the JAX
package, e.g. the PD transfer plane's ``ray_tpu_llm_pd_transfer_bytes_total``.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Tuple

_lock = threading.Lock()
_registry: Dict[str, "Metric"] = {}

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0)


def _tag_key(tags: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not tags:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in tags.items()))


class Metric:
    """Base: named metric with static default tags + per-record tags."""

    kind = "base"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None, *,
                 register: bool = True):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: dict = {}
        # series: tag-tuple -> value (float for counter/gauge, list for hist)
        self._series: Dict[Tuple, object] = {}
        self._series_lock = threading.Lock()
        if not register:
            # unregistered metric: for host processes (e.g. the GCS) that
            # export through their own channel instead of the CoreWorker
            # flusher — keeping it out of the process registry prevents a
            # co-located driver's flusher from shipping the same series a
            # second time under a different source id
            return
        with _lock:
            prev = _registry.get(name)
            if prev is not None and prev.kind != self.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev.kind}")
            _registry[name] = self

    def set_default_tags(self, tags: dict) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def remove(self, tags: Optional[dict] = None) -> None:
        """Drop one labelset's series entirely (it stops being exported).
        For short-lived tag values (e.g. per-pipeline ids) this is the
        retirement path — setting 0 would leave a dead series in every
        future scrape and grow the registry without bound."""
        key = self._merged(tags)
        with self._series_lock:
            self._series.pop(key, None)

    def _merged(self, tags: Optional[dict]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return _tag_key(merged)

    def _snapshot_series(self) -> List[tuple]:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc() value must be >= 0")
        key = self._merged(tags)
        with self._series_lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def _snapshot_series(self):
        with self._series_lock:
            return [(list(k), v) for k, v in self._series.items()]


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[dict] = None) -> None:
        with self._series_lock:
            self._series[self._merged(tags)] = float(value)

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        key = self._merged(tags)
        with self._series_lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def dec(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        self.inc(-value, tags)

    def _snapshot_series(self):
        with self._series_lock:
            return [(list(k), v) for k, v in self._series.items()]


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries=None, tag_keys=None,
                 *, register: bool = True):
        super().__init__(name, description, tag_keys, register=register)
        self.boundaries = tuple(boundaries or DEFAULT_BUCKETS)

    def observe(self, value: float, tags: Optional[dict] = None) -> None:
        self._observe_key(self._merged(tags), value)

    def _observe_key(self, key: Tuple, value: float) -> None:
        with self._series_lock:
            st = self._series.get(key)
            if st is None:
                st = self._series[key] = {
                    "buckets": [0] * (len(self.boundaries) + 1),
                    "sum": 0.0, "count": 0}
            i = 0
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    break
            else:
                i = len(self.boundaries)
            st["buckets"][i] += 1
            st["sum"] += value
            st["count"] += 1

    def bind(self, tags: Optional[dict] = None) -> "BoundHistogram":
        """Pre-resolve one labelset for hot-path observes: the tag merge +
        sort happens once here instead of on every observe. Built for the
        compiled-DAG step path, where per-phase observes run per message."""
        return BoundHistogram(self, self._merged(tags))

    def _snapshot_series(self):
        with self._series_lock:
            return [(list(k), {"buckets": list(v["buckets"]),
                               "sum": v["sum"], "count": v["count"],
                               "boundaries": list(self.boundaries)})
                    for k, v in self._series.items()]


class BoundHistogram:
    """One (histogram, labelset) pair with the series key pre-resolved and
    the series STATE cached after the first observe: steady-state observe
    is one bisect plus three in-place updates under the GIL, no lock —
    this module's 'nanosecond-cheap local updates' contract applied to the
    per-message DAG hot path (a locked observe × 3 phases × N ops per step
    measurably dents µs-scale steps). snapshot()/remove() still take the
    series lock; the worst interleaving against an unlocked update is a
    one-sample count/sum skew in a single scrape, corrected by the next."""

    __slots__ = ("_hist", "_key", "_st")

    def __init__(self, hist: Histogram, key: Tuple):
        self._hist = hist
        self._key = key
        self._st = None

    def observe(self, value: float) -> None:
        st = self._st
        if st is None:
            h = self._hist
            with h._series_lock:
                st = h._series.get(self._key)
                if st is None:
                    st = h._series[self._key] = {
                        "buckets": [0] * (len(h.boundaries) + 1),
                        "sum": 0.0, "count": 0}
            self._st = st
        # first bucket with boundary >= value (== the linear scan in
        # Histogram._observe_key, at C speed)
        st["buckets"][bisect.bisect_left(self._hist.boundaries, value)] += 1
        st["sum"] += value
        st["count"] += 1


# serializes check-then-construct in get_or_create (NOT _lock — the metric
# constructor acquires that itself): without it two racing first-users each
# construct, one registration wins, and the loser records into an orphan
# object no snapshot ever exports
_create_lock = threading.Lock()


def get_or_create(cls, name: str, description: str = "", **kwargs):
    """Registry-aware constructor: return the LIVE registered metric when
    one of this name and exact type exists, else construct (and register) a
    fresh one. The lazy-metric idiom for instrumented subsystems — a plain
    module-level cache goes stale when tests clear the registry, silently
    recording into an object no snapshot will ever see."""
    with _create_lock:
        with _lock:
            m = _registry.get(name)
        if type(m) is cls:
            return m
        return cls(name, description=description, **kwargs)


def snapshot() -> list:
    """Serializable dump of every metric in this process (for the flusher)."""
    with _lock:
        metrics = list(_registry.values())
    out = []
    for m in metrics:
        out.append({"name": m.name, "kind": m.kind,
                    "description": m.description,
                    "series": m._snapshot_series(),
                    "ts": time.time()})
    return out


def clear_registry() -> None:
    """Test helper."""
    with _lock:
        _registry.clear()


def _esc_label(v) -> str:
    """Escape a label value per the Prometheus exposition format
    (backslash, double-quote, newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def to_prometheus(agg: dict) -> str:
    """Render a GCS-side aggregate ({name: {kind, description, series:
    {source: [(tags, value), ...]}, ts: {source: snapshot_ts}}}) as
    Prometheus text format. A family no source has a sample of yet (a
    metric registered, never recorded) is left out: its HELP line alone
    would tell a scraper the metric is there before any value is."""
    lines = []
    for name, rec in sorted(agg.items()):
        if not any(rec["series"].values()):
            continue
        kind = rec["kind"]
        if rec.get("description"):
            lines.append(f"# HELP {name} {rec['description']}")
        lines.append(f"# TYPE {name} {kind}")
        # merge across sources: counters/hist sum, gauges take the series
        # with the NEWEST snapshot ts (tie-break by source id) — iteration
        # order of the source dict must never decide which value wins
        ts_map = rec.get("ts") or {}
        sources = sorted(rec["series"].items(),
                         key=lambda kv: (ts_map.get(kv[0], 0.0), kv[0]))
        merged: dict = {}
        # histograms: group per labelset by bucket layout; sources can
        # disagree when a metric is redefined mid-flight (rolling restart)
        # and summing across layouts would corrupt both. The MAJORITY
        # layout wins (tie-break: newest snapshot ts, then the layout
        # tuple) — neither a stale straggler with the newest report ts nor
        # dict iteration order can hold the export on the losing layout.
        hist_groups: dict = {}
        for source, series in sources:
            ts = ts_map.get(source, 0.0)
            for tags, val in series:
                key = tuple(tuple(t) for t in tags)
                if kind == "gauge":
                    # ts-sorted iteration: the newest source wins
                    merged[key] = val
                elif kind == "histogram":
                    sig = tuple(val.get("boundaries", ()))
                    g = hist_groups.setdefault(key, {}).setdefault(
                        sig, {"n": 0, "ts": 0.0, "sum": 0.0, "count": 0,
                              "buckets": [0] * len(val["buckets"]),
                              "boundaries": list(sig)})
                    g["n"] += 1
                    g["ts"] = max(g["ts"], ts)
                    g["sum"] += val["sum"]
                    g["count"] += val["count"]
                    g["buckets"] = [a + b for a, b in
                                    zip(g["buckets"], val["buckets"])]
                else:
                    merged[key] = merged.get(key, 0.0) + val
        for key, groups in hist_groups.items():
            best = max(groups.values(),
                       key=lambda g: (g["n"], g["ts"],
                                      tuple(g["boundaries"])))
            merged[key] = best
        for key, val in merged.items():
            label = ",".join(f'{k}="{_esc_label(v)}"' for k, v in key)
            label = "{" + label + "}" if label else ""
            if kind == "histogram":
                acc = 0
                for b, n in zip(val["boundaries"], val["buckets"]):
                    acc += n
                    lb = ("{" + (label[1:-1] + "," if label else "")
                          + f'le="{b}"' + "}")
                    lines.append(f"{name}_bucket{lb} {acc}")
                lb = ("{" + (label[1:-1] + "," if label else "")
                      + 'le="+Inf"' + "}")
                lines.append(f"{name}_bucket{lb} {val['count']}")
                lines.append(f"{name}_sum{label} {val['sum']}")
                lines.append(f"{name}_count{label} {val['count']}")
            else:
                lines.append(f"{name}{label} {val}")
    return "\n".join(lines) + "\n"
