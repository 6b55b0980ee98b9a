"""Metrics: Counter / Gauge / Histogram in a process-local registry.

The port's own copy of the recording side of ray_tpu/util/metrics.py
(the GCS-side Prometheus rendering waits for the runtime's port). Metric
names are shared with the JAX package, e.g. the PD transfer plane's
``ray_tpu_llm_pd_transfer_bytes_total``.
"""

from __future__ import annotations

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
    """Base: a named metric with per-record tags."""

    kind = "base"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Tuple[str, ...]] = None):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name: {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        # series: tag-tuple -> value (float for counter/gauge, dict for hist)
        self._series: Dict[Tuple, object] = {}
        self._series_lock = threading.Lock()
        with _lock:
            prev = _registry.get(name)
            if prev is not None and prev.kind != self.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {prev.kind}")
            _registry[name] = self

    def _snapshot_series(self) -> List[tuple]:
        with self._series_lock:
            return [(list(k), v) for k, v in self._series.items()]


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        if value < 0:
            raise ValueError("Counter.inc() value must be >= 0")
        key = _tag_key(tags)
        with self._series_lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[dict] = None) -> None:
        with self._series_lock:
            self._series[_tag_key(tags)] = float(value)

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        key = _tag_key(tags)
        with self._series_lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def dec(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        self.inc(-value, tags)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(boundaries or DEFAULT_BUCKETS)

    def observe(self, value: float, tags: Optional[dict] = None) -> None:
        key = _tag_key(tags)
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

    def _snapshot_series(self):
        with self._series_lock:
            return [(list(k), {"buckets": list(v["buckets"]),
                               "sum": v["sum"], "count": v["count"],
                               "boundaries": list(self.boundaries)})
                    for k, v in self._series.items()]


# serializes check-then-construct in get_or_create (not _lock: the metric
# constructor takes that itself): without it two racing first users each
# construct, one registration wins, and the loser records into an orphan
_create_lock = threading.Lock()


def get_or_create(cls, name: str, description: str = "", **kwargs):
    """The live registered metric of this name and exact type, or a fresh
    registered one. A module-level cache would go stale when tests clear
    the registry, recording into an object no snapshot sees."""
    with _create_lock:
        with _lock:
            m = _registry.get(name)
        if type(m) is cls:
            return m
        return cls(name, description=description, **kwargs)


def snapshot() -> list:
    """Serializable dump of every metric in this process."""
    with _lock:
        metrics = list(_registry.values())
    return [{"name": m.name, "kind": m.kind, "description": m.description,
             "series": m._snapshot_series(), "ts": time.time()}
            for m in metrics]


def clear_registry() -> None:
    """Test helper."""
    with _lock:
        _registry.clear()
