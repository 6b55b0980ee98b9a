"""What the engine-phase readers share: the gain of one of the engine's
``/v1/stats`` counters over the window, and one counter's gain over
another's, each None where a program lacks the counter or the gain is
nothing to divide by."""

from __future__ import annotations


def gain(layer: dict, key: str) -> float | None:
    b, a = layer.get("before"), layer.get("after")
    if not b or not a:
        return None
    b, a = b.get("stats", b), a.get("stats", a)
    if key not in b or key not in a:
        return None
    return a[key] - b[key]


def ratio(layer: dict, num: str, den: str, scale: float) -> float | None:
    n, d = gain(layer, num), gain(layer, den)
    if n is None or not d:
        return None
    return scale * n / d
