"""What the per-layer readers share: counter and histogram differences
over the window, the served tokens a trace slice holds, and the model's
sizes. Each reader returns None where it finds nothing to read."""

from __future__ import annotations

from gpubench import weights
from gpubench.ops import counts


def hist_delta(layer: dict, metric: str, phases) -> tuple[float, int]:
    """(seconds, observations) a histogram of the GCS's metrics snapshot
    gained over the window, summed over its sources and `phases`."""
    def total(snap):
        s = n = 0
        rec = (snap or {}).get(metric, {})
        for series in rec.get("series", {}).values():
            for tags, val in series:
                if dict(map(tuple, tags)).get("phase") in phases:
                    s += val["sum"]
                    n += val["count"]
        return s, n
    if not layer.get("before") or not layer.get("after"):
        return 0.0, 0
    s0, n0 = total(layer["before"]["metrics"])
    s1, n1 = total(layer["after"]["metrics"])
    return s1 - s0, n1 - n0


def stats_delta(layer: dict, key: str) -> float | None:
    b, a = layer.get("before"), layer.get("after")
    if not b or not a:
        return None
    b, a = b.get("stats", b), a.get("stats", a)
    return a[key] - b[key]


def served_in(layer: dict, t0: float, t1: float):
    """(prompt lengths of requests whose first token came in [t0, t1),
    contexts of the decoded tokens that came in it)."""
    prompts, contexts = [], []
    for r in layer["records"]:
        n = len(r["prompt"])
        for j, t in enumerate(r.get("t_tokens", ())):
            if t0 <= t < t1:
                if j == 0:
                    prompts.append(n)
                else:
                    contexts.append(n + j)
    return prompts, contexts


def dims(layer: dict) -> dict:
    return weights.dims(layer["cfg"])


def served_flops(layer: dict, t0: float, t1: float) -> float:
    d = dims(layer)
    prompts, contexts = served_in(layer, t0, t1)
    return (sum(counts.prefill_flops(d, n) for n in prompts)
            + sum(counts.decode_flops(d, c) for c in contexts))
