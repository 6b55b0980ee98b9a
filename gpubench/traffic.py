"""The one traffic generator: it reads a mix file (``traffic/<name>.json``)
and the run's seed.

Every seed gets the same work in another order. A segment of n requests
takes its prompt lengths, output lengths and arrival gaps from fixed
quantile grids of their distributions (log-normal lengths clipped to the
mix's range, exponential gaps at the mix's rate), and the seed only
shuffles each grid and draws the token ids. So the tokens a run prefills
and decodes, and its arrival rate, do not change with the seed; which
request meets which does. A mix with an ``order_seed`` shuffles the grids
by that number in every run, and the run's seed draws only the token ids:
the same requests arrive in the same order, so the live streams, and the
steps' batches, do not change with the seed either.

An open loop (``"loop": "open"``) is a schedule: a warm-up segment whose
requests are not measured, the window's segment, which spans exactly the
window, and a tail that keeps the load on while the window's requests
finish. A closed loop (``"loop": "closed"``) is an endless stream in
blocks, each a grid of its own.
"""

from __future__ import annotations

import math
import statistics

import numpy as np

from gpubench.common import sub_seed

_NORMAL = statistics.NormalDist()


def lengths(n: int, dist: dict) -> list[int]:
    """n log-normal lengths at the grid's quantiles (i + 0.5) / n."""
    return [int(min(max(round(dist["median"] * math.exp(
        dist["sigma"] * _NORMAL.inv_cdf((i + 0.5) / n))), dist["min"]),
        dist["max"])) for i in range(n)]


def gaps(n: int, span_s: float) -> list[float]:
    """n exponential gaps at the grid's quantiles, scaled to sum to span_s
    (a Poisson process's gaps, at the rate n / span_s)."""
    g = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    total = sum(g)
    return [x * span_s / total for x in g]


def segment(mix: dict, seed: int, name: str, n: int, vocab: int,
            span_s: float | None = None) -> list[dict]:
    """n requests, each {"prompt": ids, "max_tokens": m, "gap_s": g}."""
    rng = np.random.default_rng(sub_seed(seed, "traffic", name))
    order = (np.random.default_rng(sub_seed(mix["order_seed"], "traffic",
                                            name))
             if "order_seed" in mix else rng)
    prompt = lengths(n, mix["prompt_tokens"])
    out = lengths(n, mix["output_tokens"])
    order.shuffle(prompt)
    order.shuffle(out)
    gap = gaps(n, span_s) if span_s else [0.0] * n
    order.shuffle(gap)
    return [{"prompt": rng.integers(0, vocab, size=p).tolist(),
             "max_tokens": int(m), "gap_s": g}
            for p, m, g in zip(prompt, out, gap)]


def open_schedule(mix: dict, seed: int, seconds: float, vocab: int) -> list:
    """Requests with "due_s" (from the start of the warm-up) and "phase":
    "warmup", "window" or "tail". The window is [warmup_s, warmup_s +
    seconds)."""
    rate = mix["rate_per_s"]
    sched = []
    t = 0.0
    for phase, span in (("warmup", mix["warmup_s"]), ("window", seconds),
                        ("tail", mix["tail_s"])):
        n = max(1, round(rate * span))
        for r in segment(mix, seed, phase, n, vocab, span):
            r["due_s"], r["phase"] = t, phase
            t += r.pop("gap_s")
            sched.append(r)
    return sched


def closed_stream(mix: dict, seed: int, vocab: int, block: int = 256):
    """Endless requests for a closed loop, `block` at a time per grid."""
    i = 0
    while True:
        for r in segment(mix, seed, f"block{i}", block, vocab):
            r.pop("gap_s")
            yield r
        i += 1
