"""What the serving drivers share: which prompt buckets a mix reaches,
the sample of finished requests the reference judges, and the judging."""

from __future__ import annotations

import numpy as np

from gpubench import check
from gpubench.common import sub_seed


def buckets_used(engine_cfg: dict, dist: dict) -> list[int]:
    """The engine's prompt buckets (powers of two from min_bucket, capped
    at max_len) that prompts of the mix's length range fall in."""
    out, b = [], engine_cfg["min_bucket"]
    while True:
        cap = min(b, engine_cfg["max_len"])
        if cap >= dist["min"]:
            out.append(cap)
        if cap >= dist["max"] or cap == engine_cfg["max_len"]:
            return out
        b *= 2


def warm_lengths(engine_cfg: dict, dist: dict) -> list[int]:
    """One prompt length in each bucket the mix reaches."""
    out, lo = [], 0
    for b in buckets_used(engine_cfg, dist):
        out.append(max(dist["min"], min(b, dist["max"]), lo + 1))
        lo = b
    return out


def sample(finished: list, seed: int, n: int) -> list:
    """n finished requests drawn from the seed, the longest (most served
    tokens, then longest prompt) always among them."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: (
        len(finished[i]["ids"]), len(finished[i]["prompt"])))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)),
                      replace=False).tolist() if rest else []
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def judge_served(torch, ctx, picked: list, device) -> dict:
    """The reference over the sampled requests: the compared numbers, the
    control's with ``ctx.control``."""
    from gpubench.reference import serve

    seqs = [(r["prompt"] + r["ids"], len(r["prompt"])) for r in picked]
    precisions = (("f32", "fp8", "bf16", "published") if ctx.control
                  else ("f32",))
    recs = serve.served_gaps(torch, ctx.cfg, ctx.seed, device, seqs,
                             precisions)
    worst = sorted(((g, i, j, seqs[i][1],
                     (rec.get("margin") or [None] * (j + 1))[j])
                    for i, rec in enumerate(recs)
                    for j, g in enumerate(rec["gap"])), reverse=True)[:5]
    values = check.served(recs)
    out = {"values": values,
           "served_tokens": sum(len(r["ids"]) for r in picked),
           "requests": len(picked),
           # (gap, request, served position, prompt length, routing margin)
           "worst": [list(w) for w in worst]}
    if ctx.control:
        out["control"] = check.served(recs, "control")
        for key in ("bf16", "published"):
            out[key] = check.served(recs, key)
    return out


def percentile(values: list, q: float) -> float:
    """numpy's linear percentile; a missing value (inf) counts above all."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
