"""The numbers that decide ``correct``, each against its limit from
``limits/<cell>.json``.

Served cells: the reference's gap of every served token of the sampled
requests (``reference/serve.py``): the mean over all of them
(``gap_mean``), and the widest (``gap_max_clear``) over the tokens chosen
where the reference's routing is clear of a tie: in every layer the
token's k-th expert leads the next by at least ``CLEAR_MARGIN`` in log
probability. Where two experts' probabilities are nearer than that, bf16
rounding of the router's logits may pick either, and the other expert
moves the token's logits by up to ~2 (a tenth of the positions of a
sample); such positions count in the mean, where the float8 control
reads five to six times higher, but would make the widest gap the
widest flip.
The widest gap over all served tokens is reported beside them
(``gap_max``), not compared.

Training cells (``reference/train.py``), each as a relative gap between the program's reading and the reference's:
``loss_gap``, the worst of the checked steps' losses; ``grad_gap``, the
worst leaf's first-gradient norm; ``change_gap``, the worst leaf's norm of
its change over the checked steps. A leaf's gap is measured against the
larger of its own reference norm and the median leaf's. Leaves whose
reference first gradient is under a thousandth of the median leaf's
(GPT-2's key bias, whose gradient softmax cancels) move by round-off
alone and are left out of ``change_gap`` by that rule.
"""

from __future__ import annotations

import statistics

from gpubench.common import load_json, named_file

TINY_GRAD = 1e-3
CLEAR_MARGIN = 0.05


def limits(cell: str) -> dict:
    return load_json(named_file("limits", cell))["checks"]


def served(records: list, key: str = "gap") -> dict:
    """The compared numbers of the program's tokens, or of the control's
    first choices with key="control"."""
    gaps = [g for r in records for g in r[key]]
    clear = [g for r in records
             for g, m in zip(r[key], r.get("margin") or [None] * len(r[key]))
             if m is None or m >= CLEAR_MARGIN]
    return {"gap_mean": statistics.fmean(gaps),
            "gap_max_clear": max(clear) if clear else None,
            "gap_max": max(gaps), "clear_tokens": len(clear)}


def _leaf_gap(prog: dict, ref: dict, names) -> float:
    med = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def trained(prog: dict, ref: dict) -> dict:
    """prog and ref: {"losses", "grad_norms", "change_norms"}."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                    ref["losses"])]
    g_med = statistics.median(ref["grad_norms"].values())
    moving = [n for n, g in ref["grad_norms"].items()
              if g >= TINY_GRAD * g_med]
    return {"loss_gap": max(losses),
            "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                  ref["grad_norms"]),
            "change_gap": _leaf_gap(prog["change_norms"],
                                    ref["change_norms"], moving)}


def judge(values: dict, lims: dict) -> tuple[bool, dict]:
    """Every number with a limit against it; a number the run could not
    read (a sample with no clear token) fails."""
    checks = {k: {"value": values.get(k), "limit": lim["limit"]}
              for k, lim in lims.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
