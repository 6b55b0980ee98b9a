"""Run one cell of BENCHMARK.json once and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (a reader in ``metrics/<name>.py``
each, or one that every cell shares, ``common.metric_file``) and the device trace's busy and window seconds and breakdown. Either
way the run checks what its window produced against the reference and
prints each compared number beside its limit, last on stderr and last in
the line (``"checks"``). A run that cannot measure (no CUDA card, too few
cards, a file missing, JAX or the JAX package loaded) exits non-zero and
prints no line.

Hidden options, for the checks' calibration and tests only: ``--control
1`` also runs the float8 control over the same sample (and, where served,
the reference with bf16 matmuls and the published model where the
reference follows a departure of the port), ``--fault <name>``
plants a fault of ``faults.py`` under the timed path.
"""

from __future__ import annotations

import argparse
import os
import sys
import traceback
import types

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from gpubench import check  # noqa: E402
from gpubench.common import (ROOT, Clock, HarnessError,  # noqa: E402
                             benchmark, emit, forbidden_modules, load_json,
                             load_module, metric_file, named_file,
                             prepare_environment,
                             require_cards, watchdog)

# a run ends within 360 s; the watchdog leaves room to stop the workers
DEADLINE_S = 345


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def main(argv=None, *, device: str = "cuda", cfg_update: dict | None = None,
         mix_update: dict | None = None) -> dict:
    """One run; returns the result line. `device`, `cfg_update` and
    `mix_update` are for the harness's CPU tests (a small model, no card)."""
    clock = Clock()
    args = parse(argv)
    prepare_environment()
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        raise HarnessError(f"no cell {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    cfg = load_json(os.path.join(ROOT, next(
        c for c in bench["configs"] if c["name"] == cell["config"])["file"]))
    mix = load_json(named_file("traffic", cell["traffic"]))
    for key, val in (cfg_update or {}).items():
        cfg[key] = dict(cfg[key], **val) if isinstance(val, dict) else val
    mix.update(mix_update or {})
    lims = check.limits(cell["name"])
    import torch

    if device == "cuda":
        require_cards(torch, cell["chips"])
    import importlib

    driver = importlib.import_module(f"gpubench.drivers.{mix['driver']}")
    ctx = types.SimpleNamespace(
        cell=cell["name"], cfg=cfg, mix=mix, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=device,
        clock=clock, control=bool(args.control), fault=args.fault)
    out = driver.run(ctx)

    loaded = forbidden_modules()
    if loaded:
        raise HarnessError(f"loaded after the window: {loaded}")
    judged = out["judged"]
    ok, checks = check.judge(judged["values"], lims)
    checks["failed_requests"] = {"value": out["failed"], "limit": 0}
    correct = ok and out["failed"] == 0 and out["attempted"] > 0
    dev = dict(out["device"])
    platform = dev.pop("platform")
    device_line = {"platform": "gpu" if platform == "cuda" else platform,
                   "kind": dev.get("kind", platform),
                   "count": cell["chips"],
                   "memory_peak_bytes": dev.get("memory_peak_bytes", 0)}
    if args.trace:
        metrics = {}
        tr = out["trace"]
        for m in bench["per_layer"]:
            if not applies(m, cell["name"]):
                continue
            reader = load_module(metric_file(m["name"]),
                                 "gpubench_metric_" + m["name"])
            value = reader.read(out["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            device_line.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, cell["name"])}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_line}
    if args.trace and out["trace"] is not None:
        from gpubench import trace

        result["breakdown"] = trace.breakdown(out["trace"])
    witnesses = ("control", "bf16", "published")
    result["reference"] = {k: v for k, v in judged.items()
                           if k not in ("values",) + witnesses}
    result["reference"]["values"] = {k: v for k, v in judged["values"].items()
                                     if k not in lims}
    for key in witnesses:
        if key in judged:
            result[key] = judged[key]
    if out.get("notes"):
        result["notes"] = out["notes"]
    return emit(result, checks)


if __name__ == "__main__":
    watchdog(DEADLINE_S)
    try:
        main()
    except HarnessError as e:
        print(f"gpubench: {e}", file=sys.stderr)
        sys.exit(2)
    except Exception:  # noqa: BLE001 — no result line, a non-zero exit
        traceback.print_exc()
        sys.exit(1)
