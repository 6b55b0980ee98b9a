"""Find the highest arrival rate a serving cell sustains, once, on the
card: one app, the cell's mix at each rate in turn (its warm-up, a window,
then a drain), printing per rate the window's TTFT p90 and ITL p99, the
served tokens a second, the TTFT p90 of the window's first and last
quarters and the engine's queue at the window's end. A rate whose queue
grows through the window (the last quarter's TTFT far above the first's,
requests still waiting at its end) is beyond capacity. A window has to
be several times a request's length: at 40 s against chat streams of
~23 s, a rate 1.35 times the proxy's capacity read as sustained.

    python3 gpubench/sweep.py --workload mixtral-chat --seed 1 \\
        --seconds 40 --rates 1.5 2 2.5 3 3.5 4
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
import types

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from gpubench.common import (ROOT, Clock, benchmark, load_json,  # noqa: E402
                             named_file, prepare_environment, require_cards)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=40)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    prepare_environment()
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    from gpubench import serving, traffic
    from gpubench.drivers import serve_http as sh
    from gpubench.drivers.common import percentile
    from gpubench.http_client import get_json

    bench = benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = load_json(os.path.join(ROOT, next(
        c for c in bench["configs"] if c["name"] == cell["config"])["file"]))
    mix = load_json(named_file("traffic", cell["traffic"]))
    require_cards(torch, cell["chips"])
    ctx = types.SimpleNamespace(cell=cell["name"], cfg=cfg, mix=mix,
                                seed=args.seed, seconds=args.seconds,
                                trace=False, device="cuda", clock=Clock(),
                                control=False, fault=None)
    rt.init(num_cpus=4)
    try:
        handle, host, port = sh._start(ctx)
        sh._warm(host, port, ctx)
        vocab = serving.port_model(torch, cfg).vocab_size
        for rate in args.rates:
            m = dict(mix, rate_per_s=rate, wait_s=30.0, tail_s=0.0)
            c = types.SimpleNamespace(**dict(vars(ctx), mix=m))
            sched = [r for r in traffic.open_schedule(m, args.seed,
                                                      args.seconds, vocab)
                     if r["phase"] != "tail"]
            marks: dict = {}
            recs = asyncio.run(sh._load(c, host, port, sched, handle, marks))
            waiting = get_json(host, port, sh.PREFIX + "/v1/stats")
            ttft = [1e3 * (r["t_tokens"][0] - r["due"]) if r["t_tokens"]
                    else float("inf") for r in recs]
            gaps = [1e3 * (b - a) for r in recs
                    for a, b in zip(r["t_tokens"], r["t_tokens"][1:])]
            q = max(1, len(ttft) // 4)
            toks = sum(len(r["ids"]) for r in recs)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(recs),
                "ttft_p90_ms": percentile(ttft, 90),
                "itl_p99_ms": percentile(gaps, 99),
                "ttft_p90_first_quarter_ms": percentile(ttft[:q], 90),
                "ttft_p90_last_quarter_ms": percentile(ttft[-q:], 90),
                "tokens_per_s_served": toks / args.seconds,
                "waiting_at_close": waiting["waiting"],
                "active_at_close": waiting["active"],
                "unfinished": sum(1 for r in recs if not r.get("done"))}),
                flush=True)
            # drain before the next rate
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                st = get_json(host, port, sh.PREFIX + "/v1/stats")
                if st["active"] == 0 and st["waiting"] == 0:
                    break
                time.sleep(1.0)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()


if __name__ == "__main__":
    main()
