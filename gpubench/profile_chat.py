"""The engine's device-trace hook in the chat cell's setting.

One ``mixtral-chat`` run, untraced (as ``run.py --trace 0``: the harness's
own trace slice stays off, since one profiler runs at a time), with the
replica's profile routes on (``LLMConfig.profile_routes``), during which
the load generator's process asks the replica over HTTP, after a half
second's profile early in the arrival ramp that pays the process's first
profiler start, for
``/start_profile`` ``trace_start_s`` into the window and ``/stop_profile``
``trace_length_s`` after it has started (30 s and 8 s in
``traffic/chat.json``), and reads ``/v1/stats`` one trace length before
the hook, before each of its two calls, and one trace length after the
stop's answer: the decode step with the hook off, on (its start included),
and off again.

    python3 gpubench/profile_chat.py --seed <n> [--seconds 50] [--out FILE]

Prints the run's result line, then one line of its own: the hook's result
(``LLMEngine.stop_profile``), the three windows' engine counters, and under
``errors`` each hook call that failed with the proxy's answer. With
``--out`` the same line is written to FILE.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from gpubench import run  # noqa: E402
from gpubench.common import HarnessError, strict_json, watchdog  # noqa: E402
from gpubench import serving  # noqa: E402
from gpubench.drivers import serve_http  # noqa: E402
from gpubench.http_client import get_json  # noqa: E402

WARM_AT_S = 2.0   # into the arrival ramp
WARM_S = 0.5


def _post_json(host: str, port: int, path: str, timeout: float = 300.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://{host}:{port}{path}", data=b"",
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise RuntimeError(f"POST {path}: HTTP {e.code}: "
                           f"{e.read()[:2000]!r}") from e


def _window(a: dict, b: dict) -> dict:
    """The engine's decode counters between two /v1/stats reads."""
    d = {k: b[k] - a[k] for k in ("decode_steps", "decode_slot_steps",
                                  "decode_seconds", "decode_launch_seconds",
                                  "decode_sync_seconds",
                                  "decode_launch_cpu_seconds")}
    n = d["decode_steps"] or float("nan")
    return {"s": b["t"] - a["t"], "decode_steps": d["decode_steps"],
            "decode_step_ms": 1e3 * d["decode_seconds"] / n,
            "decode_launch_ms": 1e3 * d["decode_launch_seconds"] / n,
            "decode_sync_ms": 1e3 * d["decode_sync_seconds"] / n,
            "launch_cpu_share": 100.0 * d["decode_launch_cpu_seconds"]
            / (d["decode_launch_seconds"] or float("nan")),
            "decode_rows": d["decode_slot_steps"] / n}


def main(argv=None, **run_kw) -> dict:
    """One run; `run_kw` go to ``run.main`` (the CPU rehearsal's small
    model)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=50.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    got: dict = {}
    errors: dict = {}
    load, make_config = serve_http._load, serving.llm_config

    async def hook(ctx, host, port, marks):
        loop = asyncio.get_running_loop()

        async def call(route):
            t = time.perf_counter()
            try:
                got[route[1:]] = await loop.run_in_executor(
                    None, _post_json, host, port, serve_http.PREFIX + route)
            except Exception as e:  # noqa: BLE001 — kept in the line
                errors[f"{len(errors)}{route}"] = repr(e)
            got[route[1:] + "_call_s"] = time.perf_counter() - t

        while "w0" not in marks:
            await asyncio.sleep(0.01)
        # a short profile early in the arrival ramp pays the process's
        # first profiler start (CUPTI's set-up) before the windows
        await asyncio.sleep(WARM_AT_S)
        await call("/start_profile")
        await asyncio.sleep(WARM_S)
        await call("/stop_profile")
        got["warm"] = {k: got.pop(k) for k in list(got)}
        length = ctx.mix["trace_length_s"]
        at = marks["w0"] + ctx.mix["trace_start_s"] - length
        stats = serve_http.PREFIX + "/v1/stats"
        reads = []
        for route in (None, "/start_profile", "/stop_profile", None):
            await asyncio.sleep(max(0.0, at - time.perf_counter()))
            st = await loop.run_in_executor(None, get_json, host, port,
                                            stats)
            reads.append(dict(st, t=time.perf_counter()))
            if route is not None:
                await call(route)
            # the next read one trace length after this one's answer
            at = time.perf_counter() + length
        got["windows"] = {name: _window(a, b) for name, a, b in zip(
            ("off_before", "on", "off_after"), reads, reads[1:])}

    async def load_with_hook(ctx, host, port, sched, handle, marks):
        side = asyncio.create_task(hook(ctx, host, port, marks))
        try:
            return await load(ctx, host, port, sched, handle, marks)
        finally:
            await side

    def config_with_routes(*a, **kw):
        cfg = make_config(*a, **kw)
        cfg.profile_routes = True
        return cfg

    serve_http._load, serving.llm_config = load_with_hook, config_with_routes
    try:
        line = run.main(["--workload", "mixtral-chat", "--seed",
                         str(args.seed), "--seconds", str(args.seconds),
                         "--trace", "0"], **run_kw)
    finally:
        serve_http._load, serving.llm_config = load, make_config
    hooked = got.get("stop_profile") or {}
    warm = got.get("warm", {}).get("stop_profile", {})
    out = {"seed": args.seed, "device": line["device"],
           "correct": line["correct"], "e2e": line["metrics"],
           "hook": hooked, "windows": got.get("windows"),
           "calls_s": {k: got.get(k) for k in ("start_profile_call_s",
                                               "stop_profile_call_s")},
           "warm": {k: warm.get(k) for k in (
               "window_s", "kernels", "profiler_start_s", "profiler_stop_s",
               "reduce_s")}
           | {k: got.get("warm", {}).get(k) for k in (
               "start_profile_call_s", "stop_profile_call_s")},
           "idle_by_phase_sum_s": sum(
               hooked.get("idle_s_by_phase", {}).values()),
           "errors": errors}
    text = json.dumps(strict_json(out), allow_nan=False)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return out


if __name__ == "__main__":
    watchdog(run.DEADLINE_S)
    try:
        main()
    except HarnessError as e:
        print(f"gpubench: {e}", file=sys.stderr)
        sys.exit(2)
