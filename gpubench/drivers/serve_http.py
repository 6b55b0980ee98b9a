"""Online serving over HTTP: the port's OpenAI app (``build_openai_app``:
HTTP proxy, router, an ``LLMServer`` replica holding the card, its
``LLMEngine``) under an open loop of streamed completions.

The load comes from one asyncio thread in this process: each request is
sent when it is due and timed from then, so a stall that delays later
sends counts against them. The arrival warm-up runs before the window; the
tail keeps the load on after it until the window's requests have finished
(at most ``wait_s``).

End to end: ``ttft_p90_ms`` over the window's requests (a failed one
counts as never served; a late one by its first token) and ``itl_p99_ms`` over every gap between two
served tokens of those requests: the stall a stream sees when another
request's prefill runs between two of its steps. (The 95th percentile
falls where the plain decode gaps end and those stalls begin, and read
19-43 % apart from run to run.)

A window's request ends ``finished`` (all its tokens), ``late`` (still
streaming when the wait ran out: no error, at least one token) or
``failed`` (an error, an early end, or no token by then). A late answer is
judged by what it served so far, beside the sample of finished ones; only
a failed one counts against ``correct``.
"""

from __future__ import annotations

import asyncio
import time

from gpubench import serving, traffic
from gpubench.drivers.common import (judge_served, percentile, sample,
                                     warm_lengths)
from gpubench.http_client import get_json, stream

APP = "llm"
PREFIX = "/llm"
READY_S = 240     # the replica's start, its weights and its kernels' build
WARM_S = 120      # one warm-up request
STOP_S = 90       # Serve's teardown, before the runtime's stops every worker


def _gcs_metrics() -> dict:
    from ray_tpu_torch._private.api import _get_worker

    return _get_worker().rpc({"type": "metrics_snapshot"}).get("metrics", {})


def _start(ctx):
    """The app with its replica ready; returns (handle, host, port)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app
    from ray_tpu_torch.serve.deployment import Deployment

    gpus = 1 if ctx.device == "cuda" else 0
    eng = ctx.cfg["engine"]
    app = build_openai_app(serving.llm_config(
        ctx.cfg, ctx.seed, ctx.device,
        {"ray_actor_options": {"num_gpus": gpus},
         # the slots are the engine's limit, not the replica's
         "max_ongoing_requests": 4 * eng["max_slots"]},
        fault=ctx.fault))
    dep = app.deployment
    app.deployment = Deployment(serving.bench_server(dep.func_or_class),
                                dep.name, dep.config)
    serve.start(http_port=0)
    host, port = serve.http_address()
    handle = serve.run(app, name=APP, route_prefix=PREFIX)
    full = f"{APP}_{dep.name}"
    deadline = time.monotonic() + READY_S
    while True:
        st = serve.status().get(full, {})
        health = set(st.get("replica_health", {}).values())
        if st.get("status") == "HEALTHY" and health == {"healthy"}:
            return handle, host, port
        if time.monotonic() > deadline:
            raise RuntimeError(f"{full} not healthy after {READY_S} s: {st}")
        time.sleep(0.05)


async def _load(ctx, host, port, sched, handle, marks: dict):
    """Send every request when due; close the window; wait for its
    requests; read counters around it in a thread."""
    loop = asyncio.get_running_loop()
    mix = ctx.mix
    path = PREFIX + mix["route"]
    t_start = time.perf_counter()
    w0 = t_start + mix["warmup_s"]
    w1 = w0 + ctx.seconds
    marks.update(w0=w0, w1=w1)
    tasks, window = [], []

    async def side():
        # traced runs: the counters over the window up to the slice, which
        # slows the host-bound step it records
        await asyncio.sleep(max(0.0, w0 - time.perf_counter()))
        if ctx.trace:
            marks["before"] = await loop.run_in_executor(
                None, _counters, host, port)
            await asyncio.sleep(mix["trace_start_s"])
            marks["after"] = await loop.run_in_executor(
                None, _counters, host, port)
            await loop.run_in_executor(
                None, lambda: handle.bench_trace_start.remote().result(
                    timeout_s=120))
            await asyncio.sleep(mix["trace_length_s"])
            await loop.run_in_executor(
                None, lambda: handle.bench_trace_stop.remote().result(
                    timeout_s=120))
        await asyncio.sleep(max(0.0, w1 - time.perf_counter()))

    side_task = asyncio.create_task(side())
    for r in sched:
        due = t_start + r["due_s"]
        if r["phase"] == "tail" and window and all(
                t.done() for t in window):
            break
        if r["phase"] == "tail" and time.perf_counter() > w1 + mix["wait_s"]:
            break
        await asyncio.sleep(max(0.0, due - time.perf_counter()))
        rec = {"prompt": r["prompt"], "max_tokens": r["max_tokens"],
               "due": due, "sent": time.perf_counter(), "phase": r["phase"]}
        body = {"prompt": " ".join(map(str, r["prompt"])),
                "max_tokens": r["max_tokens"], "temperature": 0.0}
        t = asyncio.create_task(stream(host, port, path, body, rec))
        t.rec = rec
        tasks.append(t)
        if r["phase"] == "window":
            window.append(t)
    await side_task
    rest = [t for t in window if not t.done()]
    if rest:
        await asyncio.wait(rest, timeout=max(
            0.0, w1 + mix["wait_s"] - time.perf_counter()))
    for t in tasks:
        if not t.done():
            t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return [t.rec for t in window]


def outcome(rec: dict) -> str:
    """"finished", "late" or "failed"; see the module's docstring."""
    if rec.get("done") and len(rec["ids"]) == rec["max_tokens"]:
        return "finished"
    if not rec.get("done") and not rec.get("error") and rec["ids"]:
        return "late"
    return "failed"


def _counters(host, port) -> dict:
    return {"t": time.perf_counter(),
            "stats": get_json(host, port, PREFIX + "/v1/stats"),
            "metrics": _gcs_metrics()}


def _warm(host, port, ctx) -> None:
    """One request in each prompt bucket the mix reaches, one at a time."""
    for n in warm_lengths(ctx.cfg["engine"], ctx.mix["prompt_tokens"]):
        rec = {}
        asyncio.run(asyncio.wait_for(stream(
            host, port, PREFIX + ctx.mix["route"], {
                "prompt": " ".join(str(i) for i in range(n)),
                "max_tokens": 4, "temperature": 0.0}, rec), WARM_S))
        if not rec.get("done"):
            raise RuntimeError(f"warm-up request of {n} tokens failed: "
                               f"{rec.get('error')}")


def _stop_serve() -> None:
    """Serve's teardown, waited for at most STOP_S: the runtime's shutdown
    that follows kills the proxy, the controller and the replica in any
    case, so a teardown that blocks leaves a mark and not a stalled run."""
    import sys
    import threading

    from ray_tpu_torch import serve

    t = threading.Thread(target=serve.shutdown, daemon=True,
                         name="gpubench-serve-shutdown")
    t.start()
    t.join(STOP_S)
    if t.is_alive():
        print(f"gpubench: serve.shutdown() still running after {STOP_S} s; "
              "stopping the runtime", file=sys.stderr, flush=True)


def run(ctx) -> dict:
    import torch

    import ray_tpu_torch as rt

    clock = ctx.clock
    rt.init(num_cpus=4)
    try:
        handle, host, port = _start(ctx)
        clock.mark("replica ready")
        _warm(host, port, ctx)
        clock.mark("warmed up")
        vocab = serving.port_model(torch, ctx.cfg).vocab_size
        sched = traffic.open_schedule(ctx.mix, ctx.seed, ctx.seconds, vocab)
        marks: dict = {}
        recs = asyncio.run(_load(ctx, host, port, sched, handle, marks))
        clock.mark("window's requests done")
        device = handle.bench_device.remote().result(timeout_s=120)
        tr = (handle.bench_trace_read.remote().result(timeout_s=120)
              if ctx.trace else None)
    finally:
        try:
            _stop_serve()
        finally:
            rt.shutdown()
    clock.mark("runtime stopped")
    if device.pop("forbidden"):
        raise RuntimeError("the replica loaded a forbidden module")
    ttft, gaps = [], []
    by = {"finished": [], "late": [], "failed": []}
    for r in recs:
        kind = outcome(r)
        by[kind].append(r)
        ttft.append(1e3 * (r["t_tokens"][0] - r["due"])
                    if kind != "failed" else float("inf"))
        gaps += [1e3 * (b - a) for a, b in zip(r["t_tokens"],
                                               r["t_tokens"][1:])]
    picked = sample(by["finished"], ctx.seed, ctx.mix["sample_requests"])
    judged = judge_served(torch, ctx, picked + by["late"], ctx.device)
    clock.mark("reference done")
    late = max((r["sent"] - r["due"] for r in recs), default=0.0)
    return {"e2e": {"ttft_p90_ms": percentile(ttft, 90),
                    "itl_p99_ms": percentile(gaps, 99),
                    "setup_s": ctx.clock.since_start(marks["w0"])},
            "attempted": len(recs), "failed": len(by["failed"]),
            "device": device, "judged": judged, "trace": tr,
            "notes": {"sender_late_max_s": late,
                      "ttft_ms": sorted(round(t, 1) for t in ttft),
                      "itl_ms_p50_p90_p95": [percentile(gaps, q)
                                             for q in (50, 90, 95)],
                      **{kind: [
                {"n": len(r["prompt"]), "max_tokens": r["max_tokens"],
                 "served": len(r["ids"]), "error": r.get("error"),
                 "due_after_window_start_s": r["due"] - marks["w0"]}
                for r in by[kind]][:5] for kind in ("late", "failed")}},
            "layer": {"before": marks.get("before"),
                      "after": marks.get("after"), "records": recs,
                      "trace": tr, "cfg": ctx.cfg}}
