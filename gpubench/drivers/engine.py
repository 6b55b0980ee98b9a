"""Offline batch inference: the port's ``LLMEngine`` in this process,
built through ``LLMEngine.from_config`` as the Serve replica and
``llm/batch.py``'s engine actor build it, and driven through ``submit`` and
its stream by a closed loop of ``outstanding_per_slot x max_slots``
clients, each submitting its next request when the last one ends.

End to end: ``batch_tok_s``, the prompt tokens prefilled (a request whose
first token came in the window) plus the tokens served in the window, over
the window.
"""

from __future__ import annotations

import gc
import threading
import time

from gpubench import serving, traffic
from gpubench.drivers.common import judge_served, sample, warm_lengths


def _client(engine, sp_cls, stream, lock, stop, done: list):
    while not stop.is_set():
        with lock:
            spec = next(stream)
        rec = {"prompt": spec["prompt"], "ids": [], "t_tokens": [],
               "t_submit": time.perf_counter()}
        try:
            req = engine.submit(spec["prompt"],
                                sp_cls(max_tokens=spec["max_tokens"]))
            for tok in req:
                rec["t_tokens"].append(time.perf_counter())
                rec["ids"].append(int(tok))
            rec["done"] = len(rec["ids"]) == spec["max_tokens"]
        except Exception as e:  # noqa: BLE001 — counted as failed
            rec["error"] = f"{type(e).__name__}: {e}"
        with lock:
            done.append(rec)


def _counters(engine) -> dict:
    st = engine.stats()
    return {"t": time.perf_counter(), "decode_steps": st["decode_steps"],
            "decode_seconds": st["decode_seconds"],
            "prefills": st["prefills"],
            "prefill_seconds": st["prefill_seconds"],
            "decode_slot_steps": engine.decode_slot_steps,
            "max_slots": st["max_slots"]}


def run(ctx) -> dict:
    import torch

    from ray_tpu_torch.llm import LLMEngine, SamplingParams

    cfg, mix = ctx.cfg, ctx.mix
    engine = LLMEngine.from_config(serving.llm_config(
        cfg, ctx.seed, ctx.device, {}, fault=ctx.fault))
    vocab = engine.cfg.vocab_size
    ctx.clock.mark("engine built")
    # set-up: one prompt in each bucket of the mix, at its longest output
    for n in warm_lengths(cfg["engine"], mix["prompt_tokens"]):
        engine.generate(list(range(n)), SamplingParams(
            max_tokens=mix["output_tokens"]["max"]))
    stream = traffic.closed_stream(mix, ctx.seed, vocab)
    lock, stop, done = threading.Lock(), threading.Event(), []
    clients = [threading.Thread(
        target=_client, args=(engine, SamplingParams, stream, lock, stop,
                              done), daemon=True)
        for _ in range(mix["outstanding_per_slot"] * engine.max_slots)]
    for t in clients:
        t.start()
    time.sleep(mix["warmup_s"])            # the queue fills, slots settle
    w0 = time.perf_counter()
    setup_s = ctx.clock.since_start(w0)
    before = after = tr = None
    if ctx.trace:
        from gpubench import trace

        # the counters over the window up to the slice, which slows the
        # host-bound decode step it records
        before = _counters(engine)
        time.sleep(mix["trace_start_s"])
        after = _counters(engine)
        sl = trace.Slice(torch)
        time.sleep(mix["trace_length_s"])
        sl.stop()
    time.sleep(max(0.0, w0 + ctx.seconds - time.perf_counter()))
    w1 = time.perf_counter()
    stop.set()
    for t in clients:
        t.join(timeout=mix["wait_s"])
    if ctx.trace:
        tr = sl.read()
    device = {"platform": engine.device.type}
    if engine.device.type == "cuda":
        device.update(kind=torch.cuda.get_device_name(engine.device),
                      memory_peak_bytes=torch.cuda.max_memory_allocated(
                          engine.device))
    ctx.clock.mark("window's requests done")
    engine.shutdown()
    del engine
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    with lock:
        recs = list(done)
    window = [r for r in recs if w0 <= r["t_submit"] < w1]
    tokens = sum(len(r["prompt"]) for r in recs
                 if r["t_tokens"] and w0 <= r["t_tokens"][0] < w1)
    tokens += sum(1 for r in recs for t in r["t_tokens"] if w0 <= t < w1)
    finished = [r for r in window if r.get("done")]
    picked = sample(finished, ctx.seed, mix["sample_requests"])
    judged = judge_served(torch, ctx, picked, ctx.device)
    ctx.clock.mark("reference done")
    return {"e2e": {"batch_tok_s": tokens / (w1 - w0), "setup_s": setup_s},
            "attempted": len(window),
            "failed": len(window) - len(finished),
            "device": device, "judged": judged, "trace": tr,
            "layer": {"before": before, "after": after, "records": recs,
                      "trace": tr, "cfg": cfg}}
