"""The LLM engine's scheduler pass, timed where it runs: the decode step's
launch and sync counters, the queue_wait and prefill phases and their
spans, and the device-trace hook (``start_profile``/``stop_profile``) that
puts the device's idle time down to the engine phase that was open.

On the CPU the hook's profiler records the scheduler thread's CPU ops in
the kernels' place, so a planted sleep is idle the reduction can place."""

from __future__ import annotations

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch._private import task_events
from ray_tpu_torch.llm import LLMConfig, ModelLoadingConfig
from ray_tpu_torch.llm import engine as engine_mod
from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.server import LLMServer
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.util import device_trace
from ray_tpu_torch.util import metrics as met
from ray_tpu_torch.util import tracing

TINY = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2,
                         n_kv_heads=2, d_ff=64, max_seq_len=64,
                         dtype=torch.float32)
PROMPTS = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 14]]


@pytest.fixture(scope="module")
def params():
    return transformer.init(torch.Generator().manual_seed(0), TINY,
                            torch.device("cpu"), dtype=torch.float32)


@pytest.fixture
def make(params):
    engines = []

    def build(**kw):
        kw = {"max_slots": 4, "max_len": 64, "min_bucket": 8,
              "device": "cpu", **kw}
        engines.append(LLMEngine(TINY, params, **kw))
        return engines[-1]

    yield build
    for eng in engines:
        eng.shutdown()


def hold(eng):
    """Until the returned event is set, the scheduler waits at the top of
    its next pass: requests submitted meanwhile meet one pass."""
    gate = threading.Event()
    sync = eng._sync_pass

    def gated():
        gate.wait(timeout=60)
        return sync()

    eng._sync_pass = gated
    return gate


def run_all(eng, prompts=PROMPTS, max_tokens=8, gate=None):
    reqs = [eng.submit(p, SamplingParams(max_tokens=max_tokens))
            for p in prompts]
    if gate is not None:
        gate.set()
    return [list(r) for r in reqs], reqs


def engine_phases():
    for m in met.snapshot():
        if m["name"] == "ray_tpu_llm_engine_phase_seconds":
            return {dict(tuple(t) for t in tags)["phase"]:
                    (st["sum"], st["count"]) for tags, st in m["series"]}
    return {}


@pytest.mark.parametrize("kw", [{}, {"kv_layout": "paged", "page_size": 8},
                                {"speculative_k": 2}],
                         ids=["slot", "paged", "speculative"])
def test_launch_and_sync_split_the_decode_step(make, kw):
    eng = make(**kw)
    outs, _ = run_all(eng)
    assert all(len(o) == 8 for o in outs)
    st = eng.stats()
    launch, sync = st["decode_launch_seconds"], st["decode_sync_seconds"]
    assert launch > 0 and sync > 0
    assert 0.9 * st["decode_seconds"] <= launch + sync \
        <= st["decode_seconds"] * (1 + 1e-9)
    # the thread's CPU seconds lie inside the launch's wall seconds
    assert 0 < st["decode_launch_cpu_seconds"] <= launch * 1.01 + 1e-4


def test_decode_rows_are_the_live_rows(make):
    """Four requests that meet one pass, each of 8 tokens: one from its
    prefill, then 7 decode steps of all four rows."""
    eng = make(max_prefills_per_step=4)
    gate = hold(eng)
    run_all(eng, gate=gate)
    st = eng.stats()
    assert st["decode_steps"] == 7
    assert st["decode_slot_steps"] == 4 * 7


@pytest.mark.parametrize("kw", [{}, {"kv_layout": "paged", "page_size": 8,
                                     "prefill_chunk": 8}],
                         ids=["slot", "chunked"])
def test_queue_wait_and_prefill_end_at_the_first_token(make, kw):
    """queue_wait + prefill is submit → the first token's stamp, request by
    request; a scheduler held for 50 ms puts that wait in queue_wait."""
    eng = make(**kw)
    firsts: dict = {}
    emit = eng._emit

    def stamped(req, token_id, now):
        firsts.setdefault(req.rid, now)
        return emit(req, token_id, now)

    eng._emit = stamped
    gate = hold(eng)
    before = engine_phases()
    prompts = PROMPTS + [list(range(1, 20))]  # 3 chunks of 8 when chunked
    reqs = [eng.submit(p, SamplingParams(max_tokens=4)) for p in prompts]
    time.sleep(0.05)
    gate.set()
    for r in reqs:
        assert len(list(r)) == 4
    after = engine_phases()
    qw = after["queue_wait"][0] - before.get("queue_wait", (0, 0))[0]
    pf = after["prefill"][0] - before.get("prefill", (0, 0))[0]
    assert after["queue_wait"][1] - before.get("queue_wait", (0, 0))[1] \
        == len(prompts)
    assert after["prefill"][1] - before.get("prefill", (0, 0))[1] \
        == len(prompts)
    want = sum(firsts[r.rid] - r.submitted_ts for r in reqs)
    assert qw + pf == pytest.approx(want, abs=1e-6)
    for r in reqs:
        assert r.submitted_ts + 0.05 <= r.started_ts <= firsts[r.rid]
    if kw:
        assert eng.stats()["prefill_chunks_run"] >= 3


def test_a_sampled_request_carries_its_engine_spans(make, monkeypatch):
    events = []
    monkeypatch.setattr(task_events, "emit",
                        lambda event, **kw: events.append(dict(kw,
                                                               event=event)))
    eng = make()
    rid = "ab" * 16
    with tracing.request_trace(rid) as ctx:
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=4))
    unsampled = eng.submit([4, 5, 6], SamplingParams(max_tokens=4))
    assert len(list(req)) == 4 and len(list(unsampled)) == 4
    spans = {e["name"]: e for e in events if e["event"] == "trace:span"}
    assert {"llm:queue_wait", "llm:prefill", "serve:request"} \
        <= set(spans), sorted(spans)
    assert len(events) == 3  # the unsampled request emitted nothing
    qw, pf = spans["llm:queue_wait"], spans["llm:prefill"]
    assert qw["parent_span_id"] == pf["parent_span_id"] == ctx["span_id"]
    assert qw["request_id"] == pf["request_id"] == rid
    assert qw["start"] == req.submitted_ts and qw["end"] == pf["start"] \
        == req.started_ts <= pf["end"]
    tree = tracing.assemble(events, rid)
    assert {c["name"] for c in tree["root"]["children"]} \
        == {"llm:queue_wait", "llm:prefill"}


def test_with_the_hook_off_the_pass_records_no_span(make, monkeypatch):
    calls = []
    monkeypatch.setattr(LLMEngine, "_phase",
                        lambda self, name: calls.append(name))
    eng = make(kv_layout="paged", page_size=8, prefill_chunk=8)
    outs, _ = run_all(eng, PROMPTS + [list(range(1, 20))])
    assert all(len(o) == 8 for o in outs)
    assert calls == [] and eng._spans is None


def _plant_sleep(eng, phase: str, seconds: float) -> list:
    """A sleep in every call of the method that runs in `phase`, while the
    hook is on; returns the list of the sleeps' lengths."""
    slept = []
    name = {"sched": "_sync_pass", "emit": "_emit",
            "decode_launch": "_decode_step"}[phase]
    orig = getattr(eng, name)

    def slow(*a, **kw):
        if eng._spans is not None:
            t = time.perf_counter()
            time.sleep(seconds)
            slept.append(time.perf_counter() - t)
        return orig(*a, **kw)

    setattr(eng, name, slow)
    return slept


@pytest.mark.parametrize("phase", ["sched", "emit", "decode_launch"])
def test_the_hook_puts_a_planted_stall_down_to_its_phase(make, phase):
    eng = make(kv_layout="paged", page_size=8)
    slept = _plant_sleep(eng, phase, 0.005)
    t0 = eng.start_profile()
    outs, _ = run_all(eng)
    out = eng.stop_profile()
    assert all(len(o) == 8 for o in outs)
    assert abs(out["start"] - t0) < 1e-6 and slept
    idle = out["idle_s_by_phase"]
    assert idle.get(phase, 0.0) >= 0.9 * sum(slept), (sum(slept), idle)
    assert sum(idle.values()) == pytest.approx(out["idle_s"], rel=1e-9)
    assert out["busy_s"] + out["idle_s"] == pytest.approx(out["window_s"],
                                                          rel=1e-9)
    assert out["kernels"] > 0 and out["spans"] > 0
    assert out["spans_dropped"] == 0 and eng._spans is None
    assert set(out["phase_s"]) <= {"sched", "admit", "prefill",
                                   "decode_launch", "decode_sync", "emit",
                                   "wait"}


def test_the_hook_refuses_a_second_start_and_a_stop_without_start(make):
    eng = make()
    with pytest.raises(RuntimeError, match="no profile is on"):
        eng.stop_profile()
    eng.start_profile()
    with pytest.raises(RuntimeError, match="already on"):
        eng.start_profile()
    assert eng.stop_profile()["window_s"] > 0
    assert len(eng.generate([1, 2, 3], SamplingParams(max_tokens=3))) == 3


def test_an_unstopped_profile_ends_at_the_cap(make, monkeypatch):
    """A profile nobody stops ends after PROFILE_SLICE_MAX_S, by the
    scheduler itself, idle or serving; a later stop returns that slice's
    result, again until the next start."""
    monkeypatch.setattr(engine_mod, "PROFILE_SLICE_MAX_S", 0.3)
    eng = make()
    t0 = eng.start_profile()
    outs, _ = run_all(eng, max_tokens=4)
    deadline = time.monotonic() + 10
    while eng._prof is not None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng._prof is None and eng._spans is None
    out = eng.stop_profile()
    assert out["capped"] and out["start"] == pytest.approx(t0)
    # the idle loop passes at least every 0.1 s
    assert 0.3 < out["window_s"] < 0.3 + 0.5
    assert out["kernels"] > 0 and sum(out["idle_s_by_phase"].values()) \
        == pytest.approx(out["idle_s"], rel=1e-9)
    assert eng.stop_profile() == out
    eng.start_profile()
    again = eng.stop_profile()
    assert not again["capped"] and again["start"] > out["start"]
    assert all(len(o) == 4 for o in outs)


def test_a_profile_call_that_times_out_leaves_the_engine_serving(
        make, monkeypatch):
    """A start whose caller gave up before the scheduler took it is
    withdrawn: the scheduler never runs it and keeps serving."""
    monkeypatch.setattr(engine_mod, "PROFILE_CALL_TIMEOUT_S", 0.1)
    eng = make()
    gate = hold(eng)
    time.sleep(0.15)  # the scheduler now waits in its held pass
    with pytest.raises(TimeoutError, match="took no profile start"):
        eng.start_profile()
    assert eng._prof_req is None
    outs, _ = run_all(eng, max_tokens=4, gate=gate)
    assert all(len(o) == 4 for o in outs) and eng._error is None
    assert eng._prof is None
    with pytest.raises(RuntimeError, match="no profile is on"):
        eng.stop_profile()


def _tiny_server(**kw):
    cfg = LLMConfig(
        model_loading_config=ModelLoadingConfig(model_id="tiny",
                                                tokenizer="byte"),
        model_family="llama",
        engine_kwargs=dict(device="cpu", max_slots=2, max_len=64,
                           min_bucket=8), **kw)
    return LLMServer.func_or_class(cfg)


def test_the_profile_routes_are_off_unless_asked_and_take_post_only():
    server = _tiny_server()
    try:
        for route in ("/llm/start_profile", "/llm/stop_profile"):
            with pytest.raises(PermissionError, match="profile routes"):
                server({"path": route, "method": "POST"})
        assert server.engine._prof is None
    finally:
        server.engine.shutdown()
    server = _tiny_server(profile_routes=True)
    try:
        for method in ("GET", None):
            with pytest.raises(ValueError, match="takes POST"):
                server({"path": "/llm/start_profile", "method": method})
        assert server.engine._prof is None
    finally:
        server.engine.shutdown()


def test_the_server_routes_start_and_stop_the_hook():
    server = _tiny_server(profile_routes=True)
    try:
        started = server({"path": "/llm/start_profile", "method": "POST"})
        out = server({"path": "/llm/v1/completions", "method": "POST",
                      "body": {"prompt": "hi", "max_tokens": 3}})
        assert out["usage"]["completion_tokens"] >= 1
        got = server({"path": "/llm/stop_profile", "method": "POST"})
        assert got["start"] == pytest.approx(started["start"])
        assert got["kernels"] > 0 and "idle_s_by_phase" in got
        assert {"decode_launch_seconds", "decode_sync_seconds",
                "decode_launch_cpu_seconds", "decode_slot_steps"} \
            <= set(server({"path": "/llm/v1/stats", "method": "GET"}))
    finally:
        server.engine.shutdown()


def test_reduce_cuts_idle_at_the_phase_bounds():
    """Busy is the union of the events; each idle interval is cut at the
    spans' bounds, `outside` where no span was open."""
    events = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 60, 70)]
    spans = [("x", 0, 25), ("y", 25, 45)]
    out = device_trace.reduce(events, 0, 50, spans)
    assert out["busy_s"] == pytest.approx(30e-9)
    assert out["idle_s"] == pytest.approx(20e-9)
    assert out["idle_s_by_phase"] == pytest.approx(
        {"x": 5e-9, "y": 10e-9, "outside": 5e-9})
    assert out["phase_s"] == pytest.approx({"x": 25e-9, "y": 20e-9})
    assert out["kernels"] == 4 and out["top_kernels_s"][0][0] == "b"


def test_a_profiler_event_lies_inside_the_time_ns_span_that_issued_it():
    a = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        torch.mm(a, a)
        t1 = time.time_ns()
    mm = [(s, e) for n, s, e in device_trace.kernel_events(prof, False)
          if n == "aten::mm"]
    assert len(mm) == 1
    assert t0 <= mm[0][0] <= mm[0][1] <= t1
