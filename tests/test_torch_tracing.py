"""Tracing, metrics and request-phase attribution of the port against the
JAX package's.

- The PD plane's spans and phase observations: one sampled trace context
  through both packages' ``PagedKVExporter`` (a sync and a threaded
  ticket) and both pull paths gives equal span names, attribute keys and
  values, and equal ``ray_tpu_llm_pd_phase_seconds`` observations, read
  from each package's registry.
- Twins of tests/test_tracing.py (4), of tests/test_observability.py's
  config registry, metric registry, Prometheus rendering and escaping
  tests, and of the cases of tests/test_request_tracing.py that need
  neither the dashboard nor the CLI: the zero-emit guard, the sampled
  request's span tree, the sampled PD request's tree across processes,
  the flight recorder's ring, the GCS's RPC histograms, the chrome-trace
  rows and the engine's phase histograms.

The runtime cases run on the port's session only, held to the reference
tests' expected names and shapes (the JAX package's own files run the
same cases on its runtime); pure functions run through both packages and
must agree.
"""

from __future__ import annotations

import importlib
import json
import time
import urllib.request

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private import task_events
from ray_tpu_torch._private.ray_config import RayConfig
from ray_tpu_torch.util import metrics as met
from ray_tpu_torch.util import tracing

PKGS = ("ray_tpu", "ray_tpu_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ------------------------------------------------------- the plane's spans

TRACE_CTX = {"trace_id": "a" * 32, "parent_span_id": "b" * 16,
             "request_id": "a" * 32}
# the span attributes whose values both packages must agree on (the
# ticket, ids and clocks differ by nature)
SPAN_VALUES = ("name", "span_kind", "trace_id", "parent_span_id",
               "request_id", "ok", "pages", "failed", "sync")


def _pd_phase_counts(pkg: str) -> dict:
    for m in _mod(pkg, "util.metrics").snapshot():
        if m["name"] == "ray_tpu_llm_pd_phase_seconds":
            return {dict(tuple(t) for t in tags)["phase"]: st["count"]
                    for tags, st in m["series"]}
    return {}


def _plane_run(pkg: str, monkeypatch) -> tuple:
    """A sync ticket (one page), a threaded ticket pulled by pull_all and
    one pulled through a BatchedKVPuller (four pages each, one a
    message), all under TRACE_CTX: (spans as emitted, phase counts
    observed)."""
    kvt = _mod(pkg, "llm.kv_transfer")
    spans: list = []
    monkeypatch.setattr(_mod(pkg, "_private.task_events"), "emit",
                        lambda event, **kw: spans.append(
                            {"event": event, **kw}))
    rng = np.random.default_rng(5)
    kv = {T: [rng.normal(size=(2, T, 2, 8)).astype(np.float32)
              for _ in range(2)] for T in (16, 64)}
    if pkg == "ray_tpu_torch":
        kv = {T: [torch.from_numpy(a) for a in pair]
              for T, pair in kv.items()}
    before = _pd_phase_counts(pkg)
    exp = kvt.PagedKVExporter(send_timeout_s=30.0, prefetch_pages=1)
    puller = kvt.BatchedKVPuller()
    try:
        sync = exp.export(*kv[16], 16, 7, 16, trace_ctx=dict(TRACE_CTX))
        whole = exp.export(*kv[64], 60, 7, 16, trace_ctx=dict(TRACE_CTX))
        streamed = exp.export(*kv[64], 50, 7, 16, trace_ctx=dict(TRACE_CTX))
        kvt.pull_all(sync, timeout_s=30.0)
        kvt.pull_all(whole, timeout_s=30.0)
        stream = kvt.KVPageStream(streamed["n_pages"], streamed["page_size"])
        puller.pull(streamed, stream, timeout_s=30.0)
        deadline = time.monotonic() + 30
        while (exp.pending() or puller.pending()) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert exp.pending() == 0 and puller.pending() == 0
    finally:
        puller.teardown()
        exp.teardown()
    after = _pd_phase_counts(pkg)
    delta = {p: n - before.get(p, 0) for p, n in after.items()
             if n != before.get(p, 0)}
    return ([s for s in spans if s["event"] == "trace:span"],
            (sync["sync"], whole["sync"], streamed["sync"]), delta)


def test_kv_plane_spans_and_phases_match_the_reference(monkeypatch):
    (jspans, jsync, jphases), (tspans, tsync, tphases) = (
        _plane_run(pkg, monkeypatch) for pkg in PKGS)
    assert jsync == tsync == (True, False, False)

    def shape(spans):
        return sorted((tuple(sorted(s)),
                       tuple(s.get(k) for k in SPAN_VALUES)) for s in spans)

    assert shape(tspans) == shape(jspans)
    assert [s["name"] for s in tspans] == ["pd:kv_send"] * 3
    assert sorted(s.get("sync", False) for s in tspans) == [False, False,
                                                           True]
    # a message a page: 4 send waits a threaded ticket; 4 reader waits a
    # threaded ticket, and pull_all's one of the sync ticket
    assert tphases == jphases == {"transfer_send_wait": 8,
                                  "transfer_wait": 9}


# ---------------------------------------------------- tests/test_tracing.py


@pytest.fixture(scope="module")
def traced_cluster():
    """The port's session with tracing on and every serve request
    span-sampled (the reference's traced and sampled fixtures in one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_ENABLE_TRACING", "1")
        mp.setenv("RAY_TPU_TORCH_SERVE_SPAN_SAMPLE_EVERY", "1")
        RayConfig.reset()
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=32, num_workers=2, max_workers=16)
        try:
            yield
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
    RayConfig.reset()


def _wait_trace(trace_id, min_spans, timeout=20.0):
    deadline = time.time() + timeout
    tree = None
    while time.time() < deadline:
        tree = tracing.get_trace(trace_id)
        if tree is not None and _count(tree["root"]) >= min_spans:
            return tree
        time.sleep(0.25)
    raise AssertionError(f"trace incomplete after {timeout}s: {tree}")


def _count(span):
    return 1 + sum(_count(c) for c in span["children"])


def _find(span, name):
    if span.get("name") == name:
        return span
    for c in span["children"]:
        hit = _find(c, name)
        if hit is not None:
            return hit
    return None


def test_three_level_trace_reassembles(traced_cluster):
    @ray_tpu_torch.remote
    def leaf():
        return tracing.current_context()["trace_id"]

    @ray_tpu_torch.remote
    def mid():
        # a nested submission from a worker: the leaf's span is a CHILD of
        # this task's span, not of the root opened by the caller
        return ray_tpu_torch.get(leaf.remote())

    with tracing.trace("request") as root_ctx:
        trace_id = root_ctx["trace_id"]
        observed = ray_tpu_torch.get(mid.remote())

    assert observed == trace_id  # two hops from the caller
    tree = _wait_trace(trace_id, min_spans=3)
    root = tree["root"]
    assert root["span_kind"] == "root" and root["name"] == "request"
    mid_span = _find(root, "mid")
    leaf_span = _find(root, "leaf")
    assert mid_span is not None and leaf_span is not None
    assert mid_span["parent_span_id"] == root["span_id"]
    assert leaf_span["parent_span_id"] == mid_span["span_id"]
    assert leaf_span in mid_span["children"]
    assert mid_span["start"] <= leaf_span["start"]
    assert leaf_span["end"] <= mid_span["end"] + 1e-3


def test_actor_calls_join_trace(traced_cluster):
    @ray_tpu_torch.remote
    class Svc:
        def handle(self):
            return tracing.current_context()["trace_id"]

    svc = Svc.remote()
    with tracing.trace("svc-request") as ctx:
        got = ray_tpu_torch.get(svc.handle.remote())
    assert got == ctx["trace_id"]
    tree = _wait_trace(ctx["trace_id"], min_spans=2)
    handle_span = _find(tree["root"], "handle")
    assert handle_span is not None
    assert handle_span["parent_span_id"] == tree["root"]["span_id"]
    ray_tpu_torch.kill(svc)


def test_no_trace_no_overhead(traced_cluster):
    # outside a trace() block nothing is injected and nothing is emitted
    @ray_tpu_torch.remote
    def f():
        return tracing.current_context() is None

    assert ray_tpu_torch.get(f.remote()) is True


def test_traceparent_format():
    ctx = {"trace_id": "a" * 32, "span_id": "b" * 16}
    for pkg in PKGS:
        assert _mod(pkg, "util.tracing").to_traceparent(ctx) == \
            f"00-{'a' * 32}-{'b' * 16}-01"


# ----------------------------------------------- tests/test_observability.py


def test_config_registry_env_override(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_MAX_LINEAGE", "123")
    monkeypatch.setenv("RAY_TPU_TORCH_AUTO_GC", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_HYBRID_THRESHOLD", "0.75")
    RayConfig.reset()
    try:
        cfg = RayConfig.instance()
        assert cfg.max_lineage == 123
        assert cfg.auto_gc is False
        assert cfg.hybrid_threshold == 0.75
        # spawn_env forwards only flags set explicitly
        monkeypatch.delenv("RAY_TPU_TORCH_STORE_BACKEND", raising=False)
        env = RayConfig.spawn_env()
        assert env["RAY_TPU_TORCH_MAX_LINEAGE"] == "123"
        assert "RAY_TPU_TORCH_STORE_BACKEND" not in env
        # the JAX package's flags are not the port's
        monkeypatch.setenv("RAY_TPU_MAX_LINEAGE", "7")
        RayConfig.reset()
        assert RayConfig.instance().max_lineage == 123
    finally:
        RayConfig.reset()


def test_metrics_local_registry():
    got = []
    for pkg in PKGS:
        m = _mod(pkg, "util.metrics")
        m.clear_registry()
        c = m.Counter("test_requests_total", "requests")
        c.inc()
        c.inc(2, tags={"route": "/a"})
        g = m.Gauge("test_inflight", "in flight")
        g.set(5)
        g.dec()
        h = m.Histogram("test_latency_seconds", boundaries=(0.1, 1.0))
        h.observe(0.05)
        h.observe(0.5)
        h.observe(5.0)
        snap = {s["name"]: s for s in m.snapshot()}
        m.clear_registry()
        (_, gval), = snap["test_inflight"]["series"]
        (_, hval), = snap["test_latency_seconds"]["series"]
        got.append((snap["test_requests_total"]["kind"],
                    sum(v for _, v in snap["test_requests_total"]["series"]),
                    gval, hval["count"], hval["buckets"]))
    assert got[0] == got[1] == ("counter", 3, 4, 3, [1, 1, 1])


def test_prometheus_rendering():
    agg = {
        "reqs": {"kind": "counter", "description": "d",
                 "series": {"w1": [[[["a", "b"]], 2.0]],
                            "w2": [[[["a", "b"]], 3.0]]}},
        "lat": {"kind": "histogram", "description": "",
                "series": {"w1": [[[], {"buckets": [1, 2, 0], "sum": 1.5,
                                        "count": 3,
                                        "boundaries": [0.1, 1.0]}]]}},
    }
    text = met.to_prometheus(agg)
    assert 'reqs{a="b"} 5.0' in text
    assert 'lat_bucket{le="0.1"} 1' in text
    assert 'lat_bucket{le="+Inf"} 3' in text
    assert "lat_count 3" in text
    assert text == _mod("ray_tpu", "util.metrics").to_prometheus(agg)


def test_prometheus_leaves_out_families_without_a_sample():
    """A metric registered in a process but never recorded reaches the GCS
    with no series; the port's scrape shows it only once it has a value
    (the JAX package writes its HELP and TYPE lines at once, which let a
    scraper polling for the name see it before any sample)."""
    agg = {
        "empty_total": {"kind": "counter", "description": "never recorded",
                        "series": {"w1": [], "w2": []}},
        "reqs": {"kind": "counter", "description": "d",
                 "series": {"w1": [], "w2": [[[["a", "b"]], 3.0]]}},
    }
    text = met.to_prometheus(agg)
    assert "empty_total" not in text
    assert "# HELP reqs d" in text and 'reqs{a="b"} 3.0' in text
    assert "# HELP empty_total" in _mod("ray_tpu",
                                        "util.metrics").to_prometheus(agg)


def test_prometheus_label_escaping_and_bucket_mismatch():
    agg = {
        "esc": {"kind": "counter", "description": "",
                "series": {"w1": [[[["path", 'a"b\\c\nd']], 1.0]]}},
        "mix": {"kind": "histogram", "description": "",
                "series": {"w1": [[[], {"buckets": [1, 0, 0], "sum": 0.1,
                                        "count": 1,
                                        "boundaries": [0.1, 1.0]}]],
                           "w2": [[[], {"buckets": [0, 1], "sum": 0.5,
                                        "count": 1,
                                        "boundaries": [0.5]}]]}},
    }
    text = met.to_prometheus(agg)
    # label values escape backslash, quote and newline
    assert 'esc{path="a\\"b\\\\c\\nd"} 1.0' in text
    # mismatched bucket boundaries: the first series kept, the second not
    assert "mix_count 1" in text
    assert text == _mod("ray_tpu", "util.metrics").to_prometheus(agg)


# --------------------------------------------- tests/test_request_tracing.py


def _http_post(path: str, body: dict) -> dict:
    host, port = serve.http_address()
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _flat(span, acc):
    acc.append(span)
    for c in span.get("children", ()):
        _flat(c, acc)
    return acc


def _wait_tree(rid, want_names, timeout=30.0, prefixes=()):
    """Poll until the trace of `rid` holds every name in want_names and a
    name starting with each of `prefixes` (each process flushes its spans
    on its own cadence)."""
    deadline = time.time() + timeout
    spans = []
    while time.time() < deadline:
        tree = tracing.get_trace(rid)
        if tree is not None:
            spans = _flat(tree["root"], [])
            names = {s.get("name") or "" for s in spans}
            if want_names <= names and all(
                    any(n.startswith(p) for n in names) for p in prefixes):
                return spans
        time.sleep(0.4)
    raise AssertionError(
        f"trace incomplete after {timeout}s: have "
        f"{sorted(s.get('name') or '?' for s in spans)}, "
        f"want {sorted(want_names)}")


def _gcs_rpc(msg: dict) -> dict:
    from ray_tpu_torch._private.api import _get_worker

    return _get_worker().rpc(msg)


def _wait_requests(pred, timeout=25.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        rows = [r for r in _gcs_rpc({"type": "list_requests"}).get(
            "requests", []) if pred(r)]
        if rows:
            return rows
        time.sleep(0.4)
    raise AssertionError("no matching flight-recorder rows in the GCS")


def _echo():
    @serve.deployment
    class _Echo:
        def __call__(self, request):
            return {"echo": request["body"],
                    "rid": request.get("request_id")}

    return _Echo


def test_sampling_off_zero_serve_spans():
    """The zero-emit guard: with serve_span_sample_every=0 a request makes
    no serve span anywhere and no trace context reaches the replica."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_TORCH_SERVE_SPAN_SAMPLE_EVERY", "0")
        RayConfig.reset()
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=8, num_workers=2, max_workers=8)
        try:
            serve.start(http_port=0)
            serve.run(_echo().bind(), name="echo", route_prefix="/echo")
            out = _http_post("/echo", {"x": 1})
            assert out["echo"] == {"x": 1}
            assert out["rid"]  # request ids are assigned, sampled or not
            time.sleep(2.5)  # one full flush cycle
            events = _gcs_rpc({"type": "task_events"}).get("events", [])
            assert [e for e in events if e.get("event") == "trace:span"
                    and e.get("request_id")] == []
            assert tracing.get_trace(out["rid"]) is None
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
    RayConfig.reset()


def test_sampled_request_span_tree(traced_cluster):
    """A sampled HTTP request yields one tree: the serve:request root, the
    proxy's phase spans and the replica's span, over >= 2 processes."""
    serve.start(http_port=0)
    serve.run(_echo().bind(), name="echo", route_prefix="/echo")
    out = _http_post("/echo", {"x": 1})
    rid = out["rid"]
    spans = _wait_tree(rid, {"serve:request", "proxy:route", "proxy:handle"},
                       prefixes=("replica:echo",))
    names = {s.get("name") for s in spans}
    assert any(n and n.startswith("replica:echo") for n in names), names
    assert all(s.get("request_id") == rid for s in spans
               if s.get("name") != "(root)")
    assert len({s.get("pid") for s in spans if s.get("pid")}) >= 2
    root = [s for s in spans if s.get("name") == "serve:request"]
    assert root and root[0]["span_kind"] == "root"
    serve.delete("echo")


def test_sampled_pd_request_span_tree(traced_cluster):
    """One sampled PD request: one trace with the proxy's, the prefill
    replica's and the decode replica's phases, across >= 3 processes; the
    PD proxy's flight-recorder row holds both halves of the TTFT."""
    from ray_tpu_torch.llm import (LLMConfig, ModelLoadingConfig,
                                   build_pd_openai_app)

    cfg = LLMConfig(
        model_loading_config=ModelLoadingConfig(model_id="tiny",
                                                tokenizer="byte"),
        model_family="llama",
        engine_kwargs=dict(max_slots=2, max_len=128, min_bucket=16,
                           page_size=16, device="cpu"))
    serve.start(http_port=0)
    serve.run(build_pd_openai_app(cfg), name="pd", route_prefix="/pd")
    out = _http_post("/pd", {"prompt": "abc", "max_tokens": 6})
    assert out["usage"]["completion_tokens"] == 6
    rows = _wait_requests(lambda r: r.get("component") == "http_proxy"
                          and r.get("path") == "/pd")
    rid = rows[-1]["request_id"]
    want = {"serve:request", "proxy:route", "pd:prefill", "pd:kv_send",
            "pd:kv_transfer", "pd:admission", "pd:decode"}
    spans = _wait_tree(rid, want, timeout=45.0)
    names = {s.get("name") for s in spans}
    assert want <= names
    # the HTTP proxy, the PD proxy replica, prefill and decode replicas
    assert len({s.get("pid") for s in spans if s.get("pid")}) >= 3
    pd_rows = _wait_requests(lambda r: r.get("component") == "pd_proxy")
    assert {"prefill", "decode_first_token"} <= set(
        pd_rows[-1].get("phases") or {})
    serve.delete("pd")


def test_flight_recorder_ring_bounds(monkeypatch):
    """The ring keeps the LAST N summaries; drain returns what is new since
    the last drain and still in the ring, once."""
    monkeypatch.setenv("RAY_TPU_TORCH_SERVE_FLIGHT_RECORDER_SIZE", "8")
    RayConfig.reset()
    task_events.reset_request_log()
    try:
        for i in range(20):
            task_events.record_request({"request_id": f"r{i}"})
        ring = task_events.recent_requests()
        assert [r["request_id"] for r in ring] == \
            [f"r{i}" for i in range(12, 20)]
        drained = task_events.drain_request_log()
        assert [r["request_id"] for r in drained] == [
            f"r{i}" for i in range(12, 20)]
        assert task_events.drain_request_log() == []
        task_events.record_request({"request_id": "r20"})
        assert [r["request_id"] for r in
                task_events.drain_request_log()] == ["r20"]
    finally:
        task_events.reset_request_log()
        RayConfig.reset()


def test_gcs_rpc_histograms_present(traced_cluster):
    """Server-side per-RPC-type latency histograms ride metrics_snapshot
    under the reserved 'gcs' source and render as Prometheus text."""
    ray_tpu_torch.get(ray_tpu_torch.put(1))  # some RPC traffic
    snap = _gcs_rpc({"type": "metrics_snapshot"})["metrics"]
    rec = snap["ray_tpu_gcs_rpc_seconds"]
    assert rec["kind"] == "histogram"
    series = rec["series"]["gcs"]
    types = {dict(tuple(t) for t in tags).get("rpc") for tags, _ in series}
    assert "register" in types  # every session registers workers
    assert all(st["count"] > 0 for _, st in series)
    text = met.to_prometheus(snap)
    assert "ray_tpu_gcs_rpc_seconds_bucket" in text
    assert 'rpc="register"' in text


def test_chrome_trace_groups_request_rows():
    """Serve and PD request spans group under one row a request id."""
    events = [
        {"event": "trace:span", "name": "serve:request", "start": 1.0,
         "end": 2.0, "request_id": "req1", "pid": 10},
        {"event": "trace:span", "name": "replica:echo", "start": 1.2,
         "end": 1.8, "request_id": "req1", "pid": 11},
        {"event": "trace:span", "name": "serve:request", "start": 1.0,
         "end": 1.5, "request_id": "req2", "pid": 10},
        {"event": "task:done", "name": "other", "start": 1.0, "end": 1.1,
         "pid": 12},
    ]
    out = task_events.to_chrome_trace(events)
    trace = json.loads(out)["traceEvents"]
    by_row: dict = {}
    for t in trace:
        by_row.setdefault(t["pid"], []).append(t["name"])
    assert sorted(by_row["req:req1"]) == ["replica:echo", "serve:request"]
    assert by_row["req:req2"] == ["serve:request"]
    assert "other" in [n for r, ns in by_row.items()
                       if not str(r).startswith("req:") for n in ns]
    assert out == _mod("ray_tpu", "_private.task_events").to_chrome_trace(
        events)


def test_engine_phase_histograms(monkeypatch):
    """The engine's phases, always on: admission_wait and inter_token
    observed for a plain generation; none under serve_metrics=0."""
    from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.models.transformer import TransformerConfig

    tiny = TransformerConfig(vocab_size=64, d_model=32, n_layers=1,
                             n_heads=2, n_kv_heads=2, d_ff=64,
                             max_seq_len=64, dtype=torch.float32)
    params = transformer.init(torch.Generator().manual_seed(0), tiny,
                              torch.device("cpu"), dtype=torch.float32)

    def totals():
        for m in met.snapshot():
            if m["name"] == "ray_tpu_llm_engine_phase_seconds":
                return {dict(tuple(t) for t in tags)["phase"]: st["count"]
                        for tags, st in m["series"]}
        return {}

    def generate():
        eng = LLMEngine(tiny, params, max_slots=2, max_len=32, device="cpu")
        try:
            return eng.generate([1, 2, 3], SamplingParams(max_tokens=4))
        finally:
            eng.shutdown()

    before = totals()
    assert len(generate()) == 4
    after = totals()
    assert after.get("admission_wait", 0) > before.get("admission_wait", 0)
    assert after.get("inter_token", 0) > before.get("inter_token", 0)

    # the kill switch: a fresh engine under serve_metrics=0 observes nothing
    monkeypatch.setenv("RAY_TPU_TORCH_SERVE_METRICS", "0")
    RayConfig.reset()
    try:
        base = totals()
        generate()
        assert totals() == base
    finally:
        RayConfig.reset()

