"""Twins of tests/test_dag_observability.py: compiled-DAG instrumentation,
the DAG registry, storage metrics and the satellite fixes (deterministic
gauge merging, filtered list_objects, timeline labels), in each package.

Unit-level scenarios run in this process, one package after the other
(`pair`); cluster-level ones on one module-scoped session per package with
span sampling every 2nd step and tracing on, set before `init`. Both sides
must agree. Left out: `test_cli_dag_list_and_show` (the CLI, ROADMAP Queue
1 item 20); the end-to-end test reads the GCS's snapshot through
`to_prometheus` where the reference reads the dashboard's `/metrics` and
`/api/dags` (item 20).
"""

from __future__ import annotations

import json
import threading
import time
from functools import partial

import pytest

from torch_twins import (env_name, is_port, pair, private_channel_dirs,
                         rpc, shutdown_runtimes, start_sessions, sub, twin)

N_STEPS = 12
_twin = partial(twin, serve_cleanup=False)


def _series(rt, name):
    for m in sub(rt, "util.metrics").snapshot():
        if m["name"] == name:
            return m["series"]
    return []


@pytest.fixture
def chans(monkeypatch, tmp_path):
    private_channel_dirs(monkeypatch, tmp_path)


# ---------------------------------------------------------------- unit level


def _run_loop(rt, plan, in_ch, out_ch, n_steps, inputs=None):
    """Drive actor_exec_loop in-process: write n inputs, read n outputs,
    close, join. Returns the outputs."""
    actor_exec_loop = sub(rt, "dag.channel_execution").actor_exec_loop

    class Inst:
        def work(self, x):
            return x + 1

    done = {}
    t = threading.Thread(
        target=lambda: done.update(actor_exec_loop(Inst(), plan)),
        daemon=True)
    t.start()
    outs = []
    try:
        for i in range(n_steps):
            in_ch.write(inputs[i] if inputs else i, timeout=30)
            outs.append(out_ch.read(timeout=30))
    finally:
        for ch in (in_ch, out_ch):
            ch.close()
        t.join(timeout=30)
        assert not t.is_alive(), "exec loop failed to exit on close"
        for ch in (in_ch, out_ch):
            ch.unlink()
    assert done.get("status") == "closed"
    return outs


def _mk_plan(in_ch, out_ch, **instr):
    plan = {"ops": [{"method": "work", "args": [("input",)], "kwargs": {},
                     "out": [out_ch], "label": "work@actor:unittest"}],
            "input": in_ch}
    plan.update(instr)
    return plan


def _chans(rt):
    create = sub(rt, "experimental.channel.mutable_shm").create_mutable_channel
    return create(65536), create(65536)


def _capture_emits(rt, monkeypatch, with_kind: bool):
    emits = []
    te = sub(rt, "_private.task_events")
    if with_kind:
        monkeypatch.setattr(te, "emit", lambda event, **kw: emits.append(
            {"event": event, **kw}))
    else:
        monkeypatch.setattr(te, "emit", lambda *a, **k: emits.append(a))
    return emits


def test_exec_loop_zero_emit_when_disabled(monkeypatch, chans):
    """With metrics AND sampling off the hot path makes no emit call (and
    records no histogram series)."""

    def scn(rt):
        met = sub(rt, "util.metrics")
        emits = _capture_emits(rt, monkeypatch, False)
        met.clear_registry()
        in_ch, out_ch = _chans(rt)
        outs = _run_loop(rt, _mk_plan(in_ch, out_ch, dag_id="dag-unit0",
                                      metrics=False, sample=0),
                         in_ch, out_ch, 5)
        got = (outs, emits,
               bool(_series(rt, "ray_tpu_dag_step_compute_seconds")))
        met.clear_registry()
        return got

    pair(scn, ([1, 2, 3, 4, 5], [], False))


def test_exec_loop_histograms_always_on_spans_sampled(monkeypatch, chans):
    def scn(rt):
        met = sub(rt, "util.metrics")
        emits = _capture_emits(rt, monkeypatch, True)
        met.clear_registry()
        in_ch, out_ch = _chans(rt)
        _run_loop(rt, _mk_plan(in_ch, out_ch, dag_id="dag-unit1",
                               metrics=True, sample=3), in_ch, out_ch, 7)
        # sampled steps 0, 3, 6 → 3 spans, each with the phase breakdown;
        # the histograms were retired at loop exit
        got = ([e["event"] for e in emits], emits[0]["dag_id"],
               emits[0]["node"],
               {"input_wait_s", "compute_s", "output_write_s"}
               <= set(emits[0]), [e["seq"] for e in emits],
               bool(_series(rt, "ray_tpu_dag_step_compute_seconds")))
        met.clear_registry()
        return got

    pair(scn, (["dag:step"] * 3, "dag-unit1", "work@actor:unittest", True,
               [0, 3, 6], False))


def test_exec_loop_sampled_spans_join_caller_trace(monkeypatch, chans):
    """A _DagInput envelope carrying the driver's trace context turns the
    sampled span into a trace:span that assembles under the caller's
    trace."""

    def scn(rt):
        met = sub(rt, "util.metrics")
        _DagInput = sub(rt, "dag.channel_execution")._DagInput
        emits = _capture_emits(rt, monkeypatch, True)
        met.clear_registry()
        ctx = {"trace_id": "ab" * 16, "parent_span_id": "cd" * 8}
        in_ch, out_ch = _chans(rt)
        outs = _run_loop(rt, _mk_plan(in_ch, out_ch, dag_id="dag-unit2",
                                      metrics=False, sample=1),
                         in_ch, out_ch, 3,
                         inputs=[_DagInput(i, ctx) for i in range(3)])
        # unwrapped before user code and RE-WRAPPED on the out-edge
        tree = sub(rt, "util.tracing").assemble(
            [dict(e, name="work") for e in emits], ctx["trace_id"])
        got = (all(type(o) is _DagInput for o in outs),
               [o.value for o in outs],
               all(o.trace_ctx == ctx for o in outs),
               [e["event"] for e in emits],
               all(e["trace_id"] == ctx["trace_id"] for e in emits),
               all(e["parent_span_id"] == ctx["parent_span_id"]
                   for e in emits),
               all(e["span_kind"] == "dag_step" for e in emits),
               len(tree["root"]["children"]) if tree else None)
        met.clear_registry()
        return got

    pair(scn, (True, [1, 2, 3], True, ["trace:span"] * 3, True, True, True,
               3))


def test_chrome_trace_groups_dag_rows():
    events = [
        {"event": "dag:step", "name": "work@actor:aaaa", "start": 1.0,
         "end": 1.001, "dag_id": "dag-xyz", "node": "work@actor:aaaa",
         "pid": 41, "worker_id": "w1"},
        {"event": "task:execute", "name": "other", "start": 1.0, "end": 1.1,
         "pid": 42, "worker_id": "w2"},
    ]

    def scn(rt):
        rows = json.loads(sub(rt, "_private.task_events").to_chrome_trace(
            events))["traceEvents"]
        return rows[0]["pid"], rows[0]["tid"], rows[1]["pid"]

    pair(scn, ("dag:dag-xyz", "work@actor:aaaa", "w2"))


def test_prometheus_gauge_merge_newest_ts_wins():
    """Gauge merging across sources is deterministic: the series with the
    newest snapshot ts wins regardless of source-dict order; a ts tie goes
    to the larger source id."""

    def scn(rt):
        met = sub(rt, "util.metrics")
        got = []
        for order in (("w_old", "w_new"), ("w_new", "w_old")):
            series = {"w_old": [[[], 1.0]], "w_new": [[[], 2.0]]}
            agg = {"ray_tpu_g": {
                "kind": "gauge", "description": "",
                "series": {s: series[s] for s in order},
                "ts": {"w_old": 100.0, "w_new": 200.0}}}
            got.append("ray_tpu_g 2.0" in met.to_prometheus(agg))
        agg = {"ray_tpu_g": {"kind": "gauge", "description": "",
                             "series": {"b": [[[], 5.0]], "a": [[[], 4.0]]},
                             "ts": {"a": 100.0, "b": 100.0}}}
        got.append("ray_tpu_g 5.0" in met.to_prometheus(agg))
        return got

    pair(scn, [True, True, True])


def test_prometheus_histogram_layout_majority_wins():
    """A histogram's bucket layout changed in a rolling restart: the
    majority layout wins even when one stale source reports newest."""
    new = {"buckets": [1, 0, 0], "sum": 0.1, "count": 1,
           "boundaries": [0.1, 1.0]}
    old = {"buckets": [5, 0], "sum": 2.5, "count": 5, "boundaries": [0.5]}

    def scn(rt):
        agg = {"ray_tpu_lat": {
            "kind": "histogram", "description": "",
            "series": {"w1": [[[], dict(new)]], "w2": [[[], dict(new)]],
                       "w_stale": [[[], dict(old)]]},
            "ts": {"w1": 100.0, "w2": 110.0, "w_stale": 200.0}}}
        text = sub(rt, "util.metrics").to_prometheus(agg)
        return ("ray_tpu_lat_count 2" in text, 'le="0.1"' in text,
                'le="0.5"' in text)

    pair(scn, (True, True, False))


def test_storage_transfer_metrics(tmp_path, monkeypatch):
    def scn(rt):
        met = sub(rt, "util.metrics")
        st = sub(rt, "train.storage")
        root = tmp_path / rt.__name__
        monkeypatch.setenv(env_name(rt, "MOCK_STORE_ROOT"),
                           str(root / "store"))
        met.clear_registry()
        src = root / "ckpt"
        src.mkdir(parents=True)
        (src / "weights.bin").write_bytes(b"x" * 2048)
        (src / "meta.json").write_bytes(b"{}")
        backend, prefix = st.get_storage_backend(
            "mock://obsbucket/exp?fail_rate=0.3&seed=3")
        stats = st.persist_directory(
            backend, str(src), st.join_path(prefix, "checkpoint_0/rank_0"))
        up = _series(rt, "ray_tpu_storage_upload_bytes_total")
        commit = _series(rt, "ray_tpu_storage_commit_seconds")
        retries = sum(v for _t, v in _series(
            rt, "ray_tpu_storage_retries_total"))
        st.restore_directory(
            backend, st.join_path(prefix, "checkpoint_0/rank_0"),
            str(root / "restored"))
        down = _series(rt, "ray_tpu_storage_download_bytes_total")
        met.clear_registry()
        return (up[0][1], stats.bytes,
                dict(map(tuple, up[0][0]))["backend"], commit[0][1]["count"],
                retries == stats.retries, down[0][1])

    pair(scn, (2050, 2050, "mockremote", 1, True, 2050))


# ------------------------------------------------------------- cluster level


def _scn_autoscaler_metrics(tmp_path, rt):
    """Transition counters + reconcile histogram + pending/running gauges,
    riding the FakeFileNodeProvider (file-backed cloud, no processes)."""
    autoscaler = sub(rt, "autoscaler")
    met = sub(rt, "util.metrics")
    rt.shutdown()
    rt.init(num_cpus=2, num_workers=1, max_workers=4)
    met.clear_registry()
    try:
        provider = autoscaler.FakeFileNodeProvider(
            str(tmp_path / f"cloud_{rt.__name__}.json"))
        a = autoscaler.Autoscaler(
            f"unix:{sub(rt, '_private.api')._node.socket_path}", provider,
            [autoscaler.NodeType("warm", {"CPU": 2}, min_nodes=1,
                                 max_nodes=2)])
        try:
            a.reconcile_once()
            trans = {tuple(sorted(map(tuple, tags))): v
                     for tags, v in _series(
                         rt, "ray_tpu_autoscaler_instance_transitions_total")}
            key_new = (("from_state", "(new)"), ("node_type", "warm"),
                       ("to_state", "REQUESTED"))
            key_alloc = (("from_state", "REQUESTED"), ("node_type", "warm"),
                         ("to_state", "ALLOCATED"))
            rec = _series(rt, "ray_tpu_autoscaler_reconcile_seconds")
            pend = {dict(map(tuple, tags))["node_type"]: v
                    for tags, v in _series(
                        rt, "ray_tpu_autoscaler_pending_nodes")}
            return (trans.get(key_new), trans.get(key_alloc),
                    bool(rec) and rec[0][1]["count"] >= 1, pend.get("warm"))
        finally:
            a.stop()
    finally:
        met.clear_registry()
        rt.shutdown()


def test_autoscaler_transition_and_reconcile_metrics(tmp_path):
    # ALLOCATED, never joins: one pending node
    pair(partial(_scn_autoscaler_metrics, tmp_path), (1.0, 1.0, True, 1.0))


@pytest.fixture(scope="module")
def obs_cluster():
    with pytest.MonkeyPatch.context() as mp:
        import ray_tpu
        import ray_tpu_torch

        for rt in (ray_tpu, ray_tpu_torch):
            mp.setenv(env_name(rt, "DAG_SPAN_SAMPLE_EVERY"), "2")
            mp.setenv(env_name(rt, "ENABLE_TRACING"), "1")
            sub(rt, "_private.ray_config").RayConfig.reset()
            sub(rt, "util.metrics").clear_registry()
        pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=8)
        yield pkgs
        shutdown_runtimes(pkgs)
        for rt in pkgs:
            sub(rt, "util.metrics").clear_registry()
            sub(rt, "_private.ray_config").RayConfig.reset()
    for rt in pkgs:
        sub(rt, "_private.ray_config").RayConfig.reset()


def _poll(fn, deadline_s=25.0, every=0.3):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(every)
    return fn()


def _scn_dag_end_to_end(rt):
    InputNode = sub(rt, "dag").InputNode
    st = sub(rt, "util.state")
    tracing = sub(rt, "util.tracing")
    te = sub(rt, "_private.task_events")
    met = sub(rt, "util.metrics")

    @rt.remote
    class ObsStage:
        def work(self, x):
            return x + 1

    actors = [ObsStage.remote() for _ in range(2)]
    try:
        with InputNode() as inp:
            node = inp
            for a in actors:
                node = a.work.bind(node)
        compiled = node.experimental_compile(max_inflight_executions=2)
        assert compiled.uses_channels, compiled.fallback_reason
        dag_id = compiled.dag_id
        # registry: listed while live, with plane + topology
        rows = st.list_compiled_dags(filters=[("dag_id", "=", dag_id)])
        registry = (bool(rows) and rows[0]["plane"] == "channels"
                    and bool(rows[0]["actors"]) and rows[0]["channels"] >= 3
                    and any(e["to"] == "driver" for e in rows[0]["topology"]))
        outs = [compiled.execute(i).result(timeout=60)
                for i in range(N_STEPS)]
        # a driver trace spanning some steps: sampled steps join it
        with tracing.trace("dag-run") as tctx:
            for i in range(4):
                compiled.execute(i).result(timeout=60)
        # saturate max_inflight so the driver-side backpressure records
        for i in range(6):
            compiled.execute(i)
        bp = _series(rt, "ray_tpu_dag_step_backpressure_drain_seconds")
        backpressure = bool(bp) and bp[0][1]["count"] >= 1

        # worker-side spans ship on the 2 s flusher cadence
        events = _poll(lambda: [
            e for e in rpc(rt, {"type": "task_events"})["events"]
            if e.get("dag_id") == dag_id and e.get("event") == "dag:step"])
        spans = bool(events) and all(e.get("node") for e in events)

        def dag_hist():
            snap = rpc(rt, {"type": "metrics_snapshot"})["metrics"]
            rec = snap.get("ray_tpu_dag_step_compute_seconds")
            if not rec:
                return None
            for series in rec["series"].values():
                for tags, hval in series:
                    if (dict(map(tuple, tags)).get("dag_id") == dag_id
                            and hval["count"] > 0):
                        return snap
            return None

        snap = _poll(dag_hist)
        prom = bool(snap) and (
            "ray_tpu_dag_step_compute_seconds_bucket"
            in met.to_prometheus(snap))

        # sampled steps inside the driver trace joined it as dag_step
        # spans, from EVERY stage (forwarded downstream in-band)
        def traced():
            tree = tracing.get_trace(tctx["trace_id"])
            if tree is None:
                return None
            nodes = {c.get("node") for c in tree["root"]["children"]
                     if c.get("span_kind") == "dag_step"}
            return nodes if len(nodes) >= 2 else None

        joined = bool(_poll(traced))
        summary = st.summarize_dag(dag_id)
        summarized = (bool(summary) and summary["dag"]["dag_id"] == dag_id
                      and any(v.get("compute", {}).get("count", 0) > 0
                              for v in summary["steps"].values()))
        # the timeline export groups the sampled steps under the DAG id
        trace = json.loads(te.to_chrome_trace(te.normalize_events(
            list(rpc(rt, {"type": "task_events"})["events"]))))
        dag_rows = [r for r in trace["traceEvents"]
                    if r["pid"] == f"dag:{dag_id}"]
        grouped = bool(dag_rows) and all(r["tid"] for r in dag_rows)
        compiled.teardown()
        gone = not st.list_compiled_dags(filters=[("dag_id", "=", dag_id)])
        return (registry, outs, backpressure, spans, prom, joined,
                summarized, grouped, gone)
    finally:
        for a in actors:
            rt.kill(a)


@pytest.mark.dag
def test_dag_registry_metrics_timeline_end_to_end(obs_cluster, monkeypatch,
                                                  tmp_path):
    """A compiled run with sampling on yields per-step spans grouped under
    the DAG id in the timeline, non-zero ray_tpu_dag_step_* histograms in
    the Prometheus rendering, and a registry entry that teardown
    retires."""
    private_channel_dirs(monkeypatch, tmp_path)
    a, b = _twin(obs_cluster, _scn_dag_end_to_end)
    assert a == b, (a, b)
    assert a == (True, [i + 2 for i in range(N_STEPS)]) + (True,) * 7, a


def _scn_list_objects_filter(rt):
    list_objects = sub(rt, "util.state").list_objects
    refs = [rt.put(i) for i in range(15)]
    rows = list_objects(filters=[("status", "=", "ready")], limit=10)
    rows_all = list_objects(filters=[("status", "=", "ready")], limit=1000)
    del refs
    return len(rows), len(rows_all) >= 15


def test_list_objects_filter_beyond_server_limit(obs_cluster):
    """A filtered query returns `limit` matching rows even when the match
    set is larger than any server-side cut."""
    a, b = _twin(obs_cluster, _scn_list_objects_filter)
    assert a == b == (10, True), (a, b)


def _scn_timeline_labels(rt):
    te = sub(rt, "_private.task_events")

    @rt.remote
    class TimelineTarget:
        def ping(self):
            return "pong"

    a = TimelineTarget.remote()
    try:
        pong = rt.get(a.ping.remote(), timeout=60)

        def labeled():
            workers = rpc(rt, {"type": "list_workers"})["workers"]
            actors = rpc(rt, {"type": "cluster_state"})["state"]["actors"]
            names = te.worker_display_names(workers, actors)
            return names if any("TimelineTarget" in v
                                for v in names.values()) else None

        names = _poll(labeled)
        events = _poll(lambda: [
            e for e in rpc(rt, {"type": "task_events"})["events"]
            if e.get("name") == "ping"])
        trace = json.loads(te.to_chrome_trace(te.normalize_events(events),
                                              names))
        return (pong, bool(names), bool(events),
                any("TimelineTarget" in str(r["pid"])
                    for r in trace["traceEvents"]))
    finally:
        rt.kill(a)


def test_timeline_rows_labeled_with_actor_class(obs_cluster):
    """Timeline rows of actor workers carry the actor's class (from the
    GCS actor table) instead of a bare pid."""
    a, b = _twin(obs_cluster, _scn_timeline_labels)
    assert a == b == ("pong", True, True, True), (a, b)


def test_port_session_registry_rows_are_the_ports(obs_cluster):
    """The port's state API reads the port's own GCS registry: a DAG
    compiled on one runtime is listed by that runtime only."""
    rts = {is_port(rt): rt for rt in obs_cluster}
    port, ref = rts[True], rts[False]
    InputNode = sub(port, "dag").InputNode

    @port.remote
    class Stage:
        def work(self, x):
            return x + 1

    s = Stage.remote()
    try:
        with InputNode() as inp:
            dag = s.work.bind(inp)
        compiled = dag.experimental_compile()
        dag_id = compiled.dag_id
        mine = sub(port, "util.state").list_compiled_dags(
            filters=[("dag_id", "=", dag_id)])
        theirs = sub(ref, "util.state").list_compiled_dags(
            filters=[("dag_id", "=", dag_id)])
        compiled.teardown()
        assert [r["dag_id"] for r in mine] == [dag_id] and theirs == []
    finally:
        port.kill(s)
