"""The port's dashboard against the JAX package's, on a live session each.

Twins of the 14 cases of tests/test_dashboard_ui.py (the page charts the
``GPU`` resource where the reference charts ``TPU``, and its worker table
shows each worker's ``gpus``), the 5 session cases of
tests/test_observability.py (metrics, events and the dashboard; the pubsub
channels; the sampling profiler; the page and ``/api/serve``),
tests/test_request_tracing.py's ``test_api_requests_endpoint`` and
``test_cli_trace_list_and_show``, and tests/test_dag_observability.py's
``test_cli_dag_list_and_show``.

One module-scoped session per package, with every Serve request
span-sampled, tracing on and every second DAG step sampled (the
reference's sampled fixtures in one), each with the reference fixture's
workload and a dashboard on port 0. Every Serve proxy is on port 0.
"""

from __future__ import annotations

import io
import json
import os
import re
import time
import urllib.error
import urllib.request
from contextlib import redirect_stdout

import pytest

from torch_twins import (env_name, is_port, private_channel_dirs, same,
                         serve_of, shutdown_runtimes, start_sessions, sub,
                         twin)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def _get_json(port, path):
    status, body = _get(port, path)
    assert status == 200, (path, status, body[:200])
    return json.loads(body)


def _sd(rt) -> str:
    return sub(rt, "_private.api")._node.session_dir


def _workload(rt):
    @rt.remote
    def work(i):
        import time as _t

        _t.sleep(0.02)
        return i * 2

    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

    counter = Counter.options(name="dash-counter").remote()
    assert rt.get(counter.bump.remote()) == 1
    assert rt.get([work.remote(i) for i in range(20)]) == \
        [2 * i for i in range(20)]
    blob = rt.put(b"x" * 200_000)
    pg = rt.util.placement_group([{"CPU": 1}], strategy="PACK")
    rt.get(pg.ready(), timeout=30)
    return counter, blob, pg


@pytest.fixture(scope="module")
def live():
    """package name → (dashboard port, blob ref), with the sessions."""
    with pytest.MonkeyPatch.context() as mp:
        import ray_tpu
        import ray_tpu_torch

        for rt in (ray_tpu, ray_tpu_torch):
            mp.setenv(env_name(rt, "SERVE_SPAN_SAMPLE_EVERY"), "1")
            mp.setenv(env_name(rt, "DAG_SPAN_SAMPLE_EVERY"), "2")
            mp.setenv(env_name(rt, "ENABLE_TRACING"), "1")
            sub(rt, "_private.ray_config").RayConfig.reset()
        pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=12)
        heads, state = [], {}
        try:
            for rt in pkgs:
                kept = _workload(rt)
                head = sub(rt, "dashboard.head").start_dashboard(_sd(rt))
                heads.append(head)
                state[rt.__name__] = (head.port, kept[1], kept)
            yield pkgs, state
        finally:
            for head in heads:
                head.stop()
            shutdown_runtimes(pkgs)
            for rt in pkgs:
                sub(rt, "_private.ray_config").RayConfig.reset()


def _same(live, scn, want=None, **kw):
    pkgs, state = live
    return same(pkgs, lambda rt: scn(rt, *state[rt.__name__][:2]), want,
                serve_cleanup=False, **kw)


def _ui_html(rt) -> str:
    d = sub(rt, "dashboard")
    with open(os.path.join(os.path.dirname(d.__file__), "ui.html")) as f:
        return f.read()


# ------------------------------------------ tests/test_dashboard_ui.py


def test_page_serves_all_component_views(live):
    def scn(rt, port, _):
        status, body = _get(port, "/")
        html = body.decode()
        return (status, [v for v in ("overview", "nodes", "workers",
                                     "actors", "placement groups", "tasks",
                                     "timeline", "objects", "jobs", "logs")
                         if v not in html],
                "renderTimeline" in html, "function spark(" in html,
                "setInterval(render" in html)

    _same(live, scn, (200, [], True, True, True))


def test_every_js_fetched_endpoint_serves_live_data(live):
    def scn(rt, port, _):
        urls = sorted(set(re.findall(r'[j|fetch]\("(/api/[a-z_/]+)"?',
                                     _ui_html(rt))))
        for u in urls:
            _get_json(port, u)
        return "/api/cluster" in urls and "/api/objects" in urls, urls

    _same(live, scn)


def test_nodes_and_workers_fields_rendered_by_dom(live):
    def scn(rt, port, _):
        nodes = _get_json(port, "/api/nodes")
        workers = _get_json(port, "/api/workers")
        live_w = [w for w in workers if w.get("kind") == "worker"
                  and not w.get("dead")]
        # the page's worker table reads each worker's accelerators: the
        # JAX package's tpu_chips, the port's gpus
        accel = "gpus" if is_port(rt) else "tpu_chips"
        return ([f for f in ("node_id", "alive", "total", "available",
                             "quarantined_chips", "labels")
                 if f not in nodes[0]],
                bool(live_w) and [f for f in ("wid", "pid", "node_id",
                                              "idle", accel)
                                  if f not in live_w[0]],
                f"w.{accel}" in _ui_html(rt))

    _same(live, scn, ([], [], True))


def test_actor_and_pg_views_show_the_live_objects(live):
    def scn(rt, port, _):
        actors = _get_json(port, "/api/actors")
        pgs = _get_json(port, "/api/placement_groups")
        return (any(a.get("name") == "dash-counter"
                    and a.get("state") == "alive" for a in actors.values()),
                any(p.get("state") == "created" for p in pgs.values()))

    _same(live, scn, (True, True))


def test_objects_view_shows_the_put_blob(live):
    def scn(rt, port, blob):
        resp = _get_json(port, "/api/objects")
        objects = resp["objects"]
        mine = [o for o in objects if o.get("object_id") == blob.hex()]
        return (resp["total"] >= len(objects) > 0, len(mine),
                mine[0]["size"] >= 200_000, mine[0]["status"])

    _same(live, scn, (True, 1, True, "ready"))


def test_timeline_has_timed_executions_for_lane_rendering(live):
    def scn(rt, port, _):
        def timed():
            return [e for e in _get_json(port, "/api/tasks")
                    if e.get("start") and e.get("end")]

        got = _poll(timed, 15)
        status, body = _get(port, "/api/timeline")
        return (bool(got), any(e["end"] > e["start"] for e in got), status,
                bool(json.loads(body).get("traceEvents")))

    _same(live, scn, (True, True, 200, True))


def test_log_tail(live):
    def scn(rt, port, _):
        logs = _get_json(port, "/api/logs")
        status, body = _get(port, f"/api/logs/{logs[0]['name']}?tail=5")
        return bool(logs), status, len(body.splitlines()) <= 5

    _same(live, scn, (True, 200, True))


def test_cluster_metrics_history_inputs(live):
    def scn(rt, port, _):
        c = _get_json(port, "/api/cluster")
        return [f for f in ("num_workers", "num_actors", "pending_tasks",
                            "total_resources", "available_resources")
                if f not in c]

    _same(live, scn, [])


def test_metrics_history_series_has_real_values_under_load(live):
    def scn(rt, port, _):
        def enough():
            h = _get_json(port, "/api/metrics/history")
            return h if len(h.get("cluster", [])) >= 2 and h.get("nodes") \
                else None

        h = _poll(enough, 15)
        cl = h["cluster"]
        last = next(iter(h["nodes"].values()))[-1]
        h2 = _get_json(port, "/api/metrics/history?limit=1")
        return (all(cl[i]["ts"] <= cl[i + 1]["ts"]
                    for i in range(len(cl) - 1)),
                max(s["live_workers"] for s in cl) >= 2,
                max(s["live_actors"] for s in cl) >= 1,
                0.0 < last["mem_usage"] < 1.0, last["load1"] >= 0.0,
                last["num_worker_procs"] >= 2, len(h2["cluster"]))

    _same(live, scn, (True, True, True, True, True, True, 1))


def test_metrics_page_in_ui(live):
    def scn(rt, port, _):
        html = _ui_html(rt)
        return ('"metrics"' in html.replace("'", '"'),
                "/api/metrics/history" in html)

    _same(live, scn, (True, True))


def test_profile_from_ui(live):
    def scn(rt, port, _):
        ws = _get_json(port, "/api/workers")
        target = [w for w in ws if not w["dead"]
                  and w["kind"] == "worker"][0]
        prof = _get_json(port,
                         f"/api/profile?wid={target['wid']}&duration=1&hz=50")
        try:
            _get(port, "/api/profile")
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        return (prof["wid"] == target["wid"],
                isinstance(prof["profile"], str) and len(prof["profile"]) > 0,
                code, "/api/profile?wid=" in _ui_html(rt))

    _same(live, scn, (True, True, 400, True))


def test_port_page_charts_gpus_where_the_reference_charts_tpus(live):
    """The page's deliberate differences, and no other: the port's
    history and chart read the GPU resource where the reference's read
    TPU, its worker and node tables show GPUs, and it names its package."""
    import ray_tpu
    import ray_tpu_torch

    ref = _ui_html(ray_tpu).split("-->", 1)[1]
    port = _ui_html(ray_tpu_torch).split("-->", 1)[1]
    for old, new in (
            ("<title>ray_tpu dashboard", "<title>ray_tpu_torch dashboard"),
            ("<h1>ray_tpu</h1>", "<h1>ray_tpu_torch</h1>"),
            ("tpu_used", "gpu_used"), ("tot.TPU", "tot.GPU"),
            ("av.TPU", "av.GPU"), ('includes("TPU")', 'includes("GPU")'),
            ('"TPU in use"', '"GPU in use"'),
            ("<code>ray_tpu grafana",
             "<code>python -m ray_tpu_torch.scripts.cli grafana"),
            ('"quarantined chips"', '"quarantined gpus"'),
            ('"tpu chips"', '"gpus"'), ("w.tpu_chips", "w.gpus")):
        assert old in ref, old
        ref = ref.replace(old, new)
    assert ref == port
    assert "TPU" not in port and "tpu_" not in port.replace("ray_tpu_", "")


def test_grafana_provisioning_artifacts(tmp_path):
    def scn(rt):
        out = tmp_path / rt.__name__
        written = sub(rt, "dashboard.grafana").provision(
            str(out), dashboard_host="1.2.3.4:8265",
            prometheus_host="5.6.7.8:9090")
        rels = sorted(p[len(str(out)) + 1:] for p in written)
        core = json.load(open(out / "grafana/dashboards/ray_tpu_core.json"))
        serve = json.load(open(out / "grafana/dashboards/"
                                     "ray_tpu_serve.json"))
        exprs = [t["expr"] for p in core["panels"] for t in p["targets"]]
        sexprs = [t["expr"] for p in serve["panels"] for t in p["targets"]]
        prom = (out / "prometheus/prometheus.yml").read_text()
        ds = (out / "grafana/provisioning/datasources/ray_tpu.yml").read_text()
        return (rels, core["uid"], len(core["panels"]) >= 5,
                [m for m in ("ray_tpu_pending_tasks", "ray_tpu_live_actors",
                             "ray_tpu_object_store_bytes",
                             "ray_tpu_live_workers")
                 if not any(m in e for e in exprs)],
                all(p["gridPos"]["w"] == 12 and p["gridPos"]["x"] ==
                    (i % 2) * 12 for i, p in enumerate(core["panels"])),
                any("ray_tpu_serve_requests_total" in e for e in sexprs),
                any("ray_tpu_serve_request_latency_ms" in e for e in sexprs),
                "1.2.3.4:8265" in prom and "/metrics" in prom,
                "5.6.7.8:9090" in ds, exprs, sexprs)

    import ray_tpu
    import ray_tpu_torch

    a, b = scn(ray_tpu), scn(ray_tpu_torch)
    assert a == b, (a, b)
    assert "grafana/dashboards/ray_tpu_core.json" in a[0]
    assert a[1:9] == ("raytpucore", True, [], True, True, True, True, True)


def test_serve_metrics_reach_prometheus_endpoint(live):
    def scn(rt, port, _):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=1)
        class Echo:
            def __call__(self, x):
                return x

        h = serve.run(Echo.bind(), name="mx")
        try:
            got = [h.remote(i).result(timeout_s=30) for i in range(5)]

            # wait for every series asserted below: the reference's
            # /metrics names a family in HELP and TYPE lines before it has
            # a sample, and the replica counts a request before it
            # observes its latency, so a flush between the two ships the
            # counter alone
            want = ("ray_tpu_serve_requests_total", 'deployment="mx_Echo"',
                    "ray_tpu_serve_request_latency_ms")

            def scraped():
                text = _get(port, "/metrics")[1].decode()
                return text if all(w in text for w in want) else None

            text = _poll(scraped, 20) or ""
        finally:
            serve.shutdown()
        return (got, "ray_tpu_serve_requests_total" in text,
                'deployment="mx_Echo"' in text,
                "ray_tpu_serve_request_latency_ms" in text)

    _same(live, scn, ([0, 1, 2, 3, 4], True, True, True))


def test_api_serve_surfaces_replica_health(live):
    def scn(rt, port, _):
        serve = serve_of(rt)

        @serve.deployment
        class Hello:
            def __call__(self, x):
                return x

        h = serve.run(Hello.bind(), name="dash", route_prefix="/dash")
        try:
            one = h.remote(1).result(timeout_s=30)

            def ready():
                data = _get_json(port, "/api/serve")
                dep = (data.get("deployments") or {}).get("dash_Hello")
                return (data, dep) if dep and dep.get("replicas") else None

            data, dep = _poll(ready, 30)
        finally:
            serve.shutdown()
        (tag, rep), = dep["replicas"].items()
        return (one, tag.startswith("Hello#"), bool(rep["actor_id"]),
                rep["health"] in ("recovering", "healthy"),
                data["apps"].get("dash"), "/dash" in data["routes"])

    _same(live, scn, (1, True, True, True, "dash_Hello", True))


def _poll(fn, timeout, every=0.3):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(every)
    return fn()


# ------------------------------------ tests/test_observability.py (session)


def test_metrics_events_dashboard(live):
    def scn(rt, port, _):
        met = sub(rt, "util.metrics")
        met.clear_registry()
        met.Counter("driver_side_total", "driver metric").inc(7)
        metrics_mod = f"{rt.__name__}.util.metrics"

        @rt.remote
        def work(i):
            import importlib

            m = importlib.import_module(metrics_mod)
            m.Counter("task_side_total", "task metric").inc()
            return i

        assert rt.get([work.remote(i) for i in range(4)]) == list(range(4))
        w = sub(rt, "_private.api")._worker
        w._flush_telemetry()

        def both():
            snap = w.rpc({"type": "metrics_snapshot"})["metrics"]
            return snap if ("task_side_total" in snap
                            and "driver_side_total" in snap) else None

        snap = _poll(both, 15) or {}
        events = w.rpc({"type": "task_events"})["events"]
        head = sub(rt, "dashboard").start_dashboard(_sd(rt))
        try:
            base = head.port
            cluster = _get_json(base, "/api/cluster")
            prom = _get(base, "/metrics")[1].decode()
            tl = _get_json(base, "/api/timeline")
            html = _get(base, "/")[1].decode()
            logs = _get_json(base, "/api/logs")
        finally:
            head.stop()
        met.clear_registry()
        return ("driver_side_total" in snap, "task_side_total" in snap,
                "ray_tpu_tasks_total" in snap,
                any(ev.get("event") == "task:execute" for ev in events),
                any(ev.get("task_id") for ev in events),
                "total_resources" in cluster, "driver_side_total" in prom,
                "ray_tpu_pending_tasks" in prom,
                isinstance(tl["traceEvents"], list) and bool(
                    tl["traceEvents"]),
                rt.__name__ in html, isinstance(logs, list))

    _same(live, scn, (True,) * 11)


def test_pubsub_channels(live):
    def scn(rt, port, _):
        Subscriber = sub(rt, "_private.pubsub").Subscriber
        publish = sub(rt, "_private.pubsub").publish
        s = Subscriber("custom")
        publish("custom", {"hello": 1})
        first = s.poll(timeout=10)
        publish("custom", "a")
        publish("custom", "b")
        buffered = s.poll(timeout=10)
        s.close()
        return first, buffered, s.poll()

    _same(live, scn, ([{"hello": 1}], ["a", "b"], []))


def test_error_and_actor_state_channels(live):
    def scn(rt, port, _):
        Subscriber = sub(rt, "_private.pubsub").Subscriber
        err_sub = Subscriber("errors")
        state_sub = Subscriber("actor_state")

        @rt.remote(max_retries=0)
        def boom():
            raise ValueError("kaboom")

        try:
            rt.get(boom.remote())
            raised = False
        except Exception:  # noqa: BLE001 — the class differs by package
            raised = True
        items = err_sub.poll(timeout=10)

        @rt.remote
        class A:
            def ping(self):
                return "pong"

        a = A.remote()
        pong = rt.get(a.ping.remote())
        deadline = time.time() + 10
        seen = []
        while time.time() < deadline:
            seen += state_sub.poll(timeout=2)
            if any(s.get("state") == "alive" for s in seen):
                break
        err_sub.close()
        state_sub.close()
        rt.kill(a)
        return (raised, bool(items) and "kaboom" in str(items[0].get(
            "error")), pong, any(s.get("state") == "alive" for s in seen))

    _same(live, scn, (True, True, "pong", True))


def test_on_demand_sampling_profiler(live):
    def scn(rt, port, _):
        @rt.remote
        def spin():
            import time as _t

            t0 = _t.time()
            x = 0
            while _t.time() - t0 < 3:
                x += sum(range(200))
            return x

        ref = spin.remote()
        time.sleep(0.5)
        w = sub(rt, "_private.api")._get_worker()
        busy = [x for x in w.rpc({"type": "list_workers"})["workers"]
                if not x["dead"] and x["kind"] == "worker"
                and not x.get("idle") and not x.get("actor_id")]
        r = w.rpc({"type": "worker_profile", "wid": busy[0]["wid"],
                   "duration_s": 1.5, "hz": 50}, timeout=40)
        text = r.get("stacks", "")
        rt.get(ref, timeout=60)
        return (r.get("ok"), "samples over" in text,
                "collapsed stacks" in text,
                "spin" in text or "execute_spec" in text)

    _same(live, scn, (True, True, True, True))


def test_dashboard_ui_and_api_serve(live):
    def scn(rt, port, _):
        dash = sub(rt, "dashboard.head").start_dashboard(_sd(rt), port=0)
        try:
            html = _get(dash.port, "/")[1].decode()
            cluster = _get_json(dash.port, "/api/cluster")
            nodes = _get_json(dash.port, "/api/nodes")
        finally:
            dash.stop()
        return (f"{rt.__name__} dashboard" in html, "/api/cluster" in html,
                "total_resources" in cluster,
                any(n.get("alive") for n in nodes))

    _same(live, scn, (True, True, True, True))


# ---------------------- request tracing and compiled DAGs through the CLI


def _echo(serve):
    @serve.deployment
    class _Echo:
        def __call__(self, request):
            return {"echo": request["body"],
                    "rid": request.get("request_id")}

    return _Echo


def _serve_echo(rt, body) -> dict:
    serve = serve_of(rt)
    serve.start(http_port=0)
    serve.run(_echo(serve).bind(), name="echo", route_prefix="/echo")
    host, port = serve.http_address()
    req = urllib.request.Request(
        f"http://{host}:{port}/echo", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _requests(rt) -> list:
    w = sub(rt, "_private.api")._get_worker()
    return w.rpc({"type": "list_requests"}).get("requests", [])


def _cli(rt, argv) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        sub(rt, "scripts.cli").main(argv)
    return buf.getvalue()


def test_api_requests_endpoint(live):
    def scn(rt, port, _):
        out = _serve_echo(rt, {"x": 2})
        _poll(lambda: any(r.get("request_id") == out["rid"]
                          for r in _requests(rt)), 25)
        rows = _get_json(port, "/api/requests")
        entry = [r for r in rows if r.get("request_id") == out["rid"]][0]
        serve_of(rt).shutdown()
        return (entry["component"], "handle" in entry.get("phases", {}),
                entry.get("duration_s", 0) > 0)

    _same(live, scn, ("http_proxy", True, True))


def test_cli_trace_list_and_show(live):
    def scn(rt, port, _):
        out = _serve_echo(rt, {"x": 3})
        rid = out["rid"]
        tracing = sub(rt, "util.tracing")

        def names():
            tree = tracing.get_trace(rid)
            if tree is None:
                return None
            acc, stack = set(), [tree["root"]]
            while stack:
                s = stack.pop()
                acc.add(s.get("name"))
                stack.extend(s.get("children", ()))
            return acc >= {"serve:request", "proxy:handle"}

        _poll(lambda: any(r.get("request_id") == rid
                          for r in _requests(rt)), 25)
        _poll(names, 30)
        listed = _cli(rt, ["--session", _sd(rt), "trace", "list"])
        shown = _cli(rt, ["--session", _sd(rt), "trace", "show", rid])
        serve_of(rt).shutdown()
        return (rid in listed, "http_proxy" in listed,
                "serve:request" in shown, "proxy:handle" in shown)

    _same(live, scn, (True, True, True, True), sequential=True)


def test_cli_dag_list_and_show(live, monkeypatch, tmp_path):
    private_channel_dirs(monkeypatch, tmp_path)

    def scn(rt, port, _):
        @rt.remote
        class ObsStage:
            def work(self, x):
                return x + 1

        a = ObsStage.remote()
        with sub(rt, "dag").InputNode() as inp:
            dag = a.work.bind(inp)
        compiled = dag.experimental_compile()
        try:
            uses = compiled.uses_channels
            compiled.execute(1).result(timeout=60)
            listed = _cli(rt, ["--session", _sd(rt), "dag", "list"])
            shown = json.loads(_cli(rt, ["--session", _sd(rt), "dag", "show",
                                         compiled.dag_id]))
        finally:
            compiled.teardown()
            rt.kill(a)
        return (uses, compiled.dag_id in listed, "channels" in listed,
                shown["dag"]["dag_id"] == compiled.dag_id)

    _same(live, scn, (True, True, True, True), sequential=True)


def test_every_json_endpoint_answers_on_both_heads(live):
    """The page fetches only some of the head's JSON endpoints: every one
    of them answers on both packages' heads, read at once."""
    pkgs, state = live
    a, b = twin(pkgs, lambda rt: sorted(
        u for u in ("/api/cluster", "/api/nodes", "/api/workers",
                    "/api/actors", "/api/placement_groups", "/api/tasks",
                    "/api/dags", "/api/events", "/api/requests",
                    "/api/serve", "/api/jobs", "/api/logs",
                    "/api/metrics/history", "/api/objects")
        if _get(state[rt.__name__][0], u)[0] == 200),
        serve_cleanup=False)
    assert a == b and len(a) == 14, (a, b)
