"""The port's Serve against the JAX package's: deployments, routing,
composition, autoscaling, batching, HTTP, streaming and the data plane.

Twins of tests/test_serve.py, tests/test_serve_streaming.py and
tests/test_serve_dataplane.py. Each scenario runs through ``ray_tpu`` and
``ray_tpu_torch`` (one module-scoped session each, both in this process) and
the two must return the same: values, statuses, HTTP bodies. Every proxy
starts on ``http_port=0``. Plus: a live JAX proxy and a live port proxy get
different ports and each answers only its own routes, and a port replica
loads nothing of ``jax`` or ``ray_tpu``, and no torch of its own accord.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from torch_twins import post, same, serve_of, start_sessions, \
    stop_sessions, sub, twin


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield pkgs
    stop_sessions(pkgs)


# --------------------------------------------------------------- test_serve


def test_basic_deployment_and_handle(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        class Greeter:
            def __init__(self, greeting):
                self.greeting = greeting

            def __call__(self, name):
                return f"{self.greeting}, {name}!"

            def shout(self, name):
                return f"{self.greeting.upper()}, {name.upper()}!"

        h = serve.run(Greeter.bind("Hello"), name="greet",
                      route_prefix="/greet")
        out = (h.remote("world").result(timeout_s=30),
               h.shout.remote("world").result(timeout_s=30),
               serve.status()["greet_Greeter"]["status"])
        serve.delete("greet")
        return out

    same(pkgs, scn, ("Hello, world!", "HELLO, WORLD!", "HEALTHY"))


def test_function_deployment(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        def double(x):
            return x * 2

        h = serve.run(double.bind(), name="fn", route_prefix="/fn")
        return h.remote(21).result(timeout_s=30)

    same(pkgs, scn, 42)


def test_num_replicas_and_routing(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=2)
        class Who:
            def __call__(self, _):
                import os

                return os.getpid()

        h = serve.run(Who.bind(), name="who", route_prefix="/who")
        return len({h.remote(None).result(timeout_s=30) for _ in range(20)})

    same(pkgs, scn, 2)


def test_composition_nested_handles(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        class Adder:
            def __call__(self, x):
                return x + 1

        @serve.deployment
        class Pipeline:
            def __init__(self, adder):
                self.adder = adder

            def __call__(self, x):
                return self.adder.remote(x).result(timeout_s=30) * 10

        h = serve.run(Pipeline.bind(Adder.bind()), name="pipe",
                      route_prefix="/pipe")
        return h.remote(4).result(timeout_s=30)

    same(pkgs, scn, 50)


def test_batching(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(max_ongoing_requests=16)
        class Batched:
            @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
            def __call__(self, items):
                n = len(items)
                return [(x, n) for x in items]

        h = serve.run(Batched.bind(), name="batch", route_prefix="/batch")
        out = [r.result(timeout_s=30) for r in [h.remote(i)
                                                  for i in range(8)]]
        return sorted(x for x, _ in out), max(n for _, n in out) > 1

    same(pkgs, scn, (list(range(8)), True))


def test_autoscaling_up(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(
            max_ongoing_requests=2,
            autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                                "target_ongoing_requests": 1.0,
                                "downscale_delay_s": 30.0})
        class Slow:
            def __call__(self, _):
                import time as _t

                _t.sleep(0.8)
                return "ok"

        h = serve.run(Slow.bind(), name="auto", route_prefix="/auto")
        h.remote(None).result(timeout_s=30)  # one replica live
        responses = [h.remote(None) for _ in range(12)]
        deadline = time.monotonic() + 30
        scaled = False
        while time.monotonic() < deadline:
            if serve.status()["auto_Slow"]["replicas"] >= 2:
                scaled = True
                break
            time.sleep(0.2)
        return [r.result(timeout_s=60) for r in responses], scaled

    same(pkgs, scn, (["ok"] * 12, True))


def test_http_proxy(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        class Echo:
            def __call__(self, request):
                return {"path": request["path"], "echo": request["body"]}

        serve.start(http_port=0)
        serve.run(Echo.bind(), name="echo", route_prefix="/echo")
        host, port = serve.http_address()
        out = post(f"http://{host}:{port}/echo", {"x": 1}, timeout=30)
        try:
            urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=30)
            missing = None
        except urllib.error.HTTPError as e:
            missing = e.code
        return out, missing

    same(pkgs, scn, ((200, {"path": "/echo", "echo": {"x": 1}}), 404))


def test_user_config_reconfigure(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(user_config={"threshold": 5})
        class Configurable:
            def __init__(self):
                self.threshold = None

            def reconfigure(self, cfg):
                self.threshold = cfg["threshold"]

            def __call__(self, _):
                return self.threshold

        h = serve.run(Configurable.bind(), name="cfg", route_prefix="/cfg")
        return h.remote(None).result(timeout_s=30)

    same(pkgs, scn, 5)


def test_multiplexed_model_loading(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        class MultiModel:
            def __init__(self):
                self.loads = 0

            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id: str):
                self.loads += 1
                return f"model:{model_id}"

            def __call__(self, model_id):
                assert serve.get_multiplexed_model_id() == model_id
                return (self.get_model(model_id), self.loads)

        h = serve.run(MultiModel.bind(), name="mux", route_prefix="/mux")
        m = h.options(multiplexed_model_id="a")
        a1, b1 = m.remote("a").result(timeout_s=30)
        a2, b2 = m.remote("a").result(timeout_s=30)
        return a1, a2, b1 == b2  # cached, not reloaded

    same(pkgs, scn, ("model:a", "model:a", True))


def test_replica_death_recovery(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=1)
        class Fragile:
            def __call__(self, action):
                import os

                if action == "die":
                    os._exit(1)
                return os.getpid()

        h = serve.run(Fragile.bind(), name="frag", route_prefix="/frag")
        pid1 = h.remote("ok").result(timeout_s=30)
        try:
            h.remote("die").result(timeout_s=30)
        except Exception:  # noqa: BLE001 — the dying request fails
            pass
        deadline = time.monotonic() + 30
        pid2 = None
        while time.monotonic() < deadline:
            try:
                pid2 = h.remote("ok").result(timeout_s=5)
                break
            except Exception:  # noqa: BLE001 — not replaced yet
                time.sleep(0.2)
        return pid2 is not None and pid2 != pid1

    same(pkgs, scn, True)


# ------------------------------------------------------ test_serve_streaming


def _streamer(serve):
    @serve.deployment
    class Streamer:
        def stream_request(self, request: dict):
            import time as _t

            n = int((request.get("body") or {}).get("n", 4))
            for i in range(n):
                yield {"token": f"t{i}"}
                _t.sleep(0.3)

        def __call__(self, request: dict):
            return {"ok": True}

    return Streamer


def _sse_request(port: int, path: str, body: dict):
    """(status, content type, events, their arrival times) of one SSE POST."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    payload = json.dumps(body)
    conn.request("POST", path, body=payload,
                 headers={"Content-Type": "application/json",
                          "Accept": "text/event-stream",
                          "Content-Length": str(len(payload))})
    resp = conn.getresponse()
    events, stamps, buf = [], [], b""
    while resp.status == 200:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            raw, buf = buf.split(b"\n\n", 1)
            if raw.startswith(b"data: "):
                events.append(raw[len(b"data: "):].decode())
                stamps.append(time.monotonic())
    out = resp.status, resp.getheader("Content-Type"), events, stamps
    conn.close()
    return out


def test_sse_streams_incrementally(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        serve.start(http_port=0)
        serve.run(_streamer(serve).bind(), name="sse", route_prefix="/sse")
        _, port = serve.http_address()
        status, ctype, events, stamps = _sse_request(port, "/sse", {"n": 4})
        # tokens arrive over time, not in one flush at the end
        return status, ctype, events, stamps[-2] - stamps[0] > 0.5

    same(pkgs, scn, (200, "text/event-stream",
                     [json.dumps({"token": f"t{i}"}) for i in range(4)]
                     + ["[DONE]"], True))


def test_handle_stream_api(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        h = serve.run(_streamer(serve).bind(), name="hstream",
                      route_prefix="/hstream")
        return list(h.options(stream=True,
                              method_name="stream_request").remote(
            {"body": {"n": 3}}))

    same(pkgs, scn, [{"token": "t0"}, {"token": "t1"}, {"token": "t2"}])


def test_prefix_aware_routing_sticks(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=2, request_router="prefix_aware")
        class WhoAmI:
            def __init__(self):
                import os

                self.pid = os.getpid()

            def __call__(self, request: dict):
                return {"pid": self.pid}

        h = serve.run(WhoAmI.bind(), name="pfx", route_prefix="/pfx")
        time.sleep(0.5)

        def ask(prompt):
            return h.remote({"body": {"prompt": prompt}},
                            _routing_hint=prompt).result(
                timeout_s=30)["pid"]

        base = "Once upon a time in a land far away, "
        sticky = len({ask(base + str(i)) for i in range(6)})
        return sticky, isinstance(ask("Completely different prompt " * 3),
                                  int)

    same(pkgs, scn, (1, True))


def test_prefix_tree_unit(pkgs):
    def scn(rt):
        t = sub(rt, "serve.request_router").PrefixTree()
        t.insert("hello world", "r1")
        t.insert("hello there", "r2")
        out = [t.match("hello world, how are you"), t.match("hello thx"),
               t.match("goodbye")]
        t.drop_replica("r1")
        return out, t.match("hello world")[1] != "r1"

    same(pkgs, scn, ([(len("hello world"), "r1"), (len("hello th"), "r2"),
                      (0, None)], True), serve_cleanup=False)


def test_rpc_ingress_unary_and_stream(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        ingress = sub(rt, "serve.rpc_ingress")

        @serve.deployment
        class Echo:
            def __call__(self, payload):
                if isinstance(payload, dict) and payload.get("stream"):
                    def gen():
                        for i in range(payload["n"]):
                            yield {"i": i}
                    return gen()
                return {"echo": payload}

        serve.run(Echo.bind(), name="rpc_echo")
        _, (host, port) = ingress.start_rpc_ingress()
        client = ingress.RPCClient(host, port)
        try:
            out = client.call({"x": 41}, app="rpc_echo")
            chunks = list(client.stream({"stream": True, "n": 4},
                                        app="rpc_echo"))
            try:
                client.call({"x": 1}, app="nonexistent_app")
                err = None
            except RuntimeError as e:
                err = "rpc call failed" in str(e)
        finally:
            client.close()
        return out, chunks, err

    same(pkgs, scn, ({"echo": {"x": 41}}, [{"i": i} for i in range(4)],
                     True))


def test_rpc_ingress_abandoned_stream_and_singleton(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        ingress = sub(rt, "serve.rpc_ingress")

        @serve.deployment
        class Gen:
            def __call__(self, payload):
                if isinstance(payload, dict) and payload.get("stream"):
                    def gen():
                        for i in range(10):
                            yield i
                    return gen()
                return "unary"

        serve.run(Gen.bind(), name="rpc_gen")
        _, addr1 = ingress.start_rpc_ingress()
        _, addr2 = ingress.start_rpc_ingress()
        client = ingress.RPCClient(*addr1)
        try:
            g = client.stream({"stream": True}, app="rpc_gen")
            first = next(g)
            g.close()  # abandoned mid-stream: the client drains the frames
            after = client.call({"x": 1}, app="rpc_gen")
            chunks = list(client.stream({"stream": True}, app="rpc_gen"))
        finally:
            client.close()
        return addr1 == addr2, first, after, chunks

    same(pkgs, scn, (True, 0, "unary", list(range(10))))


# ------------------------------------------------------ test_serve_dataplane


def test_http_keepalive_many_requests_one_connection(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        def echo(req):
            return {"got": (req.get("body") or {}).get("x")}

        serve.run(echo.bind(), name="ka", route_prefix="/ka")
        serve.start(http_port=0)
        host, port = serve.http_address()
        conn = http.client.HTTPConnection(host, port, timeout=30)
        got = []
        try:
            for i in range(20):
                conn.request("POST", "/ka", body=json.dumps({"x": i}),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                got.append((resp.status, json.loads(resp.read())["got"]))
        finally:
            conn.close()
        return got

    same(pkgs, scn, [(200, i) for i in range(20)])


def test_http_concurrent_requests(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=2, max_ongoing_requests=8)
        def work(req):
            import time as _t

            _t.sleep(0.2)
            return {"ok": (req.get("body") or {}).get("i")}

        serve.run(work.bind(), name="conc", route_prefix="/conc")
        serve.start(http_port=0)
        host, port = serve.http_address()
        results: dict = {}

        def call(i):
            try:
                results[i] = post(f"http://{host}:{port}/conc", {"i": i})
            except Exception as e:  # noqa: BLE001 — reported below
                results[i] = ("error", repr(e))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(12)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        wall = time.monotonic() - t0
        # 12 x 0.2 s of work, concurrently rather than serially (2.4 s)
        return sorted(results.items()), wall < 2.2

    # timed: the two sides one after the other
    same(pkgs, scn, ([(i, (200, {"ok": i})) for i in range(12)], True),
         sequential=True)


@pytest.mark.slow
def test_scale_down_drops_no_requests(pkgs):
    """Requests in flight on replicas being scaled away complete."""
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=4, max_ongoing_requests=4)
        def slow(req):
            import time as _t

            _t.sleep(0.4)
            return {"ok": (req.get("body") or {}).get("i")}

        slow = slow.options(graceful_shutdown_timeout_s=30.0)
        serve.run(slow.bind(), name="sd", route_prefix="/sd")
        serve.start(http_port=0)
        host, port = serve.http_address()
        results: dict = {}
        stop = threading.Event()

        def caller(i):
            j = 0
            while not stop.is_set():
                key = i * 1000 + j
                try:
                    results[key] = post(f"http://{host}:{port}/sd",
                                        {"i": key})
                except Exception as e:  # noqa: BLE001 — counted below
                    results[key] = ("error", repr(e))
                j += 1

        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        time.sleep(1.5)
        serve.run(slow.options(num_replicas=1,
                               graceful_shutdown_timeout_s=30.0).bind(),
                  name="sd", route_prefix="/sd")
        time.sleep(2.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        errors = [v for v in results.values() if v[0] != 200]
        return bool(results), errors, serve.status()["sd_slow"]["replicas"]

    same(pkgs, scn, (True, [], 1), sequential=True)


def test_graceful_proxy_shutdown_drains(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        def slowreq(req):
            import time as _t

            _t.sleep(1.0)
            return {"done": True}

        serve.run(slowreq.bind(), name="gs", route_prefix="/gs")
        serve.start(http_port=0)
        host, port = serve.http_address()
        out: list = []

        def call():
            try:
                out.append(post(f"http://{host}:{port}/gs", {}, timeout=30))
            except Exception as e:  # noqa: BLE001 — reported below
                out.append(("error", repr(e)))

        t = threading.Thread(target=call)
        t.start()
        time.sleep(0.3)  # the request is in flight
        serve.shutdown()  # the proxy's graceful stop lets it finish
        t.join(timeout=30)
        return out

    same(pkgs, scn, [(200, {"done": True})])


# ------------------------------------------------- the two runtimes' proxies


def test_jax_and_port_proxies_on_port_zero_get_their_own_ports(pkgs):
    """Both proxies started with http_port=0 listen on different ports and
    each answers only its own routes: a port replica is never reached
    through the JAX proxy, nor the reverse."""
    jrt, trt = pkgs
    addrs = {}
    for rt in pkgs:
        serve = serve_of(rt)

        @serve.deployment
        def who(req, _name=rt.__name__):
            return {"runtime": _name}

        serve.start(http_port=0)
        serve.run(who.bind(), name="who",
                  route_prefix=f"/{rt.__name__}")
        addrs[rt.__name__] = serve.http_address()
    try:
        jport, tport = addrs["ray_tpu"][1], addrs["ray_tpu_torch"][1]
        assert jport != tport and 0 not in (jport, tport)
        for name, (host, port) in addrs.items():
            for route in ("ray_tpu", "ray_tpu_torch"):
                url = f"http://{host}:{port}/{route}"
                if route == name:
                    assert post(url, {}) == (200, {"runtime": name})
                else:
                    with pytest.raises(urllib.error.HTTPError) as ei:
                        post(url, {})
                    assert ei.value.code == 404
    finally:
        for rt in pkgs:
            serve_of(rt).shutdown()


def test_port_replicas_load_no_jax_package_and_no_torch(pkgs):
    """A port replica (a class pickled by value from this file) has no
    ray_tpu, jax or test module loaded, and no torch until its code
    imports it; the JAX package's has no ray_tpu_torch."""
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        class Mods:
            def __call__(self, _):
                import sys

                return sorted(m for m in sys.modules
                              if m.split(".")[0] in ("ray_tpu", "jax",
                                                     "ray_tpu_torch", "torch")
                              or m.startswith(("test_", "tests.",
                                               "torch_twins")))

        h = serve.run(Mods.bind(), name="mods", route_prefix="/mods")
        return h.remote(None).result(timeout_s=60)

    jax_side, port_side = twin(pkgs, scn)
    assert port_side and all(m.split(".")[0] == "ray_tpu_torch"
                             for m in port_side), port_side
    assert not any(m.split(".")[0] == "ray_tpu_torch" or
                   m.startswith(("test_", "tests.", "torch_twins"))
                   for m in jax_side)
