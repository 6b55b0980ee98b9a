"""The port's Serve control-plane fault tolerance against the JAX package's.

Twins of tests/test_serve_chaos.py: SIGKILL the controller under traffic
(zero dropped requests, replicas re-adopted), kill a replica and the
controller together, hang a replica until its probes replace it, saturate
a replica without losing it, deploy twice, reap a stale row, redeploy
after recovery, and kill a proxy shard under traffic. Each scenario runs
through both runtimes (one module-scoped session each) and returns what
the reference test asserts; each side kills only its own runtime's
processes, found through its own worker table.
"""

from __future__ import annotations

import glob
import os
import signal
import threading
import time

import pytest

from torch_twins import gcs_counter, pid_of_actor, post, rpc, same, \
    serve_of, start_sessions, stop_sessions, sub, wait_for

pytestmark = pytest.mark.serve_chaos


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield pkgs
    stop_sessions(pkgs)


def _controller(rt):
    return sub(rt, "serve.api")._get_controller()


def _sigkill_controller(rt):
    os.kill(pid_of_actor(rt, _controller(rt).actor_id), signal.SIGKILL)


def _replica_ids(rt, full_name: str) -> list[str]:
    table = rt.get(_controller(rt).get_routing_table.remote(-1),
                   timeout=30.0)
    dep = table["deployments"].get(full_name) or {}
    return sorted(dep.get("replicas") or [])


def _serve_rows(rt) -> dict:
    return rpc(rt, {"type": "serve_list"})["rows"]


def test_controller_sigkill_under_traffic_zero_drops(pkgs):
    """SIGKILL the controller under concurrent HTTP and handle traffic: no
    failed request, replicas re-adopted (ids unchanged), scale-up and
    delete work after recovery."""
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=2, max_ongoing_requests=8)
        class Echo:
            def __call__(self, x):
                return {"ok": True}

        h = serve.run(Echo.bind(), name="ct", route_prefix="/ct")
        serve.start(http_port=0)
        host, port = serve.http_address()
        first = h.remote(0).result(timeout_s=30)
        ids_before = _replica_ids(rt, "ct_Echo")
        recoveries0 = gcs_counter(
            rt, "ray_tpu_serve_controller_recoveries_total")
        errors: list = []
        counts = {"http": 0, "handle": 0}
        stop = threading.Event()

        def http_loop():
            while not stop.is_set():
                try:
                    status, out = post(f"http://{host}:{port}/ct", {},
                                       timeout=30)
                    assert status == 200 and out == {"ok": True}
                    counts["http"] += 1
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(("http", repr(e)))
                    return

        def handle_loop():
            while not stop.is_set():
                try:
                    assert h.remote(1).result(timeout_s=30) == {"ok": True}
                    counts["handle"] += 1
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(("handle", repr(e)))
                    return

        threads = [threading.Thread(target=http_loop) for _ in range(2)] + \
            [threading.Thread(target=handle_loop) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.8)
        _sigkill_controller(rt)
        time.sleep(2.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        st = wait_for(lambda: serve.status().get("ct_Echo"),
                      desc="controller recovery")
        readopted = _replica_ids(rt, "ct_Echo") == ids_before
        wait_for(lambda: gcs_counter(
            rt, "ray_tpu_serve_controller_recoveries_total")
            >= recoveries0 + 1, desc="recovery counter flush")
        readopt_count = gcs_counter(
            rt, "ray_tpu_serve_replicas_readopted_total") >= 2
        serve.run(Echo.options(num_replicas=3).bind(), name="ct",
                  route_prefix="/ct")
        wait_for(lambda: serve.status()["ct_Echo"]["replicas"] == 3,
                 desc="post-recovery scale-up")
        kept = set(ids_before) <= set(_replica_ids(rt, "ct_Echo"))
        after = h.remote(2).result(timeout_s=30)
        serve.delete("ct")
        wait_for(lambda: "ct_Echo" not in serve.status(),
                 desc="post-recovery delete")
        return (first, len(ids_before), errors,
                counts["http"] > 5 and counts["handle"] > 5, readopted,
                st["replicas"], readopt_count, kept, after)

    same(pkgs, scn, ({"ok": True}, 2, [], True, True, 2, True, True,
                     {"ok": True}))


def test_replica_and_controller_killed_together_converges(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=2)
        class P:
            def __call__(self, _):
                import os

                return os.getpid()

        h = serve.run(P.bind(), name="dk", route_prefix="/dk")
        wait_for(lambda: serve.status()["dk_P"]["replicas"] == 2,
                 desc="2 replicas up")
        assert h.remote(None).result(timeout_s=30)
        ids = _replica_ids(rt, "dk_P")
        replica_pid = pid_of_actor(rt, ids[0])
        ctl_pid = pid_of_actor(rt, _controller(rt).actor_id)
        os.kill(replica_pid, signal.SIGKILL)
        os.kill(ctl_pid, signal.SIGKILL)

        def converged():
            st = serve.status().get("dk_P")
            if not st or st["replicas"] != 2:
                return None
            new_ids = _replica_ids(rt, "dk_P")
            return (ids[1] in new_ids and ids[0] not in new_ids
                    and len(new_ids) == 2)

        wait_for(converged, timeout=60, desc="converge after double kill")
        # call_sync retries a dead replica the router may still cache
        return bool(h.call_sync(None, timeout_s=30))

    same(pkgs, scn, True)


def test_hung_replica_replaced_by_health_probes(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(health_check_period_s=0.2,
                          health_check_timeout_s=1.0,
                          graceful_shutdown_timeout_s=1.0)
        class Wedgeable:
            def __init__(self):
                self.hang = False

            def __call__(self, cmd):
                if cmd == "hang":
                    self.hang = True
                return "ok"

            def check_health(self):
                import time as _t

                if self.hang:
                    _t.sleep(3600)

        h = serve.run(Wedgeable.bind(), name="hw", route_prefix="/hw")
        first = h.remote("x").result(timeout_s=30)
        aid0 = _replica_ids(rt, "hw_Wedgeable")[0]
        fails0 = gcs_counter(
            rt, "ray_tpu_serve_replica_health_check_failures_total",
            {"deployment": "hw_Wedgeable"})
        h.remote("hang").result(timeout_s=30)
        t0 = time.monotonic()

        def replaced():
            ids = _replica_ids(rt, "hw_Wedgeable")
            return ids and ids != [aid0] and aid0 not in ids

        wait_for(replaced, timeout=20, desc="probe-driven replacement")
        fast = time.monotonic() - t0 < 15.0
        after = h.remote("y").result(timeout_s=30)
        wait_for(lambda: gcs_counter(
            rt, "ray_tpu_serve_replica_health_check_failures_total",
            {"deployment": "hw_Wedgeable"}) > fails0,
            desc="probe-failure counter flush")
        return first, fast, after, serve.status()["hw_Wedgeable"]["replicas"]

    same(pkgs, scn, ("ok", True, "ok", 1))


def test_saturated_replica_survives_probes(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(max_ongoing_requests=1, health_check_period_s=0.2,
                          health_check_timeout_s=1.0)
        class Slow:
            def __call__(self, _):
                import time as _t

                _t.sleep(0.5)
                return "ok"

        h = serve.run(Slow.bind(), name="sat", route_prefix="/sat")
        first = h.remote(0).result(timeout_s=30)
        aid0 = _replica_ids(rt, "sat_Slow")[0]
        pending = [h.remote(i) for i in range(8)]
        results = [p.result(timeout_s=60) for p in pending]
        return (first, results, _replica_ids(rt, "sat_Slow") == [aid0],
                serve.status()["sat_Slow"]["replicas"])

    same(pkgs, scn, ("ok", ["ok"] * 8, True, 1))


def test_deploy_is_idempotent_double_persist(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=2)
        class Idem:
            def __call__(self, x):
                return x

        h = serve.run(Idem.bind(), name="ip", route_prefix="/ip")
        wait_for(lambda: serve.status()["ip_Idem"]["replicas"] == 2,
                 desc="replicas up")
        ids = _replica_ids(rt, "ip_Idem")
        rows1 = {k for k in _serve_rows(rt)
                 if k.startswith(("dep:ip_", "rep:ip_"))}
        serve.run(Idem.bind(), name="ip", route_prefix="/ip")
        time.sleep(0.5)
        rows2 = {k for k in _serve_rows(rt)
                 if k.startswith(("dep:ip_", "rep:ip_"))}
        return (rows1 == rows2, _replica_ids(rt, "ip_Idem") == ids,
                h.remote(7).result(timeout_s=30),
                len([k for k in rows2 if k.startswith("dep:")]),
                len([k for k in rows2 if k.startswith("rep:")]))

    same(pkgs, scn, (True, True, 7, 1, 2))


def test_recovery_reaps_stale_replica_row(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        class S:
            def __call__(self, x):
                return x

        h = serve.run(S.bind(), name="sr", route_prefix="/sr")
        wait_for(lambda: serve.status()["sr_S"]["replicas"] == 1,
                 desc="replica up")
        stale_key = "rep:sr_S:S#999"
        rpc(rt, {"type": "serve_put", "key": stale_key, "record": {
            "full_name": "sr_S", "tag": "S#999",
            "actor_name": "SERVE_REPLICA:sr_S:S#999:bogus",
            "actor_id": "deadbeef" * 4, "addr": None, "state": "running",
            "drain_deadline_ts": None}})
        planted = stale_key in _serve_rows(rt)
        _sigkill_controller(rt)
        wait_for(lambda: serve.status().get("sr_S"),
                 desc="controller recovery")
        wait_for(lambda: stale_key not in _serve_rows(rt),
                 desc="stale row reaped")
        wait_for(lambda: serve.status()["sr_S"]["replicas"] == 1,
                 desc="converged to target")
        return planted, h.remote(5).result(timeout_s=30)

    same(pkgs, scn, (True, 5))


def test_config_only_redeploy_after_recovery(pkgs):
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment
        class C:
            def __call__(self, x):
                return x * 2

        dep = C  # one Deployment object: identical blobs across runs
        h = serve.run(dep.bind(), name="cr", route_prefix="/cr")
        first = h.remote(4).result(timeout_s=30)
        ids = _replica_ids(rt, "cr_C")
        _sigkill_controller(rt)
        wait_for(lambda: serve.status().get("cr_C"),
                 desc="controller recovery")
        readopted = _replica_ids(rt, "cr_C") == ids
        serve.run(dep.options(num_replicas=2).bind(), name="cr",
                  route_prefix="/cr")
        wait_for(lambda: serve.status()["cr_C"]["replicas"] == 2,
                 desc="scale-up after recovery")
        return (first, readopted, set(ids) <= set(_replica_ids(rt, "cr_C")),
                h.remote(5).result(timeout_s=30))

    same(pkgs, scn, (8, True, True, 10))


def test_proxy_shard_sigkill_under_traffic(pkgs):
    """Kill one proxy shard of a two-shard plane under HTTP traffic: every
    completed request is a 200, the shard is replaced, and the routing
    segment is unlinked at shutdown."""
    def scn(rt):
        serve = serve_of(rt)
        routing_glob = sub(rt, "_private.constants").SHM_ROUTING_GLOB

        @serve.deployment(num_replicas=2, max_ongoing_requests=16)
        class Echo:
            def __call__(self, x):
                return {"ok": True}

        serve.run(Echo.bind(), name="pp", route_prefix="/pp")
        serve.start(http_port=0, num_proxies=2)
        host, port = serve.http_address()

        def running_shards():
            st = serve.proxy_status()
            return [i for i, s in st["shards"].items()
                    if s["state"] == "running"]

        wait_for(lambda: len(running_shards()) == 2,
                 desc="both shards running")
        ours = set(glob.glob(routing_glob)) - before[rt.__name__]
        victim_aid = _serve_rows(rt)["proxy:0"]["actor_id"]
        errors: list = []
        counts = {"ok": 0}
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                for attempt in range(4):
                    try:
                        status, out = post(f"http://{host}:{port}/pp", {},
                                           timeout=30)
                    except Exception as e:  # noqa: BLE001 — cut connection
                        if attempt == 3:
                            errors.append(("gave up", repr(e)))
                            return
                        time.sleep(0.1)
                        continue
                    if status != 200 or out != {"ok": True}:
                        errors.append(("bad response", status, out))
                        return
                    counts["ok"] += 1
                    break

        threads = [threading.Thread(target=loop) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.8)
        os.kill(pid_of_actor(rt, victim_aid), signal.SIGKILL)

        def replaced():
            row = _serve_rows(rt).get("proxy:0")
            return (row and row.get("actor_id")
                    and row["actor_id"] != victim_aid
                    and row.get("state") == "running")

        wait_for(replaced, timeout=60.0, desc="shard 0 replaced")
        wait_for(lambda: len(running_shards()) == 2, timeout=60.0,
                 desc="fleet back to target")
        stop.set()
        for t in threads:
            t.join(timeout=60)
        after = [post(f"http://{host}:{port}/pp", {}, timeout=30)
                 for _ in range(10)]
        serve.shutdown()
        left = ours & set(glob.glob(routing_glob))
        return (len(ours), errors, counts["ok"] > 10, after, sorted(left))

    import ray_tpu  # noqa: F401 — both packages' constants, before the run
    before = {rt.__name__: set(glob.glob(
        sub(rt, "_private.constants").SHM_ROUTING_GLOB)) for rt in pkgs}
    same(pkgs, scn, (1, [], True, [(200, {"ok": True})] * 10, []))
