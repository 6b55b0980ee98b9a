"""The port's sharded proxy plane units against the JAX package's.

Twins of tests/test_serve_proxy_plane.py: the seqlock routing-table
segment, SO_REUSEPORT and fd-passing port sharing, the HTTP body cap, the
single-flight route refresh, batched phase telemetry and the zero-copy
request envelope, each run on both packages' modules with the same result.
The port's segments are /dev/shm/rtpt_routes_* (the JAX package's
rtpu_routes_*). Not twinned: test_merge_artifact_preserves_foreign_sections,
whose ``scripts/_artifacts.py`` is ROADMAP.md Queue 1 item 20.
"""

from __future__ import annotations

import http.client
import json
import os
import socket
import struct
import threading
import time

import pytest

from torch_twins import same, start_sessions, sub


def _both():
    import ray_tpu
    import ray_tpu_torch

    return ray_tpu, ray_tpu_torch


def _same_units(scn, want=None):
    return same(_both(), scn, want, serve_cleanup=False)


def _pp(rt):
    return sub(rt, "serve.proxy_plane")


def _segment(rt, path, capacity=64 * 1024, create=True):
    return _pp(rt).RoutingTableShm(str(path), capacity, _create=create)


# ------------------------------------------------------- routing shm seqlock


def test_routing_shm_publish_read_roundtrip(tmp_path):
    def scn(rt):
        path = tmp_path / f"{rt.__name__}.seg"
        w = _segment(rt, path)
        r = _pp(rt).RoutingTableShm(str(path), 0)  # attach: sizes itself
        try:
            table = {"version": 7, "routes": {"/a": "app_A"},
                     "deployments": {}}
            w.publish(table)
            got, ver, ts = r.read(-1)
            # unchanged version: the reader pays only the header peek
            same_ver = r.read(7) == (None, 7, ts)
            peek = r.peek()[0]
            w.publish({"version": 8, "routes": {}, "deployments": {}})
            got2, ver2, _ = r.read(7)
            return got == table, ver, ts > 0, same_ver, peek, ver2, \
                got2["version"]
        finally:
            r.close()
            w.close()
            w.unlink()

    _same_units(scn, (True, 7, True, True, 7, 8, 8))


def test_routing_shm_capacity_guard(tmp_path):
    def scn(rt):
        w = _segment(rt, tmp_path / f"{rt.__name__}.seg", capacity=1024)
        try:
            w.publish({"version": 1, "pad": "x" * 4096})
            return None
        except ValueError:
            return "ValueError"
        finally:
            w.close()
            w.unlink()

    _same_units(scn, "ValueError")


def test_routing_shm_torn_read_retries_until_publish(tmp_path):
    def scn(rt):
        path = tmp_path / f"{rt.__name__}.seg"
        w = _segment(rt, path)
        r = _pp(rt).RoutingTableShm(str(path), 0)
        try:
            w.publish({"version": 1, "routes": {}})
            seq = struct.unpack_from("<q", w._mm, 0)[0]
            struct.pack_into("<q", w._mm, 0, seq + 1)  # a write in progress

            def finish():
                time.sleep(0.01)
                w.publish({"version": 2, "routes": {"/b": "app_B"}})

            t = threading.Thread(target=finish)
            t.start()
            got, ver, _ = r.read(-1)  # retries through the odd window
            t.join()
            return ver, got["routes"]
        finally:
            r.close()
            w.close()
            w.unlink()

    _same_units(scn, (2, {"/b": "app_B"}))


def test_routing_shm_wedged_writer_times_out(tmp_path):
    def scn(rt):
        path = tmp_path / f"{rt.__name__}.seg"
        w = _segment(rt, path)
        r = _pp(rt).RoutingTableShm(str(path), 0)
        try:
            struct.pack_into("<q", w._mm, 0, 1)  # writer died mid-write
            try:
                r.read(-1)
                return None
            except TimeoutError:
                return "TimeoutError"
        finally:
            r.close()
            w.close()
            w.unlink()

    _same_units(scn, "TimeoutError")


def test_routing_shm_create_attach_unlink(tmp_path):
    def scn(rt):
        path = str(tmp_path / f"{rt.__name__}.seg")
        w = _pp(rt).RoutingTableShm(path, 4096, _create=True)
        try:
            _pp(rt).RoutingTableShm(path, 4096, _create=True)
            excl = None
        except FileExistsError:
            excl = "FileExistsError"  # O_EXCL create
        w.close()
        w.unlink()
        gone = not os.path.exists(path)
        w.unlink()  # idempotent
        return excl, gone

    _same_units(scn, ("FileExistsError", True))


def test_segment_prefixes_are_each_packages_own():
    import ray_tpu
    import ray_tpu_torch

    j = sub(ray_tpu, "_private.constants")
    t = sub(ray_tpu_torch, "_private.constants")
    assert j.SHM_ROUTING_PREFIX == "rtpu_routes_"
    assert t.SHM_ROUTING_PREFIX == "rtpt_routes_"
    assert t.SHM_ROUTING_GLOB.endswith("rtpt_routes_*")


# ----------------------------------------------------- port sharing / fd pass


def test_reserve_port_pins_without_accepting():
    def scn(rt):
        pp = _pp(rt)
        holder = pp.reserve_port("127.0.0.1", 0)
        try:
            port = holder.getsockname()[1]
            if not pp.REUSEPORT_AVAILABLE:
                return port > 0
            # the holder never listens: a REUSEPORT listener on the same
            # port takes the connection
            srv = pp.make_listen_socket("127.0.0.1", port, reuse_port=True)
            srv.listen(8)
            c = socket.create_connection(("127.0.0.1", port), timeout=5)
            conn, _ = srv.accept()
            conn.close()
            c.close()
            srv.close()
            return port > 0
        finally:
            holder.close()

    _same_units(scn, True)


def test_listener_fd_donor_roundtrip(tmp_path):
    def scn(rt):
        pp = _pp(rt)
        if not pp.FDPASS_AVAILABLE:
            return "no send_fds/recv_fds"
        listen = pp.make_listen_socket("127.0.0.1", 0)
        uds = str(tmp_path / f"{rt.__name__}.sock")
        donor = pp.ListenerFdDonor(listen, uds)
        try:
            got = pp.receive_listener_fd(uds, timeout=10.0)
            # the received fd is the listening socket itself
            same_sock = got.getsockname() == listen.getsockname()
            got.listen(8)
            c = socket.create_connection(("127.0.0.1", donor.port),
                                         timeout=5)
            conn, _ = got.accept()
            conn.sendall(b"hi")
            echoed = c.recv(2)
            conn.close()
            c.close()
            got.close()
        finally:
            donor.close()
        return same_sock, echoed, not os.path.exists(uds)

    out = _same_units(scn)
    assert out in ((True, b"hi", True), "no send_fds/recv_fds")


# ------------------------------------------------------------- HTTP body cap


def test_http_body_cap_returns_413(monkeypatch):
    def scn(rt):
        RayConfig = sub(rt, "_private.ray_config").RayConfig
        AsyncHTTPServer = sub(rt, "serve.http_server").AsyncHTTPServer
        RayConfig.reset()
        srv = AsyncHTTPServer(
            lambda method, path, headers, body: (200, "application/json",
                                                 b'{"ok": true}'),
            "127.0.0.1", 0).start()
        try:
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
            c.request("POST", "/x", body=b"x" * 4096,
                      headers={"Content-Type": "application/json"})
            r = c.getresponse()
            over = r.status, json.loads(r.read())["max_body_bytes"]
            c.close()
            c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=10)
            c.request("POST", "/x", body=b"x" * 512,
                      headers={"Content-Type": "application/json"})
            under = c.getresponse().status
            c.close()
            return over, under
        finally:
            srv.stop()

    monkeypatch.setenv("RAY_TPU_SERVE_MAX_HTTP_BODY_BYTES", "1024")
    monkeypatch.setenv("RAY_TPU_TORCH_SERVE_MAX_HTTP_BODY_BYTES", "1024")
    try:
        _same_units(scn, ((413, 1024), 200))
    finally:
        monkeypatch.undo()
        for rt in _both():
            sub(rt, "_private.ray_config").RayConfig.reset()


# ------------------------------------------------------- single-flight fetch


@pytest.fixture(scope="module")
def tiny_cluster():
    pkgs = start_sessions(num_cpus=4, num_workers=1, max_workers=2)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _counting_controller(rt):
    """Stands in for the controller handle: each get_routing_table fetch
    is counted and served as a real object ref."""
    class _Ctl:
        calls = 0

    ctl = _Ctl()

    class _Method:
        def remote(self, version):
            ctl.calls += 1
            time.sleep(0.05)  # a real RPC takes time: racers pile up
            return rt.put({"version": ctl.calls, "routes": {"/sf": "app"},
                           "deployments": {}})

    ctl.get_routing_table = _Method()
    return ctl


def _bare_proxy(rt, controller):
    p = object.__new__(sub(rt, "serve.proxy").ProxyActor._cls)
    p.controller = controller
    p._routes = {}
    p._version = -1
    p._table = None
    p._handles = {}
    p._lock = threading.Lock()
    p._routes_ts = 0.0
    p._sf_lock = threading.Lock()
    p._sf_event = None
    p._pending_table = None
    p._routes_shm = None
    p._batcher = None
    return p


def test_refresh_routes_single_flight(tiny_cluster):
    def scn(rt):
        ctl = _counting_controller(rt)
        p = _bare_proxy(rt, ctl)
        threads = [threading.Thread(target=p._refresh_routes,
                                    kwargs={"force": True})
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        first = ctl.calls, p._routes
        time.sleep(0.06)  # past the coalescing window: fetches again
        p._refresh_routes(force=True)
        return first, ctl.calls

    same(tiny_cluster, scn, ((1, {"/sf": "app"}), 2), serve_cleanup=False)


def test_refresh_prefers_shm_over_rpc(tiny_cluster, tmp_path):
    def scn(rt):
        ctl = _counting_controller(rt)
        p = _bare_proxy(rt, ctl)
        path = tmp_path / f"{rt.__name__}.seg"
        seg = _segment(rt, path)
        try:
            seg.publish({"version": 3, "routes": {"/shm": "app"},
                         "deployments": {}})
            p._routes_shm = _pp(rt).RoutingTableShm(str(path), 0)
            p._refresh_routes(force=True)
            return p._routes, p._version, ctl.calls
        finally:
            if p._routes_shm is not None:
                p._routes_shm.close()
            seg.close()
            seg.unlink()

    same(tiny_cluster, scn, ({"/shm": "app"}, 3, 0), serve_cleanup=False)


# ------------------------------------------------------------ phase batching


def test_phase_batcher_groups_and_flushes():
    def scn(rt):
        rc = sub(rt, "serve.request_context")
        metrics = sub(rt, "util.metrics")
        flushes = []
        b = rc.PhaseBatcher(flush_s=3600.0, on_flush=lambda: flushes.append(1))
        try:
            for _ in range(5):
                b.add(rc.PROXY_PHASE, "parse", 0.001)
            b.add(rc.PROXY_PHASE, "route", 0.002)
            buffered = len(b._buf)
            b.flush()
            snap = {m["name"]: m for m in metrics.snapshot()}
            series = snap["ray_tpu_serve_proxy_phase_seconds"]["series"]
            by_phase = {dict(tuple(t) for t in tags).get("phase"): st
                        for tags, st in series}
            return (buffered, list(b._buf), list(flushes),
                    by_phase["parse"]["count"] >= 5,
                    by_phase["route"]["count"] >= 1)
        finally:
            b.close()

    _same_units(scn, (6, [], [1], True, True))


def test_observe_phase_routes_through_batcher():
    def scn(rt):
        rc = sub(rt, "serve.request_context")
        b = rc.PhaseBatcher(flush_s=3600.0)
        rc.set_phase_batcher(b)
        try:
            rc.observe_phase(rc.PROXY_PHASE, "handle", 0.01)
            return list(b._buf)
        finally:
            rc.set_phase_batcher(None)
            b.close()

    _same_units(scn)


# ---------------------------------------------------------- zero-copy escrow


def test_build_request_escrows_large_body(tiny_cluster, monkeypatch):
    def scn(rt):
        key = sub(rt, "_private.constants").SERVE_BODY_REF_KEY
        p = _bare_proxy(rt, _counting_controller(rt))
        rec: dict = {}
        big = json.dumps({"pad": "x" * 4096}).encode()
        env = p._build_request("/z", "POST", big, "rid-1", rec)
        escrowed = env["body"] is None and key in env
        pinned = rec["_body_ref"] is not None  # for the request's life
        raw = rt.get(rt.ObjectRef(env[key]), timeout=10.0)
        env2 = p._build_request("/z", "POST", b'{"a": 1}', "rid-2", {})
        return escrowed, pinned, raw == big, env2["body"], key in env2

    monkeypatch.setenv("RAY_TPU_SERVE_ZERO_COPY_THRESHOLD_BYTES", "1024")
    monkeypatch.setenv("RAY_TPU_TORCH_SERVE_ZERO_COPY_THRESHOLD_BYTES",
                       "1024")
    for rt in tiny_cluster:
        sub(rt, "_private.ray_config").RayConfig.reset()
    try:
        same(tiny_cluster, scn, (True, True, True, {"a": 1}, False),
             serve_cleanup=False)
    finally:
        monkeypatch.undo()
        for rt in tiny_cluster:
            sub(rt, "_private.ray_config").RayConfig.reset()
    # the port's envelope key is its own
    assert sub(tiny_cluster[1], "_private.constants").SERVE_BODY_REF_KEY == \
        "__rtpt_body_ref__"
