"""The port's native C++ object-plane server against the JAX package's.

Twins of tests/test_native_object_server.py: the binary protocol (hit,
miss, a path-traversal oid), the spill tier, and a cross-host pull through
the native plane in a cluster. Each package serves from its own copy of
the C++ source (the port's ``ray_tpu_torch/csrc/object_server.cc``, symbols
``rtpt_objsrv_*``, built into ``ray_tpu_torch/build/``); the two sides
agree on what each fetch returns and on the bytes. Also: the port's build
failure raises instead of falling back to the Python server.
"""

from __future__ import annotations

import hashlib
import importlib
import subprocess

import numpy as np
import pytest

from torch_twins import env_name, pair, same, sub


def _native(rt):
    return sub(rt, "_private.native_object_server")


def _stores(rt, tag):
    store_cls = sub(rt, "_private.object_store").ShmObjectStore
    return store_cls(f"{tag}_{rt.__name__}_src"), \
        store_cls(f"{tag}_{rt.__name__}_dst")


def test_native_server_roundtrip():
    def scn(rt):
        src, dst = _stores(rt, "natsrv")
        nat = _native(rt)
        try:
            payload = np.arange(100_000, dtype=np.float64).tobytes()
            src.put_parts("aabbccdd01", [payload], len(payload))
            srv = nat.NativeObjectServer(src)
            try:
                host, port = srv.address[len("native:"):].rsplit(":", 1)
                tier = nat.fetch_native(dst, "aabbccdd01", host, int(port))
                got = bytes(dst.get("aabbccdd01").buf)
                return (srv.address.startswith("native:"), tier,
                        hashlib.sha256(got).hexdigest()
                        == hashlib.sha256(payload).hexdigest(),
                        # the miss path, and a path-traversal oid refused
                        # by the C side (dots are not in its alphabet)
                        nat.fetch_native(dst, "missing000", host, int(port)),
                        nat.fetch_native(dst, "..", host, int(port)))
            finally:
                srv.stop()
        finally:
            src.cleanup_session()
            dst.cleanup_session()

    pair(scn, (True, "shm", True, False, False))


def test_native_server_serves_spill_tier():
    def scn(rt):
        src, dst = _stores(rt, "natspill")
        nat = _native(rt)
        try:
            blob = b"z" * 50_000
            src.put_parts("deadbee002", [blob], len(blob))
            spilled = src.spill("deadbee002")  # to the disk tier
            srv = nat.NativeObjectServer(src)
            try:
                host, port = srv.address[len("native:"):].rsplit(":", 1)
                tier = nat.fetch_native(dst, "deadbee002", host, int(port))
                return spilled, tier, bytes(dst.get("deadbee002").buf) == blob
            finally:
                srv.stop()
        finally:
            src.cleanup_session()
            dst.cleanup_session()

    pair(scn, (True, "shm", True))


def test_cross_host_pull_through_native_plane(monkeypatch):
    """A follower host on the file store serves through the C++ server (its
    object address carries "native:"); the driver and a head worker pull
    its object through it, bytes equal in both packages."""
    import ray_tpu
    import ray_tpu_torch

    pkgs = (ray_tpu, ray_tpu_torch)
    for rt in pkgs:
        monkeypatch.setenv(env_name(rt, "OBJECT_SERVER_BACKEND"), "native")
        monkeypatch.setenv(env_name(rt, "STORE_BACKEND"), "file")

    def scn(rt):
        rt.shutdown()
        cluster = sub(rt, "cluster_utils").Cluster(head_node_args=dict(
            num_cpus=2, num_workers=1, max_workers=8))
        try:
            host = cluster.add_host(num_cpus=2)
            on = sub(rt, "util.scheduling_strategies") \
                .NodeAffinitySchedulingStrategy

            @rt.remote
            def make(n):
                import numpy as np

                return np.ones((n,), dtype=np.float64) * 7.0

            @rt.remote
            def digest(arr):
                import hashlib

                return hashlib.sha256(arr.tobytes()).hexdigest()

            gcs = sub(rt, "_private.api")._node.gcs
            with gcs.lock:
                addrs = {h: info["object_addr"]
                         for h, info in gcs.hosts.items()}
            ref = make.options(scheduling_strategy=on(node_id=host)).remote(
                300_000)
            arr = rt.get(ref, timeout=60)
            on_head = rt.get(digest.options(
                scheduling_strategy=on(node_id="node-0")).remote(ref),
                timeout=60)
            return (arr.shape, float(arr[0]),
                    hashlib.sha256(arr.tobytes()).hexdigest() == on_head,
                    {h: a.startswith("native:") for h, a in addrs.items()})
        finally:
            cluster.shutdown()

    same(pkgs, scn, ((300_000,), 7.0, True, {"host-0": True, "host-1": True}),
         sequential=True, serve_cleanup=False)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A source g++ cannot compile raises out of the server's constructor
    and out of make_object_server: the port never swaps the Python server
    in for a native one it was asked for."""
    nat = importlib.import_module(
        "ray_tpu_torch._private.native_object_server")
    from ray_tpu_torch._private import object_transfer
    from ray_tpu_torch._private.object_store import ShmObjectStore

    bad = tmp_path / "object_server.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nat, "_SRC", str(bad))
    monkeypatch.setattr(nat, "_LIB", str(tmp_path / "libobjserver.so"))
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setenv("RAY_TPU_TORCH_OBJECT_SERVER_BACKEND", "native")
    store = ShmObjectStore("natbuild_ray_tpu_torch")
    try:
        with pytest.raises(subprocess.CalledProcessError):
            nat.NativeObjectServer(store)
        with pytest.raises(subprocess.CalledProcessError):
            object_transfer.make_object_server(store)
    finally:
        store.cleanup_session()
