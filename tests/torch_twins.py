"""Harness of the port's twins of the JAX package's runtime and Serve tests.

A twin runs one scenario through ``ray_tpu`` and through ``ray_tpu_torch``
(both runtimes live in this process, one module-scoped session each) and
compares what the two return: values, exception class names, HTTP statuses
and bodies. A scenario takes the package as its argument and defines its
remote functions and deployment classes inside itself, so they are pickled
by value: a port worker or replica never imports a test file or the JAX
package.
"""

from __future__ import annotations

import importlib
import json
import threading
import time
import urllib.request


def start_sessions(**init_kw):
    """Both runtimes, fresh; returns (ray_tpu, ray_tpu_torch)."""
    import ray_tpu
    import ray_tpu_torch

    out = (ray_tpu, ray_tpu_torch)
    for rt in out:
        rt.shutdown()
        rt.init(**init_kw)
    return out


def stop_sessions(pkgs) -> None:
    for rt in pkgs:
        serve_of(rt).shutdown()
        rt.shutdown()


def shutdown_runtimes(pkgs) -> None:
    """Shut both runtimes down, then collect the garbage their sessions
    left: a GCS's accepted socket of a killed worker is closed only when it
    is collected, and its ResourceWarning must surface here, not inside a
    later test that turns warnings into errors."""
    import gc

    for rt in pkgs:
        rt.shutdown()
    gc.collect()


def sub(rt, name: str):
    """The submodule `name` of package `rt` (e.g. "serve", "_private.api")."""
    return importlib.import_module(f"{rt.__name__}.{name}")


def serve_of(rt):
    return sub(rt, "serve")


def is_port(rt) -> bool:
    return rt.__name__ == "ray_tpu_torch"


def twin(pkgs, scenario, *, sequential: bool = False, timeout: float = 240,
         serve_cleanup: bool = True):
    """scenario(ray_tpu) and scenario(ray_tpu_torch): on two threads at
    once, or one after the other where the scenario times itself. Serve is
    shut down after each side unless `serve_cleanup` is False."""
    results: list = [None, None]
    errors: list = [None, None]

    def run(i):
        try:
            results[i] = scenario(pkgs[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e
        finally:
            if serve_cleanup:
                serve_of(pkgs[i]).shutdown()

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
        if sequential:
            t.join(timeout=timeout)
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "scenario hung"
    for e in errors:
        if e is not None:
            raise e
    return results


def same(pkgs, scenario, want=None, **kw):
    a, b = twin(pkgs, scenario, **kw)
    assert a == b, (a, b)
    if want is not None:
        assert a == want, a
    return a


def wait_for(predicate, timeout: float = 30.0, interval: float = 0.2,
             desc: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            out = predicate()
        except Exception:  # noqa: BLE001 — controller mid-restart etc.
            out = None
        if out:
            return out
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}")


def post(url: str, payload, timeout: float = 60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def rpc(rt, msg: dict) -> dict:
    return sub(rt, "_private.api")._get_worker().rpc(msg)


def pid_of_actor(rt, actor_id: str) -> int:
    """The live worker pid hosting `actor_id`, from the runtime's own
    worker table (never a process-name glob, which could find the other
    runtime's workers)."""
    rows = rpc(rt, {"type": "list_workers"}).get("workers", [])
    return next(r["pid"] for r in rows
                if r.get("actor_id") == actor_id and not r.get("dead"))


def worker_pids(rt) -> list[int]:
    """Live task-worker pids of `rt`'s session (its own worker table)."""
    import os

    rows = rpc(rt, {"type": "list_workers"}).get("workers", [])
    return [r["pid"] for r in rows
            if not r.get("dead") and r.get("kind") == "worker"
            and r.get("pid") not in (None, os.getpid())]


def gcs_counter(rt, name: str, tag_match: dict | None = None) -> float:
    """A counter summed over the GCS's metrics snapshot (worker flushes
    reach it on the telemetry cadence)."""
    snap = rpc(rt, {"type": "metrics_snapshot"})["metrics"]
    rec = snap.get(name)
    if not rec:
        return 0.0
    total = 0.0
    for series in rec["series"].values():
        for tags, value in series:
            t = dict(tuple(kv) for kv in tags)
            if tag_match and any(t.get(k) != v for k, v in tag_match.items()):
                continue
            total += value
    return total


def kill_made(pkgs, made: dict) -> None:
    """Kill what scenarios recorded in `made` (package name → actor
    handles, and collective group names, whose rendezvous actor goes): a
    module-scoped session would otherwise keep every test's actors, each
    pinning a worker process, where the reference's per-test cluster
    drops them."""
    for rt in pkgs:
        for a in made.pop(rt.__name__, []):
            try:
                if isinstance(a, str):
                    a = rt.get_actor(f"__collective::{a}",
                                     namespace="_system")
                rt.kill(a)
            except Exception:  # noqa: BLE001 — already gone
                pass


def err_name(call) -> str | None:
    """The class name of what `call()` raises, or None."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the class name is the result
        return type(e).__name__
    return None


def pair(scenario, want=None):
    """scenario(ray_tpu) and scenario(ray_tpu_torch), one after the other on
    this thread, for code that needs no session; both must agree."""
    import ray_tpu
    import ray_tpu_torch

    a, b = scenario(ray_tpu), scenario(ray_tpu_torch)
    assert a == b, (a, b)
    if want is not None:
        assert a == want, a
    return a


def env_name(rt, flag: str) -> str:
    """The env var of config flag `flag` (e.g. "DATA_MAX_BLOCK_RETRIES") in
    `rt`'s namespace: ``RAY_TPU_*`` or the port's ``RAY_TPU_TORCH_*``."""
    return ("RAY_TPU_TORCH_" if is_port(rt) else "RAY_TPU_") + flag


def plain(x):
    """numpy scalars and arrays (nested in dicts, lists and tuples) as
    Python values, so results compare with ==."""
    import numpy as np

    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return x


def private_channel_dirs(monkeypatch, tmp_path) -> None:
    """Each package's shm channels in a directory of the calling test's own
    (readers attach by the path a channel carries), so a leak check sees
    only that test's segments, not those of tests running beside it."""
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        d = tmp_path / f"chan_{pkg}"
        d.mkdir()
        monkeypatch.setattr(importlib.import_module(
            f"{pkg}.experimental.channel.mutable_shm"), "_DIR", str(d))


def channel_files(rt) -> set:
    """The channel segments of package `rt` in its (patched) channel
    directory."""
    import glob
    import os

    shm = sub(rt, "experimental.channel.mutable_shm")
    prefix = sub(rt, "_private.constants").SHM_CHANNEL_PREFIX
    return set(glob.glob(os.path.join(shm._DIR, prefix + "*")))
