"""The port's runtime core against the JAX package's, on one host.

Twins of tests/test_core.py, test_async_actors.py, test_task_spec.py and
test_fixed_point_resources.py: each test runs the same scenario through
``ray_tpu`` and ``ray_tpu_torch`` (one module-scoped session per package,
both live in this process, the two scenarios on two threads) and asserts
the same result: values, exception class names, resource sets (TPU in the
JAX package is GPU in the port). Plus: a port worker loads no ``ray_tpu``
or ``jax`` module, the two runtimes own disjoint names, and each path the
port leaves out raises naming its ROADMAP.md item.

The scenarios define their remote functions inside themselves (pickled by
value) and reach the package only through their argument, so a port worker
never imports this file or the JAX package.
"""

from __future__ import annotations

from functools import partial

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_twins import same, twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _acc(rt, n):
    """The accelerator option of `rt`: num_tpus (JAX) / num_gpus (port)."""
    return {"num_gpus" if rt.__name__ == "ray_tpu_torch" else "num_tpus": n}


@pytest.fixture(scope="module")
def pkgs():
    import ray_tpu
    import ray_tpu_torch

    out = (ray_tpu, ray_tpu_torch)
    for rt in out:
        rt.shutdown()
        rt.init(num_cpus=4, num_workers=2, max_workers=6)
    yield out
    for rt in out:
        rt.shutdown()


_twin = partial(twin, serve_cleanup=False)
_same = partial(same, serve_cleanup=False)


def _kill_all(rt, *actors):
    for a in actors:
        rt.kill(a)


# --------------------------------------------------------------- test_core


def _scn_task_roundtrip(rt):
    @rt.remote
    def add(a, b):
        return a + b

    return rt.get(add.remote(1, 2))


def test_task_roundtrip(pkgs):
    _same(pkgs, _scn_task_roundtrip, 3)


def _scn_task_chain(rt):
    @rt.remote
    def inc(x):
        return x + 1

    ref = inc.remote(0)
    for _ in range(4):
        ref = inc.remote(ref)
    return rt.get(ref)


def test_task_chain_with_refs(pkgs):
    _same(pkgs, _scn_task_chain, 5)


def _scn_put_get_numpy(rt):
    arr = np.arange(1 << 18, dtype=np.float32)  # 1 MiB → shm path
    ref = rt.put(arr)

    @rt.remote
    def total(x):
        return float(x.sum())

    return rt.get(total.remote(ref))


def test_put_get_numpy_zero_copy(pkgs):
    _same(pkgs, _scn_put_get_numpy,
          float(np.arange(1 << 18, dtype=np.float32).sum()))


def _scn_large_result(rt):
    @rt.remote
    def big():
        return np.ones((1 << 20,), dtype=np.float32)

    out = rt.get(big.remote())
    return out.shape, str(out.dtype), float(out[123])


def test_large_result_via_shm(pkgs):
    _same(pkgs, _scn_large_result, ((1 << 20,), "float32", 1.0))


def _scn_multiple_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    return rt.get([a, b, c])


def test_multiple_returns(pkgs):
    _same(pkgs, _scn_multiple_returns, [1, 2, 3])


def _scn_task_error(rt):
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    try:
        rt.get(boom.remote())
    except rt.exceptions.RayTaskError as e:
        return type(e).__name__, "kaboom" in str(e), type(e.cause).__name__
    return None


def test_task_error_propagates(pkgs):
    _same(pkgs, _scn_task_error, ("RayTaskError", True, "ValueError"))


def _scn_parallel(rt):
    @rt.remote
    def ident(i):
        return i

    return rt.get([ident.remote(i) for i in range(20)])


def test_parallel_tasks(pkgs):
    _same(pkgs, _scn_parallel, list(range(20)))


def _scn_wait(rt):
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=4)
    out = (ready == [f], not_ready == [s])
    rt.cancel(s, force=True)
    return out


def test_wait(pkgs):
    _same(pkgs, _scn_wait, (True, True))


def _scn_actor_basic(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.v = start

        def inc(self, by=1):
            self.v += by
            return self.v

        def value(self):
            return self.v

    c = Counter.remote(10)
    out = (rt.get([c.inc.remote() for _ in range(5)]),
           rt.get(c.value.remote()))
    _kill_all(rt, c)
    return out


def test_actor_basic(pkgs):
    _same(pkgs, _scn_actor_basic, ([11, 12, 13, 14, 15], 15))


def _scn_actor_handle_to_task(rt):
    @rt.remote
    class Holder:
        def __init__(self):
            self.v = 7

        def value(self):
            return self.v

    @rt.remote
    def read(h):
        return rt.get(h.value.remote())

    h = Holder.remote()
    out = rt.get(read.remote(h))
    _kill_all(rt, h)
    return out


def test_actor_handle_passed_to_task(pkgs):
    _same(pkgs, _scn_actor_handle_to_task, 7)


def _scn_named_actor(rt):
    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    s = Svc.options(name="svc").remote()
    out = rt.get(rt.get_actor("svc").ping.remote())
    _kill_all(rt, s)
    return out


def test_named_actor(pkgs):
    _same(pkgs, _scn_named_actor, "pong")


def _scn_actor_error(rt):
    @rt.remote
    class Bad:
        def fail(self):
            raise RuntimeError("actor-err")

        def ok(self):
            return 1

    b = Bad.remote()
    try:
        rt.get(b.fail.remote())
        err = None
    except rt.exceptions.RayTaskError as e:
        err = type(e).__name__
    out = (err, rt.get(b.ok.remote()))  # the actor survives a method error
    _kill_all(rt, b)
    return out


def test_actor_error_propagates(pkgs):
    _same(pkgs, _scn_actor_error, ("RayTaskError", 1))


def _scn_kill_actor(rt):
    @rt.remote
    class Victim:
        def ping(self):
            return "pong"

    v = Victim.remote()
    first = rt.get(v.ping.remote())
    rt.kill(v)
    time.sleep(0.5)
    try:
        for _ in range(20):
            rt.get(v.ping.remote(), timeout=5)
            time.sleep(0.1)
        return first, None
    except rt.exceptions.ActorDiedError as e:
        return first, type(e).__name__


def test_kill_actor(pkgs):
    _same(pkgs, _scn_kill_actor, ("pong", "ActorDiedError"))


def _scn_nested(rt):
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    return rt.get(outer.remote(5))


def test_nested_tasks(pkgs):
    _same(pkgs, _scn_nested, 11)


_LOCAL_MODE = """
import {pkg} as rt
rt.init(local_mode=True)

@rt.remote
def f(x):
    return x + 1

@rt.remote
class A:
    def g(self):
        return "g"

print(rt.get(f.remote(1)), rt.get(A.remote().g.remote()))
rt.shutdown()
"""


def test_local_mode():
    """init(local_mode=True) in a process of its own for each package (the
    module's sessions hold each package's one global worker)."""
    env = {**os.environ, "PYTHONPATH": REPO}
    outs = [subprocess.run([sys.executable, "-c",
                            _LOCAL_MODE.format(pkg=pkg)], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=60)
            for pkg in ("ray_tpu", "ray_tpu_torch")]
    for r in outs:
        assert r.returncode == 0, r.stderr
    assert outs[0].stdout == outs[1].stdout == "2 g\n"


def test_cluster_resources(pkgs):
    _same(pkgs, lambda rt: rt.cluster_resources()["CPU"], 4.0)


def _scn_duplicate_named(rt):
    @rt.remote
    class Svc2:
        def ping(self):
            return "pong"

    first = Svc2.options(name="dup").remote()
    try:
        Svc2.options(name="dup").remote()
        err = None
    except ValueError as e:
        err = type(e).__name__
    _kill_all(rt, first)
    return err


def test_duplicate_named_actor_rejected(pkgs):
    _same(pkgs, _scn_duplicate_named, "ValueError")


def _scn_options_keep_resources(rt):
    @rt.remote(resources={"widget": 1})
    def needs_widget():
        return "ran"

    # options() that doesn't mention resources must keep the widget
    # requirement; no widget exists, so the task stays pending
    ref = needs_widget.options(max_retries=1).remote()
    _, not_ready = rt.wait([ref], num_returns=1, timeout=2)
    out = not_ready == [ref]
    rt.cancel(ref)
    return out


def test_options_preserve_decorator_resources(pkgs):
    _same(pkgs, _scn_options_keep_resources, True)


def _scn_get_total_deadline(rt):
    @rt.remote
    def never():
        time.sleep(600)

    refs = [never.remote() for _ in range(3)]
    t0 = time.monotonic()
    try:
        rt.get(refs, timeout=2)
        err = None
    except rt.exceptions.GetTimeoutError as e:
        err = type(e).__name__
    fast = time.monotonic() - t0 < 5  # total deadline, not per-ref
    for r in refs:
        rt.cancel(r, force=True)
    return err, fast


def test_get_total_deadline(pkgs):
    _same(pkgs, _scn_get_total_deadline, ("GetTimeoutError", True))


def _scn_behind_infeasible(rt):
    @rt.remote(**_acc(rt, 1))
    def needs_accelerator():
        return "acc"

    @rt.remote
    def cpu_task():
        return "ok"

    # no accelerator in this session: these queue forever
    refs = [needs_accelerator.remote() for _ in range(80)]
    out = rt.get(cpu_task.remote(), timeout=60)
    for r in refs:
        rt.cancel(r)
    return out


def test_dispatchable_task_behind_infeasible_queue(pkgs):
    _same(pkgs, _scn_behind_infeasible, "ok")


def _scn_cancel_queued(rt):
    @rt.remote(num_cpus=4)
    def hog():
        time.sleep(30)

    @rt.remote(num_cpus=4)
    def queued():
        return "ran"

    h = hog.remote()
    time.sleep(0.5)
    ref = queued.remote()  # can't start: hog holds all CPUs
    cancelled = rt.cancel(ref)
    try:
        rt.get(ref, timeout=30)
        err = None
    except rt.exceptions.TaskCancelledError as e:
        err = type(e).__name__
    rt.cancel(h, force=True)
    return cancelled, err


def test_cancel_queued_task(pkgs):
    _same(pkgs, _scn_cancel_queued, (True, "TaskCancelledError"))


def _scn_force_cancel(rt):
    @rt.remote(max_retries=3)
    def spin():
        time.sleep(60)
        return "done"

    ref = spin.remote()
    time.sleep(1.0)  # running by now
    cancelled = rt.cancel(ref, force=True)
    try:
        rt.get(ref, timeout=30)
        err = None
    except rt.exceptions.TaskCancelledError as e:
        err = type(e).__name__
    return cancelled, err


def test_force_cancel_running_task(pkgs):
    _same(pkgs, _scn_force_cancel, (True, "TaskCancelledError"))


def _scn_cancel_actor_task(rt):
    @rt.remote
    class Slow:
        def block(self):
            time.sleep(20)
            return "blocked"

        def quick(self):
            return "quick"

    a = Slow.remote()
    rt.get(a.quick.remote(), timeout=60)  # actor alive
    a.block.remote()
    time.sleep(0.3)
    queued = a.quick.remote()  # sits in the actor queue behind block()
    cancelled = rt.cancel(queued)
    try:
        rt.get(queued, timeout=30)
        err = None
    except rt.exceptions.TaskCancelledError as e:
        err = type(e).__name__
    _kill_all(rt, a)
    return cancelled, err


def test_cancel_queued_actor_task(pkgs):
    _same(pkgs, _scn_cancel_actor_task, (True, "TaskCancelledError"))


# ------------------------------------------------------- test_async_actors


def _scn_async_interleave(rt):
    @rt.remote(max_concurrency=8)
    class AsyncActor:
        async def slow(self, t):
            import asyncio

            await asyncio.sleep(t)
            return t

        async def fast(self):
            return "fast"

    a = AsyncActor.remote()
    rt.get(a.fast.remote(), timeout=30)  # the actor is up
    t0 = time.monotonic()
    refs = [a.slow.remote(0.5) for _ in range(6)]
    out = (rt.get(a.fast.remote(), timeout=30),
           rt.get(refs, timeout=30),
           # 6 x 0.5 s sleeps overlapped on one event loop: far below 3 s
           time.monotonic() - t0 < 2.5)
    _kill_all(rt, a)
    return out


def test_async_actor_methods_interleave(pkgs):
    _same(pkgs, _scn_async_interleave, ("fast", [0.5] * 6, True))


def _scn_async_state(rt):
    @rt.remote(max_concurrency=4)
    class Counter:
        def __init__(self):
            self.n = 0

        async def incr(self):
            self.n += 1
            return self.n

        async def total(self):
            return self.n

    c = Counter.remote()
    rt.get([c.incr.remote() for _ in range(10)], timeout=30)
    out = rt.get(c.total.remote(), timeout=30)
    _kill_all(rt, c)
    return out


def test_async_actor_state_is_shared(pkgs):
    _same(pkgs, _scn_async_state, 10)


def _scn_concurrency_groups(rt):
    @rt.remote(concurrency_groups={"io": 2, "compute": 1})
    class Grouped:
        @rt.method(concurrency_group="io")
        def io_task(self, t):
            time.sleep(t)
            return "io"

        @rt.method(concurrency_group="compute")
        def compute_task(self):
            return "compute"

        def default_task(self):
            return "default"

    g = Grouped.remote()
    rt.get(g.default_task.remote(), timeout=30)  # the actor is up
    t0 = time.monotonic()
    io_refs = [g.io_task.remote(1.0) for _ in range(2)]  # 2-wide io pool
    # compute + default groups are NOT blocked behind the io sleeps
    out = [rt.get(g.compute_task.remote(), timeout=30),
           rt.get(g.default_task.remote(), timeout=30),
           time.monotonic() - t0 < 0.9]
    out += [rt.get(io_refs, timeout=30), time.monotonic() - t0 < 1.9]
    _kill_all(rt, g)
    return out


def test_concurrency_groups_isolate_pools(pkgs):
    _same(pkgs, _scn_concurrency_groups,
          ["compute", "default", True, ["io", "io"], True])


def _scn_async_error(rt):
    @rt.remote(max_concurrency=2)
    class Boom:
        async def fail(self):
            raise ValueError("async-kaboom")

    b = Boom.remote()
    try:
        rt.get(b.fail.remote(), timeout=30)
        out = None
    except Exception as e:  # noqa: BLE001 — the class is compared
        out = type(e).__name__, "async-kaboom" in str(e)
    _kill_all(rt, b)
    return out


def test_async_actor_error_propagates(pkgs):
    _same(pkgs, _scn_async_error, ("RayTaskError", True))


# ------------------------------------------------------------ test_task_spec


def _spec_modules():
    from ray_tpu._private import task_spec as jts
    from ray_tpu_torch._private import task_spec as tts

    return jts, tts


def _task(**over):
    spec = {"kind": "task", "task_id": "t1", "deps": [], "num_returns": 1,
            "resources": {"CPU": 1.0}, "max_retries": 0, "name": "f",
            "strategy": None}
    spec.update(over)
    return spec


def _spec_error(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    return None


def test_valid_task_roundtrip():
    for ts in _spec_modules():
        view = ts.TaskSpec.from_wire(_task())
        assert view.task_id == "t1" and view.resources == {"CPU": 1.0}
        assert view.language == "py"


@pytest.mark.parametrize("bad,match", [
    (dict(task_id=""), "missing task_id"),
    (dict(resources={"CPU": -1}), "negative"),
    (dict(resources={"": 1}), "non-empty"),
    (dict(resources={"CPU": "lots"}), "numeric"),
    (dict(resources="CPU"), "must be a dict"),
    (dict(num_returns=-2), "num_returns"),
    (dict(num_returns=1.5), "num_returns"),
    (dict(max_retries=-5), "max_retries"),
    (dict(strategy={"pg_id": "p"}), "kind"),
    (dict(strategy={"kind": "teleport"}), "unknown strategy"),
    (dict(strategy={"kind": "pg"}), "needs pg_id"),
    (dict(strategy={"kind": "pg", "pg_id": "p", "bundle": -3}), "bundle"),
    (dict(strategy={"kind": "node_affinity"}), "needs node_id"),
    (dict(name="x" * 600), "under"),
    (dict(deps="notalist"), "deps"),
])
def test_invalid_tasks_rejected(bad, match):
    j, t = (_spec_error(lambda ts=ts: ts.validate_task(_task(**bad)))
            for ts in _spec_modules())
    assert j == t
    assert j[0] == "SpecError" and match in j[1]


def test_fractional_accelerator_above_one_rejected():
    """The accelerator resource is TPU in the JAX package, GPU in the port:
    each refuses 1.5 of its own."""
    jts, tts = _spec_modules()
    j = _spec_error(lambda: jts.validate_task(_task(resources={"TPU": 1.5})))
    t = _spec_error(lambda: tts.validate_task(_task(resources={"GPU": 1.5})))
    assert j[0] == t[0] == "SpecError"
    assert j[1].replace("TPU", "GPU") == t[1]


def test_actor_validation():
    good = {"kind": "actor_create", "task_id": "t", "actor_id": "a1",
            "resources": {"CPU": 1.0}, "max_restarts": 0,
            "max_concurrency": 1, "strategy": None}
    results = []
    for ts in _spec_modules():
        results.append((
            ts.ActorSpec.from_wire(good).actor_id,
            _spec_error(lambda: ts.validate_actor({**good,
                                                   "max_concurrency": 0})),
            _spec_error(lambda: ts.validate_actor({**good,
                                                   "max_restarts": -2}))))
    assert results[0] == results[1]
    assert "max_concurrency" in results[0][1][1]
    assert "max_restarts" in results[0][2][1]


def test_pg_validation():
    good = {"pg_id": "p1", "bundles": [{"CPU": 1.0}], "strategy": "PACK"}
    results = []
    for ts in _spec_modules():
        results.append((
            ts.validate_pg(dict(good)),
            _spec_error(lambda: ts.validate_pg({**good, "bundles": []})),
            _spec_error(lambda: ts.validate_pg({**good, "bundles": [{}]})),
            _spec_error(lambda: ts.validate_pg({**good,
                                                "strategy": "SCATTER"}))))
    assert results[0] == results[1]
    assert results[0][0] == good


def _scn_bad_submissions(rt):
    @rt.remote
    def f():
        return 1

    out = []
    for kw in (dict(resources={"custom": -3}), dict(num_returns=-1)):
        try:
            f.options(**kw).remote()
            out.append(None)
        except Exception as e:  # noqa: BLE001 — SpecError, compared
            out.append((type(e).__name__, str(e)))
    # a good submission still works after the rejected ones
    out.append(rt.get(f.remote(), timeout=60))
    return out


def test_bad_submissions_fail_at_caller(pkgs):
    got = _same(pkgs, _scn_bad_submissions)
    assert got[0][0] == got[1][0] == "SpecError" and got[2] == 1
    assert "negative" in got[0][1] and "num_returns" in got[1][1]


# ------------------------------------------------- test_fixed_point_resources


def test_fp_roundtrip_and_quantization():
    from ray_tpu._private import fixed_point as jfp
    from ray_tpu_torch._private import fixed_point as tfp

    for fp in (jfp, tfp):
        assert fp.to_fp(1.0) == 10_000
        assert fp.to_fp(0.1) == 1_000
        assert fp.from_fp(fp.to_fp(0.3)) == 0.3
        assert fp.fp_dict({"CPU": 0.1, "GPU": 4}) == {"CPU": 1_000,
                                                      "GPU": 40_000}
        assert fp.float_dict({"CPU": 1_000}) == {"CPU": 0.1}


def test_fractional_acquire_release_is_exact():
    """10 x 0.1 CPU fill 1 CPU exactly, an 11th does not fit, and releasing
    them restores the starting availability exactly, in both GCSs."""
    from ray_tpu._private import fixed_point as jfp, gcs as jgcs
    from ray_tpu._private import pg_policy as jpg
    from ray_tpu_torch._private import fixed_point as tfp, gcs as tgcs
    from ray_tpu_torch._private import pg_policy as tpg

    for fp, gcs, pg in ((jfp, jgcs, jpg), (tfp, tgcs, tpg)):
        node = gcs._VNode("n", {"CPU": 1.0})
        res = fp.fp_dict({"CPU": 0.1})
        for _ in range(10):
            assert pg._fits(node.available, res)
            for k, v in res.items():
                node.available[k] = node.available.get(k, 0) - v
        assert node.available["CPU"] == 0
        assert not pg._fits(node.available, res)
        for _ in range(10):
            for k, v in res.items():
                node.available[k] = node.available.get(k, 0) + v
        assert node.available == node.total


def _scn_fractional_actors(rt):
    @rt.remote(num_cpus=0.1)
    class Slot:
        def ping(self):
            return 1

    actors = [Slot.remote() for _ in range(4)]
    out = [rt.get([a.ping.remote() for a in actors], timeout=120)]
    # 4 x 0.1 of the session's 4 CPUs held: no float residue
    out.append(rt.available_resources().get("CPU", 0.0) <= 3.6 + 1e-12)
    _kill_all(rt, *actors)
    deadline = time.time() + 30
    while time.time() < deadline:
        if rt.available_resources().get("CPU", 0.0) == 4.0:
            break
        time.sleep(0.1)
    out.append(rt.available_resources().get("CPU", 0.0))
    return out


def test_fractional_actors_release_exactly(pkgs):
    """A small twin of the reference's slow end-to-end test: fractional
    actors come up and, once killed, give back exactly what they took."""
    _same(pkgs, _scn_fractional_actors, [[1] * 4, True, 4.0])


# ------------------------------------------------------------ the port's own


def _scn_worker_modules(rt):
    @rt.remote
    def mods():
        import sys

        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("ray_tpu", "jax", "torch"))

    @rt.remote
    class A:
        def mods(self):
            import sys

            return sorted(m for m in sys.modules
                          if m.split(".")[0] in ("ray_tpu", "jax", "torch"))

    a = A.remote()
    out = rt.get(mods.remote()), rt.get(a.mods.remote())
    _kill_all(rt, a)
    return out


def test_port_workers_load_no_jax_package_and_no_torch(pkgs):
    """A port worker (task and actor) has no ray_tpu or jax module loaded,
    and no torch either until its code imports it: it boots as cheaply as
    the JAX package's (whose workers load no jax)."""
    jax_side, port_side = _twin(pkgs, _scn_worker_modules)
    assert port_side == ([], [])
    assert not any(m.startswith("jax") for mods in jax_side for m in mods)


def test_the_two_runtimes_own_disjoint_names(pkgs):
    """Sessions, shm objects, env and config names are each package's own:
    a live port session is under <TMPDIR>/ray_tpu_torch with rtpt_
    segments, the JAX one under /tmp/ray_tpu with rtpu_ ones, and no env
    var of one is read by the other."""
    import glob
    import tempfile

    from ray_tpu._private import api as japi
    from ray_tpu_torch._private import api as tapi
    from ray_tpu_torch._private import constants, ray_config

    jdir, tdir = japi._node.session_dir, tapi._node.session_dir
    root = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    assert jdir.startswith("/tmp/ray_tpu/")
    assert tdir.startswith(root + os.sep) and constants.temp_root() == root
    assert constants.SHM_SESSION_PREFIX == "rtpt_"
    assert constants.SHM_CHANNEL_PREFIX.startswith("rtpt_")
    sid = tapi._node.session_id
    ours = glob.glob(f"/dev/shm/rtpt_{sid}*")
    assert ours and not glob.glob(f"/dev/shm/rtpu_{sid}*")
    assert not glob.glob(f"/dev/shm/rtpt_{japi._node.session_id}*")
    spawn = ray_config.RayConfig.spawn_env()
    assert all(k.startswith("RAY_TPU_TORCH_") for k in spawn)
    # Serve: routing segments, the body-escrow key, the Serve config flags
    # and the controller's and proxy's names in the port's own GCS
    assert constants.SHM_ROUTING_PREFIX == "rtpt_routes_"
    assert constants.SHM_ROUTING_GLOB.endswith("/rtpt_routes_*")
    assert constants.SERVE_BODY_REF_KEY == "__rtpt_body_ref__"
    os.environ["RAY_TPU_TORCH_SERVE_NUM_PROXIES"] = "3"
    os.environ["RAY_TPU_SERVE_NUM_PROXIES"] = "5"
    try:
        ray_config.RayConfig.reset()
        assert ray_config.RayConfig.instance().serve_num_proxies == 3
    finally:
        del os.environ["RAY_TPU_TORCH_SERVE_NUM_PROXIES"]
        del os.environ["RAY_TPU_SERVE_NUM_PROXIES"]
        ray_config.RayConfig.reset()
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu_torch import serve

    serve.start(http_port=0)
    try:
        assert ray_tpu_torch.get_actor(constants.SERVE_CONTROLLER_NAME,
                                       namespace="_system")
        assert serve.http_address()[1] > 0
        with pytest.raises(ValueError):
            ray_tpu.get_actor(constants.SERVE_CONTROLLER_NAME,
                              namespace="_system")
    finally:
        serve.shutdown()


def test_temp_root_follows_tmpdir_and_reaches_workers(pkgs, monkeypatch,
                                                       tmp_path):
    """Sessions, spill dirs and runtime envs live under the caller's TMPDIR,
    and a worker reads its node's root from the spawn env, so its spill dir
    is the driver's even when a runtime env sets another TMPDIR."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch._private import api as tapi
    from ray_tpu_torch._private import constants
    from ray_tpu_torch._private.object_store import spill_dir_for

    sid = tapi._node.session_id

    @rt.remote(runtime_env={"env_vars": {"TMPDIR": str(tmp_path)}})
    def where(s):
        import os

        from ray_tpu_torch._private.object_store import spill_dir_for

        return os.environ.get("TMPDIR"), spill_dir_for(s)

    seen_tmp, seen_spill = rt.get(where.remote(sid), timeout=60)
    assert seen_tmp == str(tmp_path)
    assert seen_spill == spill_dir_for(sid)
    monkeypatch.delenv(constants.TEMP_ROOT_ENV, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert constants.temp_root() == str(tmp_path / "ray_tpu_torch")
    assert spill_dir_for("s1") == str(tmp_path / "ray_tpu_torch" / "spill_s1")


def _refused(call):
    try:
        call()
    except NotImplementedError as e:
        return str(e)
    return None


def test_left_out_paths_raise_naming_their_roadmap_item(pkgs):
    """Each stack the runtime core leaves out raises NotImplementedError
    naming its ROADMAP.md item, at the point a user reaches it."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import object_transfer, worker

    @rt.remote
    def f():
        return 1

    w = worker._global_worker or rt._private.api._get_worker()
    # C++ workers (item 22) and DreamerV3 (item 14) are ported: both
    # names resolve to the port's classes, and nothing of RLlib refuses
    import importlib

    rllib = importlib.import_module("ray_tpu_torch.rllib")
    from ray_tpu_torch.rllib.algorithms import dreamerv3

    assert rllib.DreamerV3 is dreamerv3.DreamerV3
    assert rllib.DreamerV3Config is dreamerv3.DreamerV3Config
    assert rllib.DreamerV3Config.algo_class is rllib.DreamerV3
    assert _refused(lambda: rllib.DreamerV3Config().algo_class) is None
    assert rllib.NOT_PORTED == ()
    assert callable(rt.cpp_function("add").remote)
    # multi-host (item 17) is ported: a copy on an unreachable host is a
    # failed pull (False), not a refusal, and a native server on a
    # file-backed store starts and serves
    assert w._pull_remote("ff" * 10,
                          {"locations": [["host-9", "127.0.0.1:1"]]}) is False
    assert not w._pull_remote("ff" * 10, {"locations": [["host-0", "a"]]})
    from ray_tpu_torch._private.native_object_server import fetch_native
    from ray_tpu_torch._private.object_store import ShmObjectStore

    os.environ["RAY_TPU_TORCH_OBJECT_SERVER_BACKEND"] = "native"
    src, dst = ShmObjectStore("refusal_src"), ShmObjectStore("refusal_dst")
    try:
        srv = object_transfer.make_object_server(src)
        try:
            src.put_parts("ab12", [b"xyz" * 1000], 3000)
            host, port = srv.address[len("native:"):].rsplit(":", 1)
            assert fetch_native(dst, "ab12", host, int(port)) == "shm"
            assert bytes(dst.get("ab12").buf) == b"xyz" * 1000
        finally:
            srv.stop()
    finally:
        del os.environ["RAY_TPU_TORCH_OBJECT_SERVER_BACKEND"]
        src.cleanup_session()
        dst.cleanup_session()


def test_method_tensor_transport_device_stamps_the_attribute(pkgs):
    """`method(tensor_transport="device")` (ROADMAP.md Queue 1 item 13,
    ported) stamps the attribute the worker's result path reads; any other
    transport, the JAX package's alias "tpu" too, is a ValueError naming
    "device"."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.constants import TENSOR_TRANSPORT_ATTR

    def make(self):
        return 1

    assert rt.method(tensor_transport="device")(make) is make
    assert getattr(make, TENSOR_TRANSPORT_ATTR) == "device"
    for bad in ("tpu", "nccl"):
        with pytest.raises(ValueError, match="'device'"):
            rt.method(tensor_transport=bad)(lambda self: 1)


def test_compiled_dag_exec_loop_is_refused_in_the_actor(pkgs):
    """The compiled-DAG channel loop (an actor task under the reserved
    method name, ROADMAP.md Queue 1 item 16) is no longer refused: it runs
    in the actor until teardown, and the actor's later calls still work."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode

    @rt.remote
    class Stage:
        def work(self, x):
            return x + 1

        def ok(self):
            return "ok"

    s = Stage.remote()
    try:
        with InputNode() as inp:
            dag = s.work.bind(inp)
        compiled = dag.experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        assert [compiled.execute(i).result(timeout=60)
                for i in range(3)] == [1, 2, 3]
        compiled.teardown()
        assert rt.get(s.ok.remote(), timeout=60) == "ok"
    finally:
        rt.kill(s)


def test_follower_host_registration_is_refused(pkgs):
    """The GCS accepts a follower host's agent (ROADMAP.md Queue 1 item 17,
    ported): ``register_host`` adds its node and its host-table entry, and
    the agent connection's close removes the host and fails the node."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.protocol import connect_address

    node = rt._private.api._node
    gcs = node.gcs
    conn = connect_address(node.address)
    try:
        conn.send({"type": "register_host", "rid": 1, "host_id": "host-reg",
                   "node_id": "host-reg", "resources": {"CPU": 1.0},
                   "object_addr": "127.0.0.1:1"})
        reply = conn.recv()
        assert reply["ok"] is True and reply["session_id"] == node.session_id
        with gcs.lock:
            assert gcs.hosts["host-reg"]["object_addr"] == "127.0.0.1:1"
            assert gcs.node_hosts["host-reg"] == "host-reg"
        w = rt._private.api._get_worker()
        row = next(n for n in w.rpc({"type": "list_nodes"})["nodes"]
                   if n["node_id"] == "host-reg")
        assert row["alive"] and row["total"] == {"CPU": 1.0}
    finally:
        conn.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        with gcs.lock:
            gone = "host-reg" not in gcs.hosts
        if gone and not gcs.nodes["host-reg"].alive:
            break
        time.sleep(0.05)
    assert gone and not gcs.nodes["host-reg"].alive
