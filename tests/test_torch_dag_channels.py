"""Twins of tests/test_dag_channels.py: the compiled-DAG channel plane in
each package.

Each scenario runs through ``ray_tpu`` and ``ray_tpu_torch`` (one
module-scoped session each; the reference starts a cluster per test), and
the two sides agree. A scenario defines its actor classes inside itself
(pickled by value: a port worker never imports this file) and kills what it
made, so the shared session keeps no worker pinned. Each test's channels
go to a directory of its own, and its leak check globs only that
directory. The latency twin times each package alone and holds each to the
reference's own bound (the compiled step at least 2x faster than the
`.remote()` chain).
"""

from __future__ import annotations

import asyncio
import statistics
import threading
import time
from functools import partial

import numpy as np
import pytest

from torch_twins import (channel_files, env_name, private_channel_dirs,
                         shutdown_runtimes, start_sessions, sub, twin)

pytestmark = pytest.mark.dag

N_STAGES = 4
_twin = partial(twin, serve_cleanup=False)


@pytest.fixture(scope="module")
def pkgs():
    out = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield out
    shutdown_runtimes(out)


@pytest.fixture
def dag_cluster(pkgs, monkeypatch, tmp_path):
    """The shared sessions, with this test's own channel directory; no
    channel may be left in it."""
    private_channel_dirs(monkeypatch, tmp_path)
    yield pkgs
    for rt in pkgs:
        assert not channel_files(rt), (rt.__name__, channel_files(rt))


def _same(pkgs, scenario, want=None, **kw):
    a, b = _twin(pkgs, scenario, **kw)
    assert a == b, (a, b)
    if want is not None:
        assert a == want, a
    return a


def _stage(rt):
    @rt.remote
    class Stage:
        def __init__(self, bias):
            self.bias = bias
            self.calls = 0

        def work(self, x):
            self.calls += 1
            return x + self.bias

        def boom(self, x):
            if x == 13:
                raise RuntimeError("unlucky step")
            return x * 2

        def big(self, x):
            import numpy as np

            return np.zeros(int(x), np.float64)

        def ncalls(self):
            return self.calls

    return Stage


def _pipeline(rt, actors):
    InputNode = sub(rt, "dag").InputNode
    with InputNode() as inp:
        node = inp
        for a in actors:
            node = a.work.bind(node)
    return node


def _kill(rt, actors):
    for a in actors:
        try:
            rt.kill(a)
        except Exception:  # noqa: BLE001 — already dead
            pass


def _with_actors(rt, make, body):
    """body(actors) with actors = make(); the actors die after it."""
    actors = make()
    try:
        return body(actors)
    finally:
        _kill(rt, actors)


def _raises(call):
    """(class name, message) of what `call()` raises, or None."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the error is the result
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------- test_dag_channels


def _scn_engages(rt):
    Stage = _stage(rt)

    def body(actors):
        compiled = _pipeline(rt, actors).experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        viz = "plane: channels" in compiled.visualize()
        outs = [compiled.execute(i).result(timeout=60) for i in range(25)]
        got = rt.get(compiled.execute(5), timeout=60)  # get() resolves it
        compiled.teardown()
        # loops are joined: the actors serve normal calls again, and each
        # ran exactly one invocation per execute() (no speculative steps)
        return (viz, outs, got,
                rt.get(actors[0].ncalls.remote(), timeout=30))

    return _with_actors(
        rt, lambda: [Stage.remote(10 ** i) for i in range(N_STAGES)], body)


def test_channel_plane_engages_and_matches(dag_cluster):
    _same(dag_cluster, _scn_engages,
          (True, [i + 1111 for i in range(25)], 1116, 26))


def _scn_beats_remote_chain(rt):
    Stage = _stage(rt)

    def body(actors):
        def chain_step(x):
            ref = x
            for a in actors:
                ref = a.work.remote(ref)
            return rt.get(ref, timeout=60)

        n = 60
        for i in range(10):
            chain_step(i)
        remote_steps = []
        for i in range(n):
            t0 = time.perf_counter()
            assert chain_step(i) == i + N_STAGES
            remote_steps.append(time.perf_counter() - t0)
        compiled = _pipeline(rt, actors).experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        for i in range(10):
            compiled.execute(i).result(timeout=60)
        chan_steps = []
        for i in range(n):
            t0 = time.perf_counter()
            assert compiled.execute(i).result(timeout=60) == i + N_STAGES
            chan_steps.append(time.perf_counter() - t0)
        compiled.teardown()
        remote_s = statistics.median(remote_steps)
        chan_s = statistics.median(chan_steps)
        assert chan_s * 2 <= remote_s, (
            f"{rt.__name__}: median channel step {chan_s*1e6:.0f}us vs "
            f"remote chain {remote_s*1e6:.0f}us: <2x")
        return True

    return _with_actors(rt, lambda: [Stage.remote(1)
                                     for _ in range(N_STAGES)], body)


def test_channel_plane_beats_remote_chain(dag_cluster, monkeypatch, request):
    """Steady-state compiled step >= 2x faster than the equivalent
    .remote() chain, by MEDIAN per-step latency, each package timed alone
    with its instrumentation pinned off."""
    for rt in dag_cluster:
        monkeypatch.setenv(env_name(rt, "DAG_METRICS"), "0")
        monkeypatch.setenv(env_name(rt, "DAG_SPAN_SAMPLE_EVERY"), "0")
        cfg = sub(rt, "_private.ray_config").RayConfig
        cfg.reset()
        # drop the singleton again at teardown (before monkeypatch's env
        # undo) so later tests re-read the restored env
        request.addfinalizer(cfg.reset)
    _same(dag_cluster, _scn_beats_remote_chain, True, sequential=True)


def _scn_function_node_falls_back(rt):
    InputNode = sub(rt, "dag").InputNode

    @rt.remote
    def add(a, b):
        return a + b

    a = _stage(rt).remote(100)

    def body(_):
        with InputNode() as inp:
            dag = a.work.bind(add.bind(inp, 1))
        compiled = dag.experimental_compile()
        got = (compiled.uses_channels,
               "submit path" in compiled.fallback_reason,
               "plane: submit" in compiled.visualize(),
               rt.get(compiled.execute(5)))
        compiled.teardown()
        return got

    return _with_actors(rt, lambda: [a], body)


def test_function_node_falls_back(dag_cluster):
    _same(dag_cluster, _scn_function_node_falls_back, (False, True, True, 106))


def _scn_multi_output(rt):
    dag_mod = sub(rt, "dag")
    Stage = _stage(rt)

    def body(actors):
        a, b = actors
        with dag_mod.InputNode() as inp:
            mid = a.work.bind(inp)
            dag = dag_mod.MultiOutputNode([mid, b.work.bind(mid)])
        compiled = dag.experimental_compile(max_inflight_executions=4)
        assert compiled.uses_channels, compiled.fallback_reason
        futs = [compiled.execute_async(i) for i in range(8)]
        outs = [f.result(timeout=60) for f in futs]
        done = futs[0].done()

        async def run():
            return await compiled.execute_async(41)

        awaited = asyncio.run(run())
        compiled.teardown()
        return outs, done, awaited

    return _with_actors(rt, lambda: [Stage.remote(1), Stage.remote(2)], body)


def test_multi_output_pipelining_and_await(dag_cluster):
    _same(dag_cluster, _scn_multi_output,
          ([[i + 1, i + 3] for i in range(8)], True, [42, 44]))


def _scn_await_without_legacy_loop(rt):
    InputNode = sub(rt, "dag").InputNode
    a = _stage(rt).remote(1)

    @rt.remote
    def ident(x):
        return x

    def body(_):
        with InputNode() as inp:
            dag = a.work.bind(ident.bind(inp))
        compiled = dag.experimental_compile()
        assert not compiled.uses_channels  # fallback plane → DAGFuture

        async def run():
            return await compiled.execute_async(7)

        out = asyncio.run(run())
        compiled.teardown()
        return out

    return _with_actors(rt, lambda: [a], body)


def test_dagfuture_await_without_legacy_event_loop(dag_cluster):
    """DAGFuture.__await__ uses get_running_loop (3.12-safe)."""
    _same(dag_cluster, _scn_await_without_legacy_loop, 8)


def _scn_error_propagates(rt):
    InputNode = sub(rt, "dag").InputNode
    Stage = _stage(rt)

    def body(actors):
        a, b = actors
        with InputNode() as inp:
            dag = b.work.bind(a.boom.bind(inp))
        compiled = dag.experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        first = compiled.execute(3).result(timeout=60)
        name, msg = _raises(lambda: compiled.execute(13).result(timeout=60))
        # the faulting node is named (method + actor); the plane survives a
        # step error: next steps flow normally
        after = compiled.execute(4).result(timeout=60)
        compiled.teardown()
        return first, name, "boom" in msg and "unlucky step" in msg, after

    return _with_actors(rt, lambda: [Stage.remote(0), Stage.remote(5)], body)


def test_error_propagates_and_pipeline_recovers(dag_cluster):
    _same(dag_cluster, _scn_error_propagates, (11, "RayTaskError", True, 13))


def _scn_payload_exceeds_buffer(rt):
    InputNode = sub(rt, "dag").InputNode
    Stage = _stage(rt)

    def body(actors):
        a, b = actors
        with InputNode() as inp:
            dag = b.work.bind(a.big.bind(inp))
        compiled = dag.experimental_compile(channel_buffer_bytes=8192)
        assert compiled.uses_channels, compiled.fallback_reason
        # an intermediate over buffer_bytes: a clear in-band error...
        name, msg = _raises(
            lambda: compiled.execute(100_000).result(timeout=60))
        # ...and the channel stays usable
        shape = compiled.execute(16).result(timeout=60).shape
        # oversized DRIVER INPUT is refused before any channel write, so
        # the loops never desynchronize
        in_name, in_msg = _raises(lambda: compiled.execute(np.zeros(100_000)))
        after = compiled.execute(8).result(timeout=60).shape
        compiled.teardown()
        return (name, "exceed" in msg, shape, in_name, "exceed" in in_msg,
                after)

    return _with_actors(rt, lambda: [Stage.remote(0), Stage.remote(0)], body)


def test_payload_exceeds_buffer(dag_cluster):
    _same(dag_cluster, _scn_payload_exceeds_buffer,
          ("RayTaskError", True, (16,), "ValueError", True, (8,)))


def _scn_teardown_in_flight(rt):
    Stage = _stage(rt)

    def body(actors):
        compiled = _pipeline(rt, actors).experimental_compile(
            max_inflight_executions=4)
        assert compiled.uses_channels, compiled.fallback_reason
        for i in range(3):
            compiled.execute(i)  # never drained
        compiled.teardown()  # joins loops and unlinks despite the work
        leaked = channel_files(rt)
        compiled.teardown()  # idempotent
        refused = _raises(lambda: compiled.execute(1)) is not None
        return leaked, refused

    return _with_actors(rt, lambda: [Stage.remote(1)
                                     for _ in range(N_STAGES)], body)


def test_teardown_with_execution_in_flight(dag_cluster):
    _same(dag_cluster, _scn_teardown_in_flight, (set(), True))


def _scn_actor_death_mid_loop(rt):
    Stage = _stage(rt)
    exc = sub(rt, "exceptions")

    def body(actors):
        compiled = _pipeline(rt, actors).experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        first = compiled.execute(1).result(timeout=60)
        rt.kill(actors[1])
        raised = None
        try:
            for i in range(20):  # a step in the kill window may complete
                compiled.execute(i).result(timeout=30)
        except (exc.RayChannelError, exc.ActorDiedError):
            raised = True
        compiled.teardown()  # still clean: joins what it can, unlinks
        return first, raised, channel_files(rt)

    return _with_actors(rt, lambda: [Stage.remote(1) for _ in range(2)],
                        body)


def test_actor_death_mid_loop(dag_cluster):
    _same(dag_cluster, _scn_actor_death_mid_loop, (3, True, set()))


def _scn_teardown_surfaces_errors(rt):
    InputNode = sub(rt, "dag").InputNode

    @rt.remote
    def die(x):
        raise RuntimeError("inflight failure")

    with InputNode() as inp:
        dag = die.bind(inp)
    compiled = dag.experimental_compile()
    plane = compiled.uses_channels  # FunctionNode → submit plane
    compiled.execute(1)
    raised = _raises(lambda: compiled.teardown(raise_on_error=True))
    return plane, raised[0]


def test_teardown_surfaces_inflight_errors(dag_cluster):
    _same(dag_cluster, _scn_teardown_surfaces_errors, (False, "RayTaskError"))


def _scn_async_methods(rt):
    InputNode = sub(rt, "dag").InputNode

    @rt.remote
    class AsyncStage:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0)
            return x + 100

    def body(actors):
        with InputNode() as inp:
            dag = actors[0].work.bind(inp)
        compiled = dag.experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        outs = [compiled.execute(i).result(timeout=60) for i in range(5)]
        compiled.teardown()
        return outs

    return _with_actors(rt, lambda: [AsyncStage.remote()], body)


def test_async_actor_methods_on_channel_plane(dag_cluster):
    """`async def` methods resolve on the actor's event loop, never leaking
    coroutine objects into the channels."""
    _same(dag_cluster, _scn_async_methods, [i + 100 for i in range(5)])


def _scn_get_on_future_lists(rt):
    Stage = _stage(rt)

    def body(actors):
        compiled = _pipeline(rt, actors).experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        futs = [compiled.execute(i) for i in range(4)]
        # wait() polls futures' done() (no ObjectRefs exist)
        ready, not_ready = rt.wait(futs, num_returns=4, timeout=30)
        vals = rt.get(futs, timeout=60)
        # mixed future + ObjectRef lists resolve elementwise, once teardown
        # freed the actors' exec-loop slots for normal calls
        compiled.teardown()
        mixed = rt.get([actors[0].work.remote(10)], timeout=60)
        return len(ready), len(not_ready), vals, mixed

    return _with_actors(rt, lambda: [Stage.remote(1) for _ in range(2)],
                        body)


def test_get_on_future_lists(dag_cluster):
    _same(dag_cluster, _scn_get_on_future_lists,
          (4, 0, [i + 2 for i in range(4)], [11]))


def _scn_unconsumed_bounded(rt):
    Stage = _stage(rt)

    def body(actors):
        compiled = _pipeline(rt, actors).experimental_compile(
            max_inflight_executions=2)
        assert compiled.uses_channels, compiled.fallback_reason
        ex = compiled._channel
        early = compiled.execute(0)  # held future: must survive eviction
        for i in range(1, 100):
            compiled.execute(i)  # futures discarded immediately
        bounded = len(ex._results) <= ex._retain + 1  # +1: `early`
        evicted = ex._expired_below > 0
        out = (bounded, evicted, early.result(timeout=60),
               compiled.execute(7).result(timeout=60))
        compiled.teardown()
        return out

    return _with_actors(rt, lambda: [Stage.remote(1) for _ in range(2)],
                        body)


def test_unconsumed_results_are_bounded(dag_cluster):
    """Drained rows whose future was dropped are evicted beyond the
    retention window; rows with a live future are always kept."""
    _same(dag_cluster, _scn_unconsumed_bounded, (True, True, 2, 9))


def _scn_double_compile_rejected(rt):
    InputNode = sub(rt, "dag").InputNode
    Stage = _stage(rt)

    def body(actors):
        a = actors[0]
        with InputNode() as inp:
            dag1 = a.work.bind(inp)
        c1 = dag1.experimental_compile()
        assert c1.uses_channels, c1.fallback_reason
        with InputNode() as inp:
            dag2 = a.work.bind(inp)
        name, msg = _raises(dag2.experimental_compile)
        c1.teardown()
        c2 = dag2.experimental_compile()  # actor released at teardown
        out = (name, "compiled DAG" in msg, c2.uses_channels,
               c2.execute(1).result(timeout=60))
        c2.teardown()
        return out

    return _with_actors(rt, lambda: [Stage.remote(1)], body)


def test_double_compile_same_actor_rejected(dag_cluster):
    """A second compiled DAG over a busy actor is refused at compile time,
    and allowed after teardown."""
    _same(dag_cluster, _scn_double_compile_rejected,
          ("ValueError", True, True, 2))


def _scn_teardown_unblocks(rt):
    InputNode = sub(rt, "dag").InputNode

    @rt.remote
    class Slow:
        def work(self, x):
            import time

            time.sleep(x)
            return x

    def body(actors):
        with InputNode() as inp:
            dag = actors[0].work.bind(inp)
        compiled = dag.experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        fut = compiled.execute(8)  # the step hangs ~8 s
        errs = []
        t = threading.Thread(target=lambda: errs.append(
            _raises(lambda: fut.result(timeout=60))), daemon=True)
        t.start()
        time.sleep(0.5)  # let result() block inside the executor lock
        compiled.teardown()  # must not deadlock on the executor lock
        t.join(timeout=15)
        return t.is_alive(), errs[0][0] if errs and errs[0] else None

    return _with_actors(rt, lambda: [Slow.remote()], body)


def test_teardown_unblocks_stuck_result(dag_cluster):
    """teardown() aborts a result() blocked on a hung step (the blocked
    caller holds the executor lock: teardown must not need it)."""
    _same(dag_cluster, _scn_teardown_unblocks, (False, "RayChannelError"))


def _scn_nonblocking_poll(rt):
    create = sub(rt, "experimental.channel.mutable_shm").create_mutable_channel
    ch = create(4096)
    try:
        t0 = time.perf_counter()
        first = _raises(lambda: ch.read(timeout=0))
        fast = time.perf_counter() - t0 < 0.05
        polled = ch.poll()
        ch.write({"x": 1})
        polled_after = ch.poll()
        full = _raises(lambda: ch.write({"x": 2}, timeout=0))
        return (first[0], fast, polled, polled_after, full[0],
                ch.read(timeout=0))
    finally:
        ch.close()
        ch.unlink()


def test_mutable_shm_nonblocking_poll(dag_cluster):
    """timeout=0 is a true non-blocking probe."""
    _same(dag_cluster, _scn_nonblocking_poll,
          ("TimeoutError", True, False, True, "TimeoutError", {"x": 1}),
          sequential=True)
