"""Twins of tests/test_dag_chaos.py: SIGKILL compiled-DAG pipeline actors
mid-step, in each package, and the channel plane recovers in place (or
degrades to the submit path).

Each scenario runs through ``ray_tpu`` and ``ray_tpu_torch`` (one
module-scoped session each; the reference starts a cluster per test) and
the two sides agree. Victims come from each runtime's own worker table.
The scenarios define their actor classes inside themselves and kill what
they made. Each test's channels go to a directory of its own, and its leak
check globs only that directory; the occupancy registry must be empty
after teardown. The randomized kill loop stays behind `-m slow`, as in the
reference.
"""

from __future__ import annotations

import os
import random
import signal
import time
from functools import partial

import pytest

from torch_twins import (channel_files, pid_of_actor, private_channel_dirs,
                         shutdown_runtimes, start_sessions, sub, twin)

pytestmark = pytest.mark.dag_chaos

N_STAGES = 4
_twin = partial(twin, serve_cleanup=False)


@pytest.fixture(scope="module")
def pkgs():
    out = start_sessions(num_cpus=32, num_workers=2, max_workers=14)
    yield out
    shutdown_runtimes(out)


@pytest.fixture
def chaos_cluster(pkgs, monkeypatch, tmp_path):
    private_channel_dirs(monkeypatch, tmp_path)
    yield pkgs
    for rt in pkgs:
        assert not channel_files(rt), (rt.__name__, channel_files(rt))
        assert not sub(rt, "dag.channel_execution")._occupied_actors


def _same(pkgs, scenario, want=None):
    a, b = _twin(pkgs, scenario, timeout=300)
    assert a == b, (a, b)
    if want is not None:
        assert a == want, a
    return a


def _stage(rt):
    @rt.remote(max_restarts=-1)
    class Stage:
        """Stateless transform (restarts rebuild it bit-identical), with an
        optional per-step delay so a SIGKILL lands mid-step and an init
        delay so a restart cannot outrun a recovery deadline."""

        def __init__(self, bias, step_delay=0.0, init_delay=0.0):
            import time

            if init_delay:
                time.sleep(init_delay)
            self.bias = bias
            self.step_delay = step_delay

        def work(self, x):
            import time

            if self.step_delay:
                time.sleep(self.step_delay)
            return x + self.bias

    return Stage


def _pipeline(rt, actors):
    InputNode = sub(rt, "dag").InputNode
    with InputNode() as inp:
        node = inp
        for a in actors:
            node = a.work.bind(node)
    return node


def _sigkill(rt, actor) -> int:
    pid = pid_of_actor(rt, actor._actor_id)
    os.kill(pid, signal.SIGKILL)
    return pid


def _kill(rt, actors):
    for a in actors:
        try:
            rt.kill(a)
        except Exception:  # noqa: BLE001 — already dead
            pass


def _recovered_count(rt, dag_id: str, outcome: str) -> float:
    for m in sub(rt, "util.metrics").snapshot():
        if m["name"] != "ray_tpu_dag_recoveries_total":
            continue
        for tags, value in m["series"]:
            t = dict(tuple(kv) for kv in tags)
            if t.get("dag_id") == dag_id and t.get("outcome") == outcome:
                return value
    return 0.0


def _scn_sigkill_replay(rt):
    rng = random.Random(0xDA6C4A05)
    actors = [_stage(rt).remote(1) for _ in range(N_STAGES)]
    api = sub(rt, "_private.api")
    try:
        compiled = _pipeline(rt, actors).experimental_compile(
            enable_retry=True, max_inflight_executions=4)
        assert compiled.uses_channels, compiled.fallback_reason
        dag_id = compiled.dag_id
        warm = [compiled.execute(i).result(timeout=60) for i in range(5)]
        futs = [compiled.execute(100 + i) for i in range(4)]  # window full
        _sigkill(rt, rng.choice(actors))
        futs += [compiled.execute(104 + i) for i in range(8)]
        # strict equality over EVERY seq is the exactly-once check: a lost
        # or duplicated replay row would shift every later result
        outs = [f.result(timeout=120) for f in futs]
        in_place = (compiled.uses_channels
                    and compiled.fallback_reason is None
                    and compiled.dag_id == dag_id
                    and compiled._channel.recoveries >= 1)
        repeat = futs[0].result()  # a cached row, not re-executed
        counted = _recovered_count(rt, dag_id, "recovered") >= 1
        deadline = time.monotonic() + 20
        spans = []
        while time.monotonic() < deadline and not spans:
            spans = [e for e in api.timeline()
                     if e.get("event") == "dag:recovery"
                     and e.get("dag_id") == dag_id]
            time.sleep(0.25)
        outcome = spans[0].get("outcome") if spans else None
        after = compiled.execute(7).result(timeout=60)
        compiled.teardown()
        return warm, outs, in_place, repeat, counted, outcome, after
    finally:
        _kill(rt, actors)


def test_sigkill_mid_step_recovers_with_replay(chaos_cluster):
    """SIGKILL a random restartable pipeline actor under load on an
    enable_retry DAG: the plane rewires in place and replays."""
    _same(chaos_cluster, _scn_sigkill_replay,
          ([i + N_STAGES for i in range(5)],
           [100 + i + N_STAGES for i in range(12)], True, 100 + N_STAGES,
           True, "recovered", 7 + N_STAGES))


def _scn_death_without_retry(rt):
    exc = sub(rt, "exceptions")
    actors = [_stage(rt).remote(1, step_delay=0.3) for _ in range(2)]
    try:
        compiled = _pipeline(rt, actors).experimental_compile(
            max_inflight_executions=4)
        assert compiled.uses_channels, compiled.fallback_reason
        first = compiled.execute(0).result(timeout=60)
        futs = [compiled.execute(10 + i) for i in range(3)]
        _sigkill(rt, actors[1])  # step_delay: work is in flight
        outcomes = []
        for f in futs:
            try:
                outcomes.append(f.result(timeout=120))
            except exc.ActorDiedError as e:
                outcomes.append(e)
        errs = [o for o in outcomes if isinstance(o, exc.ActorDiedError)]
        # the error names the dead node and points at the replay knob
        named = bool(errs) and ("work@actor:" in str(errs[0])
                                and "enable_retry" in str(errs[0]))
        recovered = (compiled.uses_channels
                     and compiled._channel.recoveries >= 1)
        later = [compiled.execute(20 + i).result(timeout=60)
                 for i in range(3)]
        compiled.teardown()
        return first, bool(errs), named, recovered, later
    finally:
        _kill(rt, actors)


def test_death_without_retry_fails_steps_keeps_serving(chaos_cluster):
    """enable_retry=False: in-flight steps at the kill surface as per-step
    errors naming the dead node; the recovered plane keeps serving."""
    _same(chaos_cluster, _scn_death_without_retry,
          (2, True, True, True, [22 + i for i in range(3)]))


def _scn_unrestartable_degrades(rt):
    exc = sub(rt, "exceptions")

    @rt.remote  # max_restarts=0: no budget
    class Frail:
        def work(self, x):
            import time

            time.sleep(0.3)
            return x + 1

    a, b = Frail.remote(), Frail.remote()
    try:
        compiled = _pipeline(rt, [a, b]).experimental_compile(
            max_inflight_executions=4)
        assert compiled.uses_channels, compiled.fallback_reason
        dag_id = compiled.dag_id
        first = compiled.execute(0).result(timeout=60)
        futs = [compiled.execute(i) for i in range(2)]
        _sigkill(rt, b)
        named = []
        for f in futs:
            try:
                f.result(timeout=120)
                named.append(None)
            except exc.ActorDiedError as e:
                named.append("work@actor:" in str(e))
        # the NEXT submission flips the DAG to the submit plane: no "torn
        # down", no RayChannelError, the DAG object stays usable
        out = compiled.execute(5)
        flipped = (not compiled.uses_channels
                   and compiled.fallback_reason.startswith("actor_death"))
        counted = _recovered_count(rt, dag_id, "degraded") >= 1
        try:
            rt.get(out, timeout=60)  # b is still dead on the submit plane
            dead = None
        except exc.ActorDiedError:
            dead = True
        # the surviving actor's exec loop was joined: it serves calls
        alive = rt.get(a.work.remote(1), timeout=60)
        compiled.teardown()
        return first, named, flipped, counted, dead, alive
    finally:
        _kill(rt, [a, b])


def test_unrestartable_death_degrades_to_submit_path(chaos_cluster):
    """An actor with no restart budget dying degrades the DAG to the
    submit-path fallback instead of bricking it."""
    _same(chaos_cluster, _scn_unrestartable_degrades,
          (2, [True, True], True, True, True, 2))


def _scn_degraded_honors_retries(rt):
    exc = sub(rt, "exceptions")
    api = sub(rt, "_private.api")
    cfg = sub(rt, "_private.ray_config").RayConfig.instance()
    old_budget = cfg.dag_recovery_timeout_s
    Stage = _stage(rt)
    made = []

    def degraded_dag(actor):
        compiled = _pipeline(rt, [actor]).experimental_compile()
        assert compiled.uses_channels, compiled.fallback_reason
        assert compiled.execute(0).result(timeout=60) == 1
        # zero recovery budget + slow restart (init_delay) → the kill
        # degrades the plane instead of rewiring it
        cfg.dag_recovery_timeout_s = 0.0
        try:
            _sigkill(rt, actor)
            try:
                compiled.execute(1).result(timeout=120)
                raise AssertionError("the step survived its actor's death")
            except exc.ActorDiedError:
                pass
            flip_ref = compiled.execute(2)  # flips to the submit plane
        finally:
            cfg.dag_recovery_timeout_s = old_budget
        assert not compiled.uses_channels
        assert compiled.fallback_reason.startswith("actor_death")
        api._get_worker().wait_actor_ready(actor._actor_id, timeout=60)
        # drain the flip step so the actor is IDLE: the next execute must
        # be the one in flight when the kill lands
        assert rt.get(flip_ref, timeout=120) == 3
        return compiled

    try:
        # -1: an in-flight call lost to a death is retried until it lands
        patient = Stage.options(max_task_retries=-1).remote(
            1, step_delay=0.4, init_delay=1.0)
        made.append(patient)
        compiled = degraded_dag(patient)
        ref = compiled.execute(10)
        time.sleep(0.1)  # let the step dispatch so the kill hits it
        _sigkill(rt, patient)
        retried = rt.get(ref, timeout=120)
        compiled.teardown()

        # 0: the lost call fails; the NEXT call (restarted actor) succeeds
        frail = Stage.options(max_task_retries=0).remote(
            1, step_delay=0.4, init_delay=1.0)
        made.append(frail)
        compiled = degraded_dag(frail)
        ref = compiled.execute(10)
        time.sleep(0.1)
        _sigkill(rt, frail)
        try:
            rt.get(ref, timeout=120)
            lost = None
        except exc.ActorDiedError:
            lost = True
        api._get_worker().wait_actor_ready(frail._actor_id, timeout=60)
        nxt = rt.get(compiled.execute(3), timeout=120)
        compiled.teardown()
        return retried, lost, nxt
    finally:
        _kill(rt, made)


def test_degraded_dag_honors_max_task_retries(chaos_cluster):
    """A compiled-then-degraded DAG rides the normal actor retry machinery:
    in-flight submit-plane calls lost to a later death are retried per the
    actor's max_task_retries budget."""
    _same(chaos_cluster, _scn_degraded_honors_retries, (11, True, 4))


def _scn_randomized_kill_loop(rt):
    rng = random.Random(0xBADC0DE5)
    actors = [_stage(rt).remote(1) for _ in range(N_STAGES)]
    try:
        compiled = _pipeline(rt, actors).experimental_compile(
            enable_retry=True, max_inflight_executions=4)
        assert compiled.uses_channels, compiled.fallback_reason
        seq = 0
        for _round in range(5):
            futs = [compiled.execute(seq + i) for i in range(4)]
            try:
                _sigkill(rt, rng.choice(actors))
            except StopIteration:
                pass  # victim mid-restart from the previous round
            futs += [compiled.execute(seq + 4 + i) for i in range(6)]
            assert [f.result(timeout=120) for f in futs] == [
                seq + i + N_STAGES for i in range(10)]
            assert compiled.uses_channels, compiled.fallback_reason
            seq += 10
        recoveries = compiled._channel.recoveries >= 2
        compiled.teardown()
        return recoveries
    finally:
        _kill(rt, actors)


@pytest.mark.slow
def test_randomized_kill_loop(chaos_cluster):
    """Sustained load with a SIGKILL of a random stage every round:
    repeated recoveries (deaths DURING a recovery too) keep the plane exact
    and leak-free."""
    _same(chaos_cluster, _scn_randomized_kill_loop, True)
