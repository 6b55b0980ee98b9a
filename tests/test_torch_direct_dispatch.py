"""Twins of tests/test_direct_dispatch.py: direct (leased-worker) task
dispatch, its chaining, failure handling, cancel semantics and lease
revocation, in each package. A compiled DAG that falls back, or degrades,
runs on this `.remote()` path.

Each test starts both runtimes fresh, as the reference's
`ray_start_regular` does (4 CPUs: the hog and lease tests need the whole
node), and runs its scenario through ``ray_tpu`` and ``ray_tpu_torch``;
the two sides agree. `test_locality_large_arg_no_cross_host_bytes` makes
its own cluster with a follower host (``Cluster.add_host``), as the
reference's does.
"""

from __future__ import annotations

import time
from functools import partial

import pytest

from torch_twins import shutdown_runtimes, start_sessions, sub, twin

_twin = partial(twin, serve_cleanup=False)


@pytest.fixture
def pkgs():
    out = start_sessions(num_cpus=4, num_workers=2, max_workers=4)
    yield out
    shutdown_runtimes(out)


def _same(pkgs, scenario, want=None):
    a, b = _twin(pkgs, scenario)
    assert a == b, (a, b)
    if want is not None:
        assert a == want, a
    return a


def _add_one(rt):
    @rt.remote
    def add_one(x):
        return x + 1

    return add_one


def _scn_fast_path(rt):
    add_one = _add_one(rt)
    assert rt.get(add_one.remote(1), timeout=60) == 2  # warm the pool
    core = sub(rt, "_private.api")._get_worker()
    before = core._direct.submitted if core._direct else 0
    out = rt.get([add_one.remote(i) for i in range(60)], timeout=60)
    # most rode the fast path
    return out == list(range(1, 61)), core._direct.submitted - before >= 50


def test_fast_path_engages(pkgs):
    _same(pkgs, _scn_fast_path, (True, True))


def _scn_chained(rt):
    add_one = _add_one(rt)
    r = add_one.remote(0)
    for _ in range(40):
        r = add_one.remote(r)
    return rt.get(r, timeout=60)


def test_chained_direct_tasks(pkgs):
    _same(pkgs, _scn_chained, 41)


def _scn_error_propagates(rt):
    add_one = _add_one(rt)

    @rt.remote
    def boom():
        raise ValueError("direct boom")

    def msg(ref):
        try:
            rt.get(ref, timeout=60)
        except Exception as e:  # noqa: BLE001 — the message is the result
            return "direct boom" in str(e)
        return None

    # an errored direct dep fails the dependent task too (GCS fallback)
    return msg(boom.remote()), msg(add_one.remote(boom.remote()))


def test_direct_error_propagates(pkgs):
    _same(pkgs, _scn_error_propagates, (True, True))


def _scn_ref_escapes(rt):
    add_one = _add_one(rt)

    @rt.remote
    class Reader:
        def read(self, ref):
            return rt.get(ref)

    val = add_one.remote(10)  # a direct result, caller-local
    first = rt.get(val, timeout=60)
    reader = Reader.remote()
    return first, rt.get(reader.read.remote([val]), timeout=60)


def test_direct_result_ref_escapes_to_actor(pkgs):
    """An unpublished direct result is published when its ref leaves the
    caller, so other processes can resolve it."""
    _same(pkgs, _scn_ref_escapes, (11, [11]))


def test_direct_worker_death_retries_via_gcs(pkgs, tmp_path):
    def scn(rt):
        flag = str(tmp_path / f"died-once-{rt.__name__}")

        @rt.remote(max_retries=2)
        def flaky():
            import os

            if not os.path.exists(flag):
                open(flag, "w").write("x")
                os._exit(1)  # kills the leased worker mid-task
            return "recovered"

        return rt.get(flaky.remote(), timeout=90)

    _same(pkgs, scn, "recovered")


def _scn_cancel_queued(rt):
    @rt.remote(num_cpus=4)
    def hog():
        import time

        time.sleep(20)
        return "hog"

    @rt.remote(num_cpus=4)
    def quick():
        return "quick"

    h = hog.remote()
    time.sleep(0.6)  # hog runs on the only 4-CPU lease
    q = quick.remote()
    time.sleep(0.2)
    cancelled = rt.cancel(q)
    try:
        rt.get(q, timeout=30)
        err = None
    except sub(rt, "exceptions").TaskCancelledError:
        err = "TaskCancelledError"
    del h
    return cancelled, err


def test_direct_cancel_queued_behind_running(pkgs):
    """A direct task queued behind a long-running one on the same leased
    worker is cancellable out of the worker's queue."""
    _same(pkgs, _scn_cancel_queued, (True, "TaskCancelledError"))


def _scn_wait_mixes(rt):
    add_one = _add_one(rt)

    @rt.remote
    def slow():
        import time

        time.sleep(5)
        return "slow"

    fast_ref = add_one.remote(1)
    slow_ref = slow.remote()
    ready, not_ready = rt.wait([fast_ref, slow_ref], num_returns=1,
                               timeout=4)
    return ready == [fast_ref], not_ready == [slow_ref]


def test_wait_mixes_direct_and_gcs(pkgs):
    _same(pkgs, _scn_wait_mixes, (True, True))


def _scn_lease_revoked(rt):
    @rt.remote(num_cpus=4)
    def hold(sec):
        import time

        time.sleep(sec)
        return "done"

    @rt.remote(num_cpus=4)
    class Big:
        def ping(self):
            return "pong"

    ref = hold.remote(2.0)  # a direct lease holds all 4 CPUs while running
    time.sleep(0.5)
    a = Big.remote()  # queues at the GCS until the lease goes
    return rt.get(a.ping.remote(), timeout=60), rt.get(ref, timeout=30)


def test_lease_revoked_for_pending_gcs_work(pkgs):
    """A pending actor creation that needs resources a direct-dispatch
    lease holds triggers a revoke: the lease drains and returns, and the
    actor is placed (reference: leases spill back under pressure)."""
    _same(pkgs, _scn_lease_revoked, ("pong", "done"))


def _scn_locality(rt):
    """A task whose big argument lives on a follower host is leased there:
    the bytes never cross hosts (reference: lease_policy.h locality)."""
    rt.shutdown()
    cluster = sub(rt, "cluster_utils").Cluster(head_node_args=dict(
        num_cpus=2, num_workers=1, max_workers=8))
    try:
        host = cluster.add_host(num_cpus=2)
        on = sub(rt, "util.scheduling_strategies").NodeAffinitySchedulingStrategy
        key = ("RAY_TPU_TORCH_HOST_ID" if rt.__name__ == "ray_tpu_torch"
               else "RAY_TPU_HOST_ID")

        @rt.remote
        def make_big(n):
            import numpy as np

            return np.full((n,), 2, dtype=np.float32)

        @rt.remote
        def consume(arr):
            import os

            return os.environ.get(key, "host-0"), float(arr.sum())

        # ~1.6 MB, in the follower's shm
        big = make_big.options(
            scheduling_strategy=on(node_id=host)).remote(400_000)
        rt.wait([big], timeout=60)  # caches readiness + location
        host_ran, total = rt.get(consume.remote(big), timeout=60)
        core = sub(rt, "_private.api")._get_worker()
        # ran next to its argument; the bytes never reached the driver
        return (host_ran == host, total,
                core.store.contains(big.hex()))
    finally:
        cluster.shutdown()


def test_locality_large_arg_no_cross_host_bytes():
    import ray_tpu
    import ray_tpu_torch

    a, b = twin((ray_tpu, ray_tpu_torch), _scn_locality, sequential=True,
                serve_cleanup=False)
    assert a == b == (True, 2.0 * 400_000, False), (a, b)
