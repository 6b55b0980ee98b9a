"""The port's object lifecycle and spilling against the JAX package's: the
store paths Data stands on.

Twins of tests/test_object_lifecycle.py (reference counting, cascading
frees, holds for in-flight tasks, borrower death, spill-tier accounting)
and tests/test_spilling.py (a bounded tmpfs budget with LRU spill to
disk), run on both packages and compared (tests/torch_twins.py). Each
side reads its own GCS tables, its own config flags (``RAY_TPU_*`` and
the port's ``RAY_TPU_TORCH_*``) and its own segments
(``/dev/shm/rtpu_<session>_*`` and the port's ``rtpt_<session>_*``).

Two reference cases need a second host (``Cluster.add_host``):
``test_reconstruction_after_host_loss`` and
``test_put_object_lost_is_an_error`` (tests/test_object_lifecycle.py:149,
177). Their twins are in tests/test_torch_multihost.py.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import pytest

from torch_twins import env_name, is_port, same, start_sessions, sub

# the reference marks its module slow (tests/conftest.py _SLOW_MODULES)
pytestmark = pytest.mark.slow


def _same(pkgs, scn, want=None, **kw):
    return same(pkgs, scn, want, serve_cleanup=False, **kw)


@pytest.fixture
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=2, max_workers=8)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _api(rt):
    return sub(rt, "_private.api")


def _gcs(rt):
    return _api(rt)._node.gcs


def _entry(rt, oid):
    with _gcs(rt).lock:
        return _gcs(rt).objects.get(oid)


def _wait_gone(rt, oid, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _entry(rt, oid) is None:
            return True
        time.sleep(0.05)
    return False


def _store_has(rt, oid):
    return _api(rt)._worker.store.contains(oid)


# ------------------------------------------------------- object lifecycle


def test_put_object_freed_when_ref_dropped(pkgs):
    def scn(rt):
        ref = rt.put(np.ones((300_000,), dtype=np.float64))  # 2.4 MB → shm
        oid = ref.hex()
        before = (_store_has(rt, oid), _entry(rt, oid) is not None)
        del ref
        gc.collect()
        gone = _wait_gone(rt, oid)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and _store_has(rt, oid):
            time.sleep(0.05)
        return before, gone, _store_has(rt, oid)

    _same(pkgs, scn, ((True, True), True, False))


def test_task_result_freed_when_ref_dropped(pkgs):
    def scn(rt):
        @rt.remote
        def make():
            import numpy as _np

            return _np.zeros((200_000,), dtype=_np.float64)

        ref = make.remote()
        shape = rt.get(ref).shape
        oid = ref.hex()
        del ref
        gc.collect()
        return shape, _wait_gone(rt, oid)

    _same(pkgs, scn, ((200_000,), True))


def test_object_survives_while_ref_held(pkgs):
    def scn(rt):
        ref = rt.put(np.ones((200_000,), dtype=np.float64))
        time.sleep(1.0)  # several flush cycles
        return (_entry(rt, ref.hex()) is not None,
                bool(np.all(rt.get(ref) == 1.0)))

    _same(pkgs, scn, (True, True))


def test_inflight_task_arg_not_freed(pkgs):
    def scn(rt):
        @rt.remote
        def slow_sum(arr):
            import time as _t

            _t.sleep(1.5)
            return float(arr.sum())

        ref = rt.put(np.ones((200_000,), dtype=np.float64))
        out = slow_sum.remote(ref)
        oid = ref.hex()
        del ref  # only the in-flight task holds it now
        gc.collect()
        total = rt.get(out, timeout=30)
        del out
        gc.collect()
        return total, _wait_gone(rt, oid)

    _same(pkgs, scn, (200_000.0, True))


def test_contained_refs_cascade(pkgs):
    def scn(rt):
        inner = rt.put(np.ones((150_000,), dtype=np.float64))
        inner_oid = inner.hex()
        outer = rt.put({"payload": inner})
        del inner  # only the stored container references it now
        gc.collect()
        time.sleep(0.6)
        held = _entry(rt, inner_oid) is not None
        got = rt.get(outer)
        first = float(rt.get(got["payload"])[0])
        del got
        outer_oid = outer.hex()
        del outer
        gc.collect()
        return (held, first, _wait_gone(rt, outer_oid),
                _wait_gone(rt, inner_oid))

    _same(pkgs, scn, (True, 1.0, True, True))


def test_manual_free_still_works(pkgs):
    def scn(rt):
        ref = rt.put(np.ones((200_000,), dtype=np.float64))
        oid = ref.hex()
        rt.free([ref])
        return _entry(rt, oid)

    _same(pkgs, scn, None)


def test_gc_opt_out():
    import ray_tpu
    import ray_tpu_torch

    pkgs = (ray_tpu, ray_tpu_torch)
    flags = [env_name(rt, "AUTO_GC") for rt in pkgs]
    os.environ.update({k: "0" for k in flags})
    try:
        pkgs = start_sessions(num_cpus=2, num_workers=1, max_workers=4)

        def scn(rt):
            ref = rt.put(np.ones((200_000,), dtype=np.float64))
            oid = ref.hex()
            del ref
            gc.collect()
            time.sleep(0.6)
            return _entry(rt, oid) is not None  # no auto-free when disabled

        _same(pkgs, scn, True)
    finally:
        for k in flags:
            os.environ.pop(k, None)
        for rt in pkgs:
            rt.shutdown()


def test_sigkilled_borrower_refs_reclaimed(pkgs):
    """A SIGKILLed worker's outstanding +1 ref contributions are reclaimed
    on death, so the objects it borrowed don't leak."""
    def scn(rt):
        big = rt.put(np.ones((300_000,), dtype=np.float64))
        oid = big.hex()

        @rt.remote
        class Holder:
            def __init__(self):
                self.kept = None

            def keep(self, refs):
                import os as _os

                self.kept = refs  # deserializes + retains the inner ref
                return _os.getpid()

        h = Holder.options(max_restarts=0).remote()
        pid = rt.get(h.keep.remote([big]), timeout=30)
        os.kill(pid, 9)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            with _gcs(rt).lock:
                dead = all(w.dead for w in _gcs(rt).workers.values()
                           if w.pid == pid)
            if dead:
                break
            time.sleep(0.1)
        survived = _entry(rt, oid) is not None
        shape = rt.get(big, timeout=10).shape
        del big
        gc.collect()
        return survived, shape, _wait_gone(rt, oid, 15)

    _same(pkgs, scn, (True, (300_000,), True))


def test_spill_tier_accounting(pkgs):
    """Objects that land on the disk tier (tmpfs-full fallback) are not
    counted as tmpfs bytes by the GCS spill accountant."""
    def scn(rt):
        w = _api(rt)._worker
        tier = w.store.put_parts("deadbeef00", [b"x" * 1000], 1000)
        w.send_no_reply({"type": "object_put", "oid": "deadbeef01",
                         "where": "shm", "size": 1 << 40, "host": w.host_id,
                         "tier": "spill"})
        w.send_no_reply({"type": "object_put", "oid": "deadbeef02",
                         "where": "shm", "size": 2048, "host": w.host_id,
                         "tier": "shm"})
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if (_entry(rt, "deadbeef02") is not None
                    and _entry(rt, "deadbeef01") is not None):
                break
            time.sleep(0.05)
        with _gcs(rt).lock:
            used = _gcs(rt).host_shm_bytes.get(w.host_id, 0)
        return (tier, used < (1 << 40),
                w.host_id in _entry(rt, "deadbeef01").get("hosts", set()))

    _same(pkgs, scn, ("shm", True, True))


# --------------------------------------------------------------- spilling

CAPACITY = 1_600_000  # ~1.6 MB tmpfs budget; each test object is 0.8 MB


@pytest.fixture
def small_budget():
    import ray_tpu
    import ray_tpu_torch

    flags = [env_name(rt, "OBJECT_STORE_CAPACITY")
             for rt in (ray_tpu, ray_tpu_torch)]
    os.environ.update({k: str(CAPACITY) for k in flags})
    try:
        pkgs = start_sessions(num_cpus=4, num_workers=1, max_workers=4)
        yield pkgs
    finally:
        for k in flags:
            os.environ.pop(k, None)
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _shm_bytes(rt) -> int:
    prefix = "rtpt_" if is_port(rt) else "rtpu_"
    session = _api(rt)._node.session_id
    return sum(os.path.getsize(os.path.join("/dev/shm", n))
               for n in os.listdir("/dev/shm")
               if n.startswith(f"{prefix}{session}_"))


def test_twice_capacity_of_live_objects(small_budget):
    """Hold refs to 2x the budget: everything stays readable, tmpfs stays
    bounded, the overflow lives in the spill tier."""
    def scn(rt):
        refs = [rt.put(np.full((100_000,), i, dtype=np.float64))
                for i in range(8)]  # 8 x 0.8 MB = 6.4 MB >> 1.6 MB budget
        time.sleep(0.3)  # let the spiller drain
        spill_dir = _api(rt)._worker.store.spill_dir
        return (_shm_bytes(rt) <= 2 * CAPACITY,
                os.path.isdir(spill_dir) and bool(os.listdir(spill_dir)),
                [float(rt.get(r)[0]) for r in refs])

    # one side after the other: the spiller drains within the 0.3 s only
    # while the other runtime is not competing for the cores
    _same(small_budget, scn, (True, True, [float(i) for i in range(8)]),
          sequential=True)


def test_spilled_object_still_pullable_by_worker(small_budget):
    def scn(rt):
        @rt.remote
        def total(arr):
            return float(arr.sum())

        refs = [rt.put(np.ones((100_000,), dtype=np.float64))
                for _ in range(6)]
        time.sleep(0.3)
        # the earliest object is the LRU spill victim; a worker reads it
        return rt.get(total.remote(refs[0]), timeout=30)

    _same(small_budget, scn, 100_000.0)


def test_spill_and_free_interact(small_budget):
    def scn(rt):
        refs = [rt.put(np.ones((100_000,), dtype=np.float64))
                for _ in range(6)]
        time.sleep(0.3)
        oids = [r.hex() for r in refs]
        spill_dir = _api(rt)._worker.store.spill_dir
        del refs
        gc.collect()
        gcs = _gcs(rt)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            with gcs.lock:
                if all(o not in gcs.objects for o in oids):
                    break
            time.sleep(0.1)
        time.sleep(0.2)
        # freed objects vanish from BOTH tiers
        return [o for o in oids if os.path.exists(os.path.join(spill_dir, o))]

    _same(small_budget, scn, [])
