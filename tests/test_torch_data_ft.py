"""The port's Data fault-tolerance policy against the JAX package's:
``on_block_error`` accounting, the system-vs-application retry taxonomy,
datasource read retries, pool supervision units and owned-ref teardown.

Twins of tests/test_data_ft.py, run on both packages and compared
(tests/torch_twins.py). Each side reads its own config flags
(``RAY_TPU_DATA_*`` and the port's ``RAY_TPU_TORCH_DATA_*``), counters
(each package's ``util.metrics``) and events (each package's
``_private.events``).
"""

from __future__ import annotations

import os
import random

import numpy as np
import pytest

from torch_twins import env_name, is_port, pair, same, start_sessions, sub

BLOCK_ROWS = 50  # range(400, parallelism=8) → 8 blocks of 50 rows


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=4, num_workers=2, max_workers=6)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False)


def _ex(rt):
    return sub(rt, "data.execution")


def _exc(rt):
    return sub(rt, "exceptions")


def _failing(bad_blocks):
    rows = BLOCK_ROWS  # captured by value: workers can't import this module

    def fn(batch):
        bidx = int(batch["id"][0]) // rows
        if bidx in bad_blocks:
            raise ValueError(f"udf boom on block {bidx}")
        return {"id": batch["id"]}

    return fn


def _pipeline(rt, fn):
    return sub(rt, "data").range(400, parallelism=8).map_batches(fn)


def _metric_total(rt, name: str) -> float:
    return sum(value for m in sub(rt, "util.metrics").snapshot()
               if m["name"] == name for _tags, value in m["series"])


def _live_metrics(rt) -> None:
    """The JAX executor keeps its counters in a module-level cache; once
    another test file in this process has cleared the JAX registry
    (tests/test_torch_tracing.py compares both registries), the cached
    counters record where no snapshot looks. Drop the cache so this file's
    reads see the counters. The port's executor looks its counters up in
    the registry at each start and needs nothing
    (test_port_executor_counters_survive_a_cleared_registry)."""
    if not is_port(rt):
        _ex(rt)._pipeline_metric_cache = None


def _drain(rt, ex) -> list:
    blocks = []
    try:
        for item in ex.execute():
            got = (_ex(rt)._robust_get(item, rng=ex._rng)
                   if hasattr(item, "hex") else item)
            ex._free_if_owned(item)
            blocks.extend(got if isinstance(got, list) else [got])
    finally:
        ex.release_owned()
    return blocks


def _ids(blocks):
    return np.sort(np.concatenate([np.asarray(b["id"]) for b in blocks]))


class _Env:
    """Config flags set in `rt`'s namespace for one scenario, then unset,
    with the package's RayConfig re-read on both edges."""

    def __init__(self, rt, **flags):
        self.rt = rt
        self.flags = {env_name(rt, k): v for k, v in flags.items()}

    def __enter__(self):
        os.environ.update(self.flags)
        sub(self.rt, "_private.ray_config").RayConfig.reset()

    def __exit__(self, *exc):
        for k in self.flags:
            os.environ.pop(k, None)
        sub(self.rt, "_private.ray_config").RayConfig.reset()


# ------------------------------------------------------- policy accounting


def test_skip_policy_counts_exactly(pkgs):
    def scn(rt):
        events = sub(rt, "_private.events")
        events.reset()
        _live_metrics(rt)
        errored0 = _metric_total(rt, "ray_tpu_data_blocks_errored_total")
        ex = _ex(rt).StreamingExecutor(
            _pipeline(rt, _failing({1, 5}))._stages(), on_block_error="skip")
        ids = _ids(_drain(rt, ex))
        want = np.array([i for i in range(400)
                         if i // BLOCK_ROWS not in (1, 5)])
        ev = [e for e in events.recent() if e["etype"] == "data.block_errored"]
        return (np.array_equal(ids, want), ex.errored_blocks,
                len(ex.errored_block_ids),
                _metric_total(rt, "ray_tpu_data_blocks_errored_total")
                - errored0,
                len(ev), all(e["block_id"] in ex.errored_block_ids
                             for e in ev))

    _same(pkgs, scn, (True, 2, 2, 2, 2, True))


def test_port_executor_counters_survive_a_cleared_registry(pkgs):
    """After ``util.metrics.clear_registry()`` (another test file in the
    same process may call it) the port's executor still records its
    errored blocks where a snapshot sees them."""
    rt = pkgs[1]
    sub(rt, "util.metrics").clear_registry()
    ex = _ex(rt).StreamingExecutor(
        _pipeline(rt, _failing({2}))._stages(), on_block_error="skip")
    _drain(rt, ex)
    sub(rt, "util.metrics").clear_registry()
    ex = _ex(rt).StreamingExecutor(
        _pipeline(rt, _failing({3, 4}))._stages(), on_block_error="skip")
    _drain(rt, ex)
    assert _metric_total(rt, "ray_tpu_data_blocks_errored_total") == 2


def test_skip_policy_through_dataset_surface(pkgs):
    def scn(rt):
        rows = _pipeline(rt, _failing({3})).execute_options(
            on_block_error="skip").take_all()
        return len(rows), {int(r["id"]) // BLOCK_ROWS for r in rows}

    _same(pkgs, scn, (350, set(range(8)) - {3}))


def test_raise_policy_surfaces_block_id(pkgs):
    def scn(rt):
        with pytest.raises(_exc(rt).DataBlockError) as ei:
            _pipeline(rt, _failing({2})).take_all()
        err = ei.value
        return (err.kind, isinstance(err.block_id, int), bool(err.stage),
                "udf boom" in str(err))

    _same(pkgs, scn, ("application", True, True, True))


def test_max_errored_blocks_budget(pkgs):
    def scn(rt):
        ds = _pipeline(rt, _failing({1, 5})).execute_options(
            on_block_error="skip", max_errored_blocks=1)
        with pytest.raises(_exc(rt).DataBlockError) as ei:
            ds.take_all()
        fits = _pipeline(rt, _failing({5})).execute_options(
            on_block_error="skip", max_errored_blocks=1)
        return (ei.value.kind, "max_errored_blocks=1" in str(ei.value),
                len(fits.take_all()))

    _same(pkgs, scn, ("application", True, 350))


def _flaky_once(pkg: str, dirpath: str):
    """Raises a SYSTEM-shaped error the FIRST time each bad block runs; the
    retry (a fresh task) sees the sentinel file and succeeds."""
    rows = BLOCK_ROWS

    def fn(batch):
        import importlib
        import os as _os

        lost = importlib.import_module(pkg + ".exceptions").ObjectLostError
        bidx = int(batch["id"][0]) // rows
        sentinel = _os.path.join(dirpath, f"b{bidx}")
        if bidx in (2, 6) and not _os.path.exists(sentinel):
            open(sentinel, "w").close()
            raise lost(f"synthetic block loss (block {bidx})")
        return {"id": batch["id"]}

    return fn


def test_system_retries_do_not_consume_errored_budget(pkgs, tmp_path):
    def scn(rt):
        d = tmp_path / rt.__name__
        d.mkdir()
        _live_metrics(rt)
        retries0 = _metric_total(rt, "ray_tpu_data_block_retries_total")
        # max_errored_blocks=0: any application skip would raise at once
        ex = _ex(rt).StreamingExecutor(
            _pipeline(rt, _flaky_once(rt.__name__, str(d)))._stages(),
            on_block_error="skip", max_errored_blocks=0)
        ids = _ids(_drain(rt, ex))
        return (np.array_equal(ids, np.arange(400)), ex.errored_blocks,
                ex.errored_block_ids,
                _metric_total(rt, "ray_tpu_data_block_retries_total")
                - retries0 >= 2)

    _same(pkgs, scn, (True, 0, [], True))


def test_system_retry_budget_exhaustion_raises_system_kind(pkgs):
    def scn(rt):
        lost = _exc(rt).ObjectLostError

        def always_lost(batch):
            raise lost("every attempt loses the block")

        with _Env(rt, DATA_MAX_BLOCK_RETRIES="1",
                  DATA_RETRY_BACKOFF_S="0.01"):
            ex = _ex(rt).StreamingExecutor(
                sub(rt, "data").range(40, parallelism=2).map_batches(
                    always_lost)._stages(), on_block_error="skip")
            with pytest.raises(_exc(rt).DataBlockError) as ei:
                _drain(rt, ex)
            return ei.value.kind, ex.errored_blocks

    _same(pkgs, scn, ("system", 0))


def test_error_taxonomy_and_backoff_bounds():
    def scn(rt):
        ex, E = _ex(rt), _exc(rt)
        kinds = [ex._is_system_error(e) for e in (
            E.ObjectLostError("x"), E.ActorDiedError("x"),
            E.RayTaskError("f", "tb", E.ActorDiedError("x")),
            E.RayTaskError("f", "tb", ValueError("x")), ValueError("x"))]
        rng = random.Random(7)
        delays = [ex._backoff_delay(a, 0.25, rng) for a in range(12)]
        return kinds, delays

    kinds, delays = pair(scn)
    assert kinds == [True, True, True, False, False]
    assert all(0.0 <= d <= 0.25 * 8 for d in delays)  # full jitter, capped


def test_executor_rejects_bad_policy():
    def scn(rt):
        with pytest.raises(ValueError, match="on_block_error") as ei:
            _ex(rt).StreamingExecutor([], on_block_error="explode")
        return str(ei.value)

    pair(scn)


# ------------------------------------------------------ datasource retries


def test_read_retries_transient_io():
    def scn(rt):
        with _Env(rt, DATA_READ_RETRY_BACKOFF_S="0.001"):
            calls = []

            def reader(path):
                calls.append(path)
                if len(calls) < 3:
                    raise OSError("transient EIO")
                return [{"rows": path}]

            out = sub(rt, "data.datasource")._read_with_retries(
                reader, "/d/f.csv")
            return out, len(calls)

    pair(scn, ([{"rows": "/d/f.csv"}], 3))


def test_read_retries_exhaustion_attributes_file():
    def scn(rt):
        with _Env(rt, DATA_READ_RETRY_BACKOFF_S="0.001"):
            calls = []

            def reader(path):
                calls.append(path)
                raise OSError("disk on fire")

            with pytest.raises(OSError) as ei:
                sub(rt, "data.datasource")._read_with_retries(
                    reader, "/data/broken.parquet")
            return ("/data/broken.parquet" in str(ei.value),
                    "3 attempt(s)" in str(ei.value), len(calls))

    pair(scn, (True, True, 3))


def test_read_never_retries_missing_file():
    def scn(rt):
        calls = []

        def reader(path):
            calls.append(path)
            raise FileNotFoundError(path)

        with pytest.raises(FileNotFoundError):
            sub(rt, "data.datasource")._read_with_retries(reader, "/gone.csv")
        return len(calls)

    pair(scn, 1)


# ------------------------------------------------- pool supervision units


def _actor_stage(rt):
    ds = sub(rt, "data").range(100).map_batches(lambda b: b, compute="actors",
                                                concurrency=2)
    return next(s for s in ds._stages() if s.compute == "actors")


def _wait_dead(rt, actor, timeout=20.0):
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _ex(rt)._actor_dead(actor):
            return True
        time.sleep(0.1)
    return False


def test_pool_replaces_dead_actor_and_returns_orphans(pkgs):
    def scn(rt):
        pool = _ex(rt)._ActorPool(_actor_stage(rt), size=2)
        try:
            # a failure on a LIVE actor is a plain task failure
            pool._outstanding["aa" * 8] = 0
            pool._load[0] += 1
            live = (pool.note_failed("aa" * 8), pool.replacements)
            victim = pool.actors[0]
            rt.kill(victim)
            dead = _wait_dead(rt, victim)
            pool._outstanding["bb" * 8] = 0  # the failure that trips the probe
            pool._outstanding["cc" * 8] = 0  # its in-flight sibling (orphan)
            pool._outstanding["dd" * 8] = 1  # survivor's work: must be kept
            pool._load[0] += 2
            orphans, replaced = pool.note_failed("bb" * 8)
            return (live, dead, orphans, replaced, pool.replacements,
                    len(pool.actors), dict(pool._outstanding))
        finally:
            pool.shutdown()

    _same(pkgs, scn, ((([], 0), 0), True, ["cc" * 8], 1, 1, 2,
                      {"dd" * 8: 0}))


def test_pool_restart_budget_zero_means_no_respawn(pkgs):
    def scn(rt):
        with _Env(rt, DATA_ACTOR_RESTART_BUDGET="0"):
            pool = _ex(rt)._ActorPool(_actor_stage(rt), size=1)
            try:
                victim = pool.actors[0]
                rt.kill(victim)
                dead = _wait_dead(rt, victim)
                pool._outstanding["ee" * 8] = 0
                pool._load[0] += 1
                with pytest.raises(_exc(rt).DataBlockError) as ei:
                    pool.note_failed("ee" * 8)
                return dead, ei.value.kind, pool.replacements
            finally:
                pool.shutdown()

    _same(pkgs, scn, (True, "system", 0))


# ------------------------------------------------------- owned-ref ledger


def test_release_owned_is_idempotent_and_empties_ledger(pkgs):
    def scn(rt):
        ex = _ex(rt).StreamingExecutor(sub(rt, "data").range(
            400, parallelism=8).map_batches(lambda b: b)._stages())
        gen = ex.execute()
        next(gen)  # partial consumption leaves intermediate refs owned
        gen.close()  # the generator's finally releases too
        ex.release_owned()
        first = not ex.owned
        ex.release_owned()  # second call is a no-op
        return first, not ex.owned

    _same(pkgs, scn, (True, True))


def test_error_of_reports_errors_without_raising(pkgs):
    def scn(rt):
        @rt.remote
        def ok():
            return 1

        @rt.remote
        def boom():
            raise RuntimeError("task exploded")

        w = sub(rt, "_private.api")._get_worker()
        good, bad = ok.remote(), boom.remote()
        rt.wait([good, bad], num_returns=2, timeout=30)
        err = w.error_of(bad.hex())
        return (w.error_of(good.hex()), type(err).__name__,
                type(err.cause).__name__)

    _same(pkgs, scn, (None, "RayTaskError", "RuntimeError"))
