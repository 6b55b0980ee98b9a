"""Twins of tests/test_store_backends.py against the port's runtime: the
store-sensitive cases on BOTH object-store backends, the native shm arena
(the default) and the file-per-object fallback
(``RAY_TPU_TORCH_STORE_BACKEND=file``).

Per backend: spilling past a tight store budget with everything staying
readable, and a compiled-DAG channel smoke through a real session; and the
arena's absence (no toolchain) degrading to the file backend. The object
lifecycle and the transfer plane are twinned in
tests/test_torch_object_store.py.

Each session's leak check globs only what that session made: its own
``/dev/shm/rtpt_<session>*`` segments and the channels in the test's own
directory (``torch_twins.private_channel_dirs``). The reference's globs
every ``rtpu_*`` on the host, which other test workers' sessions trip.
"""

from __future__ import annotations

import glob
import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import api as _api
from ray_tpu_torch._private.constants import SHM_DIR, SHM_SESSION_PREFIX
from ray_tpu_torch._private.object_store import make_object_store
from torch_twins import channel_files, private_channel_dirs

pytestmark = pytest.mark.store_matrix

BACKENDS = ("arena", "file")


def _session_entries(sid: str) -> set:
    return set(glob.glob(os.path.join(SHM_DIR,
                                      SHM_SESSION_PREFIX + sid + "*")))


@pytest.fixture(params=BACKENDS)
def backend(request, monkeypatch):
    """Pin the store backend for this process AND every child it spawns
    (spawn_env forwards explicitly-set RAY_TPU_TORCH_* flags)."""
    monkeypatch.setenv("RAY_TPU_TORCH_STORE_BACKEND", request.param)
    yield request.param


@pytest.fixture
def backend_session(backend, monkeypatch, tmp_path):
    private_channel_dirs(monkeypatch, tmp_path)
    ray_tpu_torch.shutdown()
    sid = ray_tpu_torch.init(num_cpus=8, num_workers=1,
                             max_workers=8)["session_id"]
    yield backend
    ray_tpu_torch.shutdown()
    leaked = _session_entries(sid) | channel_files(ray_tpu_torch)
    assert not leaked, f"/dev/shm leak under backend={backend}: {leaked}"


def test_spilling_past_budget(backend, monkeypatch):
    """2x the store budget of live objects: everything stays readable, the
    overflow lands in the spill tier (file: GCS spiller; arena: LRU
    evict-to-spill on put)."""
    monkeypatch.setenv("RAY_TPU_TORCH_OBJECT_STORE_CAPACITY", str(1_600_000))
    monkeypatch.setenv("RAY_TPU_TORCH_STORE_CAPACITY", str(1_600_000))
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_workers=1, max_workers=4)
    try:
        refs = [ray_tpu_torch.put(np.full(100_000, i, np.float64))
                for i in range(8)]  # 8 x 0.8 MB
        time.sleep(0.3)  # let the file-backend spiller drain
        for i, r in enumerate(refs):
            arr = ray_tpu_torch.get(r)
            assert arr[0] == i and arr.shape == (100_000,)
        if backend == "arena":
            store = _api._worker.store
            # the budget bound holds structurally: the arena segment IS the
            # capacity; live bytes inside it never exceed it
            assert store.used() <= store.capacity() <= 2 * 1_600_000
    finally:
        ray_tpu_torch.shutdown()


def test_arena_unavailable_degrades_to_file(monkeypatch, caplog):
    """No C++ toolchain (g++ missing / compile failure) must not crash
    init(): the selector warns, pins the file backend into the env so
    children agree, and returns the file store."""
    import subprocess

    from ray_tpu_torch._private import shm_arena
    from ray_tpu_torch._private.object_store import ShmObjectStore

    def broken_toolchain():
        raise subprocess.CalledProcessError(1, ["g++"])

    monkeypatch.setenv("RAY_TPU_TORCH_STORE_BACKEND", "arena")
    monkeypatch.setattr(shm_arena, "_ensure_lib", broken_toolchain)
    with caplog.at_level("WARNING"):
        store = make_object_store("degrade_test")
    try:
        assert isinstance(store, ShmObjectStore)
        assert os.environ["RAY_TPU_TORCH_STORE_BACKEND"] == "file"
        assert any("falling back" in r.message for r in caplog.records)
    finally:
        store.cleanup_session()


def test_dag_channels_smoke(backend_session):
    """Compiled-DAG channel plane over each backend: the exec-loop actors
    and the driver share whichever store is configured."""
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class Adder:
        def __init__(self, bias):
            self.bias = bias

        def work(self, x):
            return x + self.bias

    actors = [Adder.remote(1), Adder.remote(10)]
    with InputNode() as inp:
        node = inp
        for a in actors:
            node = a.work.bind(node)
    compiled = node.experimental_compile()
    try:
        for i in range(3):
            assert ray_tpu_torch.get(compiled.execute(i)) == i + 11
    finally:
        compiled.teardown()
