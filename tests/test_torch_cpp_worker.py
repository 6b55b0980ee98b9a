"""Twins of tests/test_cpp_worker.py against the port's runtime.

The port's C++ worker (``ray_tpu_torch/csrc/cpp_worker.cc``, built by g++
into ``ray_tpu_torch/build/``) joins a ``ray_tpu_torch`` session over JSON
frames and runs registered functions by name; the port's GCS routes only
``lang="cpp"`` tasks to it and re-encodes its results for Python callers.
The JAX side of each case runs in the reference's own file.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cross_lang import ensure_cpp_worker_binary


@pytest.fixture(scope="module")
def cpp_cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_workers=1)
    proc = ray_tpu_torch.start_cpp_worker()
    deadline = time.time() + 30
    while time.time() < deadline:
        rows = _workers()
        if any(w.get("kind") == "worker" and not w.get("dead")
               and w.get("wid", "").startswith("cpp-") for w in rows):
            break
        time.sleep(0.2)
    yield proc
    proc.terminate()
    proc.wait(timeout=10)
    ray_tpu_torch.shutdown()


def _workers():
    from ray_tpu_torch._private.api import _get_worker

    return _get_worker().rpc({"type": "list_workers"})["workers"]


def test_binary_builds():
    path = ensure_cpp_worker_binary()
    assert path.endswith("cpp_worker")
    # the port's own build directory, never the JAX package's cpp/build/
    assert os.path.dirname(path) == os.path.join(
        os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)), "build")
    assert os.path.getmtime(path) >= os.path.getmtime(os.path.join(
        os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)), "csrc",
        "cpp_worker.cc"))


def test_cpp_functions_compute(cpp_cluster):
    add = ray_tpu_torch.cpp_function("add")
    assert ray_tpu_torch.get(add.remote(2, 3), timeout=60) == 5
    assert ray_tpu_torch.get(add.remote(2.5, 0.25), timeout=60) == 2.75
    concat = ray_tpu_torch.cpp_function("concat")
    assert ray_tpu_torch.get(concat.remote("tpu", "-", "native"),
                             timeout=60) == "tpu-native"
    vec = ray_tpu_torch.cpp_function("vec_sum")
    assert ray_tpu_torch.get(vec.remote([1, 2, 3.5]), timeout=60) == 6.5


def test_cpp_native_compute_loop(cpp_cluster):
    pi = ray_tpu_torch.get(
        ray_tpu_torch.cpp_function("monte_carlo_pi").remote(500_000),
        timeout=120)
    assert abs(pi - 3.14159) < 0.02


def test_cpp_error_propagates_as_python_exception(cpp_cluster):
    from ray_tpu_torch.exceptions import RayTpuError

    with pytest.raises(RayTpuError, match="intentional failure from C"):
        ray_tpu_torch.get(
            ray_tpu_torch.cpp_function("fail_on_purpose").remote(),
            timeout=60)
    with pytest.raises(RayTpuError, match="unknown cpp function"):
        ray_tpu_torch.get(ray_tpu_torch.cpp_function("no_such_fn").remote(),
                          timeout=60)


def test_python_tasks_never_land_on_cpp_worker(cpp_cluster):
    """Language-aware scheduling: python tasks only dispatch to python
    workers even with the cpp worker idle."""

    @ray_tpu_torch.remote
    def pyfn():
        import os

        return os.getpid()

    pids = set(ray_tpu_torch.get([pyfn.remote() for _ in range(8)],
                                 timeout=60))
    cpp_pids = {w["pid"] for w in _workers()
                if w.get("wid", "").startswith("cpp-")}
    assert pids and not (pids & cpp_pids)


def test_cross_lang_args_validated():
    import numpy as np

    with pytest.raises(TypeError, match="JSON-encodable"):
        ray_tpu_torch.cpp_function("add").remote(np.ones(3), 1)
    # nested rejects fail at the call too, naming where they are
    with pytest.raises(TypeError, match=r"args\[0\]\['k'\]\[1\]"):
        ray_tpu_torch.cpp_function("add").remote({"k": [1, float("nan")]})


def test_cpp_worker_death_fails_inflight_and_queued(cpp_cluster):
    """Killing the cpp worker mid-task surfaces a worker-death error, and
    a NEW worker picks up later submissions."""
    proc = cpp_cluster
    slowish = ray_tpu_torch.cpp_function("monte_carlo_pi")
    ref = slowish.remote(300_000_000)  # long enough to die mid-flight
    time.sleep(0.5)
    proc.terminate()
    proc.wait(timeout=10)
    with pytest.raises(Exception):
        ray_tpu_torch.get(ref, timeout=60)
    # a replacement worker serves the queue again
    proc2 = ray_tpu_torch.start_cpp_worker()
    try:
        assert ray_tpu_torch.get(
            ray_tpu_torch.cpp_function("add").remote(1, 1), timeout=60) == 2
    finally:
        proc2.terminate()
        proc2.wait(timeout=10)
