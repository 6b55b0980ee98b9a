"""The port's twins of tests/test_runtime_env.py, against ray_tpu_torch:
env_vars, working_dir, py_modules, the URI cache and pip venvs (the venv
base is the port's ``ray_tpu_torch_venvs``; extracted packages live under
``<temp root>/runtime_envs``), with the port-side checks: a re-exec'd env
worker keeps its GPU grant, and the two packages' venv bases, conda bases
and node registries are disjoint.

(reference capability: python/ray/_private/runtime_env/ — agent-materialized
per-task/actor envs with content-addressed package caching,
runtime_env_agent.py:165, packaging.py, uri_cache.py.)
"""

from __future__ import annotations

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import runtime_env as renv
from ray_tpu_torch._private.constants import temp_root


@pytest.fixture
def session():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_workers=1, max_workers=8)
    yield
    ray_tpu_torch.shutdown()


def test_env_hash_stability_and_normalization(tmp_path):
    kv = {}
    n1 = renv.package({"env_vars": {"B": "2", "A": "1"}}, kv.__setitem__, kv.get)
    n2 = renv.package({"env_vars": {"A": "1", "B": "2"}}, kv.__setitem__, kv.get)
    assert renv.env_hash(n1) == renv.env_hash(n2) != ""
    assert renv.env_hash(None) == renv.env_hash({}) == ""
    # conda is SUPPORTED as of round 4 (runtime_env_conda.py)
    assert renv.package({"conda": "env"}, kv.__setitem__,
                        kv.get)["conda"] == "env"
    with pytest.raises(ValueError):
        renv.package({"container": {}}, kv.__setitem__, kv.get)
    with pytest.raises(TypeError):
        renv.package({"env_vars": {"A": 1}}, kv.__setitem__, kv.get)


def test_package_uri_cache(tmp_path):
    d = tmp_path / "wd"
    d.mkdir()
    (d / "data.txt").write_text("hello")
    kv = {}
    puts = []

    def kv_put(k, v):
        puts.append(k)
        kv[k] = v

    n1 = renv.package({"working_dir": str(d)}, kv_put, kv.get)
    n2 = renv.package({"working_dir": str(d)}, kv_put, kv.get)
    assert n1 == n2
    assert len(puts) == 1, "second package of identical dir must hit the URI cache"
    assert n1["working_dir"].startswith("pkg:")


def test_env_vars_per_task_worker(session):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RENV_PROBE": "v1"}})
    def probe():
        return os.environ.get("RENV_PROBE"), os.getpid()

    @ray_tpu_torch.remote
    def plain():
        return os.environ.get("RENV_PROBE"), os.getpid()

    v, pid_env = ray_tpu_torch.get(probe.remote(), timeout=90)
    assert v == "v1"
    v2, pid_plain = ray_tpu_torch.get(plain.remote(), timeout=90)
    assert v2 is None
    assert pid_env != pid_plain, "env task must run in a dedicated worker"
    # same env reuses the same specialized worker
    _, pid_env2 = ray_tpu_torch.get(probe.remote(), timeout=90)
    assert pid_env2 == pid_env


def test_working_dir_and_py_modules(session, tmp_path):
    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "payload.txt").write_text("from-working-dir")
    mod = tmp_path / "mod"
    mod.mkdir()
    (mod / "renv_probe_mod.py").write_text("VALUE = 'imported-ok'\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(wd),
                                 "py_modules": [str(mod)]})
    def use_env():
        import renv_probe_mod  # resolvable via py_modules

        with open("payload.txt") as f:  # cwd == extracted working_dir
            data = f.read()
        return data, renv_probe_mod.VALUE, os.getcwd()

    data, val, cwd = ray_tpu_torch.get(use_env.remote(), timeout=90)
    assert data == "from-working-dir"
    assert val == "imported-ok"
    assert cwd.startswith(os.path.join(temp_root(), "runtime_envs"))


def test_actor_runtime_env(session):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_RENV": "yes"}})
    class A:
        def probe(self):
            return os.environ.get("ACTOR_RENV")

    a = A.remote()
    assert ray_tpu_torch.get(a.probe.remote(), timeout=90) == "yes"


def test_job_level_default_runtime_env(tmp_path):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, max_workers=8,
                 runtime_env={"env_vars": {"JOB_WIDE": "set"}})
    try:
        @ray_tpu_torch.remote
        def probe():
            return os.environ.get("JOB_WIDE")

        assert ray_tpu_torch.get(probe.remote(), timeout=90) == "set"
    finally:
        ray_tpu_torch.shutdown()


def _make_test_pkg(tmp_path, version="0.1.0"):
    """A tiny offline-installable package (host setuptools via
    --no-build-isolation; no index access)."""
    pkg = tmp_path / "rtpu_probe_pkg"
    (pkg / "rtpu_probe_pkg").mkdir(parents=True)
    (pkg / "rtpu_probe_pkg" / "__init__.py").write_text(
        f'MAGIC = "probe-{version}"\n')
    (pkg / "pyproject.toml").write_text(
        '[build-system]\n'
        'requires = ["setuptools"]\n'
        'build-backend = "setuptools.build_meta"\n'
        '[project]\n'
        'name = "rtpu-probe-pkg"\n'
        f'version = "{version}"\n')
    return str(pkg)


@pytest.mark.slow
def test_pip_runtime_env_isolated_venv(session, tmp_path):
    """A task runs with a package the driver env lacks, installed into a
    cached venv keyed by the requirement list (reference:
    _private/runtime_env/pip.py)."""
    pkg_dir = _make_test_pkg(tmp_path)
    pip_spec = ["--no-index", "--no-build-isolation", pkg_dir]

    with pytest.raises(ImportError):
        import rtpu_probe_pkg  # noqa: F401 — must NOT exist in the driver

    @ray_tpu_torch.remote(runtime_env={"pip": pip_spec})
    def probe():
        import sys

        import rtpu_probe_pkg

        return rtpu_probe_pkg.MAGIC, sys.prefix

    magic, prefix = ray_tpu_torch.get(probe.remote(), timeout=300)
    assert magic == "probe-0.1.0"
    assert "ray_tpu_torch_venvs" in prefix  # ran under the venv interpreter

    # cache hit: same spec reuses the venv (fast second task)
    t0 = time.monotonic()
    magic2, prefix2 = ray_tpu_torch.get(probe.remote(), timeout=120)
    assert magic2 == "probe-0.1.0" and prefix2 == prefix

    # baseline workers stay clean
    @ray_tpu_torch.remote
    def clean():
        try:
            import rtpu_probe_pkg  # noqa: F401

            return "leaked"
        except ImportError:
            return "clean"

    assert ray_tpu_torch.get(clean.remote(), timeout=60) == "clean"


@pytest.mark.slow
def test_pip_env_hash_distinguishes_requirements(tmp_path):
    from ray_tpu_torch import runtime_env as _renv

    kv = {}
    n1 = _renv.package({"pip": ["pkg-a==1.0"]}, kv.__setitem__, kv.get)
    n2 = _renv.package({"pip": ["pkg-a==2.0"]}, kv.__setitem__, kv.get)
    assert _renv.env_hash(n1) != _renv.env_hash(n2)
    n3 = _renv.package({"uv": {"packages": ["pkg-a==1.0"]}},
                       kv.__setitem__, kv.get)
    assert _renv.env_hash(n3) == _renv.env_hash(n1)


# ------------------------------------------------------- port-side checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reexec_under_the_env_keeps_the_gpu_grant(tmp_path, monkeypatch):
    """A pip-env worker boots through worker_boot, which asks the host's
    runtime-env agent for the env's interpreter and execs it: the GPU
    grant (CUDA_VISIBLE_DEVICES), the port's location on PYTHONPATH and
    the worker_main entry reach that interpreter."""
    import json
    import subprocess
    import sys
    import threading

    from ray_tpu_torch._private import runtime_env_agent as rea

    out = tmp_path / "exec.txt"
    fake = tmp_path / "python"
    fake.write_text(f'#!/bin/sh\necho "$CUDA_VISIBLE_DEVICES|$PYTHONPATH|$*" '
                    f'> {out}\n')
    fake.chmod(0o755)
    monkeypatch.setattr(rea, "_build", lambda renv: {"python": str(fake)})
    agent = rea.RuntimeEnvAgent(str(tmp_path / "agent.sock"))
    threading.Thread(target=agent.serve_forever, daemon=True).start()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="3",
               RAY_TPU_TORCH_RUNTIME_ENV=json.dumps({"pip": ["x==1"]}),
               RAY_TPU_TORCH_RENV_AGENT_SOCK=agent.socket_path)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_boot"],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=60)
    finally:
        agent.stop()
    assert r.returncode == 0, r.stderr
    cvd, pythonpath, args = out.read_text().strip().split("|")
    assert cvd == "3"
    assert REPO in pythonpath.split(os.pathsep)
    assert args == "-m ray_tpu_torch._private.worker_main"


def test_the_two_packages_env_bases_and_node_registries_are_disjoint(
        tmp_path, monkeypatch):
    """Each package keeps its venvs, conda prefixes and LocalNodeProvider
    pid registry in a 0700 directory of its own, and recognizes only its
    own node agents in /proc: neither can reuse, sweep or signal what the
    other built or launched."""
    import stat
    import subprocess
    import sys
    import tempfile

    from ray_tpu._private import runtime_env_conda as jconda
    from ray_tpu._private import runtime_env_pip as jpip
    from ray_tpu.autoscaler import node_provider as jnp
    from ray_tpu_torch._private import runtime_env_conda as tconda
    from ray_tpu_torch._private import runtime_env_pip as tpip
    from ray_tpu_torch.autoscaler import node_provider as tnp

    for var in ("RAY_TPU_VENV_BASE", "RAY_TPU_TORCH_VENV_BASE",
                "RAY_TPU_CONDA_ENV_BASE", "RAY_TPU_TORCH_CONDA_ENV_BASE",
                "RAY_TPU_TORCH_AUTOSCALER_STATE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    addr = "unix:/tmp/no-such-gcs.sock"
    for jax_dir, port_dir in (
            (jpip.venv_base(), tpip.venv_base()),
            (jconda.conda_base(), tconda.conda_base()),
            (os.path.dirname(jnp.LocalNodeProvider(addr).registry_path),
             os.path.dirname(tnp.LocalNodeProvider(addr).registry_path))):
        assert not (jax_dir + os.sep).startswith(port_dir + os.sep)
        assert not (port_dir + os.sep).startswith(jax_dir + os.sep)
        assert stat.S_IMODE(os.stat(port_dir).st_mode) == 0o700
    host = "as-w-disjoint"
    stand_in = subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(60)",
         "ray_tpu._private.node_agent", "--host-id", host])
    try:
        deadline = time.monotonic() + 10
        while jnp._find_agent_pid(host) is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert jnp._find_agent_pid(host) == stand_in.pid
        assert tnp._find_agent_pid(host) is None
    finally:
        stand_in.kill()
        stand_in.wait(timeout=10)


def test_a_gpu_task_with_a_new_env_gets_a_worker_of_that_env(monkeypatch):
    """The first num_gpus=1 task of a runtime env the GCS has not seen yet
    runs in a worker of that env holding the GPU: lease demand spawns no
    env-less worker for it (one would register under no env and be
    refused while its GPU stayed booked for the spawn's budget)."""
    monkeypatch.setenv("RAY_TPU_TORCH_GPUS", "1")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=1, num_workers=0, max_workers=4)
    try:
        @ray_tpu_torch.remote(num_gpus=1,
                              runtime_env={"env_vars": {"GPU_ENV": "on"}})
        def probe():
            return (os.environ.get("GPU_ENV"),
                    os.environ.get("CUDA_VISIBLE_DEVICES"))

        assert ray_tpu_torch.get(probe.remote(), timeout=60) == ("on", "0")
    finally:
        ray_tpu_torch.shutdown()


def test_the_parent_bridge_goes_into_the_venvs_own_site_packages(tmp_path):
    """The .pth bridge to the building interpreter's packages is written
    into the new venv's own site-packages (its purelib), never into a
    system directory the venv can also see."""
    import subprocess
    import sys

    from ray_tpu_torch._private import runtime_env_pip as rep

    dest = tmp_path / "venv"
    subprocess.run([sys.executable, "-m", "venv", "--without-pip",
                    "--system-site-packages", str(dest)], check=True,
                   timeout=120)
    site_dir = rep.venv_site_dir(str(dest / "bin" / "python"))
    assert os.path.commonpath([site_dir, str(dest)]) == str(dest), site_dir
    assert site_dir.endswith("site-packages") and os.path.isdir(site_dir)
