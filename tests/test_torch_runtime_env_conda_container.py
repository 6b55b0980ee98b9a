"""The port's twins of tests/test_runtime_env_conda_container.py, against
ray_tpu_torch: conda + image_uri runtime environments (the port's
``RAY_TPU_TORCH_CONDA_ENV_BASE`` and ``RAY_TPU_TORCH_CONTAINER_ENGINE``).

(reference: python/ray/_private/runtime_env/{conda.py,image_uri.py} —
conda env creation keyed by spec hash, podman-wrapped workers. The conda
runner and container engine are injectable/fakable so the full command
construction and boot flow run in this image, which ships neither.)
"""

import os
import stat
import subprocess
import sys

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.runtime_env_conda import (conda_hash, ensure_conda_env,
                                                find_conda, normalize_conda)
from ray_tpu_torch._private.runtime_env_container import (container_argv,
                                                    find_engine,
                                                    normalize_image_uri)
from ray_tpu_torch.runtime_env import env_hash, package


class FakeRun:
    """Records conda invocations; simulates success."""

    def __init__(self, stdout=""):
        self.calls = []
        self.stdout = stdout

    def __call__(self, argv, **kw):
        self.calls.append(list(argv))
        if argv[1:3] == ["env", "create"]:
            prefix = argv[argv.index("-p") + 1]
            os.makedirs(os.path.join(prefix, "bin"), exist_ok=True)
            open(os.path.join(prefix, "bin", "python"), "w").close()
        return subprocess.CompletedProcess(argv, 0, stdout=self.stdout,
                                           stderr="")


@pytest.fixture(autouse=True)
def conda_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_CONDA_ENV_BASE", str(tmp_path / "conda"))
    yield


def test_normalize_conda():
    assert normalize_conda("myenv") == "myenv"
    spec = {"dependencies": ["numpy", "python=3.12",
                             {"pip": ["b-pkg", "a-pkg"]}]}
    out = normalize_conda(spec)
    assert out == {"dependencies": ["numpy", "python=3.12",
                                    {"pip": ["a-pkg", "b-pkg"]}]}
    # canonicalization is order-independent → stable hash
    spec2 = {"dependencies": ["python=3.12", {"pip": ["a-pkg", "b-pkg"]},
                              "numpy"]}
    assert conda_hash(normalize_conda(spec2)) == conda_hash(out)
    for bad in ({}, {"dependencies": []}, {"dependencies": [1]}, 42):
        with pytest.raises(TypeError):
            normalize_conda(bad)


def test_find_conda_error_is_actionable(monkeypatch):
    monkeypatch.delenv("CONDA_EXE", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="conda"):
        find_conda()


def test_ensure_named_env_resolves_interpreter():
    run = FakeRun(stdout="/opt/conda/envs/myenv/bin/python\n")
    py = ensure_conda_env("myenv", conda_exe="/fake/conda", runner=run)
    assert py == "/opt/conda/envs/myenv/bin/python"
    assert run.calls[0][:4] == ["/fake/conda", "run", "-n", "myenv"]


def test_ensure_spec_env_creates_once_and_caches():
    run = FakeRun()
    spec = {"dependencies": ["python=3.12", "numpy"]}
    py1 = ensure_conda_env(spec, conda_exe="/fake/conda", runner=run)
    py2 = ensure_conda_env(spec, conda_exe="/fake/conda", runner=run)
    assert py1 == py2 and py1.endswith("/bin/python")
    creates = [c for c in run.calls if c[1:3] == ["env", "create"]]
    assert len(creates) == 1  # second call hit the .ready cache
    yml = creates[0][creates[0].index("-f") + 1]
    text = open(yml).read()
    assert "python=3.12" in text and "numpy" in text


def test_package_normalizes_conda_and_image(tmp_path):
    kv = {}
    env = package({"conda": {"dependencies": ["numpy"]},
                   "image_uri": " img:tag "},
                  kv_put=kv.__setitem__, kv_get=kv.get)
    assert env["conda"] == {"dependencies": ["numpy"]}
    assert env["image_uri"] == "img:tag"
    assert env_hash(env)  # hashable for worker-pool keying
    with pytest.raises(ValueError, match="both 'pip' and 'conda'"):
        package({"pip": ["x"], "conda": "e"},
                kv_put=kv.__setitem__, kv_get=kv.get)


def test_container_argv_shape(tmp_path):
    argv = container_argv(
        "docker.io/org/img:tag", [sys.executable, "-m", "w"],
        {"RAY_TPU_TORCH_SOCKET": "/s/gcs.sock", "A": "1"},
        session_dir="/tmp/sess", engine="/usr/bin/podman")
    assert argv[:2] == ["/usr/bin/podman", "run"]
    assert "--network=host" in argv and "--ipc=host" in argv
    assert "-v" in argv and "/tmp/sess:/tmp/sess" in argv
    assert "/dev/shm:/dev/shm" in argv
    assert "--env" in argv and "A=1" in argv
    img_at = argv.index("docker.io/org/img:tag")
    # host interpreter path is swapped for the image's python
    assert argv[img_at + 1:] == ["python3", "-m", "w"]
    # no empty PYTHONPATH entry (empty = cwd on sys.path inside the image)
    pp = [a for a in argv if a.startswith("PYTHONPATH=")][0]
    assert "::" not in pp and not pp.endswith(":")


def test_find_engine_error(monkeypatch):
    monkeypatch.delenv("RAY_TPU_TORCH_CONTAINER_ENGINE", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="podman or docker"):
        find_engine()
    with pytest.raises(TypeError):
        normalize_image_uri("")


@pytest.mark.slow
def test_task_runs_inside_fake_container_engine(tmp_path, monkeypatch):
    """End to end: a fake engine (execs the worker argv, stamping a marker
    env var like a container would its own environment) proves spawn-path
    wiring — env vars, mounts and argv survive the wrapper."""
    fake = tmp_path / "podman"
    fake.write_text(f"""#!{sys.executable}
import os, sys
args = sys.argv[1:]
assert args[0] == "run"
envs = {{}}
i = 1
image = None
while i < len(args):
    if args[i] == "--env":
        k, _, v = args[i + 1].partition("=")
        envs[k] = v
        i += 2
    elif args[i] in ("-v", "--workdir"):
        i += 2
    elif args[i].startswith("-"):
        i += 1
    else:
        image = args[i]
        cmd = args[i + 1:]
        break
os.environ.update(envs)
os.environ["FAKE_CONTAINER_IMAGE"] = image
if cmd[0] == "python3":
    cmd[0] = sys.executable  # stand in for the image's python
os.execv(cmd[0], cmd)
""")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("RAY_TPU_TORCH_CONTAINER_ENGINE", str(fake))
    ray_tpu_torch.init(num_cpus=2, num_workers=0, max_workers=2)
    try:
        @ray_tpu_torch.remote(runtime_env={"image_uri": "test/img:1"})
        def where_am_i():
            return os.environ.get("FAKE_CONTAINER_IMAGE")

        assert ray_tpu_torch.get(where_am_i.remote(), timeout=120) == "test/img:1"
    finally:
        ray_tpu_torch.shutdown()


def test_conda_channels_in_spec_and_yaml():
    spec = {"dependencies": ["numpy"], "channels": ["conda-forge", "defaults"]}
    out = normalize_conda(spec)
    assert out["channels"] == ["conda-forge", "defaults"]  # priority order
    # channel lists change the cache hash — different channels, different env
    assert conda_hash(out) != conda_hash(
        normalize_conda({"dependencies": ["numpy"]}))
    run = FakeRun()
    ensure_conda_env(spec, conda_exe="/fake/conda", runner=run)
    yml_path = [c for c in run.calls if c[1:3] == ["env", "create"]][0]
    text = open(yml_path[yml_path.index("-f") + 1]).read()
    assert "channels:" in text and "conda-forge" in text
    with pytest.raises(TypeError, match="unsupported conda spec keys"):
        normalize_conda({"dependencies": ["x"], "variables": {"A": "1"}})
