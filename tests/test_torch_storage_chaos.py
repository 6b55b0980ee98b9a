"""The port's checkpoint-storage chaos against the JAX package's.

Twins of tests/test_storage_chaos.py: the mock store's die_on_key SIGKILLs
the training worker halfway through an upload; a fresh driver process (a
different "host", nothing shared but the storage URI) resumes from the
last committed checkpoint, never the torn one, with bounded retries. Each
package runs the same two phases in driver processes of its own, with its
own mock store root (``RAY_TPU_MOCK_STORE_ROOT``, the port's
``RAY_TPU_TORCH_MOCK_STORE_ROOT``), and both print the same record. The
randomized fault-injection loop runs once per package, behind ``slow`` as
the reference's.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("ray_tpu", "ray_tpu_torch")

_TRAIN_FN = """
def train_fn(config):
    import tempfile
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            with open(os.path.join(d, "rank_0", "iter.txt")) as f:
                start = int(f.read()) + 1
    for i in range(start, 5):
        with tempfile.TemporaryDirectory() as d:
            with open(os.path.join(d, "iter.txt"), "w") as f:
                f.write(str(i))
            with open(os.path.join(d, "payload.bin"), "wb") as f:
                f.write(os.urandom(4096))
            train.report({"iter": i, "resumed_from": start},
                         checkpoint=train.Checkpoint.from_directory(d))
"""

_PHASE_A = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import PKG as rt
from PKG import train

rt.init(num_cpus=4, num_workers=2, max_workers=4)
""" + _TRAIN_FN + """
trainer = train.DataParallelTrainer(
    train_fn,
    scaling_config=train.ScalingConfig(num_workers=1),
    run_config=train.RunConfig(
        name="chaos", storage_path=os.environ["CHAOS_URI_A"],
        failure_config=train.FailureConfig(max_failures=0)),
)
try:
    trainer.fit()
    print("PHASE-A-UNEXPECTED-SUCCESS")
except train.TrainingFailedError:
    print("PHASE-A-DIED-AS-EXPECTED")
rt.shutdown()
"""

_PHASE_B = """
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import PKG as rt
from PKG import train
from PKG.train import storage as st

uri = os.environ["CHAOS_URI_B"]
backend, exp_root = st.get_storage_backend(uri)
exp = st.join_path(exp_root, "chaos")
committed = [st.basename(p) for p, _ in
             st.list_committed_checkpoints(backend, exp, world_size=1)]
print("COMMITTED-BEFORE:", ",".join(committed))
torn = st.join_path(exp, "checkpoint_000002")
print("TORN-EXISTS:", backend.exists(torn),
      "TORN-COMMITTED:", st.is_committed(backend, st.join_path(torn, "rank_0")))

rt.init(num_cpus=4, num_workers=2, max_workers=4)
""" + _TRAIN_FN + """
trainer = train.DataParallelTrainer(
    train_fn,
    scaling_config=train.ScalingConfig(num_workers=1),
    run_config=train.RunConfig(
        name="chaos", storage_path=uri,
        failure_config=train.FailureConfig(max_failures=0)),
)
result = trainer.fit()
print("RESULT-ITER:", result.metrics["iter"])
print("RESUMED-FROM:", result.metrics["resumed_from"])
print("RESULT-CKPT:", st.basename(result.checkpoint.path))
print("STORAGE-RETRIES:", result.storage_retries)
rt.shutdown()
"""


def _root_env(pkg: str) -> str:
    return ("RAY_TPU_TORCH_" if pkg == "ray_tpu_torch" else "RAY_TPU_") + \
        "MOCK_STORE_ROOT"


def _phase(pkg: str, script: str, env: dict) -> str:
    env = {**env, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)}
    res = subprocess.run([sys.executable, "-c", script.replace("PKG", pkg)],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _record(pkg: str, tmp_path) -> tuple:
    env = dict(os.environ)
    env[_root_env(pkg)] = str(tmp_path / pkg / "store")
    env["CHAOS_URI_A"] = ("mock://chaosbkt/runs"
                          "?die_on_key=checkpoint_000002/rank_0&latency_ms=1")
    env["CHAOS_URI_B"] = ("mock://chaosbkt/runs"
                          "?fail_rate=0.15&read_fail_rate=0.1&seed=11")
    a = _phase(pkg, _PHASE_A, env)
    b = _phase(pkg, _PHASE_B, env)
    st = importlib.import_module(f"{pkg}.train.storage")
    retries = int(b.split("STORAGE-RETRIES:")[1].strip().split()[0])
    lines = [line for line in b.splitlines()
             if line.split(":")[0] in ("COMMITTED-BEFORE", "TORN-EXISTS",
                                       "RESUMED-FROM", "RESULT-ITER",
                                       "RESULT-CKPT")]
    return ("PHASE-A-DIED-AS-EXPECTED" in a, lines,
            0 <= retries <= 18 * (st.DEFAULT_RETRY.max_attempts - 1))


@pytest.mark.storage_chaos
def test_kill_mid_upload_then_resume_on_fresh_host(tmp_path):
    got = [_record(pkg, tmp_path) for pkg in PKGS]
    assert got[0] == got[1], got
    assert got[0] == (True, [
        "COMMITTED-BEFORE: checkpoint_000000,checkpoint_000001",
        "TORN-EXISTS: True TORN-COMMITTED: False",
        "RESULT-ITER: 4", "RESUMED-FROM: 2",
        "RESULT-CKPT: checkpoint_000004"], True), got


@pytest.mark.slow
@pytest.mark.storage_chaos
def test_fault_injection_loop_never_silently_corrupts(tmp_path, monkeypatch):
    outcomes = {}
    for pkg in PKGS:
        st = importlib.import_module(f"{pkg}.train.storage")
        monkeypatch.setenv(_root_env(pkg), str(tmp_path / pkg / "store"))
        retry = st.RetryConfig(max_attempts=6, base_delay_s=0.001)
        out = outcomes[pkg] = {"ok": 0, "persist_fail": 0}
        for seed in range(12):
            backend, base = st.get_storage_backend(
                f"mock://loop/exp{seed}?fail_rate=0.3&torn_rate=0.15"
                f"&read_fail_rate=0.2&seed={seed}")
            src = tmp_path / pkg / f"src{seed}"
            src.mkdir(parents=True)
            blobs = {f"f{j}.bin": os.urandom(256 + 64 * j) for j in range(4)}
            for name, data in blobs.items():
                (src / name).write_bytes(data)
            prefix = st.join_path(base, "ck")
            try:
                stats = st.persist_directory(backend, str(src), prefix,
                                             retry=retry)
            except st.StorageError:
                out["persist_fail"] += 1
                assert not st.is_committed(backend, prefix)
                continue
            assert stats.retries <= (stats.files + 2) * (
                retry.max_attempts - 1)
            assert st.is_committed(backend, prefix)
            dest = tmp_path / pkg / f"dest{seed}"
            st.restore_directory(
                backend, prefix, str(dest),
                retry=st.RetryConfig(max_attempts=12, base_delay_s=0.001))
            for name, data in blobs.items():
                assert (dest / name).read_bytes() == data
            out["ok"] += 1
        assert out["ok"] >= 1
        assert sum(out.values()) == 12
    # the same seeds inject the same faults in both packages
    assert outcomes["ray_tpu"] == outcomes["ray_tpu_torch"], outcomes
