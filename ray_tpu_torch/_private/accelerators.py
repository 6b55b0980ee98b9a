"""GPU detection and per-worker GPU isolation.

The port's counterpart of ray_tpu/_private/accelerators.py (its
``TPU_VISIBLE_CHIPS`` binding and chip count), for NVIDIA GPUs: the
resource is ``"GPU"`` and the option ``num_gpus``. A worker granted whole
GPUs gets them through ``CUDA_VISIBLE_DEVICES`` in its spawn env, before
anything in the child can create a CUDA context; a worker with no grant is
hidden from every card (``worker_platform="cpu"``, the counterpart of the
JAX package's hard-set ``JAX_PLATFORMS=cpu``).

Detection never imports torch and never creates a CUDA context: the env
override ``RAY_TPU_TORCH_GPUS`` (so tests simulate GPUs without hardware,
as ``RAY_TPU_CHIPS`` does for TPU chips), then the NVIDIA driver's
``/proc/driver/nvidia/gpus/*``, then ``nvidia-smi -L``.

The TPU slice labels (``ray_tpu.io/tpu-*``) and the ``TPU-{type}-head``
resource have no GPU counterpart and are not ported; ``labels=`` still
labels a node for NodeLabel scheduling.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess

#: the env var the CUDA runtime reads to restrict a process to a GPU subset.
CUDA_VISIBLE_DEVICES_ENV = "CUDA_VISIBLE_DEVICES"
#: authoritative record of the GPUs the GCS bound to this worker process
#: (set alongside CUDA_VISIBLE_DEVICES at spawn; read back at registration).
WORKER_GPUS_ENV = "RAY_TPU_TORCH_WORKER_GPUS"
#: opt-out: don't set CUDA_VISIBLE_DEVICES on GPU workers (reference:
#: RAY_EXPERIMENTAL_NOSET_CUDA_VISIBLE_DEVICES).
NOSET_VISIBLE_DEVICES_ENV = "RAY_TPU_TORCH_NOSET_CUDA_VISIBLE_DEVICES"
#: env override of the host's GPU count (simulated GPUs in tests).
GPUS_ENV = "RAY_TPU_TORCH_GPUS"


def detect_num_gpus() -> int:
    """The host's GPU count without importing torch: the env override, the
    driver's per-GPU proc entries, or ``nvidia-smi -L``."""
    env = os.environ.get(GPUS_ENV)
    if env:
        return int(env)
    try:
        gpus = glob.glob("/proc/driver/nvidia/gpus/*")
        if gpus:
            return len(gpus)
    except OSError:
        pass
    smi = shutil.which("nvidia-smi")
    if smi:
        try:
            out = subprocess.run([smi, "-L"], capture_output=True, text=True,
                                 timeout=10)
        except (OSError, subprocess.SubprocessError):
            return 0
        if out.returncode == 0:
            return sum(1 for line in out.stdout.splitlines()
                       if line.startswith("GPU "))
    return 0


def detect_host_resources(num_cpus=None, num_gpus=None, resources=None,
                          labels=None) -> tuple[dict, dict]:
    """(total_resources, labels) for a host."""
    total = {"CPU": float(num_cpus if num_cpus is not None
                          else (os.cpu_count() or 1))}
    ngpu = num_gpus if num_gpus is not None else detect_num_gpus()
    if ngpu:
        total["GPU"] = float(ngpu)
    if resources:
        total.update({k: float(v) for k, v in resources.items()})
    return total, dict(labels or {})


def gpus_required(resources: dict) -> int:
    """Whole GPUs a task/actor binds. A fractional GPU (< 1) shares without
    isolation and binds none, as in the reference."""
    v = float(resources.get("GPU", 0.0))
    return int(v) if v >= 1.0 else 0


def validate_num_gpus(num_gpus) -> None:
    if num_gpus is not None and float(num_gpus) > 1 and \
            float(num_gpus) != int(num_gpus):
        raise ValueError(
            f"num_gpus must be an integer when > 1 (got {num_gpus}): whole "
            f"GPUs are bound to a worker via CUDA_VISIBLE_DEVICES")


def apply_gpu_env(env: dict, gpus: tuple | list) -> None:
    """Stamp a worker-spawn env with its GPU binding (before anything in the
    child creates a CUDA context, so it only ever sees these GPUs)."""
    ids = ",".join(str(g) for g in gpus)
    env[WORKER_GPUS_ENV] = ids
    if os.environ.get(NOSET_VISIBLE_DEVICES_ENV) != "1":
        env[CUDA_VISIBLE_DEVICES_ENV] = ids


def hide_gpus(env: dict) -> None:
    """A worker with no GPU grant sees no card: the counterpart of the JAX
    package's hard-set ``JAX_PLATFORMS=cpu`` on chipless workers."""
    env.pop(WORKER_GPUS_ENV, None)
    env[CUDA_VISIBLE_DEVICES_ENV] = ""


def current_worker_gpus() -> list[int]:
    """The GPUs the GCS bound to this worker process ([] for CPU workers)."""
    raw = os.environ.get(WORKER_GPUS_ENV, "")
    return [int(g) for g in raw.split(",") if g != ""]
