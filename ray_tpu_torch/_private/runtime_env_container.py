"""Container runtime environments: workers run inside an image.

The port's copy of ray_tpu/_private/runtime_env_container.py, and the one
place the worker spawn argv is built (the head's and the followers'
spawners both call ``build_worker_argv``): every worker boots
``python -m ray_tpu_torch._private.worker_main``, or the
``worker_boot`` shim when its env needs a pip venv or a conda prefix.

runtime_env={"image_uri": "docker.io/org/img:tag"} wraps the worker
process in `podman run` (or docker — discovered from PATH, override via
RAY_TPU_TORCH_CONTAINER_ENGINE), mounting the session directory (sockets,
logs, shm object files) and the ray_tpu_torch source so the containerized
worker joins the same cluster. As in the reference, no device is passed
into the container: the image's worker sees the cards its engine grants.

(reference: python/ray/_private/runtime_env/image_uri.py — worker
processes run under `podman run` with the session dir mounted; same
contract here, argv construction kept pure so it's testable without a
container engine.)
"""

from __future__ import annotations

import os
import shutil

WORKER_MAIN = "ray_tpu_torch._private.worker_main"


def find_engine(engine: str | None = None) -> str:
    exe = (engine or os.environ.get("RAY_TPU_TORCH_CONTAINER_ENGINE")
           or shutil.which("podman") or shutil.which("docker"))
    if not exe:
        raise RuntimeError(
            "runtime_env['image_uri'] requires a container engine "
            "(podman or docker) on the worker host — none found on PATH "
            "and $RAY_TPU_TORCH_CONTAINER_ENGINE unset")
    return exe


def normalize_image_uri(uri) -> str:
    if not isinstance(uri, str) or not uri.strip():
        raise TypeError("runtime_env['image_uri'] must be a non-empty "
                        "image reference string")
    return uri.strip()


def container_argv(image_uri: str, worker_argv: list, env: dict, *,
                   session_dir: str, engine: str,
                   extra_mounts: tuple = ()) -> list:
    """The full `engine run ...` argv for one worker process. Pure
    function of its inputs (reference behavior: image_uri.py builds a
    podman command with --env/-v and host networking)."""
    argv = [engine, "run", "--rm", "--network=host", "--ipc=host",
            "--pid=host"]
    # the session dir carries the GCS socket, logs, and /dev/shm-backed
    # object files the worker must share with the host cluster
    mounts = [session_dir, "/dev/shm", _repo_root(), *extra_mounts]
    for m in mounts:
        argv += ["-v", f"{m}:{m}"]
    for k in sorted(env):
        argv += ["--env", f"{k}={env[k]}"]
    pkg_parent = _repo_root()
    pp_parts = [pkg_parent] + [p for p in
                               env.get("PYTHONPATH", "").split(os.pathsep)
                               if p]  # no empty entries: "" = cwd on sys.path
    argv += ["--env", "PYTHONPATH=" + os.pathsep.join(pp_parts)]
    argv += ["--workdir", session_dir]
    argv.append(image_uri)
    worker_argv = list(worker_argv)
    # the HOST interpreter path doesn't exist inside the image: the image
    # provides the python (with the framework's deps); PATH resolves it
    if worker_argv and os.path.isabs(worker_argv[0]) \
            and os.path.basename(worker_argv[0]).startswith("python"):
        worker_argv[0] = "python3"
    argv += worker_argv
    return argv


def build_worker_argv(runtime_env: dict | None, env: dict,
                      session_dir: str, entry: str) -> list:
    """The spawn argv for one worker given its runtime env — shared by the
    head-node and follower-agent spawners so entry selection and container
    wrapping stay in ONE place."""
    import sys

    argv = [sys.executable, "-m", entry]
    if runtime_env and runtime_env.get("image_uri"):
        argv = container_argv(runtime_env["image_uri"], argv, env,
                              session_dir=session_dir, engine=find_engine())
    return argv


def boot_entry(runtime_env: dict | None) -> str:
    """worker_boot (env built in the worker) vs worker_main (direct)."""
    if runtime_env and (runtime_env.get("pip") or runtime_env.get("conda")):
        return "ray_tpu_torch._private.worker_boot"
    return WORKER_MAIN


def _repo_root() -> str:
    """Directory containing the ray_tpu_torch package (mounted so the
    container runs the same framework code as the host)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
