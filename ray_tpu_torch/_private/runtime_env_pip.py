"""pip runtime environments: isolated venvs keyed by requirements hash.

The port's copy of ray_tpu/_private/runtime_env_pip.py. A task/actor with
runtime_env={"pip": [...]} runs in a worker whose interpreter is a
virtualenv built from those requirements. Venvs are content-addressed by
the requirement list and cached per host in a 0700 per-user directory
(``<TMPDIR>/ray_tpu_torch_venvs_<uid>``, or ``RAY_TPU_TORCH_VENV_BASE``);
creation is flock-guarded so concurrent workers build once. Venvs inherit
the host's site-packages (--system-site-packages, plus a .pth bridge to the
building interpreter's own site-packages) so the machine's torch, with its
CUDA, stays importable and only the delta installs.

Requirement entries are requirements.txt lines, so pip global options
("--no-index", "--no-build-isolation", local paths) work — which is also
how hermetic/offline installs are expressed.

(reference: python/ray/_private/runtime_env/pip.py — per-node pip env
creation with caching and locking, delegated to the runtime-env agent.)
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import subprocess
import sys

PIP_TIMEOUT_S = 600.0


def secure_user_base(env_var: str, prefix: str) -> str:
    """Per-user 0700 cache directory (override via `env_var`). A fixed
    world-writable path would let another local user pre-plant an env at a
    predictable content hash that worker_boot would exec — shared hardening
    for every env cache (pip venvs, conda prefixes, the autoscaler's pid
    registry)."""
    import stat
    import tempfile

    base = os.environ.get(env_var) or os.path.join(
        tempfile.gettempdir(), f"{prefix}_{os.getuid()}")
    os.makedirs(base, mode=0o700, exist_ok=True)
    info = os.stat(base)
    if info.st_uid != os.getuid() or info.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
        raise RuntimeError(
            f"refusing env base {base!r}: not owned by uid {os.getuid()} "
            "or group/world-writable")
    return base


def venv_base() -> str:
    return secure_user_base("RAY_TPU_TORCH_VENV_BASE", "ray_tpu_torch_venvs")


def pip_hash(entries: list[str]) -> str:
    return hashlib.sha1(json.dumps(list(entries)).encode()).hexdigest()[:16]


def normalize_pip(spec) -> list[str]:
    """Accept list[str] or {"packages": [...]} (reference schema)."""
    if isinstance(spec, dict):
        spec = spec.get("packages") or []
    if isinstance(spec, str):
        spec = [spec]
    if not isinstance(spec, (list, tuple)) or not all(
            isinstance(x, str) for x in spec):
        raise TypeError("runtime_env['pip'] must be a list of requirement "
                        "strings or {'packages': [...]}")
    return list(spec)


def venv_site_dir(python: str) -> str:
    """The venv's own site-packages: its interpreter's purelib. (The last
    of ``site.getsitepackages()`` is a system dist-packages directory
    under a Debian-patched Python with --system-site-packages, where the
    bridge must not go.)"""
    code = "import sysconfig; print(sysconfig.get_path('purelib'))"
    return subprocess.run([python, "-c", code], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def ensure_venv(entries: list[str]) -> str:
    """Create (or reuse) the venv for `entries`; returns its python path."""
    h = pip_hash(entries)
    base = venv_base()
    dest = os.path.join(base, h)
    python = os.path.join(dest, "bin", "python")
    marker = os.path.join(dest, ".ready")
    if os.path.exists(marker):
        return python
    lock_path = os.path.join(base, f".{h}.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):  # another worker built it meanwhile
                return python
            subprocess.run(
                [sys.executable, "-m", "venv", "--system-site-packages",
                 dest],
                check=True, capture_output=True, timeout=PIP_TIMEOUT_S)
            # --system-site-packages exposes the BASE python's site dir; when
            # this interpreter is itself a venv (the usual deployment), the
            # host stack (setuptools, numpy, torch with its CUDA) lives in
            # THIS venv's site-packages — bridge it with a .pth so the child
            # env sees it (venv-local installs still shadow it: .pth paths
            # come later)
            import site

            parents = [p for p in site.getsitepackages() if os.path.isdir(p)]
            vsite = venv_site_dir(python)
            if vsite and parents:
                with open(os.path.join(vsite, "_ray_tpu_torch_parent.pth"),
                          "w") as f:
                    f.write("\n".join(parents) + "\n")
            # "--"-prefixed entries are pip CLI flags ("--no-index",
            # "--no-build-isolation", ...); the rest are requirement lines
            cli = [e for e in entries if e.startswith("--")]
            lines = [e for e in entries if not e.startswith("--")]
            reqs = os.path.join(dest, "requirements.txt")
            with open(reqs, "w") as f:
                f.write("\n".join(lines) + "\n")
            r = subprocess.run(
                [python, "-m", "pip", "install",
                 "--disable-pip-version-check", "--no-input", *cli,
                 "-r", reqs],
                capture_output=True, text=True, timeout=PIP_TIMEOUT_S)
            if r.returncode != 0:
                raise RuntimeError(
                    f"pip install for runtime_env failed:\n{r.stderr[-2000:]}")
            with open(marker, "w"):
                pass
            return python
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def interpreter_for(normalized_env: dict | None) -> str:
    """The python executable a worker with this runtime env must run under."""
    if normalized_env and normalized_env.get("pip"):
        return ensure_venv(normalized_env["pip"])
    return sys.executable
