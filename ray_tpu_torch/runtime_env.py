"""Runtime environments: per-task/actor env_vars, working_dir, py_modules.

Reference capability: python/ray/_private/runtime_env/ — the per-node
runtime-env agent materializes envs before worker start
(agent/runtime_env_agent.py:165, GetOrCreateRuntimeEnv:303), packages
working_dir/py_modules into content-addressed zips cached by URI
(packaging.py, uri_cache.py).

The port's copy of ray_tpu/runtime_env.py: the driver normalizes + hashes
the env, packages directories into zips stored in the GCS KV
(content-addressed — the URI cache), and the scheduler spawns workers whose
process env matches the task's runtime-env hash; worker_main materializes
the env (extract zips, set cwd/sys.path) before executing anything. pip
(and its ``uv`` spelling), conda and container (``image_uri``) envs are
normalized here and built on the worker's host (the worker_boot shim and
the per-host runtime-env agent).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import zipfile
from typing import Any, Optional

from ray_tpu_torch._private.constants import temp_root

_PKG_PREFIX = "renv_pkg:"  # GCS KV key prefix for packaged zips
MAX_PACKAGE_BYTES = 512 * 1024 * 1024


def _zip_dir(path: str) -> bytes:
    """Deterministic zip of a directory tree (sorted entries, zeroed mtimes
    so the content hash is stable across machines)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs.sort()
            if "__pycache__" in dirs:
                dirs.remove("__pycache__")
            for name in sorted(files):
                full = os.path.join(root, name)
                rel = os.path.relpath(full, path)
                info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
                info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
                with open(full, "rb") as f:
                    zf.writestr(info, f.read())
    data = buf.getvalue()
    if len(data) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes "
            f"(limit {MAX_PACKAGE_BYTES})")
    return data


def _content_uri(data: bytes) -> str:
    return hashlib.sha1(data).hexdigest()[:20]


def package(runtime_env: dict, kv_put, kv_get) -> dict:
    """Normalize a user runtime_env: upload working_dir / py_modules as
    content-addressed zips (skipping uploads the KV already has — the URI
    cache) and replace paths with pkg URIs. Returns the normalized env."""
    env = dict(runtime_env or {})
    out: dict[str, Any] = {}
    ev = env.pop("env_vars", None)
    if ev:
        if not all(isinstance(k, str) and isinstance(v, str)
                   for k, v in ev.items()):
            raise TypeError("runtime_env['env_vars'] must be Dict[str, str]")
        out["env_vars"] = dict(sorted(ev.items()))
    wd = env.pop("working_dir", None)
    if wd:
        out["working_dir"] = _upload_dir(wd, kv_put, kv_get)
    mods = env.pop("py_modules", None)
    if mods:
        out["py_modules"] = [_upload_dir(m, kv_put, kv_get) for m in mods]
    pip_spec = env.pop("pip", None)
    if pip_spec is None:
        pip_spec = env.pop("uv", None)  # uv schema: same requirement lines
    if pip_spec:
        from ray_tpu_torch._private.runtime_env_pip import normalize_pip

        out["pip"] = normalize_pip(pip_spec)
    conda_spec = env.pop("conda", None)
    if conda_spec is not None:
        if pip_spec:
            raise ValueError(
                "runtime_env cannot set both 'pip' and 'conda' (the conda "
                "spec's dependencies list takes pip sub-entries instead)")
        from ray_tpu_torch._private.runtime_env_conda import normalize_conda

        out["conda"] = normalize_conda(conda_spec)
    image = env.pop("image_uri", None)
    if image is not None:
        from ray_tpu_torch._private.runtime_env_container import (
            normalize_image_uri)

        out["image_uri"] = normalize_image_uri(image)
    if env:
        raise ValueError(f"unsupported runtime_env keys: {sorted(env)} "
                         "(supported: env_vars, working_dir, py_modules, "
                         "pip, uv, conda, image_uri)")
    return out


def _upload_dir(path: str, kv_put, kv_get) -> str:
    if isinstance(path, str) and path.startswith("pkg:"):
        return path  # already packaged (e.g. env reused across submissions)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env path {path!r} is not a directory")
    data = _zip_dir(path)
    uri = _content_uri(data)
    key = _PKG_PREFIX + uri
    if kv_get(key) is None:  # URI cache hit check
        kv_put(key, data)
    return f"pkg:{uri}"


def env_hash(normalized: Optional[dict]) -> str:
    """Stable fingerprint used to key worker-pool compatibility (reference:
    worker pool keyed by runtime-env hash, worker_pool.h)."""
    if not normalized:
        return ""
    return hashlib.sha1(
        json.dumps(normalized, sort_keys=True).encode()).hexdigest()[:16]


def materialize(normalized: dict, kv_get) -> dict:
    """Worker-side: download + extract packages, returning
    {"env_vars": ..., "cwd": path|None, "sys_path": [paths]}.
    Extraction is cached per-URI under <temp_root>/runtime_envs (shared across workers
    on the host; the .ready marker makes concurrent extraction safe)."""
    result = {"env_vars": normalized.get("env_vars") or {},
              "cwd": None, "sys_path": []}
    wd = normalized.get("working_dir")
    if wd:
        result["cwd"] = _ensure_extracted(wd, kv_get)
        result["sys_path"].append(result["cwd"])
    for m in normalized.get("py_modules") or ():
        result["sys_path"].append(_ensure_extracted(m, kv_get))
    return result


def _ensure_extracted(pkg_uri: str, kv_get) -> str:
    uri = pkg_uri.split(":", 1)[1]
    dest = os.path.join(temp_root(), "runtime_envs", uri)
    marker = dest + ".ready"
    if os.path.exists(marker):
        return dest
    data = kv_get(_PKG_PREFIX + uri)
    if data is None:
        raise RuntimeError(f"runtime_env package {pkg_uri} not found in GCS")
    tmp = dest + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, dest)
    except OSError:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)  # another worker won the race
    with open(marker, "w"):
        pass
    return dest


def apply_to_process(normalized: dict, kv_get) -> None:
    """Apply a runtime env to THIS process (worker_main calls it before the
    exec loop; reference: worker started through the runtime-env agent)."""
    import sys

    mat = materialize(normalized, kv_get)
    os.environ.update(mat["env_vars"])
    for p in reversed(mat["sys_path"]):
        if p not in sys.path:
            sys.path.insert(0, p)
    if mat["cwd"]:
        os.chdir(mat["cwd"])
