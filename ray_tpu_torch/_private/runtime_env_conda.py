"""conda runtime environments: named envs or spec-created envs per worker.

The port's copy of ray_tpu/_private/runtime_env_conda.py.

runtime_env={"conda": "existing-env-name"} runs the worker under that
conda env's interpreter; {"conda": {"dependencies": [...]}} creates (and
caches, keyed by spec hash) a prefix env under the session base.

(reference: python/ray/_private/runtime_env/conda.py — get_conda_activate
commands + per-job env creation keyed by a hash of the spec. Same model:
creation happens in the WORKER process (worker_boot), never the scheduler
thread; the conda binary is discovered from $CONDA_EXE/PATH and its
absence is a clear user error, not a crash.)
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess


def conda_base() -> str:
    from ray_tpu_torch._private.runtime_env_pip import secure_user_base

    return secure_user_base("RAY_TPU_TORCH_CONDA_ENV_BASE", "ray_tpu_torch_conda")


def find_conda(conda_exe: str | None = None) -> str:
    exe = (conda_exe or os.environ.get("CONDA_EXE")
           or shutil.which("conda") or shutil.which("mamba")
           or shutil.which("micromamba"))
    if not exe:
        raise RuntimeError(
            "runtime_env['conda'] requires a conda/mamba binary on the "
            "worker host (none on PATH and $CONDA_EXE unset)")
    return exe


def normalize_conda(spec) -> str | dict:
    """Named env → str; inline spec → canonical
    {dependencies: [...], channels?: [...]}. Unknown keys are rejected —
    silently dropping e.g. channels would build a DIFFERENT env than the
    user asked for and collide cache hashes across channel lists."""
    if isinstance(spec, str):
        return spec
    if isinstance(spec, dict):
        extra = set(spec) - {"dependencies", "channels", "name"}
        if extra:
            raise TypeError(
                f"unsupported conda spec keys {sorted(extra)} (supported: "
                "dependencies, channels, name)")
        deps = spec.get("dependencies")
        if not isinstance(deps, list) or not deps:
            raise TypeError(
                "runtime_env['conda'] dict needs a non-empty "
                "'dependencies' list (conda environment.yml schema)")
        out = {"dependencies": _canon_deps(deps)}
        channels = spec.get("channels")
        if channels:
            if not all(isinstance(c, str) for c in channels):
                raise TypeError("conda 'channels' must be strings")
            out["channels"] = list(channels)  # ORDER is priority: keep it
        return out
    raise TypeError("runtime_env['conda'] must be an env name (str) or an "
                    "environment.yml-style dict")


def _canon_deps(deps: list):
    out = []
    for d in deps:
        if isinstance(d, str):
            out.append(d)
        elif isinstance(d, dict) and list(d) == ["pip"]:
            out.append({"pip": sorted(str(x) for x in d["pip"])})
        else:
            raise TypeError(f"unsupported conda dependency entry {d!r}")
    # plain entries sort; a pip sub-dict stays last (conda requirement)
    plain = sorted(x for x in out if isinstance(x, str))
    pips = [x for x in out if isinstance(x, dict)]
    return plain + pips


def conda_hash(normalized) -> str:
    return hashlib.sha1(
        json.dumps(normalized, sort_keys=True).encode()).hexdigest()[:16]


def _env_yaml(normalized: dict) -> str:
    """environment.yml text from the canonical spec (hand-rendered: the
    schema subset here is flat lists, no yaml dependency needed)."""
    lines = []
    if normalized.get("channels"):
        lines.append("channels:")
        lines.extend(f"  - {c}" for c in normalized["channels"])
    lines.append("dependencies:")
    for d in normalized["dependencies"]:
        if isinstance(d, str):
            lines.append(f"  - {d}")
        else:
            lines.append("  - pip:")
            for p in d["pip"]:
                lines.append(f"      - {p}")
    return "\n".join(lines) + "\n"


def _prefix_python(prefix: str) -> str:
    return os.path.join(prefix, "bin", "python")


def ensure_conda_env(spec, *, conda_exe: str | None = None,
                     runner=subprocess.run) -> str:
    """Return the interpreter path for this conda runtime env, creating a
    prefix env on first use for inline specs. `runner` is injectable so
    the command construction is testable without a conda install."""
    normalized = normalize_conda(spec)
    exe = find_conda(conda_exe)
    if isinstance(normalized, str):
        # named env: ask conda where it lives (works for -n registered envs)
        r = runner([exe, "run", "-n", normalized, "python", "-c",
                    "import sys; print(sys.executable)"],
                   capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise RuntimeError(
                f"conda env {normalized!r} not usable:\n{r.stderr[-1000:]}")
        return r.stdout.strip().splitlines()[-1]
    import fcntl

    h = conda_hash(normalized)
    base = conda_base()
    prefix = os.path.join(base, h)
    python = _prefix_python(prefix)
    marker = prefix + ".ready"
    if os.path.exists(marker):
        return python
    # flock so concurrent workers with the same spec build the env once
    # (mirrors runtime_env_pip.ensure_venv)
    with open(os.path.join(base, f"{h}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return python
            yml = os.path.join(base, f"{h}.yml")
            with open(yml, "w") as f:
                f.write(_env_yaml(normalized))
            r = runner([exe, "env", "create", "--yes", "-p", prefix,
                        "-f", yml],
                       capture_output=True, text=True, timeout=1200)
            if r.returncode != 0:
                raise RuntimeError(
                    f"conda env create failed:\n{r.stderr[-2000:]}")
            with open(marker, "w") as f:
                f.write("ok")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return python
