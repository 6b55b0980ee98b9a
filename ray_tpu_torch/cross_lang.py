"""Cross-language task calls: invoke REGISTERED native-worker functions.

(reference: ray.cross_language / the C++ worker API — tasks target
functions by NAME so any driver can call into a C++ worker; args/results
are restricted to language-neutral values. Here that wire format is JSON
frames on the port's control plane; ``csrc/cpp_worker.cc`` is the worker.)

    h = ray_tpu_torch.cpp_function("add")
    ray_tpu_torch.get(h.remote(2, 3))  # -> 5  (computed in C++)

`start_cpp_worker()` builds (g++, cached by mtime in
``ray_tpu_torch/build/``) and launches the bundled worker binary against the
current session — production deployments run the binary themselves,
linking their own function registrations.
"""

from __future__ import annotations

import math
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "cpp_worker.cc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
_build_lock = threading.Lock()


def _check_jsonable(v, path="arg"):
    """Deep-validate a cross-language value: JSON types only, finite
    floats, string keys. A nested reject must fail HERE at call time —
    inside the GCS dispatch flush it would abort the whole send pass."""
    if v is None or isinstance(v, (bool, str, int)):
        return
    if isinstance(v, float):
        if not math.isfinite(v):
            raise TypeError(f"{path}: non-finite float {v!r} is not "
                            "JSON-encodable")
        return
    if isinstance(v, (list, tuple)):
        for i, x in enumerate(v):
            _check_jsonable(x, f"{path}[{i}]")
        return
    if isinstance(v, dict):
        for k, x in v.items():
            if not isinstance(k, str):
                raise TypeError(f"{path}: dict keys must be str, got "
                                f"{type(k).__name__}")
            _check_jsonable(x, f"{path}[{k!r}]")
        return
    raise TypeError(
        f"{path}: cross-language args must be JSON-encodable; got "
        f"{type(v).__name__} (wrap arrays as lists)")


class CppFunction:
    """Handle to a named function registered in cross-language workers."""

    def __init__(self, name: str, *, num_cpus: float = 1.0):
        self.name = name
        self.num_cpus = num_cpus

    def remote(self, *args):
        from ray_tpu_torch._private.api import _get_worker

        for i, a in enumerate(args):
            _check_jsonable(a, f"args[{i}]")
        return _get_worker().submit_cross_lang_task(
            self.name, list(args), lang="cpp",
            resources={"CPU": float(self.num_cpus)})

    def options(self, *, num_cpus: float | None = None) -> "CppFunction":
        return CppFunction(self.name,
                           num_cpus=self.num_cpus if num_cpus is None
                           else num_cpus)


def cpp_function(name: str) -> CppFunction:
    return CppFunction(name)


def ensure_cpp_worker_binary() -> str:
    """Build csrc/cpp_worker.cc into ray_tpu_torch/build/ once (rebuilt when
    the source is newer than the binary); returns the binary path."""
    binary = os.path.abspath(os.path.join(_BUILD_DIR, "cpp_worker"))
    src = os.path.abspath(_SRC)
    with _build_lock:
        if (os.path.exists(binary)
                and os.path.getmtime(binary) >= os.path.getmtime(src)):
            return binary
        os.makedirs(os.path.dirname(binary), exist_ok=True)
        tmp = binary + f".tmp{os.getpid()}"
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", tmp, src],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, binary)  # atomic: concurrent builders don't collide
    return binary


def start_cpp_worker(address: str | None = None) -> subprocess.Popen:
    """Launch the bundled C++ worker joined to the current session (or an
    explicit GCS host:port address)."""
    if address is None:
        import ray_tpu_torch._private.api as _api

        node = _api._node
        if node is None:
            raise RuntimeError("ray_tpu_torch.init() first (or pass address=)")
        address = node.address
    binary = ensure_cpp_worker_binary()
    return subprocess.Popen([binary, "--address", address])
