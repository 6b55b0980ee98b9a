"""What every part of the harness shares: where its files are, seeds,
the environment of a run, the device's description and the result line."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".gpubench_cache")

# H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core rate and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


class HarnessError(RuntimeError):
    """A run that cannot produce a result: no card, a missing file, a
    forbidden import. The run exits non-zero and prints no result line."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise HarnessError(f"no BENCHMARK.json beside {HERE}")
    return load_json(path)


def named_file(kind: str, name: str, ext: str = ".json") -> str:
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.exists(path):
        raise HarnessError(f"no {kind} file for {name!r} ({path})")
    return path


def metric_file(name: str) -> str:
    """A per-layer metric's reader: ``metrics/<name>.py``, else the one
    that serves the quantity in every cell, ``metrics/<name less its last
    .<part>>.py`` (``idle_share.py`` reads ``idle_share.chat``)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if "." in name and not os.path.exists(path):
        shared = os.path.join(HERE, "metrics",
                              name.rsplit(".", 1)[0] + ".py")
        if os.path.exists(shared):
            return shared
    return named_file("metrics", name, ".py")


def load_module(path: str, name: str):
    """Import a harness file by path (metric readers carry dots in their
    names, so they are not importable as modules)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sub_seed(seed: int, *keys) -> int:
    """A 63-bit seed derived from the run's seed and a purpose, so that each
    stream (weights of one leaf, one step's batch, the traffic) is drawn
    independently and can be redrawn alone."""
    h = hashlib.blake2b(repr((int(seed),) + tuple(keys)).encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def process_start_time() -> float:
    """Wall-clock start of this process (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def prepare_environment() -> None:
    """Caches inside the checkout at fixed paths, the checkout on the path
    of every process the runtime starts, and no JAX through a library."""
    os.makedirs(CACHE, exist_ok=True)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    paths = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
             if p]
    if ROOT not in paths:
        os.environ["PYTHONPATH"] = os.pathsep.join([ROOT] + paths)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``ray_tpu_torch`` is not ``ray_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def require_cards(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise HarnessError("torch.cuda.is_available() is false: the "
                           "benchmark measures a CUDA card")
    if torch.cuda.device_count() < chips:
        raise HarnessError(f"the cell needs {chips} cards, "
                           f"torch.cuda.device_count() is "
                           f"{torch.cuda.device_count()}")


def strict_json(x):
    """`x` with every non-finite float as None: the line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: strict_json(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [strict_json(v) for v in x]
    return x


def emit(result: dict, checks: dict) -> dict:
    """Each compared number beside its limit, last on stderr, and the
    result's one JSON line last on stdout, with the checks last in it."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    line = strict_json(dict(result, checks=checks))
    print(json.dumps(line, allow_nan=False), flush=True)
    return line


class Clock:
    """perf_counter stamps of a run's phases (CLOCK_MONOTONIC: the same
    clock in every process of the host)."""

    def __init__(self):
        self.wall_start = process_start_time()
        self.mono_at_start = time.perf_counter() - (time.time()
                                                    - self.wall_start)

    def since_start(self, t_mono: float) -> float:
        return t_mono - self.mono_at_start

    def mark(self, what: str) -> None:
        """A phase's end on stderr, so that a run cut short shows where."""
        print(f"gpubench: {self.since_start(time.perf_counter()):.1f} s "
              f"{what}", file=sys.stderr, flush=True)


def watchdog(seconds: float):
    """After `seconds`, print every thread's stack, stop the runtime's
    workers and exit with code 3: a run never outlives its allowance."""
    import faulthandler
    import threading

    def fire():
        print(f"gpubench: no result after {seconds:.0f} s", file=sys.stderr)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        rt = sys.modules.get("ray_tpu_torch")
        try:
            if rt is not None:
                rt.shutdown()
        finally:
            os._exit(3)

    t = threading.Timer(seconds, fire)
    t.daemon = True
    t.start()
    return t
