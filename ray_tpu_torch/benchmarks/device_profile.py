"""Device-busy share of one step, from torch.profiler on a CUDA card
(reduced by ``util/device_trace.reduce``, as the engine's slices are)."""

from __future__ import annotations

import time
from typing import Callable

import torch

from ray_tpu_torch.util.device_trace import kernel_events, reduce

# kernel kinds by a substring of the device kernel's name, first match wins
KINDS = (("attention (csrc)", ("flash_", "ragged_")),
         ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
         ("optimizer", ("adam", "Adam")),
         ("reduction", ("reduce_kernel", "Reduce")),
         ("index", ("index", "gather", "scatter")),
         ("elementwise", ("elementwise", "CatArray", "copy")))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def busy_share(step: Callable[[], object]) -> dict:
    """Host wall time of one call of `step` against the device time its
    kernels add up to, from torch.profiler; the gap is time the device sits
    idle waiting on the host. Runs `step` twice (one warm-up). Also sums
    the device time by kernel kind (``KINDS``) and lists the heaviest
    kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        step()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    wall_ms = (t1 - t0) / 1e6
    red = reduce(kernel_events(prof), t0, t1)
    if not red["kernels"]:  # the profiler saw no device activity
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    by_name = {k: 1e3 * s for k, s in red["kernel_s"].items()}
    device_ms = sum(by_name.values())
    by_kind: dict = {}
    for name, ms in by_name.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_kernels": red["kernels"],
            "busy_share": device_ms / wall_ms,
            "device_ms_by_kind": dict(sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k, 1e3 * s] for k, s in red["top_kernels_s"]]}
