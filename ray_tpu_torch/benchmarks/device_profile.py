"""Device-busy share of one step, from torch.profiler on a CUDA card."""

from __future__ import annotations

import time
from typing import Callable

import torch

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
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        # user annotations (e.g. "Optimizer.step#AdamW.step") also sit on
        # the device timeline, spanning kernels counted on their own
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            n_kernels += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    if not n_kernels:  # the profiler saw no device activity
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    device_ms = sum(by_name.values())
    by_kind: dict = {}
    for name, ms in by_name.items():
        by_kind[kind_of(name)] = by_kind.get(kind_of(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_kernels": n_kernels, "busy_share": device_ms / wall_ms,
            "device_ms_by_kind": dict(sorted(by_kind.items(),
                                             key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k[:160], v] for k, v in top]}
