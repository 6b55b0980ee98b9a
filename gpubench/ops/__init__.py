"""Operations: their FLOPs and bytes (``counts.py``) and the device
kernels that implement each.

A kernel belongs to an operation when a file ``kernels/<op>/<name>.txt``
exists and ``<name>`` is part of the kernel's name in the device trace. A
program that implements an operation with another kernel adds a file
there; the counts of the operation do not change, since they follow from
its shapes and not from the kernel.

A roofline share is the least time the card could take for the work,
max(FLOPs / peak FLOP/s, bytes / peak bytes/s), over the device time its
kernels took. Each input byte is counted read once and each output byte
written once. Where the trace holds no kernel of the operation there is
nothing to read, and the share is None, never 0.
"""

from __future__ import annotations

import os

from gpubench.common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

KERNELS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")


def kernel_names(op: str) -> list[str]:
    d = os.path.join(KERNELS, op)
    if not os.path.isdir(d):
        return []
    return sorted(f[:-4] for f in os.listdir(d) if f.endswith(".txt"))


def device_seconds(op: str, kernel_seconds: dict) -> float | None:
    """Device seconds of the operation's kernels in a trace's sums by
    kernel name; None where none of them ran."""
    names = kernel_names(op)
    hit = [s for k, s in kernel_seconds.items() if any(n in k for n in names)]
    return sum(hit) if hit else None


def bound_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def roofline_pct(work: list, seconds: float | None) -> float | None:
    """Share (%) of the roofline of `work` [(FLOPs, bytes), ...] in
    `seconds` of device time."""
    if not seconds or not work:
        return None
    return 100.0 * sum(bound_seconds(f, b) for f, b in work) / seconds
