"""The device trace of a slice of the window, reduced where it was taken.

``torch.profiler`` records the CUDA kernels only (no CPU ops, whose
recording would slow the host-bound step it is meant to observe). The
reduction keeps, for the slice: the host-clock length, the device-busy
seconds as the union of kernel intervals (kernels on two streams that
overlap count once), the seconds of each kernel name, the kernel count,
and the longest idle gaps, each named by the kernel that ended it, which
is what the host was launching when the device went idle.
"""

from __future__ import annotations

import time

TOP = 10


class Slice:
    """A profiled slice; on a machine without CUDA (the harness's CPU
    tests) it records the CPU ops in the kernels' place."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        self.cuda = torch.cuda.is_available()
        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.start()
        self.t0 = time.perf_counter()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def stop(self) -> float:
        """Ends the slice; returns its end. The reduction (``read``) can
        wait until the window has closed."""
        self.sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        return self.t1

    def read(self) -> dict:
        return reduce(kernel_events(self.torch, self.prof), self.t0, self.t1)


def kernel_events(torch, prof) -> list:
    """(name, start_ns, end_ns) of every device kernel of the trace (of
    every CPU op where CUDA is absent)."""
    cuda = torch.autograd.DeviceType.CUDA if torch.cuda.is_available() \
        else torch.autograd.DeviceType.CPU
    try:
        return [(e.name(), e.start_ns(), e.end_ns())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == cuda and not e.is_user_annotation()]
    except AttributeError:  # an older profiler: its FunctionEvents
        pass
    out = []
    for e in prof.events():
        if e.device_type == cuda and not getattr(e, "is_user_annotation", False):
            out.append((e.name, int(e.time_range.start * 1000),
                        int(e.time_range.end * 1000)))
    return out


def reduce(events: list, t0: float, t1: float) -> dict:
    by_name: dict = {}
    gaps = []
    busy_ns = 0
    cur_s = cur_e = None
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_ns += cur_e - cur_s
                gaps.append(((s - cur_e) / 1e9, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    gaps.sort(key=lambda g: -g[0])
    by_gap: dict = {}
    for sec, name in gaps:
        key = f"before {short(name)}"
        by_gap[key] = by_gap.get(key, 0.0) + sec
    return {"t0": t0, "t1": t1, "window_s": t1 - t0, "busy_s": busy_ns / 1e9,
            "kernels": len(events), "kernel_s": by_name,
            "longest_gaps": [[f"before {short(n)}", s] for s, n in gaps[:TOP]],
            "gap_s_by_next": sorted(by_gap.items(), key=lambda kv: -kv[1])}


def short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters, at most 120 characters."""
    s = name.removeprefix("void ")
    base = s.split("<", 1)[0]
    if not base.startswith("("):  # "(anonymous namespace)::f" keeps it
        base = base.split("(", 1)[0]
    return (base or s)[:120]


def breakdown(tr: dict) -> dict:
    by_short: dict = {}
    for k, v in tr["kernel_s"].items():
        by_short[short(k)] = by_short.get(short(k), 0.0) + v
    ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [list(kv) for kv in ops],
            "idle_gaps": [list(g) for g in tr["gap_s_by_next"][:TOP]]}
