"""Device traces from torch.profiler, reduced: a slice's kernels
(``kernel_events``, on the ``time.time_ns()`` clock) and its device busy
and idle time, with the idle put down to the host's phases (``reduce``).
``LLMEngine.stop_profile`` returns the reduction of its own slice, and
``benchmarks/device_profile.busy_share`` that of one step."""

from __future__ import annotations

import bisect

import torch

TOP = 12  # heaviest kernels a reduction names


def kernel_events(prof, cuda: bool = True) -> list:
    """(name, start_ns, end_ns) of every device activity (kernel, memcpy,
    memset) a stopped profiler recorded, or with ``cuda=False`` of every
    CPU op, on the ``time.time_ns()`` clock. User annotations (e.g.
    "Optimizer.step#AdamW.step") also sit on the device timeline, spanning
    kernels counted on their own, and are left out."""
    want = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == want and not e.is_user_annotation()]


def reduce(events: list, t0_ns: int, t1_ns: int, spans=()) -> dict:
    """A slice [t0_ns, t1_ns] of ``kernel_events``: its length, the busy
    seconds as the union of the events' intervals (two streams that overlap
    count once), the idle rest, each event name's seconds and the heaviest.
    `spans` are the host's (phase, start_ns, end_ns), in order and not
    overlapping: each idle interval is cut at their bounds and each piece
    put down to the phase open at its start, ``outside`` where none was
    (``idle_s_by_phase``, which sums to ``idle_s``); ``phase_s`` is each
    phase's host seconds."""
    by_name: dict = {}
    busy = []
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        s, e = max(s, t0_ns), min(e, t1_ns)
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    idle, at = [], t0_ns
    for s, e in busy:
        if s > at:
            idle.append((at, s))
        at = e
    if t1_ns > at:
        idle.append((at, t1_ns))
    spans = sorted(spans, key=lambda sp: sp[1])
    ends = [sp[2] for sp in spans]
    by_phase: dict = {}
    for a, b in idle:
        covered = 0
        i = bisect.bisect_right(ends, a)
        while i < len(spans) and spans[i][1] < b:
            phase, s, e = spans[i]
            piece = min(b, e) - max(a, s)
            if piece > 0:
                by_phase[phase] = by_phase.get(phase, 0) + piece
                covered += piece
            i += 1
        if b - a > covered:
            by_phase["outside"] = by_phase.get("outside", 0) + b - a - covered
    phase_s: dict = {}
    for phase, s, e in spans:
        phase_s[phase] = phase_s.get(phase, 0.0) + (e - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (t1_ns - t0_ns) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "idle_s": sum(b - a for a, b in idle) / 1e9,
            "kernels": len(events),
            "idle_s_by_phase": {k: v / 1e9 for k, v in sorted(
                by_phase.items(), key=lambda kv: -kv[1])},
            "phase_s": dict(sorted(phase_s.items(), key=lambda kv: -kv[1])),
            "kernel_s": by_name,
            "top_kernels_s": [[k[:160], v] for k, v in top]}
