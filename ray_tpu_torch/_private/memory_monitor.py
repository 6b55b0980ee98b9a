"""Host memory monitor + worker-killing policy (OOM defense).

Watches host memory usage; past the threshold it kills a victim worker so
the kernel OOM killer never takes down the node agent / GCS with it. Victim
choice follows the reference's group-by-owner policy shape: prefer the
NEWEST retriable running task's worker (its lost work is the cheapest and it
can be retried), then leased direct-dispatch workers (their callers retry),
never infrastructure processes.

(reference: src/ray/common/memory_monitor.h:52 — usage polling with
threshold; src/ray/raylet/worker_killing_policy_group_by_owner.h:87 —
newest-retriable-first victim choice; VERDICT round-2 item 5.)

Enabled when RAY_TPU_TORCH_MEMORY_MONITOR_REFRESH_MS > 0 (the GCS enables it for
the head host, each node agent for its own host). Tests can fake the usage
reading via RAY_TPU_TORCH_TESTING_MEM_USAGE_FILE (a file holding a float 0..1).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable

logger = logging.getLogger(__name__)

_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def host_memory_usage() -> float:
    """Fraction of host memory in use (1 - MemAvailable/MemTotal)."""
    override = os.environ.get("RAY_TPU_TORCH_TESTING_MEM_USAGE_FILE")
    if override:
        try:
            return float(open(override).read().strip())
        except (OSError, ValueError):
            return 0.0
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = float(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total or avail is None:
        return 0.0
    return 1.0 - avail / total


def proc_rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * _PAGE
    except (OSError, ValueError, IndexError):
        return 0


class MemoryMonitor:
    """Generic monitor loop: `pick_victim()` returns (pid, describe) or
    None; `on_kill(pid, why)` is notified after a SIGKILL."""

    def __init__(self, *, threshold: float, period_s: float,
                 pick_victim: Callable, on_kill: Callable | None = None,
                 usage_fn: Callable[[], float] = host_memory_usage):
        self.threshold = threshold
        self.period_s = period_s
        self.pick_victim = pick_victim
        self.on_kill = on_kill
        self.usage_fn = usage_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")
        self.kills = 0

    def start(self) -> "MemoryMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                usage = self.usage_fn()
                if usage <= self.threshold:
                    continue
                victim = self.pick_victim()
                if victim is None:
                    continue
                pid, desc = victim
                why = (f"host memory usage {usage:.0%} exceeded the "
                       f"{self.threshold:.0%} threshold; killed {desc} "
                       f"(rss {proc_rss_bytes(pid) / 1e6:.0f} MB) to protect "
                       f"the node")
                # record the reason BEFORE the kill: death detection races
                # the callback otherwise and the task error loses its cause
                if self.on_kill is not None:
                    self.on_kill(pid, why)
                try:
                    os.kill(pid, 9)
                except (ProcessLookupError, PermissionError):
                    if self.on_kill is not None:
                        self.on_kill(pid, None)  # kill failed: clear it
                    continue
                self.kills += 1
                logger.warning(why)
                # give the death bookkeeping a beat before re-evaluating
                time.sleep(min(1.0, self.period_s * 2))
            except Exception:  # noqa: BLE001 — the monitor must survive
                logger.exception("memory monitor iteration failed")
