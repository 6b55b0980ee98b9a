"""Child-process teardown shared by the head Node and follower NodeAgent."""

from __future__ import annotations

import subprocess
import time


def drain_procs(procs, deadline_s: float = 3.0, reap_timeout_s: float = 2.0):
    """Wait for `procs` to exit within a shared deadline, SIGKILL the rest,
    then reap the killed stragglers. The reap matters: SIGKILL is async, and
    a worker mid-boot that outlives the store teardown that follows would
    recreate the just-unlinked arena segment. Kill-all-then-reap keeps the
    worst case one reap round-trip, not `reap_timeout_s` per straggler."""
    deadline = time.monotonic() + deadline_s
    stragglers = []
    for p in procs:
        try:
            p.wait(timeout=max(0.05, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            stragglers.append(p)
    for p in stragglers:
        try:
            p.wait(timeout=reap_timeout_s)
        except subprocess.TimeoutExpired:
            pass
