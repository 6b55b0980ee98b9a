"""Shared poll-with-backoff helper for host-plane rendezvous loops."""

from __future__ import annotations

import time
from typing import Any, Callable

_SLEEP_INIT = 0.0005
_SLEEP_CAP = 0.05


def poll_until(probe: Callable[[], Any], timeout: float | None, what: str) -> Any:
    """Call `probe` with exponential backoff until it returns non-None;
    raises TimeoutError(`what`) past `timeout` seconds (None = forever)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    sleep_s = _SLEEP_INIT
    while True:
        out = probe()
        if out is not None:
            return out
        if deadline is not None and time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(sleep_s)
        sleep_s = min(sleep_s * 2, _SLEEP_CAP)
