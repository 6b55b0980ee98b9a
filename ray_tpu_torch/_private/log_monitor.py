"""Log monitor: tail worker log files and republish lines to the driver.

(reference capability: python/ray/_private/log_monitor.py — a per-node
process tails `session_latest/logs/*` and publishes through GCS pubsub to
every driver; here the driver runs the tailer in-process over the session's
log dir, which covers the single-host layout. The follower-node agent runs
its own tailer and forwards over the wire — see node agent.)
"""

from __future__ import annotations

import os
import sys
import threading
import time


class LogMonitor:
    """Polls `<session>/logs/*.log` for appended bytes; emits each complete
    line to `sink(source, line)`. Default sink prints to stderr in the
    reference's `(worker-N pid=…)` style."""

    def __init__(self, log_dir: str, sink=None, poll_interval_s: float = 0.25):
        self.log_dir = log_dir
        self.sink = sink or self._default_sink
        self.poll_interval_s = poll_interval_s
        self._offsets: dict[str, int] = {}
        self._partial: dict[str, bytes] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="log-monitor")

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        self._poll()  # final drain so shutdown doesn't eat tail lines

    @staticmethod
    def _default_sink(source: str, line: str):
        print(f"({source}) {line}", file=sys.stderr)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self._poll()
            except Exception:
                pass  # session dir may vanish at shutdown
            self._stop.wait(self.poll_interval_s)

    def _poll(self):
        try:
            names = sorted(os.listdir(self.log_dir))
        except OSError:
            return
        for name in names:
            if not name.endswith(".log"):
                continue
            path = os.path.join(self.log_dir, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            off = self._offsets.get(name, 0)
            if size <= off:
                continue
            try:
                with open(path, "rb") as f:
                    f.seek(off)
                    data = f.read(size - off)
            except OSError:
                continue
            self._offsets[name] = off + len(data)
            buf = self._partial.pop(name, b"") + data
            *lines, rest = buf.split(b"\n")
            if rest:
                self._partial[name] = rest
            source = name[:-len(".log")]
            for raw in lines:
                line = raw.decode("utf-8", "replace")
                if line.strip():
                    self.sink(source, line)
