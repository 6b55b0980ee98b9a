"""Persistent GCS table storage — the fault-tolerance backend.

Reference capability: pluggable GCS metadata persistence
(src/ray/gcs/store_client/ — InMemoryStoreClient vs RedisStoreClient:126;
Redis mode lets the GCS restart and rebuild its managers from stored tables
via gcs_init_data.h). TPU build keeps it dependency-free: sqlite3 (stdlib)
in WAL mode, one table per GCS manager, write-through on every mutation.

Tables: kv (internal KV incl. jobs), actors (create specs of live actors),
pgs (placement-group specs), session (session metadata), instances
(autoscaler instance state machine — see autoscaler/instance_manager.py),
serve (serve control-plane state — see serve/controller.py recovery),
events (INFO+ cluster events — see _private/events.py; keyed by
zero-padded sequence number so restart recovery replays them in order).
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import threading
from typing import Any, Iterator, Optional


#: every persisted GCS table. The graft_check rpc-pairing checker verifies
#: that any table literal the GCS server reads/writes appears here, so a
#: handler can never target a table this module never created.
TABLES = ("kv", "actors", "pgs", "session", "instances", "serve", "events")


class GcsStorage:
    """Write-through table store. All methods are thread-safe."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        for table in TABLES:
            self._db.execute(
                f"CREATE TABLE IF NOT EXISTS {table} "
                "(key TEXT PRIMARY KEY, value BLOB)")
        self._db.commit()

    def put(self, table: str, key: str, value: Any) -> None:
        blob = pickle.dumps(value, protocol=5)
        with self._lock:
            self._db.execute(
                f"INSERT OR REPLACE INTO {table} (key, value) VALUES (?, ?)",
                (key, blob))
            self._db.commit()

    def get(self, table: str, key: str) -> Optional[Any]:
        with self._lock:
            row = self._db.execute(
                f"SELECT value FROM {table} WHERE key = ?", (key,)).fetchone()
        return pickle.loads(row[0]) if row else None

    def delete(self, table: str, key: str) -> None:
        with self._lock:
            self._db.execute(f"DELETE FROM {table} WHERE key = ?", (key,))
            self._db.commit()

    def items(self, table: str) -> Iterator[tuple[str, Any]]:
        with self._lock:
            rows = self._db.execute(
                f"SELECT key, value FROM {table}").fetchall()
        for k, v in rows:
            yield k, pickle.loads(v)

    def close(self) -> None:
        with self._lock:
            try:
                self._db.commit()
                self._db.close()
            except sqlite3.Error:
                pass
