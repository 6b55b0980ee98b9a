"""Cross-host object plane: chunked pull of shm objects over TCP.

The port's copy of ray_tpu/_private/object_transfer.py. Every host of a
session runs one `ObjectPlaneServer` in front of its local store; a worker
that needs a remote object dials the owning host's server, streams the
payload in chunks into its own store, seals it, and registers the new copy
with the GCS — pull-on-demand with per-object dedup, the same semantics as
the reference's node-to-node transfer plane
(reference: src/ray/object_manager/object_manager.h:128 — chunked push/pull,
default 5 MiB chunks; pull_manager.h:50 admission/dedup).
"""

from __future__ import annotations

import logging
import socket
import threading

from ray_tpu_torch._private.protocol import (
    ConnectionClosed,
    MsgConnection,
    connect_tcp,
    listen_tcp,
)

logger = logging.getLogger(__name__)

from ray_tpu_torch._private.ray_config import RayConfig as _RayConfig

CHUNK = _RayConfig.get("object_transfer_chunk")


def make_object_server(store, host: str | None = None):
    """Backend selector: RAY_TPU_TORCH_OBJECT_SERVER_BACKEND=native runs the
    C++ server (csrc/object_server.cc) for file-backed stores; default is
    the in-process Python server below. The arena backend keeps its own
    layout, which the C++ server cannot read: there the Python server
    serves, with a logged warning."""
    from ray_tpu_torch._private.ray_config import RayConfig

    if RayConfig.get("object_server_backend") == "native":
        from ray_tpu_torch._private.native_object_server import (
            NativeObjectServer)
        from ray_tpu_torch._private.object_store import ShmObjectStore

        if isinstance(store, ShmObjectStore):
            return NativeObjectServer(store, host)
        logger.warning("native object server needs the file store backend; "
                       "falling back to the python server")
    return ObjectPlaneServer(store, host)


class ObjectPlaneServer:
    """Serves local shm objects to other hosts. One thread per connection
    (an agent/worker keeps its connection open and pipelines fetches)."""

    def __init__(self, store, host: str | None = None):
        import os

        self.store = store
        # loopback by default; RAY_TPU_TORCH_BIND_HOST=0.0.0.0 for real multi-host
        from ray_tpu_torch._private.ray_config import RayConfig

        self.bind_host = host or RayConfig.get("bind_host")
        self.sock = listen_tcp(self.bind_host, 0)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="objsrv-accept")
        self._thread.start()

    @property
    def address(self) -> str:
        host = _local_ip() if self.bind_host == "0.0.0.0" else self.bind_host
        return f"{host}:{self.port}"

    def stop(self):
        # shutdown-not-close: freeing the fd while the accept thread may be
        # entering accept(2) lets a new listener reuse the fd number and
        # leak its connections to this stopped server (see GcsServer.stop)
        self._stop = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:  # wake accept() even where shutdown() on a listener doesn't
            s = socket.create_connection(("127.0.0.1", self.port), timeout=0.2)
            s.close()
        except OSError:
            pass

    def _accept_loop(self):
        while not self._stop:
            try:
                raw, _ = self.sock.accept()
            except OSError:
                break
            if self._stop:
                try:
                    raw.close()
                except OSError:
                    pass
                break
            conn = MsgConnection(raw)
            threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="objsrv-conn").start()
        try:
            self.sock.close()  # sole closer of the listener fd
        except OSError:
            pass

    def _serve(self, conn: MsgConnection):
        try:
            while True:
                msg = conn.recv()
                if msg.get("type") != "fetch":
                    conn.send({"ok": False, "error": f"bad request {msg.get('type')}"})
                    continue
                oid = msg["oid"]
                try:
                    obj = self.store.get(oid)
                except (FileNotFoundError, OSError):
                    conn.send({"ok": False, "error": "not found"})
                    continue
                try:
                    # chunked sends straight off the pinned view: the pin
                    # keeps the arena run alive under concurrent eviction,
                    # no staging copy of the whole object is ever made
                    buf = obj.buf
                    size = buf.nbytes if hasattr(buf, "nbytes") else len(buf)
                    conn.send({"ok": True, "size": size})
                    for off in range(0, size, CHUNK):
                        conn.send({"data": bytes(buf[off:off + CHUNK])})
                finally:
                    # arena objects pin until released (file objects GC with
                    # obj); release even on a broken send, or the pin leaks
                    # and wedges eviction for the whole session
                    if hasattr(obj, "release"):
                        obj.release()
        except ConnectionClosed:
            pass
        except Exception:
            logger.exception("object plane connection failed")
        finally:
            try:
                conn.close()
            except Exception:
                pass


class ObjectFetcher:
    """Per-process client side: cached connections, per-object in-flight
    dedup (two threads needing the same remote object fetch it once)."""

    def __init__(self, store):
        self.store = store
        self._conns: dict[str, MsgConnection] = {}
        self._lock = threading.Lock()
        self._inflight: dict[str, threading.Event] = {}
        # one request/response conversation per connection at a time — two
        # threads interleaving frames on one socket would cross-read payloads
        self._addr_locks: dict[str, threading.Lock] = {}

    def fetch(self, oid: str, address: str) -> "str | bool":
        """Pull `oid` from the object server at `address` into the local
        store. Returns the landing tier ("shm"/"spill") on a fresh pull,
        True when already/concurrently fetched, False on failure. Safe to
        call concurrently."""
        with self._lock:
            if self.store.contains(oid):
                return True
            ev = self._inflight.get(oid)
            if ev is None:
                self._inflight[oid] = ev = threading.Event()
                owner = True
            else:
                owner = False
        if not owner:
            ev.wait(timeout=300)
            return self.store.contains(oid)
        try:
            ok = self._fetch_once(oid, address)
        finally:
            ev.set()
            with self._lock:
                self._inflight.pop(oid, None)
        return ok

    def _fetch_once(self, oid: str, address: str) -> "str | bool":
        with self._lock:
            alock = self._addr_locks.setdefault(address, threading.Lock())
        with alock:
            return self._fetch_conversation(oid, address)

    def _fetch_conversation(self, oid: str, address: str) -> "str | bool":
        if address.startswith("native:"):
            # remote host runs the C++ server: binary codec, one connection
            # per fetch (the server is cheap-threaded; keep the client simple)
            from ray_tpu_torch._private.native_object_server import (
                fetch_native)

            host, _, port = address[len("native:"):].rpartition(":")
            return fetch_native(self.store, oid, host or "127.0.0.1",
                                int(port))
        try:
            conn = self._conn(address)
            conn.send({"type": "fetch", "oid": oid})
            head = conn.recv()
            if not head.get("ok"):
                return False
            size = head["size"]
            parts = []
            got = 0
            while got < size:
                frame = conn.recv()
                data = frame["data"]
                parts.append(data)
                got += len(data)
            tier = self.store.put_parts(oid, parts, size)
            return tier or "shm"
        except (ConnectionClosed, OSError, KeyError):
            with self._lock:
                self._conns.pop(address, None)
            return False

    def _conn(self, address: str) -> MsgConnection:
        with self._lock:
            conn = self._conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        host, _, port = address.rpartition(":")
        conn = connect_tcp(host, int(port), timeout=10.0)
        with self._lock:
            self._conns[address] = conn
        return conn


def _local_ip() -> str:
    """Best-effort routable IP of this host (falls back to loopback)."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"
