"""Cross-host object plane: the head host's object server.

The port's copy of the serving half of ray_tpu/_private/object_transfer.py.
Every host of a session runs one `ObjectPlaneServer` in front of its local
store, serving shm objects in chunks over TCP (reference:
src/ray/object_manager/object_manager.h:128 — chunked push/pull, default
5 MiB chunks). The port runs on one host: the pulling side (the JAX
package's ``ObjectFetcher``) and the follower hosts that would use it are
not ported yet (ROADMAP.md Queue 1 item 17).
"""

from __future__ import annotations

import logging
import socket
import threading

from ray_tpu_torch._private.protocol import (
    ConnectionClosed,
    MsgConnection,
    listen_tcp,
)

from ray_tpu_torch.exceptions import _not_ported

logger = logging.getLogger(__name__)

from ray_tpu_torch._private.ray_config import RayConfig as _RayConfig

CHUNK = _RayConfig.get("object_transfer_chunk")


def make_object_server(store, host: str | None = None):
    """The head host's object-plane server (the in-process Python server
    below). RAY_TPU_TORCH_OBJECT_SERVER_BACKEND=native (the JAX package's
    C++ server) is not ported: ROADMAP.md Queue 1 item 17."""
    from ray_tpu_torch._private.ray_config import RayConfig

    if RayConfig.get("object_server_backend") == "native":
        raise _not_ported("the native object server", "item 17")
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
