"""Binary RPC ingress: the gRPC-equivalent data plane for Serve.

Reference capability: Serve's gRPC proxy alongside HTTP
(reference: serve/_private/proxy.py:530 gRPCProxy, serve/grpc_util.py) —
typed binary calls into deployments without HTTP framing overhead.

Here the framed message protocol (protocol.py) doubles as the wire
format — one `RPCProxyActor` per cluster accepts TCP connections carrying
{"app", "method", "payload"} frames, routes through the same
DeploymentHandle plane as HTTP, and streams multi-part responses for
generator endpoints. `RPCClient` is the matching client stub.
"""

from __future__ import annotations

import pickle
import threading

import ray_tpu_torch
from ray_tpu_torch._private.protocol import (
    ConnectionClosed,
    MsgConnection,
    connect_tcp,
    listen_tcp,
)


@ray_tpu_torch.remote
class RPCProxyActor:
    """(reference: proxy.py gRPCProxy — one per node; here one per cluster,
    num_cpus=0 so it never competes with replicas.)"""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.sock = listen_tcp(host, port)
        self.host = host
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="rpc-ingress")
        self._thread.start()

    def address(self) -> tuple:
        if self.host == "0.0.0.0":
            import socket as _socket

            return (_socket.gethostbyname(_socket.gethostname()), self.port)
        return (self.host, self.port)

    def _accept_loop(self):
        while not self._stop:
            try:
                raw, _ = self.sock.accept()
            except OSError:
                return
            conn = MsgConnection(raw)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="rpc-conn").start()

    def _serve(self, conn: MsgConnection):
        from ray_tpu_torch.serve.api import get_app_handle

        try:
            while True:
                msg = conn.recv()
                rid = msg.get("rid")
                try:
                    handle = get_app_handle(msg.get("app") or "default")
                    if msg.get("method"):
                        handle = getattr(handle, msg["method"])
                    payload = pickle.loads(msg["payload"])
                    if msg.get("stream"):
                        for item in handle.options(stream=True).remote(payload):
                            conn.send({"rid": rid, "chunk": pickle.dumps(item)})
                        conn.send({"rid": rid, "done": True})
                    else:
                        result = handle.remote(payload).result(timeout_s=120)
                        conn.send({"rid": rid, "ok": True,
                                   "payload": pickle.dumps(result)})
                except ConnectionClosed:
                    raise
                except Exception as e:  # noqa: BLE001 — surface to the caller
                    try:
                        conn.send({"rid": rid, "ok": False, "error": repr(e)})
                    except ConnectionClosed:
                        raise
        except ConnectionClosed:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass  # peer already reset the socket

    def stop(self):
        self._stop = True
        try:
            self.sock.close()
        except OSError:
            pass


class RPCClient:
    """Client stub for the RPC ingress (reference: the generated gRPC stubs
    over serve's RayServeAPIService)."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._host, self._port = host, int(port)
        self._conn = connect_tcp(host, int(port), timeout=timeout)
        self._rid = 0
        self._lock = threading.Lock()
        self._streaming = False  # a framed stream owns the connection

    def _begin(self) -> int:
        if self._streaming:
            raise RuntimeError(
                "an in-progress stream owns this RPCClient connection; "
                "exhaust or close() the stream generator first (or use a "
                "second RPCClient for concurrent calls)")
        self._rid += 1
        return self._rid

    def call(self, data, *, app: str = "default", method: str | None = None):
        with self._lock:
            rid = self._begin()
            self._conn.send({"rid": rid, "app": app, "method": method,
                             "payload": pickle.dumps(data)})
            reply = self._conn.recv()
        if not reply.get("ok"):
            raise RuntimeError(f"rpc call failed: {reply.get('error')}")
        return pickle.loads(reply["payload"])

    def stream(self, data, *, app: str = "default", method: str | None = None):
        """Yield streamed chunks from a generator endpoint. The connection
        is owned by the stream until it finishes: an abandoned generator
        drains the remaining frames on close so later calls never read
        stale chunks (framed protocol = strictly serial per connection)."""
        with self._lock:
            rid = self._begin()
            self._streaming = True
            self._conn.send({"rid": rid, "app": app, "method": method,
                             "payload": pickle.dumps(data), "stream": True})
        done = False
        try:
            while True:
                reply = self._conn.recv()
                if reply.get("done"):
                    done = True
                    return
                if "error" in reply:
                    done = True  # server sent no further frames
                    raise RuntimeError(f"rpc stream failed: {reply['error']}")
                yield pickle.loads(reply["chunk"])
        finally:
            if not done:
                # abandoned mid-stream: drain briefly; an unbounded stream
                # never sends 'done', so past the deadline we RESET the
                # connection — the server's next send fails and it stops
                # producing (the cancellation signal)
                drained = False
                try:
                    self._conn.sock.settimeout(2.0)
                    while True:
                        reply = self._conn.recv()
                        if reply.get("done") or "error" in reply:
                            drained = True
                            break
                except (ConnectionClosed, OSError):
                    pass
                if drained:
                    self._conn.sock.settimeout(None)
                else:
                    try:
                        self._conn.close()
                    except OSError:
                        pass  # reset is the point: server stops producing
                    self._conn = connect_tcp(self._host, self._port,
                                             timeout=30.0)
            self._streaming = False

    def close(self):
        try:
            self._conn.close()
        except OSError:
            pass  # already closed/reset: close() stays idempotent


_INGRESS_NAME = "_serve_rpc_ingress"


def start_rpc_ingress(host: str = "127.0.0.1", port: int = 0):
    """Start (or return) the cluster's RPC ingress actor; returns
    (actor_handle, (host, port)). One per cluster, by name."""
    created = False
    try:
        proxy = ray_tpu_torch.get_actor(_INGRESS_NAME, namespace="_system")
    except ValueError:
        try:
            proxy = RPCProxyActor.options(
                name=_INGRESS_NAME, namespace="_system", num_cpus=0,
                max_concurrency=32).remote(host, port)
            created = True
        except ValueError:
            proxy = ray_tpu_torch.get_actor(_INGRESS_NAME, namespace="_system")  # lost the create race
    addr = ray_tpu_torch.get(proxy.address.remote())
    if not created and ((host not in ("127.0.0.1", addr[0]))
                        or (port not in (0, addr[1]))):
        raise ValueError(
            f"RPC ingress already running at {addr[0]}:{addr[1]}; cannot "
            f"rebind to {host}:{port} (stop the existing ingress first)")
    return proxy, addr
