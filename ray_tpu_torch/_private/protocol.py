"""Framed message protocol over unix-domain sockets.

Wire format: 8-byte little-endian length + pickled dict. Every message is a
dict with a "type" key; RPCs carry "rid" (request id) and replies mirror it.
This plays the role of the reference's gRPC + flatbuffers IPC planes
(reference: src/ray/rpc/grpc_server.h, src/ray/flatbuffers/node_manager.fbs)
collapsed into one socket protocol — adequate intra-node; a real RPC layer can
slot in per-message-type later without changing callers.
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import struct
import threading
import time

_LEN = struct.Struct("<Q")
MAX_FRAME = 1 << 34


class ConnectionClosed(Exception):
    pass


class _Chaos:
    """Test-only fault injection, off unless env-configured (reference:
    src/ray/rpc/rpc_chaos.h:24, env RAY_testing_rpc_failure).

    RAY_TPU_TORCH_TESTING_MSG_DROP="type_a,type_b:0.2" drops listed outbound
    message types with the given probability; RAY_TPU_TORCH_TESTING_MSG_DELAY_MS=N
    sleeps up to N ms before every send (latency/reordering pressure).
    """

    def __init__(self):
        self.drop_types: set[str] = set()
        self.drop_prob = 0.0
        self.delay_ms = 0.0
        spec = os.environ.get("RAY_TPU_TORCH_TESTING_MSG_DROP", "")
        if spec:
            types, _, prob = spec.partition(":")
            self.drop_types = {t for t in types.split(",") if t}
            self.drop_prob = float(prob or 0.1)
        self.delay_ms = float(os.environ.get("RAY_TPU_TORCH_TESTING_MSG_DELAY_MS", "0") or 0)
        self.enabled = bool(self.drop_types or self.delay_ms)

    def intercept(self, msg: dict) -> bool:
        """True → drop the message."""
        if self.delay_ms:
            time.sleep(random.random() * self.delay_ms / 1000.0)
        return (msg.get("type") in self.drop_types
                and random.random() < self.drop_prob)


_chaos = _Chaos()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionClosed()
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


# language-neutral frame payload marker: "\0JSN" + UTF-8 JSON. Pickles
# can never start with a NUL byte (proto>=2 starts \x80; proto 0/1 with a
# printable opcode), so recv() can auto-detect the codec per frame —
# that's what lets non-Python workers (cpp/cpp_worker.cc) speak the same
# control plane.
_JSON_MAGIC = b"\x00JSN"


class MsgConnection:
    """Thread-safe framed connection; one reader, many writers."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self.closed = False
        self.codec = "pickle"  # "json" for language-neutral peers

    def send(self, msg: dict) -> None:
        if _chaos.enabled and _chaos.intercept(msg):
            return  # injected drop
        if self.codec == "json":
            import json as _json

            data = _JSON_MAGIC + _json.dumps(msg).encode()
        else:
            data = pickle.dumps(msg, protocol=5)
        if len(data) > MAX_FRAME:
            raise ValueError(f"frame too large: {len(data)}")
        with self._send_lock:
            try:
                self.sock.sendall(_LEN.pack(len(data)) + data)
            except (BrokenPipeError, ConnectionResetError, OSError) as e:
                self.closed = True
                raise ConnectionClosed() from e

    def recv(self) -> dict:
        try:
            header = _recv_exact(self.sock, 8)
            (n,) = _LEN.unpack(header)
            data = _recv_exact(self.sock, n)
        except (ConnectionResetError, OSError) as e:
            self.closed = True
            raise ConnectionClosed() from e
        if data[:4] == _JSON_MAGIC:
            import json as _json

            return _json.loads(data[4:])
        return pickle.loads(data)

    def close(self) -> None:
        self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def connect_unix(path: str, timeout: float = 30.0) -> MsgConnection:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect(path)
    sock.settimeout(None)
    return MsgConnection(sock)


def listen_unix(path: str) -> socket.socket:
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        import os

        os.unlink(path)
    except OSError:
        pass
    sock.bind(path)
    sock.listen(256)
    return sock


def connect_tcp(host: str, port: int, timeout: float = 30.0) -> MsgConnection:
    """TCP variant of the framed connection — the cross-host control plane
    (reference capability: gRPC services, src/ray/rpc/grpc_server.h)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return MsgConnection(sock)


def listen_tcp(host: str = "0.0.0.0", port: int = 0) -> socket.socket:
    """Listening TCP socket; port 0 picks a free port (read via getsockname)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(256)
    return sock


def parse_address(address: str) -> tuple[str, str | tuple[str, int]]:
    """'unix:<path>' → ("unix", path); 'host:port' or 'tcp:host:port' →
    ("tcp", (host, port))."""
    if address.startswith("unix:"):
        return "unix", address[len("unix:"):]
    if address.startswith("tcp:"):
        address = address[len("tcp:"):]
    host, _, port = address.rpartition(":")
    return "tcp", (host or "127.0.0.1", int(port))


def connect_address(address: str, timeout: float = 30.0) -> MsgConnection:
    if address.startswith("proxy://"):
        # Ray-Client-style proxied connection: versioned handshake, then a
        # per-client relay bridges this socket to the GCS
        # (util/client/proxier.py)
        import socket as _socket
        import uuid as _uuid

        from ray_tpu_torch.util.client.proxier import client_handshake

        host, _, port = address[len("proxy://"):].rpartition(":")
        sock = _socket.create_connection((host or "127.0.0.1", int(port)),
                                         timeout=timeout)
        client_handshake(sock, client_id=_uuid.uuid4().hex[:12])
        sock.settimeout(None)
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        return MsgConnection(sock)
    kind, target = parse_address(address)
    if kind == "unix":
        return connect_unix(target, timeout)
    return connect_tcp(target[0], target[1], timeout)
