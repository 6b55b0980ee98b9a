"""ctypes binding for the native object-plane server (csrc/object_server.cc).

The port's copy of ray_tpu/_private/native_object_server.py over its own
copy of the JAX package's ``cpp/object_server.cc`` (symbols
``rtpt_objsrv_*``), built with g++ at first use into
``ray_tpu_torch/build/libobjserver.so`` (git-ignored). A failed build
raises: the Python server is never swapped in behind the caller's back.

The server streams sealed store files (tmpfs or spill tier) to other hosts
with zero Python on the hot path — the C++ counterpart of the reference's
object manager transfer plane (reference:
src/ray/object_manager/object_manager.h:128). Selected with
RAY_TPU_TORCH_OBJECT_SERVER_BACKEND=native; its addresses carry a "native:"
prefix so fetchers pick the binary codec per remote host.

Wire format (binary, little-endian):
  request:  [u32 oid_len][oid]
  response: [u64 size][payload]          (size == 2^64-1 → not found)
"""

from __future__ import annotations

import ctypes
import os
import socket
import struct
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "object_server.cc")
_LIB = os.path.join(os.path.dirname(__file__), "..", "build", "libobjserver.so")
_NOT_FOUND = (1 << 64) - 1

_build_lock = threading.Lock()
_lib = None


def _ensure_lib() -> ctypes.CDLL:
    """Build (if missing or older than its source) and load the library,
    once per process. A missing or broken toolchain raises."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        src, lib = os.path.abspath(_SRC), os.path.abspath(_LIB)
        if (not os.path.exists(lib)
                or os.path.getmtime(lib) < os.path.getmtime(src)):
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            tmp = lib + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src, "-lpthread"],
                check=True, capture_output=True)
            os.replace(tmp, lib)  # atomic: parallel builds don't collide
        dll = ctypes.CDLL(lib)
        dll.rtpt_objsrv_start.restype = ctypes.c_void_p
        dll.rtpt_objsrv_start.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_char_p, ctypes.c_int]
        dll.rtpt_objsrv_port.restype = ctypes.c_int
        dll.rtpt_objsrv_port.argtypes = [ctypes.c_void_p]
        dll.rtpt_objsrv_stop.argtypes = [ctypes.c_void_p]
        _lib = dll
        return dll


class NativeObjectServer:
    """Drop-in for ObjectPlaneServer when the store is file-backed."""

    def __init__(self, store, host: str | None = None):
        from ray_tpu_torch._private.object_store import (SHM_DIR,
                                                         ShmObjectStore)
        from ray_tpu_torch._private.ray_config import RayConfig

        if not isinstance(store, ShmObjectStore):
            raise ValueError(
                "the native object server serves file-backed stores; the "
                "arena backend keeps its own layout (use the python server)")
        self.bind_host = host or RayConfig.get("bind_host")
        self._dll = _ensure_lib()
        prefix = os.path.join(SHM_DIR, store.prefix)
        self._handle = self._dll.rtpt_objsrv_start(
            prefix.encode(), store.spill_dir.encode(),
            self.bind_host.encode(), 0)
        if not self._handle:
            raise OSError("native object server failed to start")
        self.port = self._dll.rtpt_objsrv_port(self._handle)

    @property
    def address(self) -> str:
        from ray_tpu_torch._private.object_transfer import _local_ip

        host = _local_ip() if self.bind_host == "0.0.0.0" else self.bind_host
        return f"native:{host}:{self.port}"

    def stop(self) -> None:
        if self._handle:
            self._dll.rtpt_objsrv_stop(self._handle)
            self._handle = None


def fetch_native(store, oid: str, host: str, port: int,
                 timeout: float = 60.0) -> "str | bool":
    """Client side of the binary protocol: pull one object into `store`.
    Returns the landing tier, or False on miss/error."""
    try:
        with socket.create_connection((host, port), timeout=timeout) as sock:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            raw = oid.encode()
            sock.sendall(struct.pack("<I", len(raw)) + raw)
            head = _recv_exact(sock, 8)
            if head is None:
                return False
            (size,) = struct.unpack("<Q", head)
            if size == _NOT_FOUND:
                return False
            parts = []
            got = 0
            while got < size:
                chunk = sock.recv(min(1 << 20, size - got))
                if not chunk:
                    return False
                parts.append(chunk)
                got += len(chunk)
        return store.put_parts(oid, parts, size) or "shm"
    except OSError:
        return False


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
