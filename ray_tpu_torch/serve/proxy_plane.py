"""Sharded proxy plane: shared-port ingress + shm routing-table broadcast.

Three substrate pieces for the horizontally-sharded serve ingress
(controller.py manages the fleet, proxy.py runs inside each shard):

- **shared-port accept sharding** — N proxy worker processes accept on ONE
  TCP port. Primary mechanism is ``SO_REUSEPORT`` (each shard binds its own
  listen socket; the kernel hashes incoming connections across them, so a
  SIGKILLed shard only drops its own accepted connections). Where the
  platform lacks ``SO_REUSEPORT``, the fallback is a single acceptor
  socket whose fd is passed to every shard over a unix socket
  (``ListenerFdDonor`` / ``receive_listener_fd``) — all shards then accept
  from the same kernel queue. (reference: uvicorn/gunicorn's reuse-port
  worker model; Ray Serve runs one proxy per node and scales across nodes,
  here we shard within the node the same way.)

- **seqlock routing-table broadcast** (``RoutingTableShm``) — the
  controller publishes its versioned deployment→replica table into one
  /dev/shm segment; proxy shards read it without ever blocking on a
  controller RPC. Single writer, many readers: the writer bumps the
  sequence to odd, rewrites the payload, bumps to even; a reader snapshots
  the sequence, copies, and retries if the sequence moved (same
  total-store-order reasoning as MutableShmChannel's header — aligned
  8-byte stores via struct.pack_into on an mmap, publish-last). The
  segment is stale-tolerant by construction: during a controller outage
  the file (and the last published table) remains readable, so shards
  keep routing exactly like the version-cached RPC path does.

- **port reservation** — when the caller asks for port 0, something must
  pin the concrete port before N shards can bind it. ``reserve_port``
  binds (without listening) with SO_REUSEPORT set; a bound-but-not-
  listening socket receives no connections, so holding it open reserves
  the number without stealing traffic from the listening shards.
"""

from __future__ import annotations

import json
import logging
import mmap
import os
import socket
import struct
import threading
import time

from ray_tpu_torch._private.constants import SHM_DIR, SHM_ROUTING_PREFIX

logger = logging.getLogger(__name__)

#: SO_REUSEPORT exists on Linux >= 3.9 and the BSDs; absent elsewhere
#: (and on very old kernels) the plane degrades to fd-passing.
REUSEPORT_AVAILABLE = hasattr(socket, "SO_REUSEPORT")

#: fd-passing needs the 3.9+ SCM_RIGHTS convenience wrappers.
FDPASS_AVAILABLE = hasattr(socket, "send_fds") and hasattr(socket, "recv_fds")


def routing_segment_path(nonce: str) -> str:
    """Canonical /dev/shm path of one plane generation's routing segment
    (creator = controller, readers = proxy shards, leak sweeps glob
    SHM_ROUTING_GLOB)."""
    return os.path.join(SHM_DIR, f"{SHM_ROUTING_PREFIX}{nonce}")


# ------------------------------------------------------------ routing table


class RoutingTableShm:
    """Single-writer many-reader seqlock broadcast of the routing table.

    Header (64-byte padded, like MutableShmChannel's): seq (odd while a
    publish is in progress), table version, payload length, publish
    wall-clock timestamp. Payload is the JSON routing table — JSON, not
    pickle: readers in any process can parse it without trusting the
    segment's bytes as executable, and the table is plain strings/ints.

    The writer republishes every reconcile pass (same version when nothing
    changed), so ``published_ts`` doubles as a controller heartbeat: the
    reader-side age gauge (`ray_tpu_serve_routing_table_age_seconds`)
    climbing means the controller stopped reconciling, not that routes are
    merely quiet.
    """

    _HDR = struct.Struct("<qqqd")  # seq, version, plen, published_ts
    _HDR_SIZE = 64                 # padded: payload starts cacheline-clear
    _F_SEQ = struct.Struct("<q")
    _F_TS = struct.Struct("<d")

    def __init__(self, path: str, capacity: int, _create: bool = False):
        self.path = path
        self.capacity = capacity
        size = self._HDR_SIZE + capacity
        if _create:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            except BaseException:
                # O_EXCL burned the name: roll the file back too, or a
                # half-created segment leaks with no owning handle
                os.close(fd)
                try:
                    os.unlink(path)
                except OSError:
                    pass
                raise
            os.close(fd)
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                # attach at the file's actual size: readers need not know
                # the creator's capacity out of band
                actual = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, actual)
                self.capacity = actual - self._HDR_SIZE
            finally:
                os.close(fd)
        self._seq = self._hdr()[0]  # writer-local (always even at rest)

    # --------------------------------------------------------------- header

    def _hdr(self):
        return self._HDR.unpack_from(self._mm, 0)

    def peek(self) -> tuple[int, float]:
        """(version, published_ts) from one header unpack — the per-request
        staleness probe. May observe a mid-publish header; callers only use
        it to DECIDE whether to do a validated full read."""
        _seq, ver, _n, ts = self._hdr()
        return ver, ts

    # ---------------------------------------------------------------- write

    def publish(self, table: dict, version: int | None = None) -> None:
        """Publish one table snapshot (writer side — the controller)."""
        payload = json.dumps(table, separators=(",", ":")).encode()
        if len(payload) > self.capacity:
            raise ValueError(
                f"routing table {len(payload)}B exceeds segment capacity "
                f"{self.capacity}B (raise RayConfig.serve_routing_shm_bytes)")
        ver = int(table.get("version", -1) if version is None else version)
        seq = self._seq
        # odd seq = publish in progress: readers spin/retry instead of
        # parsing a torn payload. TSO makes the store order below safe
        # without fences (same argument as mutable_shm.py's header).
        self._F_SEQ.pack_into(self._mm, 0, seq + 1)
        self._mm[self._HDR_SIZE:self._HDR_SIZE + len(payload)] = payload
        self._HDR.pack_into(self._mm, 0, seq + 1, ver, len(payload),
                            time.time())
        self._F_SEQ.pack_into(self._mm, 0, seq + 2)  # publish LAST
        self._seq = seq + 2

    # ----------------------------------------------------------------- read

    def read(self, known_version: int = -1):
        """(table, version, published_ts), or (None, version, ts) when the
        published version equals ``known_version`` (reader already has it).
        Retries on seqlock conflict; a writer mid-publish costs microseconds,
        so the retry budget only trips if the segment is corrupt."""
        backoff = 0
        while True:
            seq1, ver, plen, ts = self._hdr()
            if not seq1 & 1:
                if ver == known_version:
                    if self._hdr()[0] == seq1:  # stable: genuinely unchanged
                        return None, ver, ts
                elif 0 <= plen <= self.capacity:
                    data = bytes(self._mm[self._HDR_SIZE:
                                          self._HDR_SIZE + plen])
                    if self._hdr()[0] == seq1:
                        return json.loads(data) if plen else None, ver, ts
            backoff += 1
            if backoff > 200:
                raise TimeoutError(
                    "routing-table seqlock read kept colliding "
                    f"(seq={seq1}) — segment corrupt or writer wedged")
            if backoff > 50:
                time.sleep(0.0002)

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        try:
            self._mm.close()
        except (OSError, ValueError, BufferError):
            pass  # already closed / buffers still exported: name cleanup
            #       (unlink) is what matters for leak sweeps

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __del__(self):
        try:
            self._mm.close()
        except (OSError, ValueError, BufferError, AttributeError):
            pass  # partially-constructed instance or already closed
        if getattr(self, "_creator", False):
            # creator GC backstop: existing reader mappings stay valid per
            # POSIX, the NAME (and tmpfs bytes on last unmap) is reclaimed
            self.unlink()


def create_routing_shm(nonce: str, capacity: int) -> RoutingTableShm:
    """Create (controller side) the plane generation's routing segment. If
    a previous incarnation's file survives (controller crash-restart), it
    is ATTACHED, not replaced: live proxy readers keep their mapping of
    the same inode, so an unlink+recreate would silently split the plane
    into two segments."""
    path = routing_segment_path(nonce)
    try:
        seg = RoutingTableShm(path, capacity, _create=True)
    except FileExistsError:
        seg = RoutingTableShm(path, capacity)
    seg._creator = True
    return seg


def attach_routing_shm(nonce: str) -> RoutingTableShm | None:
    """Attach (proxy side) read/write-mapped but only ever read. None when
    the segment is gone — callers fall back to controller-RPC refresh."""
    try:
        return RoutingTableShm(routing_segment_path(nonce), 0)
    except OSError:
        return None


# -------------------------------------------------------------- listen side


def make_listen_socket(host: str, port: int, *,
                       reuse_port: bool = False) -> socket.socket:
    """A bound+listening TCP socket for one proxy shard (or for the
    fd-passing donor). With ``reuse_port`` every shard binds its own
    socket to the same (host, port) and the kernel load-balances accepts."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            if not REUSEPORT_AVAILABLE:
                raise OSError("SO_REUSEPORT not available on this platform")
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
        sock.listen(1024)
    except BaseException:
        sock.close()
        raise
    return sock


def reserve_port(host: str, port: int) -> socket.socket:
    """Pin a concrete port for the reuse-port fleet without serving from
    it: bound with SO_REUSEPORT but NEVER listening, so the kernel routes
    no connections here while the bind keeps the number from being handed
    to anyone who doesn't set SO_REUSEPORT. The caller holds the socket
    open for the plane's lifetime and closes it on teardown."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if REUSEPORT_AVAILABLE:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
    except BaseException:
        sock.close()
        raise
    return sock


class ListenerFdDonor:
    """Fallback acceptor-sharing for hosts without SO_REUSEPORT: the plane
    owner binds ONE listen socket and serves dup'd fds to shard processes
    over a unix socket (SCM_RIGHTS); every shard then accepts from the
    same kernel queue. One donation per connection — the protocol is
    connect → receive fd → close."""

    def __init__(self, listen_sock: socket.socket, uds_path: str):
        if not FDPASS_AVAILABLE:
            raise OSError("socket.send_fds/recv_fds not available")
        self._sock = listen_sock
        self.uds_path = uds_path
        try:
            os.unlink(uds_path)
        except OSError:
            pass
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._srv.bind(uds_path)
            self._srv.listen(16)
        except BaseException:
            self._srv.close()
            raise
        self._stopped = False
        self._thread = threading.Thread(target=self._serve_loop, daemon=True,
                                        name="serve-proxy-fd-donor")
        self._thread.start()

    def _serve_loop(self):
        while not self._stopped:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # close() shut the server socket
            try:
                socket.send_fds(conn, [b"lfd"], [self._sock.fileno()])
            except OSError as e:
                logger.debug("listener-fd donation failed: %r", e)
            finally:
                conn.close()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def close(self) -> None:
        """Stop donating and release the acceptor. Shards holding received
        fds keep serving their established connections; new connections
        stop once the last copy of the listen fd closes."""
        self._stopped = True
        try:
            self._srv.close()
        except OSError:
            pass
        try:
            os.unlink(self.uds_path)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def receive_listener_fd(uds_path: str, timeout: float = 10.0) -> socket.socket:
    """Shard side of the fd-passing fallback: fetch the shared listen
    socket from the donor. The returned socket object owns a dup of the
    donor's fd (closing it does not close the donor's)."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        c.settimeout(timeout)
        c.connect(uds_path)
        _msg, fds, _flags, _addr = socket.recv_fds(c, 16, 4)
    finally:
        c.close()
    if not fds:
        raise RuntimeError(f"no listener fd received from {uds_path}")
    sock = socket.socket(fileno=fds[0])
    for extra in fds[1:]:  # defensive: the donor only ever sends one
        os.close(extra)
    return sock
