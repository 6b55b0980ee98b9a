"""Mutable shared-memory SPSC channel: zero control-plane hops per message.

The port's copy of ray_tpu/experimental/channel/mutable_shm.py, with the
raw-frame methods the PD KV transfer plane uses (``write_vectored``,
``read_view`` + ``ack_read``). The serializer-backed ``write``/``read``
go through the runtime's serializer and wait for the runtime's port.

One writer and one reader on the SAME host map one /dev/shm buffer; a
seqlock-style header synchronizes them: the writer waits until the reader
consumed the previous payload (write_seq == read_seq), writes bytes, bumps
write_seq; the reader waits for write_seq > read_seq, reads, bumps
read_seq.

Ordering note: header fields are 8-byte-aligned int64s written via
struct.pack_into on an mmap; x86-64's total-store-order makes the
payload-then-len-then-seq write sequence safe without explicit fences.

One difference from the JAX package: the creator reserves the segment's
pages with ``posix_fallocate`` after ``ftruncate``. A sparse tmpfs file
that outgrows a full /dev/shm kills the writer with SIGBUS on the first
store past the limit; reserved up front, the same shortage is an OSError
at create time.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
import uuid

from ray_tpu_torch._private.constants import SHM_CHANNEL_PREFIX, SHM_DIR
from ray_tpu_torch.experimental.channel.channel import ChannelClosed

_HDR = struct.Struct("<qqqq")  # write_seq, read_seq, payload_len, closed
_HDR_SIZE = 64  # padded: keep the data region cacheline-separated
_DIR = SHM_DIR


class MutableShmChannel:
    """Single-producer single-consumer; both ends must be on one host."""

    def __init__(self, path: str, capacity: int, _create: bool = False):
        self.path = path
        self.capacity = capacity
        if _create:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, _HDR_SIZE + capacity)
                os.posix_fallocate(fd, 0, _HDR_SIZE + capacity)
                self._mm = mmap.mmap(fd, _HDR_SIZE + capacity)
            except BaseException:
                # the O_EXCL create already took the NAME: closing only the
                # fd would leave a file no handle will ever unlink
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
                self._mm = mmap.mmap(fd, _HDR_SIZE + capacity)
            finally:
                os.close(fd)

    # ------------------------------------------------------------- header

    _FIELD = struct.Struct("<q")
    _OFF = {"write_seq": 0, "read_seq": 8, "plen": 16, "closed": 24}

    def _hdr(self):
        return _HDR.unpack_from(self._mm, 0)

    def _set(self, **fields):
        # one aligned 8-byte store per field: a read-modify-write of the
        # whole header could resurrect a flag the peer just set (e.g. its
        # close() racing our plen update)
        for name, val in fields.items():
            self._FIELD.pack_into(self._mm, self._OFF[name], val)

    def _wait(self, check, timeout: float | None, what: str):
        # `check` takes one header tuple. The deadline is checked BEFORE
        # any sleep, so timeout=0 is a true non-blocking probe. A short
        # spin, then sleeps that grow while the channel is quiet; any
        # header progress drops the sleep back to the lowest tier.
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        slept_since = None
        snap = None
        while True:
            hdr = self._hdr()
            if check(hdr):
                return
            if hdr != snap:
                snap = hdr
                slept_since = None  # progress: reset the sleep escalation
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(what)
            spins += 1
            if spins <= 100:  # spin briefly, then yield the core
                continue
            now = time.monotonic()
            if slept_since is None:
                slept_since = now
            quiet = now - slept_since
            time.sleep(50e-6 if quiet < 0.002
                       else (200e-6 if quiet < 0.02
                             else (1e-3 if quiet < 0.25 else 5e-3)))

    # ---------------------------------------------------------------- api

    def poll(self) -> bool:
        """Non-blocking: True iff a payload is ready to read."""
        w, r, _n, _c = self._hdr()
        return w > r

    def closed(self) -> bool:
        """Non-blocking: True iff a peer flipped the closed flag. An unread
        payload may still be pending: poll() first if the stream should be
        drained before treating the close as death."""
        _w, _r, _n, c = self._hdr()
        return bool(c)

    def drained(self) -> bool:
        """Non-blocking: True iff at least one payload was published and
        every published payload was consumed."""
        w, r, _n, _c = self._hdr()
        return w > 0 and r >= w

    def write_vectored(self, parts, timeout: float | None = 60.0) -> None:
        """Write the concatenation of ``parts`` (bytes-like) as ONE payload
        without materializing the join (PD KV pages: header + raw page
        bytes)."""
        total = sum(len(memoryview(p).cast("B")) for p in parts)
        if total > self.capacity:
            raise ValueError(
                f"payload {total}B exceeds channel capacity "
                f"{self.capacity}B (pick buffer_bytes at create time)")

        def writable(hdr):
            w, r, _n, c = hdr
            if c:
                raise ChannelClosed("channel closed")
            return w == r  # previous payload consumed

        self._wait(writable, timeout,
                   "channel write timed out (reader too slow)")
        off = _HDR_SIZE
        for p in parts:
            b = memoryview(p).cast("B")
            self._mm[off:off + len(b)] = b
            off += len(b)
        w, _r, _n, _c = self._hdr()
        self._set(plen=total)
        self._set(write_seq=w + 1)  # publish LAST (TSO: payload visible)

    def read_view(self, timeout: float | None = 60.0):
        """Zero-copy read: a memoryview over the published payload, valid
        ONLY until ``ack_read()``: the caller copies what it keeps BEFORE
        acking (the writer may overwrite the buffer after)."""

        def readable(hdr):
            w, r, _n, c = hdr
            if w > r:
                return True
            if c:
                raise ChannelClosed("channel closed and drained")
            return False

        self._wait(readable, timeout, "channel read timed out")
        _w, _r, n, _c = self._hdr()
        return memoryview(self._mm)[_HDR_SIZE:_HDR_SIZE + n]

    def ack_read(self) -> None:
        """Consume the payload returned by ``read_view``: the writer may
        overwrite the buffer from here on."""
        _w, r, _n, _c = self._hdr()
        self._set(read_seq=r + 1)

    def wait_drained(self, timeout: float | None = 60.0) -> None:
        """Block until the reader consumed the LAST published payload: the
        writer's end-of-stream barrier, after which close()+unlink() cannot
        strand an unread payload. Raises ChannelClosed if the channel was
        closed underneath the wait."""

        def drained(hdr):
            w, r, _n, c = hdr
            if w == r:  # drained wins over closed: the stream completed
                return True
            if c:
                raise ChannelClosed("channel closed")
            return False

        self._wait(drained, timeout,
                   "channel drain wait timed out (reader gone?)")

    def close(self) -> None:
        """Mark closed; peers already attached observe ChannelClosed. The
        NAME stays linked: the creator's GC (or an explicit unlink())
        removes the file."""
        try:
            self._set(closed=1)
        except ValueError:
            pass  # already unmapped

    def force_ack(self) -> None:
        """Recovery aid: mark whatever the writer last published as consumed
        (read_seq = write_seq), so a writer blocked on a DEAD reader's ack
        can finish. Violates SPSC on purpose: only for a reader known
        dead."""
        try:
            w, _r, _n, _c = self._hdr()
            self._set(read_seq=w)
        except ValueError:
            pass  # already unmapped

    def close_mapping(self) -> None:
        """Release THIS handle's mmap without touching the header: the
        reader-side detach. close() would flip the shared closed flag and
        make a still-draining writer read its own stream as a peer death."""
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass  # a view still exports the buffer, or already unmapped

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __del__(self):
        mm = getattr(self, "_mm", None)
        if mm is not None:
            try:
                mm.close()
            except Exception:
                pass
        if getattr(self, "_creator", False):
            # the creating handle owns the name: releasing it reclaims the
            # tmpfs bytes even if close()/unlink() were never called.
            # Existing mappings stay valid per POSIX.
            self.unlink()


def create_mutable_channel(buffer_bytes: int = 1 << 20) -> MutableShmChannel:
    """A new channel of ``buffer_bytes`` payload bytes under the port's shm
    prefix; this handle unlinks the segment when it is collected. Raises
    OSError (and leaves no file) when the directory cannot hold it."""
    path = os.path.join(_DIR, f"{SHM_CHANNEL_PREFIX}{uuid.uuid4().hex[:12]}")
    ch = MutableShmChannel(path, buffer_bytes, _create=True)
    ch._creator = True  # this handle's GC unlinks the backing file
    return ch
