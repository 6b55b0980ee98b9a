"""ctypes binding for the native shm arena store (csrc/shm_store.cc).

The port's copy of ray_tpu/_private/shm_arena.py over its own copy of the
JAX package's host C++ source (``cpp/shm_store.cc``, symbols ``rtpt_*``),
built with g++ into ``ray_tpu_torch/build/libshmstore.so`` (git-ignored):
the two packages never share or race on one library.

One mmap'd tmpfs arena per (session, host): the C side owns metadata
(hash-indexed object table, free-list, robust process-shared mutex, per-pid
pin registry); Python maps the same file MAP_SHARED and reads/writes object
bytes at the offsets the C side hands out — zero-copy for consumers, exactly
like the file-per-object backend but with bounded memory and eviction.

Eviction here never drops the only copy of an object: when a put needs room,
the LRU sealed+unpinned victim is SPILLED to the disk tier first (reusing the
two-tier layout the file backend already has), then freed from the arena —
the plasma analogue would be eviction + restore-from-external-storage
(reference: src/ray/object_manager/plasma/ — store over dlmalloc'd shm with
LRU eviction_policy.h:159; here arena+offsets instead of fds). Pins held by
processes that died are reaped from the shared pin registry so a SIGKILLed
reader can never wedge eviction.
"""

from __future__ import annotations

import ctypes
import logging
import mmap
import os
import subprocess
import threading

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "..", "csrc", "shm_store.cc")
_LIB_DIR = os.path.join(os.path.dirname(__file__), "..", "build")
_LIB = os.path.join(_LIB_DIR, "libshmstore.so")

_build_lock = threading.Lock()
_lib = None

from ray_tpu_torch._private.constants import SHM_DIR, SHM_SESSION_PREFIX
from ray_tpu_torch._private.ray_config import RayConfig

# Puts at or above this size bypass the mmap store and pwrite() instead:
# storing through the mapping faults fresh tmpfs pages one at a time, a
# syscall copies and allocates them in bulk. Below it, syscall overhead
# dominates and the mmap copy wins.
_BULK_WRITE_MIN = 256 * 1024


class ArenaFullError(Exception):
    """No contiguous run fits even after evicting every unpinned object."""


def _ensure_lib() -> ctypes.CDLL:
    """Build (if missing/stale) and load the native library, once per process.
    Raises on a missing/broken toolchain — make_object_store catches that and
    falls back to the file backend rather than failing ray_tpu_torch.init()."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        src = os.path.abspath(_SRC)
        lib = os.path.abspath(_LIB)
        if (not os.path.exists(lib)
                or os.path.getmtime(lib) < os.path.getmtime(src)):
            os.makedirs(os.path.dirname(lib), exist_ok=True)
            tmp = lib + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src, "-lpthread"],
                check=True, capture_output=True)
            os.replace(tmp, lib)  # atomic: concurrent builders don't collide
        dll = ctypes.CDLL(lib)
        dll.rtpt_store_open.restype = ctypes.c_void_p
        dll.rtpt_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        dll.rtpt_store_close.argtypes = [ctypes.c_void_p]
        dll.rtpt_store_create.restype = ctypes.c_int64
        dll.rtpt_store_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        dll.rtpt_store_create_noevict.restype = ctypes.c_int64
        dll.rtpt_store_create_noevict.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        dll.rtpt_store_seal.restype = ctypes.c_int
        dll.rtpt_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        dll.rtpt_store_get.restype = ctypes.c_int64
        dll.rtpt_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_uint64)]
        dll.rtpt_store_release.restype = ctypes.c_int
        dll.rtpt_store_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        dll.rtpt_store_contains.restype = ctypes.c_int
        dll.rtpt_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        dll.rtpt_store_size.restype = ctypes.c_int64
        dll.rtpt_store_size.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        dll.rtpt_store_delete.restype = ctypes.c_int
        dll.rtpt_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        dll.rtpt_store_lru_victim.restype = ctypes.c_int
        dll.rtpt_store_lru_victim.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        dll.rtpt_store_reap_dead.restype = ctypes.c_int
        dll.rtpt_store_reap_dead.argtypes = [ctypes.c_void_p]
        dll.rtpt_store_release_pid.restype = ctypes.c_int
        dll.rtpt_store_release_pid.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        dll.rtpt_store_used.restype = ctypes.c_uint64
        dll.rtpt_store_used.argtypes = [ctypes.c_void_p]
        dll.rtpt_store_capacity.restype = ctypes.c_uint64
        dll.rtpt_store_capacity.argtypes = [ctypes.c_void_p]
        dll.rtpt_store_num_objects.restype = ctypes.c_uint32
        dll.rtpt_store_num_objects.argtypes = [ctypes.c_void_p]
        _lib = dll
        return dll


class _ArenaObject:
    """A pinned view into the arena; unpins on GC (plasma release)."""

    __slots__ = ("buf", "_store", "_oid", "_released", "__weakref__")

    def __init__(self, buf: memoryview, store: "ArenaStore", oid: str):
        self.buf = buf
        self._store = store
        self._oid = oid
        self._released = False

    def release(self):
        if not self._released:
            self._released = True
            self.buf = None
            self._store._release(self._oid)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class ArenaStore:
    """Drop-in for ShmObjectStore, backed by the native arena.

    All processes of a session on one host share one arena file; `get`
    returns pinned zero-copy views, `put_parts` spills LRU sealed objects to
    the disk tier to make room (the file backend instead grows until tmpfs
    fills). `on_evict` (if set) is called with the list of object ids each
    put pushed down to the spill tier — the CoreWorker/node-agent forward
    that to the GCS so cluster tmpfs accounting and `tier_of` stay truthful.
    """

    def __init__(self, session_id: str, capacity: int = 0):
        from ray_tpu_torch._private.object_store import spill_dir_for

        self.session_id = session_id
        self.prefix = f"{SHM_SESSION_PREFIX}{session_id}_"
        self.path = os.path.join(SHM_DIR, self.prefix + "arena")
        self.spill_dir = spill_dir_for(session_id)
        self._dll = _ensure_lib()
        cap = capacity or RayConfig.get("store_capacity")
        try:
            # plasma-style capping: an arena bigger than tmpfs can hold
            # would SIGBUS writers when pages can't be allocated — cap at
            # 80% of what /dev/shm can actually back right now
            vfs = os.statvfs(SHM_DIR)
            cap = max(1 << 20, min(cap, int(vfs.f_bavail * vfs.f_frsize * 0.8)))
        except OSError:
            pass
        self._handle = self._dll.rtpt_store_open(self.path.encode(), cap, 1)
        if not self._handle:
            raise OSError(f"cannot open shm arena at {self.path}")
        f = open(self.path, "r+b")
        try:
            total = os.fstat(f.fileno()).st_size
            self._mm = mmap.mmap(f.fileno(), total)
        except Exception:
            f.close()
            self._dll.rtpt_store_close(self._handle)
            raise
        self._file = f  # kept open: large puts pwrite() at the C-side offset
        self._lock = threading.Lock()
        self.on_evict = None  # callable(list[str]) | None
        self.evictions = 0  # objects THIS process spilled to make room
        import weakref

        self._views = weakref.WeakSet()  # live pinned views of this process

    # -- interface shared with ShmObjectStore ------------------------------

    def _spill_path(self, object_hex: str) -> str:
        return os.path.join(self.spill_dir, object_hex)

    def put_parts(self, object_hex: str, parts, total: int) -> str:
        """Create+seal an object from pre-serialized parts. Returns the tier
        it actually landed on ("shm" | "spill"), matching ShmObjectStore.
        Never drops data to make room: LRU victims are spilled to disk."""
        oid = object_hex.encode()
        size = max(total, 1)
        evicted: list[str] = []
        try:
            off = self._dll.rtpt_store_create_noevict(self._handle, oid, size)
            while off == -1:  # no contiguous run: spill the LRU victim
                victim = ctypes.create_string_buffer(48)
                if self._dll.rtpt_store_lru_victim(self._handle, victim) == 0:
                    vic = victim.value.decode()
                    try:
                        if self.spill(vic):
                            evicted.append(vic)
                    except OSError:
                        logger.exception("evict-to-spill of %s failed", vic)
                        break  # disk trouble: fall through to spill-tier put
                elif self._dll.rtpt_store_reap_dead(self._handle) > 0:
                    pass  # orphaned pins released, space may be free: retry
                else:
                    break  # everything resident is live-pinned
                off = self._dll.rtpt_store_create_noevict(self._handle, oid, size)
            if off == -2:
                # already present: report where the object actually lives
                # (it may sit in the spill tier) so GCS tmpfs accounting
                # isn't inflated by re-puts
                tier = self.tier_of(object_hex)
                if tier is None:
                    # deferred-delete ghost: the old entry is kDeleting
                    # (readers still pinned) so the arena refuses the id,
                    # but the object is logically gone. Preserve the
                    # re-put's bytes in the spill tier — claiming "shm"
                    # here would silently lose the only copy.
                    self._write_spill(object_hex, parts)
                    return "spill"
                return tier
            if off < 0:
                # -4 larger than the arena, -1 unplaceable, -3 index full:
                # create straight in the spill tier
                self._write_spill(object_hex, parts)
                return "spill"
            pos = off
            if size >= _BULK_WRITE_MIN:
                # bulk pwrite: storing through the mmap faults each fresh
                # tmpfs page individually (~3x slower than the file backend
                # at 4 MiB); one write syscall allocates pages in bulk
                # in-kernel. tmpfs is the page cache, so the MAP_SHARED
                # views other processes hold stay coherent.
                fd = self._file.fileno()
                for p in parts:
                    mv = p if isinstance(p, bytes) else memoryview(p).cast("B")
                    sent = os.pwrite(fd, mv, pos)
                    while sent < len(mv):  # short write (rare on tmpfs)
                        sent += os.pwrite(fd, memoryview(mv)[sent:], pos + sent)
                    pos += len(mv)
            else:
                for p in parts:
                    n = len(p) if isinstance(p, bytes) else p.nbytes
                    self._mm[pos:pos + n] = p
                    pos += n
            rc = self._dll.rtpt_store_seal(self._handle, oid)
            if rc != 0:
                raise OSError(f"seal({object_hex}) failed: {rc}")
            return "shm"
        finally:
            self._note_evicted(evicted)

    def _write_spill(self, object_hex: str, parts) -> None:
        # pid-suffixed temp name: two processes spilling the same object
        # must not corrupt each other's atomic rename
        os.makedirs(self.spill_dir, exist_ok=True)
        dst = self._spill_path(object_hex)
        tmp = dst + f".tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                for p in parts:
                    f.write(p)
            os.replace(tmp, dst)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _note_evicted(self, evicted: list) -> None:
        if not evicted:
            return
        self.evictions += len(evicted)
        cb = self.on_evict
        if cb is not None:
            try:
                cb(list(evicted))
            except Exception:
                logger.exception("on_evict hook failed")

    def get(self, object_hex: str):
        oid = object_hex.encode()
        size = ctypes.c_uint64()
        off = self._dll.rtpt_store_get(self._handle, oid, ctypes.byref(size))
        if off < 0:
            # spill-tier fallback (mmap'd from disk)
            try:
                f = open(self._spill_path(object_hex), "rb")
            except FileNotFoundError:
                raise FileNotFoundError(
                    f"object {object_hex} not in arena (evicted?)") from None
            from ray_tpu_torch._private.object_store import PlasmaObject

            try:
                n = os.fstat(f.fileno()).st_size
                mm = mmap.mmap(f.fileno(), n, prot=mmap.PROT_READ)
            except BaseException:
                f.close()  # mmap of an empty/torn spill file raises
                raise
            return PlasmaObject(memoryview(mm), mm, f)
        view = memoryview(self._mm)[off:off + size.value]
        obj = _ArenaObject(view, self, object_hex)
        self._views.add(obj)
        return obj

    def contains(self, object_hex: str) -> bool:
        return (bool(self._dll.rtpt_store_contains(self._handle, object_hex.encode()))
                or os.path.exists(self._spill_path(object_hex)))

    def tier_of(self, object_hex: str) -> "str | None":
        if self._dll.rtpt_store_contains(self._handle, object_hex.encode()):
            return "shm"
        if os.path.exists(self._spill_path(object_hex)):
            return "spill"
        return None

    def size(self, object_hex: str) -> int:
        n = self._dll.rtpt_store_size(self._handle, object_hex.encode())
        if n < 0:
            try:
                return os.stat(self._spill_path(object_hex)).st_size
            except FileNotFoundError:
                raise FileNotFoundError(object_hex) from None
        return n

    def spill(self, object_hex: str) -> bool:
        """Copy an arena object to the disk tier, then drop it from the arena.

        Known race (predates the arena default, window widened by the put
        evict loop): a concurrent delete() that runs between our pin and the
        _write_spill publish leaves a stale spill file behind — the deleted
        id then reads as tier "spill" and its bytes sit on disk until
        cleanup_session. Nothing dereferences a GCS-freed id, so the cost is
        the leaked file, not wrong data; closing it needs a delete tombstone
        the two-tier layout doesn't have yet."""
        oid = object_hex.encode()
        size = ctypes.c_uint64()
        off = self._dll.rtpt_store_get(self._handle, oid, ctypes.byref(size))
        if off < 0:
            return False
        try:
            self._write_spill(object_hex, [self._mm[off:off + size.value]])
        finally:
            self._dll.rtpt_store_release(self._handle, oid)
        self._dll.rtpt_store_delete(self._handle, oid)
        return True

    def delete(self, object_hex: str) -> None:
        self._dll.rtpt_store_delete(self._handle, object_hex.encode())
        try:
            os.unlink(self._spill_path(object_hex))
        except FileNotFoundError:
            pass

    def cleanup_session(self) -> None:
        """Unlink the arena segment, the spill dir, and any per-object tmpfs
        files a file-backend fallback process of the same session created."""
        try:
            names = os.listdir(SHM_DIR)
        except FileNotFoundError:
            names = []
        for name in names:
            if name.startswith(self.prefix):
                try:
                    os.unlink(os.path.join(SHM_DIR, name))
                except OSError:
                    pass
        import shutil

        shutil.rmtree(self.spill_dir, ignore_errors=True)

    # -- arena-specific ----------------------------------------------------

    def _release(self, object_hex: str) -> None:
        self._dll.rtpt_store_release(self._handle, object_hex.encode())

    def release_pid_pins(self) -> int:
        """Release every pin this process still holds (clean-exit path).
        Outstanding views release themselves by oid first — that needs no
        registry attribution, so it works even for pins taken while the
        shared registry was full — then the pid sweep drops whatever
        recorded edges remain (views lost without GC)."""
        n = 0
        for v in list(self._views):
            if not v._released:
                v.release()
                n += 1
        return n + self._dll.rtpt_store_release_pid(self._handle, os.getpid())

    def reap_dead_pins(self) -> int:
        """Release pins whose holder process no longer exists."""
        return self._dll.rtpt_store_reap_dead(self._handle)

    def used(self) -> int:
        return self._dll.rtpt_store_used(self._handle)

    def capacity(self) -> int:
        return self._dll.rtpt_store_capacity(self._handle)

    def num_objects(self) -> int:
        return self._dll.rtpt_store_num_objects(self._handle)
