"""Per-node shared-memory object store (plasma equivalent).

Objects live as files under /dev/shm (tmpfs) and are mapped read-only by
consumers, giving zero-copy cross-process reads of numpy payloads the same way
the reference's plasma store hands out mmap'd fds
(reference: src/ray/object_manager/plasma/store.h, dlmalloc over mmap'd shm,
fd passing in fling.cc). Here tmpfs file names play the role of fds; the
optional C++ arena allocator (src/shm_alloc.cc) can back large stores with a
single mapped arena instead of one file per object.
"""

from __future__ import annotations

import logging
import mmap
import os
from typing import Iterable

from ray_tpu_torch._private.constants import SHM_DIR  # noqa: F401 — re-exported
from ray_tpu_torch._private.constants import SHM_SESSION_PREFIX, temp_root

logger = logging.getLogger(__name__)


def make_object_store(session_id: str):
    """Backend selector: the default is the native C++ arena (one mmap'd
    segment, bounded capacity, LRU evict-to-spill — csrc/shm_store.cc);
    RAY_TPU_TORCH_STORE_BACKEND=file selects one tmpfs file per object.

    A broken/missing toolchain (no g++, failed compile) degrades to the
    file backend with a warning instead of failing ray_tpu_torch.init(). The
    choice is pinned into this process's environment so every child this
    host spawns inherits the SAME backend — processes of one session
    disagreeing on where objects live would strand every put."""
    from ray_tpu_torch._private.ray_config import RayConfig

    if RayConfig.get("store_backend") == "arena":
        try:
            from ray_tpu_torch._private import shm_arena

            # only the build/load step may degrade: a transient runtime
            # error constructing the store (fd exhaustion, bad mount) must
            # propagate — one process silently flipping backends mid-session
            # would strand every object it writes
            shm_arena._ensure_lib()
        except Exception as e:  # CalledProcessError / missing g++ / dlopen
            logger.warning(
                "native shm arena unavailable (%s: %s); falling back to the "
                "file object-store backend", type(e).__name__, e)
            os.environ["RAY_TPU_TORCH_STORE_BACKEND"] = "file"
        else:
            return shm_arena.ArenaStore(session_id)
    return ShmObjectStore(session_id)


class PlasmaObject:
    """A sealed object: keeps the mmap alive while consumers hold views."""

    __slots__ = ("buf", "_mm", "_f")

    def __init__(self, buf: memoryview, mm=None, f=None):
        self.buf = buf
        self._mm = mm
        self._f = f


def spill_dir_for(ns: str) -> str:
    return os.path.join(temp_root(), f"spill_{ns}")


class ShmObjectStore:
    """One store per session; all processes of the session share the prefix.

    Two tiers: tmpfs (hot, zero-copy) and a disk spill directory (cold).
    Reads fall back to the spill tier transparently; the GCS-driven spiller
    moves LRU objects down when the host's tmpfs budget is exceeded
    (reference: spill orchestration, raylet/local_object_manager.h:43)."""

    def __init__(self, session_id: str):
        self.prefix = f"{SHM_SESSION_PREFIX}{session_id}_"
        self.spill_dir = spill_dir_for(session_id)
        self._created: set[str] = set()

    def _path(self, object_hex: str) -> str:
        return os.path.join(SHM_DIR, self.prefix + object_hex)

    def _spill_path(self, object_hex: str) -> str:
        return os.path.join(self.spill_dir, object_hex)

    def put_parts(self, object_hex: str, parts: Iterable[bytes | memoryview], total: int) -> str:
        """Create+seal an object from pre-serialized parts. Returns the tier
        it actually landed on: "shm" (tmpfs) or "spill" (disk fallback) — so
        callers report true tmpfs usage to the GCS accountant."""
        path = self._path(object_hex)
        tmp = path + ".tmp"
        tier = "shm"
        try:
            self._write(tmp, path, parts, total)
        except OSError:  # tmpfs full: create straight into the spill tier
            try:
                os.unlink(tmp)  # don't strand a truncated file on full tmpfs
            except OSError:
                pass
            os.makedirs(self.spill_dir, exist_ok=True)
            spath = self._spill_path(object_hex)
            self._write(spath + ".tmp", spath, parts, total)
            tier = "spill"
        self._created.add(object_hex)
        return tier

    @staticmethod
    def _write(tmp: str, path: str, parts, total: int) -> None:
        # plain write(2), NOT an mmap store: tmpfs allocates lazily, so a
        # faulting mmap write on a full tmpfs raises SIGBUS (kills the
        # process) while write() returns ENOSPC — which the spill fallback
        # in put_parts can actually catch
        with open(tmp, "wb") as f:
            for p in parts:
                f.write(p)
        os.rename(tmp, path)  # atomic seal: readers never see partial objects

    def get(self, object_hex: str) -> PlasmaObject:
        try:
            f = open(self._path(object_hex), "rb")
        except FileNotFoundError:
            f = open(self._spill_path(object_hex), "rb")
        try:
            size = os.fstat(f.fileno()).st_size
            mm = mmap.mmap(f.fileno(), size, prot=mmap.PROT_READ)
        except BaseException:
            # mmap raises on an empty/truncated file; the workers calling
            # get() under memory pressure are exactly the ones that cannot
            # afford to bleed one fd per failed read
            f.close()
            raise
        return PlasmaObject(memoryview(mm), mm, f)

    def contains(self, object_hex: str) -> bool:
        return (os.path.exists(self._path(object_hex))
                or os.path.exists(self._spill_path(object_hex)))

    def tier_of(self, object_hex: str) -> str | None:
        """Which tier holds the object right now ("shm" | "spill" | None)."""
        if os.path.exists(self._path(object_hex)):
            return "shm"
        if os.path.exists(self._spill_path(object_hex)):
            return "spill"
        return None

    def size(self, object_hex: str) -> int:
        try:
            return os.stat(self._path(object_hex)).st_size
        except FileNotFoundError:
            return os.stat(self._spill_path(object_hex)).st_size

    def spill(self, object_hex: str) -> bool:
        """Move an object from tmpfs to the disk tier (no-op if absent).
        tmp-copy + atomic replace: a crash mid-spill must never leave a
        truncated file where readers expect a sealed object."""
        src = self._path(object_hex)
        if not os.path.exists(src):
            return False
        os.makedirs(self.spill_dir, exist_ok=True)
        import shutil

        dst = self._spill_path(object_hex)
        tmp = dst + f".tmp{os.getpid()}"
        try:
            shutil.copyfile(src, tmp)
            os.replace(tmp, dst)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.unlink(src)
        return True

    def delete(self, object_hex: str) -> None:
        for path in (self._path(object_hex), self._spill_path(object_hex)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        self._created.discard(object_hex)

    def cleanup_session(self) -> None:
        """Unlink every object of this session (driver calls at shutdown)."""
        try:
            names = os.listdir(SHM_DIR)
        except FileNotFoundError:
            return
        for name in names:
            if name.startswith(self.prefix):
                try:
                    os.unlink(os.path.join(SHM_DIR, name))
                except OSError:
                    pass
        import shutil

        shutil.rmtree(self.spill_dir, ignore_errors=True)
