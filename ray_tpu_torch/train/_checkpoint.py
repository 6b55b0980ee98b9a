"""Checkpoint: a handle to persisted training state in a storage backend.

(reference: python/ray/train/_checkpoint.py:56 — Checkpoint wraps a
(filesystem, path) pair with from_directory/to_directory/as_directory; the
filesystem here is a `ray_tpu_torch.train.storage.StorageBackend`, so the same
handle covers a local/NFS mount (zero-copy reads) and remote object stores
(download-on-demand through the fault-injecting storage API).)
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

from ray_tpu_torch.train import storage as storage_mod


class Checkpoint:
    def __init__(self, path: str, backend: "storage_mod.StorageBackend | None" = None):
        if backend is None:
            backend, path = storage_mod.get_storage_backend(path)
        self.backend = backend
        self.path = backend.normalize(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path, backend=storage_mod.LocalBackend())

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        return cls(uri)

    @property
    def uri(self) -> str:
        return self.backend.uri_for(self.path)

    def to_directory(self, path: str | None = None) -> str:
        """Materialize checkpoint contents into `path` (or a fresh temp dir).
        Local storage copies; remote storage downloads manifest-listed files
        with retries and size validation."""
        dest = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(dest, exist_ok=True)
        if self.backend.is_local:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        else:
            storage_mod.restore_directory(self.backend, self.path, dest)
        return dest

    @contextlib.contextmanager
    def as_directory(self):
        """Local view of the checkpoint. Zero-copy when the storage is
        local/NFS (yields the stored path directly); remote checkpoints are
        downloaded to a temp dir that is removed on exit."""
        if self.backend.is_local:
            yield self.path
            return
        dest = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        try:
            storage_mod.restore_directory(self.backend, self.path, dest)
            yield dest
        finally:
            shutil.rmtree(dest, ignore_errors=True)

    def subdir(self, name: str) -> "Checkpoint":
        """A handle scoped to a sub-prefix (e.g. `rank_3`): on remote
        storage, restoring the subset moves only that shard's bytes instead
        of the whole W-rank checkpoint."""
        return type(self)(storage_mod.join_path(self.path, name),
                          backend=self.backend)

    def delete(self) -> None:
        """Remove the persisted checkpoint from its backend (retention)."""
        self.backend.delete_prefix(self.path)

    def __repr__(self):
        return f"{type(self).__name__}(path={self.uri!r})"

    def __reduce__(self):
        # type(self), not Checkpoint: subclasses must survive pickling
        # through the object store
        return (type(self), (self.path, self.backend))
