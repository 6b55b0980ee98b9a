"""Pluggable checkpoint storage: URI-dispatched backends + two-phase commits.

(reference: train/v2/_internal/execution/storage.py:99-180 — StorageContext
rides every checkpoint through an arbitrary pyarrow filesystem so a run
survives losing its host; here the filesystem is a `StorageBackend` resolved
from the `storage_path` URI.)

Backends:
- `file://` (or a bare path): local/NFS filesystem. Zero-copy reads —
  `Checkpoint.as_directory` yields the stored path directly.
- `mock://bucket/prefix?...`: a process-external "remote" object store with
  configurable fault injection (upload error rate, torn/partial writes,
  injected latency, read failures, SIGKILL-on-key). Objects live under a
  shared root directory so a controller restarted on a *different* host
  (process) sees the same store, but every byte moves through this API —
  never zero-copy — which is what makes the preemption chaos tests real.

Persisting a directory is a two-phase atomic commit: upload each file plus a
manifest (names, sizes) to the destination prefix with per-file
retry/exponential-backoff+jitter, then write a single commit marker. Restore
reads the manifest(s), downloads only manifest-listed files with retries, and
validates sizes. Recovery trusts only committed prefixes — a crash mid-upload
leaves a torn prefix that no controller will ever register.
"""

from __future__ import annotations

import json
import os
import posixpath
import random
import shutil
import signal
import time
from dataclasses import dataclass, field
from urllib.parse import parse_qs, urlsplit

from ray_tpu_torch._private.constants import temp_root

MANIFEST_NAME = ".manifest.json"
COMMIT_MARKER = ".commit"
# written into a checkpoint dir when the controller registers it; recovery
# after a crash trusts marked dirs whose per-rank manifests still validate
COMPLETE_MARKER = ".complete"


class StorageError(RuntimeError):
    """A storage operation failed past its retry budget (or unrecoverably)."""


# --------------------------------------------------------------------- paths


def join_path(base: str, *parts: str) -> str:
    """Join path components onto a local path or URI, preserving any
    `?query` suffix on the base (fault-injection knobs ride in the query)."""
    base, q, query = base.partition("?")
    joined = "/".join([base.rstrip("/")] + [str(p).strip("/") for p in parts])
    return joined + (q + query if query else "")


def strip_query(path: str) -> str:
    return path.partition("?")[0]


def basename(path: str) -> str:
    return posixpath.basename(strip_query(path).rstrip("/"))


def parent(path: str) -> str:
    return posixpath.dirname(strip_query(path).rstrip("/"))


# ------------------------------------------------------------------- retries


@dataclass
class RetryConfig:
    """Per-file retry with exponential backoff + jitter.
    (reference: storage layers retry transient filesystem errors; the
    backoff shape matches _retry_with_backoff idiom.)"""

    max_attempts: int = 5
    base_delay_s: float = 0.02
    multiplier: float = 2.0
    max_delay_s: float = 1.0
    jitter: float = 0.5  # each sleep is delay * (1 + uniform(0, jitter))


DEFAULT_RETRY = RetryConfig()


def _with_retry(fn, *args, retry: RetryConfig, op: str):
    """Run fn(*args); on failure, back off and retry. Returns
    (result, extra_attempts) so callers can account retries."""
    delay = retry.base_delay_s
    last: Exception | None = None
    for attempt in range(max(1, retry.max_attempts)):
        try:
            return fn(*args), attempt
        except Exception as e:  # noqa: BLE001 — every backend error is retryable
            last = e
            if attempt >= retry.max_attempts - 1:
                break
            time.sleep(delay * (1.0 + random.uniform(0.0, retry.jitter)))
            delay = min(delay * retry.multiplier, retry.max_delay_s)
    raise StorageError(
        f"{op} failed after {retry.max_attempts} attempt(s): {last}") from last


def with_retry(fn, *args, retry: RetryConfig | None = None,
               op: str = "storage op"):
    """Public retry wrapper for one storage operation: returns fn's result,
    raising StorageError past the budget."""
    result, _ = _with_retry(fn, *args, retry=retry or DEFAULT_RETRY, op=op)
    return result


def _walk_files(base: str) -> list[str]:
    """Object keys (relative, '/'-separated) under a local directory,
    excluding in-flight writes of crashed processes."""
    out = []
    for root, _dirs, files in os.walk(base):
        for name in files:
            if ".tmp." in name:
                continue
            out.append(os.path.relpath(os.path.join(root, name), base))
    return sorted(out)


def _scan_child_dirs(base: str) -> list[str]:
    """Immediate subdirectory names — one scandir, no recursive walk."""
    try:
        with os.scandir(base) as it:
            return sorted(e.name for e in it if e.is_dir())
    except OSError:
        return []


def _delete_path(base: str) -> None:
    if os.path.isdir(base):
        shutil.rmtree(base, ignore_errors=True)
    elif os.path.exists(base):
        try:
            os.remove(base)
        except OSError:
            pass


# ------------------------------------------------------------------ backends


class StorageBackend:
    """Protocol for checkpoint storage. Paths are the same strings stored in
    `Checkpoint.path` (plain local paths, or full URIs for remote schemes).
    Implementations must be picklable: backends travel with checkpoints and
    session contexts through the object store."""

    is_local = False

    # data-plane ops (fault-injected in mock): bytes move through these
    def upload_file(self, local_path: str, dest_path: str) -> None:
        raise NotImplementedError

    def download_file(self, src_path: str, local_path: str) -> None:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    # metadata ops (never fault-injected)
    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> list[str]:
        """All object keys under prefix, relative to it ('a/b.txt')."""
        raise NotImplementedError

    def list_children(self, prefix: str) -> list[str]:
        """Immediate child 'directory' names under prefix (delimiter-style
        shallow listing). Default derives it from a full list_prefix walk —
        override where a shallow stat is cheaper (recovery scans call this
        on every restart)."""
        kids = set()
        for key in self.list_prefix(prefix):
            if "/" in key:
                kids.add(key.split("/", 1)[0])
        return sorted(kids)

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        """Prepare a prefix for writes (no-op on object stores)."""

    def normalize(self, path: str) -> str:
        return strip_query(path).rstrip("/")

    def uri_for(self, path: str) -> str:
        return path


class LocalBackend(StorageBackend):
    """Local/NFS filesystem. `upload` is a copy; reads are zero-copy at the
    Checkpoint layer (as_directory yields the stored path directly)."""

    is_local = True

    def upload_file(self, local_path: str, dest_path: str) -> None:
        os.makedirs(os.path.dirname(dest_path), exist_ok=True)
        shutil.copy2(local_path, dest_path)

    def download_file(self, src_path: str, local_path: str) -> None:
        os.makedirs(os.path.dirname(local_path), exist_ok=True)
        shutil.copy2(src_path, local_path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # atomic even under SIGKILL

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def size(self, path: str) -> int:
        return os.path.getsize(path)

    def list_prefix(self, prefix: str) -> list[str]:
        return _walk_files(prefix)

    def list_children(self, prefix: str) -> list[str]:
        return _scan_child_dirs(prefix)

    def delete_prefix(self, prefix: str) -> None:
        _delete_path(prefix)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def normalize(self, path: str) -> str:
        return os.path.abspath(strip_query(path))

    def uri_for(self, path: str) -> str:
        return f"file://{path}"

    def __eq__(self, other):
        return type(other) is LocalBackend

    def __hash__(self):
        return hash("LocalBackend")


@dataclass
class MockFaultSpec:
    """Fault-injection knobs for the mock remote store; every field maps to a
    `mock://` URI query parameter of the same name."""

    fail_rate: float = 0.0       # P(upload attempt raises before writing)
    torn_rate: float = 0.0       # P(upload writes a partial object, then raises)
    read_fail_rate: float = 0.0  # P(read attempt raises)
    latency_ms: float = 0.0      # injected per-op latency
    seed: int | None = None      # deterministic per-instance RNG
    die_on_key: str | None = None  # SIGKILL this process mid-write of a
    #                                matching key (fires once per store)
    fail_on_key: str | None = None  # every write of a matching key fails —
    #                                 deterministic single-rank outage


class MockRemoteBackend(StorageBackend):
    """An out-of-process "remote" object store with fault injection.

    Objects are blobs under `<store_root>/<bucket>/...` (store_root from
    $RAY_TPU_TORCH_MOCK_STORE_ROOT, default <temp root>/mock_store), so every
    process on the machine — controller, workers, a "different host" driver —
    shares one store, while all data moves through this fault-injecting API.
    Writes of full objects are atomic (tmp + rename); injected torn writes
    bypass that to leave a genuinely partial object in place.
    """

    is_local = False

    def __init__(self, bucket: str, faults: MockFaultSpec | None = None):
        self.bucket = bucket
        self.faults = faults or MockFaultSpec()
        self.store_root = os.environ.get(
            "RAY_TPU_TORCH_MOCK_STORE_ROOT",
            os.path.join(temp_root(), "mock_store"))
        self._rng = random.Random(self.faults.seed)

    # ----------------------------------------------------------- key mapping

    def _local(self, path: str) -> str:
        """Map 'mock://bucket/a/b' (or 'a/b') to its blob path on disk."""
        path = strip_query(path)
        if path.startswith("mock://"):
            rest = path[len("mock://"):]
            bucket, _, key = rest.partition("/")
        else:
            bucket, key = self.bucket, path.lstrip("/")
        return os.path.join(self.store_root, bucket, key)

    def _internal(self, name: str) -> str:
        d = os.path.join(self.store_root, ".internal", self.bucket)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, name)

    # ------------------------------------------------------- fault injection

    def _sleep(self):
        if self.faults.latency_ms:
            time.sleep(self.faults.latency_ms / 1000.0)

    def _maybe_die_on(self, path: str, data: bytes, dest: str) -> None:
        key = self.faults.die_on_key
        if not key or key not in strip_query(path):
            return
        sentinel = self._internal("die_fired")
        try:  # fire exactly once per store, even across process restarts
            fd = os.open(sentinel, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            return
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        with open(dest, "wb") as f:  # torn: half the object, then death
            f.write(data[: max(1, len(data) // 2)])
            f.flush()
        os.kill(os.getpid(), signal.SIGKILL)

    # -------------------------------------------------------------- data ops

    def write_bytes(self, path: str, data: bytes) -> None:
        self._sleep()
        dest = self._local(path)
        self._maybe_die_on(path, data, dest)
        if (self.faults.fail_on_key
                and self.faults.fail_on_key in strip_query(path)):
            raise StorageError(f"injected permanent upload failure for {path}")
        r = self._rng.random()
        if r < self.faults.fail_rate:
            raise StorageError(f"injected upload failure for {path}")
        if r < self.faults.fail_rate + self.faults.torn_rate:
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:  # partial object left in place
                f.write(data[: len(data) // 2])
            raise StorageError(f"injected torn write for {path}")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        tmp = f"{dest}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dest)

    def upload_file(self, local_path: str, dest_path: str) -> None:
        with open(local_path, "rb") as f:
            self.write_bytes(dest_path, f.read())

    def read_bytes(self, path: str) -> bytes:
        self._sleep()
        if self._rng.random() < self.faults.read_fail_rate:
            raise StorageError(f"injected read failure for {path}")
        with open(self._local(path), "rb") as f:
            return f.read()

    def download_file(self, src_path: str, local_path: str) -> None:
        data = self.read_bytes(src_path)
        os.makedirs(os.path.dirname(local_path), exist_ok=True)
        tmp = f"{local_path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, local_path)

    # ---------------------------------------------------------- metadata ops

    def exists(self, path: str) -> bool:
        return os.path.exists(self._local(path))

    def size(self, path: str) -> int:
        return os.path.getsize(self._local(path))

    def list_prefix(self, prefix: str) -> list[str]:
        return _walk_files(self._local(prefix))

    def list_children(self, prefix: str) -> list[str]:
        return _scan_child_dirs(self._local(prefix))

    def delete_prefix(self, prefix: str) -> None:
        _delete_path(self._local(prefix))

    def uri_for(self, path: str) -> str:
        return path

    def __eq__(self, other):
        return (type(other) is MockRemoteBackend and other.bucket == self.bucket
                and other.store_root == self.store_root)

    def __hash__(self):
        return hash(("MockRemoteBackend", self.bucket, self.store_root))


# -------------------------------------------------------------- URI dispatch


def _local_factory(uri: str) -> tuple[StorageBackend, str]:
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    backend = LocalBackend()
    return backend, backend.normalize(path)


def _mock_factory(uri: str) -> tuple[StorageBackend, str]:
    parts = urlsplit(uri)
    q = {k: v[-1] for k, v in parse_qs(parts.query).items()}
    faults = MockFaultSpec(
        fail_rate=float(q.get("fail_rate", 0.0)),
        torn_rate=float(q.get("torn_rate", 0.0)),
        read_fail_rate=float(q.get("read_fail_rate", 0.0)),
        latency_ms=float(q.get("latency_ms", 0.0)),
        seed=int(q["seed"]) if "seed" in q else None,
        die_on_key=q.get("die_on_key"),
        fail_on_key=q.get("fail_on_key"),
    )
    bucket = parts.netloc
    if not bucket:
        raise StorageError(f"mock:// URI needs a bucket: {uri!r}")
    backend = MockRemoteBackend(bucket, faults)
    clean = f"mock://{bucket}{parts.path}".rstrip("/")
    return backend, clean


_SCHEMES: dict[str, object] = {"file": _local_factory, "mock": _mock_factory}


def register_storage_backend(scheme: str, factory) -> None:
    """Register `factory(uri) -> (backend, clean_path)` for a URI scheme —
    the extension point for real object stores (gs://, s3://, ...)."""
    _SCHEMES[scheme] = factory


def resolve_run_storage(run_config) -> tuple[StorageBackend, str]:
    """(backend, experiment prefix) for a RunConfig: an explicit
    `storage_backend` instance overrides URI dispatch on `storage_path` —
    shared by TrainController and Tuner so Train and Tune can't diverge."""
    if getattr(run_config, "storage_backend", None) is not None:
        backend = run_config.storage_backend
        return backend, backend.normalize(run_config.experiment_dir())
    return get_storage_backend(run_config.experiment_dir())


def default_results_root() -> str:
    """Where runs without a storage_path persist: under the port's temp
    root (the JAX package's default is ~/ray_tpu_results)."""
    return os.path.join(temp_root(), "results")


def get_storage_backend(uri: str | None) -> tuple[StorageBackend, str]:
    """Resolve a storage_path (URI or local path) to (backend, clean path).
    The clean path has any `?query` fault knobs stripped — those live on the
    returned backend instance."""
    if uri is None:
        return _local_factory(default_results_root())
    if "://" not in uri:
        return _local_factory(uri)
    scheme = uri.split("://", 1)[0]
    factory = _SCHEMES.get(scheme)
    if factory is None:
        raise StorageError(
            f"no storage backend registered for scheme {scheme!r} "
            f"(known: {sorted(_SCHEMES)})")
    return factory(uri)


# ------------------------------------------------------------------ metrics


def _backend_tag(backend: StorageBackend) -> str:
    return ("local" if backend.is_local
            else type(backend).__name__.replace("Backend", "").lower())


def _observe_transfer(backend: StorageBackend, op: str,
                      stats: "PersistStats", commit_s: float | None = None):
    """Record one persist/restore's byte/retry counters (and, for
    persists, the end-to-end commit latency). Fetched registry-aware and
    fully fire-and-forget — metrics must never fail a checkpoint."""
    try:
        from ray_tpu_torch.util.metrics import Counter, Histogram, get_or_create

        tags = {"backend": _backend_tag(backend)}
        get_or_create(
            Counter, f"ray_tpu_storage_{op}_bytes_total",
            f"checkpoint bytes {op}ed through storage backends",
            tag_keys=("backend",)).inc(stats.bytes, tags=tags)
        if stats.retries:
            get_or_create(
                Counter, "ray_tpu_storage_retries_total",
                "extra storage-op attempts beyond the first",
                tag_keys=("backend", "op")).inc(
                    stats.retries, tags={**tags, "op": op})
        if commit_s is not None:
            get_or_create(
                Histogram, "ray_tpu_storage_commit_seconds",
                "two-phase checkpoint commit latency (upload → marker)",
                boundaries=(0.01, 0.05, 0.25, 1.0, 5.0, 30.0, 120.0),
                tag_keys=("backend",)).observe(commit_s, tags=tags)
    except Exception:  # noqa: BLE001
        pass


# --------------------------------------------------- two-phase commit layer


@dataclass
class PersistStats:
    files: int = 0
    bytes: int = 0
    retries: int = 0  # extra attempts beyond the first, summed over ops


def scan_local_files(local_dir: str) -> list[tuple[str, int]]:
    """(relpath, size) for every file under local_dir, manifest/marker names
    excluded (they describe a commit, they are not part of one)."""
    files: list[tuple[str, int]] = []
    for root, _dirs, names in os.walk(local_dir):
        for name in names:
            if name in (MANIFEST_NAME, COMMIT_MARKER):
                continue
            full = os.path.join(root, name)
            rel = os.path.relpath(full, local_dir).replace(os.sep, "/")
            files.append((rel, os.path.getsize(full)))
    files.sort()
    return files


def write_manifest_and_commit(backend: StorageBackend, dest_prefix: str,
                              files: list[tuple[str, int]],
                              meta: dict | None = None, *,
                              retry: RetryConfig | None = None) -> int:
    """The commit phase shared by every persist path: write the manifest
    (names, sizes, meta), then the single commit marker, each with retries.
    Returns the extra attempts spent."""
    retry = retry or DEFAULT_RETRY
    manifest = {
        "files": [{"path": rel, "size": size} for rel, size in files],
        "meta": dict(meta or {}),
    }
    payload = json.dumps(manifest, sort_keys=True).encode()
    _res, extra1 = _with_retry(backend.write_bytes,
                               join_path(dest_prefix, MANIFEST_NAME), payload,
                               retry=retry, op="upload manifest")
    _res, extra2 = _with_retry(backend.write_bytes,
                               join_path(dest_prefix, COMMIT_MARKER),
                               b"committed", retry=retry, op="commit marker")
    return extra1 + extra2


def persist_directory(backend: StorageBackend, local_dir: str,
                      dest_prefix: str, *, retry: RetryConfig | None = None,
                      meta: dict | None = None) -> PersistStats:
    """Two-phase atomic commit of a local directory to `dest_prefix`:
    clear stale partials, upload every file + a manifest (names, sizes) with
    per-file retry, then write the single commit marker. Readers trust the
    prefix only once the marker exists and the manifest validates."""
    retry = retry or DEFAULT_RETRY
    stats = PersistStats()
    t0 = time.monotonic()
    files = scan_local_files(local_dir)
    # phase 0: a crashed prior attempt at this prefix may have left torn
    # objects; the manifest only vouches for what THIS commit uploads
    backend.delete_prefix(dest_prefix)
    for rel, size in files:
        _res, extra = _with_retry(
            backend.upload_file, os.path.join(local_dir, rel.replace("/", os.sep)),
            join_path(dest_prefix, rel), retry=retry, op=f"upload {rel}")
        stats.files += 1
        stats.bytes += size
        stats.retries += extra
    stats.retries += write_manifest_and_commit(backend, dest_prefix, files,
                                               meta, retry=retry)
    _observe_transfer(backend, "upload", stats,
                      commit_s=time.monotonic() - t0)
    return stats


def read_manifest(backend: StorageBackend, prefix: str,
                  retry: RetryConfig | None = None) -> dict | None:
    path = join_path(prefix, MANIFEST_NAME)
    if not backend.exists(path):
        return None
    data, _ = _with_retry(backend.read_bytes, path,
                          retry=retry or DEFAULT_RETRY, op="read manifest")
    try:
        return json.loads(data)
    except ValueError as e:
        raise StorageError(f"corrupt manifest at {path}: {e}") from e


def validate_manifest(backend: StorageBackend, prefix: str) -> bool:
    """True iff a manifest exists and every file it names is present with the
    recorded size. Torn uploads (partial objects, missing files) fail this."""
    try:
        manifest = read_manifest(backend, prefix)
    except StorageError:
        return False
    if manifest is None:
        return False
    for entry in manifest["files"]:
        path = join_path(prefix, entry["path"])
        if not backend.exists(path) or backend.size(path) != entry["size"]:
            return False
    return True


def is_committed(backend: StorageBackend, prefix: str) -> bool:
    """Commit marker present AND manifest validates — the only state a
    restore or recovery scan may trust."""
    return (backend.exists(join_path(prefix, COMMIT_MARKER))
            and validate_manifest(backend, prefix))


def restore_directory(backend: StorageBackend, src_prefix: str, dest_dir: str,
                      *, retry: RetryConfig | None = None) -> PersistStats:
    """Download a persisted prefix into `dest_dir`, trusting the manifests:
    only manifest-listed files are fetched (stale/torn strays are ignored),
    each download retries and is validated against its recorded size."""
    retry = retry or DEFAULT_RETRY
    stats = PersistStats()
    keys = backend.list_prefix(src_prefix)
    manifest_keys = [k for k in keys if posixpath.basename(k) == MANIFEST_NAME]
    if not manifest_keys:
        raise StorageError(f"no manifest under {src_prefix} — nothing "
                           "committed here (torn or foreign prefix)")
    # every subtree holding data must be vouched for by a manifest in its
    # dirname chain: a rank shard whose uploader died pre-manifest must fail
    # the restore loudly, not silently vanish from the result. (Stray files
    # *inside* a manifested dir are merely unlisted leftovers — skipped.)
    manifest_dirs = {posixpath.dirname(k) for k in manifest_keys}
    for key in keys:
        name = posixpath.basename(key)
        if name in (MANIFEST_NAME, COMMIT_MARKER, COMPLETE_MARKER):
            continue
        d = posixpath.dirname(key)
        while True:
            if d in manifest_dirs:
                break
            if not d:
                raise StorageError(
                    f"unvouched subtree under {src_prefix}: {key!r} has no "
                    "manifest in its directory chain (torn upload?)")
            d = posixpath.dirname(d)
    expected: dict[str, int] = {}
    for mk in manifest_keys:
        sub = posixpath.dirname(mk)
        manifest = read_manifest(
            backend, join_path(src_prefix, sub) if sub else src_prefix, retry)
        for entry in (manifest or {"files": []})["files"]:
            rel = posixpath.join(sub, entry["path"]) if sub else entry["path"]
            expected[rel] = entry["size"]

    def fetch(rel: str, size: int) -> None:
        local = os.path.join(dest_dir, rel.replace("/", os.sep))
        backend.download_file(join_path(src_prefix, rel), local)
        got = os.path.getsize(local)
        if got != size:
            raise StorageError(
                f"size mismatch for {rel}: manifest {size}, downloaded {got}")

    os.makedirs(dest_dir, exist_ok=True)
    for rel, size in sorted(expected.items()):
        _res, extra = _with_retry(fetch, rel, size, retry=retry,
                                  op=f"download {rel}")
        stats.files += 1
        stats.bytes += size
        stats.retries += extra
    # also materialize the commit metadata (manifests + markers) so a
    # restored view matches the zero-copy local one byte for byte
    for rel in keys:
        if posixpath.basename(rel) not in (MANIFEST_NAME, COMMIT_MARKER,
                                           COMPLETE_MARKER):
            continue
        _res, extra = _with_retry(
            backend.download_file, join_path(src_prefix, rel),
            os.path.join(dest_dir, rel.replace("/", os.sep)),
            retry=retry, op=f"download {rel}")
        stats.retries += extra
    _observe_transfer(backend, "download", stats)
    return stats


def write_complete_marker(backend: StorageBackend, ckpt_prefix: str) -> None:
    """The controller's registration marker. Its payload records WHICH rank
    shards the checkpoint had when marked, so recovery can detect a marked
    checkpoint that later lost shards (e.g. a retention delete crashed
    halfway) instead of silently resuming from the surviving subset."""
    ranks = [r for r in list_subdirs(backend, ckpt_prefix)
             if r.startswith("rank_") and not r.endswith(".tmp")]
    payload = json.dumps({"ranks": ranks}, sort_keys=True).encode()
    backend.write_bytes(join_path(ckpt_prefix, COMPLETE_MARKER), payload)


# -------------------------------------------------------- recovery scanning


def list_subdirs(backend: StorageBackend, prefix: str) -> list[str]:
    return backend.list_children(prefix)


def list_committed_checkpoints(
        backend: StorageBackend, exp_prefix: str, world_size: int,
        skip: "set[str] | None" = None) -> list[tuple[str, dict]]:
    """Scan an experiment prefix for checkpoint dirs safe to register:
    every rank prefix two-phase-committed (marker + validating manifest),
    and either the controller's COMPLETE_MARKER present or all
    `world_size` rank dirs accounted for. The manifest is the authority —
    a `checkpoint_*`-named dir with unverifiable contents is torn, not
    recoverable. Prefixes in `skip` (e.g. already-tracked checkpoints) are
    not re-validated — recovery loops would otherwise re-stat every file of
    every trusted checkpoint on each restart.
    Returns [(checkpoint_path, rank0_manifest_meta)] sorted."""
    out: list[tuple[str, dict]] = []
    for name in list_subdirs(backend, exp_prefix):
        if not name.startswith("checkpoint_"):
            continue
        path = join_path(exp_prefix, name)
        if skip and path in skip:
            continue
        ranks = [r for r in list_subdirs(backend, path)
                 if r.startswith("rank_") and not r.endswith(".tmp")]
        if not ranks:
            continue
        marker = join_path(path, COMPLETE_MARKER)
        marked = backend.exists(marker)
        if not all(is_committed(backend, join_path(path, r)) for r in ranks):
            # legacy format (pre-manifest): marker-trusted, no rank carries
            # any manifest. A MIXED dir (some manifests) is a torn modern
            # write, never recoverable
            legacy = marked and not any(
                backend.exists(join_path(path, r, MANIFEST_NAME))
                for r in ranks)
            if legacy:
                out.append((path, {}))
            continue
        if marked:
            try:  # marker payload = rank set at registration time; any
                # recorded shard now missing means a partial delete, not a
                # resumable checkpoint (empty/legacy payloads stay trusted)
                recorded = json.loads(with_retry(
                    backend.read_bytes, marker, op="read complete marker"))
                if not set(recorded.get("ranks") or []) <= set(ranks):
                    continue
            except (StorageError, ValueError):
                pass
        meta: dict = {}
        recorded_ws = None
        for r in ranks:  # rank_0's meta preferred, but ANY rank's manifest
            # records the writing attempt's world size (rank_0's shard may
            # be the missing one)
            try:
                manifest = read_manifest(backend, join_path(path, r))
            except StorageError:
                continue
            if manifest:
                m = manifest.get("meta", {})
                recorded_ws = recorded_ws or m.get("world_size")
                if r == "rank_0" or not meta:
                    meta = m
                if meta and recorded_ws:
                    break  # sorted scan: rank_0 (if present) came first
        if not marked:
            # completeness fallback: trust the writing attempt's recorded
            # world size over the caller's (possibly elastically downsized)
            # current size
            if len(ranks) < (recorded_ws or world_size):
                continue
        out.append((path, meta))
    return out
