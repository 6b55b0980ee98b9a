"""The port's checkpoint storage layer against the JAX package's.

Twins of tests/test_storage.py: URI dispatch, the two-phase commit,
retries, torn writes, restore validation, the Checkpoint handle,
retention, recovery scanning, the session's persist path, the controller's
veto, and trainer and Tune runs on the mock remote store. Each test runs
the reference's body once per package (``P`` holds that package's
modules), each in a directory of its own with its own mock store root
(``RAY_TPU_MOCK_STORE_ROOT`` and the port's
``RAY_TPU_TORCH_MOCK_STORE_ROOT``); the cluster runs go through both
runtimes at once (tests/torch_twins.py) and compare what they return.
"""

import importlib
import json
import os
import pickle
import types

import pytest

from torch_twins import env_name, same, start_sessions, sub

PKGS = ("ray_tpu", "ray_tpu_torch")


def _ns(pkg: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    cm = mod("train.checkpoint_manager")
    return types.SimpleNamespace(
        name=pkg, st=mod("train.storage"), train=mod("train"),
        Checkpoint=mod("train._checkpoint").Checkpoint,
        CheckpointManager=cm.CheckpointManager,
        COMPLETE_MARKER=cm.COMPLETE_MARKER,
        CheckpointConfig=mod("train.config").CheckpointConfig,
        TrainSession=mod("train.session").TrainSession,
        TrainController=mod("train.controller").TrainController,
        Tuner=mod("tune.tuner").Tuner,
        ser=mod("_private.serialization"))


def _both(body, tmp_path, monkeypatch):
    """body(P, tmp) for each package, in a directory of its own and with
    its own mock object store root under it."""
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        monkeypatch.setenv(env_name(importlib.import_module(pkg),
                                    "MOCK_STORE_ROOT"),
                           str(d / "mock_store"))
        body(_ns(pkg), d)


def _make_src(tmp_path, name="src", files=None):
    src = tmp_path / name
    src.mkdir(exist_ok=True)
    for rel, content in (files or {"a.txt": "hello", "sub/b.bin": "b" * 64}).items():
        p = src / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(content)
    return str(src)


# ----------------------------------------------------------- URI dispatch


def test_uri_dispatch_local_and_file_scheme(tmp_path, monkeypatch):
    def body(P, tmp_path):
        for uri in [str(tmp_path / "x"), f"file://{tmp_path}/x"]:
            backend, path = P.st.get_storage_backend(uri)
            assert backend.is_local
            assert path == str(tmp_path / "x")

    _both(body, tmp_path, monkeypatch)


def test_uri_dispatch_mock_parses_fault_knobs(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, path = P.st.get_storage_backend(
            "mock://bkt/pfx?fail_rate=0.25&torn_rate=0.1&latency_ms=2&seed=7")
        assert not backend.is_local
        assert path == "mock://bkt/pfx"  # query stripped from the clean path
        assert backend.faults.fail_rate == 0.25
        assert backend.faults.torn_rate == 0.1
        assert backend.faults.seed == 7

    _both(body, tmp_path, monkeypatch)


def test_uri_dispatch_unknown_scheme_raises(tmp_path, monkeypatch):
    def body(P, tmp_path):
        with pytest.raises(P.st.StorageError, match="no storage backend"):
            P.st.get_storage_backend("s3://nope/bucket")

    _both(body, tmp_path, monkeypatch)


def test_register_custom_scheme(tmp_path, monkeypatch):
    def body(P, tmp_path):
        def factory(uri):
            backend = P.st.LocalBackend()
            return backend, backend.normalize(str(tmp_path / "custom"))

        P.st.register_storage_backend("customfs", factory)
        try:
            backend, path = P.st.get_storage_backend("customfs://whatever")
            assert backend.is_local and path.endswith("custom")
        finally:
            P.st._SCHEMES.pop("customfs", None)

    _both(body, tmp_path, monkeypatch)


def test_join_path_preserves_query(tmp_path, monkeypatch):
    def body(P, tmp_path):
        assert (P.st.join_path("mock://b/x?fail_rate=0.5", "ckpt", "rank_0")
                == "mock://b/x/ckpt/rank_0?fail_rate=0.5")
        assert P.st.basename("mock://b/x/checkpoint_000003?seed=1") == "checkpoint_000003"

    _both(body, tmp_path, monkeypatch)


# ------------------------------------------------- two-phase commit + restore


@pytest.mark.parametrize("uri_fmt", ["{tmp}/local_store", "mock://bkt/exp"])
def test_persist_restore_roundtrip(tmp_path, monkeypatch, uri_fmt):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend(uri_fmt.format(tmp=tmp_path))
        src = _make_src(tmp_path)
        prefix = P.st.join_path(base, "checkpoint_000000", "rank_0")
        stats = P.st.persist_directory(backend, src, prefix, meta={"metrics": {"x": 1}})
        assert stats.files == 2
        assert P.st.is_committed(backend, prefix)
        dest = str(tmp_path / "restored")
        P.st.restore_directory(backend, prefix, dest)
        assert open(os.path.join(dest, "a.txt")).read() == "hello"
        assert open(os.path.join(dest, "sub", "b.bin")).read() == "b" * 64
        manifest = P.st.read_manifest(backend, prefix)
        assert manifest["meta"]["metrics"] == {"x": 1}
        assert {f["path"] for f in manifest["files"]} == {"a.txt", "sub/b.bin"}

    _both(body, tmp_path, monkeypatch)


def _flaky_backend(P, fail_n):
  class _FlakyBackend(P.st.LocalBackend):
    """Deterministically fails the first `fail_n` data-plane calls."""

    def __init__(self, fail_n):
        self.remaining = fail_n

    def _maybe_fail(self):
        if self.remaining > 0:
            self.remaining -= 1
            raise P.st.StorageError("transient flake")

    def upload_file(self, local_path, dest_path):
        self._maybe_fail()
        super().upload_file(local_path, dest_path)

    def write_bytes(self, path, data):
        self._maybe_fail()
        super().write_bytes(path, data)

    def download_file(self, src_path, local_path):
        self._maybe_fail()
        super().download_file(src_path, local_path)
  return _FlakyBackend(fail_n)


def test_persist_retries_with_backoff_and_counts(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend = _flaky_backend(P, fail_n=3)
        src = _make_src(tmp_path)
        prefix = str(tmp_path / "store" / "ck")
        stats = P.st.persist_directory(
            backend, src, prefix,
            retry=P.st.RetryConfig(max_attempts=4, base_delay_s=0.001))
        assert stats.retries == 3  # exactly the injected flakes, no more
        assert P.st.is_committed(backend, prefix)

    _both(body, tmp_path, monkeypatch)


def test_persist_exhausts_retry_budget_raises(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp?fail_rate=1.0&seed=1")
        src = _make_src(tmp_path)
        retry = P.st.RetryConfig(max_attempts=3, base_delay_s=0.001)
        with pytest.raises(P.st.StorageError, match="after 3 attempt"):
            P.st.persist_directory(backend, src, P.st.join_path(base, "ck"), retry=retry)
        assert not P.st.is_committed(backend, P.st.join_path(base, "ck"))

    _both(body, tmp_path, monkeypatch)


def test_torn_writes_never_commit(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp?torn_rate=1.0&seed=2")
        src = _make_src(tmp_path)
        prefix = P.st.join_path(base, "ck")
        with pytest.raises(P.st.StorageError):
            P.st.persist_directory(
                backend, src, prefix,
                retry=P.st.RetryConfig(max_attempts=2, base_delay_s=0.001))
        # a torn (partial) object may exist, but the prefix is not committed and
        # restore refuses it rather than returning corrupt data
        assert not P.st.is_committed(backend, prefix)
        with pytest.raises(P.st.StorageError):
            P.st.restore_directory(backend, prefix, str(tmp_path / "out"))

    _both(body, tmp_path, monkeypatch)


def test_restore_validates_manifest_sizes(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        prefix = P.st.join_path(base, "ck")
        P.st.persist_directory(backend, src, prefix)
        # corrupt the stored object behind the API's back (bit-rot / torn blob)
        blob = backend._local(P.st.join_path(prefix, "sub/b.bin"))
        with open(blob, "wb") as f:
            f.write(b"short")
        assert not P.st.validate_manifest(backend, prefix)
        assert not P.st.is_committed(backend, prefix)
        with pytest.raises(P.st.StorageError, match="size mismatch|download"):
            P.st.restore_directory(
                backend, prefix, str(tmp_path / "out"),
                retry=P.st.RetryConfig(max_attempts=2, base_delay_s=0.001))

    _both(body, tmp_path, monkeypatch)


def test_restore_ignores_stray_uncommitted_objects(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        prefix = P.st.join_path(base, "ck")
        P.st.persist_directory(backend, src, prefix)
        backend.write_bytes(P.st.join_path(prefix, "stale_garbage.bin"), b"torn junk")
        dest = str(tmp_path / "out")
        P.st.restore_directory(backend, prefix, dest)
        assert not os.path.exists(os.path.join(dest, "stale_garbage.bin"))
        assert open(os.path.join(dest, "a.txt")).read() == "hello"

    _both(body, tmp_path, monkeypatch)


def test_restore_fails_loudly_on_unvouched_rank_subtree(tmp_path, monkeypatch):
    """A rank shard whose uploader died before writing its manifest must
    fail the whole-checkpoint restore, not silently vanish from it."""
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        ck = P.st.join_path(base, "checkpoint_000000")
        P.st.persist_directory(backend, src, P.st.join_path(ck, "rank_0"))
        backend.write_bytes(P.st.join_path(ck, "rank_1", "state.txt"), b"partial")
        with pytest.raises(P.st.StorageError, match="unvouched"):
            P.st.restore_directory(backend, ck, str(tmp_path / "out"))

    _both(body, tmp_path, monkeypatch)


def test_read_failures_are_retried(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend(
            "mock://bkt/exp?read_fail_rate=0.4&seed=3")
        src = _make_src(tmp_path)
        prefix = P.st.join_path(base, "ck")
        P.st.persist_directory(backend, src, prefix)
        stats = P.st.restore_directory(
            backend, prefix, str(tmp_path / "out"),
            retry=P.st.RetryConfig(max_attempts=10, base_delay_s=0.001))
        assert stats.files == 2
        assert open(str(tmp_path / "out" / "a.txt")).read() == "hello"

    _both(body, tmp_path, monkeypatch)


# -------------------------------------------------------- P.Checkpoint handle


def test_checkpoint_local_zero_copy_behavior(tmp_path, monkeypatch):
    def body(P, tmp_path):
        src = _make_src(tmp_path)
        ck = P.Checkpoint.from_directory(src)
        with ck.as_directory() as d:
            assert d == os.path.abspath(src)  # zero-copy: the stored path itself

    _both(body, tmp_path, monkeypatch)


def test_checkpoint_remote_download_on_demand(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        prefix = P.st.join_path(base, "checkpoint_000000", "rank_0")
        P.st.persist_directory(backend, src, prefix)
        ck = P.Checkpoint(prefix, backend=backend)
        with ck.as_directory() as d:
            assert d != prefix
            assert open(os.path.join(d, "a.txt")).read() == "hello"
        assert not os.path.exists(d)  # temp view cleaned up
        out = ck.to_directory(str(tmp_path / "mat"))
        assert open(os.path.join(out, "a.txt")).read() == "hello"

    _both(body, tmp_path, monkeypatch)


def test_checkpoint_reduce_preserves_subclass_and_backend(tmp_path, monkeypatch):
    def body(P, tmp_path):
        ser = P.ser

        class MyCheckpoint(P.Checkpoint):
            pass

        # subclasses survive serialization through the object store
        local = ser.loads(ser.dumps(MyCheckpoint.from_directory(str(tmp_path))))
        assert type(local).__name__ == "MyCheckpoint"
        assert isinstance(local, P.Checkpoint) and type(local) is not P.Checkpoint
        backend, base = P.st.get_storage_backend("mock://bkt/exp?fail_rate=0.5&seed=9")
        remote = ser.loads(ser.dumps(MyCheckpoint(base, backend=backend)))
        assert type(remote).__name__ == "MyCheckpoint"
        assert remote.backend.faults.fail_rate == 0.5  # fault knobs travel too
        # plain pickle also round-trips the (backend, path) pair
        plain = pickle.loads(pickle.dumps(P.Checkpoint(base, backend=backend)))
        assert plain.path == base and not plain.backend.is_local

    _both(body, tmp_path, monkeypatch)


def test_checkpoint_subdir_restores_single_rank_shard(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        ck_prefix = P.st.join_path(base, "checkpoint_000000")
        for r in range(2):
            src = _make_src(tmp_path, name=f"r{r}", files={"w.txt": f"rank{r}"})
            P.st.persist_directory(backend, src, P.st.join_path(ck_prefix, f"rank_{r}"))
        shard = P.Checkpoint(ck_prefix, backend=backend).subdir("rank_1")
        with shard.as_directory() as d:
            # only this rank's bytes moved (commit metadata dotfiles ride along
            # so the view matches the zero-copy local one)
            assert [x for x in os.listdir(d) if not x.startswith(".")] == ["w.txt"]
            assert open(os.path.join(d, "w.txt")).read() == "rank1"

    _both(body, tmp_path, monkeypatch)


def test_checkpoint_from_uri_autoresolves(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        P.st.persist_directory(backend, src, P.st.join_path(base, "ck"))
        ck = P.Checkpoint.from_uri("mock://bkt/exp/ck")
        assert not ck.backend.is_local
        with ck.as_directory() as d:
            assert open(os.path.join(d, "a.txt")).read() == "hello"

    _both(body, tmp_path, monkeypatch)


# -------------------------------------------- P.CheckpointManager retention


def _register_n(P, mgr, tmp_path, metrics_list):
    paths = []
    for i, m in enumerate(metrics_list):
        p = tmp_path / f"ckpt_{i}"
        p.mkdir(exist_ok=True)
        (p / "w.txt").write_text(str(i))
        paths.append(str(p))
        mgr.register(P.Checkpoint.from_directory(str(p)), m)
    return paths


def test_retention_num_to_keep_zero_keeps_only_latest(tmp_path, monkeypatch):
    def body(P, tmp_path):
        mgr = P.CheckpointManager(P.CheckpointConfig(num_to_keep=0))
        paths = _register_n(P, mgr, tmp_path, [{"acc": 0.9}, {"acc": 0.1}, {"acc": 0.5}])
        kept = [t.checkpoint.path for t in mgr._tracked]
        assert kept == [paths[2]]  # resume point survives even num_to_keep=0
        assert not os.path.exists(paths[0]) and not os.path.exists(paths[1])

    _both(body, tmp_path, monkeypatch)


def test_retention_score_ties_prefer_newer(tmp_path, monkeypatch):
    def body(P, tmp_path):
        cfg = P.CheckpointConfig(num_to_keep=1, checkpoint_score_attribute="acc")
        mgr = P.CheckpointManager(cfg)
        paths = _register_n(P, mgr, tmp_path, [{"acc": 0.5}, {"acc": 0.5}, {"acc": 0.5}])
        kept = [t.checkpoint.path for t in mgr._tracked]
        assert kept == [paths[2]]  # deterministic: the tie breaks toward recency
        assert mgr.best_checkpoint.path == paths[2]

    _both(body, tmp_path, monkeypatch)


def test_retention_missing_score_attribute_falls_back_to_recency(tmp_path, monkeypatch):
    def body(P, tmp_path):
        cfg = P.CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="nope")
        mgr = P.CheckpointManager(cfg)
        paths = _register_n(P, mgr, tmp_path, [{"a": 1}, {"a": 2}, {"a": 3}, {"a": 4}])
        kept = [t.checkpoint.path for t in mgr._tracked]
        assert kept == [paths[2], paths[3]]  # most recent two
        assert not os.path.exists(paths[0])

    _both(body, tmp_path, monkeypatch)


def test_retention_latest_never_deleted_even_if_worst(tmp_path, monkeypatch):
    def body(P, tmp_path):
        cfg = P.CheckpointConfig(num_to_keep=1, checkpoint_score_attribute="acc")
        mgr = P.CheckpointManager(cfg)
        paths = _register_n(P, mgr, tmp_path, [{"acc": 0.9}, {"acc": 0.8}, {"acc": 0.1}])
        kept = [t.checkpoint.path for t in mgr._tracked]
        assert paths[2] in kept        # latest (worst score) still the resume point
        assert paths[0] in kept        # best score retained
        assert mgr.latest_checkpoint.path == paths[2]
        assert mgr.best_checkpoint.path == paths[0]

    _both(body, tmp_path, monkeypatch)


def test_retention_deletes_via_backend_for_remote(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        mgr = P.CheckpointManager(P.CheckpointConfig(num_to_keep=1))
        prefixes = []
        for i in range(3):
            src = _make_src(tmp_path, name=f"s{i}")
            prefix = P.st.join_path(base, f"checkpoint_{i:06d}")
            P.st.persist_directory(backend, src, P.st.join_path(prefix, "rank_0"))
            prefixes.append(prefix)
            mgr.register(P.Checkpoint(prefix, backend=backend), {"i": i})
        assert not backend.exists(prefixes[0])  # deleted from the object store
        assert backend.exists(prefixes[2])

    _both(body, tmp_path, monkeypatch)


def test_reregistration_rewrites_missing_complete_marker(tmp_path, monkeypatch):
    def body(P, tmp_path):
        mgr = P.CheckpointManager(P.CheckpointConfig())
        src = _make_src(tmp_path, name="ck")
        ck = P.Checkpoint.from_directory(src)
        mgr.register(ck, {"a": 1})
        marker = os.path.join(src, P.COMPLETE_MARKER)
        assert os.path.exists(marker)
        os.remove(marker)  # e.g. storage-recovered dir that predates its marker
        mgr.register(ck, {"a": 2})  # re-registration path
        assert os.path.exists(marker)
        assert mgr._tracked[0].metrics == {"a": 2}

    _both(body, tmp_path, monkeypatch)


# ------------------------------------------------------- recovery scanning


def test_recovery_trusts_manifest_not_name_prefix(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        # committed checkpoint
        good = P.st.join_path(base, "checkpoint_000001")
        P.st.persist_directory(backend, src, P.st.join_path(good, "rank_0"),
                             meta={"metrics": {"loss": 0.5}, "iteration": 1})
        # torn dir: checkpoint_* name, rank files present, but no commit marker
        torn = P.st.join_path(base, "checkpoint_000002")
        backend.write_bytes(P.st.join_path(torn, "rank_0", "state.txt"), b"par")
        # committed but wrong sizes (bit-rot after commit): also untrusted
        rotten = P.st.join_path(base, "checkpoint_000003")
        P.st.persist_directory(backend, src, P.st.join_path(rotten, "rank_0"))
        with open(backend._local(P.st.join_path(rotten, "rank_0", "a.txt")), "wb") as f:
            f.write(b"x")
        found = P.st.list_committed_checkpoints(backend, base, world_size=1)
        assert [p for p, _ in found] == [good]
        assert found[0][1]["metrics"] == {"loss": 0.5}  # metrics ride the manifest

    _both(body, tmp_path, monkeypatch)


def test_recovery_requires_all_ranks_unless_marked(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        ck = P.st.join_path(base, "checkpoint_000000")
        P.st.persist_directory(backend, src, P.st.join_path(ck, "rank_0"))
        # only 1 of 2 ranks committed → not recoverable at world_size=2
        assert P.st.list_committed_checkpoints(backend, base, world_size=2) == []
        # unless the controller's P.COMPLETE_MARKER vouches for it
        backend.write_bytes(P.st.join_path(ck, P.st.COMPLETE_MARKER), b"")
        assert [p for p, _ in
                P.st.list_committed_checkpoints(backend, base, world_size=2)] == [ck]

    _both(body, tmp_path, monkeypatch)


def test_recovery_accepts_legacy_marker_only_checkpoints(tmp_path, monkeypatch):
    """Pre-manifest-era checkpoints (marker, no manifests anywhere) stay
    recoverable; a MIXED dir (some manifests) is a torn modern write."""
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        ck = P.st.join_path(base, "checkpoint_000000")
        for r in range(2):
            backend.write_bytes(P.st.join_path(ck, f"rank_{r}", "state.txt"), b"old")
        assert P.st.list_committed_checkpoints(backend, base, 2) == []  # unmarked
        backend.write_bytes(P.st.join_path(ck, P.st.COMPLETE_MARKER), b"")
        assert [p for p, _ in
                P.st.list_committed_checkpoints(backend, base, 2)] == [ck]
        src = _make_src(tmp_path)
        ck2 = P.st.join_path(base, "checkpoint_000001")
        P.st.persist_directory(backend, src, P.st.join_path(ck2, "rank_0"))
        backend.write_bytes(P.st.join_path(ck2, "rank_1", "state.txt"), b"partial")
        backend.write_bytes(P.st.join_path(ck2, P.st.COMPLETE_MARKER), b"")
        assert [p for p, _ in
                P.st.list_committed_checkpoints(backend, base, 2)] == [ck]

    _both(body, tmp_path, monkeypatch)


def test_downsized_recovery_respects_writing_world_size(tmp_path, monkeypatch):
    """A checkpoint the controller vetoed (one of two ranks failed to
    persist) must not become recoverable after an elastic downsize to 1:
    the manifest records the writing attempt's world size."""
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        ck = P.st.join_path(base, "checkpoint_000000")
        P.st.persist_directory(backend, src, P.st.join_path(ck, "rank_0"),
                             meta={"world_size": 2})
        assert P.st.list_committed_checkpoints(backend, base, world_size=1) == []
        assert P.st.list_committed_checkpoints(backend, base, world_size=2) == []

    _both(body, tmp_path, monkeypatch)


def test_tuner_restore_falls_back_to_backup_snapshot(tmp_path, monkeypatch):
    """A torn overwrite of experiment_state.json (partial object in place)
    must not make the experiment unrestorable — the backup slot holds the
    previous good generation."""
    def body(P, tmp_path):
        Tuner = P.Tuner

        backend, base = P.st.get_storage_backend("mock://bkt/exp/run")
        good = json.dumps([{"trial_id": "trial_0000", "config": {"x": 1},
                            "status": "TERMINATED", "last_result": {"score": 1},
                            "iteration": 1, "error": None,
                            "checkpoint_path": None}]).encode()
        backend.write_bytes(P.st.join_path(base, "experiment_state.bak.json"), good)
        backend.write_bytes(P.st.join_path(base, "experiment_state.json"),
                            good[: len(good) // 2])  # torn canonical
        tuner = Tuner.restore("mock://bkt/exp/run", lambda config: None,
                              param_space={"x": [1]})
        assert tuner._restore_summaries[0]["trial_id"] == "trial_0000"

    _both(body, tmp_path, monkeypatch)


def test_marked_checkpoint_missing_recorded_shard_not_recovered(tmp_path, monkeypatch):
    """The COMPLETE marker records its rank set: a retention delete that
    crashed halfway (one shard gone, marker intact) must not leave a
    recoverable-looking checkpoint — even after an elastic downsize."""
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/exp")
        src = _make_src(tmp_path)
        ck = P.st.join_path(base, "checkpoint_000000")
        for r in range(2):
            P.st.persist_directory(backend, src, P.st.join_path(ck, f"rank_{r}"))
        P.st.write_complete_marker(backend, ck)
        assert [p for p, _ in
                P.st.list_committed_checkpoints(backend, base, 2)] == [ck]
        backend.delete_prefix(P.st.join_path(ck, "rank_1"))  # crashed half-delete
        assert P.st.list_committed_checkpoints(backend, base, 2) == []
        assert P.st.list_committed_checkpoints(backend, base, 1) == []

    _both(body, tmp_path, monkeypatch)


# ----------------------------------------------------- session persist path


def _session(P, tmp_path, backend, exp_dir, **kw):
    return P.TrainSession(rank=0, world_size=1, local_rank=0, local_world_size=1,
                        node_rank=0, experiment_dir=exp_dir,
                        experiment_name="t", storage_backend=backend, **kw)


def test_session_report_uploads_two_phase(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/run")
        s = _session(P, tmp_path, backend, base)
        src = _make_src(tmp_path)
        s.report({"loss": 1.0}, checkpoint=P.Checkpoint.from_directory(src))
        reports = s.drain_reports()
        assert reports[0]["checkpoint_dir"] == P.st.join_path(base, "checkpoint_000000")
        assert P.st.is_committed(
            backend, P.st.join_path(base, "checkpoint_000000", "rank_0"))
        manifest = P.st.read_manifest(
            backend, P.st.join_path(base, "checkpoint_000000", "rank_0"))
        assert manifest["meta"]["metrics"] == {"loss": 1.0}

    _both(body, tmp_path, monkeypatch)


def test_session_persist_failure_degrades_by_default(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/run?fail_rate=1.0&seed=4")
        s = _session(P, tmp_path, backend, base,
                     storage_retry=P.st.RetryConfig(max_attempts=2, base_delay_s=0.001))
        src = _make_src(tmp_path)
        s.report({"loss": 1.0}, checkpoint=P.Checkpoint.from_directory(src))
        rep = s.drain_reports()[0]
        assert rep["checkpoint_dir"] is None  # degraded: metrics flow, no ckpt
        assert rep["metrics"] == {"loss": 1.0}
        assert s.persist_failures == 1

    _both(body, tmp_path, monkeypatch)


def test_session_persist_failure_raises_when_configured(tmp_path, monkeypatch):
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/run?fail_rate=1.0&seed=4")
        s = _session(P, tmp_path, backend, base, fail_on_persist_error=True,
                     storage_retry=P.st.RetryConfig(max_attempts=2, base_delay_s=0.001))
        src = _make_src(tmp_path)
        with pytest.raises(P.st.StorageError):
            s.report({"loss": 1.0}, checkpoint=P.Checkpoint.from_directory(src))

    _both(body, tmp_path, monkeypatch)


def test_controller_vetoes_checkpoint_with_degraded_rank(tmp_path,
                                                          monkeypatch):
    """Unit-level veto: one rank's persist degraded (persist_failed=True) →
    the controller must not register the checkpoint even though the other
    rank committed its shard."""
    def body(P, tmp_path):
        backend, base = P.st.get_storage_backend("mock://bkt/run")
        ctrl = P.TrainController._cls.__new__(P.TrainController._cls)
        ctrl.ckpt_manager = P.CheckpointManager(P.CheckpointConfig())
        ctrl.latest_metrics = {}
        ctrl._retries_prev_attempts = 0
        ctrl._attempt_retries = 0
        ctrl._storage = backend
        ctrl._iter_buffer = {0: {
            0: {"iter": 0, "rank": 0, "metrics": {"loss": 1.0},
                "checkpoint_dir": None, "persist_failed": True,
                "storage_retries": 4},
            1: {"iter": 0, "rank": 1, "metrics": {"loss": 1.0},
                "checkpoint_dir": P.st.join_path(base, "checkpoint_000000"),
                "persist_failed": False, "storage_retries": 0},
        }}
        ctrl._consume_complete_iters(2)
        assert ctrl.ckpt_manager.latest_checkpoint is None  # vetoed
        assert ctrl.latest_metrics == {"loss": 1.0}
        assert ctrl._iter_buffer == {}
        ctrl._iter_buffer = {1: {
            0: {"iter": 1, "rank": 0, "metrics": {"loss": 0.5},
                "checkpoint_dir": P.st.join_path(base, "checkpoint_000001"),
                "persist_failed": False, "storage_retries": 0},
            1: {"iter": 1, "rank": 1, "metrics": {"loss": 0.5},
                "checkpoint_dir": None, "persist_failed": False,
                "storage_retries": 0},
        }}
        ctrl._consume_complete_iters(2)
        assert ctrl.ckpt_manager.latest_checkpoint is not None

    _both(body, tmp_path, monkeypatch)


# ------------------------------------------------- end-to-end on a cluster


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=8, num_workers=2, max_workers=8)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


@pytest.fixture
def mock_bucket():
    """A unique bucket in each package's default store root: controller
    and worker processes do not see the test's env, but they all resolve
    the same default root, so bucket-uniqueness is the isolation."""
    import shutil
    import uuid

    bucket = f"t{uuid.uuid4().hex[:12]}"
    yield bucket
    for pkg in PKGS:
        st = importlib.import_module(f"{pkg}.train.storage")
        root = st.MockRemoteBackend(bucket).store_root
        shutil.rmtree(os.path.join(root, bucket), ignore_errors=True)
        shutil.rmtree(os.path.join(root, ".internal", bucket),
                      ignore_errors=True)


def test_trainer_fit_on_mock_storage(pkgs, mock_bucket):
    """Full trainer run against the mock remote store: checkpoints upload
    through the backend, the result checkpoint downloads on demand."""
    def scn(rt):
        pkg, train = rt.__name__, sub(rt, "train")

        def train_fn(config):
            import importlib
            import tempfile

            t = importlib.import_module(pkg + ".train")
            for i in range(2):
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "state.txt"), "w") as f:
                        f.write(f"iter={i}")
                    t.report({"iter": i},
                             checkpoint=t.Checkpoint.from_directory(d))

        result = train.DataParallelTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(
                name="mockrun",
                storage_path=f"mock://{mock_bucket}/results?latency_ms=1"),
        ).fit()
        with result.checkpoint.as_directory() as d:
            ranks = sorted(x for x in os.listdir(d) if not x.startswith("."))
            state = open(os.path.join(d, "rank_0", "state.txt")).read()
        return (result.error, result.metrics["iter"], result.checkpoint.path,
                ranks, state, result.storage_retries)

    same(pkgs, scn, (None, 1,
                     f"mock://{mock_bucket}/results/mockrun/checkpoint_000001",
                     ["rank_0", "rank_1"], "iter=1", 0), serve_cleanup=False)


@pytest.mark.slow
def test_degraded_rank_vetoes_checkpoint_registration(pkgs, mock_bucket):
    """fail_on_key pins a permanent outage on rank_0's uploads: the
    controller never registers a checkpoint missing a rank, metrics still
    flow and the run finishes without a resume point."""
    uri = f"mock://{mock_bucket}/runs?fail_on_key=rank_0"

    def scn(rt):
        pkg, train = rt.__name__, sub(rt, "train")
        st = sub(rt, "train.storage")

        def train_fn(config):
            import importlib
            import tempfile

            t = importlib.import_module(pkg + ".train")
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "w.txt"), "w") as f:
                    f.write("x")
                t.report({"step": 1}, checkpoint=t.Checkpoint.from_directory(d))

        result = train.DataParallelTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="degraded", storage_path=uri),
        ).fit()
        backend, base = st.get_storage_backend(uri)
        return (result.error, result.metrics, result.checkpoint,
                st.list_committed_checkpoints(
                    backend, st.join_path(base, "degraded"), world_size=2))

    same(pkgs, scn, (None, {"step": 1}, None, []), serve_cleanup=False)


@pytest.mark.slow
def test_tuner_on_mock_storage_and_restore_uri(pkgs, mock_bucket):
    """Tune trials persist under per-trial mock:// prefixes; Tuner.restore
    from the storage URI sees the finished trials without re-running."""
    uri = f"mock://{mock_bucket}/tune_exp"

    def scn(rt):
        pkg = rt.__name__
        tune, train, st = sub(rt, "tune"), sub(rt, "train"), \
            sub(rt, "train.storage")

        def trainable(config):
            import importlib
            import tempfile

            t = importlib.import_module(pkg + ".train")
            with tempfile.TemporaryDirectory() as d:
                with open(os.path.join(d, "v.txt"), "w") as f:
                    f.write(str(config["x"]))
                t.report({"score": config["x"] * 10},
                         checkpoint=t.Checkpoint.from_directory(d))

        grid = tune.Tuner(
            trainable, param_space={"x": tune.grid_search([1, 2])},
            tune_config=tune.TuneConfig(metric="score", mode="max"),
            run_config=train.RunConfig(name=f"grid_{pkg}",
                                       storage_path=uri)).fit()
        best = grid.get_best_result()
        with best.checkpoint.as_directory() as d:
            v = open(os.path.join(d, "rank_0", "v.txt")).read()
        backend, base = st.get_storage_backend(f"{uri}/grid_{pkg}")
        restored = tune.Tuner.restore(f"{uri}/grid_{pkg}", trainable).fit()
        return (len(grid), grid.errors, best.metrics["score"],
                best.checkpoint.backend.is_local, v,
                backend.exists(st.join_path(base, "experiment_state.json")),
                len(restored), restored.errors,
                restored.get_best_result().metrics["score"])

    same(pkgs, scn, (2, [], 20, False, "2", True, 2, [], 20),
         serve_cleanup=False)
