"""The port's MutableShmChannel (ray_tpu_torch/experimental/channel), and
the JAX package's static invariant suite (tools/graft_check) run over the
port's shm and threaded host modules.

Channels here are created in a per-test directory (``_DIR`` patched), so
no segment of these tests can show in another test's /dev/shm leak check.
"""

import errno
import gc
import os
import threading
import time

import pytest

from ray_tpu_torch._private import constants
from ray_tpu_torch.experimental.channel import mutable_shm
from ray_tpu_torch.experimental.channel.channel import ChannelClosed
from ray_tpu_torch.experimental.channel.mutable_shm import (
    MutableShmChannel, create_mutable_channel)

JOIN_S = 30.0


@pytest.fixture
def shm_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(mutable_shm, "_DIR", str(tmp_path))
    return tmp_path


def _files(d) -> list:
    return sorted(p.name for p in d.iterdir())


def _reader(path, capacity):
    return MutableShmChannel(path, capacity)


def test_prefix_is_the_ports_own():
    assert constants.SHM_CHANNEL_PREFIX != "rtpu_chan_"
    assert not constants.SHM_CHANNEL_PREFIX.startswith("rtpu_")
    assert constants.SHM_CHANNEL_GLOB == (constants.SHM_DIR + "/"
                                          + constants.SHM_CHANNEL_PREFIX + "*")


def test_seqlock_round_trip_across_threads(shm_dir):
    """A writer thread publishes 50 messages of varying size; the reader
    sees each exactly once, in order, and the writer never overwrites an
    unacked payload (each write blocks until the previous ack)."""
    ch = create_mutable_channel(4096)
    assert _files(shm_dir)[0].startswith(constants.SHM_CHANNEL_PREFIX)
    rd = _reader(ch.path, ch.capacity)
    msgs = [bytes([i % 251]) * (1 + 37 * i) for i in range(50)]

    def write():
        for m in msgs:
            ch.write_vectored([m], timeout=JOIN_S)

    t = threading.Thread(target=write)
    t.start()
    got = []
    for _ in msgs:
        view = rd.read_view(timeout=JOIN_S)
        got.append(bytes(view))
        del view
        rd.ack_read()
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    assert got == msgs
    assert not rd.poll() and rd.drained()
    rd.close_mapping()
    ch.close()
    ch.unlink()
    assert _files(shm_dir) == []


def test_vectored_write_joins_parts_and_checks_capacity(shm_dir):
    import numpy as np

    ch = create_mutable_channel(64)
    try:
        parts = [b"head", memoryview(np.arange(6, dtype=np.int32)),
                 bytearray(b"tail")]
        ch.write_vectored(parts, timeout=0)
        view = ch.read_view(timeout=0)
        assert bytes(view) == (b"head" + np.arange(6, dtype=np.int32)
                               .tobytes() + b"tail")
        del view
        ch.ack_read()
        with pytest.raises(ValueError, match="exceeds channel capacity"):
            ch.write_vectored([b"x" * 65], timeout=0)
        # a write on an unconsumed payload times out instead of clobbering
        ch.write_vectored([b"a"], timeout=0)
        with pytest.raises(TimeoutError):
            ch.write_vectored([b"b"], timeout=0.05)
    finally:
        ch.close()
        ch.unlink()


def test_drained_and_wait_drained(shm_dir):
    ch = create_mutable_channel(64)
    rd = _reader(ch.path, 64)
    try:
        assert not ch.drained()  # nothing published yet
        ch.write_vectored([b"x"], timeout=0)
        assert not ch.drained()
        with pytest.raises(TimeoutError):
            ch.wait_drained(timeout=0.05)

        def ack_later():
            time.sleep(0.1)
            del_view = rd.read_view(timeout=JOIN_S)
            del del_view
            rd.ack_read()

        t = threading.Thread(target=ack_later)
        t.start()
        ch.wait_drained(timeout=JOIN_S)
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        assert ch.drained()
    finally:
        rd.close_mapping()
        ch.close()
        ch.unlink()


def test_close_wakes_a_waiting_reader_and_writer(shm_dir):
    ch = create_mutable_channel(64)
    rd = _reader(ch.path, 64)
    seen = []

    def read():
        try:
            rd.read_view(timeout=JOIN_S)
        except ChannelClosed as e:
            seen.append(e)

    t = threading.Thread(target=read)
    t.start()
    time.sleep(0.05)
    ch.close()
    t.join(timeout=JOIN_S)
    assert not t.is_alive() and len(seen) == 1
    assert rd.closed()
    with pytest.raises(ChannelClosed):
        ch.write_vectored([b"x"], timeout=0)
    # a payload published before the close still reads; then closed
    ch2 = create_mutable_channel(64)
    ch2.write_vectored([b"last"], timeout=0)
    ch2.close()
    view = ch2.read_view(timeout=0)
    assert bytes(view) == b"last"
    del view
    ch2.ack_read()
    with pytest.raises(ChannelClosed):
        ch2.read_view(timeout=0)
    for c in (ch, ch2):
        c.unlink()
    rd.close_mapping()


def test_force_ack_unblocks_a_writer_of_a_dead_reader(shm_dir):
    ch = create_mutable_channel(64)
    try:
        ch.write_vectored([b"1"], timeout=0)
        done = []

        def write():
            ch.write_vectored([b"2"], timeout=JOIN_S)
            done.append(True)

        t = threading.Thread(target=write)
        t.start()
        time.sleep(0.05)
        assert not done  # blocked on the unacked first payload
        ch.force_ack()
        t.join(timeout=JOIN_S)
        assert not t.is_alive() and done
    finally:
        ch.close()
        ch.unlink()


def test_creator_unlinks_on_gc_and_mappings_survive(shm_dir):
    ch = create_mutable_channel(64)
    path = ch.path
    rd = _reader(path, 64)
    ch.write_vectored([b"kept"], timeout=0)
    attached = MutableShmChannel(path, 64)  # a non-creating handle
    del attached
    gc.collect()
    assert os.path.exists(path)  # only the creator owns the name
    del ch
    gc.collect()
    assert not os.path.exists(path)
    view = rd.read_view(timeout=0)  # the reader's mapping stays valid
    assert bytes(view) == b"kept"
    del view
    rd.close_mapping()


def test_create_fails_cleanly_when_the_segment_cannot_be_reserved(
        shm_dir, monkeypatch):
    """A full tmpfs: posix_fallocate raises ENOSPC, create_mutable_channel
    raises OSError and leaves no file behind (without the reservation the
    shortage would surface later as SIGBUS on a write)."""
    def no_space(fd, offset, length):
        raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC))

    monkeypatch.setattr(mutable_shm.os, "posix_fallocate", no_space)
    with pytest.raises(OSError) as ei:
        create_mutable_channel(1 << 20)
    assert ei.value.errno == errno.ENOSPC
    assert _files(shm_dir) == []


# the JAX package's justified exception for the same function
# (tools/graft_check/baseline.txt): a GC finalizer must never raise
_ALLOWED = {
    ("silent-swallow", "experimental/channel/mutable_shm.py",
     "MutableShmChannel.__del__"),
}
_CHECKS = ("shm-lifecycle", "resource-leak", "blocking-under-lock",
           "lock-order", "guarded-attr", "silent-swallow")
_MODULES = ("llm/kv_transfer.py", "llm/pd.py",
            "experimental/channel/mutable_shm.py",
            "experimental/channel/channel.py", "util/metrics.py",
            "_private/constants.py")


def test_graft_check_invariants_hold_on_the_ports_host_modules():
    """The invariant suite the JAX package's tier-1 gates on (shm
    lifecycle, leaks on exception paths, locks, swallowed errors) finds
    nothing in the port's transfer plane, PD and channel modules but the
    exceptions the JAX package's baseline justifies for the same code."""
    from tools.graft_check import all_check_ids, run_default

    assert set(_CHECKS) <= {cid for cid, _doc in all_check_ids()}
    report = run_default(root="ray_tpu_torch", use_baseline=False,
                         scope=set(_MODULES), cache_path="")
    assert not report.parse_errors
    found = {(f.check_id, f.path, f.symbol) for f in report.findings
             if f.check_id in _CHECKS and (
                 f.path in ("llm/kv_transfer.py", "llm/pd.py")
                 or f.path.startswith("experimental/channel/"))}
    assert found <= _ALLOWED, sorted(found - _ALLOWED)
