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


# the JAX package's justified exceptions for the same functions
# (tools/graft_check/baseline.txt, one entry each): a GC finalizer must
# never raise, daemon loops survive one bad message, teardown and
# telemetry are best effort
_ALLOWED = {
    ("silent-swallow", "experimental/channel/mutable_shm.py",
     "MutableShmChannel.__del__"),
    ("silent-swallow", "_private/api.py", "shutdown"),
    ("silent-swallow", "_private/direct.py", "DirectDispatcher._fail_lease"),
    ("silent-swallow", "_private/direct.py", "DirectDispatcher._grow"),
    ("silent-swallow", "_private/direct.py",
     "DirectDispatcher._maintenance_loop"),
    ("silent-swallow", "_private/direct.py",
     "DirectDispatcher._return_lease"),
    ("silent-swallow", "_private/direct.py", "DirectDispatcher.shutdown"),
    ("silent-swallow", "_private/direct.py", "DirectServer._serve"),
    ("silent-swallow", "_private/gcs.py", "GcsServer._delete_host_copy"),
    ("silent-swallow", "_private/gcs.py", "GcsServer._free_objects"),
    ("silent-swallow", "_private/gcs.py", "GcsServer._handle"),
    ("silent-swallow", "_private/gcs.py", "GcsServer._pub_send_loop"),
    ("silent-swallow", "_private/gcs.py", "GcsServer.crash_for_testing"),
    ("silent-swallow", "_private/log_monitor.py", "LogMonitor._loop"),
    # the follower's agent (baseline.txt's node_agent.py entries): one bad
    # delete/spill request must not kill the dispatch loop, and teardown
    # sweeps on past a store whose pins are already gone
    ("silent-swallow", "_private/node_agent.py", "NodeAgent._dispatch"),
    ("silent-swallow", "_private/node_agent.py", "NodeAgent.shutdown"),
    ("silent-swallow", "_private/object_transfer.py",
     "ObjectPlaneServer._serve"),
    ("silent-swallow", "_private/pubsub.py", "Subscriber.close"),
    ("silent-swallow", "_private/shm_arena.py", "_ArenaObject.__del__"),
    ("silent-swallow", "_private/worker.py", "CoreWorker._flush_telemetry"),
    ("silent-swallow", "_private/worker.py", "CoreWorker._recv_loop"),
    ("silent-swallow", "_private/worker.py",
     "CoreWorker._report_evictions"),
    ("silent-swallow", "_private/worker.py", "CoreWorker._try_reconnect"),
    ("silent-swallow", "_private/worker.py", "CoreWorker.disconnect"),
    ("silent-swallow", "_private/worker.py", "ObjectRef.__del__"),
    ("silent-swallow", "_private/worker.py", "ObjectRefGenerator.__del__"),
    # Serve and the LLM server (baseline.txt's serve/ and llm/server.py
    # entries): persist-before-side-effect writes under the controller's
    # mutation lock, advisory counters and emptiness polls read bare,
    # best-effort teardown, probes and telemetry, a GC finalizer
    ("blocking-under-lock", "serve/controller.py",
     "ServeController._do_autoscale"),
    ("blocking-under-lock", "serve/controller.py",
     "ServeController._do_reconcile"),
    ("blocking-under-lock", "serve/controller.py",
     "ServeController.delete_application"),
    ("blocking-under-lock", "serve/controller.py",
     "ServeController.deploy_application"),
    ("blocking-under-lock", "serve/controller.py",
     "ServeController.note_replica_addr"),
    ("guarded-attr", "serve/controller.py", "ServeController._persist_meta"),
    ("guarded-attr", "serve/handle.py", "_Router.pick"),
    ("guarded-attr", "serve/handle.py", "_Router.pick.pow2"),
    ("guarded-attr", "serve/replica.py", "ReplicaActor.ongoing"),
    ("guarded-attr", "serve/replica.py", "ReplicaActor.stats"),
    ("silent-swallow", "llm/server.py", "_AdapterHandle.__del__"),
    # the PD deployments (baseline.txt's llm/pd.py entries): GC finalizers
    # whose teardown must never raise into GC
    ("silent-swallow", "llm/pd.py", "DecodeServer.__del__"),
    ("silent-swallow", "llm/pd.py", "PrefillServer.__del__"),
    ("silent-swallow", "serve/api.py", "shutdown"),
    ("silent-swallow", "serve/controller.py", "ServeController._kill_replica"),
    ("silent-swallow", "serve/controller.py", "ServeController._probe_health"),
    ("silent-swallow", "serve/controller.py",
     "ServeController._reconcile_loop"),
    ("silent-swallow", "serve/controller.py", "ServeController.shutdown"),
    ("silent-swallow", "serve/controller.py", "_count"),
    ("silent-swallow", "serve/multiplex.py", "multiplexed.wrap.get_model"),
    # Data's executor and the batch processor (baseline.txt's
    # data/execution.py and llm/batch.py entries): telemetry and event
    # guards, best-effort frees of owned refs and pool teardown
    *(("silent-swallow", "data/execution.py", f) for f in (
        "StreamingExecutor._free_if_owned", "StreamingExecutor.execute",
        "StreamingExecutor.execute._handle_failure",
        "StreamingExecutor.execute._note_queues",
        "StreamingExecutor.execute._note_replacements",
        "StreamingExecutor.execute._q_room",
        "StreamingExecutor.release_owned", "_ActorPool._replace",
        "_ActorPool.note_done", "_ActorPool.shutdown", "_emit_data_event")),
    ("silent-swallow", "llm/batch.py", "Processor.shutdown"),
    # Train, Tune and the host collectives (baseline.txt's train/, tune/
    # and util/collective/ entries): best-effort retention deletes and
    # markers, the vetoed prefix's cleanup, transfer telemetry and the
    # opt-state gauge, teardown of dead workers, trials and rendezvous
    # actors, the tuner's snapshot and PBT's exploit side channel
    *(("silent-swallow", path, f) for path, f in (
        ("train/checkpoint_manager.py",
         "CheckpointManager._enforce_retention"),
        ("train/checkpoint_manager.py",
         "CheckpointManager._write_complete_marker"),
        ("train/controller.py", "TrainController._consume_complete_iters"),
        ("train/storage.py", "_observe_transfer"),
        ("train/worker_group.py", "WorkerGroup.shutdown"),
        ("train/zero.py", "ZeroShardedOptimizer._report_state_bytes"),
        ("tune/tuner.py", "Tuner.fit"),
        ("tune/tuner.py", "_TuneLoop._exploit"),
        ("tune/tuner.py", "_TuneLoop._terminate"),
        ("util/collective/collective.py", "destroy_collective_group"))),
    # compiled DAGs, the broker channel and device objects (baseline.txt's
    # dag/, experimental/channel/channel.py and device_objects.py
    # entries; its five bounded-retry ones are outside _CHECKS): recovery
    # and stats on the thread that owns the submission bookkeeping, a GC
    # finalizer, best-effort registry, teardown, telemetry and frees
    *(("guarded-attr", "dag/channel_execution.py", f) for f in (
        "ChannelExecutor.stats", "ChannelExecutor._replay_or_settle",
        "ChannelExecutor._degrade")),
    *(("silent-swallow", path, f) for path, f in (
        ("dag/channel_execution.py", "ChannelExecutor.__del__"),
        ("dag/channel_execution.py", "ChannelExecutor._degrade"),
        ("dag/channel_execution.py", "ChannelExecutor._note_recovery"),
        ("dag/dag_node.py", "CompiledDAG._degrade_to_submit"),
        ("dag/dag_node.py", "CompiledDAG._deregister"),
        ("dag/dag_node.py", "CompiledDAG._register"),
        ("experimental/channel/channel.py", "Channel.close"),
        ("experimental/device_objects.py", "export_to_store"),
        ("experimental/device_objects.py", "free_device_tensors"))),
    # runtime envs and the autoscaler (baseline.txt's runtime_env_agent,
    # node.py, node_agent.py and autoscaler/ entries): the agent's one-time
    # boot poll under its lock, the spawners' best-effort agent socket, the
    # reconciler's telemetry, post-stop cleanup and teardown guards
    ("blocking-under-lock", "_private/runtime_env_agent.py",
     "AgentHandle.ensure"),
    ("silent-swallow", "_private/node.py", "Node._spawn_workers"),
    ("silent-swallow", "_private/node_agent.py", "NodeAgent._spawn_workers"),
    *(("silent-swallow", "autoscaler/autoscaler.py", f) for f in (
        "Autoscaler._flush_metrics", "Autoscaler._launch",
        "Autoscaler.stop")),
    ("silent-swallow", "autoscaler/instance_manager.py",
     "_count_transition"),
    # the dashboard, the client proxy and the util shims (baseline.txt's
    # dashboard/head.py, util/client/, util/joblib, util/multiprocessing
    # and util/queue.py entries): a request handler and an accept loop
    # that survive one bad request, result collectors that hand the error
    # to their caller, and a best-effort teardown
    ("silent-swallow", "dashboard/head.py", "_Handler.do_GET"),
    ("silent-swallow", "util/client/proxier.py", "ClientProxy._handle"),
    ("silent-swallow", "util/joblib/__init__.py",
     "_make_backend.RayTpuBackend.apply_async.waiter"),
    ("silent-swallow", "util/multiprocessing/pool.py",
     "AsyncResult._collect"),
    ("silent-swallow", "util/multiprocessing/pool.py",
     "_ChunkedResult._collect"),
    ("silent-swallow", "util/queue.py", "Queue.shutdown"),
    # the env runners (baseline.txt's rllib/env_runner.py entries): a
    # failed runner's sample is dropped and the runner replaced, and the
    # group's teardown sweeps on past a runner already dead
    ("silent-swallow", "rllib/env_runner.py", "EnvRunnerGroup._collect"),
    ("silent-swallow", "rllib/env_runner.py", "EnvRunnerGroup.shutdown"),
    # IMPALA, SAC and DreamerV3 (baseline.txt's rllib/algorithms
    # entries): a runner being replaced or torn down may already be dead
    ("silent-swallow", "rllib/algorithms/impala.py", "IMPALA._restart"),
    ("silent-swallow", "rllib/algorithms/impala.py", "IMPALA.stop"),
    ("silent-swallow", "rllib/algorithms/sac.py", "SAC.stop"),
    ("silent-swallow", "rllib/algorithms/dreamerv3.py", "DreamerV3.stop"),
}
_CHECKS = ("shm-lifecycle", "resource-leak", "blocking-under-lock",
           "lock-order", "guarded-attr", "silent-swallow")
# the transfer plane, PD (below Serve and its deployments) and channel
# modules, the runtime core's host modules, Serve, the LLM server, Data,
# the batch processor, Train, Tune, the host collectives, compiled DAGs,
# device objects, RLlib's env runners, IMPALA and SAC
_RUNTIME = ("api", "accelerators", "actor_executor", "constants", "direct",
            "events", "fixed_point", "gcs", "gcs_storage", "ids",
            "local_mode", "log_monitor", "memory_monitor",
            "native_object_server", "node", "node_agent",
            "object_store", "object_transfer", "pg_policy", "poll",
            "procutil", "protocol", "pubsub", "ray_config",
            "runtime_env_container", "serialization", "shm_arena",
            "task_events", "task_spec", "worker", "worker_main",
            "runtime_env_pip", "runtime_env_conda", "runtime_env_agent",
            "worker_boot", "monitor")
_AUTOSCALER = ("__init__", "autoscaler", "instance_manager", "kuberay",
               "node_provider", "gce_gpu", "gce_rest")
_SERVE = ("__init__", "api", "batching", "config", "controller",
          "deployment", "gcs_state", "handle", "http_server", "multiplex",
          "proxy", "proxy_plane", "replica", "request_context",
          "request_router", "rpc_ingress", "schema")
_DATA = ("__init__", "aggregate", "archive", "avro", "block", "dataset",
         "datasource", "execution", "expressions", "lakehouse", "logical")
_TRAIN = ("__init__", "_checkpoint", "backend", "checkpoint_manager",
          "config", "controller", "session", "storage", "sync", "trainer",
          "worker_group", "zero")
_TUNE = ("__init__", "schedulers", "search", "trial", "tuner")
_MODULES = ("llm/kv_transfer.py", "llm/pd.py",
            "experimental/channel/mutable_shm.py",
            "experimental/channel/channel.py", "util/metrics.py",
            "util/tracing.py", "util/state.py", "util/placement_group.py",
            "util/actor_pool.py", "util/scheduling_strategies.py",
            "remote_function.py", "actor.py", "runtime_env.py",
            "cross_lang.py", "exceptions.py", "llm/server.py",
            "llm/tokenizer.py", "llm/checkpoint_io.py",
            "llm/batch.py") + tuple(
                f"data/{m}.py" for m in _DATA) + tuple(
                f"_private/{m}.py" for m in _RUNTIME) + tuple(
                f"serve/{m}.py" for m in _SERVE) + tuple(
                f"train/{m}.py" for m in _TRAIN) + tuple(
                f"tune/{m}.py" for m in _TUNE) + (
                "util/collective/__init__.py",
                "util/collective/collective.py",
                "util/collective/quantization.py", "cluster_utils.py",
                "dag/__init__.py", "dag/dag_node.py",
                "dag/channel_execution.py", "experimental/device_objects.py",
                "experimental/channel/__init__.py") + tuple(
                f"autoscaler/{m}.py" for m in _AUTOSCALER) + (
                "job_submission.py", "dashboard/__init__.py",
                "dashboard/head.py", "dashboard/grafana.py",
                "scripts/__init__.py", "scripts/_artifacts.py",
                "scripts/cli.py", "scripts/llm_bench.py",
                "scripts/serve_bench.py", "_private/ray_perf.py",
                "util/queue.py", "util/client/__init__.py",
                "util/client/proxier.py", "util/client/relay.py",
                "util/multiprocessing/__init__.py",
                "util/multiprocessing/pool.py", "util/joblib/__init__.py",
                "util/dask/__init__.py", "util/accelerators/__init__.py",
                "util/accelerators/gpu.py", "rllib/env_runner.py",
                "rllib/multi_agent_runner.py", "rllib/algorithms/impala.py",
                "rllib/algorithms/sac.py", "rllib/algorithms/dreamerv3.py")


def test_graft_check_invariants_hold_on_the_ports_host_modules():
    """The invariant suite the JAX package's tier-1 gates on (shm
    lifecycle, leaks on exception paths, locks, swallowed errors) finds
    nothing in the port's transfer plane, PD, channel and runtime modules
    but the exceptions the JAX package's baseline justifies for the same
    code."""
    from tools.graft_check import all_check_ids, run_default

    assert set(_CHECKS) <= {cid for cid, _doc in all_check_ids()}
    report = run_default(root="ray_tpu_torch", use_baseline=False,
                         scope=set(_MODULES), cache_path="")
    assert not report.parse_errors
    found = {(f.check_id, f.path, f.symbol) for f in report.findings
             if f.check_id in _CHECKS and f.path in _MODULES}
    assert found <= _ALLOWED, sorted(found - _ALLOWED)
