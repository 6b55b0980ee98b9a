"""Central runtime-flag registry.

Single definition file for every tunable, typed, env-var-overridable flag,
playing the role of the reference's ``RAY_CONFIG(type, name, default)``
registry (reference: src/ray/common/ray_config_def.h, ray_config.h:60 — 229
entries materialized as a process singleton, overridable via RAY_<name> env
vars forwarded at process spawn).

Usage::

    from ray_tpu_torch._private.ray_config import RayConfig
    if RayConfig.instance().auto_gc:
        ...

Each flag reads ``RAY_TPU_TORCH_<NAME>`` (upper-cased field name) at first access;
`spawn_env()` returns the subset of flags explicitly set in this process's
environment so parent processes can forward their overrides to children the
same way the reference's `services.py` forwards `RAY_*` vars.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, fields


def _parse(typ, raw: str):
    if typ is bool:
        return raw.strip().lower() not in ("0", "false", "no", "")
    return typ(raw)


@dataclass
class RayConfig:
    # --- object store ---------------------------------------------------
    # Per-host shm store capacity in bytes before LRU spill kicks in (0 = no
    # limit). Mirrors plasma's capacity + eviction threshold.
    object_store_capacity: int = 0
    # Arena-backend capacity (csrc/shm_store.cc) in bytes (capped at 80% of
    # what /dev/shm can back at arena-creation time).
    store_capacity: int = 1 << 30
    # Store backend: "arena" (native C++ single-segment arena with LRU
    # evict-to-spill — the default: O(1) tmpfs inodes, bounded memory) or
    # "file" (one tmpfs file per object — the debuggable fallback, also
    # what init() degrades to when no C++ toolchain can build the arena).
    store_backend: str = "arena"
    # Inline-object threshold: values ≤ this many bytes live in the GCS
    # table instead of shm (reference: memory_store small-object tier).
    inline_object_limit: int = 64 * 1024
    # Chunk size for cross-host object pulls.
    object_transfer_chunk: int = 5 * 1024 * 1024
    # Object-plane server: "python" (framed MsgConnection) or "native"
    # (C++ csrc/object_server.cc — zero Python on the transfer hot path;
    # file-backed store only).
    object_server_backend: str = "python"

    # --- core worker ----------------------------------------------------
    # Distributed reference counting on ObjectRef drop (0 = manual free()).
    auto_gc: bool = True
    # Max retained task specs for lineage reconstruction (LRU).
    max_lineage: int = 10000
    # Seconds between batched refcount-delta flushes to the GCS.
    ref_flush_interval_s: float = 0.2

    # Direct dispatch: callers lease idle workers from the GCS and push
    # plain tasks to them over a dedicated connection, keeping the central
    # scheduler off the per-task hot path (reference: leased-worker
    # submission, normal_task_submitter.h:81).
    direct_dispatch: bool = True

    # --- scheduling -----------------------------------------------------
    # Utilization threshold past which the hybrid policy spreads instead of
    # packing (reference: scheduling_policy.h:66 ~50%).
    hybrid_threshold: float = 0.5
    # Default max task retries on worker death.
    default_max_retries: int = 3

    # --- cluster / transport --------------------------------------------
    # Host interface the TCP planes bind (control + object transfer).
    bind_host: str = "127.0.0.1"
    # Workers without a GPU grant: "cpu" hides every card from them
    # (CUDA_VISIBLE_DEVICES=""); see node.py GPU isolation.
    worker_platform: str = "cpu"
    # Stream worker stdout/stderr to the driver.
    log_to_driver: bool = True
    # GCS → node-agent health-check period and miss budget: a follower host
    # whose agent misses this many pongs in a row is removed (reference:
    # gcs_health_check_manager.h:45, ray_config_def.h:877). The same tick
    # samples the retained histories and expires parked relay waiters.
    health_check_period_s: float = 1.0
    health_check_failure_threshold: int = 5
    # Follower agents broadcast a resource-view delta (memory usage, load,
    # live worker count) this often (reference: ray_syncer RESOURCE_VIEW
    # messages); 0 disables. Feeds the GCS host table and list_nodes'
    # host_view.
    resource_view_interval_s: float = 2.0

    # --- collectives / fault detection ----------------------------------
    # While blocked in a host-plane collective wait, poll the liveness of
    # peer ranks' actors (via the GCS actor_info RPC) this often, so a dead
    # rank surfaces as CollectiveError within ~this interval instead of as
    # a TimeoutError after the full op timeout. 0 disables the in-wait
    # polling (a timeout still triggers one final liveness sweep).
    collective_liveness_interval_s: float = 2.0
    # How long init_collective_group waits for the rendezvous actor to
    # appear AND for all ranks to register before failing with an error
    # naming the missing ranks (previously a hardcoded 60.0).
    collective_group_create_timeout_s: float = 60.0

    # --- node drain / preemption ----------------------------------------
    # Grace window between a node being marked DRAINING and its
    # termination: how long resident train workers get to land a
    # preemption-grace checkpoint. Used by the node agent's SIGTERM
    # self-drain (the GCE preemption notice path) and as the autoscaler's
    # default drain-then-terminate window.
    drain_grace_s: float = 20.0

    # --- worker pool ----------------------------------------------------
    # Warm-pool floor: keep this many idle no-runtime-env CPU workers per
    # node, replenished asynchronously as they are consumed by dispatch or
    # leases (reference: raylet worker_pool.h:280 prestarted/cached pool —
    # first-task latency becomes a dispatch, not a process fork + imports).
    # 0 disables (init(num_workers=N) still prespawns N once; the floor
    # additionally REPLENISHES as workers are consumed).
    warm_pool_size: int = 0

    # --- memory / OOM defense -------------------------------------------
    # Host memory-monitor poll period in ms; 0 disables (reference:
    # memory_monitor.h:52 polls at memory_monitor_refresh_ms). Off by
    # default here so test runs on loaded hosts stay deterministic; node
    # deployments enable it (ray_tpu_torch start / node_agent pass it through).
    memory_monitor_refresh_ms: int = 0
    # Usage fraction past which a victim worker is killed (reference:
    # memory_usage_threshold 0.95).
    memory_usage_threshold: float = 0.95
    # Whether the OOM killer may pick workers holding GPUs. Off by default,
    # as the JAX package's oom_kill_tpu_workers (there a SIGKILL mid-grant
    # can wedge a shared TPU device pool). When a GPU worker IS killed
    # (opt-in), its GPUs are quarantined rather than returned to the
    # allocatable pool.
    oom_kill_gpu_workers: bool = False

    # --- GCS persistence ------------------------------------------------
    # Path for the GCS write-ahead table store; empty = in-memory only
    # (reference: redis_store_client.h — Redis mode = fault tolerance).
    gcs_storage_path: str = ""
    # How long a DRIVER keeps retrying to reconnect + re-register after the
    # GCS connection drops (reference: retryable_grpc_client.h). Workers
    # never reconnect — they exit and the restarted GCS respawns actors.
    gcs_reconnect_timeout_s: float = 10.0

    # --- streaming generators -------------------------------------------
    # How long a streaming producer waits at the backpressure limit with NO
    # consumer ack before failing the stream (0 = wait forever while the
    # GCS connection is alive, matching the reference's blocking behavior).
    stream_stall_timeout_s: float = 300.0

    # --- metrics / tracing ----------------------------------------------
    # Enable task timeline events (reference: ray_config_def.h:615).
    enable_timeline: bool = True
    # Max buffered task events per process before oldest are dropped.
    task_events_max: int = 10000
    # Propagate trace context (trace/span ids) inside task/actor specs
    # across process boundaries and emit spans on the task-event channel
    # (reference: python/ray/util/tracing/tracing_helper.py:165
    # _DictPropagator injecting the OTel span context into every spec).
    enable_tracing: bool = False
    # Metrics report period from workers/agents to the GCS.
    metrics_report_interval_s: float = 2.0
    # Compiled-DAG channel-plane instrumentation: per-step phase histograms
    # (input-wait / compute / output-write / backpressure-drain). The
    # always-on cost is two monotonic reads + one pre-bound histogram
    # observe per phase; 0/false disables entirely (the bench baseline).
    dag_metrics: bool = True
    # Emit a full timeline span (task_events, flushed to the GCS by the
    # CoreWorker flusher) every Nth compiled-DAG step; 0 = off. Sampled at
    # compile time into the exec-loop plan so workers need no env override.
    dag_span_sample_every: int = 100
    # Serve/PD request-path instrumentation: always-on pre-bound phase
    # histograms for the serving hot path (proxy accept/parse/route/handle,
    # handle pick/RTT, replica queue-wait/execute, PD per-page transfer
    # wait, decode-slot admission wait, inter-token gap) plus the
    # flight-recorder ring of recent request summaries. 0/false disables
    # entirely (the serving bench A/B baseline).
    serve_metrics: bool = True
    # Emit a full cross-process span tree (task_events) for every Nth serve
    # request entering the HTTP proxy; 0 = off. Same knob pattern as
    # dag_span_sample_every: sampling keeps the hot path cheap while one
    # request in N yields a complete phase timeline
    # (`ray_tpu_torch trace show <request_id>`).
    serve_span_sample_every: int = 100
    # In-process flight recorder: how many recent request summaries each
    # serving process retains (and ships to the GCS request log) so a slow
    # request can be explained after the fact without sampling luck.
    serve_flight_recorder_size: int = 256
    # Structured cluster event log (_private/events.py): typed node/actor/
    # PG/lease lifecycle events recorded at their GCS/controller source and
    # readable via `ray_tpu_torch events` / state.list_events(). 0/false disables
    # both emission and the GCS ring (the events bench A/B baseline).
    cluster_events: bool = True
    # Capacity of the GCS cluster-event ring (and of each producer-side
    # buffer); oldest events fall off. Persisted INFO+ events in the sqlite
    # `events` table are bounded to the same count.
    cluster_events_ring_size: int = 4096
    # --- serve proxy plane ----------------------------------------------
    # Number of proxy shard processes serve.start() launches when the
    # sharded plane is requested without an explicit num_proxies. 0 keeps
    # the legacy single in-driver ProxyActor (the default: tests and small
    # deployments need no extra worker processes).
    serve_num_proxies: int = 0
    # Ceiling on buffered HTTP request bodies: a Content-Length above this
    # is refused with 413 before any body bytes are read, and a chunked/
    # unframed body is cut off at the cap. Headers are bounded separately
    # (http_server.MAX_HEADER_BYTES).
    serve_max_http_body_bytes: int = 64 * 1024 * 1024
    # Zero-copy payload threshold: HTTP bodies / replica results at or
    # above this many bytes move proxy<->replica through the arena object
    # plane (envelope carries the object id, never a pickled body through
    # fast-RPC or the GCS). Must exceed inline_object_limit or the "zero
    # copy" path would just move the bytes into the GCS table instead.
    serve_zero_copy_threshold_bytes: int = 256 * 1024
    # Serve telemetry batching: when > 0, proxy-shard phase observes are
    # buffered locally and flushed into the real histograms once per this
    # interval (one lock acquisition per flush instead of per request).
    # 0 = observe synchronously per request (the legacy single proxy).
    serve_telemetry_flush_s: float = 0.5
    # Capacity of the seqlock shm segment the controller publishes the
    # routing table into. A table that serializes past this falls back to
    # controller-RPC refresh (proxies log once and keep serving).
    serve_routing_shm_bytes: int = 1 << 20
    # HTTP proxy per-request budget: ceiling on the blocking handle call
    # behind each non-streaming HTTP request (previously a hardcoded 60 s).
    # A request carrying its own deadline (x-ray-tpu-deadline-s header)
    # clamps further to the remaining budget; expiry surfaces as 504.
    serve_request_timeout_s: float = 60.0
    # Compiled-DAG exec-loop recovery budget: total seconds the driver
    # waits per recovery for the core actor restart + the in-band rewire
    # barrier + the in-flight replay before degrading the DAG to the
    # submit-path fallback.
    dag_recovery_timeout_s: float = 60.0

    # --- data plane fault tolerance -------------------------------------
    # Master switch for Data-plane fault handling (per-block retry, pool
    # actor replacement, lineage-backed barrier recovery). Off = legacy
    # fail-fast behavior (the DATA_BENCH A/B baseline).
    data_fault_tolerance: bool = True
    # Max resubmissions per block after a SYSTEM error (actor death /
    # worker crash / lost object). Exhausting the budget raises
    # DataBlockError(kind="system") naming the block.
    data_max_block_retries: int = 3
    # Base for the full-jitter retry backoff: sleep ~uniform(0,
    # base * 2**attempt), capped at 8x base (injectable rng).
    data_retry_backoff_s: float = 0.25
    # How many dead `_MapPoolActor`s a pool may replace over its lifetime
    # (-1 = unlimited). Exhausting it with zero survivors fails the
    # pipeline rather than hanging it.
    data_actor_restart_budget: int = 4
    # Transient-IO retries per file inside datasource read tasks (OSError
    # except FileNotFoundError), and their backoff base. Failures carry
    # per-file attribution.
    data_read_retries: int = 2
    data_read_retry_backoff_s: float = 0.2
    # APPLICATION-error (UDF raise) policy: "raise" surfaces the first
    # errored block; "skip" drops it (counted + logged with block id)
    # until max_errored_blocks is exceeded (-1 = unlimited skips).
    # Retried SYSTEM errors never consume this budget.
    data_on_block_error: str = "raise"
    data_max_errored_blocks: int = -1

    _singleton = None
    _lock = threading.Lock()

    @classmethod
    def instance(cls) -> "RayConfig":
        if cls._singleton is None:
            with cls._lock:
                if cls._singleton is None:
                    cls._singleton = cls._from_env()
        return cls._singleton

    @classmethod
    def _from_env(cls) -> "RayConfig":
        cfg = cls()
        for f in fields(cls):
            if f.name.startswith("_"):
                continue
            raw = os.environ.get("RAY_TPU_TORCH_" + f.name.upper())
            if raw is not None:
                try:
                    setattr(cfg, f.name, _parse(f.type if isinstance(f.type, type)
                                                else type(f.default), raw))
                except (TypeError, ValueError):
                    pass  # malformed override: keep the default
        return cfg

    @classmethod
    def reset(cls) -> None:
        """Drop the singleton (tests set env vars then re-read)."""
        with cls._lock:
            cls._singleton = None

    @classmethod
    def get(cls, name: str):
        """Fresh typed read of one flag (env consulted every call — for
        construction-time reads where tests change env between sessions
        within one process; use instance() on hot paths)."""
        for f in fields(cls):
            if f.name == name:
                raw = os.environ.get("RAY_TPU_TORCH_" + name.upper())
                if raw is None:
                    return f.default
                try:
                    return _parse(f.type if isinstance(f.type, type)
                                  else type(f.default), raw)
                except (TypeError, ValueError):
                    return f.default
        raise AttributeError(f"unknown ray config flag {name!r}")

    @staticmethod
    def spawn_env() -> dict:
        """Flags explicitly set in this process's env, for child processes."""
        out = {}
        for f in fields(RayConfig):
            if f.name.startswith("_"):
                continue
            key = "RAY_TPU_TORCH_" + f.name.upper()
            if key in os.environ:
                out[key] = os.environ[key]
        return out
