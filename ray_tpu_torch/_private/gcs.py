"""GCS — the control plane: object directory, scheduler, actor manager, KV,
virtual nodes, placement groups.

The port's copy of ray_tpu/_private/gcs.py. The accelerator resource is
"GPU": a node's GPU ids form its ``chip_pool``, and a worker spawned for a
whole-GPU spec owns its ids through CUDA_VISIBLE_DEVICES for its lifetime.

One process-wide server thread accepting unix-socket connections from the
driver and worker processes. Collapses the reference's head-node GcsServer +
per-node raylet NodeManager into one component, keeping the same
responsibilities and state machines:

- object directory + waiters      (reference: src/ray/gcs/gcs_server.h pubsub,
                                   object_manager/ownership_object_directory.h)
- lease-style task scheduling     (reference: raylet/scheduling/cluster_lease_manager.h:41
                                   + local_lease_manager.h:60 — tasks are queued until
                                   deps are local and resources free, then dispatched)
- actor lifecycle + restarts      (reference: gcs/gcs_actor_manager.h:93)
- named actors, internal KV       (reference: gcs/gcs_kv_manager.h:34)
- worker pool scale-up            (reference: raylet/worker_pool.h:280)
- virtual nodes                   (reference: one raylet per node; here nodes are
                                   resource partitions of the host — the same
                                   mechanism the reference's cluster_utils.Cluster
                                   test harness relies on, python/ray/cluster_utils.py:135)
- placement groups                (reference: gcs/gcs_placement_group_manager.h:50)
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import queue as _queue
import threading
import time
from typing import Callable

from ray_tpu_torch._private import accelerators, constants as _const, fixed_point as fp, pg_policy
from ray_tpu_torch._private.protocol import ConnectionClosed, MsgConnection, listen_unix
from ray_tpu_torch._private.ray_config import RayConfig

logger = logging.getLogger(__name__)

INLINE_LIMIT = RayConfig.get("inline_object_limit")  # results below this live in the GCS table

DEFAULT_NODE = "node-0"
HEAD_HOST = "host-0"
# node-drain records persist in the kv table under this prefix; a restarted
# GCS (or a node re-registering) re-applies them — a drain survives both
_DRAIN_KV_PREFIX = "__node_drain::"
MAX_RECONSTRUCTIONS = 3
MAX_LINEAGE = RayConfig.get("max_lineage")
# GPU worker spawns get the longer budget (the JAX package's chip spawns
# can block minutes in TPU plugin init); plain spawns are fast
SPAWN_TIMEOUT_S = 60.0
CHIP_SPAWN_TIMEOUT_S = 300.0
# pip envs build a venv + install inside the worker boot (each phase gets
# up to PIP_TIMEOUT_S=600s): the presumed-failed budget must exceed that
PIP_SPAWN_TIMEOUT_S = 1500.0


class _Worker:
    __slots__ = ("wid", "conn", "pid", "idle", "actor_id", "dead", "kind",
                 "running_tasks", "node_id", "gpus", "host_id",
                 "ref_balance", "renv_hash", "direct_addr", "leased_to",
                 "lease_spec", "lease_token", "oom_why", "oom_ts",
                 "language", "functions")

    def __init__(self, wid: str, conn: MsgConnection, pid: int, kind: str, node_id: str,
                 gpus: tuple = (), host_id: str = "host-0",
                 renv_hash: str = "", direct_addr: str | None = None,
                 language: str = "py", functions: tuple = ()):
        self.host_id = host_id
        self.wid = wid
        self.conn = conn
        self.pid = pid
        self.kind = kind  # "worker" | "driver"
        self.node_id = node_id
        self.idle = kind == "worker"
        self.running_tasks: dict[str, dict] = {}  # task_id → spec (GCS-side)
        self.actor_id: str | None = None
        self.dead = False
        # GPUs bound to this process at spawn via CUDA_VISIBLE_DEVICES; fixed
        # for the process lifetime (the CUDA runtime reads the env once)
        self.gpus = tuple(gpus)
        # net process-level ref contributions, so a SIGKILLed process's
        # outstanding +1s can be reclaimed (reference: reference_counter
        # borrower death handling)
        self.ref_balance: dict[str, int] = {}
        # runtime-env fingerprint baked into the process at spawn
        # (reference: worker pool keyed by runtime-env hash)
        self.renv_hash = renv_hash
        # direct-dispatch plane (reference: leased-worker submission)
        self.direct_addr = direct_addr  # where leased callers connect
        self.leased_to: str | None = None  # caller wid holding the lease
        self.lease_spec: dict | None = None  # resources held by the lease
        self.lease_token: int | None = None  # guards stale release messages
        self.oom_why: str | None = None  # set by the memory monitor pre-kill
        self.oom_ts: float = 0.0  # when; stale tags are ignored on death
        # cross-language workers (reference: C++/Java API workers) execute
        # REGISTERED named functions; only specs of their language dispatch
        # to them
        self.language = language
        self.functions = tuple(functions)


class _Actor:
    __slots__ = (
        "aid", "state", "worker", "queue", "in_flight", "max_concurrency",
        "create_spec", "name",
        "restarts_left", "waiters", "kill_requested", "num_restarts",
        "max_task_retries",
        "groups", "method_groups", "group_in_flight", "group_queued",
        "death_cause",
    )

    def __init__(self, aid: str, create_spec: dict):
        self.aid = aid
        self.state = "pending"  # pending → alive → (restarting → alive)* → dead
        self.worker: str | None = None
        self.queue: collections.deque[dict] = collections.deque()
        self.in_flight = 0  # dispatched, not yet done (≤ max_concurrency)
        self.max_concurrency = int(create_spec.get("max_concurrency") or 1)
        # concurrency groups dispatch through their own lane (reference:
        # concurrency_group_manager.h — per-group limits): group methods are
        # never stuck behind a saturated default FIFO (e.g. serve health
        # probes vs a full data queue). max_concurrency above is the TOTAL
        # (default pool + group limits, summed at create_actor).
        self.groups: dict[str, int] = {
            str(k): max(1, int(v))
            for k, v in (create_spec.get("concurrency_groups") or {}).items()}
        self.method_groups: dict[str, str] = {
            str(k): str(v) for k, v in
            (create_spec.get("concurrency_group_methods") or {}).items()
            if str(v) in self.groups}
        self.group_in_flight: dict[str, int] = {}
        self.group_queued = 0  # queued specs bound for ANY group lane
        self.create_spec = create_spec
        self.name: str | None = create_spec.get("name")
        self.restarts_left: int = create_spec.get("max_restarts", 0)
        # in-flight method calls lost to a worker death are retried on the
        # restarted actor up to this many times each (-1 = unlimited);
        # 0 = fail with ActorDiedError (reference: actor max_task_retries)
        self.max_task_retries: int = int(
            create_spec.get("max_task_retries") or 0)
        self.num_restarts = 0
        self.waiters: list[tuple[MsgConnection, int]] = []  # ready-waiters
        self.kill_requested = False
        # why creation failed, handed to every call on the dead actor
        # (reference: RayActorError whose cause is the creation task's error)
        self.death_cause: str | None = None


class _VNode:
    """A virtual node: a resource partition with labels.

    (reference: one raylet per machine registered in gcs_node_manager.h:47;
    the in-process multi-node harness is how the reference tests multi-node,
    SURVEY.md §4.2.)"""

    __slots__ = ("node_id", "total", "available", "labels", "alive",
                 "chip_pool", "quarantined_chips", "draining", "drain_reason",
                 "drain_since", "drain_grace")

    def __init__(self, node_id: str, resources: dict, labels: dict | None = None):
        self.node_id = node_id
        # fixed-point integer units internally (fixed_point.py): exact
        # acquire/release round-trips, no epsilon compares
        self.total = fp.fp_dict(resources)
        self.available = dict(self.total)
        self.labels = dict(labels or {})
        self.alive = True
        # DRAINING: alive (running work continues + releases normally) but
        # excluded from every placement decision; one-way until node death
        # (reference: the reference GCS's DrainNode state, SURVEY §3.4)
        self.draining = False
        self.drain_reason = ""
        self.drain_since: float | None = None
        self.drain_grace: float | None = None
        # unbound GPU ids; they leave the pool when a worker is spawned with
        # them visible and return when that worker dies (reference:
        # CUDA_VISIBLE_DEVICES isolation, _private/accelerators/nvidia_gpu.py)
        self.chip_pool: list[int] = list(
            range(int(fp.from_fp(self.total.get("GPU", 0)))))
        # chips held by a worker that was SIGKILLed mid-grant (OOM defense):
        # the shared device pool may be wedged, so they are withheld from
        # re-allocation until an operator re-enables them
        self.quarantined_chips: list[int] = []


class _PendingShards:
    """Pending plain-task queue sharded by (resource shape, renv_hash).

    Deep queues are the reference's scalability envelope (1M queued tasks on
    a node, release/benchmarks/README.md:29): per-event scheduler work must
    not scan the whole queue. Specs in one shard are uniform in everything
    placement-relevant except deps, so ONE feasibility probe (is there an
    idle worker of this shape / could one be spawned?) covers the entire
    shard — feasibility becomes a dict walk over shards instead of a spec
    scan. Specs with a scheduling strategy (PG / node affinity / labels)
    differ per-spec and live in the `misc` shard, scanned the old way.
    """

    __slots__ = ("shards", "misc", "ids")

    def __init__(self, specs=()):
        self.shards: dict[tuple, collections.deque] = {}
        self.misc: collections.deque = collections.deque()
        # task_id multiset for O(1) "is this tid queued?" probes (lineage
        # eviction asks per submit; a set build would be O(queue))
        self.ids: collections.Counter = collections.Counter()
        for s in specs:
            self.append(s)

    @staticmethod
    def key_of(spec: dict):
        if spec.get("strategy"):
            return None
        res = spec.get("resources") or {}
        return (tuple(sorted((k, float(v)) for k, v in res.items())),
                spec.get("renv_hash", ""), spec.get("lang", "py"))

    def _dq(self, spec: dict) -> collections.deque:
        k = self.key_of(spec)
        if k is None:
            return self.misc
        dq = self.shards.get(k)
        if dq is None:
            dq = self.shards[k] = collections.deque()
        return dq

    def append(self, spec: dict) -> None:
        self._dq(spec).append(spec)
        self.ids[spec["task_id"]] += 1

    def appendleft(self, spec: dict) -> None:
        self._dq(spec).appendleft(spec)
        self.ids[spec["task_id"]] += 1

    def note_consumed(self, tid: str) -> None:
        """A spec left the queue by direct deque manipulation (dispatch)."""
        n = self.ids.get(tid, 0) - 1
        if n <= 0:
            self.ids.pop(tid, None)
        else:
            self.ids[tid] = n

    def is_queued(self, tid: str) -> bool:
        return self.ids.get(tid, 0) > 0

    def __len__(self) -> int:
        return len(self.misc) + sum(len(d) for d in self.shards.values())

    def __bool__(self) -> bool:
        return bool(self.misc) or any(self.shards.values())

    def __iter__(self):
        yield from self.misc
        for dq in self.shards.values():
            yield from dq

    def remove_task_id(self, tid: str) -> list[dict]:
        """Remove (and return) every spec with this task id. O(total) —
        cancellation only."""
        removed: list[dict] = []

        def _filter(dq: collections.deque) -> collections.deque:
            kept: collections.deque = collections.deque()
            for s in dq:
                (removed if s["task_id"] == tid else kept).append(s)
            return kept

        self.misc = _filter(self.misc)
        for k in list(self.shards):
            self.shards[k] = _filter(self.shards[k])
            if not self.shards[k]:
                del self.shards[k]
        for _ in removed:
            self.note_consumed(tid)
        return removed


class _Bundle:
    __slots__ = ("total", "available", "node_id")

    def __init__(self, resources: dict):
        self.total = fp.fp_dict(resources)  # fixed-point units, like _VNode
        self.available = dict(self.total)
        self.node_id: str | None = None


class _PG:
    """Placement group state machine: pending → created → removed.

    (reference: gcs/gcs_placement_group_manager.h:50)"""

    __slots__ = ("pg_id", "bundles", "strategy", "name", "state", "waiters", "epoch")

    def __init__(self, pg_id: str, bundles: list[dict], strategy: str, name: str):
        self.pg_id = pg_id
        self.bundles = [_Bundle(b) for b in bundles]
        self.strategy = strategy
        self.name = name
        self.state = "pending"
        self.epoch = 0  # bumped on every (re)placement; stale releases detect it
        self.waiters: list[tuple[MsgConnection, int]] = []


def pg_ready_oid(pg_id: str) -> str:
    return f"{pg_id}r0000"


class GcsServer:
    def __init__(
        self,
        socket_path: str,
        total_resources: dict[str, float],
        spawn_worker_cb: Callable[[int, str, list], None],
        max_workers: int = 32,
        node_labels: dict | None = None,
        session_id: str = "",
        storage_path: str | None = None,
    ):
        self.socket_path = socket_path
        self.session_id = session_id
        self.lock = threading.RLock()
        self.spawn_worker_cb = spawn_worker_cb
        self.max_workers = max_workers
        # read once: _schedule is a hot path and the floor can't change
        # after server start
        self.warm_pool_size = int(RayConfig.get("warm_pool_size"))

        self.nodes: dict[str, _VNode] = {
            DEFAULT_NODE: _VNode(DEFAULT_NODE, total_resources, node_labels)
        }
        self.local_node_id = DEFAULT_NODE
        # cross-host state (reference: gcs_node_manager.h:47 node registry +
        # ownership_object_directory.h locations). "host-0" is the head.
        self.hosts: dict[str, dict] = {HEAD_HOST: {"object_addr": None, "conn": None}}
        self.node_hosts: dict[str, str] = {}  # node_id → host_id (default head)

        self.objects: dict[str, dict] = {}
        self.object_waiters: dict[str, list[tuple[MsgConnection, int]]] = {}
        # wid → oids it promised to publish (will_publish); consulted on its
        # death so the scan is O(its promises), entries dropped with the wid
        self._pub_promises: dict[str, set] = {}
        self._fn_access: dict[str, float] = {}  # fn: key → last touch ts
        self._pinned_fn_cache: tuple[float, set] | None = None
        self.workers: dict[str, _Worker] = {}
        self.pending_tasks = _PendingShards()
        self.pending_actor_creations: collections.deque[dict] = collections.deque()
        self.actors: dict[str, _Actor] = {}
        # (namespace, name) → actor id: named actors are scoped per
        # namespace (reference: ray namespaces — jobs in different
        # namespaces can reuse names without colliding)
        self.named_actors: dict[tuple, str] = {}
        self.pgs: dict[str, _PG] = {}
        self.named_pgs: dict[str, str] = {}
        self.pending_pgs: collections.deque[str] = collections.deque()
        self.kv: dict[str, bytes] = {}
        # retained specs of stateless tasks, for lineage reconstruction of
        # their outputs (reference: TaskManager lineage pinning)
        self.lineage: dict[str, dict] = {}
        # live streaming-generator tasks: task_id → stream state
        # (reference: streaming generators, _raylet.pyx:299)
        self.streams: dict[str, dict] = {}
        # per-host live tmpfs bytes; over RAY_TPU_TORCH_OBJECT_STORE_CAPACITY the
        # LRU objects are spilled to disk (reference: local_object_manager.h:43)
        self.host_shm_bytes: collections.Counter = collections.Counter()
        self.spill_capacity = RayConfig.get("object_store_capacity")
        self._spawn_pending: dict[str, collections.deque] = collections.defaultdict(collections.deque)
        # normalized runtime envs by hash, for spawning matching workers
        self.runtime_envs: dict[str, dict] = {}
        self.stopped = False
        self._conn_threads: list[threading.Thread] = []
        self._listener = None
        self._accept_thread: threading.Thread | None = None
        # fault tolerance: optional write-through table persistence so a
        # restarted GCS rebuilds its managers from storage (reference: Redis
        # store client + gcs_init_data rebuild, redis_store_client.h:126)
        self.storage = None
        sp = storage_path if storage_path is not None else RayConfig.get("gcs_storage_path")
        if sp:
            from ray_tpu_torch._private.gcs_storage import GcsStorage

            self.storage = GcsStorage(sp)
        # metrics / introspection
        self.task_counter = collections.Counter()
        self.task_events: collections.deque = collections.deque(maxlen=10000)
        # cluster-wide user/system metrics, keyed by metric name; per-source
        # series so restarts/re-reports replace instead of double-count
        # (reference: metrics agent aggregation, _private/metrics_agent.py:628)
        self.metrics: dict[str, dict] = {}
        # compiled-DAG registry: dag_id → metadata registered at
        # experimental_compile (nodes, actors, channel topology,
        # fallback_reason), dropped at teardown or driver death. Session-
        # scoped like task_events — a DAG cannot outlive its driver, so the
        # table is in-memory only.
        self.compiled_dags: dict[str, dict] = {}
        # serve flight-recorder log: last-N request summaries shipped by
        # worker flushers (request_log_report), read by `ray_tpu_torch trace list`
        # and the dashboard's /api/requests
        self.request_log: collections.deque = collections.deque(maxlen=1024)
        # structured cluster event log (_private/events.py): node/actor/PG/
        # lease lifecycle transitions, emitted here at their source and
        # ingested from controller processes via cluster_events_report.
        # INFO+ events write through to the sqlite `events` table so the
        # log survives a GCS restart; the ring answers list_events.
        self._events_enabled = bool(RayConfig.get("cluster_events"))
        self._events_ring_size = max(
            1, int(RayConfig.get("cluster_events_ring_size")))
        self.cluster_events: collections.deque = collections.deque(
            maxlen=self._events_ring_size)
        self._cluster_event_seq = 0
        self._events_lock = threading.Lock()
        # scheduler decision traces: actor_id/pg_id → attribution record
        # (enqueue time, attempts, queue wait, chosen node, lease RTT) kept
        # while the entity exists so sched_explain can answer "why is X
        # pending" / "where and how fast did X place"
        self.sched_traces: dict[str, dict] = {}
        # server-side RPC latency per request type — the measurement floor
        # for control-plane scale work. UNREGISTERED histogram: the GCS
        # often shares a process with the driver, whose flusher would
        # otherwise ship the same series a second time; instead the series
        # folds into metrics_snapshot under the reserved "gcs" source.
        from ray_tpu_torch.util.metrics import Histogram

        self._rpc_hist = Histogram(
            "ray_tpu_gcs_rpc_seconds",
            "server-side GCS RPC handler latency per request type "
            "(includes any handler-side blocking)",
            boundaries=[0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05,
                        0.1, 0.5, 1.0, 5.0],
            tag_keys=("rpc",), register=False)
        self._rpc_bound: dict[str, object] = {}
        self._rpc_other = self._rpc_hist.bind({"rpc": "other"})
        self._rpc_bound_lock = threading.Lock()
        # nodes currently DRAINING — same unregistered pattern as _rpc_hist
        # (the value is computed from self.nodes at snapshot time; the Gauge
        # object exists so the metric is declared head-side, not shipped
        # twice by a co-resident driver flusher)
        from ray_tpu_torch.util.metrics import Gauge

        self._draining_gauge = Gauge(
            "ray_tpu_nodes_draining",
            "nodes in DRAINING state: no new placements; resident train "
            "workers grace-checkpoint before the node is terminated",
            register=False)
        # scheduler decision metrics — same unregistered fold-in pattern.
        # The histogram observes queue-wait at dispatch/placement time and
        # creation round-trips at completion; the counter is the
        # decisions/s floor the 1000-node scale harness measures against.
        from ray_tpu_torch.util.metrics import Counter

        self._sched_hist = Histogram(
            "ray_tpu_sched_decision_seconds",
            "scheduler decision latency: queue-wait until dispatch/placement "
            "(outcome=dispatched/placed) and actor-creation lease RTT "
            "(outcome=created)",
            boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                        5.0, 30.0, 120.0],
            tag_keys=("kind", "outcome"), register=False)
        self._sched_counter = Counter(
            "ray_tpu_sched_decisions_total",
            "terminal scheduler decisions by work kind and outcome",
            tag_keys=("kind", "outcome"), register=False)
        self._sched_pending_gauge = Gauge(
            "ray_tpu_sched_pending",
            "work items waiting on a placement decision, by kind",
            tag_keys=("kind",), register=False)
        # retained metric TIME SERIES, head-side (reference: the dashboard's
        # metrics stack — per-node agents scraped into Prometheus,
        # dashboard/modules/metrics/metrics_head.py; here the GCS keeps a
        # bounded in-memory window so the UI graphs history with no
        # external TSDB): per-node samples appended on each resource_view
        # delta, cluster samples on each health-loop tick
        self.node_history: dict[str, collections.deque] = {}
        self.cluster_history: collections.deque = collections.deque(
            maxlen=720)
        # general long-poll pubsub: channel → list of (conn, rid) pollers and
        # buffered per-subscriber queues (reference: src/ray/pubsub/publisher.h:159)
        self.pubsub_queues: dict[tuple[str, str], collections.deque] = {}
        self.pubsub_pollers: dict[tuple[str, str], tuple[MsgConnection, int]] = {}
        self.pubsub_conns: dict[tuple[str, str], MsgConnection] = {}
        # in-flight RDT exports: token → (requester conn, rid)
        self._tensor_exports: dict[str, tuple] = {}
        # direct-dispatch leases (reference: cluster_lease_manager.h:41):
        # grant tokens guard against stale release messages; the holder index
        # lets caller death release everything it held
        self._lease_seq = 0
        self._leases_by_holder: dict[str, set[str]] = {}
        # attached autoscalers can GROW the cluster: infeasible-now
        # placement groups then stay pending instead of failing fast
        # (reference: infeasibility is judged against the autoscaler's max
        # cluster shape, which only the autoscaler knows). Tracked per
        # connection so autoscaler death restores fail-fast.
        self._autoscaler_conns: set = set()
        # autoscaler instance state machine (reference: v2 instance_manager's
        # InstanceStorage lives in the GCS so a restarted reconciler rebuilds
        # from the table): instance_id → record dict, write-through to the
        # sqlite `instances` table when persistence is on
        self.autoscaler_instances: dict[str, dict] = {}
        # serve control-plane state (reference: the Serve controller
        # checkpoints ApplicationState/DeploymentState into the GCS,
        # serve/_private/controller.py:102): key → record dict, write-through
        # to the sqlite `serve` table. A crash-restarted ServeController
        # rebuilds deployments/replicas/routes from here and re-adopts live
        # replica actors instead of restarting them.
        self.serve_table: dict[str, dict] = {}
        # caller-reported local submission backlogs, piggybacked on lease
        # requests (reference: backlog_size in lease requests feeds the
        # autoscaler's demand view)
        self._direct_backlog: dict[tuple, tuple] = {}  # (caller,key)→(res,n,ts)
        # publish() is called from paths holding self.lock — a slow
        # subscriber socket must not stall the control plane, so replies to
        # parked pollers go through this queue to a dedicated sender thread
        self._pub_sendq: "_queue.SimpleQueue" = _queue.SimpleQueue()
        self._pub_thread: threading.Thread | None = None

    # aggregate views (cluster_state compatibility; floats at the surface)
    @property
    def total(self) -> dict:
        out: dict[str, int] = {}
        for n in self.nodes.values():
            if n.alive:
                for k, v in n.total.items():
                    out[k] = out.get(k, 0) + v
        return fp.float_dict(out)

    @property
    def available(self) -> dict:
        # draining nodes are excluded: their capacity is unschedulable, so
        # counting it would make elastic restarts size attempts against
        # nodes that are about to terminate (and would hide the unmet
        # demand the autoscaler should replace)
        out: dict[str, int] = {}
        for n in self.nodes.values():
            if n.alive and not n.draining:
                for k, v in n.available.items():
                    out[k] = out.get(k, 0) + v
        return fp.float_dict(out)

    # ------------------------------------------------------------------ server

    def _restore_from_storage(self):
        """Rebuild manager state from persisted tables (reference:
        gcs_init_data.h — GCS restart rebuild in Redis mode)."""
        if self.storage is None:
            return
        with self.lock:
            for k, v in self.storage.items("kv"):
                self.kv[k] = v
            for k, v in self.storage.items("instances"):
                self.autoscaler_instances[k] = v
            for k, v in self.storage.items("serve"):
                self.serve_table[k] = v
        self._restore_events_from_storage()
        for _, spec in self.storage.items("pgs"):
            self._create_pg(dict(spec), _persist=False)
        for _, spec in self.storage.items("actors"):
            # actors restart from their creation spec on the rebuilt cluster
            # (fresh state, same identity/name — reference restarts actors
            # whose processes died with the old GCS's nodes)
            self._create_actor(dict(spec), _persist=False)

    def _health_loop(self):
        """Actively ping follower-host agents; hosts missing too many pongs
        are declared dead (reference: gcs_health_check_manager.h:45, config
        thresholds in ray_config_def.h:877). Same-host worker death is
        already observed through connection close."""
        period = RayConfig.get("health_check_period_s")
        thresh = RayConfig.get("health_check_failure_threshold")
        while not self.stopped:
            time.sleep(period)
            now = time.monotonic()
            self._sample_histories()
            # expire parked relay waiters (stack dumps / tensor exports) so
            # a worker wedged in native code can't hang the requester forever
            with self.lock:
                expired = [(tok, w) for tok, w in self._tensor_exports.items()
                           if now - w[3] > (w[4] if len(w) > 4 else 30.0)]
                for tok, _ in expired:
                    self._tensor_exports.pop(tok, None)
            for _, (wconn, wrid, *_rest) in expired:
                try:
                    wconn.send({"rid": wrid, "ok": False,
                                "error": "target did not answer within 30s "
                                         "(wedged in native code?)"})
                except ConnectionClosed:
                    pass
            dead_hosts = []
            with self.lock:
                targets = [(hid, info) for hid, info in self.hosts.items()
                           if hid != HEAD_HOST and info.get("conn") is not None]
                for hid, info in targets:
                    last = info.get("last_pong")
                    if last is None:
                        info["last_pong"] = now  # first check cycle
                    elif now - last > period * thresh:
                        dead_hosts.append(hid)
            for hid in dead_hosts:
                logger.warning("host %s failed health checks; removing", hid)
                self._remove_host(hid)
            for hid, info in targets:
                if hid in dead_hosts:
                    continue
                try:
                    info["conn"].send({"type": "ping"})
                except (ConnectionClosed, Exception):
                    self._remove_host(hid)

    def _sample_histories(self):
        """One retained-history tick: cluster-level gauges plus the head
        host's own resource view (followers report theirs via ray_syncer
        deltas; without this the head node would have no series at all)."""
        from ray_tpu_torch._private.memory_monitor import host_memory_usage

        try:
            load1 = os.getloadavg()[0]
        except OSError:
            load1 = 0.0
        try:
            mem = host_memory_usage()
        except Exception:
            mem = 0.0
        ts = time.time()
        with self.lock:
            live_workers = 0
            head_workers = 0
            for w in self.workers.values():
                if w.kind == "worker" and not w.dead:
                    live_workers += 1
                    if w.host_id == HEAD_HOST:
                        head_workers += 1
            self.cluster_history.append({
                "ts": ts,
                "pending_tasks": len(self.pending_tasks),
                "live_actors": sum(1 for a in self.actors.values()
                                   if a.state == "alive"),
                "live_workers": live_workers,
                "placement_groups": len(self.pgs),
                "objects": len(self.objects),
            })
            hist = self.node_history.setdefault(
                HEAD_HOST, collections.deque(maxlen=720))
            # the head's PER-NODE series counts head-local workers only —
            # followers report their own via resource_view deltas
            hist.append({"ts": ts, "mem_usage": round(mem, 4),
                         "load1": round(load1, 2),
                         "num_worker_procs": head_workers})

    def start(self):
        self._restore_from_storage()
        for node_id in list(self.nodes):
            self._emit_event(_const.EVENT_NODE_JOIN, node=node_id,
                             message="head-local virtual node online")
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="gcs-health")
        self._health_thread.start()
        self._pub_thread = threading.Thread(
            target=self._pub_send_loop, daemon=True, name="gcs-pubsub")
        self._pub_thread.start()
        self._listener = listen_unix(self.socket_path)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, args=(self._listener,), daemon=True,
            name="gcs-accept")
        self._accept_thread.start()
        # always also listen on TCP so follower hosts / remote drivers can
        # join (reference capability: gRPC control plane, rpc/grpc_server.h).
        # Loopback by default — the protocol executes pickled code, so only
        # bind externally (RAY_TPU_TORCH_BIND_HOST=0.0.0.0) on trusted networks.
        import os as _os

        from ray_tpu_torch._private.protocol import listen_tcp

        self._tcp_listener = listen_tcp(RayConfig.get("bind_host"), 0)
        self.tcp_port = self._tcp_listener.getsockname()[1]
        self._tcp_accept_thread = threading.Thread(
            target=self._accept_loop, args=(self._tcp_listener,), daemon=True,
            name="gcs-accept-tcp")
        self._tcp_accept_thread.start()
        # OOM defense for the head host (reference: memory_monitor.h:52 +
        # worker_killing_policy_group_by_owner.h:87); node agents run their
        # own for follower hosts
        self._mem_monitor = None
        refresh_ms = RayConfig.get("memory_monitor_refresh_ms")
        if refresh_ms > 0:
            from ray_tpu_torch._private.memory_monitor import MemoryMonitor

            self._mem_monitor = MemoryMonitor(
                threshold=RayConfig.get("memory_usage_threshold"),
                period_s=refresh_ms / 1000.0,
                pick_victim=self._pick_oom_victim,
                on_kill=self._note_oom_kill).start()

    @staticmethod
    def _oom_fresh(w) -> bool:
        """A pre-kill OOM tag explains a death only while fresh — a pick
        whose reply was lost (agent never killed) must not blame a much
        later unrelated death on memory pressure."""
        return (w is not None and w.oom_why is not None
                and time.monotonic() - w.oom_ts < 30.0)

    def _pick_oom_victim(self, host_id: str = HEAD_HOST):
        """Newest retriable running plain task's worker on `host_id`, then
        any running plain task's worker, then the newest-leased direct
        worker — never actors or infrastructure (reference:
        worker_killing_policy_group_by_owner.h:87). Node agents delegate
        their victim choice here too (pick_oom_victim RPC): only the GCS
        knows which pids run retriable tasks vs actors."""
        # killing a worker mid-grant can wedge a shared device pool (the JAX
        # package's TPU backend init hangs for every later process), so GPU
        # workers are excluded unless explicitly opted in — and even then
        # ranked strictly after every chip-free candidate
        allow_gpu = RayConfig.get("oom_kill_gpu_workers")
        with self.lock:
            best = None  # ((chip_free, retriable, newest_ts), worker)
            for w in self.workers.values():
                if (w.kind != "worker" or w.dead or w.host_id != host_id
                        or w.actor_id is not None or not w.pid):
                    continue
                if w.gpus and not allow_gpu:
                    continue
                plain = [s for s in w.running_tasks.values()
                         if s.get("kind") == "task"]
                if not plain:
                    continue
                ts = max(s.get("_ts", 0.0) for s in plain)
                retriable = any(s.get("retries_used", 0) < s.get("max_retries", 0)
                                for s in plain)
                key = (0 if w.gpus else 1, 1 if retriable else 0, ts)
                if best is None or key > best[0]:
                    best = (key, w)
            if best is not None:
                w = best[1]
                names = [s.get("name") or s.get("task_id", "")[:8]
                         for s in w.running_tasks.values()]
                return w.pid, f"worker {w.wid[:8]} running {names}"
            leased = [w for w in self.workers.values()
                      if w.kind == "worker" and not w.dead and w.pid
                      and w.host_id == host_id and w.leased_to is not None
                      and (allow_gpu or not w.gpus)]
            if leased:
                w = max(leased,
                        key=lambda x: (0 if x.gpus else 1,
                                       x.lease_token or 0))
                return w.pid, f"leased worker {w.wid[:8]}"
        return None

    def _note_oom_kill(self, pid: int, why: str | None,
                       host_id: str = HEAD_HOST) -> None:
        with self.lock:
            for w in self.workers.values():
                # pids are per-host namespaces: match host too, or a
                # follower worker sharing the pid gets mis-tagged
                if w.pid == pid and w.host_id == host_id and not w.dead:
                    w.oom_why = why
                    w.oom_ts = time.monotonic()
                    break
        if why is not None:
            self.publish("errors", {"kind": "oom_kill", "error": why,
                                    "ts": time.time()})

    def crash_for_testing(self):
        """Abruptly drop every connection and listener WITHOUT the graceful
        worker-exit handshake — simulates a GCS process crash for fault-
        tolerance tests (reference: GCS restart tests with external Redis,
        test_gcs_fault_tolerance.py)."""
        import socket as _socket

        self._pub_sendq.put(None)  # stop the pubsub sender thread
        with self.lock:
            self.stopped = True
            conns = [w.conn for w in self.workers.values() if not w.dead]
            conns += [h["conn"] for h in self.hosts.values() if h.get("conn")]
        if self.storage is not None:
            self.storage.close()
        for listener in (self._listener, getattr(self, "_tcp_listener", None)):
            if listener is not None:
                try:
                    listener.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
        for c in conns:
            try:
                c.close()
            except Exception:
                pass
        try:
            s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            s.settimeout(0.2)
            s.connect(self.socket_path)
            s.close()
        except OSError:
            pass
        if getattr(self, "tcp_port", None):
            try:  # wake the TCP accept thread so it closes its listener too
                s = _socket.create_connection(("127.0.0.1", self.tcp_port),
                                              timeout=0.2)
                s.close()
            except OSError:
                pass

    def stop(self):
        if getattr(self, "_mem_monitor", None) is not None:
            self._mem_monitor.stop()
        if self.storage is not None:
            self.storage.close()
        self._pub_sendq.put(None)
        with self.lock:
            self.stopped = True
            for w in self.workers.values():
                if w.kind == "worker" and not w.dead:
                    try:
                        w.conn.send({"type": "exit"})
                    except ConnectionClosed:
                        pass
        # Wake the accept threads WITHOUT closing the fds: close() here would
        # free the fd numbers while the accept threads may be entering
        # accept(2), and a new session's listener can reuse those numbers —
        # the stale thread then steals the new listener's connections and
        # serves them with this stopped GCS (observed: drivers registering
        # into a dead session and hanging). shutdown() unblocks accept but
        # keeps the fd allocated; the owning accept thread closes it.
        import socket as _socket  # local: protocol owns all other socket use

        for listener in (self._listener, getattr(self, "_tcp_listener", None)):
            if listener is not None:
                try:
                    listener.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
        # belt-and-braces: a no-op connect unblocks accept() even where
        # shutdown() on a listening socket doesn't
        try:
            s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            s.settimeout(0.2)
            s.connect(self.socket_path)
            s.close()
        except OSError:
            pass
        if getattr(self, "tcp_port", None):
            try:
                s = _socket.create_connection(("127.0.0.1", self.tcp_port), timeout=0.2)
                s.close()
            except OSError:
                pass

    def _accept_loop(self, listener):
        while not self.stopped:
            try:
                sock, _ = listener.accept()
            except OSError:
                break
            if self.stopped:
                try:
                    sock.close()
                except OSError:
                    pass
                break
            conn = MsgConnection(sock)
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True, name="gcs-conn")
            t.start()
            self._conn_threads.append(t)
        try:
            listener.close()  # sole closer: no fd reuse while accept may run
        except OSError:
            pass

    # label-cardinality cap for the per-RPC-type histogram: the type string
    # is client-supplied, so without a bound a misbehaving/skewed client
    # could grow GCS memory and every snapshot with garbage series. The
    # real dispatch table is ~100 types; overflow buckets as "other".
    _RPC_TYPE_CAP = 160

    def _observe_rpc(self, rpc_type, seconds: float) -> None:
        """Per-type server-side latency. Bound labelsets are cached so the
        steady-state cost is one lock-free histogram observe per request;
        past the cap, unseen types share one uncached "other" bind so
        neither the series set nor the cache grows."""
        b = self._rpc_bound.get(rpc_type)
        if b is None:
            with self._rpc_bound_lock:
                b = self._rpc_bound.get(rpc_type)
                if b is None:
                    if len(self._rpc_bound) < self._RPC_TYPE_CAP:
                        b = self._rpc_bound[rpc_type] = self._rpc_hist.bind(
                            {"rpc": str(rpc_type)})
                    else:
                        b = self._rpc_other
        b.observe(seconds)

    def _serve_conn(self, conn: MsgConnection):
        wid = None
        try:
            while True:
                msg = conn.recv()
                _t0 = time.perf_counter()
                try:
                    wid = self._handle(conn, msg, wid)
                except ConnectionClosed:
                    raise
                except Exception:  # noqa: BLE001 — one bad request must not kill the conn thread
                    logger.exception("gcs: error handling %s", msg.get("type"))
                    if "rid" in msg:
                        try:
                            conn.send({"rid": msg["rid"], "ok": False,
                                       "error": "internal error; see GCS log"})
                        except ConnectionClosed:
                            raise
                finally:
                    self._observe_rpc(msg.get("type"),
                                      time.perf_counter() - _t0)
        except ConnectionClosed:
            if wid is not None:
                self._on_worker_death(wid)
            host_id = next((h for h, info in self.hosts.items()
                            if info.get("conn") is conn), None)
            if host_id is not None:
                self._remove_host(host_id)
            # drop pubsub subscriber state owned by this connection — a
            # crashed subscriber must not leave queues accumulating forever
            with self.lock:
                self._autoscaler_conns.discard(id(conn))
                dead_keys = [k for k, c in self.pubsub_conns.items() if c is conn]
                for k in dead_keys:
                    self.pubsub_conns.pop(k, None)
                    self.pubsub_queues.pop(k, None)
                    self.pubsub_pollers.pop(k, None)

    # --------------------------------------------------------------- dispatch

    def _handle(self, conn: MsgConnection, msg: dict, wid: str | None) -> str | None:
        t = msg["type"]
        if t == "register":
            if msg.get("codec") == "json":
                # language-neutral peer (e.g. the C++ worker): reply frames
                # must be JSON from the first message on
                conn.codec = "json"
            with self.lock:
                wid = msg["wid"]
                node_id = msg.get("node_id") or DEFAULT_NODE
                chips = tuple(msg.get("gpus") or ())
                renv_hash = msg.get("renv_hash", "")
                accepted = True
                if msg["kind"] == "worker":
                    # retire the spawn-accounting entry for this worker,
                    # matching by chip assignment + runtime-env hash so a
                    # specialized spawn isn't credited to a plain registration
                    dq = self._spawn_pending[node_id]
                    for i, (_, c, rh) in enumerate(dq):
                        if tuple(c or ()) == chips and rh == renv_hash:
                            del dq[i]
                            break
                    else:
                        if chips:
                            # no pending entry: this chip spawn was presumed
                            # failed and its chips refunded. Accept only if
                            # the chips are still unbound — otherwise another
                            # worker holds them and admitting this one would
                            # double-bind the physical chips.
                            node = self.nodes.get(node_id)
                            pool = node.chip_pool if (node and node.alive) else []
                            if all(c in pool for c in chips):
                                for c in chips:
                                    pool.remove(c)
                            else:
                                accepted = False
                        elif dq:
                            dq.popleft()
                if accepted:
                    self.workers[wid] = _Worker(
                        wid, conn, msg.get("pid", 0), msg["kind"], node_id,
                        gpus=chips, host_id=msg.get("host") or HEAD_HOST,
                        renv_hash=renv_hash,
                        direct_addr=msg.get("direct_addr"),
                        language=msg.get("language", "py"),
                        functions=tuple(msg.get("functions") or ()))
            if not accepted:
                conn.send({"rid": msg["rid"], "ok": False,
                           "error": "stale chip binding; exit"})
                try:
                    conn.send({"type": "exit"})
                except ConnectionClosed:
                    pass
                return None
            conn.send({"rid": msg["rid"], "ok": True})
            self._schedule()
            return wid
        if t == "get_session":
            conn.send({"rid": msg["rid"], "session_id": self.session_id})
            return wid
        if t == "register_host":
            with self.lock:
                host_id = msg["host_id"]
                node_id = msg.get("node_id") or host_id
                self.hosts[host_id] = {
                    "object_addr": msg.get("object_addr"), "conn": conn}
                self.node_hosts[node_id] = host_id
                self.nodes[node_id] = _VNode(
                    node_id, msg["resources"], msg.get("labels"))
                self._reapply_drain_locked(self.nodes[node_id])
            self._emit_event(_const.EVENT_NODE_JOIN, node=node_id,
                             message=f"host {host_id} registered",
                             host=host_id)
            conn.send({"rid": msg["rid"], "ok": True,
                       "session_id": self.session_id})
            self._schedule()
            return wid
        if t == "resource_view":
            # follower load delta (reference: ray_syncer resource-view
            # broadcasts) — stored on the host entry, served per node by
            # list_nodes (and the dashboard's nodes page on top of it)
            with self.lock:
                info = self.hosts.get(msg.get("host_id"))
                if info is not None:
                    info["view"] = {
                        "mem_usage": msg.get("mem_usage"),
                        "load1": msg.get("load1"),
                        "num_worker_procs": msg.get("num_worker_procs"),
                        "ts": time.monotonic(),
                    }
                    hist = self.node_history.setdefault(
                        msg.get("host_id"),
                        collections.deque(maxlen=720))
                    hist.append({"ts": time.time(),
                                 "mem_usage": msg.get("mem_usage"),
                                 "load1": msg.get("load1"),
                                 "num_worker_procs":
                                     msg.get("num_worker_procs")})
            return wid
        if t == "pong":
            with self.lock:
                info = self.hosts.get(msg.get("host_id"))
                if info is not None:
                    info["last_pong"] = time.monotonic()
            return wid
        if t == "log_line":
            # fan out to every driver (reference: log_monitor republishing
            # worker logs to drivers via GCS pubsub)
            with self.lock:
                drivers = [w.conn for w in self.workers.values()
                           if w.kind == "driver" and not w.dead]
            for dconn in drivers:
                try:
                    dconn.send({"type": "log_line", "source": msg["source"],
                                "line": msg["line"]})
                except ConnectionClosed:
                    pass
            return wid
        if t == "ref_delta":
            self._on_ref_delta(msg["deltas"], wid)
            return wid
        if t == "stream_item":
            with self.lock:
                st = self.streams.get(msg["task_id"])
            if st is None:
                # consumer released the stream: drop the orphan item's shm
                # copy and tell the producer to stop generating
                if msg.get("where") == "shm":
                    self._delete_host_copy(msg["oid"], msg.get("host") or HEAD_HOST)
                with self.lock:
                    prod = self.workers.get(msg.get("wid") or "")
                if prod is not None and not prod.dead:
                    try:
                        prod.conn.send({"type": "stream_cancel",
                                        "task_id": msg["task_id"]})
                    except ConnectionClosed:
                        pass
                return wid
            self._on_object_ready(
                msg["oid"], where=msg.get("where", "shm"),
                inline=msg.get("inline"), size=msg.get("size", 0),
                is_error=False, host=msg.get("host") or HEAD_HOST,
                contained=msg.get("contained"), tier=msg.get("tier", "shm"))
            with self.lock:
                st = self.streams.get(msg["task_id"])
                if st is not None:
                    st["producer"] = msg.get("wid") or st["producer"]
                    st["items"].append(msg["oid"])
                    waiters, st["waiters"] = st["waiters"], []
                else:
                    waiters = []
            for wconn, rid, idx in waiters:
                self._answer_stream_next(wconn, rid, msg["task_id"], idx)
            return wid
        if t == "stream_end":
            with self.lock:
                st = self.streams.get(msg["task_id"])
                if st is not None:
                    st["done"] = True
                    st["error"] = msg.get("error")
                    st["producer"] = msg.get("wid") or st["producer"]
                    waiters, st["waiters"] = st["waiters"], []
                else:
                    waiters = []
            for wconn, rid, idx in waiters:
                self._answer_stream_next(wconn, rid, msg["task_id"], idx)
            return wid
        if t == "stream_next":
            self._answer_stream_next(conn, msg["rid"], msg["task_id"], msg["index"])
            return wid
        if t == "stream_consumed":
            with self.lock:
                st = self.streams.get(msg["task_id"])
                if st is None:
                    return wid
                st["consumed"] = max(st["consumed"], msg["index"])
                prod = self.workers.get(st["producer"]) if st["producer"] else None
            if prod is not None and not prod.dead:
                try:
                    prod.conn.send({"type": "stream_ack", "task_id": msg["task_id"],
                                    "consumed": msg["index"]})
                except ConnectionClosed:
                    pass
            return wid
        if t == "stream_release":
            # consumer dropped the generator: free whatever it didn't take
            with self.lock:
                st = self.streams.pop(msg["task_id"], None)
                leftover = st["items"][st["consumed"]:] if st else []
            if leftover:
                self._free_objects(leftover)
            return wid
        if t == "object_lost":
            action = self._reconstruct_or_report(msg["oid"])
            conn.send({"rid": msg["rid"], "action": action})
            return wid
        if t == "submit_task":
            self._submit_task(msg["spec"])
            # submission is async (reference: .remote() never waits on the
            # GCS); callers send rid-less fire-and-forget submits with a
            # periodic synchronous one as backpressure
            if "rid" in msg:
                conn.send({"rid": msg["rid"], "ok": True})
        elif t == "task_done":
            if conn.codec == "json":
                self._convert_cross_lang_done(msg)
            self._on_task_done(msg)
        elif t == "object_put":
            self._on_object_ready(msg["oid"], where=msg.get("where", "shm"),
                                  inline=msg.get("inline"), size=msg.get("size", 0),
                                  is_error=msg.get("is_error", False),
                                  host=msg.get("host") or HEAD_HOST,
                                  pin=msg.get("pin", False),
                                  contained=msg.get("contained"),
                                  tier=msg.get("tier", "shm"))
        elif t == "objects_evicted":
            # arena evict-to-spill on some host: those copies left tmpfs
            # (still readable from that host's spill tier)
            self._on_objects_evicted(msg.get("host") or HEAD_HOST,
                                     msg.get("oids") or [])
        elif t == "lease_workers":
            self._lease_workers(conn, msg, wid)
        elif t == "return_lease":
            for lw, tok in (msg.get("tokens") or {}).items():
                self._release_lease(lw, tok)
        elif t == "lease_released":
            # a worker reporting its caller's connection closed
            self._release_lease(msg["wid"], msg.get("token"))
        elif t == "pick_oom_victim":
            # a node agent under memory pressure asks for a victim on ITS
            # host: the GCS applies the same policy it uses for the head
            # (never actors/infrastructure) and tags the reason pre-kill
            victim = self._pick_oom_victim(msg.get("host_id") or HEAD_HOST)
            pid = None
            if victim is not None:
                pid, desc = victim
                why = (f"{msg.get('why', 'host memory pressure')}; "
                       f"killed {desc}")
                self._note_oom_kill(pid, why,
                                    host_id=msg.get("host_id") or HEAD_HOST)
            conn.send({"rid": msg["rid"], "pid": pid})
        elif t == "autoscaler_attach":
            with self.lock:
                self._autoscaler_conns.add(id(conn))
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "instance_put":
            # autoscaler instance state machine write-through (reference: v2
            # instance_storage) — the reply IS the durability ack: the
            # reconciler orders provider side-effects after it, so persist
            # (memory + sqlite) strictly before sending
            rec = dict(msg["instance"])
            iid = str(rec["instance_id"])
            with self.lock:
                prev = self.autoscaler_instances.get(iid)
                self.autoscaler_instances[iid] = rec
            if self.storage is not None:
                self.storage.put("instances", iid, rec)
            old_state = (prev or {}).get("state")
            new_state = rec.get("state")
            if new_state != old_state:
                self._emit_event(
                    _const.EVENT_AUTOSCALER_INSTANCE,
                    node=str(rec.get("node_id") or ""),
                    message=f"instance {iid}: "
                            f"{old_state or 'NEW'} -> {new_state}",
                    instance_id=iid, from_state=old_state, to_state=new_state)
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "instance_delete":
            iid = str(msg["instance_id"])
            with self.lock:
                self.autoscaler_instances.pop(iid, None)
            if self.storage is not None:
                self.storage.delete("instances", iid)
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "instance_list":
            with self.lock:
                recs = [dict(r) for r in self.autoscaler_instances.values()]
            conn.send({"rid": msg["rid"], "instances": recs})
        elif t == "serve_put":
            # serve control-plane write-through (reference: serve controller
            # checkpoints before side effects) — same contract as
            # instance_put: the reply IS the durability ack, so persist
            # (memory + sqlite) strictly before sending it
            key = str(msg["key"])
            rec = dict(msg["record"])
            with self.lock:
                self.serve_table[key] = rec
            if self.storage is not None:
                self.storage.put("serve", key, rec)
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "serve_delete":
            key = str(msg["key"])
            with self.lock:
                self.serve_table.pop(key, None)
            if self.storage is not None:
                self.storage.delete("serve", key)
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "serve_list":
            with self.lock:
                if msg.get("keys_only"):
                    conn.send({"rid": msg["rid"],
                               "keys": list(self.serve_table)})
                    return wid
                # light = control state only: blob rows carry the pickled
                # callables and must not ship to list-only consumers (the
                # dashboard polls this endpoint)
                light = bool(msg.get("light"))
                rows = {k: dict(r) for k, r in self.serve_table.items()
                        if not (light and k.startswith("blob:"))}
            conn.send({"rid": msg["rid"], "rows": rows})
        elif t == "oom_clear":
            # agent declined the pick or its kill failed: drop the tag
            self._note_oom_kill(msg["pid"], None,
                                host_id=msg.get("host_id") or HEAD_HOST)
        elif t == "worker_death_reason":
            # direct-dispatch callers ask why their leased worker vanished
            # (e.g. the memory monitor killed it) to build a useful error
            with self.lock:
                w2 = self.workers.get(msg["wid"])
                why = w2.oom_why if self._oom_fresh(w2) else None
            conn.send({"rid": msg["rid"], "reason": why})
        elif t == "direct_lineage":
            # a direct task produced evictable (shm) outputs: retain its spec
            # for reconstruction, same budget as GCS-path tasks
            with self.lock:
                evicted = self._retain_lineage_locked(msg["spec"])
            if evicted:
                self._free_objects(evicted)
        elif t == "unquarantine_chips":
            # operator re-enables chips quarantined by an OOM kill, after
            # confirming the host device pool is healthy again
            with self.lock:
                node = self.nodes.get(msg.get("node_id") or self.local_node_id)
                restored: list[int] = []
                if node is not None:
                    want = msg.get("chips")  # None = all
                    keep: list[int] = []
                    for c in node.quarantined_chips:
                        if want is None or c in want:
                            restored.append(c)
                        else:
                            keep.append(c)
                    node.quarantined_chips = keep
                    node.chip_pool.extend(restored)
            conn.send({"rid": msg["rid"], "restored": restored})
            self._schedule()
        elif t == "will_publish":
            # the sender promises a future object_put for this unpublished
            # direct-task result (publish_on_done). Recording the publisher
            # lets _on_worker_death fail the stub with OwnerDiedError instead
            # of letting borrowers block until their wait timeout
            dead_promise = False
            with self.lock:
                pw = self.workers.get(msg["wid"])
                if pw is None or pw.dead:
                    # promise arrived after the sender was declared dead (its
                    # death scan already ran): fail the stub right away
                    dead_promise = True
                else:
                    e = self.objects.setdefault(
                        msg["oid"], {"status": "pending", "where": None,
                                     "inline": None, "size": 0})
                    if e.get("status") == "pending":
                        e["pub_wid"] = msg["wid"]
                        self._pub_promises.setdefault(
                            msg["wid"], set()).add(msg["oid"])
            if dead_promise:
                self._fail_orphaned_stubs([msg["oid"]])
        elif t == "wait_object":
            self._wait_object(conn, msg)
        elif t == "free_objects_async":
            self._free_objects(list(msg["oids"]))
        elif t == "cancel_task":
            # reference: ray.cancel (core_worker CancelTask) — a queued task
            # is dequeued and its outputs fail with TaskCancelledError; a
            # RUNNING plain task is interrupted only with force=True, by
            # telling its worker process to die over the worker connection
            # (host-agnostic, serializes with completion messages — the same
            # route kill_actor uses). Actor tasks are never force-killed:
            # that would destroy unrelated callers' state (Ray rejects
            # force-cancel on actor tasks too).
            tid = msg["task_id"]
            cancelled = False
            die_conn = None
            free_args: list[str] = []
            with self.lock:
                removed = self.pending_tasks.remove_task_id(tid)
                cancelled = bool(removed)
                for spec in removed:
                    spec["_cancelled"] = True
                if not cancelled:
                    # a pending actor METHOD call sits in its actor's queue,
                    # not pending_tasks — dequeue it there (reference:
                    # ray.cancel dequeues queued actor tasks)
                    for a in self.actors.values():
                        hit = [s for s in a.queue if s["task_id"] == tid]
                        if hit:
                            a.queue = collections.deque(
                                s for s in a.queue if s["task_id"] != tid)
                            for spec in hit:
                                spec["_cancelled"] = True
                                free_args.extend(self._unpin_args_locked(spec))
                                # keep the group-lane backlog counter exact:
                                # a stale positive forces the grouped
                                # dispatch scan on every pass forever
                                if a.method_groups.get(
                                        spec.get("method") or "") is not None:
                                    a.group_queued = max(0, a.group_queued - 1)
                            removed.extend(hit)
                            cancelled = True
                            break
                if not cancelled and msg.get("force"):
                    for w in self.workers.values():
                        spec = w.running_tasks.get(tid)
                        if (spec is not None and not w.dead
                                and spec["kind"] == "task"):
                            # never retried, and fails as cancelled
                            spec["max_retries"] = 0
                            spec["_cancelled"] = True
                            die_conn = w.conn
                            cancelled = True
                            break
            for spec in removed:
                self._fail_task_objects(spec, "task was cancelled")
            if free_args:
                self._free_objects(free_args)
            if die_conn is not None:
                try:
                    die_conn.send({"type": "die"})
                except ConnectionClosed:
                    pass  # already dying; death handler finishes the job
            conn.send({"rid": msg["rid"], "cancelled": cancelled})
        elif t == "free_objects":
            # manual free: drop entries and every host copy, cascading to
            # nested refs (reference: ray._private.internal_api.free)
            self._free_objects(list(msg["oids"]))
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "create_actor":
            err = self._create_actor(msg["spec"])
            conn.send({"rid": msg["rid"], "ok": err is None, "error": err})
        elif t == "actor_task":
            ok, err = self._submit_actor_task(msg["spec"])
            conn.send({"rid": msg["rid"], "ok": ok, "error": err})
        elif t == "actor_task_async":
            # fire-and-forget submission (reference: actor task pushes are
            # async; a dead target fails the RESULT objects so the error
            # surfaces at ray.get, not at .remote())
            spec = msg["spec"]
            ok, err = self._submit_actor_task(spec)
            if not ok and isinstance(spec.get("num_returns"), int):
                self._fail_task_objects(spec, err)
        elif t == "wait_actor_ready":
            self._wait_actor_ready(conn, msg)
        elif t == "actor_info":
            # non-blocking liveness/placement probe (compiled-DAG recovery
            # polls this while waiting out an actor restart): state, the
            # host of the CURRENT incarnation (None mid-restart), and the
            # remaining restart budget
            with self.lock:
                a = self.actors.get(msg["aid"])
                if a is None:
                    conn.send({"rid": msg["rid"], "found": False})
                else:
                    w = self.workers.get(a.worker) if a.worker else None
                    conn.send({
                        "rid": msg["rid"], "found": True, "state": a.state,
                        "host": w.host_id if w is not None else None,
                        "restarts_left": a.restarts_left,
                        "num_restarts": a.num_restarts,
                        "max_task_retries": a.max_task_retries})
        elif t == "get_named_actor":
            with self.lock:
                aid = self.named_actors.get(
                    (msg.get("namespace") or "default", msg["name"]))
                state = self.actors[aid].state if aid else None
            conn.send({"rid": msg["rid"], "aid": aid, "state": state})
        elif t == "kill_actor":
            self._kill_actor(msg["aid"], msg.get("no_restart", True))
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "create_pg":
            err = self._create_pg(msg["spec"])
            conn.send({"rid": msg["rid"], "ok": err is None, "error": err})
        elif t == "remove_pg":
            self._remove_pg(msg["pg_id"])
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "pg_wait":
            self._pg_wait(conn, msg)
        elif t == "pg_table":
            with self.lock:
                table = {
                    pg.pg_id: {
                        "name": pg.name, "state": pg.state, "strategy": pg.strategy,
                        "bundles": [fp.float_dict(b.total) for b in pg.bundles],
                        "bundle_nodes": [b.node_id for b in pg.bundles],
                    }
                    for pg in self.pgs.values()
                }
            conn.send({"rid": msg["rid"], "table": table})
        elif t == "get_named_pg":
            with self.lock:
                pgid = self.named_pgs.get(msg["name"])
            conn.send({"rid": msg["rid"], "pg_id": pgid})
        elif t == "add_node":
            with self.lock:
                node_id = msg["node_id"]
                self.nodes[node_id] = _VNode(node_id, msg["resources"], msg.get("labels"))
                self._reapply_drain_locked(self.nodes[node_id])
            self._emit_event(_const.EVENT_NODE_JOIN, node=node_id,
                             message="virtual node added")
            conn.send({"rid": msg["rid"], "ok": True})
            self._schedule()
        elif t == "remove_node":
            self._remove_node(msg["node_id"], reason="removed by request")
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "node_drain":
            node_id = msg["node_id"]
            grace = msg.get("grace_s")
            reason = msg.get("reason") or ""
            ok, err = True, None
            notify: list = []
            with self.lock:
                node = self.nodes.get(node_id)
                if node is None or not node.alive:
                    ok, err = False, f"unknown or dead node {node_id!r}"
                else:
                    record = {"node_id": node_id, "reason": reason,
                              "grace_s": grace, "ts": time.time()}
                    # persist BEFORE any side effect (state flip, worker
                    # notices): a GCS restart re-applies the drain instead
                    # of resurrecting the node as placeable
                    if self.storage is not None:
                        self.storage.put("kv", _DRAIN_KV_PREFIX + node_id,
                                         record)
                    self.kv[_DRAIN_KV_PREFIX + node_id] = record
                    if not node.draining:
                        node.draining = True
                        node.drain_reason = reason
                        node.drain_since = time.time()
                        node.drain_grace = grace
                    # fan the notice out to every resident worker (and the
                    # node's host agent) so train sessions can land a
                    # preemption-grace checkpoint inside the window
                    for w in self.workers.values():
                        if w.node_id == node_id and not w.dead:
                            notify.append(w.conn)
                    host_id = self.node_hosts.get(node_id)
                    info = self.hosts.get(host_id) if host_id else None
                    if info is not None and info.get("conn") is not None:
                        notify.append(info["conn"])
            if ok:
                self._emit_event(
                    _const.EVENT_NODE_DRAIN,
                    severity=_const.EVENT_SEVERITY_WARNING, node=node_id,
                    message=f"drain requested: {reason or 'no reason given'}",
                    reason=reason, grace_s=grace)
            push = {"type": "drain_notice", "node_id": node_id,
                    "grace_s": grace, "reason": reason}
            for c in notify:
                try:
                    c.send(push)
                except ConnectionClosed:
                    pass
            conn.send({"rid": msg["rid"], "ok": ok, "error": err})
        elif t == "list_nodes":
            with self.lock:
                nodes = [
                    {"node_id": n.node_id, "alive": n.alive,
                     "draining": n.draining, "labels": dict(n.labels),
                     "drain_reason": n.drain_reason,
                     "drain_since": n.drain_since,
                     "drain_deadline": (n.drain_since + n.drain_grace
                                        if n.draining and n.drain_since
                                        and n.drain_grace else None),
                     "total": fp.float_dict(n.total),
                     "available": fp.float_dict(n.available),
                     "quarantined_chips": list(n.quarantined_chips),
                     "host_view": self._host_view_for(n.node_id)}
                    for n in self.nodes.values()
                ]
            conn.send({"rid": msg["rid"], "nodes": nodes})
        elif t == "kv_put":
            evicted: list[str] = []
            with self.lock:
                self.kv[msg["key"]] = msg["value"]
                if msg["key"].startswith("fn:"):
                    self._fn_access[msg["key"]] = time.monotonic()
                    # function store: bounded LRU-ish (insertion order) so
                    # dynamic-closure workloads can't grow the GCS without
                    # bound (reference: the function table is job-scoped).
                    # Keys referenced by pending/running specs or retained
                    # lineage are pinned — evicting them would make those
                    # tasks permanently unrunnable/unreconstructable. Keys
                    # touched recently are also spared: direct-plane
                    # in-flight specs and drivers inside their existence-
                    # probe memoization window are invisible to the pin
                    # scan, and both resolve within seconds. The budget is
                    # soft — overage with nothing evictable is fine.
                    fn_keys = [k for k in self.kv if k.startswith("fn:")]
                    excess = len(fn_keys) - 2048
                    if excess > 0:
                        pinned = self._pinned_fn_keys_locked()
                        fresh = time.monotonic() - 300.0
                        for k in fn_keys:
                            if excess <= 0:
                                break
                            if (k in pinned
                                    or self._fn_access.get(k, 0.0) > fresh):
                                continue
                            self.kv.pop(k, None)
                            self._fn_access.pop(k, None)
                            evicted.append(k)
                            excess -= 1
            if self.storage is not None:
                self.storage.put("kv", msg["key"], msg["value"])
                for k in evicted:
                    try:
                        self.storage.delete("kv", k)
                    except Exception:
                        pass
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "kv_get":
            with self.lock:
                val = self.kv.get(msg["key"])
                if msg["key"].startswith("fn:") and val is not None:
                    self._fn_access[msg["key"]] = time.monotonic()
            conn.send({"rid": msg["rid"], "value": val})
        elif t == "kv_keys":
            with self.lock:
                keys = [k for k in self.kv if k.startswith(msg.get("prefix", ""))]
                if msg.get("prefix", "").startswith("fn:"):
                    # a driver's existence probe: it will skip re-upload and
                    # submit specs referencing these — keep them evict-safe
                    # through the memoization window
                    now = time.monotonic()
                    for k in keys:
                        self._fn_access[k] = now
            conn.send({"rid": msg["rid"], "keys": keys})
        elif t == "kv_del":
            with self.lock:
                self.kv.pop(msg["key"], None)
                self._fn_access.pop(msg["key"], None)
            if self.storage is not None:
                self.storage.delete("kv", msg["key"])
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "cluster_state":
            with self.lock:
                state = {
                    "total_resources": self.total,
                    "available_resources": self.available,
                    "num_workers": sum(1 for w in self.workers.values() if w.kind == "worker" and not w.dead),
                    "num_actors": sum(1 for a in self.actors.values() if a.state == "alive"),
                    "pending_tasks": len(self.pending_tasks),
                    "task_counter": dict(self.task_counter),
                    "actors": {
                        a.aid: {"state": a.state, "name": a.name, "worker": a.worker,
                                "class": a.create_spec.get("class_name"),
                                "num_restarts": a.num_restarts,
                                "queued": len(a.queue), "in_flight": a.in_flight}
                        for a in self.actors.values()
                    },
                    "nodes": {
                        n.node_id: {"alive": n.alive, "draining": n.draining,
                                    "drain_reason": n.drain_reason,
                                    "drain_since": n.drain_since,
                                    "drain_deadline": (
                                        n.drain_since + n.drain_grace
                                        if n.draining and n.drain_since
                                        and n.drain_grace else None),
                                    "labels": dict(n.labels),
                                    "total": fp.float_dict(n.total),
                                    "available": fp.float_dict(n.available)}
                        for n in self.nodes.values()
                    },
                    # what the scheduler is sitting on, by kind — the
                    # "why is the cluster busy" one-liner for `ray_tpu_torch status`
                    "pending_demand": {
                        "tasks": len(self.pending_tasks),
                        "actor_creations": len(self.pending_actor_creations),
                        "placement_groups": sum(
                            1 for pg in self.pgs.values()
                            if pg.state == "pending"),
                    },
                }
            conn.send({"rid": msg["rid"], "state": state})
        elif t == "resource_demand":
            # unplaceable load summary for the autoscaler (reference: GCS
            # autoscaler state API, gcs_autoscaler_state_manager.h +
            # autoscaler.proto cluster_resource_state)
            with self.lock:
                demands = []
                for spec in self.pending_tasks:
                    demands.append(dict(spec.get("resources") or {}))
                for spec in self.pending_actor_creations:
                    demands.append(dict(spec.get("resources") or {}))
                # direct-dispatch backlogs queued at callers (stale entries
                # age out; dead callers' entries are dropped)
                now_m = time.monotonic()
                for (caller, _rk, _rh), (res, n, ts) in list(
                        self._direct_backlog.items()):
                    w = self.workers.get(caller)
                    if now_m - ts > 5.0 or w is None or w.dead:
                        self._direct_backlog.pop((caller, _rk, _rh), None)
                        continue
                    demands.extend([dict(res)] * min(n, 100))
                pg_demands = []
                for pgid in self.pending_pgs:
                    pg = self.pgs.get(pgid)
                    if pg is not None and pg.state == "pending":
                        pg_demands.append({"strategy": pg.strategy,
                                           "bundles": [fp.float_dict(b.total)
                                                       for b in pg.bundles]})
                state = {
                    "demands": demands,
                    "pg_demands": pg_demands,
                    "total_resources": self.total,
                    "available_resources": self.available,
                    "num_nodes": sum(1 for n in self.nodes.values() if n.alive),
                    "node_ids": [n.node_id for n in self.nodes.values()
                                 if n.alive],
                    # nodes where something holds resources (a task, an
                    # actor, a placement group): the autoscaler does not
                    # idle-terminate them (a port addition)
                    "busy_node_ids": [
                        n.node_id for n in self.nodes.values()
                        if n.alive and any(n.available.get(k, 0) < v
                                           for k, v in n.total.items())],
                }
            conn.send({"rid": msg["rid"], "demand": state})
        elif t == "worker_stacks":
            # live thread stacks of one worker process (reference:
            # dashboard/modules/reporter on-demand profiling)
            self._park_relay(conn, msg, prefix="st",
                             payload={"type": "dump_stacks"})
        elif t == "worker_profile":
            # on-demand in-process sampling profiler (reference capability:
            # dashboard/modules/reporter's py-spy integration; here the
            # worker samples its own frames — no ptrace in the sandbox).
            # Sampling runs duration_s in the worker, so the parked waiter
            # gets a TTL that outlives it.
            # sanitize HERE, not just at the dashboard edge: NaN survives
            # min()/comparisons, so a NaN duration from any client would
            # make the relay TTL never expire and leak the parked waiter
            import math as _math

            dur = float(msg.get("duration_s", 5.0))
            hz = float(msg.get("hz", 50.0))
            if not _math.isfinite(dur) or dur <= 0:
                dur = 5.0
            if not _math.isfinite(hz) or hz <= 0:
                hz = 50.0
            self._park_relay(
                conn, msg, prefix="pf",
                ttl=min(dur, 120.0) + 30.0,
                payload={"type": "profile", "duration_s": min(dur, 120.0),
                         "hz": hz})
        elif t == "stacks_reply":
            with self.lock:
                waiter = self._tensor_exports.pop(msg["token"], None)
            if waiter is not None:
                try:
                    waiter[0].send({"rid": waiter[1], "ok": True,
                                    "stacks": msg.get("text", "")})
                except ConnectionClosed:
                    pass
        elif t == "list_objects":
            # object-directory summary (reference: `ray list objects`,
            # util/state/state_cli.py backed by GCS/raylet introspection).
            # Filters run BEFORE the limit cut (state.list_objects pushes
            # its predicates here): limiting first would return fewer than
            # `limit` matching rows while more matches exist, and shipping
            # the whole table for client-side filtering would marshal
            # every row under this lock. limit <= 0 means unbounded.
            from ray_tpu_torch.util.state import matches_filters

            limit = int(msg.get("limit", 1000))
            filters = msg.get("filters") or ()
            truncated = False
            with self.lock:
                total = len(self.objects)
                rows = []
                for oid, e in self.objects.items():
                    row = {
                        "object_id": oid, "status": e.get("status"),
                        "where": e.get("where"), "size": e.get("size", 0),
                        "ref_count": e.get("count", 0),
                        "sys_holds": e.get("sys", 0),
                        "pinned": bool(e.get("pinned")),
                        "hosts": sorted(e.get("hosts", ())),
                    }
                    if filters and not matches_filters(row, filters):
                        continue
                    if 0 < limit <= len(rows):
                        # a further MATCH exists past the cut
                        truncated = True
                        break
                    rows.append(row)
            conn.send({"rid": msg["rid"], "objects": rows, "total": total,
                       "truncated": truncated})
        elif t == "list_workers":
            with self.lock:
                rows = [{"wid": w.wid, "pid": w.pid, "kind": w.kind,
                         "node_id": w.node_id, "host": w.host_id,
                         "dead": w.dead, "idle": w.idle,
                         "actor_id": w.actor_id,
                         "gpus": list(w.gpus)}
                        for w in self.workers.values()]
            conn.send({"rid": msg["rid"], "workers": rows})
        elif t == "export_tensor":
            # RDT cross-process fetch: relay to the owner worker and park
            # the requester until export_tensor_done (reference: RDT
            # transport coordination, gpu_object_manager.py)
            with self.lock:
                owner = self.workers.get(msg["owner_wid"])
                if owner is None or owner.dead:
                    owner = None
                else:
                    token = f"tx-{msg['rid']}-{id(conn) & 0xffffff}"
                    self._tensor_exports[token] = (conn, msg["rid"],
                                                   msg["owner_wid"],
                                                   time.monotonic())
            if owner is None:
                conn.send({"rid": msg["rid"], "ok": False,
                           "error": "owner process is gone"})
            else:
                try:
                    owner.conn.send({"type": "do_export_tensor",
                                     "tensor_id": msg["tensor_id"],
                                     "token": token})
                except ConnectionClosed:
                    with self.lock:
                        self._tensor_exports.pop(token, None)
                    conn.send({"rid": msg["rid"], "ok": False,
                               "error": "owner connection lost"})
        elif t == "export_tensor_done":
            with self.lock:
                waiter = self._tensor_exports.pop(msg["token"], None)
            if waiter is not None:
                wconn, wrid = waiter[0], waiter[1]
                try:
                    if msg.get("oid"):
                        wconn.send({"rid": wrid, "ok": True,
                                    "oid": msg["oid"]})
                    else:
                        wconn.send({"rid": wrid, "ok": False,
                                    "error": msg.get("error")
                                    or "tensor not found in owner registry"})
                except ConnectionClosed:
                    pass
        elif t == "metrics_report":
            # per-source replace so a worker's repeated reports (cumulative
            # local values) don't double-count in the aggregate
            source = msg.get("source") or wid or "unknown"
            with self.lock:
                for m in msg.get("metrics", []):
                    rec = self.metrics.setdefault(
                        m["name"], {"kind": m["kind"],
                                    "description": m.get("description", ""),
                                    "series": {}, "ts": {}})
                    rec["series"][source] = m["series"]
                    # snapshot ts per source: gauge merging picks the
                    # newest series deterministically (util/metrics.py
                    # to_prometheus), not whichever source iterates last
                    rec.setdefault("ts", {})[source] = m.get(
                        "ts", time.time())
        elif t == "metrics_history":
            # retained time series for the dashboard's graphs: per-node
            # resource views + cluster-level gauges (reference capability:
            # dashboard metrics tab backed by Prometheus range queries)
            with self.lock:
                limit = int(msg.get("limit", 0)) or None
                nodes = {hid: list(dq)[-limit:] if limit else list(dq)
                         for hid, dq in self.node_history.items()}
                cluster = (list(self.cluster_history)[-limit:] if limit
                           else list(self.cluster_history))
            conn.send({"rid": msg["rid"], "nodes": nodes,
                       "cluster": cluster})
        elif t == "metrics_snapshot":
            with self.lock:
                snap = {name: {"kind": r["kind"],
                               "description": r["description"],
                               "series": {s: list(v) for s, v in r["series"].items()},
                               "ts": dict(r.get("ts") or {})}
                        for name, r in self.metrics.items()}
                # fold in internal runtime stats as gauges
                snap["ray_tpu_pending_tasks"] = {
                    "kind": "gauge", "description": "tasks queued in the GCS",
                    "series": {"gcs": [[[], float(len(self.pending_tasks))]]}}
                snap["ray_tpu_live_actors"] = {
                    "kind": "gauge", "description": "actors in state alive",
                    "series": {"gcs": [[[], float(sum(
                        1 for a in self.actors.values() if a.state == "alive"))]]}}
                snap["ray_tpu_object_store_bytes"] = {
                    "kind": "gauge", "description": "live shm bytes per host",
                    "series": {"gcs": [[[["host", h]], float(v)]
                                       for h, v in self.host_shm_bytes.items()]}}
                snap["ray_tpu_live_workers"] = {
                    "kind": "gauge", "description": "live worker processes",
                    "series": {"gcs": [[[], float(sum(
                        1 for w in self.workers.values()
                        if w.kind == "worker" and not w.dead))]]}}
                self._draining_gauge.set(float(sum(
                    1 for n in self.nodes.values()
                    if n.alive and n.draining)))
                snap["ray_tpu_nodes_draining"] = {
                    "kind": "gauge",
                    "description": self._draining_gauge.description,
                    "series": {"gcs": self._draining_gauge._snapshot_series()}}
                snap["ray_tpu_node_mem_usage"] = {
                    "kind": "gauge",
                    "description": "host memory usage fraction per node",
                    "series": {"gcs": [
                        [[["host", hid]], float(s[-1]["mem_usage"] or 0.0)]
                        for hid, s in self.node_history.items() if s]}}
                for k, v in self.task_counter.items():
                    snap.setdefault("ray_tpu_tasks_total", {
                        "kind": "counter",
                        "description": "task terminal states",
                        "series": {"gcs": []}})["series"]["gcs"].append(
                            [[["state", k]], float(v)])
                # server-side RPC latency: unregistered histogram folded in
                # under the reserved "gcs" source (see __init__)
                snap["ray_tpu_gcs_rpc_seconds"] = {
                    "kind": "histogram",
                    "description": self._rpc_hist.description,
                    "series": {"gcs": self._rpc_hist._snapshot_series()},
                    "ts": {"gcs": time.time()}}
                # scheduler decision attribution (unregistered, GCS-local)
                self._sched_pending_gauge.set(
                    float(len(self.pending_tasks)), tags={"kind": "task"})
                self._sched_pending_gauge.set(
                    float(len(self.pending_actor_creations)),
                    tags={"kind": "actor"})
                self._sched_pending_gauge.set(
                    float(sum(1 for pg in self.pgs.values()
                              if pg.state == "pending")), tags={"kind": "pg"})
                for name, obj in (
                        ("ray_tpu_sched_decision_seconds", self._sched_hist),
                        ("ray_tpu_sched_decisions_total", self._sched_counter),
                        ("ray_tpu_sched_pending", self._sched_pending_gauge)):
                    snap[name] = {
                        "kind": obj.kind, "description": obj.description,
                        "series": {"gcs": obj._snapshot_series()},
                        "ts": {"gcs": time.time()}}
            conn.send({"rid": msg["rid"], "metrics": snap})
        elif t == "events_report":
            with self.lock:
                for ev in msg.get("events", []):
                    ev.setdefault("worker_id", wid or "")
                    self.task_events.append(ev)
                    if ev.get("direct") and ev.get("name") != "actor_create":
                        # direct-dispatch tasks never pass through
                        # submit/task_done: account them here so cluster
                        # task counters (and the errors channel) stay truthful
                        self.task_counter["submitted"] += 1
                        self.task_counter[
                            "finished" if ev.get("ok") else "failed"] += 1
                        if not ev.get("ok"):
                            self.publish("errors", {
                                "task_id": ev.get("task_id"), "kind": "task",
                                "name": ev.get("name"),
                                "worker": ev.get("worker_id"),
                                "error": ev.get("error"), "ts": ev.get("end")})
        elif t == "task_events":
            with self.lock:
                events = list(self.task_events)
            conn.send({"rid": msg["rid"], "events": events})
        elif t == "request_log_report":
            # serve flight-recorder entries (no reply — fire-and-forget
            # like events_report; the flusher bounds each batch to the
            # sender's ring size)
            with self.lock:
                for rec in msg.get("entries", []):
                    rec.setdefault("source", msg.get("source", wid or ""))
                    self.request_log.append(rec)
        elif t == "list_requests":
            with self.lock:
                rows = [dict(r) for r in self.request_log]
            limit = int(msg.get("limit", 0) or 0)
            if limit:
                rows = rows[-limit:]
            conn.send({"rid": msg["rid"], "requests": rows})
        elif t == "cluster_events_report":
            # controller processes (serve/train) flushing their local event
            # rings (no reply — fire-and-forget like request_log_report)
            if self._events_enabled:
                src = str(msg.get("source") or wid or "")
                for ev in msg.get("events", []):
                    if src and not ev.get("source"):
                        ev["source"] = src
                    self._ingest_event(dict(ev))
        elif t == "list_events":
            from ray_tpu_torch._private import events as _events
            with self._events_lock:
                rows = [dict(r) for r in self.cluster_events]
            rows = _events.filter_events(
                rows,
                min_severity=str(msg.get("severity") or ""),
                etype=str(msg.get("etype") or ""),
                node=str(msg.get("node") or ""),
                after_seq=int(msg.get("after_seq", 0) or 0),
                limit=int(msg.get("limit", 0) or 0))
            conn.send({"rid": msg["rid"], "events": rows})
        elif t == "sched_explain":
            conn.send({"rid": msg["rid"],
                       **self._sched_explain(str(msg.get("target") or ""))})
        elif t == "dag_register":
            # compiled-DAG registry (tentpole: observability for the channel
            # execution plane). The registering connection's wid is recorded
            # so driver death retires the entry — a DAG cannot outlive the
            # driver that owns its channels.
            rec = dict(msg["dag"])
            rec.setdefault("driver_wid", wid or "")
            with self.lock:
                self.compiled_dags[str(rec["dag_id"])] = rec
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "dag_deregister":
            with self.lock:
                existed = self.compiled_dags.pop(
                    str(msg["dag_id"]), None) is not None
            conn.send({"rid": msg["rid"], "ok": True, "existed": existed})
        elif t == "dag_list":
            with self.lock:
                rows = [dict(r) for r in self.compiled_dags.values()]
            conn.send({"rid": msg["rid"], "dags": rows})
        elif t == "subscribe":
            key = (msg["channel"], msg["sub_id"])
            with self.lock:
                self.pubsub_queues.setdefault(key, collections.deque(maxlen=10000))
                self.pubsub_conns[key] = conn
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "unsubscribe":
            key = (msg["channel"], msg["sub_id"])
            with self.lock:
                self.pubsub_queues.pop(key, None)
                self.pubsub_conns.pop(key, None)
                poller = self.pubsub_pollers.pop(key, None)
            if poller is not None:
                try:
                    poller[0].send({"rid": poller[1], "items": [], "closed": True})
                except ConnectionClosed:
                    pass
            conn.send({"rid": msg["rid"], "ok": True})
        elif t == "publish":
            self.publish(msg["channel"], msg["data"])
        elif t == "pubsub_poll":
            key = (msg["channel"], msg["sub_id"])
            with self.lock:
                q = self.pubsub_queues.get(key)
                if q is None:
                    conn.send({"rid": msg["rid"], "items": [], "closed": True})
                elif q:
                    items = list(q)
                    q.clear()
                    conn.send({"rid": msg["rid"], "items": items})
                else:
                    # long-poll: park until the next publish on the channel
                    # (reference: pubsub long-poll, src/ray/pubsub/publisher.h)
                    self.pubsub_pollers[key] = (conn, msg["rid"])
        else:
            logger.warning("gcs: unknown message type %s", t)
        return wid

    def publish(self, channel: str, data) -> None:
        """Fan a message out to every subscriber of `channel`. Callers may
        hold self.lock: sends happen on the pubsub sender thread."""
        with self.lock:
            for (ch, sub), q in self.pubsub_queues.items():
                if ch != channel:
                    continue
                key = (ch, sub)
                poller = self.pubsub_pollers.pop(key, None)
                if poller is not None:
                    self._pub_sendq.put((poller[0], {"rid": poller[1],
                                                     "items": [data]}))
                else:
                    q.append(data)

    def _pub_send_loop(self):
        while True:
            item = self._pub_sendq.get()
            if item is None:
                return
            conn, msg = item
            try:
                conn.send(msg)
            except (ConnectionClosed, Exception):
                pass

    # --------------------------------------------------------- cluster events

    def _emit_event(self, etype: str, *, severity: str | None = None,
                    node: str = "", message: str = "", **fields) -> None:
        """Record one typed cluster event at its GCS source. The event type
        must be a constants.py EVENT_* name (event-type-literal check).
        Callers may hold self.lock: the ring has its own lock and the
        sqlite write keys on a unique seq, so ordering never inverts."""
        if not self._events_enabled:
            return
        from ray_tpu_torch._private.events import make_event

        rec = make_event(
            etype, severity=severity or _const.EVENT_SEVERITY_INFO,
            node=node, message=message, source="gcs", **fields)
        self._ingest_event(rec)

    def _ingest_event(self, rec: dict) -> None:
        """Stamp a GCS sequence number onto one event record, ring it, and
        write INFO+ through to the sqlite `events` table (DEBUG events —
        lease churn — stay in-memory: they dominate volume and explain
        nothing after a restart)."""
        with self._events_lock:
            self._cluster_event_seq += 1
            seq = rec[_const.EVENT_FIELD_SEQ] = self._cluster_event_seq
            self.cluster_events.append(rec)
        if (self.storage is not None
                and rec.get(_const.EVENT_FIELD_SEVERITY)
                != _const.EVENT_SEVERITY_DEBUG):
            try:
                self.storage.put("events", f"{seq:012d}", rec)
                # bound the table to the ring size: the entry this one
                # rotated out of a full ring also leaves the table
                if seq > self._events_ring_size:
                    self.storage.delete(
                        "events", f"{seq - self._events_ring_size:012d}")
            except Exception:
                # persistence is best-effort; the ring stays truthful
                logger.warning("gcs: event persist failed for seq %d", seq,
                               exc_info=True)

    def _restore_events_from_storage(self) -> None:
        """Reload persisted events (oldest first) and resume the sequence
        counter past them so post-restart events sort after."""
        rows = sorted(self.storage.items("events"))
        with self._events_lock:
            for key, rec in rows[-self._events_ring_size:]:
                self.cluster_events.append(rec)
            if rows:
                self._cluster_event_seq = max(
                    self._cluster_event_seq, int(rows[-1][0]))

    # ------------------------------------------------- scheduler attribution

    def _observe_sched(self, kind: str, outcome: str,
                       seconds: float | None, n: int = 1) -> None:
        """One terminal scheduler decision (n for batched grants):
        decisions/s counter plus the decision-latency histogram when a
        wait/RTT is attributable."""
        tags = {"kind": kind, "outcome": outcome}
        self._sched_counter.inc(float(n), tags=tags)
        if seconds is not None and seconds >= 0:
            self._sched_hist.observe(seconds, tags=tags)

    def _trace_enqueue(self, key: str, kind: str) -> None:
        """(Re)enter a work item into the pending decision-trace table.
        Caller holds self.lock."""
        tr = self.sched_traces.get(key)
        if tr is None:
            tr = self.sched_traces[key] = {
                "kind": kind, "attempts": 0, "history": []}
        tr["status"] = "pending"
        tr["attempts"] += 1
        tr["enqueued_ts"] = time.time()
        tr["_enq_mono"] = time.monotonic()

    def _trace_decision(self, key: str, status: str, **fields) -> None:
        """Advance a trace to dispatched/placed/created/failed, recording
        per-attempt attribution. Caller holds self.lock."""
        tr = self.sched_traces.get(key)
        if tr is None:
            return
        tr["status"] = status
        tr.update(fields)
        if status in ("placed", "created", "failed"):
            hist = tr.setdefault("history", [])
            hist.append({k: tr.get(k) for k in
                         ("attempts", "status", "node", "queue_wait_s",
                          "lease_rtt_s") if tr.get(k) is not None})
            del hist[:-8]  # keep the last attempts only

    def _explain_spec_locked(self, spec: dict) -> dict:
        """Per-node rejection table for one pending spec: mirrors _fits_for
        but returns WHY each candidate fails instead of the first fit.
        Computed lazily (only when sched_explain asks) so _schedule never
        pays for it. Caller holds self.lock."""
        res = self._spec_fp(spec)
        strat = spec.get("strategy") or {}
        reasons: dict[str, str] = {}
        if strat.get("kind") == "pg":
            pg = self.pgs.get(strat.get("pg_id"))
            if pg is None:
                return {"<pg>": f"no such placement group {strat.get('pg_id')!r}"}
            if pg.state != "created":
                return {"<pg>": f"placement group is {pg.state}, not created"}
            idx = strat.get("bundle", -1)
            cand = (list(enumerate(pg.bundles)) if idx == -1
                    else [(idx, pg.bundles[idx])])
            for i, b in cand:
                short = next((k for k, v in res.items()
                              if b.available.get(k, 0) < v), None)
                if short is None:
                    reasons[f"bundle[{i}]@{b.node_id}"] = (
                        "fits; waiting on worker availability")
                else:
                    reasons[f"bundle[{i}]@{b.node_id}"] = (
                        f"insufficient {short}: need "
                        f"{fp.from_fp(res[short])}, bundle has "
                        f"{fp.from_fp(b.available.get(short, 0))}")
            return reasons
        hard = strat.get("hard", {}) if strat.get("kind") == "node_label" else {}
        affinity = (strat.get("node_id")
                    if strat.get("kind") == "node_affinity" else None)
        soft = bool(strat.get("soft"))
        for n in self.nodes.values():
            if not n.alive:
                reasons[n.node_id] = "node is dead"
                continue
            if n.draining:
                reasons[n.node_id] = (
                    "node is draining"
                    + (f" ({n.drain_reason})" if n.drain_reason else ""))
                continue
            if affinity is not None and n.node_id != affinity and not soft:
                reasons[n.node_id] = (
                    f"not the node_affinity target {affinity!r}")
                continue
            miss = next(((k, v) for k, v in hard.items()
                         if n.labels.get(k) != v), None)
            if miss is not None:
                reasons[n.node_id] = (
                    f"label mismatch: requires {miss[0]}={miss[1]!r}, node "
                    f"has {n.labels.get(miss[0])!r}")
                continue
            short = next((k for k, v in res.items()
                          if n.available.get(k, 0) < v), None)
            if short is not None:
                reasons[n.node_id] = (
                    f"insufficient {short}: need {fp.from_fp(res[short])}, "
                    f"node has {fp.from_fp(n.available.get(short, 0))} "
                    f"available of {fp.from_fp(n.total.get(short, 0))}")
                continue
            reasons[n.node_id] = (
                "fits; waiting on worker availability (spawn in progress "
                "or max_workers reached)")
        if not self._deps_ready(spec):
            reasons["<deps>"] = "task dependencies are not yet available"
        return reasons

    def _explain_pg_locked(self, pg: "_PG") -> dict:
        """Per-node rejection view for a pending placement group: what the
        placement policy could fit on each node in isolation (bundles that
        fit nowhere, or a strategy that needs a joint assignment no node
        set satisfies). Caller holds self.lock."""
        reasons: dict[str, str] = {}
        for n in self.nodes.values():
            if not n.alive:
                reasons[n.node_id] = "node is dead"
                continue
            if n.draining:
                reasons[n.node_id] = (
                    "node is draining"
                    + (f" ({n.drain_reason})" if n.drain_reason else ""))
                continue
            unfit = []
            for i, b in enumerate(pg.bundles):
                short = next((k for k, v in b.total.items()
                              if n.available.get(k, 0) < v), None)
                if short is not None:
                    unfit.append(
                        f"bundle[{i}] short {fp.from_fp(b.total[short] - n.available.get(short, 0))} {short}")
            if unfit:
                reasons[n.node_id] = "; ".join(unfit)
            else:
                reasons[n.node_id] = (
                    f"every bundle fits individually; no joint "
                    f"{pg.strategy} assignment found yet")
        return reasons

    def _sched_explain(self, target: str) -> dict:
        """Answer "why is X pending": the live per-node rejection table for
        a pending actor or placement group, plus the decision trace for
        anything the scheduler has already placed."""
        with self.lock:
            a = self.actors.get(target)
            if a is not None:
                out = {"found": True, "kind": "actor", "state": a.state,
                       "trace": dict(self.sched_traces.get(target) or {})}
                out["trace"].pop("_enq_mono", None)
                if a.state in ("pending", "restarting"):
                    spec = next(
                        (s for s in self.pending_actor_creations
                         if s.get("actor_id") == target), None)
                    if spec is not None:
                        out["rejections"] = self._explain_spec_locked(spec)
                        enq = spec.get("_enq_ts")
                        if enq is not None:
                            out["queue_wait_s"] = round(
                                time.monotonic() - enq, 6)
                    else:
                        # dispatched: a worker is spawning / creating it
                        out["rejections"] = {}
                        out["note"] = ("creation dispatched to worker "
                                       f"{a.worker!r}; waiting on the "
                                       "worker to finish __init__")
                return out
            pg = self.pgs.get(target)
            if pg is not None:
                out = {"found": True, "kind": "pg", "state": pg.state,
                       "trace": dict(self.sched_traces.get(target) or {})}
                out["trace"].pop("_enq_mono", None)
                if pg.state == "pending":
                    out["rejections"] = self._explain_pg_locked(pg)
                return out
        return {"found": False,
                "error": f"no actor or placement group {target!r}"}

    # --------------------------------------------------------------- objects

    def _on_object_ready(self, oid: str, where: str, inline, size: int,
                         is_error: bool, host: str = HEAD_HOST,
                         pin: bool = False, contained=None,
                         tier: str = "shm", only_if_pending: bool = False):
        with self.lock:
            prev = self.objects.get(oid)
            if (only_if_pending and prev is not None
                    and prev.get("status") != "pending"):
                # guarded write (owner-death error path): a concurrently
                # published real value wins over the OwnerDiedError
                return
            if (prev is not None and prev["status"] == "ready"
                    and prev["where"] == "shm" and where == "shm"):
                # an additional shm copy on another host: extend the location
                # set, keep the entry (reference: object directory adding a
                # location, ownership_object_directory.h)
                added_copy = False
                if host not in prev.setdefault("hosts", set()):
                    prev["hosts"].add(host)
                    if tier == "shm":
                        self._note_shm_copy_locked(prev, host)
                        added_copy = True
            else:
                added_copy = None
        if added_copy is not None:
            if added_copy:
                # pull-heavy consumer hosts must hit the spill budget too
                self._maybe_spill(host)
            return
        with self.lock:
            prev = self.objects.get(oid)
            if (only_if_pending and prev is not None
                    and prev.get("status") != "pending"):
                return  # re-check: the real publish won the race
            if prev is not None:
                self._drop_shm_copies_locked(prev)  # stale copies of an overwrite
                pw = prev.pop("pub_wid", None)
                if pw is not None:
                    # promise fulfilled (or superseded): drop the index entry
                    # so long-lived drivers don't accumulate dead promises
                    s = self._pub_promises.get(pw)
                    if s is not None:
                        s.discard(oid)
                        if not s:
                            self._pub_promises.pop(pw, None)
            entry = self.objects[oid] = {
                **(prev or {}),  # keep refcount state accumulated while pending
                "status": "error" if is_error else "ready",
                "where": where,
                "inline": inline,
                "size": size,
                "hosts": {host} if where == "shm" else set(),
            }
            if where == "shm":
                entry["shm_live"] = set()
                if tier == "shm":
                    self._note_shm_copy_locked(entry, host)
            if pin:
                entry["pinned"] = True
            if contained and "contained" not in entry:
                entry["contained"] = list(contained)
                self._sys_hold_locked(contained, +1)
            waiters = self.object_waiters.pop(oid, [])
        for conn, rid in waiters:
            self._reply_object(conn, rid, entry)
        if where == "shm" and tier == "shm":
            self._maybe_spill(host)
        self._schedule()

    def _note_shm_copy_locked(self, entry: dict, host: str) -> None:
        entry.setdefault("shm_live", set()).add(host)
        entry["last_access"] = time.monotonic()
        self.host_shm_bytes[host] += entry.get("size", 0)

    def _drop_shm_copies_locked(self, entry: dict) -> None:
        """Undo the tmpfs accounting for every live copy of an entry (host
        loss, reconstruction reset, entry overwrite)."""
        for h in entry.get("shm_live", ()):
            self.host_shm_bytes[h] -= entry.get("size", 0)
        entry["shm_live"] = set()

    def _maybe_spill(self, host: str) -> None:
        """Spill LRU tmpfs objects on `host` down to disk until under the
        budget (reference: raylet/local_object_manager.h:43)."""
        if not self.spill_capacity:
            return
        to_spill: list[str] = []
        with self.lock:
            used = self.host_shm_bytes.get(host, 0)
            if used <= self.spill_capacity:
                return
            target = int(self.spill_capacity * 0.7)
            cands = sorted(
                (e.get("last_access", 0.0), oid, e)
                for oid, e in self.objects.items()
                if e.get("status") == "ready" and host in e.get("shm_live", ()))
            for _, oid, e in cands:
                if used <= target:
                    break
                e["shm_live"].discard(host)
                used -= e.get("size", 0)
                to_spill.append(oid)
            self.host_shm_bytes[host] = used
            agent = (self.hosts.get(host) or {}).get("conn")
        if not to_spill:
            return
        if agent is not None:
            try:
                agent.send({"type": "spill_objects", "oids": to_spill})
            except ConnectionClosed:
                pass
        elif self.session_id:
            for oid in to_spill:
                try:
                    self._head_store().spill(oid)
                except Exception:
                    logger.exception("spill of %s failed", oid)

    def _object_locations_locked(self, entry: dict) -> list:
        return [(h, self.hosts[h]["object_addr"])
                for h in entry.get("hosts", ()) if h in self.hosts]

    # ---------------------------------------------------- reference counting
    # GCS-arbitered equivalent of the reference's distributed ReferenceCounter
    # (src/ray/core_worker/reference_counter.h:43): workers report process-
    # level ref transitions; the GCS adds system holds for in-flight task
    # dependencies and refs nested inside stored objects, and frees an object
    # cluster-wide when every hold is gone.

    def _on_ref_delta(self, deltas: dict, wid: str | None = None):
        free: list[str] = []
        with self.lock:
            w = self.workers.get(wid) if wid else None
            if w is not None and w.dead:
                # this process was already declared dead and its ref balance
                # reclaimed — applying its late in-flight deltas would double
                # count (e.g. a -1 drained from the socket after host removal)
                return
            for oid, n in deltas.items():
                e = self.objects.get(oid)
                if e is None:
                    continue  # stale ref from a prior session / already freed
                e["count"] = e.get("count", 0) + n
                # any delta (including a within-window +1/-1 cancel, sent as
                # 0) proves the object has been user-referenced
                e["counted"] = True
                if w is not None and n:
                    bal = w.ref_balance.get(oid, 0) + n
                    if bal:
                        w.ref_balance[oid] = bal
                    else:
                        w.ref_balance.pop(oid, None)
                if self._freeable_locked(oid, e):
                    free.append(oid)
        if free:
            self._free_objects(free)

    def _freeable_locked(self, oid: str, e: dict) -> bool:
        return (e.get("counted", False)
                and e.get("count", 0) <= 0
                and e.get("sys", 0) <= 0
                and not e.get("pinned", False)
                and e.get("status") != "pending"
                # PG-ready sentinels are owned by the PG state machine
                and not (oid.endswith("r0000") and oid[:-5] in self.pgs))

    def _sys_hold_locked(self, oids, n: int) -> list[str]:
        """Adjust system holds; returns oids that became freeable."""
        out = []
        for oid in oids:
            e = self.objects.get(oid)
            if e is None:
                if n > 0:
                    # dep/nested ref the GCS hasn't seen yet — typically an
                    # unpublished direct-task result whose owner will
                    # object_put it (publish_on_done): park the hold in a
                    # stub entry the publish merges into
                    self.objects[oid] = {"status": "pending", "where": None,
                                         "inline": None, "size": 0, "sys": n}
                continue
            e["sys"] = e.get("sys", 0) + n
            if n < 0 and self._freeable_locked(oid, e):
                out.append(oid)
        return out

    def _unpin_args_locked(self, spec: dict) -> list[str]:
        """Release a spec's pinned args blob (no user ref ever exists for
        one); returns the oid to free, if any."""
        args_oid = spec.get("args_oid")
        if args_oid and args_oid in self.objects:
            self.objects[args_oid]["pinned"] = False
            return [args_oid]
        return []

    def _actor_dead_cleanup_locked(self, create_spec: dict) -> list[str]:
        """Permanent actor death: release creation-arg holds and the pinned
        creation-args blob. Returns oids to free."""
        out = self._sys_hold_locked(create_spec.pop("_actor_holds", ()), -1)
        out.extend(self._unpin_args_locked(create_spec))
        return out

    def _drop_lineage_locked(self, tid: str) -> list[str]:
        """Forget a task's retained spec; its (pinned, otherwise-unowned)
        args blob goes with it. Returns oids to free."""
        spec = self.lineage.pop(tid, None)
        if spec is None:
            return []
        return self._unpin_args_locked(spec)

    def _on_objects_evicted(self, host: str, oids: list) -> None:
        """A host's arena pushed these objects down to its spill tier to
        make room: drop them from that host's tmpfs accounting so
        `_maybe_spill` and the object directory's tier info stay truthful.
        The host keeps serving them (spill-tier reads are transparent), so
        the location set is untouched."""
        with self.lock:
            for oid in oids:
                e = self.objects.get(oid)
                if e is not None and host in e.get("shm_live", ()):
                    e["shm_live"].discard(host)
                    self.host_shm_bytes[host] -= e.get("size", 0)

    def _head_store(self):
        if getattr(self, "_head_store_obj", None) is None:
            if self.stopped:
                # a straggler thread lazily constructing the store AFTER
                # session teardown would recreate the just-unlinked arena
                # segment in /dev/shm — refuse instead (callers tolerate)
                raise RuntimeError("GCS stopped; head store torn down")
            from ray_tpu_torch._private.object_store import make_object_store

            self._head_store_obj = make_object_store(self.session_id)
            if hasattr(self._head_store_obj, "on_evict"):
                # the GCS runs in the driver process: account directly
                self._head_store_obj.on_evict = (
                    lambda oids: self._on_objects_evicted(HEAD_HOST, oids))
        return self._head_store_obj

    def _free_objects(self, oids: list[str]):
        """Drop entries and delete every host's shm copy; cascades to refs
        nested inside the freed objects (reference: plasma delete +
        reference_counter release cascades)."""
        by_host: dict[str, list[str]] = collections.defaultdict(list)
        cascade: list[str] = []
        agent_msgs = []
        dev_frees: dict = collections.defaultdict(list)  # wid → tensor ids
        with self.lock:
            for oid in oids:
                e = self.objects.pop(oid, None)
                if e is None:
                    continue
                dt = e.get("device_tensors")
                if dt:
                    dev_frees[dt[0]].extend(dt[1])
                self.object_waiters.pop(oid, None)
                self._drop_shm_copies_locked(e)
                for h in e.get("hosts", ()):
                    by_host[h].append(oid)
                cascade.extend(self._sys_hold_locked(e.get("contained", ()), -1))
                # drop retained lineage once a task's outputs are all gone
                tid = oid[:-5]
                spec = self.lineage.get(tid)
                if spec is not None and not any(
                        f"{tid}r{i:04d}" in self.objects
                        for i in range(spec["num_returns"])):
                    cascade.extend(self._drop_lineage_locked(tid))
            for h, lst in by_host.items():
                info = self.hosts.get(h)
                if info is not None and info.get("conn") is not None:
                    agent_msgs.append((info["conn"], lst))
        if self.session_id:
            for oid in by_host.get(HEAD_HOST, ()):
                try:
                    self._head_store().delete(oid)
                except Exception:
                    pass
        for conn, lst in agent_msgs:
            try:
                conn.send({"type": "delete_objects", "oids": lst})
            except ConnectionClosed:
                pass
        if dev_frees:
            # tell owners to drop the freed objects' HBM registry entries
            with self.lock:
                targets = [(self.workers.get(w), tids)
                           for w, tids in dev_frees.items()]
            for w, tids in targets:
                if w is not None and not w.dead:
                    try:
                        w.conn.send({"type": "free_device_tensors",
                                     "tensor_ids": tids})
                    except ConnectionClosed:
                        pass
        if cascade:
            self._free_objects(cascade)

    # ------------------------------------------------- lineage reconstruction

    def _delete_host_copy(self, oid: str, host: str) -> None:
        """Delete one host's store copy of an object with no table entry."""
        info = self.hosts.get(host)
        if info is not None and info.get("conn") is not None:
            try:
                info["conn"].send({"type": "delete_objects", "oids": [oid]})
            except ConnectionClosed:
                pass
        elif host == HEAD_HOST and self.session_id:
            try:
                self._head_store().delete(oid)
            except Exception:
                pass

    def _answer_stream_next(self, conn: MsgConnection, rid: int,
                            task_id: str, index: int) -> None:
        with self.lock:
            st = self.streams.get(task_id)
            if st is None:
                reply = {"rid": rid, "done": True, "error": None}
            elif index < len(st["items"]):
                reply = {"rid": rid, "oid": st["items"][index]}
            elif st["done"]:
                reply = {"rid": rid, "done": True, "error": st["error"]}
            else:
                st["waiters"].append((conn, rid, index))
                return
        try:
            conn.send(reply)
        except ConnectionClosed:
            pass

    def _reconstruct_or_report(self, oid: str) -> str:
        """A consumer failed to materialize `oid` from any advertised copy.
        Resubmit the creating task — and, recursively, any upstream task
        whose outputs it needs that are also gone — if specs were retained
        (reference: object_recovery_manager.h:41 — the owner resubmits the
        creating task; lineage pinning keeps ancestors recoverable).
        Returns the action the consumer should take."""
        plan: list[dict] = []
        with self.lock:
            e = self.objects.get(oid)
            tid = oid[:-5] if len(oid) > 5 else ""
            if e is None:
                # no entry yet the owner asserts loss: an UNPUBLISHED
                # direct-task result (owned bookkeeping never reached the
                # GCS). The retained lineage spec can still replay it —
                # _collect_recon_locked creates the pending entries the
                # consumer's follow-up wait_object parks on.
                if tid not in self.lineage:
                    return "gone"
            elif e["status"] == "pending":
                return "pending"  # reconstruction already in flight
            elif e.get("where") == "inline":
                return "ready"
            if not self._collect_recon_locked(tid, plan, set(), 0):
                return "lost"
        # resubmit upstream-first: _deps_ready gates execution order anyway
        for spec in plan:
            self._submit_task(spec)
        return "reconstructing"

    def _collect_recon_locked(self, tid: str, plan: list, seen: set,
                              depth: int) -> bool:
        """Plan reconstruction of task `tid`'s outputs, recursing into
        missing upstream dependencies. Resets the involved return entries to
        pending (so concurrent reporters dedupe on 'pending')."""
        if tid in seen:
            return True
        if depth > 8:
            return False
        spec = self.lineage.get(tid)
        if spec is None or spec.get("recons_used", 0) >= MAX_RECONSTRUCTIONS:
            return False
        for dep in list(spec.get("deps", ())) + list(spec.get("ref_holds", ())):
            de = self.objects.get(dep)
            missing = (
                de is None
                or (de["status"] == "ready" and de.get("where") == "shm"
                    and not de.get("hosts")))
            if missing and not self._collect_recon_locked(
                    dep[:-5], plan, seen, depth + 1):
                return False
        spec["recons_used"] = spec.get("recons_used", 0) + 1
        seen.add(tid)
        for i in range(spec["num_returns"]):
            roid = f"{tid}r{i:04d}"
            re_ = self.objects.get(roid)
            if re_ is None:
                self.objects[roid] = {"status": "pending", "where": None,
                                      "inline": None, "size": 0}
            elif re_["status"] != "pending":
                self._drop_shm_copies_locked(re_)
                re_.update(status="pending", inline=None)
                re_["hosts"] = set()
                # the re-run will report fresh nested refs; keeping the old
                # 'contained' would make task_done skip taking holds on them
                stale = re_.pop("contained", None)
                if stale:
                    self._sys_hold_locked(stale, -1)
        newspec = {k: v for k, v in spec.items()
                   if k not in ("_paid", "_holds", "_fp_res", "retries_used", "recons_used")}
        # a hard affinity to a dead node would make reconstruction
        # unschedulable forever; the data matters more than the placement
        strat = newspec.get("strategy")
        if strat and strat.get("kind") == "node_affinity":
            node = self.nodes.get(strat.get("node_id"))
            if node is None or not node.alive:
                newspec.pop("strategy", None)
        plan.append(newspec)
        return True

    def _reply_object(self, conn: MsgConnection, rid: int, entry: dict):
        with self.lock:
            locs = self._object_locations_locked(entry)
        try:
            conn.send({
                "rid": rid, "ready": True, "status": entry["status"],
                "where": entry["where"], "inline": entry["inline"], "size": entry["size"],
                "locations": locs,
            })
        except ConnectionClosed:
            pass

    def _wait_object(self, conn: MsgConnection, msg: dict):
        oid = msg["oid"]
        with self.lock:
            entry = self.objects.get(oid)
            if entry is None or entry["status"] == "pending":
                self.object_waiters.setdefault(oid, []).append((conn, msg["rid"]))
                return
            entry["last_access"] = time.monotonic()  # LRU signal for the spiller
        self._reply_object(conn, msg["rid"], entry)

    def _park_relay(self, conn: MsgConnection, msg: dict, *, prefix: str,
                    payload: dict, ttl: float = 30.0) -> None:
        """Forward `payload` (plus a reply token) to msg["wid"] and park the
        requester until the worker's stacks_reply comes back; waiters are
        (conn, rid, wid, parked_at, ttl) — expired by the health loop."""
        with self.lock:
            target = self.workers.get(msg["wid"])
            if target is not None and not target.dead:
                token = f"{prefix}-{msg['rid']}-{id(conn) & 0xffffff}"
                self._tensor_exports[token] = (conn, msg["rid"], msg["wid"],
                                               time.monotonic(), ttl)
            else:
                target = None
        if target is None:
            conn.send({"rid": msg["rid"], "ok": False,
                       "error": "no such live worker"})
            return
        try:
            target.conn.send({**payload, "token": token})
        except ConnectionClosed:
            with self.lock:
                self._tensor_exports.pop(token, None)
            conn.send({"rid": msg["rid"], "ok": False,
                       "error": "worker connection lost"})

    # ------------------------------------------------------------- accounting


    @staticmethod
    def _spec_fp(spec: dict) -> dict:
        """Fixed-point view of spec["resources"], cached on the spec —
        schedulers probe the same pending spec many times per pass, and a
        forgotten fp.fp_dict wrapper at a new call site would compare raw
        floats against integer availability (never fits)."""
        r = spec.get("_fp_res")
        if r is None:
            r = fp.fp_dict(spec.get("resources") or {})
            spec["_fp_res"] = r
        return r

    def _fits_for(self, spec: dict) -> str | None:
        """Pick a node for this spec honoring its scheduling strategy.
        Returns node_id or None if nothing fits right now."""
        res = self._spec_fp(spec)
        strat = spec.get("strategy")
        if strat and strat.get("kind") == "pg":
            pg = self.pgs.get(strat["pg_id"])
            if pg is None or pg.state != "created":
                return None
            idx = strat.get("bundle", -1)
            if idx != -1 and not (0 <= idx < len(pg.bundles)):
                return None  # invalid index: rejected at submit time
            cand = pg.bundles if idx == -1 else [pg.bundles[idx]]
            for b in cand:
                if all(b.available.get(k, 0) >= v for k, v in res.items()):
                    return b.node_id
            return None
        if strat and strat.get("kind") == "node_label":
            hard = strat.get("hard", {})
            cands = [n for n in self.nodes.values() if n.alive
                     and not n.draining
                     and all(n.labels.get(k) == v for k, v in hard.items())]
            return pg_policy.pick_node_hybrid(cands, res, self.local_node_id)
        if strat and strat.get("kind") == "node_affinity":
            n = self.nodes.get(strat["node_id"])
            if (n is not None and n.alive and not n.draining
                    and pg_policy._fits(n.available, res)):
                return n.node_id
            if strat.get("soft"):
                return pg_policy.pick_node_hybrid(list(self.nodes.values()), res, self.local_node_id)
            return None
        return pg_policy.pick_node_hybrid(list(self.nodes.values()), res, self.local_node_id)

    def _acquire_for(self, spec: dict, node_id: str):
        res = self._spec_fp(spec)
        strat = spec.get("strategy")
        if strat and strat.get("kind") == "pg":
            pg = self.pgs[strat["pg_id"]]
            idx = strat.get("bundle", -1)
            cands = list(enumerate(pg.bundles)) if idx == -1 else [(idx, pg.bundles[idx])]
            for i, b in cands:
                if b.node_id == node_id and all(b.available.get(k, 0) >= v for k, v in res.items()):
                    for k, v in res.items():
                        b.available[k] = b.available.get(k, 0) - v
                    spec["_paid"] = {"kind": "bundle", "pg_id": pg.pg_id, "bundle": i,
                                     "node": node_id, "epoch": pg.epoch}
                    return
            raise RuntimeError("bundle vanished between fit-check and acquire")
        node = self.nodes[node_id]
        for k, v in res.items():
            node.available[k] = node.available.get(k, 0) - v
        spec["_paid"] = {"kind": "node", "node": node_id}

    def _release_for(self, spec: dict):
        res = self._spec_fp(spec)
        paid = spec.pop("_paid", None)
        if not res or paid is None:
            return
        if paid["kind"] == "bundle":
            pg = self.pgs.get(paid["pg_id"])
            if (pg is not None and pg.state == "created"
                    and paid.get("epoch") == pg.epoch):
                b = pg.bundles[paid["bundle"]]
                for k, v in res.items():
                    b.available[k] = b.available.get(k, 0) + v
                return
            # PG removed (or unplaced+re-placed under a new epoch) while the
            # task ran: the in-use share was withheld from the original node
            # at removal/unplacement; return it to that node now.
        node = self.nodes.get(paid["node"])
        if node is not None and node.alive:
            for k, v in res.items():
                node.available[k] = node.available.get(k, 0) + v

    # ------------------------------------------------------- direct leases
    # (reference: src/ray/raylet/scheduling/cluster_lease_manager.h:41 lease
    # grant/release; normal_task_submitter.h:81 caller-side lease use)

    def _lease_workers(self, conn: MsgConnection, msg: dict, caller: str | None):
        res = msg.get("resources") or {"CPU": 1.0}
        rh = msg.get("renv_hash", "")
        need = accelerators.gpus_required(res)
        prefer = msg.get("prefer_host")
        count = max(1, int(msg.get("count", 1)))
        grants: list[dict] = []
        with self.lock:
            # record the caller's local backlog for the autoscaler demand view
            bkey = (caller, tuple(sorted(res.items())), rh)
            backlog = int(msg.get("backlog", 0))
            if backlog > 0:
                self._direct_backlog[bkey] = (dict(res), backlog, time.monotonic())
            else:
                self._direct_backlog.pop(bkey, None)
            if not self.stopped and caller is not None:
                cands = [w for w in self.workers.values()
                         if w.kind == "worker" and not w.dead and w.idle
                         and w.actor_id is None and w.leased_to is None
                         and len(w.gpus) == need and w.renv_hash == rh
                         and w.direct_addr]
                if prefer:
                    cands.sort(key=lambda w: w.host_id != prefer)
                res_fp = fp.fp_dict(res)
                for w in cands:
                    if len(grants) >= count:
                        break
                    node = self.nodes.get(w.node_id)
                    if node is None or not node.alive or node.draining:
                        continue
                    if not pg_policy._fits(node.available, res_fp):
                        continue
                    lspec = {"resources": dict(res)}
                    self._acquire_for(lspec, w.node_id)
                    self._lease_seq += 1
                    w.idle = False
                    w.leased_to = caller
                    w.lease_spec = lspec
                    w.lease_token = self._lease_seq
                    self._leases_by_holder.setdefault(caller, set()).add(w.wid)
                    grants.append({"wid": w.wid, "addr": w.direct_addr,
                                   "host": w.host_id, "node": w.node_id,
                                   "token": self._lease_seq})
        unmet = count - len(grants)
        if unmet > 0:
            self._spawn_for_lease_demand(res, rh, need, unmet)
        if grants:
            self._observe_sched("lease", "granted", None, n=len(grants))
            self._emit_event(
                _const.EVENT_LEASE_GRANT,
                severity=_const.EVENT_SEVERITY_DEBUG,
                message=f"{len(grants)} worker lease(s) to {caller}",
                caller=caller or "", count=len(grants),
                nodes=sorted({g["node"] for g in grants}))
        try:
            conn.send({"rid": msg["rid"], "leases": grants})
        except ConnectionClosed:
            for g in grants:
                self._release_lease(g["wid"], g["token"])

    def _spawn_for_lease_demand(self, res: dict, rh: str, need: int, n: int):
        """Unmet lease demand scales the pool up, same as queued GCS tasks
        do — the caller's next lease attempt then finds idle workers."""
        spawn_plan: list[tuple[str, list]] = []
        now = time.monotonic()
        with self.lock:
            if rh and rh not in self.runtime_envs:
                # the env's body reaches the GCS with its first spec: a
                # worker spawned before that would boot without it (no
                # venv, no env vars), register under no env and, with a
                # GPU grant, be refused while its GPUs stay booked for the
                # spawn's whole budget. The caller's spec takes the GCS
                # path instead, which records the env and spawns for it.
                return
            n_workers = sum(1 for w in self.workers.values()
                            if w.kind == "worker" and not w.dead)
            spawning = sum(len(dq) for dq in self._spawn_pending.values())
            headroom = self.max_workers - n_workers - spawning
            n = min(n, headroom)
            if n <= 0:
                return
            node_id = pg_policy.pick_node_hybrid(
                list(self.nodes.values()), fp.fp_dict(res),
                self.local_node_id)
            if node_id is None:
                return
            node = self.nodes.get(node_id)
            assignments: list = []
            for _ in range(n):
                if need == 0:
                    assignments.append(None)
                    continue
                if (node is None or not node.alive or node.draining
                        or len(node.chip_pool) < need):
                    break
                chips = tuple(node.chip_pool[:need])
                del node.chip_pool[:need]
                assignments.append(chips)
            if not assignments:
                return
            self._spawn_pending[node_id].extend(
                (now, c, rh) for c in assignments)
            host = self.node_hosts.get(node_id, HEAD_HOST)
            agent_conn = self.hosts.get(host, {}).get("conn")
            renv = self.runtime_envs.get(rh) if rh else None
            spawn_plan.append((node_id, assignments, agent_conn, renv))
        for node_id, assignments, agent_conn, renv in spawn_plan:
            if agent_conn is not None:
                try:
                    agent_conn.send({"type": "spawn_workers",
                                     "node_id": node_id,
                                     "assignments": assignments,
                                     "runtime_env": renv})
                except ConnectionClosed:
                    pass
            else:
                self.spawn_worker_cb(len(assignments), node_id, assignments,
                                     renv)

    def _release_lease(self, target: str, token=None, make_idle: bool = True):
        with self.lock:
            w = self.workers.get(target)
            if w is None or w.leased_to is None:
                return
            if token is not None and token != w.lease_token:
                return  # stale release for an already-recycled lease
            holder = w.leased_to
            w.leased_to = None
            w.lease_token = None
            hs = self._leases_by_holder.get(holder)
            if hs is not None:
                hs.discard(target)
            spec, w.lease_spec = w.lease_spec, None
            if spec is not None:
                self._release_for(spec)
            if not w.dead and make_idle:
                w.idle = True
        self._emit_event(_const.EVENT_LEASE_RELEASE,
                         severity=_const.EVENT_SEVERITY_DEBUG,
                         message=f"lease on {target} released by {holder}",
                         worker=target, holder=holder)
        self._schedule()

    def _convert_cross_lang_done(self, msg: dict) -> None:
        """A JSON-codec (cross-language) worker reports plain JSON result
        values; Python consumers unpickle inline blobs, so re-encode each
        value (or the error) here. Mutates msg into the standard
        task_done shape."""
        import ray_tpu_torch._private.serialization as ser
        from ray_tpu_torch.exceptions import RayTpuError

        err = msg.get("error")
        results = []
        for res in msg.get("results") or ():
            oid, where, value = res[0], res[1], res[2]
            if err is not None:
                blob = ser.dumps(RayTpuError(
                    f"cross-language task failed: {err}"))
            else:
                blob = ser.dumps(value)
            results.append([oid, where, blob, len(blob)])
        msg["results"] = results

    def _fail_orphaned_stubs(self, oids) -> None:
        """Error pending stubs whose promised publisher is gone (caller
        holds no lock)."""
        import ray_tpu_torch._private.serialization as ser
        from ray_tpu_torch.exceptions import OwnerDiedError

        blob = ser.dumps(OwnerDiedError(
            "the process owning this object died before publishing it"))
        for oid in oids:
            self._on_object_ready(oid, where="inline", inline=blob,
                                  size=len(blob), is_error=True,
                                  only_if_pending=True)

    def _host_view_for(self, node_id: str) -> dict | None:
        """Latest resource-view delta of the host backing a node (caller
        holds the lock). Views older than 3 intervals are served with a
        stale flag rather than dropped — a wedged agent's LAST view is
        still diagnostic."""
        host = self.node_hosts.get(node_id, HEAD_HOST)
        view = (self.hosts.get(host) or {}).get("view")
        if not view:
            return None
        out = dict(view)
        age = time.monotonic() - out.pop("ts")
        out["age_s"] = round(age, 1)
        # instance() (not get()) — this runs per node under the GCS lock
        interval = RayConfig.instance().resource_view_interval_s
        out["stale"] = age > 3 * max(0.1, interval)
        return out

    def _pinned_fn_keys_locked(self) -> set:
        """fn: store keys that MUST survive eviction: referenced by a
        pending/running spec (the executor fetches the blob at dispatch) or
        by retained lineage (reconstruction resubmits the spec verbatim).
        Caller holds the lock.

        The scan is O(pending + running + lineage), so the result is cached
        for a few seconds: dynamic-closure floods hit the eviction path on
        EVERY overflowing put, and an uncached scan there would undo the
        sharded-queue submit scaling. Staleness is safe because every key
        referenced in the cache window is also recency-protected — uploads
        and existence probes stamp _fn_access, and eviction spares keys
        touched within the (much longer) 300s freshness window."""
        now = time.monotonic()
        cached = self._pinned_fn_cache
        if cached is not None and now - cached[0] < 5.0:
            return cached[1]
        pinned: set = set()

        def _note(spec):
            sha = spec.get("func_sha")
            if sha:
                pinned.add("fn:" + sha)

        for s in self.pending_tasks:
            _note(s)
        for w in self.workers.values():
            for s in w.running_tasks.values():
                _note(s)
        for a in self.actors.values():
            for s in a.queue:
                _note(s)
        for s in self.lineage.values():
            _note(s)
        self._pinned_fn_cache = (now, pinned)
        return pinned

    def _retain_lineage_locked(self, spec: dict) -> list[str]:
        """Retain a task spec for lineage reconstruction of its outputs,
        under the bounded budget (reference: lineage eviction). A
        reconstruction resubmit keeps its spent budget. Returns oids freed
        by eviction; caller holds the lock."""
        prev_lin = self.lineage.get(spec["task_id"])
        lin = {k: v for k, v in spec.items()
               if k not in ("_paid", "_holds", "_fp_res", "retries_used")}
        if prev_lin is not None:
            lin["recons_used"] = prev_lin.get("recons_used", 0)
        self.lineage[spec["task_id"]] = lin
        evicted: list[str] = []
        # deep-queue fast path: if the last walk found every candidate still
        # queued/running (a 1M-task queue keeps the oldest lineage pinned),
        # repeating the walk on each of the next million submits is O(K)
        # futile probes per submit. The verdict only changes when a task
        # completes, so stay stalled until _on_task_done clears the flag.
        if getattr(self, "_lineage_evict_stalled", False):
            return evicted
        if len(self.lineage) > MAX_LINEAGE:
            # evict oldest-first, but never a task that is still
            # queued/running — dropping one would free its pinned
            # args blob under it and hang the dispatch. Queued-ness is an
            # O(1) multiset probe; the candidate walk is BOUNDED so a deep
            # queue (every lineage entry still pending) costs O(K) per
            # submit, not O(lineage) — the budget is soft and the excess
            # drains as soon as tasks start completing
            running: set = set()
            for w_ in self.workers.values():
                running.update(w_.running_tasks.keys())
            candidates = list(itertools.islice(self.lineage, 64))
            for tid in candidates:
                if len(self.lineage) <= MAX_LINEAGE:
                    break
                if (tid == spec["task_id"] or tid in running
                        or self.pending_tasks.is_queued(tid)):
                    continue
                evicted.extend(self._drop_lineage_locked(tid))
            if not evicted and len(self.lineage) > MAX_LINEAGE:
                self._lineage_evict_stalled = True
        return evicted

    # ----------------------------------------------------------------- tasks

    def _invalid_strategy_reason(self, strat: dict | None) -> str | None:
        """Reject structurally-invalid strategies at submit time (caller holds lock)."""
        if not strat or strat.get("kind") != "pg":
            return None
        pg = self.pgs.get(strat.get("pg_id"))
        if pg is None:
            return f"no such placement group {strat.get('pg_id')!r}"
        if pg.state == "removed":
            return "placement group has been removed"
        idx = strat.get("bundle", -1)
        if idx != -1 and not (0 <= idx < len(pg.bundles)):
            return (f"placement_group_bundle_index {idx} out of range "
                    f"for {len(pg.bundles)} bundles")
        return None

    def _submit_task(self, spec: dict):
        with self.lock:
            if spec.get("renv_hash"):
                self.runtime_envs[spec["renv_hash"]] = spec.get("runtime_env") or {}
            if spec["num_returns"] == "streaming":
                self.streams[spec["task_id"]] = {
                    "items": [], "done": False, "error": None,
                    "consumed": 0, "producer": None, "waiters": []}
            else:
                for i in range(spec["num_returns"]):
                    oid = f"{spec['task_id']}r{i:04d}"
                    e = self.objects.setdefault(oid, {"status": "pending", "where": None, "inline": None, "size": 0})
                    # the GCS path now owns producing this value; a stale
                    # will_publish promise (direct spec redirected here)
                    # must not let the old owner's death error the stub
                    pw = e.pop("pub_wid", None)
                    if pw is not None:
                        s = self._pub_promises.get(pw)
                        if s is not None:
                            s.discard(oid)
                            if not s:
                                self._pub_promises.pop(pw, None)
            reason = self._invalid_strategy_reason(spec.get("strategy"))
            if reason is None:
                # hold every object this task needs (args + refs nested in
                # args) until it completes, so a caller dropping its handles
                # mid-flight can't free them under the task
                holds = list(spec.get("deps", ())) + list(spec.get("ref_holds", ()))
                spec["_holds"] = holds
                self._sys_hold_locked(holds, +1)
                evicted: list[str] = []
                if spec["kind"] == "task" and isinstance(spec["num_returns"], int):
                    evicted = self._retain_lineage_locked(spec)
                spec["_enq_ts"] = time.monotonic()
                self.pending_tasks.append(spec)
            self.task_counter["submitted"] += 1
        if reason is not None:
            self._fail_task_objects(spec, reason)
            return
        if evicted:
            self._free_objects(evicted)
        self._schedule()

    def _deps_ready(self, spec: dict) -> bool:
        for dep in spec.get("deps", ()):
            e = self.objects.get(dep)
            if e is None or e["status"] == "pending":
                return False
        return True

    def _schedule(self):
        """Dispatch whatever can run; request worker scale-up for the rest."""
        to_send: list[tuple[MsgConnection, dict]] = []
        want_spawn: collections.Counter = collections.Counter()  # (node, n_chips) → demand
        revokes: list[tuple[MsgConnection, str]] = []
        with self.lock:
            if self.stopped:
                return
            self._try_place_pgs_locked()
            idle_by_node: dict[str, list[_Worker]] = collections.defaultdict(list)
            n_alive = 0
            for w in self.workers.values():
                if w.kind == "worker" and not w.dead:
                    n_alive += 1
                    if w.idle and w.actor_id is None:
                        idle_by_node[w.node_id].append(w)
            # purge timed-out spawn requests FIRST: a silently failed spawn
            # must free its headroom before the feasibility decision below,
            # or it suppresses both scanning and respawn until an unrelated
            # event
            now = time.monotonic()
            for node_id_, dq in self._spawn_pending.items():
                while dq:
                    ts_, chips_, rh_ = dq[0]
                    # pip runtime envs build a venv inside the worker boot:
                    # give them the long budget too
                    pip_env = bool(rh_ and (self.runtime_envs.get(rh_)
                                            or {}).get("pip"))
                    limit_ = (PIP_SPAWN_TIMEOUT_S if pip_env
                              else CHIP_SPAWN_TIMEOUT_S if chips_
                              else SPAWN_TIMEOUT_S)
                    if now - ts_ <= limit_:
                        break
                    dq.popleft()  # spawn presumed failed; allow retry
                    if chips_:
                        node_ = self.nodes.get(node_id_)
                        if node_ is not None and node_.alive:
                            node_.chip_pool.extend(chips_)
            # scalability early-exit (reference envelope: 1M queued tasks on
            # a node — BASELINE.md): when nothing can possibly dispatch (no
            # idle worker) and nothing can spawn (no headroom), scanning the
            # whole pending queue per event would make submission O(queue²).
            # Actor METHOD dispatch doesn't need idle workers, so that loop
            # still runs below.
            spawning_now = sum(len(dq) for dq in self._spawn_pending.values())
            can_place = (any(idle_by_node.values())
                         or self.max_workers - n_alive - spawning_now > 0)

            dispatched_any = False
            # why the most recent dispatch() returned False: "deps" (spec-
            # specific — a later spec in the same shard may still run) vs
            # "capacity" (no fitting node / no matching idle worker — for a
            # uniform shard this verdict covers every other spec too)
            fail_reason = ""

            def dispatch(spec) -> bool:
                nonlocal dispatched_any, fail_reason
                fail_reason = "capacity"
                lang = spec.get("lang", "py")
                need = accelerators.gpus_required(spec.get("resources", {}))
                rh = spec.get("renv_hash", "")
                if lang != "py":
                    # cross-language workers self-join on whatever node
                    # their operator chose: place the task WHERE such a
                    # worker is, not where resources look emptiest (the
                    # GCS cannot spawn one, so demand registration is
                    # pointless). Prefer a worker that registered the
                    # function by name.
                    if not self._deps_ready(spec):
                        fail_reason = "deps"
                        return False
                    fname = spec.get("func_name")
                    cands = [x for pool in idle_by_node.values()
                             for x in pool
                             if x.language == lang
                             and len(x.gpus) == need
                             and x.renv_hash == rh
                             and pg_policy._fits(
                                 self.nodes[x.node_id].available,
                                 self._spec_fp(spec))]
                    if not cands:
                        return False
                    w = next((x for x in cands
                              if not x.functions or fname in x.functions),
                             cands[0])
                    node_id = w.node_id
                    pool = idle_by_node.get(node_id, [])
                else:
                    node_id = self._fits_for(spec)
                    if node_id is None:
                        return False
                    if not self._deps_ready(spec):
                        fail_reason = "deps"
                        return False
                    # whole-GPU specs need a worker spawned with exactly
                    # that many GPUs visible; CPU specs need a GPU-less
                    # worker (a GPU worker must stay free for GPU demand)
                    pool = idle_by_node.get(node_id, [])
                    w = next((x for x in pool if len(x.gpus) == need
                              and x.renv_hash == rh and x.language == lang),
                             None)
                if w is None:
                    fail_reason = "capacity_demand"  # spawn demand registered
                    want_spawn[(node_id, need, rh)] += 1
                    return False
                pool.remove(w)
                self._acquire_for(spec, node_id)
                w.idle = False
                spec["_ts"] = time.monotonic()
                w.running_tasks[spec["task_id"]] = spec
                wait = spec["_ts"] - spec.get("_enq_ts", spec["_ts"])
                if spec["kind"] == "actor_create":
                    w.actor_id = spec["actor_id"]
                    actor = self.actors[spec["actor_id"]]
                    actor.worker = w.wid
                    self._observe_sched("actor", "dispatched", wait)
                    self._trace_decision(spec["actor_id"], "dispatched",
                                         node=node_id, worker=w.wid,
                                         queue_wait_s=round(wait, 6))
                else:
                    self._observe_sched("task", "dispatched", wait)
                to_send.append((w.conn, {"type": "exec", "spec": spec}))
                self.pending_tasks.note_consumed(spec["task_id"])
                dispatched_any = True
                return True

            if can_place:
                # bounded scan: mostly-FIFO dispatch that gives up after a
                # run of consecutive non-dispatchable specs — per-event work
                # stays O(idle + K) instead of O(queue), which is what keeps
                # deep queues (reference envelope: 1M pending) from turning
                # every completion into a full rescan. K>1 so heterogeneous
                # resource shapes behind a stuck head still make progress.
                K = 64

                # liveness vs bound: while idle workers remain, scan deeper
                # (up to K_IDLE) so dispatchable specs behind stuck heads are
                # reached; if we STILL stop early with idle workers left, the
                # scanned misses rotate to the tail so successive events make
                # eventual progress through the whole queue instead of
                # re-hitting the same head forever. O(1) idle tracking: a
                # counter decremented where dispatch consumes a worker.
                K_IDLE = 1024
                idle_left = sum(len(v) for v in idle_by_node.values())

                def keep_scanning(misses: int) -> bool:
                    if misses < K:
                        return True
                    return idle_left > 0 and misses < K_IDLE

                def scan(queue: collections.deque, skip=None,
                         uniform: bool = False) -> str:
                    """Dispatch from `queue`; returns the fail_reason it
                    stopped on for a UNIFORM queue's capacity miss (every
                    remaining spec shares the failing spec's resource shape,
                    so one miss is a verdict for the whole shard — the
                    caller then registers bulk spawn demand instead of
                    probing spec by spec), else ""."""
                    nonlocal idle_left
                    still = collections.deque()
                    misses = 0
                    cap_stop = ""
                    while queue and keep_scanning(misses):
                        spec = queue.popleft()
                        if skip is not None and skip(spec):
                            continue
                        if dispatch(spec):
                            idle_left -= 1  # creations/tasks consume a worker
                            misses = 0
                        else:
                            still.append(spec)
                            misses += 1
                            if uniform and fail_reason.startswith("capacity"):
                                cap_stop = fail_reason
                                break
                    if still and queue and idle_left > 0 and not cap_stop:
                        queue.extend(still)  # rotate: different specs next event
                    else:
                        queue.extendleft(reversed(still))
                    return cap_stop

                # actor creations first (they pin workers)
                def _dead_actor(spec):
                    actor = self.actors.get(spec["actor_id"])
                    return actor is None or actor.state == "dead"

                scan(self.pending_actor_creations, skip=_dead_actor)
                # strategy specs: placement varies per spec, scan them all
                scan(self.pending_tasks.misc)
                # uniform shards: one feasibility probe covers the shard
                for key, dq in list(self.pending_tasks.shards.items()):
                    if not dq:
                        del self.pending_tasks.shards[key]
                        continue
                    res = dq[0].get("resources") or {}
                    rh, lang = key[1], key[2]
                    need = accelerators.gpus_required(res)
                    probe_registered = 0
                    if any(len(x.gpus) == need and x.renv_hash == rh
                           and x.language == lang
                           for pool in idle_by_node.values() for x in pool):
                        stop = scan(dq, uniform=True)
                        if not stop:
                            continue
                        # capacity-stopped mid-scan: the idle workers are
                        # consumed/mismatched, so fall through to bulk
                        # demand registration exactly as if none had matched.
                        # The probing dispatch may itself have registered +1
                        # for the spec now back at the queue head — don't
                        # count it twice below.
                        probe_registered = 1 if stop == "capacity_demand" else 0
                    if lang != "py":
                        continue  # cross-language workers self-join: no spawn
                    # no matching idle worker anywhere: nothing in this
                    # shard can dispatch this pass. Register spawn demand
                    # for the RUNNABLE prefix only (a dep-blocked shard must
                    # not trigger spawns/reclaims/revocations for tasks that
                    # couldn't run anyway) — bounded probe, O(K) per shard
                    node_id = pg_policy.pick_node_hybrid(
                        list(self.nodes.values()), fp.fp_dict(res),
                        self.local_node_id)
                    if node_id is not None:
                        runnable = sum(1 for s in itertools.islice(dq, 64)
                                       if self._deps_ready(s))
                        runnable -= probe_registered
                        if runnable > 0:
                            want_spawn[(node_id, need, rh)] += runnable

            # warm-pool floor: replenish idle no-env CPU workers consumed
            # by dispatch/leases so the next cold task is a dispatch, not a
            # process fork + imports (reference: worker_pool.h:280
            # prestarted pool). Deficits are NOT merged into want_spawn:
            # real demand may retire mismatched workers and revoke leases
            # to make room, but background replenishment must only ever use
            # LEFTOVER headroom (see the post-scale-up block below).
            warm_needs: dict[str, int] = {}
            if self.warm_pool_size > 0:
                for node_id_w, node_w in self.nodes.items():
                    if not node_w.alive:
                        continue
                    idle_plain = sum(
                        1 for x in idle_by_node.get(node_id_w, ())
                        if not x.gpus and x.renv_hash == ""
                        and x.language == "py")
                    if self.warm_pool_size > idle_plain:
                        warm_needs[node_id_w] = self.warm_pool_size - idle_plain

            # pending work that couldn't dispatch while leases hold the
            # resources it needs: revoke exactly those leases (reference:
            # leases are returned under cluster pressure / spillback)
            if ((self.pending_tasks or self.pending_actor_creations)
                    and not dispatched_any):
                for lw in self.workers.values():
                    if (lw.kind == "worker" and not lw.dead
                            and lw.leased_to is not None
                            and self._lease_would_help_locked(lw)):
                        holder = self.workers.get(lw.leased_to)
                        if holder is not None and not holder.dead:
                            revokes.append((holder.conn, lw.wid))

            # actor method calls (up to max_concurrency in flight per actor;
            # group-declared methods dispatch through their own lane so a
            # control call — e.g. a serve health probe — is never stuck
            # behind a saturated default queue)
            for actor in self.actors.values():
                if actor.state != "alive" or not actor.queue:
                    continue
                w = self.workers.get(actor.worker)
                if w is None or w.dead:
                    continue
                if actor.group_queued > 0:
                    self._dispatch_actor_grouped_locked(actor, w, to_send)
                    continue
                # fast path: nothing bound for a group lane is queued, so
                # heads are all default-pool specs — FIFO up to the default
                # cap (total minus reserved group slots)
                base_cap = actor.max_concurrency - sum(actor.groups.values())
                while (actor.queue
                       and actor.in_flight
                       - sum(actor.group_in_flight.values()) < base_cap):
                    spec = actor.queue.popleft()
                    actor.in_flight += 1
                    w.running_tasks[spec["task_id"]] = spec
                    to_send.append((w.conn, {"type": "exec", "spec": spec}))

            # scale-up: runnable-if-only-there-were-workers, per (node, chips)
            # (stale spawn requests were purged at the top of this pass)
            now = time.monotonic()
            n_workers = sum(1 for w in self.workers.values() if w.kind == "worker" and not w.dead)
            spawning_total = sum(len(dq) for dq in self._spawn_pending.values())
            spawn_plan: list[tuple[str, list]] = []  # node_id, [chips|None per worker]
            reclaim: list[_Worker] = []
            headroom = self.max_workers - n_workers - spawning_total
            for (node_id, need, rh), demand in want_spawn.items():
                spawning_here = sum(
                    1 for _, c, prh in self._spawn_pending[node_id]
                    if len(c or ()) == need and prh == rh)
                want = demand - spawning_here
                if want <= 0:
                    continue
                node = self.nodes.get(node_id)
                # free headroom and/or chips by retiring idle workers whose
                # binding can't serve this demand (a process can't change
                # its visible chips after jax backend init)
                short_headroom = want - headroom
                short_chips = (need > 0 and node is not None
                               and len(node.chip_pool) < need * want)
                if short_headroom > 0 or short_chips:
                    got = self._reclaim_mismatched_idle_locked(
                        node_id, need, max(short_headroom, want), rh,
                        gpus_wanted=need * want)
                    headroom += len(got)
                    reclaim.extend(got)
                n = max(0, min(want, headroom))
                if n < want:
                    # demand this pass can't spawn for: ask lease holders to
                    # hand matching leased workers back (reference: leases are
                    # revoked/spilled back under cluster pressure)
                    needed = want - n
                    for lw in self.workers.values():
                        if needed <= 0:
                            break
                        if (lw.kind == "worker" and not lw.dead
                                and lw.leased_to is not None
                                and len(lw.gpus) == need
                                and lw.renv_hash == rh):
                            holder = self.workers.get(lw.leased_to)
                            if holder is not None and not holder.dead:
                                revokes.append((holder.conn, lw.wid))
                                needed -= 1
                if n <= 0:
                    continue
                assignments: list = []
                for _ in range(n):
                    if need == 0:
                        assignments.append(None)
                        continue
                    if node is None or not node.alive or len(node.chip_pool) < need:
                        break
                    chips = tuple(node.chip_pool[:need])
                    del node.chip_pool[:need]
                    assignments.append(chips)
                if assignments:
                    headroom -= len(assignments)
                    self._spawn_pending[node_id].extend(
                        (now, c, rh) for c in assignments)
                    spawn_plan.append((node_id, assignments, rh))
            # warm-pool replenishment: strictly leftover headroom, shared
            # across nodes, never reclaims or revokes anything
            for node_id_w, deficit in warm_needs.items():
                if headroom <= 0:
                    break
                spawning_plain = sum(
                    1 for _, c_, rh_ in self._spawn_pending[node_id_w]
                    if not c_ and rh_ == "")
                n = min(deficit - spawning_plain, headroom)
                if n <= 0:
                    continue
                headroom -= n
                self._spawn_pending[node_id_w].extend(
                    (now, None, "") for _ in range(n))
                spawn_plan.append((node_id_w, [None] * n, ""))
            agent_sends = []
            for node_id, assignments, rh in spawn_plan:
                host = self.node_hosts.get(node_id, HEAD_HOST)
                agent_conn = self.hosts.get(host, {}).get("conn")
                if agent_conn is not None:
                    agent_sends.append(
                        (agent_conn, node_id, assignments,
                         self.runtime_envs.get(rh) if rh else None))
            spawn_plan = [(nid, a, rh) for nid, a, rh in spawn_plan
                          if self.hosts.get(self.node_hosts.get(nid, HEAD_HOST), {}).get("conn") is None]

        for conn, msg in to_send:
            try:
                conn.send(msg)
            except ConnectionClosed:
                pass
        for w in reclaim:
            try:
                w.conn.send({"type": "exit"})
            except ConnectionClosed:
                pass
        for hconn, lw in revokes:
            try:
                hconn.send({"type": "lease_revoke", "wid": lw})
            except ConnectionClosed:
                pass
        for agent_conn, node_id, assignments, renv in agent_sends:
            try:
                agent_conn.send({"type": "spawn_workers", "node_id": node_id,
                                 "assignments": assignments,
                                 "runtime_env": renv})
            except ConnectionClosed:
                pass
        for node_id, assignments, rh in spawn_plan:
            self.spawn_worker_cb(len(assignments), node_id, assignments,
                                 self.runtime_envs.get(rh) if rh else None)

    def _dispatch_actor_grouped_locked(self, actor: _Actor, w: _Worker,
                                       to_send: list) -> None:
        """Dispatch an actor's queue with per-lane caps: group-declared
        methods fill their group's slots regardless of position (a probe
        queued behind 50 data requests still dispatches), default specs
        fill the default pool FIFO. Called only when at least one queued
        spec is bound for a group lane (group_queued > 0)."""
        base_cap = actor.max_concurrency - sum(actor.groups.values())
        default_in_flight = actor.in_flight - sum(
            actor.group_in_flight.values())
        group_left = actor.group_queued  # group-bound specs not yet visited
        remaining: collections.deque[dict] = collections.deque()
        while actor.queue:
            if default_in_flight >= base_cap and (
                    group_left <= 0
                    or all(actor.group_in_flight.get(g, 0) >= lim
                           for g, lim in actor.groups.items())):
                # nothing further can dispatch: the default lane is full and
                # either every group-bound spec has been visited or every
                # group lane is full — don't churn the (possibly deep)
                # default backlog
                remaining.extend(actor.queue)
                actor.queue.clear()
                break
            spec = actor.queue.popleft()
            g = actor.method_groups.get(spec.get("method") or "")
            if g is not None:
                group_left -= 1
                if actor.group_in_flight.get(g, 0) >= actor.groups[g]:
                    remaining.append(spec)
                    continue
                actor.group_in_flight[g] = actor.group_in_flight.get(g, 0) + 1
                actor.group_queued -= 1
                spec["_cgroup"] = g  # for the done/death decrement
            else:
                if default_in_flight >= base_cap:
                    remaining.append(spec)
                    continue
                default_in_flight += 1
            actor.in_flight += 1
            w.running_tasks[spec["task_id"]] = spec
            to_send.append((w.conn, {"type": "exec", "spec": spec}))
        actor.queue = remaining

    def _lease_would_help_locked(self, lw: _Worker) -> bool:
        """Would returning this worker's lease make any head-of-queue
        pending spec resource-feasible on its node? Only specs that are
        dep-ready AND actually resource-blocked count — revoking for work
        that is waiting on something else would just churn the lease pool."""
        node = self.nodes.get(lw.node_id)
        if node is None or not node.alive:
            return False
        avail0 = node.available
        avail = dict(avail0)
        for k, v in fp.fp_dict(
                (lw.lease_spec or {}).get("resources", {})).items():
            avail[k] = avail.get(k, 0) + v
        for spec in itertools.islice(
                itertools.chain(self.pending_actor_creations,
                                self.pending_tasks), 32):
            res = self._spec_fp(spec)
            if not self._deps_ready(spec):
                continue
            if all(avail0.get(k, 0) >= v for k, v in res.items()):
                continue  # resources already free: blocked on workers, not us
            if all(avail.get(k, 0) >= v for k, v in res.items()):
                return True
        return False

    def _reclaim_mismatched_idle_locked(self, node_id: str, need: int,
                                        max_count: int,
                                        renv_hash: str = "",
                                        gpus_wanted: int = 0) -> list[_Worker]:
        """Retire idle workers on a node whose chip binding differs from the
        wanted one (chip workers blocking CPU demand, or CPU/odd-size chip
        workers blocking chip demand). Runs after all dispatch for this
        round, so anything still idle here failed to match current demand.
        Caller sends the exit messages.

        Retires up to `max_count` workers, and past that count keeps
        retiring GPU-holding ones while the node's free GPUs are fewer than
        `gpus_wanted`: a 4-GPU demand facing four idle 1-GPU workers needs
        all four back in one pass, since a retired worker's exit (already
        marked dead here) triggers no later pass. (The JAX package stops at
        `max_count`, and such a demand waits forever.)"""
        out: list[_Worker] = []
        node = self.nodes.get(node_id)
        for w in self.workers.values():
            if len(out) >= max_count:
                if node is None or len(node.chip_pool) >= gpus_wanted:
                    break
                if not w.gpus:
                    continue  # past the count only a GPU holder helps
            if (w.kind == "worker" and not w.dead and w.idle
                    and w.actor_id is None and w.node_id == node_id
                    and w.language == "py"  # self-joined cpp workers are
                    # not respawnable: never retire them for headroom
                    and (len(w.gpus) != need
                         or w.renv_hash != renv_hash)):
                w.dead = True
                if w.gpus and node is not None and node.alive:
                    node.chip_pool.extend(w.gpus)
                out.append(w)
        return out

    def _on_task_done(self, msg: dict):
        wid = msg["wid"]
        creation_failed: list[dict] = []  # calls queued on a failed creation
        with self.lock:
            # a completion can unpin the oldest lineage entries — re-arm the
            # bounded eviction walk (see _retain_lineage_locked)
            self._lineage_evict_stalled = False
            w = self.workers.get(wid)
            spec = msg["spec"]
            # prefer the GCS-side spec: it carries the _paid accounting tag the
            # worker's lite echo doesn't (the worker never sees reservations)
            if w is not None:
                # the top-level task_id is authoritative (direct dispatch
                # keys on it too); the lite spec echo is the fallback for
                # cross-language peers that omit it
                gcs_spec = w.running_tasks.pop(
                    msg.get("task_id") or spec.get("task_id"), None)
                if gcs_spec is not None:
                    spec = gcs_spec
            kind = spec["kind"]
            error = msg.get("error")
            if kind == "actor_create":
                actor = self.actors.get(spec["actor_id"])
                rtt = time.monotonic() - spec.get("_ts", time.monotonic())
                if error is None:
                    if actor is not None:
                        actor.state = "alive"
                        self._observe_sched("actor", "created", rtt)
                        self._trace_decision(actor.aid, "created",
                                             lease_rtt_s=round(rtt, 6))
                        self._emit_event(
                            _const.EVENT_ACTOR_ALIVE,
                            node=w.node_id if w is not None else "",
                            message=f"actor {actor.name or actor.aid} alive "
                                    f"on worker {wid}",
                            actor_id=actor.aid, name=actor.name, worker=wid,
                            num_restarts=actor.num_restarts)
                        self.publish("actor_state",
                                     {"actor_id": actor.aid, "state": "alive"})
                        waiters, actor.waiters = actor.waiters, []
                        for conn, rid in waiters:
                            try:
                                conn.send({"rid": rid, "ok": True})
                            except ConnectionClosed:
                                pass
                        if actor.kill_requested and w is not None and not w.dead:
                            try:
                                w.conn.send({"type": "kill_actor", "aid": actor.aid})
                            except ConnectionClosed:
                                pass
                else:
                    # creation failed → actor dead, release worker; its
                    # queued calls fail with the constructor's error
                    if actor is not None:
                        actor.state = "dead"
                        actor.death_cause = (
                            f"actor {actor.name or actor.aid} died: its "
                            f"creation task raised {error}")
                        creation_failed.extend(actor.queue)
                        actor.queue.clear()
                        actor.group_queued = 0
                        self._observe_sched("actor", "failed", rtt)
                        self._trace_decision(actor.aid, "failed", error=error)
                        self._emit_event(
                            _const.EVENT_ACTOR_DEAD,
                            severity=_const.EVENT_SEVERITY_ERROR,
                            node=w.node_id if w is not None else "",
                            message=f"actor {actor.name or actor.aid} "
                                    f"creation failed: {error}",
                            actor_id=actor.aid, name=actor.name,
                            death_reason=f"creation failed: {error}")
                        self._unpersist_actor(actor.aid)
                        self.publish("actor_state",
                                     {"actor_id": actor.aid, "state": "dead"})
                        for conn, rid in actor.waiters:
                            try:
                                conn.send({"rid": rid, "ok": False,
                                           "error": actor.death_cause})
                            except ConnectionClosed:
                                pass
                        actor.waiters = []
                    if w is not None:
                        w.actor_id = None
                        w.idle = True
                    self._release_for(spec)
            else:
                if kind == "actor_task":
                    actor = self.actors.get(spec["actor_id"])
                    if actor is not None:
                        actor.in_flight = max(0, actor.in_flight - 1)
                        g = spec.get("_cgroup")
                        if g:
                            actor.group_in_flight[g] = max(
                                0, actor.group_in_flight.get(g, 0) - 1)
                else:
                    if w is not None:
                        w.idle = True
                    self._release_for(spec)
            self.task_counter["finished" if error is None else "failed"] += 1
            self.task_events.append({
                "task_id": spec.get("task_id"), "kind": kind, "name": spec.get("name"),
                "worker": wid, "error": error, "ts": time.time(),
            })
            if error is not None:
                # error channel (reference: GCS pubsub error_info channel
                # surfaced by drivers' error pollers)
                self.publish("errors", {
                    "task_id": spec.get("task_id"), "kind": kind,
                    "name": spec.get("name"), "worker": wid,
                    "error": error, "ts": time.time()})

            # the task is over: release its holds on args/nested refs
            free_now = self._sys_hold_locked(spec.pop("_holds", ()), -1)
            if kind == "actor_task":
                free_now.extend(self._unpin_args_locked(spec))
            if kind == "actor_create" and error is not None:
                # creation failed permanently: creation-arg holds + args blob
                free_now.extend(self._actor_dead_cleanup_locked(spec))

            # record results, with the producing host as the shm location so
            # cross-host consumers know where to pull from
            host = w.host_id if w is not None else HEAD_HOST
            contained_map = msg.get("contained") or {}
            dev_map = msg.get("device_tensors") or {}
            if not isinstance(dev_map, dict):
                # legacy flat-list wire form: attribute to every result
                dev_map = ({f"{spec['task_id']}r{i:04d}": list(dev_map)
                            for i in range(spec["num_returns"])}
                           if isinstance(spec["num_returns"], int) else {})
            any_shm = False
            for res in msg.get("results", ()):
                oid, where, inline, size = res[:4]
                # 5th element: actual tier ("spill" = landed on disk because
                # tmpfs was full — a readable host copy, but not tmpfs bytes)
                tier = res[4] if len(res) > 4 else "shm"
                prev = self.objects.get(oid)
                if prev is not None:
                    self._drop_shm_copies_locked(prev)
                entry = self.objects[oid] = {
                    **(prev or {}),
                    "status": "error" if error is not None else "ready",
                    "where": where, "inline": inline, "size": size,
                    "hosts": {host} if where == "shm" else set(),
                }
                if where == "shm":
                    entry["shm_live"] = set()
                    if tier == "shm":
                        self._note_shm_copy_locked(entry, host)
                        any_shm = True
                refs = contained_map.get(oid)
                if refs and "contained" not in (prev or {}):
                    entry["contained"] = list(refs)
                    self._sys_hold_locked(refs, +1)
                if dev_map.get(oid):
                    # RDT: THIS result carries markers into wid's HBM
                    # registry; freeing this object frees exactly those
                    # entries — other results' tensors stay live
                    entry["device_tensors"] = (wid, list(dev_map[oid]))
                for conn, rid in self.object_waiters.pop(oid, []):
                    self._reply_object(conn, rid, entry)
                if self._freeable_locked(oid, entry):
                    free_now.append(oid)
        if free_now:
            self._free_objects(free_now)
        for queued in creation_failed:
            self._fail_task_objects(queued, self._death_reason(queued))
        if any_shm:
            self._maybe_spill(host)
        self._schedule()

    def _death_reason(self, spec: dict) -> str:
        """Why a call on a dead actor fails: the creation task's error when
        the constructor raised, else that the actor is dead."""
        actor = self.actors.get(spec.get("actor_id"))
        return (actor.death_cause if actor is not None and actor.death_cause
                else "actor is dead")

    # ---------------------------------------------------------------- actors

    def _create_actor(self, spec: dict, _persist: bool = True) -> str | None:
        with self.lock:
            reason = self._invalid_strategy_reason(spec.get("strategy"))
            if reason is not None:
                return reason
            if spec.get("renv_hash"):
                self.runtime_envs[spec["renv_hash"]] = spec.get("runtime_env") or {}
            aid = spec["actor_id"]
            actor = _Actor(aid, spec)
            if actor.name:
                ns = spec.get("namespace") or "default"
                key = (ns, actor.name)
                existing = self.named_actors.get(key)
                if existing is not None and self.actors[existing].state != "dead":
                    return (f"an actor named {actor.name!r} already exists "
                            f"in namespace {ns!r}")
                self.named_actors[key] = aid
            self.actors[aid] = actor
            # creation args stay holdable for the actor's whole life (it may
            # be restarted from the same spec)
            holds = list(spec.get("deps", ())) + list(spec.get("ref_holds", ()))
            spec["_actor_holds"] = holds
            self._sys_hold_locked(holds, +1)
            spec["_enq_ts"] = time.monotonic()
            self.pending_actor_creations.append(spec)
            self._trace_enqueue(aid, "actor")
        self._emit_event(
            _const.EVENT_ACTOR_PENDING,
            message=f"actor {actor.name or aid} "
                    f"({spec.get('class_name')}) queued for placement",
            actor_id=aid, name=actor.name, actor_class=spec.get("class_name"))
        if _persist and self.storage is not None:
            clean = {k: v for k, v in spec.items()
                     if k not in ("_actor_holds", "_paid", "_fp_res",
                                  "_enq_ts")}
            self.storage.put("actors", aid, clean)
        self._schedule()
        return None

    def _submit_actor_task(self, spec: dict) -> tuple[bool, str | None]:
        with self.lock:
            actor = self.actors.get(spec["actor_id"])
            if actor is None or actor.state == "dead":
                return False, self._death_reason(spec)
            if spec["num_returns"] == "streaming":
                self.streams[spec["task_id"]] = {
                    "items": [], "done": False, "error": None,
                    "consumed": 0, "producer": None, "waiters": []}
            else:
                for i in range(spec["num_returns"]):
                    oid = f"{spec['task_id']}r{i:04d}"
                    e = self.objects.setdefault(oid, {"status": "pending", "where": None, "inline": None, "size": 0})
                    # the GCS path now owns producing this value; a stale
                    # will_publish promise (direct spec redirected here)
                    # must not let the old owner's death error the stub
                    pw = e.pop("pub_wid", None)
                    if pw is not None:
                        s = self._pub_promises.get(pw)
                        if s is not None:
                            s.discard(oid)
                            if not s:
                                self._pub_promises.pop(pw, None)
            holds = list(spec.get("deps", ())) + list(spec.get("ref_holds", ()))
            spec["_holds"] = holds
            self._sys_hold_locked(holds, +1)
            actor.queue.append(spec)
            if actor.method_groups.get(spec.get("method") or "") is not None:
                actor.group_queued += 1
        self._schedule()
        return True, None

    def _wait_actor_ready(self, conn: MsgConnection, msg: dict):
        with self.lock:
            actor = self.actors.get(msg["aid"])
            if actor is None:
                pass
            elif actor.state == "alive":
                conn.send({"rid": msg["rid"], "ok": True})
                return
            elif actor.state in ("pending", "restarting"):
                actor.waiters.append((conn, msg["rid"]))
                return
            cause = actor.death_cause if actor is not None else None
        try:
            conn.send({"rid": msg["rid"], "ok": False,
                       "error": cause or "ActorDiedError"})
        except ConnectionClosed:
            pass

    def _unpersist_actor(self, aid: str) -> None:
        # a stopped GCS keeps its persisted actors: their workers' sockets
        # close because the GCS went down, and the table is already closed
        # (the JAX package's delete raises there, on a connection thread)
        if self.storage is not None and not self.stopped:
            self.storage.delete("actors", aid)

    def _kill_actor(self, aid: str, no_restart: bool):
        fail: list[dict] = []
        # a kill with no_restart must stick across GCS restarts too
        if no_restart:
            self._unpersist_actor(aid)
        with self.lock:
            actor = self.actors.get(aid)
            if actor is None:
                return
            if no_restart:
                actor.restarts_left = 0
            actor.kill_requested = True
            w = self.workers.get(actor.worker) if actor.worker else None
            free_now: list[str] = []
            if w is None and actor.state in ("pending", "restarting"):
                # creation not yet dispatched: cancel it outright
                actor.state = "dead"
                self._unpersist_actor(actor.aid)
                self.publish("actor_state",
                             {"actor_id": actor.aid, "state": "dead"})
                self.pending_actor_creations = collections.deque(
                    s for s in self.pending_actor_creations if s["actor_id"] != aid
                )
                while actor.queue:
                    fail.append(actor.queue.popleft())
                actor.group_queued = 0
                for conn, rid in actor.waiters:
                    try:
                        conn.send({"rid": rid, "ok": False, "error": "ActorDiedError"})
                    except ConnectionClosed:
                        pass
                actor.waiters = []
                free_now = self._actor_dead_cleanup_locked(actor.create_spec)
                self.sched_traces.pop(aid, None)
                self._emit_event(
                    _const.EVENT_ACTOR_DEAD,
                    message=f"actor {actor.name or aid} killed before "
                            "creation dispatched",
                    actor_id=aid, name=actor.name,
                    death_reason="killed before creation")
        if free_now:
            self._free_objects(free_now)
        for spec in fail:
            self._fail_task_objects(spec, "actor killed before creation")
        if w is not None and not w.dead:
            try:
                w.conn.send({"type": "kill_actor", "aid": aid})
            except ConnectionClosed:
                pass
        # death will be observed via the worker connection closing

    # -------------------------------------------------------- placement groups

    def _create_pg(self, spec: dict, _persist: bool = True) -> str | None:
        with self.lock:
            if spec.get("strategy", "PACK") not in pg_policy.STRATEGIES:
                return (f"unknown placement strategy {spec.get('strategy')!r}; "
                        f"expected one of {pg_policy.STRATEGIES}")
            pg = _PG(spec["pg_id"], spec["bundles"], spec.get("strategy", "PACK"),
                     spec.get("name") or "")
            # feasibility against cluster totals (infeasible forever → error now;
            # reference raises on infeasible PGs too)
            class _TotNode:
                pass
            tot_nodes = []
            for n in self.nodes.values():
                if n.alive:
                    t = _TotNode()
                    t.node_id, t.total, t.available, t.labels, t.alive = (
                        n.node_id, n.total, dict(n.total), n.labels, True)
                    tot_nodes.append(t)
            if (_persist  # restore path: nodes re-register after start
                    and not self._autoscaler_conns  # growth may make it fit
                    and pg_policy.place_bundles(
                        tot_nodes, [b.total for b in pg.bundles], pg.strategy) is None):
                return ("placement group is infeasible: no node set satisfies "
                        f"{pg.strategy} over {spec['bundles']}")
            if pg.name:
                if pg.name in self.named_pgs and self.pgs[self.named_pgs[pg.name]].state != "removed":
                    return f"a placement group named {pg.name!r} already exists"
                self.named_pgs[pg.name] = pg.pg_id
            self.pgs[pg.pg_id] = pg
            self.objects.setdefault(pg_ready_oid(pg.pg_id),
                                    {"status": "pending", "where": None, "inline": None, "size": 0})
            self.pending_pgs.append(pg.pg_id)
            self._trace_enqueue(pg.pg_id, "pg")
        self._emit_event(
            _const.EVENT_PG_PENDING,
            message=f"placement group {pg.name or pg.pg_id} "
                    f"({pg.strategy}, {len(pg.bundles)} bundles) pending",
            pg_id=pg.pg_id, name=pg.name, strategy=pg.strategy,
            n_bundles=len(pg.bundles))
        if _persist and self.storage is not None:
            self.storage.put("pgs", spec["pg_id"], dict(spec))
        self._schedule()
        return None

    def _try_place_pgs_locked(self):
        """Called under lock from _schedule: try to place each pending PG."""
        import ray_tpu_torch._private.serialization as ser

        placed: list[str] = []
        still = collections.deque()
        while self.pending_pgs:
            pg_id = self.pending_pgs.popleft()
            pg = self.pgs.get(pg_id)
            if pg is None or pg.state != "pending":
                continue
            assignment = pg_policy.place_bundles(
                list(self.nodes.values()), [b.total for b in pg.bundles], pg.strategy)
            if assignment is None:
                still.append(pg_id)
                continue
            for b, node_id in zip(pg.bundles, assignment):
                b.node_id = node_id
                node = self.nodes[node_id]
                for k, v in b.total.items():
                    node.available[k] = node.available.get(k, 0) - v
            pg.state = "created"
            pg.epoch += 1
            placed.append(pg_id)
            placement = {str(i): b.node_id
                         for i, b in enumerate(pg.bundles)}
            tr = self.sched_traces.get(pg_id)
            wait = (time.monotonic() - tr["_enq_mono"]
                    if tr and tr.get("_enq_mono") is not None else None)
            self._observe_sched("pg", "placed", wait)
            self._trace_decision(pg_id, "placed", placement=placement,
                                 epoch=pg.epoch,
                                 queue_wait_s=(round(wait, 6)
                                               if wait is not None else None))
            self._emit_event(
                _const.EVENT_PG_CREATED,
                message=f"placement group {pg.name or pg_id} placed "
                        f"(epoch {pg.epoch})",
                pg_id=pg_id, name=pg.name, strategy=pg.strategy,
                placement=placement, epoch=pg.epoch)
            for conn, rid in pg.waiters:
                try:
                    conn.send({"rid": rid, "ok": True})
                except ConnectionClosed:
                    pass
            pg.waiters = []
        self.pending_pgs = still
        for pg_id in placed:
            blob = ser.dumps(True)
            oid = pg_ready_oid(pg_id)
            self.objects[oid] = {"status": "ready", "where": "inline", "inline": blob, "size": len(blob)}
            for conn, rid in self.object_waiters.pop(oid, []):
                self._reply_object(conn, rid, self.objects[oid])

    def _remove_pg(self, pg_id: str):
        if self.storage is not None:
            self.storage.delete("pgs", pg_id)
        import ray_tpu_torch._private.serialization as ser
        from ray_tpu_torch.exceptions import PlacementGroupUnschedulableError

        waiters: list[tuple[MsgConnection, int]] = []
        with self.lock:
            pg = self.pgs.get(pg_id)
            if pg is None or pg.state == "removed":
                return
            if pg.state == "created":
                # return only the *unused* share now; in-flight tasks return
                # their share straight to the node on completion (_release_for)
                for b in pg.bundles:
                    node = self.nodes.get(b.node_id)
                    if node is not None and node.alive:
                        for k, v in b.available.items():
                            node.available[k] = node.available.get(k, 0) + v
            pg.state = "removed"
            waiters, pg.waiters = pg.waiters, []
            if pg.name and self.named_pgs.get(pg.name) == pg_id:
                del self.named_pgs[pg.name]
            self.pending_pgs = collections.deque(p for p in self.pending_pgs if p != pg_id)
            self.sched_traces.pop(pg_id, None)
            self._emit_event(
                _const.EVENT_PG_REMOVED,
                message=f"placement group {pg.name or pg_id} removed",
                pg_id=pg_id, name=pg.name)
        for conn, rid in waiters:
            try:
                conn.send({"rid": rid, "ok": False, "error": "placement group removed"})
            except ConnectionClosed:
                pass
        # resolve the ready-object as an error so get(pg.ready()) unblocks
        blob = ser.dumps(PlacementGroupUnschedulableError("placement group removed"))
        self._on_object_ready(pg_ready_oid(pg_id), where="inline", inline=blob,
                              size=len(blob), is_error=True)
        self._schedule()

    def _pg_wait(self, conn: MsgConnection, msg: dict):
        with self.lock:
            pg = self.pgs.get(msg["pg_id"])
            if pg is None:
                err = "no such placement group"
            elif pg.state == "created":
                conn.send({"rid": msg["rid"], "ok": True})
                return
            elif pg.state == "pending":
                pg.waiters.append((conn, msg["rid"]))
                return
            else:
                err = "placement group removed"
        try:
            conn.send({"rid": msg["rid"], "ok": False, "error": err})
        except ConnectionClosed:
            pass

    # ----------------------------------------------------------------- nodes

    def set_head_object_addr(self, addr: str) -> None:
        with self.lock:
            self.hosts[HEAD_HOST]["object_addr"] = addr

    def _remove_host(self, host_id: str):
        """A follower host's agent connection died: its nodes die with it."""
        with self.lock:
            if host_id not in self.hosts or host_id == HEAD_HOST:
                return
            self.hosts.pop(host_id, None)
            # a departed host's retained series must go with it, or the
            # metrics tab / node_mem_usage gauge serves dead nodes forever
            self.node_history.pop(host_id, None)
            doomed_nodes = [n for n, h in self.node_hosts.items() if h == host_id]
            # drop the host from every object's location set + accounting
            for entry in self.objects.values():
                entry.get("hosts", set()).discard(host_id)
                entry.get("shm_live", set()).discard(host_id)
            self.host_shm_bytes.pop(host_id, None)
        for node_id in doomed_nodes:
            self._remove_node(
                node_id,
                reason=f"host {host_id} connection lost / failed health checks")

    def _reapply_drain_locked(self, node: "_VNode") -> None:
        """Restore a persisted drain onto a (re)registering node: a drain
        record in kv means the node was marked DRAINING before a GCS
        restart / reconnect — it must come back unplaceable."""
        rec = self.kv.get(_DRAIN_KV_PREFIX + node.node_id)
        if rec:
            node.draining = True
            node.drain_reason = rec.get("reason") or ""
            node.drain_since = rec.get("ts")
            node.drain_grace = rec.get("grace_s")

    def _remove_node(self, node_id: str, reason: str = ""):
        """Mark a virtual node dead: its workers die, its PG bundles unplace."""
        to_fail: list[dict] = []
        unplaced_pgs: list[tuple[str, str]] = []
        with self.lock:
            node = self.nodes.get(node_id)
            if node is None or not node.alive:
                return
            node.alive = False
            lost = fp.float_dict(node.total)
            doomed = [w for w in self.workers.values()
                      if w.node_id == node_id and w.kind == "worker" and not w.dead]
            # PGs with bundles on this node go back to pending (reference: PG
            # rescheduling on node failure, gcs_placement_group_manager.h)
            for pg in self.pgs.values():
                if pg.state == "created" and any(b.node_id == node_id for b in pg.bundles):
                    for b in pg.bundles:
                        other = self.nodes.get(b.node_id)
                        if b.node_id != node_id and other is not None and other.alive:
                            for k, v in b.available.items():
                                other.available[k] = other.available.get(k, 0) + v
                        b.available = dict(b.total)
                        b.node_id = None
                    pg.state = "pending"
                    self.pending_pgs.append(pg.pg_id)
                    self._trace_enqueue(pg.pg_id, "pg")
                    unplaced_pgs.append((pg.pg_id, pg.name))
                    oid = pg_ready_oid(pg.pg_id)
                    self.objects[oid] = {"status": "pending", "where": None, "inline": None, "size": 0}
        self._emit_event(
            _const.EVENT_NODE_LEAVE,
            severity=_const.EVENT_SEVERITY_WARNING, node=node_id,
            message=f"node left the cluster: {reason or 'unknown cause'}",
            reason=reason, n_workers_lost=len(doomed),
            # the capacity the cluster lost with the node (the JAX package's
            # event carries the worker count only)
            lost_resources=lost)
        for pg_id_, pg_name_ in unplaced_pgs:
            self._emit_event(
                _const.EVENT_PG_PENDING,
                severity=_const.EVENT_SEVERITY_WARNING, node=node_id,
                message=f"placement group {pg_name_ or pg_id_} unplaced: "
                        f"node {node_id} died; bundles back to pending",
                pg_id=pg_id_, name=pg_name_,
                reason=f"node {node_id} died")
        for w in doomed:
            try:
                w.conn.send({"type": "exit"})
            except ConnectionClosed:
                pass
            self._on_worker_death(w.wid)
        self._schedule()

    # ------------------------------------------------------------ fault paths

    def _fail_task_objects(self, spec: dict, reason: str):
        """Mark all return objects of a task as errored (caller holds no lock)."""
        import ray_tpu_torch._private.serialization as ser
        from ray_tpu_torch.exceptions import (
            ActorDiedError,
            TaskCancelledError,
            WorkerCrashedError,
        )

        if spec.get("_cancelled"):
            exc = TaskCancelledError(reason)
        elif spec["kind"] == "actor_task":
            exc = ActorDiedError(reason)
        else:
            exc = WorkerCrashedError(reason)
        blob = ser.dumps(exc)
        with self.lock:
            free_now = self._sys_hold_locked(spec.pop("_holds", ()), -1)
        if free_now:
            self._free_objects(free_now)
        if spec["num_returns"] == "streaming":
            with self.lock:
                st = self.streams.get(spec["task_id"])
                if st is not None:
                    st["done"] = True
                    st["error"] = blob
                    waiters, st["waiters"] = st["waiters"], []
                else:
                    waiters = []
            for wconn, rid, idx in waiters:
                self._answer_stream_next(wconn, rid, spec["task_id"], idx)
            return
        for i in range(spec["num_returns"]):
            oid = f"{spec['task_id']}r{i:04d}"
            self._on_object_ready(oid, where="inline", inline=blob, size=len(blob), is_error=True)

    def _on_worker_death(self, wid: str):
        requeue: dict | None = None
        fail: list[dict] = []
        death_free: list[str] = []
        with self.lock:
            w = self.workers.get(wid)
            if w is None or w.dead:
                return
            w.dead = True
            # tasks failed here terminate WITHOUT a task_done message, which
            # can unpin lineage entries just like a completion — re-arm the
            # bounded eviction walk (see _retain_lineage_locked)
            self._lineage_evict_stalled = False
            # reclaim the process's outstanding ref contributions: a SIGKILL
            # (or a secondary driver disconnecting) must not pin objects its
            # flushed +1s were holding (reference: reference_counter borrower
            # death)
            for oid, bal in w.ref_balance.items():
                if not bal:
                    continue
                e = self.objects.get(oid)
                if e is None:
                    continue
                e["count"] = e.get("count", 0) - bal
                if self._freeable_locked(oid, e):
                    death_free.append(oid)
            w.ref_balance.clear()
            # pending stubs whose promised publisher is this process: the
            # object_put will never come, so fail them now instead of letting
            # borrowers block until their wait timeout (reference:
            # OwnerDiedError from the ownership directory). The promise index
            # keeps this O(promises by this wid), not O(all objects)
            orphaned_stubs = [
                oid for oid in self._pub_promises.pop(wid, ())
                if (e := self.objects.get(oid)) is not None
                and e.get("status") == "pending"
                and e.get("pub_wid") == wid]
            # fail parked RDT exports that were waiting on this process
            stale_exports = [(tok, waiter) for tok, waiter
                             in self._tensor_exports.items()
                             if waiter[2] == wid]
            for tok, _ in stale_exports:
                self._tensor_exports.pop(tok, None)
            if w.kind != "worker":
                # driver death: free its refs (outside the lock below); the
                # rest of the teardown is the node's job
                driver_death = True
            else:
                driver_death = False
        for _, (rconn, rrid, *_rest) in stale_exports:
            try:
                rconn.send({"rid": rrid, "ok": False,
                            "error": "owner process died during export"})
            except ConnectionClosed:
                pass
        if orphaned_stubs:
            self._fail_orphaned_stubs(orphaned_stubs)
        # leases HELD by the dying process: its workers may still be mid-task
        # on the direct plane, so don't hand them to the scheduler — retire
        # them (the reference kills workers leaked by dead drivers too)
        with self.lock:
            held = list(self._leases_by_holder.pop(wid, ()))
            # compiled DAGs registered by this driver die with it (their
            # channels/loops are gone); the registry must not serve ghosts
            for did in [d for d, r in self.compiled_dags.items()
                        if r.get("driver_wid") == wid]:
                self.compiled_dags.pop(did, None)
        for lw in held:
            self._release_lease(lw, None, make_idle=False)
            with self.lock:
                lw_w = self.workers.get(lw)
                exit_conn = lw_w.conn if lw_w is not None and not lw_w.dead else None
            if exit_conn is not None:
                try:
                    exit_conn.send({"type": "exit"})
                except ConnectionClosed:
                    pass
        if driver_death:
            if death_free:
                self._free_objects(death_free)
            return
        with self.lock:
            # a lease ON the dying worker: give its resources back
            if w.leased_to is not None:
                hs = self._leases_by_holder.get(w.leased_to)
                if hs is not None:
                    hs.discard(wid)
                w.leased_to = None
                w.lease_token = None
                if w.lease_spec is not None:
                    self._release_for(w.lease_spec)
                    w.lease_spec = None
            if w.gpus:
                node = self.nodes.get(w.node_id)
                if node is not None and node.alive:
                    # same freshness window the death-reason tagging uses: a
                    # stale oom_why from a kill that never landed must not
                    # quarantine chips on an unrelated later death
                    if self._oom_fresh(w):
                        # SIGKILLed mid-grant: the physical device pool may
                        # be wedged — quarantine the chips instead of handing
                        # them to the next worker (which would hang in
                        # backend init). Re-enable via unquarantine_chips.
                        node.quarantined_chips.extend(w.gpus)
                    else:
                        node.chip_pool.extend(w.gpus)
            specs = list(w.running_tasks.values())
            w.running_tasks.clear()
            aid = w.actor_id
            if aid is None:
                for spec in specs:
                    if spec["kind"] == "task":
                        self._release_for(spec)
                        # a partially-emitted stream can't be retried (its
                        # items are already consumed); fail it instead
                        if (spec["num_returns"] != "streaming"
                                and spec.get("retries_used", 0) < spec.get("max_retries", 0)):
                            spec["retries_used"] = spec.get("retries_used", 0) + 1
                            requeue = spec
                        else:
                            fail.append(spec)
            else:
                actor = self.actors.get(aid)
                if actor is not None:
                    self._release_for(actor.create_spec)
                    will_restart = (actor.restarts_left != 0
                                    and actor.state != "dead")
                    # in-flight method calls: retried on the restarted
                    # actor while their per-spec budget lasts (reference:
                    # max_task_retries), else failed with ActorDiedError.
                    # Never retried: streams (items already consumed — same
                    # guard as the plain-task path above) and deaths caused
                    # by an explicit kill() (reference: ray.kill interrupts
                    # fail regardless of the retry budget)
                    can_retry = will_restart and not actor.kill_requested
                    # the kill this flag requested has now happened: clear
                    # it so a LATER accidental death of the restarted actor
                    # retries normally (and the alive-handler doesn't
                    # re-kill every future incarnation)
                    actor.kill_requested = False
                    retry_q = []
                    for s in specs:
                        if s["kind"] != "actor_task":
                            if s["kind"] == "actor_create":
                                fail.append(s)
                            continue
                        # spec-level override of the actor's budget: the
                        # compiled-DAG exec loop submits with 0 so a lost
                        # loop task FAILS (resolving the driver's liveness
                        # ref) instead of resurrecting a stale loop over
                        # dead channels on the restarted actor
                        mtr = s.get("max_task_retries",
                                    actor.max_task_retries)
                        used = s.get("retries_used", 0)
                        if (can_retry
                                and s["num_returns"] != "streaming"
                                and (mtr == -1 or used < mtr)):
                            s["retries_used"] = used + 1
                            retry_q.append(s)
                        else:
                            fail.append(s)
                    # lost calls run FIRST on the restarted actor, ahead of
                    # the queued backlog that never dispatched. Retried
                    # specs go back to QUEUED: shed their in-flight group
                    # stamp and recount the group-lane backlog.
                    for s in retry_q:
                        s.pop("_cgroup", None)
                    actor.queue.extendleft(reversed(retry_q))
                    actor.in_flight = 0
                    actor.group_in_flight = {}
                    actor.group_queued = sum(
                        1 for s in actor.queue
                        if actor.method_groups.get(s.get("method") or "")
                        is not None)
                    actor.worker = None
                    # same freshness window the chip quarantine above uses;
                    # the module-level death_reason is computed after the
                    # lock, so derive it locally for the causal event fields
                    dr = ((w.oom_why if self._oom_fresh(w) else None)
                          or f"worker {wid} died")
                    if will_restart:
                        if actor.restarts_left > 0:
                            actor.restarts_left -= 1
                        actor.state = "restarting"
                        actor.num_restarts += 1
                        actor.create_spec["_enq_ts"] = time.monotonic()
                        self._trace_enqueue(actor.aid, "actor")
                        self._emit_event(
                            _const.EVENT_ACTOR_RESTARTING,
                            severity=_const.EVENT_SEVERITY_WARNING,
                            node=w.node_id,
                            message=f"actor {actor.name or actor.aid} "
                                    f"restarting: {dr}",
                            actor_id=actor.aid, name=actor.name,
                            death_reason=dr, worker=wid,
                            num_restarts=actor.num_restarts,
                            restarts_left=actor.restarts_left)
                        self.publish("actor_state", {"actor_id": actor.aid,
                                                     "state": "restarting"})
                        self.pending_actor_creations.append(actor.create_spec)
                    else:
                        actor.state = "dead"
                        self._observe_sched("actor", "died", None)
                        self.sched_traces.pop(actor.aid, None)
                        self._emit_event(
                            _const.EVENT_ACTOR_DEAD,
                            severity=_const.EVENT_SEVERITY_ERROR,
                            node=w.node_id,
                            message=f"actor {actor.name or actor.aid} died: "
                                    f"{dr}",
                            actor_id=actor.aid, name=actor.name,
                            death_reason=dr, worker=wid,
                            num_restarts=actor.num_restarts)
                        self._unpersist_actor(actor.aid)
                        self.publish("actor_state",
                                     {"actor_id": actor.aid, "state": "dead"})
                        while actor.queue:
                            fail.append(actor.queue.popleft())
                        actor.group_queued = 0
                        for conn, rid in actor.waiters:
                            try:
                                conn.send({"rid": rid, "ok": False, "error": "ActorDiedError"})
                            except ConnectionClosed:
                                pass
                        actor.waiters = []
                        death_free.extend(
                            self._actor_dead_cleanup_locked(actor.create_spec))
        if death_free:
            self._free_objects(death_free)
        death_reason = (w.oom_why if self._oom_fresh(w) else None) or f"worker {wid} died"
        for spec in fail:
            self._fail_task_objects(
                spec, "task was cancelled" if spec.get("_cancelled")
                else death_reason)
        if requeue is not None:
            with self.lock:
                self.pending_tasks.appendleft(requeue)
        self._schedule()
