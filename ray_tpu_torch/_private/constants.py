"""Shared cross-process protocol constants of the port.

The port's own copy of ray_tpu/_private/constants.py. Names that cross a
process boundary (shm segment prefixes, named-actor name schemes, magic
actor-task method names) come from ONE module, so a producer and a consumer
can never drift apart.

Every shm name here starts with ``rtpt_`` where the JAX package's start
with ``rtpu_``: both packages' runtimes and tests run side by side on one
host, and a leak check or teardown sweep that globs one package's segments
must never see (or unlink) the other's.
"""

from __future__ import annotations

import os
import tempfile

# ------------------------------------------------------------- host paths

#: env var through which a node hands its temp root to the workers it
#: spawns, so a runtime env that sets TMPDIR cannot move a worker's spill
#: dir away from its driver's
TEMP_ROOT_ENV = "RAY_TPU_TORCH_TEMP_ROOT"


def temp_root() -> str:
    """Root of the port's session dirs, spill dirs and runtime envs:
    <TMPDIR>/ray_tpu_torch, or what the spawning node stamped into
    TEMP_ROOT_ENV. (The JAX package keeps a fixed /tmp/ray_tpu.)"""
    return (os.environ.get(TEMP_ROOT_ENV)
            or os.path.join(tempfile.gettempdir(), "ray_tpu_torch"))

# ---------------------------------------------------------------- shm names

#: tmpfs directory all shm segments live in (channels, arenas, spill).
SHM_DIR = "/dev/shm"

#: every per-session shm object (arena segment, file-backed object store
#: entries) is named f"{SHM_SESSION_PREFIX}{session_id}_..." — leak checks
#: and teardown sweeps key on this prefix.
SHM_SESSION_PREFIX = "rtpt_"

#: mutable seqlock channel segments (compiled-DAG edges, PD KV transfer):
#: f"{SHM_CHANNEL_PREFIX}{uuid}" under SHM_DIR. Teardown leak checks glob
#: SHM_CHANNEL_GLOB and must agree with the creator's naming.
SHM_CHANNEL_PREFIX = "rtpt_chan_"

#: glob matching every live channel segment (teardown/leak sweeps).
SHM_CHANNEL_GLOB = SHM_DIR + "/" + SHM_CHANNEL_PREFIX + "*"

#: serve routing-table broadcast segments (single writer = the serve
#: controller, many readers = the proxy shards): f"{SHM_ROUTING_PREFIX}{nonce}"
#: under SHM_DIR. The controller creates/unlinks the segment with the proxy
#: plane's lifecycle; chaos leak checks glob SHM_ROUTING_GLOB.
SHM_ROUTING_PREFIX = "rtpt_routes_"

#: glob matching every live routing-table segment (teardown/leak sweeps).
SHM_ROUTING_GLOB = SHM_DIR + "/" + SHM_ROUTING_PREFIX + "*"

# ----------------------------------------------------- cross-process methods

#: actor-task method name the worker routes to the compiled-DAG channel
#: exec loop (ray_tpu_torch/dag/channel_execution.py) on a dedicated thread —
#: the spec producer (driver) and the worker dispatcher share this one
#: definition. Re-exported by task_spec.py for back-compat.
EXEC_LOOP_METHOD = "__ray_tpu_channel_exec_loop__"

#: function attribute `@ray_tpu_torch.method(concurrency_group=...)` stamps on a
#: method and the actor executor / GCS create-spec introspection read back.
CONCURRENCY_GROUP_ATTR = "__ray_tpu_concurrency_group__"

#: function attribute `@ray_tpu_torch.method(tensor_transport=...)` stamps; the
#: worker's result-serialization path reads it to route device tensors.
TENSOR_TRANSPORT_ATTR = "__ray_tpu_tensor_transport__"

# ------------------------------------------------------------- named actors

#: the serve controller's named-actor name (namespace "_system").
SERVE_CONTROLLER_NAME = "SERVE_CONTROLLER"

#: serve replica actors are named
#: f"{SERVE_REPLICA_NAME_PREFIX}{full_name}:{tag}:{nonce}" (namespace
#: "_system") — the controller's crash-recovery re-adopts replicas by
#: exactly this name, so creator and recovery must share the scheme.
SERVE_REPLICA_NAME_PREFIX = "SERVE_REPLICA:"

#: sharded proxy-plane workers are named
#: f"{SERVE_PROXY_NAME_PREFIX}{index}:{nonce}:{gen}" (namespace "_system") —
#: the controller starts, health-checks, replaces, and crash-recovery
#: re-adopts proxy shards by exactly this name, mirroring the replica scheme
#: above. `gen` is a plane-wide generation counter persisted BEFORE each
#: create: a SIGKILLed shard can hold its name past its death, so a
#: replacement must never reuse it.
SERVE_PROXY_NAME_PREFIX = "SERVE_PROXY:"

#: request-envelope key carrying a zero-copy body reference: when an HTTP
#: body exceeds RayConfig.serve_zero_copy_threshold_bytes the proxy `put`s
#: the raw bytes into the arena object plane and ships the object id hex
#: under this key instead of pickling the body through fast-RPC; the replica
#: unwraps it before user code runs. Producer (proxy) and consumer (replica)
#: live in different processes, so the key is wire protocol.
SERVE_BODY_REF_KEY = "__rtpt_body_ref__"

# ---------------------------------------------------------------- mesh axes

#: the SPMD mesh-axis vocabulary. These strings are program-wide protocol:
#: a collective's `axis_name`, a `PartitionSpec` entry, and the mesh
#: construction in parallel/mesh.py must all agree, and a typo'd axis only
#: explodes at runtime on the real device mesh. The `spmd-consistency`
#: static check resolves every axis string in train/, parallel/, ops/ and
#: llm/ against MESH_AXES, so drift fails tier-1 instead of a TPU job.
MESH_AXIS_DP = "dp"        # data parallel (gradient psum)
MESH_AXIS_FSDP = "fsdp"    # fully-sharded data parallel
MESH_AXIS_EP = "ep"        # expert parallel (MoE)
MESH_AXIS_PP = "pp"        # pipeline parallel (layer stages)
MESH_AXIS_SP = "sp"        # sequence/context parallel (ring attention)
MESH_AXIS_TP = "tp"        # tensor parallel (heads / mlp / vocab)

#: canonical mesh-axis order, outermost→innermost (tp innermost so its
#: collectives ride the shortest ICI hops).
MESH_AXES = (MESH_AXIS_DP, MESH_AXIS_FSDP, MESH_AXIS_EP, MESH_AXIS_PP,
             MESH_AXIS_SP, MESH_AXIS_TP)

# ------------------------------------------------------------------ metrics

#: canonical exported-metric namespace (tools/graft_check metric-name check).
METRIC_NAME_PREFIX = "ray_tpu_"

# ------------------------------------------------------------- node drain

#: GCS RPC type that marks a node DRAINING (scheduler stops placing there,
#: resident workers get a `drain_notice` push, the autoscaler
#: drains-then-terminates). Documented here as protocol; RPC call sites and
#: the gcs.py dispatch arm spell the literal so the rpc-pairing /
#: rpc-field-schema checkers can pair them lexically.
NODE_DRAIN_RPC = "node_drain"

#: unsolicited GCS→worker/agent push announcing the worker's node is
#: draining; CoreWorker._recv_loop records it and train sessions read it as
#: the "save a preemption-grace checkpoint now" flag.
DRAIN_NOTICE_PUSH = "drain_notice"

#: node lifecycle state names surfaced by list_nodes / cluster_state and by
#: the autoscaler instance state machine's DRAINING state — one vocabulary
#: across the GCS node table and the instance table.
NODE_STATE_ALIVE = "ALIVE"
NODE_STATE_DRAINING = "DRAINING"
NODE_STATE_DEAD = "DEAD"

#: TrainWorker.poll() payload keys for cooperative-stop acknowledgement and
#: per-step progress heartbeats: producer (train/worker_group.py) and
#: consumer (train/controller.py hang watchdog) live in different
#: processes, so the keys are wire protocol. Progress rides as an AGE
#: (seconds since the rank's last session.report), not a timestamp —
#: controller and worker clocks need not agree.
TRAIN_POLL_STOP_OBSERVED = "stop_observed"
TRAIN_POLL_PROGRESS_AGE = "progress_age_s"

# ------------------------------------------------------------ cluster events
#
# The structured cluster event log (_private/events.py + the GCS ring).
# Event-type and severity strings cross process boundaries twice: once on
# the `cluster_events_report` flush from controller processes to the GCS,
# and again on every `list_events` read (CLI, state API, dashboard). A
# producer spelling "node.leave" and a filter spelling "node.left" would
# silently match nothing, so the whole vocabulary lives here and the
# `event-type-literal` graft_check forbids re-spelled literals at
# emit_event() call sites outside this module.

#: GCS RPC type flushing a batch of locally-buffered cluster events (serve
#: controller, train controller — anything not co-resident with the GCS).
#: Documented here as protocol; call sites and the gcs.py dispatch arm
#: spell the literal so the rpc-pairing checker can pair them lexically.
CLUSTER_EVENTS_RPC = "cluster_events_report"

#: GCS RPC type reading the event ring with server-side limit/severity/
#: type/node filtering (same lexical-literal discipline as above).
LIST_EVENTS_RPC = "list_events"

#: GCS RPC type answering "why is X pending" with the live per-node
#: rejection table for a pending actor or placement group.
SCHED_EXPLAIN_RPC = "sched_explain"

#: severity vocabulary, orderable by index in EVENT_SEVERITIES.
EVENT_SEVERITY_DEBUG = "DEBUG"
EVENT_SEVERITY_INFO = "INFO"
EVENT_SEVERITY_WARNING = "WARNING"
EVENT_SEVERITY_ERROR = "ERROR"
EVENT_SEVERITIES = (EVENT_SEVERITY_DEBUG, EVENT_SEVERITY_INFO,
                    EVENT_SEVERITY_WARNING, EVENT_SEVERITY_ERROR)

#: event-type vocabulary: "<entity>.<transition>". Every type a producer
#: may emit is enumerated here — `ray_tpu_torch events --type` completion, the
#: README taxonomy table, and the dashboard all key on these strings.
EVENT_NODE_JOIN = "node.join"
EVENT_NODE_LEAVE = "node.leave"
EVENT_NODE_DRAIN = "node.drain"
EVENT_ACTOR_PENDING = "actor.pending"
EVENT_ACTOR_ALIVE = "actor.alive"
EVENT_ACTOR_RESTARTING = "actor.restarting"
EVENT_ACTOR_DEAD = "actor.dead"
EVENT_PG_PENDING = "pg.pending"
EVENT_PG_CREATED = "pg.created"
EVENT_PG_REMOVED = "pg.removed"
EVENT_LEASE_GRANT = "lease.grant"
EVENT_LEASE_RELEASE = "lease.release"
EVENT_AUTOSCALER_INSTANCE = "autoscaler.instance"
EVENT_SERVE_RECONCILE = "serve.reconcile"
EVENT_TRAIN_ATTEMPT = "train.attempt"
#: data-plane fault tolerance: a block's task was resubmitted after a
#: SYSTEM error (actor death / worker crash / lost object), a dead
#: `_MapPoolActor` was replaced by pool supervision, or a block was
#: permanently errored (UDF raise under the skip policy, or a retry
#: budget exhausted).
EVENT_DATA_BLOCK_RETRY = "data.block_retry"
EVENT_DATA_ACTOR_REPLACED = "data.actor_replaced"
EVENT_DATA_BLOCK_ERRORED = "data.block_errored"

EVENT_TYPES = (
    EVENT_NODE_JOIN, EVENT_NODE_LEAVE, EVENT_NODE_DRAIN,
    EVENT_ACTOR_PENDING, EVENT_ACTOR_ALIVE, EVENT_ACTOR_RESTARTING,
    EVENT_ACTOR_DEAD,
    EVENT_PG_PENDING, EVENT_PG_CREATED, EVENT_PG_REMOVED,
    EVENT_LEASE_GRANT, EVENT_LEASE_RELEASE,
    EVENT_AUTOSCALER_INSTANCE, EVENT_SERVE_RECONCILE, EVENT_TRAIN_ATTEMPT,
    EVENT_DATA_BLOCK_RETRY, EVENT_DATA_ACTOR_REPLACED,
    EVENT_DATA_BLOCK_ERRORED,
)

#: canonical field names on the event record envelope. Producers populate
#: them positionally through emit_event()'s signature; consumers (CLI
#: column layout, dashboard JSON, chrome-trace row mapping) index by these.
EVENT_FIELD_SEQ = "seq"
EVENT_FIELD_TS = "ts"
EVENT_FIELD_TYPE = "etype"
EVENT_FIELD_SEVERITY = "severity"
EVENT_FIELD_SOURCE = "source"
EVENT_FIELD_NODE = "node"
EVENT_FIELD_MESSAGE = "message"

#: pytest marker gating the data-plane chaos suite (SIGKILL of pool
#: actors / forced block loss mid-pipeline). Registered in pytest.ini and
#: spelled by tests/test_data_chaos.py's module pytestmark.
DATA_CHAOS_MARKER = "data_chaos"

# ---------------------------------------------------------------- deadlines

#: HTTP request header carrying the per-request deadline budget in seconds
#: (float). The proxy converts it to an absolute wall-clock deadline that
#: rides the request-context envelope through handle → replica → engine;
#: every hop refuses work it can no longer finish. Clients and the
#: load-bench speak this exact header, so it is wire protocol.
HTTP_DEADLINE_HEADER = "x-ray-tpu-deadline-s"
