"""Persisted instance state machine for the autoscaler reconciler.

The port's copy of ray_tpu/autoscaler/instance_manager.py, persisted
through the port's GCS `instances` table.

Reference capability: autoscaler v2's instance manager
(reference: python/ray/autoscaler/v2/instance_manager/instance_manager.py +
instance_storage.py — every node the autoscaler touches is an Instance
record whose state transitions are validated and write-through persisted,
so a restarted reconciler rebuilds from the table instead of from memory).

States:

    REQUESTED ──→ ALLOCATED ──→ RUNNING ──→ IDLE_TRACKED ──→ DRAINING ──→ TERMINATING
        │             │            ↑ ↓            │               │            │
        │             └────────────┼─┴────────────┘               │            ↓
        ↓                          │                              │        TERMINATED
    ALLOCATION_FAILED ─────────────┴──(cooldown expires)──────────┴─→    (record gone)

- REQUESTED        — persisted BEFORE the provider create call, so a crash
                     mid-launch leaves a record the recovery sweep resolves.
- ALLOCATED        — the provider returned a node id; persisted with it.
- RUNNING          — the node registered with the GCS (joined the cluster).
- IDLE_TRACKED     — no demand; the persisted idle clock is running.
- DRAINING         — the node_drain RPC was issued (persisted FIRST): the
                     GCS schedules around the node and resident train
                     workers grace-checkpoint; termination waits for
                     drain_deadline. One-way: a drained node never returns
                     to service.
- TERMINATING      — persisted BEFORE the provider terminate call; a crash
                     between persist and cloud call re-issues the (idempotent)
                     terminate on restart.
- TERMINATED       — terminal; the record is deleted from the table.
- ALLOCATION_FAILED— the provider create raised (quota/stockout); carries the
                     launch-type cooldown and error so a restarted reconciler
                     keeps suppressing hot relaunches.

The invariant consumers rely on: **every transition is persisted before its
provider side-effect is considered durable** — at any single crash point the
table holds a record from which the converge loop can recover without
double-launching or leaking the node.
"""

from __future__ import annotations

import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

# -- states -----------------------------------------------------------------

REQUESTED = "REQUESTED"
ALLOCATED = "ALLOCATED"
RUNNING = "RUNNING"
IDLE_TRACKED = "IDLE_TRACKED"
DRAINING = "DRAINING"
TERMINATING = "TERMINATING"
TERMINATED = "TERMINATED"
ALLOCATION_FAILED = "ALLOCATION_FAILED"

#: states in which the instance has (or should have) a live provider node
LIVE_STATES = (ALLOCATED, RUNNING, IDLE_TRACKED, DRAINING)
#: states that count toward a node type's min/max capacity. TERMINATING is
#: included: its provider node is still alive until the terminate succeeds,
#: so releasing the slot early would let a cloud-API outage (terminate
#: failing every pass) push provider reality past max_nodes.
COUNTED_STATES = (REQUESTED, ALLOCATED, RUNNING, IDLE_TRACKED, DRAINING,
                  TERMINATING)

_TRANSITIONS: Dict[str, frozenset] = {
    REQUESTED: frozenset({ALLOCATED, ALLOCATION_FAILED, TERMINATED}),
    ALLOCATED: frozenset({RUNNING, IDLE_TRACKED, TERMINATING, TERMINATED}),
    RUNNING: frozenset({IDLE_TRACKED, DRAINING, TERMINATING, TERMINATED}),
    IDLE_TRACKED: frozenset({RUNNING, DRAINING, TERMINATING, TERMINATED}),
    # one-way: a draining node only ever terminates (no return to RUNNING —
    # the GCS-side drain flag is sticky, so the node can't take new work)
    DRAINING: frozenset({TERMINATING, TERMINATED}),
    TERMINATING: frozenset({TERMINATED}),
    ALLOCATION_FAILED: frozenset({TERMINATED}),
    TERMINATED: frozenset(),
}


class InvalidTransition(RuntimeError):
    """A state change the machine does not allow (programming error)."""


def _transition_counter():
    """Instance state-transition counter, fetched registry-aware (the
    monitor process flushes it to the GCS; in-process autoscalers ride the
    driver's flusher)."""
    from ray_tpu_torch.util.metrics import Counter, get_or_create

    return get_or_create(
        Counter, "ray_tpu_autoscaler_instance_transitions_total",
        "autoscaler instance state-machine transitions",
        tag_keys=("node_type", "from_state", "to_state"))


def _count_transition(node_type: str, from_state: str, to_state: str) -> None:
    try:
        _transition_counter().inc(tags={"node_type": node_type,
                                        "from_state": from_state,
                                        "to_state": to_state})
    except Exception:  # noqa: BLE001 — metrics must never fail a transition
        pass


@dataclass
class Instance:
    """One autoscaler-managed node, as persisted in the GCS table.

    All fields are wire-safe primitives; timestamps are wall-clock
    (`time.time()`) because they must stay meaningful across process
    restarts — monotonic clocks don't."""

    instance_id: str
    node_type: str
    state: str = REQUESTED
    node_id: Optional[str] = None       # provider node id, None until ALLOCATED
    launch_time: float = 0.0            # when the provider node was created
    idle_since: Optional[float] = None  # IDLE_TRACKED clock start
    drain_deadline: float = 0.0         # DRAINING: terminate at/after this
    cooldown_until: float = 0.0         # ALLOCATION_FAILED: suppress until
    error: str = ""                     # ALLOCATION_FAILED: provider error
    provider_data: dict = field(default_factory=dict)  # for adopt_node()
    updated_at: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, rec: dict) -> "Instance":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in rec.items() if k in known})


# -- storage backends --------------------------------------------------------


class InstanceStorage:
    """Where instance records durably live. `put` must not return until the
    record is persisted — callers order provider side-effects after it."""

    def put(self, record: dict) -> None:
        raise NotImplementedError

    def delete(self, instance_id: str) -> None:
        raise NotImplementedError

    def list(self) -> List[dict]:
        raise NotImplementedError


class MemoryInstanceStorage(InstanceStorage):
    """Dict-backed storage for unit tests (and as the shared-state fake:
    two managers over one MemoryInstanceStorage model restart)."""

    def __init__(self):
        self.records: Dict[str, dict] = {}

    def put(self, record: dict) -> None:
        self.records[record["instance_id"]] = dict(record)

    def delete(self, instance_id: str) -> None:
        self.records.pop(instance_id, None)

    def list(self) -> List[dict]:
        return [dict(r) for r in self.records.values()]


class GcsInstanceStorage(InstanceStorage):
    """Instance table in the GCS (new `instances` sqlite table, reached via
    the instance_put/instance_delete/instance_list RPCs). `rpc` is a
    synchronous request/reply callable — the autoscaler passes its own."""

    def __init__(self, rpc: Callable[[dict], dict]):
        self._rpc = rpc

    def _call(self, msg: dict) -> dict:
        reply = self._rpc(msg)
        if reply.get("error") or reply.get("ok") is False:
            # the reply IS the durability ack: an error reply (e.g. the
            # GCS sqlite write failed) must surface, or callers would
            # proceed to provider side-effects with nothing persisted
            raise RuntimeError(
                f"{msg['type']} failed at the GCS: "
                f"{reply.get('error') or 'not acknowledged'}")
        return reply

    def put(self, record: dict) -> None:
        self._call({"type": "instance_put", "instance": dict(record)})

    def delete(self, instance_id: str) -> None:
        self._call({"type": "instance_delete", "instance_id": instance_id})

    def list(self) -> List[dict]:
        return list(self._call({"type": "instance_list"})["instances"])


# -- manager -----------------------------------------------------------------


class InstanceManager:
    """Validated, write-through-persisted view of every managed instance."""

    def __init__(self, storage: InstanceStorage):
        self.storage = storage
        self._instances: Dict[str, Instance] = {}
        # guards the in-memory dict: stop() may run teardown concurrently
        # with a wedged reconcile thread, and both read/mutate this view
        # (persistence calls stay OUTSIDE the lock — they do I/O)
        self._lock = threading.Lock()

    # -- lifecycle --------------------------------------------------------

    def load(self) -> List[Instance]:
        """Replace the in-memory view with the persisted table (restart
        rebuild). Returns the loaded instances."""
        loaded = {
            rec["instance_id"]: Instance.from_dict(rec)
            for rec in self.storage.list()
        }
        with self._lock:
            self._instances = loaded
            return list(self._instances.values())

    def create(self, node_type: str, *, now: Optional[float] = None) -> Instance:
        """New REQUESTED instance, persisted before it is returned — the
        caller may only call the provider after this record is durable."""
        now = time.time() if now is None else now
        inst = Instance(instance_id=f"inst-{uuid.uuid4().hex[:12]}",
                        node_type=node_type, state=REQUESTED, updated_at=now)
        self.storage.put(inst.to_dict())
        with self._lock:
            self._instances[inst.instance_id] = inst
        _count_transition(node_type, "(new)", REQUESTED)
        return inst

    def transition(self, inst: Instance, state: str, *,
                   now: Optional[float] = None, **fields) -> Instance:
        """Move `inst` to `state`, updating `fields`, persisting write-through.
        TERMINATED deletes the record (the table tracks live instances).
        The in-memory view only changes after the persist succeeds."""
        with self._lock:
            cur = self._instances.get(inst.instance_id, inst)
        if state not in _TRANSITIONS.get(cur.state, frozenset()):
            raise InvalidTransition(
                f"instance {cur.instance_id} ({cur.node_type}): "
                f"{cur.state} → {state} is not a legal transition")
        updated = Instance.from_dict({**cur.to_dict(), **fields})
        updated.state = state
        updated.updated_at = time.time() if now is None else now
        if state == TERMINATED:
            self.storage.delete(updated.instance_id)
            with self._lock:
                self._instances.pop(updated.instance_id, None)
        else:
            self.storage.put(updated.to_dict())
            with self._lock:
                self._instances[updated.instance_id] = updated
        # counted AFTER the persist: the metric reports durable transitions
        _count_transition(updated.node_type, cur.state, state)
        return updated

    # -- queries ----------------------------------------------------------

    def instances(self, *states: str) -> List[Instance]:
        with self._lock:
            out = list(self._instances.values())
        if states:
            out = [i for i in out if i.state in states]
        return out

    def get(self, instance_id: str) -> Optional[Instance]:
        with self._lock:
            return self._instances.get(instance_id)

    def by_node(self, node_id: str) -> Optional[Instance]:
        with self._lock:
            for inst in self._instances.values():
                if inst.node_id == node_id:
                    return inst
            return None

    def counts(self, states=COUNTED_STATES) -> Dict[str, int]:
        """Per-type instance counts over `states` (capacity accounting)."""
        out: Dict[str, int] = {}
        with self._lock:
            insts = list(self._instances.values())
        for inst in insts:
            if inst.state in states:
                out[inst.node_type] = out.get(inst.node_type, 0) + 1
        return out
