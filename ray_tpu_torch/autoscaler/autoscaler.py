"""Declarative autoscaler: reconcile node count against pending demand.

The port's copy of ray_tpu/autoscaler/autoscaler.py, over the port's GCS
(its instance table and demand) and metrics registry; the metric names are
the reference's.

Reference capability: autoscaler v2's reconciler
(reference: python/ray/autoscaler/v2/autoscaler.py:47, scheduler.py,
instance_manager/reconciler.py) consuming the GCS autoscaler-state API
(src/ray/gcs/gcs_autoscaler_state_manager.h), and v1's demand bin-packing
(autoscaler/_private/resource_demand_scheduler.py:100).

Every node the autoscaler touches is an `Instance` record in a persisted
state machine (instance_manager.py): REQUESTED is persisted before the
provider create call, ALLOCATED after it, TERMINATING before the terminate
call — so `reconcile_once` is a pure function of (persisted instance table,
provider `non_terminated_nodes()`, GCS demand). A reconciler SIGKILLed at
any single point restarts, rebuilds from the table, adopts still-alive
provider nodes, reaps records whose node vanished, sweeps provider nodes
that have no record, and converges to the same target without
double-launching or leaking (tests/test_autoscaler_chaos.py).

Loop: read pending demand from the GCS → bin-pack unplaceable demand onto
configured node types (respecting min/max counts) → create/terminate via the
NodeProvider → repeat. A `NodeType` is created/terminated as one unit,
never partially (a GPU host with all of its cards).
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private.protocol import ConnectionClosed, connect_address
from ray_tpu_torch.autoscaler import instance_manager as im
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger(__name__)


@dataclass
class NodeType:
    name: str
    resources: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)
    min_nodes: int = 0
    max_nodes: int = 10


def _fits(avail: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())


def _deduct(avail: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        avail[k] = avail.get(k, 0.0) - v


class Autoscaler:
    """One reconciler per cluster, connected to the GCS as a client."""

    def __init__(self, gcs_address: str, provider: NodeProvider,
                 node_types: List[NodeType], *, interval_s: float = 2.0,
                 idle_timeout_s: float = 60.0,
                 node_startup_grace_s: float = 60.0,
                 drain_grace_s: Optional[float] = None):
        from ray_tpu_torch._private.ray_config import RayConfig

        self.provider = provider
        self.node_types = {nt.name: nt for nt in node_types}
        self.interval_s = interval_s
        self.idle_timeout_s = idle_timeout_s
        # scale-down is drain-then-terminate: the node_drain RPC stops new
        # placements and lets resident train workers grace-checkpoint, and
        # the provider terminate waits out this window (0 = same pass)
        self.drain_grace_s = (RayConfig.get("drain_grace_s")
                              if drain_grace_s is None else float(drain_grace_s))
        # launched nodes get this long to join before their capacity stops
        # counting as pending (reference: the resource demand scheduler
        # subtracts launching nodes from unmet demand so each reconcile
        # doesn't relaunch for the same backlog)
        self.node_startup_grace_s = node_startup_grace_s
        self._conn = connect_address(gcs_address)
        self._rid = itertools.count(1)
        # stop() keeps going after a 5s join timeout (the loop thread may be
        # wedged in a provider backoff) and then issues RPCs of its own:
        # request/reply pairs on the shared connection must be atomic or
        # each thread's recv loop silently eats the other's reply
        self._rpc_lock = threading.Lock()
        self._rpc({"type": "autoscaler_attach"})  # infeasible PGs now pend
        # the persisted instance state machine, write-through to the GCS
        # `instances` table; the first reconcile pass rebuilds from it
        self._im = im.InstanceManager(im.GcsInstanceStorage(self._rpc))
        self._recovered = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- GCS I/O -----------------------------------------------------------

    def _rpc(self, msg: dict) -> dict:
        msg["rid"] = next(self._rid)
        with self._rpc_lock:
            self._conn.send(msg)
            while True:
                reply = self._conn.recv()
                if reply.get("rid") == msg["rid"]:
                    return reply

    def _demand(self) -> dict:
        return self._rpc({"type": "resource_demand"})["demand"]

    # -- metrics -----------------------------------------------------------

    def _observe_pass(self, duration_s: float) -> None:
        """Record reconcile duration + per-type pending/running gauges.
        Gauges are set for EVERY configured node type (zero included) so a
        scale-down is visible as 0, not as a vanished series."""
        try:
            from ray_tpu_torch.util.metrics import (Gauge, Histogram,
                                              get_or_create)

            get_or_create(
                Histogram, "ray_tpu_autoscaler_reconcile_seconds",
                "autoscaler reconcile-pass duration",
                boundaries=(0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0),
            ).observe(duration_s)
            pending = self._im.counts(states=(im.REQUESTED, im.ALLOCATED))
            running = self._im.counts(states=(im.RUNNING, im.IDLE_TRACKED))
            g_pend = get_or_create(
                Gauge, "ray_tpu_autoscaler_pending_nodes",
                "instances requested/allocated but not yet joined",
                tag_keys=("node_type",))
            g_run = get_or_create(
                Gauge, "ray_tpu_autoscaler_running_nodes",
                "instances joined to the cluster (incl. idle-tracked)",
                tag_keys=("node_type",))
            for tname in self.node_types:
                g_pend.set(pending.get(tname, 0), tags={"node_type": tname})
                g_run.set(running.get(tname, 0), tags={"node_type": tname})
        except Exception:  # noqa: BLE001 — metrics must never fail a pass
            logger.debug("autoscaler metrics update failed", exc_info=True)

    def _flush_metrics(self) -> None:
        """Ship this process's metric registry to the GCS. Only when no
        in-process CoreWorker exists (the monitor process): a driver-hosted
        autoscaler shares the process registry, which the driver's own
        flusher already reports — a second source would double-count."""
        try:
            from ray_tpu_torch._private import api as _api

            if getattr(_api, "_worker", None) is not None:
                return
            from ray_tpu_torch.util import metrics as _met

            snap = _met.snapshot()
            if not snap:
                return
            # source is per-PROCESS (registry is process-wide): a restarted
            # Autoscaler instance in the same monitor re-reports the same
            # cumulative registry, and per-source replace must not let the
            # GCS sum the old and new copies
            import os as _os

            msg = {"type": "metrics_report",
                   "source": f"autoscaler:{_os.getpid()}", "metrics": snap}
            with self._rpc_lock:  # one-way send; metrics_report never replies
                self._conn.send(msg)
        except Exception:  # noqa: BLE001
            pass

    # -- reconciliation ----------------------------------------------------

    def reconcile_once(self) -> dict:
        """One reconcile pass; returns a summary (for tests/introspection)."""
        t_pass = time.monotonic()
        try:
            return self._reconcile_once()
        finally:
            self._observe_pass(time.monotonic() - t_pass)

    def _reconcile_once(self) -> dict:
        actions = {"launched": [], "terminated": [], "adopted": [],
                   "reaped": [], "swept": [], "drained": []}
        if not self._recovered:
            self._recover(actions)
            self._recovered = True
        now = time.time()

        # 0. sync the table against provider ground truth. This is what
        #    makes a restart just another pass: stale records resolve, and
        #    provider reality the table doesn't know about gets cleaned up.
        live = set(self.provider.non_terminated_nodes())
        for inst in self._im.instances(im.REQUESTED):
            # only a crashed reconciler leaves REQUESTED behind (within a
            # pass it resolves synchronously): launch outcome unknown, so
            # count it failed — any node it DID create has no record and is
            # swept below, and real demand drives a fresh launch
            self._im.transition(inst, im.TERMINATED)
        for inst in self._im.instances(*im.LIVE_STATES):
            if inst.node_id not in live:
                # externally-died node (incl. preempted slices the provider
                # filters out of non_terminated_nodes — relaunched on demand)
                self._im.transition(inst, im.TERMINATED)
                actions["reaped"].append((inst.node_type, inst.node_id))
        for inst in self._im.instances(im.TERMINATING):
            if inst.node_id in live:
                # crash landed between the TERMINATING persist and the cloud
                # call: re-issue the (idempotent) terminate
                if self._terminate_instance(inst, actions):
                    live.discard(inst.node_id)  # or the sweep re-terminates
            else:
                self._im.transition(inst, im.TERMINATED)
        for inst in self._im.instances(im.ALLOCATION_FAILED):
            if now >= inst.cooldown_until:
                # expired cooldowns drop their stale error from the summary
                self._im.transition(inst, im.TERMINATED)
        # leak sweep: provider nodes no record claims. Only nodes the
        # provider recognizes as autoscaler-created (owns_node) — sweeping a
        # foreign node would be worse than leaking one.
        recorded = {i.node_id for i in self._im.instances() if i.node_id}
        for nid in sorted(live - recorded):
            if not self.provider.owns_node(nid):
                continue
            try:
                self.provider.terminate_node(nid)
                actions["swept"].append(nid)
                live.discard(nid)
                logger.warning("autoscaler: swept leaked node %s (no "
                               "instance record)", nid)
            except Exception:
                logger.exception("failed to sweep leaked node %s", nid)

        demand = self._demand()
        joined = set(demand.get("node_ids") or ())
        for inst in self._im.instances(im.ALLOCATED):
            if inst.node_id in live and self.provider.node_joined(
                    inst.node_id, joined):
                self._im.transition(inst, im.RUNNING)

        # 1. unplaceable demand = demands that don't fit current availability
        avail = dict(demand["available_resources"])
        unmet: List[Dict[str, float]] = []
        for d in demand["demands"]:
            if _fits(avail, d):
                _deduct(avail, d)
            else:
                unmet.append(d)
        for pg in demand["pg_demands"]:
            for b in pg["bundles"]:
                if _fits(avail, b):
                    _deduct(avail, b)
                else:
                    unmet.append(b)

        # 2. min_nodes floors
        counts = self._im.counts()
        for nt in self.node_types.values():
            while (counts.get(nt.name, 0) < nt.min_nodes
                   and not self._cooling_down(nt.name)):
                nid = self._launch(nt)
                if nid is None:
                    break  # cooldown just started; next pass retries
                actions["launched"].append((nt.name, nid))
                counts[nt.name] = counts.get(nt.name, 0) + 1

        # 3. bin-pack unmet demand onto new nodes — several demands may share
        #    one planned node (reference: ResourceDemandScheduler bin-packing).
        #    ALLOCATED instances that haven't joined yet are seeded as
        #    pending capacity so the same backlog doesn't relaunch each pass
        #    (their launch_time is persisted wall-clock: the seeding — and
        #    therefore double-launch protection — survives a restart).
        planned: List[tuple] = []  # (NodeType, remaining capacity, is_new)
        for inst in self._im.instances(im.ALLOCATED):
            nt = self.node_types.get(inst.node_type)
            if (nt is not None
                    # joined capacity is already in available_resources —
                    # counting it again would absorb real demand into
                    # phantom capacity (ALLOCATED means not yet joined)
                    and now - inst.launch_time < self.node_startup_grace_s):
                planned.append((nt, dict(nt.resources), False))
        for d in sorted(unmet, key=lambda d: -sum(d.values())):
            for _, rem, _new in planned:
                if _fits(rem, d):
                    _deduct(rem, d)
                    break
            else:
                for nt in self.node_types.values():
                    if self._cooling_down(nt.name):
                        continue  # launches of this type just failed
                    count_now = (counts.get(nt.name, 0)
                                 + sum(1 for p, _r, new in planned
                                       if new and p.name == nt.name))
                    if count_now >= nt.max_nodes:
                        continue
                    if _fits(dict(nt.resources), d):
                        rem = dict(nt.resources)
                        _deduct(rem, d)
                        planned.append((nt, rem, True))
                        break
        for nt, _rem, new in planned:
            if not new:
                continue
            if self._cooling_down(nt.name):
                # an earlier launch in THIS pass failed: don't hot-retry
                continue
            nid = self._launch(nt)
            if nid is not None:
                actions["launched"].append((nt.name, nid))

        # 4. drain-then-terminate idle above-min nodes (no demand and nothing
        #    running on them — approximated by zero unmet demand + full
        #    availability). Idle past the timeout → DRAINING (the GCS stops
        #    placing there; resident train workers grace-checkpoint) →
        #    terminate once the drain window elapses.
        # idle means nothing pending at all and nothing holding resources
        # on the node: the reference approximates it by zero unmet demand
        # alone, which starts the idle clock while a demand that fits the
        # new node waits for its worker to boot, and drains a node out
        # from under its running actor
        if not unmet and not demand["pg_demands"] and not demand["demands"]:
            busy = set(demand.get("busy_node_ids") or ())
            live_insts = self._im.instances(*im.LIVE_STATES)
            alive_counts = self._im.counts(states=im.LIVE_STATES)
            for inst in live_insts:
                nt = self.node_types.get(inst.node_type)
                if nt is None:
                    continue
                if inst.state == im.DRAINING:
                    # drain is one-way — even below the min floor the node
                    # is already unplaceable, so terminate on schedule and
                    # let the min-floor step relaunch a fresh one
                    if now >= inst.drain_deadline:
                        if self._terminate_instance(inst, actions):
                            alive_counts[inst.node_type] = (
                                alive_counts.get(inst.node_type, 1) - 1)
                    continue
                if (alive_counts.get(inst.node_type, 0) <= nt.min_nodes
                        or self.provider.node_joined(inst.node_id, busy)):
                    if inst.state == im.IDLE_TRACKED:
                        self._im.transition(inst, im.RUNNING, idle_since=None)
                    continue
                if (inst.state == im.ALLOCATED
                        and now - inst.launch_time
                        < self.node_startup_grace_s):
                    # a just-launched node that hasn't joined yet must not be
                    # idle-terminated out from under its own startup: the
                    # idle clock only starts once it joins (RUNNING) or
                    # overstays the startup grace
                    continue
                if inst.state != im.IDLE_TRACKED:
                    inst = self._im.transition(inst, im.IDLE_TRACKED,
                                               idle_since=now)
                if now - (inst.idle_since or now) >= self.idle_timeout_s:
                    inst = self._drain_instance(inst, now, actions)
                    if inst.state == im.DRAINING and now >= inst.drain_deadline:
                        # grace 0: terminate in the same pass
                        if self._terminate_instance(inst, actions):
                            alive_counts[inst.node_type] = (
                                alive_counts.get(inst.node_type, 1) - 1)
        else:
            for inst in self._im.instances(im.IDLE_TRACKED):
                self._im.transition(inst, im.RUNNING, idle_since=None)
            # demand cannot un-drain a node (the GCS-side flag is sticky):
            # holding a DRAINING node would just strand unusable capacity
            for inst in self._im.instances(im.DRAINING):
                if now >= inst.drain_deadline:
                    self._terminate_instance(inst, actions)

        actions["launch_failures"] = {
            f.node_type: f.error
            for f in self._im.instances(im.ALLOCATION_FAILED)}
        return actions

    def _recover(self, actions: dict) -> None:
        """Startup rebuild: load the persisted table and let the provider
        re-attach to each recorded live node (a fresh LocalNodeProvider
        re-adopts agent pids; cloud providers just confirm existence).
        Records whose node is truly gone are reaped by the sync step of the
        same pass — recovery never launches or terminates by itself."""
        for inst in self._im.load():
            # TERMINATING is included: a terminate interrupted by the crash
            # must be re-attachable, or a provider whose visibility depends
            # on adoption (LocalNodeProvider pids) would "lose" the node and
            # orphan it instead of re-issuing the terminate
            if inst.state not in (*im.LIVE_STATES, im.TERMINATING):
                continue
            adopted = False
            try:
                adopted = self.provider.adopt_node(
                    inst.node_id, dict(inst.provider_data))
            except Exception:
                logger.exception("adopt_node failed for %s", inst.node_id)
            if adopted:
                actions["adopted"].append((inst.node_type, inst.node_id))
                logger.info("autoscaler: adopted %s node %s from persisted "
                            "state", inst.node_type, inst.node_id)

    def _cooling_down(self, tname: str) -> bool:
        now = time.time()
        return any(f.cooldown_until > now
                   for f in self._im.instances(im.ALLOCATION_FAILED)
                   if f.node_type == tname)

    def _launch(self, nt: NodeType) -> Optional[str]:
        """Create a node; on provider failure, back off the node type for
        the error's suggested cooldown and return None instead of raising —
        a quota/stockout must degrade the reconciler, not crash it.

        Persistence ordering: the REQUESTED record is durable BEFORE the
        provider call, the ALLOCATED record (with the node id) right after
        it — a crash at any point leaves a record the recovery sweep can
        resolve."""
        if self._stop.is_set():
            # a wedged reconcile pass resuming AFTER stop() tore the fleet
            # down must not relaunch nodes nobody will ever terminate
            return None
        inst = self._im.create(nt.name)
        try:
            nid = self.provider.create_node(nt.name, nt.resources, nt.labels)
        except Exception as e:
            cooldown = float(getattr(e, "cooldown_s", 10.0))
            self._im.transition(inst, im.ALLOCATION_FAILED,
                                cooldown_until=time.time() + cooldown,
                                error=str(e))
            logger.warning("autoscaler: launch of %s failed (%s); cooling "
                           "down %.0fs", nt.name, e, cooldown)
            return None
        if self._stop.is_set():
            # stop() tore the fleet down while this create was in flight
            # (thread wedged inside the provider call past the join
            # timeout): ALLOCATING now would hand a live node to nobody —
            # undo it instead
            logger.warning("autoscaler: launch of %s completed after stop; "
                           "terminating %s", nt.name, nid)
            try:
                self.provider.terminate_node(nid)
            except Exception:
                logger.exception("failed to terminate post-stop node %s",
                                 nid)
            try:
                self._im.transition(inst, im.TERMINATED)
            except Exception:
                # GCS may already be gone; a stale REQUESTED record is
                # resolved by the next incarnation's recovery
                pass
            return None
        data: dict = {}
        try:
            data = self.provider.describe_node(nid) or {}
        except Exception:
            logger.exception("describe_node failed for %s", nid)
        self._im.transition(inst, im.ALLOCATED, node_id=nid,
                            launch_time=time.time(), provider_data=data)
        # a successful launch retires stale failure records of this type
        for f in self._im.instances(im.ALLOCATION_FAILED):
            if f.node_type == nt.name:
                self._im.transition(f, im.TERMINATED)
        logger.info("autoscaler: launched %s node %s", nt.name, nid)
        return nid

    def _drain_instance(self, inst: im.Instance, now: float,
                        actions: dict) -> im.Instance:
        """Begin drain-then-terminate: DRAINING (with its deadline) is
        durable BEFORE the node_drain RPC flips GCS state — a crash in
        between re-enters here with the flag already persisted, and the
        (idempotent) drain is simply re-issued by the sticky GCS record."""
        if inst.state == im.DRAINING:
            return inst
        inst = self._im.transition(inst, im.DRAINING,
                                   drain_deadline=now + self.drain_grace_s)
        try:
            reply = self._rpc({"type": "node_drain", "node_id": inst.node_id,
                               "grace_s": self.drain_grace_s,
                               "reason": "autoscaler scale-down"})
            if not reply.get("ok"):
                # provider-known but never joined the GCS: nothing to notify
                logger.debug("node_drain for %s declined: %s", inst.node_id,
                             reply.get("error"))
        except ConnectionClosed:
            logger.warning("node_drain RPC failed for %s (GCS gone); "
                           "terminating on schedule anyway", inst.node_id)
        actions["drained"].append((inst.node_type, inst.node_id))
        logger.info("autoscaler: draining %s node %s (grace %.0fs)",
                    inst.node_type, inst.node_id, self.drain_grace_s)
        return inst

    def _terminate_instance(self, inst: im.Instance, actions: dict) -> bool:
        """TERMINATING is durable before the cloud call: a crash in between
        re-issues the idempotent terminate on restart instead of leaking.
        Returns True once the node is actually gone."""
        if inst.state != im.TERMINATING:
            inst = self._im.transition(inst, im.TERMINATING)
        try:
            self.provider.terminate_node(inst.node_id)
        except Exception:
            # record stays TERMINATING; the next pass re-issues
            logger.exception("failed to terminate node %s", inst.node_id)
            return False
        self._im.transition(inst, im.TERMINATED)
        actions["terminated"].append((inst.node_type, inst.node_id))
        logger.info("autoscaler: terminated %s node %s", inst.node_type,
                    inst.node_id)
        return True

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.reconcile_once()
                self._flush_metrics()
            except ConnectionClosed:
                return
            except Exception:
                logger.exception("autoscaler reconcile failed")

    def stop(self, terminate_nodes: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # a loop thread still alive after the join timeout may be wedged
        # inside an RPC holding _rpc_lock — teardown must not touch the
        # shared connection or it deadlocks
        wedged = self._thread is not None and self._thread.is_alive()
        if terminate_nodes and not self._recovered and not wedged:
            # stopped before the first reconcile ever ran: the in-memory
            # view is empty but the TABLE may hold a previous incarnation's
            # live nodes — load (and adopt, so pid-based providers can kill
            # them) or terminate_nodes would silently leak everything
            try:
                self._recover({"adopted": []})
                self._recovered = True
            except Exception:
                logger.warning("could not load persisted instances for "
                               "teardown (GCS gone?)")
        if terminate_nodes:
            # teardown is provider-FIRST, persistence best-effort — the
            # inverse of the reconcile-path ordering. The monitor often
            # stops BECAUSE the head/GCS died (ConnectionClosed exit), and
            # a failing persist must not stand between us and releasing
            # cloud nodes. A record left stale here still resolves: the
            # next reconciler's sync reaps it once the node is gone.
            # InstanceManager snapshots are internally locked, so this is
            # consistent even against a wedged reconcile thread mid-pass
            for inst in self._im.instances(*im.LIVE_STATES, im.TERMINATING):
                try:
                    self.provider.terminate_node(inst.node_id)
                except Exception:
                    # one failed cloud call must not abort teardown and
                    # leak every REMAINING node
                    logger.exception("failed to terminate node %s",
                                     inst.node_id)
                    continue
                logger.info("autoscaler: terminated %s node %s",
                            inst.node_type, inst.node_id)
                if wedged:
                    continue
                try:
                    if inst.state != im.TERMINATING:
                        inst = self._im.transition(inst, im.TERMINATING)
                    self._im.transition(inst, im.TERMINATED)
                except Exception:
                    logger.warning("could not persist teardown of %s "
                                   "(GCS gone?); the recovery sweep will "
                                   "resolve the stale record", inst.node_id)
        try:
            self._conn.close()
        except Exception:
            pass
