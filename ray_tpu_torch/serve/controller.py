"""ServeController: the control-plane actor reconciling deployments.

(reference: python/ray/serve/_private/controller.py:102 — owns
ApplicationState / DeploymentStateManager (deployment_state.py:1713,2957)
whose reconcile loop creates/kills replica actors to match the target, and
the autoscaling state (autoscaling_state.py:838) that turns ongoing-request
metrics into new targets. Routing-table push via LongPoll is replaced by
versioned pull: routers poll get_routing_table and cache by version.)

Fault tolerance (reference: the controller checkpoints its state into the
GCS and recovers without touching running replicas — controller.py:102 +
deployment_state.py's recovery path): every control-plane mutation is
write-through persisted into the GCS `serve` table BEFORE its side effect
(replica create/kill) counts as durable, the controller runs as a named
restartable actor (max_restarts=-1), and a crash-restarted incarnation's
__init__ rebuilds deployments/routes from the table and RE-ADOPTS live
replicas by named-actor lookup — healthy replicas are never restarted,
routers keep serving from their version-cached tables during the outage,
and stale rows (replica died while the controller was down) are reaped by
the first reconcile.

Health probing (reference: deployment_state.py drives
ReplicaActor.check_health on health_check_period_s): the reconcile loop
actively probes each replica; a probe that raises counts toward a
consecutive-failure threshold, a probe that HANGS past
health_check_timeout_s marks the replica unhealthy immediately — either
way the replica is drained and replaced, distinct from the
actor-state="dead" path.
"""

from __future__ import annotations

import math
import os
import tempfile
import threading
import time
import uuid

import ray_tpu_torch
from ray_tpu_torch._private.constants import (SERVE_CONTROLLER_NAME,
                                              SERVE_PROXY_NAME_PREFIX,
                                              SERVE_REPLICA_NAME_PREFIX)
from ray_tpu_torch._private.ray_config import RayConfig
from ray_tpu_torch.actor import ActorHandle
from ray_tpu_torch.serve.gcs_state import (META_KEY, PROXY_PLANE_KEY, blob_key,
                                           dep_key, gcs_serve_store, proxy_key,
                                           rep_key)
from ray_tpu_torch.serve.replica import ReplicaActor

CONTROLLER_NAME = SERVE_CONTROLLER_NAME
RECONCILE_INTERVAL_S = 0.1
#: consecutive FAILING (raising) health probes before a replica is replaced.
#: A probe that hangs past health_check_timeout_s replaces immediately —
#: a wedged replica must be gone within one timeout, not threshold × timeout.
HEALTH_PROBE_FAILURE_THRESHOLD = 3


def _recoveries_counter():
    from ray_tpu_torch.util.metrics import Counter, get_or_create

    return get_or_create(
        Counter, "ray_tpu_serve_controller_recoveries_total",
        "serve controller crash-restart recoveries")


def _readopted_counter():
    from ray_tpu_torch.util.metrics import Counter, get_or_create

    return get_or_create(
        Counter, "ray_tpu_serve_replicas_readopted_total",
        "serve replicas re-adopted (not restarted) across controller "
        "recoveries")


def _probe_failure_counter():
    from ray_tpu_torch.util.metrics import Counter, get_or_create

    return get_or_create(
        Counter, "ray_tpu_serve_replica_health_check_failures_total",
        "serve replica health-check probe failures",
        tag_keys=("deployment", "replica"))


def _proxy_shards_gauge():
    from ray_tpu_torch.util.metrics import Gauge, get_or_create

    return get_or_create(
        Gauge, "ray_tpu_serve_proxy_shards",
        "serve proxy-plane shard workers currently running")


def _count(fn):
    """Metrics must never fail a control-plane transition."""
    try:
        fn()
    except Exception:  # noqa: BLE001
        pass


class _DeploymentState:
    def __init__(self, app_name: str, name: str, callable_blob: bytes,
                 init_args_blob: bytes, config: dict, *,
                 next_idx: int = 0, nonce: str | None = None,
                 target: int | None = None, deleted: bool = False):
        self.app_name = app_name
        self.name = name
        self.callable_blob = callable_blob
        self.init_args_blob = init_args_blob
        self.config = config          # dict form of DeploymentConfig
        self.replicas: dict[str, object] = {}  # tag → ActorHandle
        self.addrs: dict[str, tuple] = {}      # tag → fast-RPC (host, port)
        self.pushed: dict[str, tuple] = {}     # tag → (ongoing, mono_ts)
        self.draining: dict[str, tuple[object, float]] = {}  # tag → (handle, deadline)
        self.target = config["initial_replicas"] if target is None else target
        self.next_idx = next_idx
        # names replica actors uniquely across controller generations and
        # redeploys (a dying previous session's replica may still hold its
        # name when the next session starts)
        self.nonce = nonce or uuid.uuid4().hex[:8]
        self.status = "UPDATING"
        self.last_scale_down_ok: float = 0.0
        self.deleted = deleted
        # persisted replica rows mirrored in memory (tag → record) and the
        # operator-visible health state per tag: recovering / healthy /
        # unhealthy-probing / draining
        self.rep_rows: dict[str, dict] = {}
        self.health: dict[str, str] = {}
        # active probing state (in-memory only — probes restart clean after
        # a controller recovery)
        self.probe_fail: dict[str, int] = {}
        self.probe_inflight: dict[str, tuple] = {}  # tag → (ref, sent_mono)
        self.probe_last: dict[str, float] = {}

    @property
    def full_name(self) -> str:
        return f"{self.app_name}_{self.name}"

    def to_record(self) -> dict:
        """Mutable control state only — the (immutable, possibly multi-MB)
        code blobs live in their own blob:<full>:<nonce> row written once
        per generation, so target moves and index bumps stay small writes."""
        return {
            "app_name": self.app_name, "name": self.name,
            "config": dict(self.config), "target": self.target,
            "next_idx": self.next_idx, "nonce": self.nonce,
            "deleted": self.deleted,
        }

    def blobs_record(self) -> dict:
        return {"callable_blob": self.callable_blob,
                "init_args_blob": self.init_args_blob}

    @classmethod
    def from_record(cls, rec: dict, blobs: dict) -> "_DeploymentState":
        return cls(rec["app_name"], rec["name"], blobs["callable_blob"],
                   blobs["init_args_blob"], rec["config"],
                   next_idx=rec.get("next_idx", 0), nonce=rec.get("nonce"),
                   target=rec.get("target"),
                   deleted=rec.get("deleted", False))


@ray_tpu_torch.remote
class ServeController:
    def __init__(self, _store=None, _start_loop: bool = True):
        self.deployments: dict[str, _DeploymentState] = {}  # full_name → state
        self.routes: dict[str, str] = {}  # route_prefix → full deployment name
        self.apps: dict[str, str] = {}    # app name → ingress full name
        # fresh-start version base is wall-clock ms, NOT 0: a router that
        # outlives a serve.shutdown()+run() (which clears the table) still
        # holds the old session's version, and a counter restarting at 0
        # could climb back to exactly that number with different content —
        # the router would then be told "up to date" forever. Crash-restart
        # recovery overwrites this with persisted version + 1 (same
        # lineage, so continuity is what's correct there).
        self.version = int(time.time() * 1000)
        self._lock = threading.RLock()
        self._stop = False
        self._reconcile_dirty = False  # probe path requests one batched bump
        self._store = _store if _store is not None else gcs_serve_store()
        # sharded proxy plane (started on demand by start_proxy_plane):
        # shard fleet state mirrors the replica bookkeeping — persisted
        # rows, probe counters, health strings — plus the plane-scoped
        # singletons: the shm routing broadcast, the SO_REUSEPORT port
        # holder, and (fallback mode) the listener-fd donor
        self._proxy_plane: dict | None = None
        self._proxies: dict[int, object] = {}      # index → ActorHandle
        self._proxy_rows: dict[int, dict] = {}
        self._proxy_addrs: dict[int, tuple] = {}
        self._proxy_health: dict[int, str] = {}
        self._proxy_probe_fail: dict[int, int] = {}
        self._proxy_probe_inflight: dict[int, tuple] = {}
        self._proxy_probe_last: dict[int, float] = {}
        self._routes_shm = None
        self._port_holder = None
        self._fd_donor = None
        self._recover()
        self._thread = None
        if _start_loop:
            self._thread = threading.Thread(
                target=self._reconcile_loop, daemon=True,
                name="serve-reconcile")
            self._thread.start()

    # ---------------------------------------------------------- persistence

    def _persist_meta(self) -> None:
        self._store.put(META_KEY, {"version": self.version,
                                   "routes": dict(self.routes),
                                   "apps": dict(self.apps)})

    def _bump_version(self) -> None:
        """Version bumps are persisted with their routes/apps so a recovered
        controller can never reuse a (version, content) pair a router cached
        before the crash (recovery restarts from persisted version + 1).
        When the proxy plane is up, every bump is also broadcast into the
        shm routing segment so shards see it without an RPC."""
        self.version += 1
        self._persist_meta()
        self._publish_routes()

    def _publish_routes(self) -> None:
        """Publish the full routing table into the plane's shm segment
        (no-op without a plane). Also called once per reconcile pass with
        an unchanged version: the fresh publish timestamp is the shards'
        controller-liveness heartbeat (their routing-table-age gauge)."""
        try:
            with self._lock:  # RLock: safe from _bump_version under lock
                if self._routes_shm is None:
                    return
                table = self.get_routing_table(-1)
                self._routes_shm.publish(table)
        except Exception as e:  # noqa: BLE001 — shards fall back to RPC
            import logging

            logging.getLogger(__name__).warning(
                "routing-table shm publish failed: %r", e)

    def _persist_dep(self, st: _DeploymentState) -> None:
        self._store.put(dep_key(st.full_name), st.to_record())

    def _persist_rep(self, st: _DeploymentState, tag: str) -> None:
        self._store.put(rep_key(st.full_name, tag), st.rep_rows[tag])

    def _delete_rep_row(self, st: _DeploymentState, tag: str) -> None:
        self._store.delete(rep_key(st.full_name, tag))
        st.rep_rows.pop(tag, None)
        st.health.pop(tag, None)

    # -------------------------------------------------------------- recovery

    def _actor_state(self, aid: str) -> str | None:
        from ray_tpu_torch._private.api import _get_worker

        w = _get_worker()
        if not hasattr(w, "rpc"):
            return None
        reply = w.rpc({"type": "actor_info", "aid": aid})
        return reply.get("state") if reply.get("found") else None

    def _lookup_named(self, name: str) -> str | None:
        from ray_tpu_torch._private.api import _get_worker

        w = _get_worker()
        if not hasattr(w, "get_named_actor"):
            return None
        try:
            return w.get_named_actor(name, namespace="_system")
        except Exception:  # noqa: BLE001 — treat lookup failure as absent
            return None

    def _recover(self) -> None:
        """Rebuild from the persisted table (crash-restart path; a no-op on
        the first-ever start). Live replicas are re-adopted by named-actor
        lookup — same actor ids, never restarted; rows whose actor died
        while the controller was down are reaped; rows caught mid-stop get
        their kill re-issued (idempotent)."""
        rows = self._store.list()
        if not rows:
            return
        meta = rows.get(META_KEY) or {}
        self.routes = dict(meta.get("routes") or {})
        self.apps = dict(meta.get("apps") or {})
        self.version = int(meta.get("version", 0))
        live_blob_keys = set()
        for key, rec in rows.items():
            if not key.startswith("dep:"):
                continue
            bkey = blob_key(f"{rec['app_name']}_{rec['name']}",
                            rec.get("nonce") or "")
            blobs = rows.get(bkey)
            if blobs is None:
                # a dep row whose generation blobs never landed (crash
                # between deploy persists): unrecoverable — drop it; its
                # replica rows become orphans and are reaped below
                self._store.delete(key)
                continue
            live_blob_keys.add(bkey)
            st = _DeploymentState.from_record(rec, blobs)
            self.deployments[st.full_name] = st
        for key in rows:
            # blob rows left behind by a replaced/deleted generation
            if key.startswith("blob:") and key not in live_blob_keys:
                self._store.delete(key)
        readopted = 0
        now_mono = time.monotonic()
        for key, rec in rows.items():
            if not key.startswith("rep:"):
                continue
            full, tag = rec["full_name"], rec["tag"]
            st = self.deployments.get(full)
            aid = self._lookup_named(rec["actor_name"])
            alive = (aid is not None
                     and self._actor_state(aid) in ("alive", "pending",
                                                    "restarting"))
            if st is None:
                # orphan row (its deployment record is gone): kill whatever
                # is still running under it and drop the row
                if alive:
                    self._kill_replica(ActorHandle(aid))
                self._store.delete(key)
                continue
            if rec.get("state") == "stopping" or not alive:
                # stopping: the previous incarnation decided to kill this
                # replica — re-issue (idempotent) and finish the delete.
                # dead/missing: a stale row; the reconcile loop replaces it.
                if alive:
                    self._kill_replica(ActorHandle(aid))
                self._store.delete(key)
                continue
            handle = ActorHandle(aid)
            if rec.get("state") == "draining":
                remaining = max(0.0, rec.get("drain_deadline_ts", 0.0)
                                - time.time())
                st.draining[tag] = (handle, now_mono + remaining)
                st.rep_rows[tag] = dict(rec)
                st.health[tag] = "draining"
                continue
            # live replica: re-adopt in place, same actor id
            st.replicas[tag] = handle
            if rec.get("addr"):
                st.addrs[tag] = tuple(rec["addr"])
            rec = {**rec, "actor_id": aid, "state": "running"}
            st.rep_rows[tag] = rec
            self._store.put(key, rec)
            st.health[tag] = "recovering"  # until the first probe passes
            st.probe_last[tag] = now_mono
            readopted += 1
        _count(lambda: _recoveries_counter().inc())
        if readopted:
            _count(lambda: _readopted_counter().inc(readopted))
        self._recover_proxy_plane(rows)
        # force every router to refetch: the rebuilt table content may
        # differ from anything cached under the persisted version (with a
        # recovered plane, this also re-publishes into the shm segment)
        self._bump_version()

    def _recover_proxy_plane(self, rows: dict) -> None:
        """Re-adopt a persisted proxy plane: ATTACH the existing shm
        segment (live shard readers hold mmaps of that inode — an
        unlink+recreate would silently split the plane into two segments),
        re-reserve the port, and re-adopt live shards by named-actor
        lookup exactly like replicas. Dead shards are reaped; the first
        reconcile replaces them."""
        plane = rows.get(PROXY_PLANE_KEY)
        if not plane:
            return
        from ray_tpu_torch.serve import proxy_plane as pp

        self._proxy_plane = dict(plane)
        try:
            self._routes_shm = pp.create_routing_shm(
                plane["nonce"],
                RayConfig.instance().serve_routing_shm_bytes)
        except OSError:
            self._routes_shm = None
        if not plane.get("fd_mode"):
            try:
                self._port_holder = pp.reserve_port(plane["host"],
                                                    plane["port"])
            except OSError:
                pass  # another holder (or a shard) keeps the port pinned
        # fd-passing mode cannot rebuild its donor: the shared acceptor
        # socket died with the previous incarnation, and the port is held
        # (without SO_REUSEPORT) by the surviving shards' fds. Existing
        # shards keep serving; replacements wait for a plane restart.
        now_mono = time.monotonic()
        for key, rec in rows.items():
            if not key.startswith("proxy:"):
                continue
            idx = int(rec["index"])
            aid = self._lookup_named(rec["actor_name"])
            alive = (aid is not None
                     and self._actor_state(aid) in ("alive", "pending",
                                                    "restarting"))
            if not alive:
                self._store.delete(key)
                continue
            self._proxies[idx] = ActorHandle(aid)
            self._proxy_rows[idx] = dict(rec)
            if rec.get("addr"):
                self._proxy_addrs[idx] = tuple(rec["addr"])
            self._proxy_health[idx] = "recovering"
            self._proxy_probe_last[idx] = now_mono

    # ------------------------------------------------------------------- api

    def deploy_application(self, app_name: str, deployments: list[dict],
                           route_prefix: str | None, ingress: str) -> None:
        with self._lock:
            for d in deployments:
                full = f"{app_name}_{d['name']}"
                existing = self.deployments.get(full)
                if (existing is not None
                        and existing.callable_blob == d["callable_blob"]
                        and existing.init_args_blob == d["init_args_blob"]):
                    # config-only update: adjust target / user_config in
                    # place — persisted BEFORE the reconfigure side effect
                    existing.config = d["config"]
                    existing.target = d["config"]["initial_replicas"]
                    existing.deleted = False
                    self._persist_dep(existing)
                    if d["config"].get("user_config") is not None:
                        for r in existing.replicas.values():
                            r.reconfigure.remote(d["config"]["user_config"])
                    continue
                if existing is not None:
                    self._drop_replicas(existing, list(existing.replicas))
                new_state = _DeploymentState(
                    app_name, d["name"], d["callable_blob"],
                    d["init_args_blob"], d["config"],
                    # tags must never be reused while old rows/names can
                    # still exist: the replacement generation continues the
                    # index sequence and keeps draining bookkeeping
                    next_idx=existing.next_idx if existing else 0)
                if existing is not None:
                    new_state.draining = dict(existing.draining)  # finish drains
                    for tag in new_state.draining:
                        if tag in existing.rep_rows:
                            new_state.rep_rows[tag] = existing.rep_rows[tag]
                        new_state.health[tag] = "draining"
                self.deployments[full] = new_state
                # blobs first (written once per generation), THEN the dep
                # row that references them — a crash in between leaves an
                # orphan blob row recovery sweeps, never a dep row whose
                # code is gone
                self._store.put(blob_key(full, new_state.nonce),
                                new_state.blobs_record())
                self._persist_dep(new_state)
                if existing is not None:
                    self._store.delete(blob_key(full, existing.nonce))
            if route_prefix is not None:
                self.routes[route_prefix] = f"{app_name}_{ingress}"
            self.apps[app_name] = f"{app_name}_{ingress}"
            self._bump_version()

    def delete_application(self, app_name: str) -> None:
        with self._lock:
            for full, st in list(self.deployments.items()):
                if st.app_name == app_name:
                    st.deleted = True
                    st.target = 0
                    self._persist_dep(st)
            self.routes = {p: d for p, d in self.routes.items()
                           if not d.startswith(app_name + "_")}
            self.apps.pop(app_name, None)
            self._bump_version()

    def get_routing_table(self, known_version: int = -1) -> dict | None:
        """Replica actor ids per deployment; None if caller is up to date."""
        with self._lock:
            if known_version == self.version:
                return None
            return {
                "version": self.version,
                "routes": dict(self.routes),
                "apps": dict(self.apps),
                "deployments": {
                    full: {"replicas": [h.actor_id for h in st.replicas.values()],
                           "max_ongoing": st.config["max_ongoing_requests"],
                           "max_queued": st.config.get("max_queued_requests",
                                                       -1),
                           "request_router": st.config.get("request_router", "pow2"),
                           "replica_addrs": {
                               h.actor_id: st.addrs[tag]
                               for tag, h in st.replicas.items()
                               if tag in st.addrs}}
                    for full, st in self.deployments.items()
                },
            }

    def status(self) -> dict:
        with self._lock:
            return {
                full: {"status": st.status, "replicas": len(st.replicas),
                       "target": st.target, "app": st.app_name,
                       # operator view of probe-driven replacement:
                       # recovering / healthy / unhealthy-probing / draining
                       "replica_health": dict(st.health)}
                for full, st in self.deployments.items()
            }

    # ----------------------------------------------------------- proxy plane

    def start_proxy_plane(self, host: str, port: int,
                          num_proxies: int) -> dict:
        """Start (idempotently) the sharded proxy plane: pin the ingress
        port, create the shm routing broadcast, publish the current table,
        and start N shard workers. Persisted (plane row + per-shard rows)
        before each side effect, same discipline as replicas."""
        with self._lock:
            if self._proxy_plane is not None:
                return self.proxy_status()
            from ray_tpu_torch.serve import proxy_plane as pp

            nonce = uuid.uuid4().hex[:8]
            fd_mode = not pp.REUSEPORT_AVAILABLE
            uds_path = None
            if fd_mode:
                # one shared acceptor, fds donated to every shard. The UDS
                # lives in tmpdir (NOT /dev/shm — it is not an rtpt shm
                # segment and must not trip leak sweeps)
                listen = pp.make_listen_socket(host, port)
                port = listen.getsockname()[1]
                uds_path = os.path.join(
                    tempfile.gettempdir(), f"serve-proxy-fds-{nonce}.sock")
                self._fd_donor = pp.ListenerFdDonor(listen, uds_path)
            else:
                # bound-not-listening holder pins the concrete port for
                # the fleet without receiving any connections
                self._port_holder = pp.reserve_port(host, port)
                port = self._port_holder.getsockname()[1]
            plane = {"host": host, "port": int(port),
                     "num_proxies": int(num_proxies), "nonce": nonce,
                     "fd_mode": fd_mode, "uds_path": uds_path,
                     "next_gen": 0}
            self._store.put(PROXY_PLANE_KEY, plane)
            self._proxy_plane = plane
            self._routes_shm = pp.create_routing_shm(
                nonce, RayConfig.instance().serve_routing_shm_bytes)
            self._publish_routes()
            for i in range(plane["num_proxies"]):
                self._start_proxy_locked(i)
            _count(lambda: _proxy_shards_gauge().set(
                float(len(self._proxies))))
            return self.proxy_status()

    def _start_proxy_locked(self, index: int) -> None:
        plane = self._proxy_plane
        # the generation is burned (persisted) BEFORE the create: a
        # SIGKILLed shard may still hold its actor name, so a replacement
        # must never reuse it — mirrors the replica next_idx discipline
        gen = plane.get("next_gen", 0)
        plane["next_gen"] = gen + 1
        self._store.put(PROXY_PLANE_KEY, plane)
        actor_name = (f"{SERVE_PROXY_NAME_PREFIX}"
                      f"{index}:{plane['nonce']}:{gen}")
        row = {"index": index, "actor_name": actor_name, "actor_id": None,
               "addr": None, "state": "starting"}
        self._proxy_rows[index] = row
        self._store.put(proxy_key(index), row)
        from ray_tpu_torch.serve.proxy import ProxyActor

        try:
            handle = ProxyActor.options(
                name=actor_name, namespace="_system",
                num_cpus=0.5, max_concurrency=32,
            ).remote(plane["host"], plane["port"], shard_index=index,
                     plane_nonce=plane["nonce"],
                     fd_sock_path=plane.get("uds_path"))
        except Exception:  # noqa: BLE001 — retry next reconcile tick
            self._store.delete(proxy_key(index))
            self._proxy_rows.pop(index, None)
            return
        row["actor_id"] = handle.actor_id
        self._store.put(proxy_key(index), row)
        self._proxies[index] = handle
        self._proxy_health[index] = "recovering"  # until ready/first probe
        self._proxy_probe_last[index] = time.monotonic()

    def note_proxy_ready(self, index: int, addr) -> None:
        """Shard pushes its bound HTTP (host, port) once its server is up
        (mirrors note_replica_addr). Marks the row running."""
        with self._lock:
            if index not in self._proxies:
                return  # already replaced: ignore the stale push
            addr = tuple(addr)
            self._proxy_addrs[index] = addr
            row = self._proxy_rows.get(index)
            if row is not None and (row.get("addr") != list(addr)
                                    or row.get("state") != "running"):
                row["addr"] = list(addr)
                row["state"] = "running"
                self._store.put(proxy_key(index), row)
            self._proxy_health[index] = "healthy"

    def proxy_status(self) -> dict | None:
        """Operator/CLI view of the proxy plane (None when not started)."""
        with self._lock:
            plane = self._proxy_plane
            if plane is None:
                return None
            return {
                "host": plane["host"], "port": plane["port"],
                "num_proxies": plane["num_proxies"],
                "mode": "fd_passing" if plane.get("fd_mode") else "reuseport",
                "shards": {
                    str(i): {"state": row.get("state"),
                             "health": self._proxy_health.get(i),
                             "addr": row.get("addr")}
                    for i, row in sorted(self._proxy_rows.items())
                },
            }

    def _reconcile_proxies_locked(self, lookup: dict, now: float,
                                  stats_ok: bool) -> None:
        """Shard fleet reconcile (runs under the lock, once per pass):
        reap dead shards, probe live ones, start replacements up to the
        plane's target count."""
        plane = self._proxy_plane
        if plane is None:
            return
        if stats_ok:
            dead = [i for i, h in self._proxies.items()
                    if lookup.get(h.actor_id, {}).get("state") == "dead"]
            for i in dead:
                self._proxies.pop(i)
                self._proxy_addrs.pop(i, None)
                self._forget_proxy_probe(i)
                self._store.delete(proxy_key(i))
                self._proxy_rows.pop(i, None)
            self._probe_proxy_health(lookup, now)
        if not plane.get("fd_mode") or self._fd_donor is not None:
            for i in range(plane["num_proxies"]):
                if i not in self._proxies:
                    self._start_proxy_locked(i)
        _count(lambda: _proxy_shards_gauge().set(float(len(self._proxies))))

    def _forget_proxy_probe(self, index: int) -> None:
        self._proxy_probe_fail.pop(index, None)
        self._proxy_probe_inflight.pop(index, None)
        self._proxy_probe_last.pop(index, None)
        self._proxy_health.pop(index, None)

    _PROXY_PROBE_PERIOD_S = 2.0
    _PROXY_PROBE_TIMEOUT_S = 10.0

    def _probe_proxy_health(self, lookup: dict, now: float) -> None:
        """Same probe machine as replicas: raising probes count toward the
        failure threshold, a hung probe replaces immediately."""
        for i, h in list(self._proxies.items()):
            ref, sent = self._proxy_probe_inflight.get(i, (None, 0.0))
            if ref is not None:
                done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
                if done:
                    self._proxy_probe_inflight.pop(i, None)
                    try:
                        ray_tpu_torch.get(ref, timeout=5.0)
                        self._proxy_probe_fail[i] = 0
                        self._proxy_health[i] = "healthy"
                    except Exception:  # noqa: BLE001 — failed probe
                        self._proxy_probe_failed(i)
                elif now - sent > self._PROXY_PROBE_TIMEOUT_S:
                    self._proxy_probe_inflight.pop(i, None)
                    self._proxy_probe_failed(i, hung=True)
                continue
            if lookup.get(h.actor_id, {}).get("state") != "alive":
                continue  # still starting: don't time its init
            if now - self._proxy_probe_last.get(i, 0.0) \
                    >= self._PROXY_PROBE_PERIOD_S:
                self._proxy_probe_last[i] = now
                try:
                    self._proxy_probe_inflight[i] = (h.check_health.remote(),
                                                     now)
                except Exception as e:  # noqa: BLE001 — retry next tick
                    import logging

                    logging.getLogger(__name__).debug(
                        "proxy shard %d probe submit failed: %r", i, e)

    def _proxy_probe_failed(self, index: int, hung: bool = False) -> None:
        self._proxy_probe_fail[index] = \
            self._proxy_probe_fail.get(index, 0) + 1
        self._proxy_health[index] = "unhealthy-probing"
        if hung or (self._proxy_probe_fail[index]
                    >= HEALTH_PROBE_FAILURE_THRESHOLD):
            # no graceful drain for an unhealthy ingress: surviving shards
            # (their own listen sockets / fd copies) keep accepting; kill
            # and let this same pass start the replacement
            h = self._proxies.pop(index, None)
            self._proxy_addrs.pop(index, None)
            self._forget_proxy_probe(index)
            self._store.delete(proxy_key(index))
            self._proxy_rows.pop(index, None)
            if h is not None:
                self._kill_replica(h)

    def _teardown_proxy_plane_locked(self) -> None:
        """Kill every shard and release the plane singletons; the shm
        routing segment is unlinked here (leak sweeps glob
        SHM_ROUTING_GLOB)."""
        if self._proxy_plane is None and not self._proxies:
            return
        # persist the teardown intent FIRST: a crash mid-teardown must
        # recover to "no plane", never re-adopt half-killed shards
        try:
            self._store.delete(PROXY_PLANE_KEY)
            for i in list(self._proxy_rows):
                self._store.delete(proxy_key(i))
        except Exception as e:  # noqa: BLE001 — teardown must not raise
            import logging

            logging.getLogger(__name__).warning(
                "proxy plane row cleanup failed (GCS down?): %r", e)
        for h in self._proxies.values():
            self._kill_replica(h)
        self._proxies.clear()
        self._proxy_addrs.clear()
        self._proxy_rows.clear()
        self._proxy_probe_fail.clear()
        self._proxy_probe_inflight.clear()
        self._proxy_probe_last.clear()
        self._proxy_health.clear()
        if self._fd_donor is not None:
            self._fd_donor.close()
            self._fd_donor = None
        if self._port_holder is not None:
            try:
                self._port_holder.close()
            except OSError:
                pass
            self._port_holder = None
        if self._routes_shm is not None:
            self._routes_shm.close()
            self._routes_shm.unlink()
            self._routes_shm = None
        self._proxy_plane = None
        _count(lambda: _proxy_shards_gauge().set(0.0))

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            self._teardown_proxy_plane_locked()
            # hard teardown: kill every replica now — the reconcile loop that
            # would finish a graceful drain is about to exit
            for st in self.deployments.values():
                for h in st.replicas.values():
                    self._kill_replica(h)
                for h, _deadline in st.draining.values():
                    self._kill_replica(h)
                st.replicas.clear()
                st.draining.clear()
            self.deployments.clear()
            # an explicit shutdown is terminal: clear the table so the NEXT
            # serve session starts from nothing instead of "recovering"
            # this session's deployments
            try:
                self._store.clear()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass

    # -------------------------------------------------------------- reconcile

    def _reconcile_loop(self):
        while not self._stop:
            try:
                try:
                    actor_stats = ray_tpu_torch.cluster_state()["actors"]
                except Exception:
                    actor_stats = None  # stats unavailable: no liveness/load info
                self._do_reconcile(actor_stats)
                if actor_stats is not None:
                    self._do_autoscale(actor_stats)
            except Exception:
                pass  # reconcile must never die; next tick retries
            time.sleep(RECONCILE_INTERVAL_S)

    def _do_reconcile(self, actor_stats: dict | None):
        stats_ok = actor_stats is not None
        lookup = actor_stats or {}
        now = time.monotonic()
        # ONE batched version bump per pass: the bump is a synchronous
        # persist RPC under the lock, and a burst (e.g. a node death taking
        # out 10 replicas) must not serialize 10 round trips while routers'
        # get_routing_table calls wait on the lock
        changed = False
        dead_dropped = started = scaled_down = deleted_deps = 0
        with self._lock:
            for full, st in list(self.deployments.items()):
                # replica death detection: drop handles whose actor the GCS
                # marks dead so they're replaced below and leave the routing
                # table (reference: DeploymentState reconciles against actor
                # liveness, serve/_private/deployment_state.py:1713). Skipped
                # when stats are unavailable — absence of data is not death.
                if stats_ok:
                    dead = [tag for tag, h in st.replicas.items()
                            if lookup.get(h.actor_id, {}).get("state") == "dead"]
                    for tag in dead:
                        st.replicas.pop(tag)
                        st.addrs.pop(tag, None)
                        st.pushed.pop(tag, None)
                        self._forget_probe(st, tag)
                        self._delete_rep_row(st, tag)
                        changed = True
                        dead_dropped += 1
                    # active health probing on each deployment's
                    # health_check_period_s — distinct from the
                    # actor-state="dead" path above: these replicas are
                    # alive but failing/hanging their probes
                    self._probe_health(st, lookup, now)
                # drain completion: kill once idle or past the grace deadline
                for tag, (h, deadline) in list(st.draining.items()):
                    s = lookup.get(h.actor_id, {})
                    idle = stats_ok and s.get("queued", 0) + s.get("in_flight", 0) == 0
                    if idle or now > deadline or s.get("state") == "dead":
                        st.draining.pop(tag)
                        # persist the decision BEFORE the kill: a crash in
                        # between re-issues the (idempotent) kill on recovery
                        row = st.rep_rows.get(tag)
                        if row is not None:
                            row["state"] = "stopping"
                            self._persist_rep(st, tag)
                        self._kill_replica(h)
                        self._delete_rep_row(st, tag)
                live = len(st.replicas)
                if live < st.target:
                    for _ in range(st.target - live):
                        self._start_replica(st)
                    changed = True
                    started += st.target - live
                elif live > st.target:
                    drop = list(st.replicas)[: live - st.target]
                    self._drop_replicas(st, drop)
                    changed = True
                    scaled_down += len(drop)
                st.status = ("HEALTHY" if len(st.replicas) == st.target
                             else "UPDATING")
                if st.deleted and not st.replicas and not st.draining:
                    del self.deployments[full]
                    self._store.delete(dep_key(full))
                    self._store.delete(blob_key(full, st.nonce))
                    changed = True
                    deleted_deps += 1
            self._reconcile_proxies_locked(lookup, now, stats_ok)
            if changed:
                # controller-side cluster event, shipped to the GCS by the
                # host worker's telemetry flusher (cluster_events_report)
                from ray_tpu_torch._private import constants as _const
                from ray_tpu_torch._private.events import emit_event
                emit_event(
                    _const.EVENT_SERVE_RECONCILE,
                    severity=(_const.EVENT_SEVERITY_WARNING if dead_dropped
                              else _const.EVENT_SEVERITY_INFO),
                    message=f"serve reconcile: {dead_dropped} dead replicas "
                            f"dropped, {started} started, "
                            f"{scaled_down} scaled down",
                    source="serve-controller",
                    dead_replicas=dead_dropped, started=started,
                    scaled_down=scaled_down, deleted=deleted_deps)
            if changed or self._reconcile_dirty:
                self._reconcile_dirty = False
                self._bump_version()
            else:
                # heartbeat republish (same version, fresh timestamp):
                # shards' routing-table age gauge measures controller
                # liveness from this, and a reader that raced a torn
                # publish converges within one pass
                self._publish_routes()

    # --------------------------------------------------------- health probes

    def _forget_probe(self, st: _DeploymentState, tag: str) -> None:
        st.probe_fail.pop(tag, None)
        st.probe_inflight.pop(tag, None)
        st.probe_last.pop(tag, None)

    def _probe_health(self, st: _DeploymentState, lookup: dict, now: float):
        period = st.config.get("health_check_period_s") or 2.0
        timeout_s = st.config.get("health_check_timeout_s") or 30.0
        for tag, h in list(st.replicas.items()):
            ref, sent = st.probe_inflight.get(tag, (None, 0.0))
            if ref is not None:
                done, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
                if done:
                    st.probe_inflight.pop(tag, None)
                    try:
                        ray_tpu_torch.get(ref, timeout=5.0)
                        st.probe_fail[tag] = 0
                        if st.health.get(tag) != "healthy":
                            st.health[tag] = "healthy"
                            row = st.rep_rows.get(tag)
                            if row is not None and row.get("state") != "running":
                                row["state"] = "running"
                                self._persist_rep(st, tag)
                    except Exception:  # noqa: BLE001 — any error = failed probe
                        self._probe_failed(st, tag)
                elif now - sent > timeout_s:
                    # hung probe: the replica is wedged, not dead — replace
                    # NOW (waiting out a failure threshold would stretch the
                    # outage to threshold × timeout)
                    st.probe_inflight.pop(tag, None)
                    self._probe_failed(st, tag, hung=True)
                continue
            if lookup.get(h.actor_id, {}).get("state") != "alive":
                continue  # still starting/restarting: don't time its init
            if now - st.probe_last.get(tag, 0.0) >= period:
                st.probe_last[tag] = now
                try:
                    st.probe_inflight[tag] = (h.check_health.remote(), now)
                except Exception:  # noqa: BLE001 — submit failure: next tick
                    pass

    def _probe_failed(self, st: _DeploymentState, tag: str,
                      hung: bool = False):
        st.probe_fail[tag] = st.probe_fail.get(tag, 0) + 1
        _count(lambda: _probe_failure_counter().inc(
            tags={"deployment": st.full_name, "replica": tag}))
        st.health[tag] = "unhealthy-probing"
        row = st.rep_rows.get(tag)
        if row is not None and row.get("state") != "unhealthy":
            # persisted too, so /api/serve (reading the table, not this
            # actor) shows the probing window of a replacement in progress
            row["state"] = "unhealthy"
            self._persist_rep(st, tag)
        if hung or st.probe_fail[tag] >= HEALTH_PROBE_FAILURE_THRESHOLD:
            # unhealthy → drain-and-replace: it leaves the routing table
            # now, dies once idle (or at the grace deadline), and the
            # target/live gap starts its replacement this same tick
            # (version bump batched into this reconcile pass)
            self._drop_replicas(st, [tag])
            self._reconcile_dirty = True

    # ------------------------------------------------------ replica lifecycle

    def _start_replica(self, st: _DeploymentState):
        tag = f"{st.name}#{st.next_idx}"
        st.next_idx += 1
        # persist the advanced index BEFORE creating anything: tags are
        # burned once, so a crash anywhere past here can never hand a new
        # replica a name that an old (possibly still dying) actor holds
        self._persist_dep(st)
        actor_name = (f"{SERVE_REPLICA_NAME_PREFIX}"
                      f"{st.full_name}:{tag}:{st.nonce}")
        row = {"full_name": st.full_name, "tag": tag,
               "actor_name": actor_name, "actor_id": None, "addr": None,
               "state": "starting", "drain_deadline_ts": None}
        st.rep_rows[tag] = row
        # the row is durable BEFORE the create side effect: a crash between
        # persist and create leaves a row recovery resolves by named-actor
        # lookup (found → adopt; not found → reap and recreate)
        self._persist_rep(st, tag)
        opts = dict(st.config.get("ray_actor_options") or {})
        try:
            handle = ReplicaActor.options(
                name=actor_name, namespace="_system",
                num_cpus=opts.get("num_cpus", 1.0),
                # a GPU replica's grant binds CUDA_VISIBLE_DEVICES
                num_gpus=opts.get("num_gpus"),
                resources=opts.get("resources"),
                # data-plane concurrency; health probes ride the replica's
                # dedicated 'control' concurrency group (replica.py), so a
                # saturated request queue can never starve them into a
                # spurious hung-probe replacement
                max_concurrency=st.config["max_ongoing_requests"],
            ).remote(st.full_name, tag, st.callable_blob,
                     st.init_args_blob, st.config.get("user_config"),
                     st.config["max_ongoing_requests"],
                     st.config.get("max_queued_requests", -1))
        except Exception:  # noqa: BLE001 — e.g. the name is still held
            self._delete_rep_row(st, tag)  # retry next tick with a new tag
            return
        row["actor_id"] = handle.actor_id
        self._persist_rep(st, tag)
        st.replicas[tag] = handle
        st.health[tag] = "recovering"  # until its first probe passes
        st.probe_last[tag] = time.monotonic()

    def note_replica_addr(self, full_name: str, tag: str, addr) -> None:
        """Replica pushes its fast-RPC (host, port) once listening; routers
        pick it up on the next versioned table pull (replica.py fast data
        plane)."""
        with self._lock:
            st = self.deployments.get(full_name)
            if st is None or tag not in st.replicas:
                return  # already dropped (or never known): ignore
            addr = tuple(addr)
            if st.addrs.get(tag) == addr:
                return  # periodic re-advertisement: no change, no version bump
            row = st.rep_rows.get(tag)
            if row is not None:
                row["addr"] = list(addr)
                self._persist_rep(st, tag)
            st.addrs[tag] = addr
            self._bump_version()

    def note_replica_stats(self, full_name: str, tag: str,
                           ongoing: int) -> None:
        """Replica's out-of-band ongoing+queued count: the autoscaling
        signal for fast-plane traffic, which never shows up in GCS actor
        task stats (replica.py _stats_push_loop)."""
        with self._lock:
            st = self.deployments.get(full_name)
            if st is None or tag not in st.replicas:
                return
            st.pushed[tag] = (int(ongoing), time.monotonic())

    def _drop_replicas(self, st: _DeploymentState, tags: list[str]):
        """Remove replicas from routing and drain: they keep serving queued
        requests until idle (or the graceful timeout), then die.
        (reference: graceful_shutdown_timeout_s draining in replica teardown,
        serve/_private/deployment_state.py.)"""
        grace = st.config.get("graceful_shutdown_timeout_s", 5.0)
        deadline = time.monotonic() + grace
        for tag in tags:
            # drain decision persisted (wall-clock deadline: it must stay
            # meaningful to a recovered controller) BEFORE the replica
            # leaves the routing table
            row = st.rep_rows.get(tag)
            if row is not None:
                row["state"] = "draining"
                row["drain_deadline_ts"] = time.time() + grace
                self._persist_rep(st, tag)
            h = st.replicas.pop(tag, None)
            st.addrs.pop(tag, None)
            st.pushed.pop(tag, None)
            self._forget_probe(st, tag)
            if h is not None:
                st.draining[tag] = (h, deadline)
                st.health[tag] = "draining"

    def _kill_replica(self, h):
        try:
            h.shutdown.remote()
            ray_tpu_torch.kill(h)
        except Exception:
            pass

    # ------------------------------------------------------------- autoscale

    def _do_autoscale(self, actor_stats: dict):
        """(reference: serve/_private/autoscaling_state.py:838 +
        autoscaling_policy.py — replicas_needed = ceil(total_ongoing /
        target_ongoing_requests), immediate upscale, delayed downscale.

        Ongoing = queued + executing per replica actor, read from GCS actor
        state — NOT probed through the replicas' own (possibly saturated)
        request queues, mirroring the reference where metrics are pushed out
        of band rather than pulled through the data path.)"""
        with self._lock:
            states = [st for st in self.deployments.values()
                      if st.config.get("autoscaling_config") and not st.deleted]
        for st in states:
            cfg = st.config["autoscaling_config"]
            with self._lock:
                rows = [(tag, h.actor_id) for tag, h in st.replicas.items()]
                pushed = dict(st.pushed)
            # per replica: max of the GCS actor-task view (actor plane)
            # and the freshly pushed counter (covers the fast plane; an
            # actor-plane request appears in both, so max avoids double
            # counting)
            now_m = time.monotonic()
            total = 0
            for tag, aid in rows:
                gcs = (actor_stats.get(aid, {}).get("queued", 0)
                       + actor_stats.get(aid, {}).get("in_flight", 0))
                pv, pts = pushed.get(tag, (0, 0.0))
                total += max(gcs, pv if now_m - pts < 2.0 else 0)
            desired = max(cfg["min_replicas"],
                          min(cfg["max_replicas"],
                              math.ceil(total / cfg["target_ongoing_requests"])))
            now = time.monotonic()
            with self._lock:
                if desired > st.target:
                    st.target = desired
                    st.last_scale_down_ok = now + cfg["downscale_delay_s"]
                    self._persist_dep(st)
                elif desired < st.target:
                    if now >= st.last_scale_down_ok:
                        st.target = desired
                        self._persist_dep(st)
                else:
                    st.last_scale_down_ok = now + cfg["downscale_delay_s"]
