"""Node providers: how the autoscaler actually creates/terminates nodes.

The port's copy of ray_tpu/autoscaler/node_provider.py. Its
LocalNodeProvider launches the port's follower agents
(``python -m ray_tpu_torch._private.node_agent``), a "GPU" resource as
``--num-gpus``, each in a process group of its own, and keeps its pid
registry in the port's own 0700 directory
(``<TMPDIR>/ray_tpu_torch_autoscaler_<uid>``), so neither package's
provider can see or signal the other's agents.

Reference capability: autoscaler NodeProvider plugins (AWS/GCP/KubeRay/...,
reference: python/ray/autoscaler/node_provider.py + autoscaler/_private/*/
— create_node/terminate_node/non_terminated_nodes) and the v2 cloud
providers (autoscaler/v2/instance_manager/cloud_providers/).

In-tree providers:
- `LocalNodeProvider` spawns node-agent subprocesses joining the live GCS —
  the single-machine analogue of launching a VM (how the reference's fake
  multi-node provider works, autoscaler/_private/fake_multi_node/).
- `FakeFileNodeProvider` keeps its "cloud" in a JSON file outside the
  reconciler process, for crash-restart chaos tests (the mock:// storage
  philosophy applied to nodes), with a SIGKILL fault-injection hook.
- Custom providers subclass NodeProvider (e.g. a cloud provider where one
  "node" is a GPU VM with all of its cards).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional

#: the follower agent a LocalNodeProvider node runs
AGENT_MODULE = "ray_tpu_torch._private.node_agent"
#: how long terminate_node waits for an agent's orderly stop (its
#: drain_procs takes up to 3 s for its workers) before it SIGKILLs the group
STOP_GRACE_S = 10.0


class NodeProvider:
    """Interface. Node ids are provider-scoped strings."""

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def is_ready(self, node_id: str) -> bool:
        """Has the node joined the cluster?"""
        return True

    def node_joined(self, node_id: str, gcs_node_ids) -> bool:
        """Does this provider node correspond to a registered GCS node?
        Providers whose nodes register under different ids override this."""
        return node_id in set(gcs_node_ids)

    def describe_node(self, node_id: str) -> dict:
        """Provider-specific data persisted with the instance record so a
        RESTARTED provider can re-attach to the node (`adopt_node`). Must be
        wire-safe primitives."""
        return {}

    def adopt_node(self, node_id: str, data: dict) -> bool:
        """Re-attach to a node launched by a previous (crashed) incarnation
        of this provider, from its persisted `describe_node` data. Returns
        False if the node is gone — the reconciler reaps its record."""
        return node_id in set(self.non_terminated_nodes())

    def owns_node(self, node_id: str) -> bool:
        """Opt-in gate for the reconciler's leak sweep: True only for nodes
        this autoscaler provably created. The default is False — sweeping a
        node the autoscaler does NOT own (another cluster's, an operator's)
        is far worse than leaking one, so providers must recognize their own
        naming scheme to enable the sweep."""
        return False

    def shutdown(self) -> None:
        for nid in list(self.non_terminated_nodes()):
            self.terminate_node(nid)


class LocalNodeProvider(NodeProvider):
    """Launches follower node agents as subprocesses against a live GCS.

    An on-disk pid registry (keyed by GCS address) is the local analogue of
    a cloud list API: agents spawned by a CRASHED provider incarnation —
    even one killed between `Popen` and the reconciler's ALLOCATED persist —
    stay visible to `non_terminated_nodes`, so the recovery leak sweep can
    find and terminate them instead of orphaning the process forever."""

    def __init__(self, gcs_address: str, registry_path: str | None = None):
        self.gcs_address = gcs_address
        if registry_path is None:
            # NOT world-writable /tmp: the registry names pids this
            # provider will signal, so any other local user able to write
            # it could direct SIGTERM/SIGKILL at arbitrary processes of
            # ours — keep it in a 0700 per-user directory
            tag = hashlib.sha1(gcs_address.encode()).hexdigest()[:10]
            registry_path = os.path.join(
                _private_state_dir(), f"local_nodes_{tag}.json")
        self.registry_path = registry_path
        self._procs: Dict[str, subprocess.Popen] = {}
        # nodes from a previous provider incarnation, re-attached by
        # (pid, start_time) identity (adopt_node): not our children, so
        # lifecycle is signal/poll-based, and EVERY poll/signal re-verifies
        # the identity — a pid recycled after adoption must never be hit
        self._adopted: Dict[str, tuple] = {}  # node id → (pid, pid_start)
        self._lock = threading.Lock()

    # -- pid registry (best-effort, atomic writes) -------------------------

    def _registry(self) -> dict:
        try:
            with open(self.registry_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _registry_write(self, reg: dict) -> None:
        try:
            _atomic_write_json(self.registry_path, reg)
        except OSError:
            pass  # registry is a best-effort safety net

    def _registry_update(self, node_id: str, ent: Optional[dict]) -> None:
        """Set (or with ent=None, drop) one entry. Caller holds _lock."""
        reg = self._registry()
        if ent is None:
            if node_id not in reg:
                return
            reg.pop(node_id)
        else:
            reg[node_id] = ent
        self._registry_write(reg)

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        host_id = f"as-{node_type}-{uuid.uuid4().hex[:6]}"
        cmd = [sys.executable, "-m", AGENT_MODULE,
               "--address", self.gcs_address, "--host-id", host_id]
        if "CPU" in resources:
            cmd += ["--num-cpus", str(resources["CPU"])]
        if "GPU" in resources:
            cmd += ["--num-gpus", str(resources["GPU"])]
        # provisional registry entry BEFORE the spawn: a crash between
        # Popen and the pid write would otherwise orphan the agent with no
        # trace — the restarted incarnation recovers the pid by finding the
        # unique --host-id in /proc cmdlines (_find_agent_pid)
        with self._lock:
            self._registry_update(host_id, {"pid": None,
                                            "created_at": time.time()})
        # a session of its own: the agent, its runtime-env agent and the
        # workers it spawns form one process group, which terminate_node
        # kills as a whole if the agent's orderly stop does not end it
        p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL,
                             start_new_session=True)
        with self._lock:
            self._procs[host_id] = p
            self._registry_update(host_id, {
                "pid": p.pid, "pid_start": _pid_start_time(p.pid)})
        return host_id

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            p = self._procs.pop(node_id, None)
            pid = None
            adopted = self._adopted.pop(node_id, None)
            if adopted is not None:
                apid, astart = adopted
                if _pid_identity_ok(apid, astart):
                    pid = apid
            elif p is None:
                # registry-only orphan (spawned by a crashed incarnation):
                # kill by registered pid, guarding against pid reuse; a
                # provisional (pid-less) entry resolves via /proc cmdlines
                ent = self._registry().get(node_id) or {}
                if ent.get("pid") is None:
                    pid = _find_agent_pid(node_id)
                else:
                    rpid = int(ent.get("pid") or 0)
                    if rpid > 0 and _pid_identity_ok(rpid,
                                                     ent.get("pid_start")):
                        pid = rpid
        # SIGINT is the agent's orderly stop (its workers, its store
        # segments, its runtime-env agent; SIGTERM would be a drain
        # notice); whatever of its process group outlives the grace is
        # SIGKILLed, so no worker is left holding a card
        if p is not None:
            try:
                p.send_signal(signal.SIGINT)
                p.wait(timeout=STOP_GRACE_S)
            except subprocess.TimeoutExpired:
                pass
            _kill_group(p.pid, leader=True)
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=5)
        elif pid is not None:
            # not our child — signal and poll for exit
            leader = _leads_group(pid)
            try:
                os.kill(pid, signal.SIGINT)
                deadline = time.monotonic() + STOP_GRACE_S
                while time.monotonic() < deadline:
                    if not _pid_alive(pid):
                        break
                    time.sleep(0.05)
            except OSError:
                pass
            _kill_group(pid, leader)
        with self._lock:
            self._registry_update(node_id, None)

    def non_terminated_nodes(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            dead: List[str] = []
            # reap exited agents as we list: poll() collects the child's
            # exit status (no zombie) and the entry is dropped so _procs
            # can't accumulate dead Popen handles forever
            for nid, p in list(self._procs.items()):
                if p.poll() is None:
                    out.append(nid)
                else:
                    self._procs.pop(nid)
                    dead.append(nid)
            for nid, (pid, start) in list(self._adopted.items()):
                if _pid_alive(pid) and _pid_identity_ok(pid, start):
                    out.append(nid)
                else:
                    self._adopted.pop(nid)
                    dead.append(nid)
            # registry-only entries: a crashed incarnation's agents, still
            # running (pid + start time match) — visible so the reconciler's
            # sweep can claim or terminate them. Dead/stale entries and the
            # reaps above fold into ONE registry rewrite per listing.
            seen = set(out)
            reg = self._registry()
            changed = False
            for nid in dead:
                changed = bool(reg.pop(nid, None)) or changed
            now = time.time()
            for nid, ent in list(reg.items()):
                if nid in seen:
                    continue
                if ent.get("pid") is None:
                    # provisional entry: the spawner died between Popen and
                    # the pid write — recover the pid from the agent's own
                    # cmdline, or prune once it's clearly not coming
                    found = _find_agent_pid(nid)
                    if found is not None:
                        ent["pid"] = found
                        ent["pid_start"] = _pid_start_time(found)
                        changed = True
                        out.append(nid)
                    elif now - float(ent.get("created_at") or 0) > 10.0:
                        reg.pop(nid)
                        changed = True
                    continue
                pid = int(ent.get("pid") or 0)
                if (pid > 0 and _pid_alive(pid)
                        and _pid_identity_ok(pid, ent.get("pid_start"))):
                    out.append(nid)
                else:
                    reg.pop(nid)
                    changed = True
            if changed:
                self._registry_write(reg)
        return out

    def describe_node(self, node_id: str) -> dict:
        with self._lock:
            p = self._procs.get(node_id)
            if p is not None:
                # pid_start disambiguates pid reuse: a recycled pid belongs
                # to a DIFFERENT process even though os.kill(pid, 0) says
                # "alive"
                return {"pid": p.pid, "pid_start": _pid_start_time(p.pid)}
            adopted = self._adopted.get(node_id)
        if adopted is None:
            return {}
        return {"pid": adopted[0], "pid_start": adopted[1]}

    def adopt_node(self, node_id: str, data: dict) -> bool:
        pid = int(data.get("pid") or 0)
        if pid <= 0 or not _pid_alive(pid):
            return False
        start = data.get("pid_start")
        if not _pid_identity_ok(pid, start):
            # recycled pid, or identity unverifiable (no /proc): adopting
            # — and later SIGTERMing — could hit an unrelated process;
            # treat the node as gone instead
            return False
        with self._lock:
            self._adopted[node_id] = (pid, start)
        return True

    def owns_node(self, node_id: str) -> bool:
        return node_id.startswith("as-")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # e.g. EPERM: it exists
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            # state is the first field after the comm's closing ')';
            # a zombie has exited — only its parent's reap is pending
            if f.read().rsplit(b")", 1)[1].split()[0] == b"Z":
                return False
    except (OSError, IndexError):
        pass
    return True


def _pid_start_time(pid: int):
    """Kernel start time (clock ticks since boot) from /proc/<pid>/stat,
    or None where /proc isn't available. (pid, start_time) identifies a
    process uniquely for the lifetime of the boot."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # comm (field 2) may contain spaces/parens: parse past the LAST ')'
        # — starttime is overall field 22, i.e. index 19 of the remainder
        return int(data.rsplit(b")", 1)[1].split()[19])
    except (OSError, ValueError, IndexError):
        return None


def _pid_identity_ok(pid: int, want_start) -> bool:
    """True only when the process's identity is POSITIVELY verified: a
    recycled pid must never be signalled, so `None` on either side (e.g.
    no /proc on this platform) means unverifiable → not ours."""
    got = _pid_start_time(pid)
    return got is not None and got == want_start


def _private_state_dir() -> str:
    """A 0700 per-user directory for provider state (the pid registry),
    the port's own: ``<TMPDIR>/ray_tpu_torch_autoscaler_<uid>`` or
    ``RAY_TPU_TORCH_AUTOSCALER_STATE_DIR``."""
    from ray_tpu_torch._private.runtime_env_pip import secure_user_base

    return secure_user_base("RAY_TPU_TORCH_AUTOSCALER_STATE_DIR",
                            "ray_tpu_torch_autoscaler")


def _leads_group(pid: int) -> bool:
    try:
        return os.getpgid(pid) == pid
    except OSError:
        return False


def _kill_group(pid: int, leader: bool) -> None:
    """SIGKILL what is left of an agent: the process group it leads (it was
    started in a session of its own, so its workers are in it even after
    the agent itself has exited), or the pid alone where it leads no group
    of its own (an agent started otherwise)."""
    try:
        if leader:
            os.killpg(pid, signal.SIGKILL)
        else:
            os.kill(pid, signal.SIGKILL)
    except OSError:
        pass


def _find_agent_pid(host_id: str):
    """Recover a lost agent pid by its unique --host-id argv entry in /proc
    cmdlines (the crash window between Popen and the registry pid write)."""
    try:
        pids = [p for p in os.listdir("/proc") if p.isdigit()]
    except OSError:
        return None
    for p in pids:
        try:
            with open(f"/proc/{p}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        if (host_id.encode() in argv
                and AGENT_MODULE.encode() in argv):
            return int(p)
    return None


def _atomic_write_json(path: str, obj) -> None:
    """tmp + fsync + rename: a crash mid-write leaves the old content, not
    a torn file (both the pid registry and the fake cloud rely on it)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class FakeFileNodeProvider(NodeProvider):
    """Fake provider whose "cloud" is a JSON state file OUTSIDE the
    reconciler process: a SIGKILLed monitor's nodes persist on disk and a
    restarted provider instance sees the exact same ground truth — which is
    what makes crash-restart chaos tests real (tests/test_autoscaler_chaos.py).

    State file: {"nodes": {node_id: {...}}, "creates": N} — `creates` is the
    lifetime create_node count, letting tests assert "no double-launch".

    Fault injection: `die_after_create=N` SIGKILLs the calling process right
    after the Nth create_node commits the node to the file but BEFORE
    returning — the reconciler is killed exactly between the provider
    side-effect and its ALLOCATED persist. Fires once per state file (a
    `<path>.died` marker survives the restart)."""

    def __init__(self, path: str, die_after_create: int = 0):
        self.path = path
        self.die_after_create = int(die_after_create)
        self._lock = threading.Lock()

    # -- file-backed "cloud" ----------------------------------------------

    def _load(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"nodes": {}, "creates": 0}

    def _save(self, state: dict) -> None:
        _atomic_write_json(self.path, state)

    # -- NodeProvider surface ---------------------------------------------

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        with self._lock:
            state = self._load()
            state["creates"] = int(state.get("creates", 0)) + 1
            nid = f"ff-{node_type}-{state['creates']}-{uuid.uuid4().hex[:4]}"
            state["nodes"][nid] = {"node_type": node_type,
                                   "resources": dict(resources),
                                   "created_at": time.time()}
            self._save(state)
            if (self.die_after_create
                    and state["creates"] >= self.die_after_create
                    and not os.path.exists(self.path + ".died")):
                with open(self.path + ".died", "w") as f:
                    f.write(str(os.getpid()))
                os.kill(os.getpid(), signal.SIGKILL)
        return nid

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            state = self._load()
            state["nodes"].pop(node_id, None)
            self._save(state)

    def non_terminated_nodes(self) -> List[str]:
        with self._lock:
            return list(self._load()["nodes"])

    def describe_node(self, node_id: str) -> dict:
        return {"path": self.path}

    def owns_node(self, node_id: str) -> bool:
        return node_id.startswith("ff-")
