"""Follower-host agent: joins a remote GCS and hosts a local worker pool.

`python -m ray_tpu_torch._private.node_agent --address <gcs host:port> [...]`

The port's copy of ray_tpu/_private/node_agent.py. Plays the reference
raylet's cluster-facing role on a non-head machine: registers the host and
its resources with the GCS over TCP, spawns worker processes on demand when
the GCS asks (a GPU worker bound to its grant through CUDA_VISIBLE_DEVICES,
a CPU worker hidden from every card under worker_platform="cpu"), runs the
host's object-plane server (chunked TCP pulls from the local shm store),
and forwards worker log lines to the GCS for driver-side streaming
(reference capability: raylet registration gcs_node_manager.h:47 + worker
pool worker_pool.h:280 + object manager object_manager.h:128 + log monitor
_private/log_monitor.py, collapsed into one agent process).

The agent never imports torch: it needs no tensor and no CUDA context, and
a process pays seconds for either. pip/conda envs of its workers are built
by the host's own runtime-env agent (a subprocess started on the first
such spawn, in the agent's process group). SIGTERM is a drain notice;
SIGINT stops the agent in order (workers, store segments, the runtime-env
agent), which is how the autoscaler's LocalNodeProvider terminates it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import threading
import time
import uuid

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private.constants import TEMP_ROOT_ENV, temp_root
from ray_tpu_torch._private.log_monitor import LogMonitor
from ray_tpu_torch._private.object_store import make_object_store
from ray_tpu_torch._private.object_transfer import make_object_server
from ray_tpu_torch._private.procutil import drain_procs
from ray_tpu_torch._private.protocol import ConnectionClosed, connect_address


class NodeAgent:
    def __init__(self, *, address: str, host_id: str | None = None,
                 num_cpus: float | None = None, num_gpus: float | None = None,
                 resources: dict | None = None, labels: dict | None = None,
                 session_dir: str | None = None):
        self.gcs_address = address
        self.host_id = host_id or f"host-{uuid.uuid4().hex[:8]}"
        self.conn = connect_address(address)
        self._rid = 1

        # handshake: learn the session id before anything store-related
        hello = self._rpc({"type": "get_session"})
        self.session_id = hello["session_id"]

        # this host's own shm namespace (a real second machine gets this for
        # free; on one machine the namespace keeps the stores honest-disjoint)
        self.store_ns = f"{self.session_id}_{self.host_id}"
        self.store = make_object_store(self.store_ns)
        if hasattr(self.store, "on_evict"):
            # arena backend: local evict-to-spill must reach the GCS
            # accountant, same as the head workers' hook
            self.store.on_evict = self._report_evictions
        self.obj_server = make_object_server(self.store)

        base = session_dir or temp_root()
        self.session_dir = os.path.join(
            base, f"session_{self.session_id}", f"agent_{self.host_id}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)

        total, labels = accelerators.detect_host_resources(
            num_cpus, num_gpus, resources, labels)

        from ray_tpu_torch._private.runtime_env_agent import AgentHandle

        self._renv_agent = AgentHandle(self.session_dir)
        self._procs: list[subprocess.Popen] = []
        self._rpc({
            "type": "register_host",
            "host_id": self.host_id,
            "node_id": self.host_id,  # one vnode per follower host
            "resources": total,
            "labels": labels,
            "object_addr": self.obj_server.address,
        })
        self.log_monitor = LogMonitor(
            os.path.join(self.session_dir, "logs"), sink=self._forward_log).start()
        # OOM defense for THIS host. Victim choice is delegated to the GCS
        # (same policy as the head: newest retriable plain task first, never
        # actors), since only it knows what each pid runs (reference:
        # per-raylet memory monitor, memory_monitor.h:52 + group-by-owner
        # policy). A dedicated query connection keeps the monitor thread off
        # the agent's main dispatch socket.
        self.mem_monitor = None
        from ray_tpu_torch._private.ray_config import RayConfig
        refresh_ms = RayConfig.get("memory_monitor_refresh_ms")
        if refresh_ms > 0:
            from ray_tpu_torch._private.memory_monitor import MemoryMonitor

            state = {"conn": None, "rid": 0}

            def _clear(pid):
                """Un-tag a declined/failed victim so an unrelated later
                death isn't misattributed to memory pressure."""
                try:
                    if state["conn"] is not None:
                        state["conn"].send({"type": "oom_clear",
                                            "host_id": self.host_id,
                                            "pid": pid})
                except (ConnectionClosed, OSError):
                    state["conn"] = None

            def pick():
                try:
                    if state["conn"] is None:
                        state["conn"] = connect_address(self.gcs_address)
                        # a hung GCS must not wedge the monitor forever —
                        # the kernel OOM killer is what we're racing
                        state["conn"].sock.settimeout(5.0)
                    state["rid"] += 1
                    state["conn"].send({
                        "type": "pick_oom_victim", "rid": state["rid"],
                        "host_id": self.host_id,
                        "why": f"host {self.host_id} memory pressure"})
                    while True:
                        reply = state["conn"].recv()
                        if reply.get("rid") == state["rid"]:
                            break
                except (ConnectionClosed, OSError):
                    state["conn"] = None
                    return None
                pid = reply.get("pid")
                if pid is None:
                    return None
                # only kill pids this agent actually spawned
                if not any(p.pid == pid and p.poll() is None
                           for p in self._procs):
                    _clear(pid)
                    return None
                return pid, f"worker pid {pid} on host {self.host_id}"

            def on_kill(pid, why):
                if why is None:  # the SIGKILL itself failed
                    _clear(pid)

            self.mem_monitor = MemoryMonitor(
                threshold=RayConfig.get("memory_usage_threshold"),
                period_s=refresh_ms / 1000.0, pick_victim=pick,
                on_kill=on_kill).start()

    def _rpc(self, msg: dict) -> dict:
        msg["rid"] = self._rid
        self._rid += 1
        self.conn.send(msg)
        while True:
            reply = self.conn.recv()
            if reply.get("rid") == msg["rid"]:
                return reply
            self._dispatch(reply)

    def _report_evictions(self, oids: list) -> None:
        try:
            self.conn.send({"type": "objects_evicted",
                            "host": self.host_id, "oids": list(oids)})
        except ConnectionClosed:
            pass

    def _forward_log(self, source: str, line: str):
        try:
            self.conn.send({"type": "log_line",
                            "source": f"{self.host_id}/{source}", "line": line})
        except ConnectionClosed:
            pass

    def _resource_view(self) -> dict:
        """One periodic resource-view delta (reference: ray_syncer's
        RESOURCE_VIEW channel — raylets broadcast their load so the rest
        of the cluster schedules on fresh state, syncer.h). Here the view
        feeds the GCS host table and list_nodes' host_view."""
        from ray_tpu_torch._private.memory_monitor import host_memory_usage

        try:
            load1 = os.getloadavg()[0]
        except OSError:
            load1 = 0.0
        live = sum(1 for p in self._procs if p.poll() is None)
        return {"type": "resource_view", "host_id": self.host_id,
                "mem_usage": round(host_memory_usage(), 4),
                "load1": round(load1, 2), "num_worker_procs": live}

    def _view_loop(self, period_s: float):
        while not self._stopping:
            time.sleep(period_s)
            try:
                self.conn.send(self._resource_view())
            except ConnectionClosed:
                return

    def serve_forever(self):
        from ray_tpu_torch._private.ray_config import RayConfig

        period = RayConfig.get("resource_view_interval_s")
        self._stopping = False
        if period > 0:
            threading.Thread(target=self._view_loop, args=(period,),
                             daemon=True, name="agent-view").start()
        try:
            while True:
                self._dispatch(self.conn.recv())
        except ConnectionClosed:
            pass
        finally:
            self._stopping = True
            self.shutdown()

    def _dispatch(self, msg: dict):
        t = msg.get("type")
        if t == "spawn_workers":
            self._spawn_workers(msg["assignments"], msg.get("node_id", self.host_id),
                                msg.get("runtime_env"))
        elif t == "delete_objects":
            for oid in msg["oids"]:
                try:
                    self.store.delete(oid)
                except Exception:
                    pass
        elif t == "spill_objects":
            for oid in msg["oids"]:
                try:
                    self.store.spill(oid)
                except Exception:
                    pass
        elif t == "ping":
            # GCS active health check (reference: gcs_health_check_manager.h)
            try:
                self.conn.send({"type": "pong", "host_id": self.host_id})
            except ConnectionClosed:
                pass
        elif t == "drain_notice":
            # the GCS already fanned the notice out to resident workers
            # (they connect to it directly); the agent just logs it and
            # keeps serving through the grace window
            print(f"node agent {self.host_id}: node {msg.get('node_id')} "
                  f"draining ({msg.get('reason')}), grace "
                  f"{msg.get('grace_s')}s", flush=True)
        elif t == "exit":
            raise ConnectionClosed()

    def self_drain(self, reason: str) -> None:
        """Ask the GCS to drain this host's node (SIGTERM / preemption
        notice path). Runs on a dedicated connection so it cannot interleave
        with the main dispatch socket's request/reply traffic."""
        from ray_tpu_torch._private.ray_config import RayConfig

        try:
            conn = connect_address(self.gcs_address)
            conn.send({"type": "node_drain", "rid": 1,
                       "node_id": self.host_id,
                       "grace_s": RayConfig.get("drain_grace_s"),
                       "reason": reason})
            reply = conn.recv()
            print(f"node agent {self.host_id}: self-drain ({reason}) → "
                  f"{reply}", flush=True)
            conn.close()
        except (ConnectionClosed, OSError) as e:
            print(f"node agent {self.host_id}: self-drain failed: {e}",
                  flush=True)

    def _spawn_workers(self, assignments: list, node_id: str,
                       runtime_env: dict | None = None):
        import json as _json

        from ray_tpu_torch._private.ray_config import RayConfig
        from ray_tpu_torch._private.runtime_env_container import (
            boot_entry, build_worker_argv)

        base = dict(os.environ)
        base["RAY_TPU_TORCH_ADDRESS"] = self.gcs_address
        base["RAY_TPU_TORCH_SESSION"] = self.session_id
        base["RAY_TPU_TORCH_NODE_ID"] = node_id
        base["RAY_TPU_TORCH_HOST_ID"] = self.host_id
        base["RAY_TPU_TORCH_STORE_NS"] = self.store_ns
        base[TEMP_ROOT_ENV] = temp_root()
        if runtime_env:
            base["RAY_TPU_TORCH_RUNTIME_ENV"] = _json.dumps(runtime_env, sort_keys=True)
            base.update(runtime_env.get("env_vars") or {})
            if runtime_env.get("pip") or runtime_env.get("conda"):
                # this host's own runtime-env agent builds the env
                try:
                    base["RAY_TPU_TORCH_RENV_AGENT_SOCK"] = \
                        self._renv_agent.ensure()
                except Exception:
                    pass
        else:
            base.pop("RAY_TPU_TORCH_RUNTIME_ENV", None)
        for gpus in assignments:
            env = dict(base)
            if gpus:
                # GPU worker: restricted to its grant before anything in
                # the child creates a CUDA context
                accelerators.apply_gpu_env(env, gpus)
            elif RayConfig.get("worker_platform") == "cpu":
                accelerators.hide_gpus(env)
            argv = build_worker_argv(runtime_env, env, self.session_dir,
                                     boot_entry(runtime_env))
            log = open(os.path.join(self.session_dir, "logs",
                                    f"worker-{len(self._procs)}.log"), "ab")
            try:
                p = subprocess.Popen(
                    argv,
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                    cwd=os.getcwd())
            finally:
                log.close()
            self._procs.append(p)

    def shutdown(self):
        if self.mem_monitor is not None:
            self.mem_monitor.stop()
        self._renv_agent.stop()
        self.log_monitor.stop()
        self.obj_server.stop()
        drain_procs(self._procs)
        if hasattr(self.store, "release_pid_pins"):
            try:
                self.store.release_pid_pins()
            except Exception:
                pass
        self.store.cleanup_session()


def parser() -> argparse.ArgumentParser:
    """The agent's command line (a GCE GPU VM's startup script runs it with
    ``--address`` and ``--host-id``)."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--address", required=True, help="GCS address host:port or unix:<path>")
    p.add_argument("--host-id", default=None)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    agent = NodeAgent(address=args.address, host_id=args.host_id,
                      num_cpus=args.num_cpus, num_gpus=args.num_gpus)

    # a cloud preemption notice arrives as SIGTERM ahead of the instance
    # kill: turn it into a node drain so resident train workers
    # grace-checkpoint. The agent keeps serving; actual termination is the
    # provider's job after the grace window.
    import signal

    def _on_sigterm(signum, frame):
        threading.Thread(target=agent.self_drain, args=("SIGTERM",),
                         daemon=True, name="agent-self-drain").start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    # SIGINT is the orderly stop even where the spawner ignored it (a
    # background job inherits SIG_IGN): serve_forever's finally shuts down
    signal.signal(signal.SIGINT, signal.default_int_handler)
    print(f"node agent {agent.host_id} joined {args.address} "
          f"(objects at {agent.obj_server.address})", flush=True)
    try:
        agent.serve_forever()
    except KeyboardInterrupt:
        print(f"node agent {agent.host_id}: stopped (SIGINT)", flush=True)


if __name__ == "__main__":
    main()
