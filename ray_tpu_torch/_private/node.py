"""Node: session bootstrap — starts the GCS and owns the worker pool.

The port's copy of ray_tpu/_private/node.py: the session lives under
<TMPDIR>/ray_tpu_torch (constants.temp_root), a worker granted whole GPUs
sees exactly those through CUDA_VISIBLE_DEVICES, and a worker with none is
hidden from every card. Workers boot ray_tpu_torch._private.worker_main,
or its worker_boot shim when their runtime env needs a pip venv or a conda
prefix, which the host's runtime-env agent builds.

(reference: python/ray/_private/node.py:47 starts gcs/raylet/log-monitor
subprocesses; here the GCS runs as an in-process thread and workers are
subprocesses. This is the head host, "host-0": its object server
(`make_object_server`) is host-0's entry in the GCS's host table. A
follower host runs a node agent (`_private/node_agent.py`) that connects
its own worker pool and object server to the GCS over TCP.)
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import uuid

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private.constants import TEMP_ROOT_ENV, temp_root
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.ray_config import RayConfig
from ray_tpu_torch._private.object_store import make_object_store
from ray_tpu_torch._private.procutil import drain_procs


class Node:
    def __init__(
        self,
        *,
        resources: dict | None = None,
        num_cpus: float | None = None,
        num_gpus: float | None = None,
        num_workers: int = 0,
        max_workers: int = 16,
        session_dir: str | None = None,
        labels: dict | None = None,
    ):
        self.session_id = uuid.uuid4().hex[:8]
        base = session_dir or temp_root()
        self.session_dir = os.path.join(base, f"session_{self.session_id}")
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.socket_path = os.path.join(self.session_dir, "gcs.sock")

        total, labels = accelerators.detect_host_resources(
            num_cpus, num_gpus, resources, labels)
        self.total_resources = total
        self.node_labels = labels

        self._procs: list[subprocess.Popen] = []
        self._spawn_lock = threading.Lock()
        # per-host runtime-env agent process, started on first pip/conda
        # worker spawn (reference: _private/runtime_env/agent/ — a separate
        # process builds envs, deduplicating concurrent requests)
        from ray_tpu_torch._private.runtime_env_agent import AgentHandle

        self._renv_agent = AgentHandle(self.session_dir)
        self.gcs = GcsServer(
            self.socket_path,
            total_resources=total,
            spawn_worker_cb=self._spawn_workers,
            max_workers=max_workers,
            node_labels=labels,
            session_id=self.session_id,
        )
        self.gcs.start()
        # the head host's object-plane server: follower hosts pull shm
        # objects from here (and vice versa) over chunked TCP
        from ray_tpu_torch._private.object_transfer import make_object_server

        self.object_server = make_object_server(make_object_store(self.session_id))
        self.gcs.set_head_object_addr(self.object_server.address)
        # cross-host control-plane address (follower agents, remote drivers)
        self.address = f"127.0.0.1:{self.gcs.tcp_port}"
        # stream worker logs to the driver's stderr (reference:
        # _private/log_monitor.py); RAY_TPU_TORCH_LOG_TO_DRIVER=0 disables
        self.log_monitor = None
        if RayConfig.get("log_to_driver"):
            from ray_tpu_torch._private.log_monitor import LogMonitor

            self.log_monitor = LogMonitor(
                os.path.join(self.session_dir, "logs")).start()
        # wait for socket
        for _ in range(500):
            if os.path.exists(self.socket_path):
                break
            time.sleep(0.005)
        if num_workers:
            now = time.monotonic()
            # counted before spawn to avoid a register race
            self.gcs._spawn_pending["node-0"].extend([(now, None, "")] * num_workers)
            self._spawn_workers(num_workers, "node-0")

    def _spawn_workers(self, n: int, node_id: str = "node-0", chip_assignments=None,
                       runtime_env: dict | None = None):
        """Spawn n workers; chip_assignments[i] is a tuple of GPU ids (the
        worker owns those GPUs via CUDA_VISIBLE_DEVICES) or None (a CPU
        worker, hidden from the cards under worker_platform="cpu").
        `runtime_env` is a normalized runtime env baked into the processes
        (env_vars at spawn; pip/conda envs built through the agent by the
        worker_boot shim; working_dir/py_modules materialized by
        worker_main)."""
        import json as _json

        base = dict(os.environ)
        base["RAY_TPU_TORCH_SOCKET"] = self.socket_path
        base["RAY_TPU_TORCH_SESSION"] = self.session_id
        base["RAY_TPU_TORCH_NODE_ID"] = node_id
        if runtime_env:
            base["RAY_TPU_TORCH_RUNTIME_ENV"] = _json.dumps(runtime_env, sort_keys=True)
            base.update(runtime_env.get("env_vars") or {})
            if runtime_env.get("pip") or runtime_env.get("conda"):
                # env-bearing workers resolve their interpreter through the
                # per-host runtime-env agent (deduped builds, fail-fast);
                # the boot shim falls back to a local build if it's gone
                try:
                    base["RAY_TPU_TORCH_RENV_AGENT_SOCK"] = \
                        self._renv_agent.ensure()
                except Exception:
                    pass
        else:
            base.pop("RAY_TPU_TORCH_RUNTIME_ENV", None)
        base[TEMP_ROOT_ENV] = temp_root()
        from ray_tpu_torch._private.runtime_env_container import (
            boot_entry, build_worker_argv)

        with self._spawn_lock:
            for i in range(n):
                chips = chip_assignments[i] if chip_assignments else None
                env = dict(base)
                if chips:
                    # GPU worker: restricted to its grant before anything in
                    # the child creates a CUDA context
                    accelerators.apply_gpu_env(env, chips)
                elif RayConfig.get("worker_platform") == "cpu":
                    # CPU workers must not own a card: hard-set, because the
                    # host env may already name the GPUs, and two processes
                    # must not contend for one card's memory
                    accelerators.hide_gpus(env)
                # pip/conda envs boot through a shim that builds the env IN
                # the worker process, then re-execs under its interpreter —
                # the scheduler thread never waits on pip
                argv = build_worker_argv(runtime_env, env, self.session_dir,
                                         boot_entry(runtime_env))
                log = open(os.path.join(self.session_dir, "logs", f"worker-{len(self._procs)}.log"), "ab")
                try:
                    p = subprocess.Popen(
                        argv,
                        env=env,
                        stdout=log,
                        stderr=subprocess.STDOUT,
                        cwd=os.getcwd(),
                    )
                finally:
                    log.close()  # Popen dup'd the fd; parent copy would leak
                self._procs.append(p)

    def restart_gcs(self) -> None:
        """Stand up a fresh GCS on the same socket after a (simulated) crash,
        rebuilding from persistent storage (reference: GCS restart with
        external Redis — gcs_init_data.h rebuild; clients reconnect via
        retryable channels). The old GCS must already be stopped/crashed."""
        self.gcs = GcsServer(
            self.socket_path,
            total_resources=self.total_resources,
            spawn_worker_cb=self._spawn_workers,
            max_workers=self.gcs.max_workers,
            node_labels=self.node_labels,
            session_id=self.session_id,
        )
        self.gcs.start()
        self.gcs.set_head_object_addr(self.object_server.address)
        self.address = f"127.0.0.1:{self.gcs.tcp_port}"

    def shutdown(self):
        if self.log_monitor is not None:
            self.log_monitor.stop()
        self.object_server.stop()
        self.gcs.stop()
        drain_procs(self._procs)
        self._renv_agent.stop()
        # backend-aware teardown: the arena backend must also unlink its
        # /dev/shm segment and spill dir, not just per-object files
        make_object_store(self.session_id).cleanup_session()
