"""In-process multi-node cluster harness for tests.

Virtual nodes are resource partitions registered with the GCS; each gets its
own worker subprocesses tagged with its node id, so scheduling policies,
placement-group strategies, and node-failure paths are exercised for real on
one machine.

(reference: python/ray/cluster_utils.py:135 — Cluster/add_node run real
GCS/raylet processes per "node" on one machine; that harness is how the
reference tests multi-node without a cluster, SURVEY.md §4.2.) The port's
copy of ray_tpu/cluster_utils.py: `add_node(num_gpus=)` and
`add_host(num_gpus=)` take the place of `num_tpus`. A follower host is a
real node-agent subprocess (`ray_tpu_torch._private.node_agent`) with its
own shm namespace and worker pool, joined over TCP; on one machine its
GPUs are the same cards the head's are.
"""

from __future__ import annotations

import itertools
import os

import ray_tpu_torch
from ray_tpu_torch._private import api as _api


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: dict | None = None):
        self._counter = itertools.count(1)
        self.head_args = head_node_args or {}
        self.node_ids: list[str] = []
        self.host_ids: list[str] = []
        self._agents: dict = {}
        if initialize_head:
            ray_tpu_torch.init(**self.head_args)
            self.node_ids.append("node-0")

    def add_node(self, *, num_cpus: float = 1.0, num_gpus: float = 0.0,
                 resources: dict | None = None, labels: dict | None = None,
                 node_id: str | None = None) -> str:
        node_id = node_id or f"node-{next(self._counter)}"
        res = {"CPU": float(num_cpus)}
        if num_gpus:
            res["GPU"] = float(num_gpus)
        if resources:
            res.update({k: float(v) for k, v in resources.items()})
        _api._get_worker().add_node(node_id, res, labels)
        self.node_ids.append(node_id)
        return node_id

    def remove_node(self, node_id: str):
        _api._get_worker().remove_node(node_id)
        if node_id in self.node_ids:
            self.node_ids.remove(node_id)

    def add_host(self, *, num_cpus: float = 1.0, num_gpus: float = 0.0,
                 host_id: str | None = None, wait: bool = True,
                 env: dict | None = None) -> str:
        """Start a follower-HOST process: a real node agent subprocess with
        its own shm namespace and worker pool, joined over TCP — the closest
        one machine gets to a second machine. (reference: cluster_utils
        add_node runs real raylet processes per node, SURVEY.md §4.2.)
        With `wait`, a host that has not registered within 30 s raises."""
        import subprocess
        import sys
        import time

        host_id = host_id or f"host-{next(self._counter)}"
        node = _api._node
        assert node is not None, "head must be initialized first"
        args = [sys.executable, "-m", "ray_tpu_torch._private.node_agent",
                "--address", node.address, "--host-id", host_id,
                "--num-cpus", str(num_cpus)]
        if num_gpus:
            args += ["--num-gpus", str(num_gpus)]
        child_env = dict(os.environ)
        child_env.pop("RAY_TPU_TORCH_ADDRESS", None)  # agent dials --address
        if env:
            child_env.update(env)
        log = open(os.path.join(node.session_dir, "logs", f"agent-{host_id}.log"), "ab")
        try:
            # a session of its own: the agent and the workers it spawns
            # form one process group, which remove_host kills as a whole
            p = subprocess.Popen(args, env=child_env, stdout=log,
                                 stderr=subprocess.STDOUT, cwd=os.getcwd(),
                                 start_new_session=True)
        finally:
            log.close()
        self._agents[host_id] = p
        if wait:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                nodes = _api._get_worker().list_nodes()
                if any(n["node_id"] == host_id and n["alive"] for n in nodes):
                    break
                time.sleep(0.05)
            else:
                raise TimeoutError(f"host {host_id} did not register")
        self.host_ids.append(host_id)
        return host_id

    def remove_host(self, host_id: str):
        """Lose the host: SIGKILL its agent and every worker the agent
        spawned (one process group, as a machine's loss takes all of its
        processes; the JAX package kills the agent alone and its workers
        exit after their current task). The GCS notices the dead agent
        connection and fails the host's node, workers and object copies
        (the host-failure path)."""
        import signal

        p = self._agents.pop(host_id, None)
        if p is not None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait(timeout=10)
        if host_id in self.host_ids:
            self.host_ids.remove(host_id)

    def shutdown(self):
        for host_id in list(self._agents):
            self.remove_host(host_id)
        ray_tpu_torch.shutdown()
