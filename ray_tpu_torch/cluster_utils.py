"""In-process multi-node cluster harness for tests.

Virtual nodes are resource partitions registered with the GCS; each gets its
own worker subprocesses tagged with its node id, so scheduling policies,
placement-group strategies, and node-failure paths are exercised for real on
one machine.

(reference: python/ray/cluster_utils.py:135 — Cluster/add_node run real
GCS/raylet processes per "node" on one machine; that harness is how the
reference tests multi-node without a cluster, SURVEY.md §4.2.) Counterpart
of the virtual-node half of ray_tpu/cluster_utils.py: `add_node(num_gpus=)`
takes the place of `num_tpus`; follower hosts (`add_host`/`remove_host`)
come with the multi-host runtime, ROADMAP.md Queue 1 item 17.
"""

from __future__ import annotations

import itertools

import ray_tpu_torch
from ray_tpu_torch._private import api as _api
from ray_tpu_torch.exceptions import _not_ported


class Cluster:
    def __init__(self, initialize_head: bool = True, head_node_args: dict | None = None):
        self._counter = itertools.count(1)
        self.head_args = head_node_args or {}
        self.node_ids: list[str] = []
        self.host_ids: list[str] = []
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

    def add_host(self, **_kwargs) -> str:
        raise _not_ported("Cluster.add_host (a follower host's node agent)",
                          "item 17")

    def remove_host(self, host_id: str):
        raise _not_ported("Cluster.remove_host", "item 17")

    def shutdown(self):
        ray_tpu_torch.shutdown()
