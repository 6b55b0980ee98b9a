"""GCE GPU node provider: a Compute Engine VM with all of its H100s is the
atomic scaling unit.

The port's counterpart of ray_tpu/autoscaler/gce_tpu.py. It maps the
autoscaler's create/terminate/list interface onto Compute Engine instance
operations (compute.googleapis.com v1). A provider "node" is one
accelerator-optimized A3 VM (e.g. a3-highgpu-8g = 8 H100s, 208 vCPUs): VMs
are allocated and released whole, and since one VM is one host, a node
type's GPU count alone keeps a pending multi-GPU job on one VM — no head
resource is needed, unlike a multi-host TPU slice.

The API surface is injected (`GceGpuApi`): production uses the REST client
(`gce_rest.RestGceGpuApi` — Compute v1 with retry/backoff and
quota/stockout/preemption mapping); `FakeGceGpuApi` simulates async
provisioning (CREATING → READY) and records calls for fast tests.

(reference: python/ray/autoscaler/_private/gcp/node.py's GCPComputeNode and
autoscaler/v2 cloud_providers/* define the same create/terminate/list
surface.)
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List

from ray_tpu_torch.autoscaler.autoscaler import NodeType
from ray_tpu_torch.autoscaler.node_provider import NodeProvider

#: the accelerator every A3 machine type carries
ACCELERATOR_TYPE = "nvidia-h100-80gb"

# machine type → (H100s, vCPUs), from Google's accelerator-optimized
# machine table (cloud.google.com/compute/docs/accelerator-optimized-machines)
_MACHINE_SHAPES = {
    "a3-highgpu-1g": (1, 26), "a3-highgpu-2g": (2, 52),
    "a3-highgpu-4g": (4, 104), "a3-highgpu-8g": (8, 208),
    "a3-megagpu-8g": (8, 208), "a3-edgegpu-8g": (8, 208),
}


def machine_shape(machine_type: str) -> tuple[int, int]:
    """(GPUs, vCPUs) for an A3 H100 machine type. There is no fallback
    parse: other ``-<n>g`` types carry other cards and other vCPU counts
    (a2-highgpu: A100s, 12 vCPUs each; a3-ultragpu: H200s)."""
    if machine_type not in _MACHINE_SHAPES:
        raise ValueError(f"unknown machine_type {machine_type!r}: an A3 "
                         f"H100 type is one of {sorted(_MACHINE_SHAPES)}")
    return _MACHINE_SHAPES[machine_type]


def gpu_vm_node_type(machine_type: str, *, cpus: float | None = None,
                     min_nodes: int = 0, max_nodes: int = 4) -> NodeType:
    """A NodeType whose resources describe ONE whole VM: its GPUs and its
    vCPUs (or `cpus`, where the agent is given fewer)."""
    gpus, vcpus = machine_shape(machine_type)
    return NodeType(
        name=f"gpu-{machine_type}",
        resources={"GPU": float(gpus),
                   "CPU": float(vcpus if cpus is None else cpus)},
        labels={"machine_type": machine_type,
                "accelerator_type": ACCELERATOR_TYPE,
                "ray.io/node-group": f"gpu-{machine_type}"},
        min_nodes=min_nodes, max_nodes=max_nodes)


class GceGpuApi:
    """The Compute Engine surface the provider consumes. Production: REST
    calls against compute.googleapis.com v1 (instances.insert/delete/list/
    get)."""

    def create_node(self, name: str, machine_type: str,
                    labels: Dict[str, str]) -> None:
        raise NotImplementedError

    def delete_node(self, name: str) -> None:
        raise NotImplementedError

    def list_nodes(self) -> List[str]:
        raise NotImplementedError

    def node_state(self, name: str) -> str:
        """CREATING | READY | DELETING | ABSENT"""
        raise NotImplementedError


class FakeGceGpuApi(GceGpuApi):
    """In-memory Compute API with async CREATING→READY provisioning."""

    def __init__(self, provision_delay_s: float = 0.0):
        self.provision_delay_s = provision_delay_s
        self.nodes: Dict[str, dict] = {}
        self.calls: List[tuple] = []
        self._lock = threading.Lock()

    def create_node(self, name, machine_type, labels):
        with self._lock:
            self.calls.append(("create", name, machine_type))
            self.nodes[name] = {"machine_type": machine_type,
                                "labels": dict(labels),
                                "created": time.monotonic()}

    def delete_node(self, name):
        with self._lock:
            self.calls.append(("delete", name))
            self.nodes.pop(name, None)

    def list_nodes(self):
        with self._lock:
            return list(self.nodes)

    def node_state(self, name):
        with self._lock:
            info = self.nodes.get(name)
            if info is None:
                return "ABSENT"
            if time.monotonic() - info["created"] < self.provision_delay_s:
                return "CREATING"
            return "READY"


class GceGpuNodeProvider(NodeProvider):
    """VM-atomic provider over a GceGpuApi client.

    In production the VM self-joins the cluster: the insert request carries
    a startup script running the port's node agent with ``--address <gcs>
    --host-id <name>-w0``. The provider itself only manages VM lifecycle."""

    def __init__(self, api: GceGpuApi, *, project: str = "proj",
                 zone: str = "us-central1-a", gcs_address: str = "",
                 cluster_name: str = ""):
        self.api = api
        self.project = project
        self.zone = zone
        self.gcs_address = gcs_address
        # scopes node NAMES (ray--<cluster>--...) and therefore owns_node /
        # the reconciler's leak sweep: set it whenever more than one
        # cluster can share a project+zone, or each reconciler would sweep
        # the other's unrecorded VMs
        if "--" in cluster_name or cluster_name.strip("-") != cluster_name:
            # the double hyphen DELIMITS the cluster token in node names; a
            # name containing '--' (or edged with '-', which recreates a
            # '--' at the delimiter) would make "a" own "a--b"'s or "a-"'s
            # VMs — the prefix ambiguity the delimiter exists to prevent
            raise ValueError(
                f"cluster_name {cluster_name!r} must not contain '--' or "
                "begin/end with '-'")
        self.cluster_name = cluster_name
        self._types: Dict[str, str] = {}  # node name → machine_type

    @property
    def _name_prefix(self) -> str:
        # '--' delimiters make the scope prefix-unambiguous: 'ray--prod--'
        # can never prefix 'ray--prod-eu--...' (cluster names cannot
        # contain '--', enforced above)
        return f"ray--{self.cluster_name}--" if self.cluster_name else "ray-"

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        machine = labels.get("machine_type") or node_type.removeprefix("gpu-")
        name = f"{self._name_prefix}{node_type}-{uuid.uuid4().hex[:6]}"
        self.api.create_node(name, machine, labels)
        self._types[name] = machine
        return name

    def terminate_node(self, node_id: str) -> None:
        self.api.delete_node(node_id)
        self._types.pop(node_id, None)

    def non_terminated_nodes(self) -> List[str]:
        return self.api.list_nodes()

    def is_ready(self, node_id: str) -> bool:
        return self.api.node_state(node_id) == "READY"

    def describe_node(self, node_id: str) -> dict:
        return {"machine_type": self._types.get(node_id, "")}

    def adopt_node(self, node_id: str, data: dict) -> bool:
        """A restarted reconciler re-attaches to a VM its predecessor
        created: confirm it still exists and restore the name →
        machine_type mapping from the persisted instance record."""
        if self.api.node_state(node_id) == "ABSENT":
            return False
        machine = data.get("machine_type")
        if machine:
            self._types[node_id] = machine
        return True

    def owns_node(self, node_id: str) -> bool:
        """Leak-sweep eligibility requires an explicit cluster_name scope:
        list_nodes sees the whole project+zone, and an UNSCOPED provider
        cannot tell its own `ray-...` VMs from another cluster's
        `ray-<other>-...` — so it never claims any (leaking a VM is
        recoverable; deleting a foreign cluster's live VM is not)."""
        return bool(self.cluster_name) and node_id.startswith(
            self._name_prefix)

    def node_joined(self, node_id: str, gcs_node_ids) -> bool:
        """The VM's agent registers as ``<name>-w0`` (its startup script
        passes that --host-id), so joined-ness is a "<name>-w" prefix match
        — the separator keeps VM "gpu-1" from matching hosts of "gpu-10"."""
        return any(str(g).startswith(node_id + "-w") for g in gcs_node_ids)
