"""The port's autoscaler: the reconciler, its persisted instance state
machine and node providers (the local follower-agent provider, the
file-backed fake, KubeRay, and the GCE GPU provider: one Compute Engine A3
VM with its H100s per node over compute.googleapis.com). The reference's
GCE TPU provider (one TPU slice per node) is left out by decision: a TPU
slice has no GPU counterpart (ROADMAP.md)."""

from .autoscaler import Autoscaler, NodeType
from .gce_gpu import (FakeGceGpuApi, GceGpuApi, GceGpuNodeProvider,
                      gpu_vm_node_type)
from .instance_manager import Instance, InstanceManager
from .node_provider import (FakeFileNodeProvider, LocalNodeProvider,
                            NodeProvider)

__all__ = ["Autoscaler", "NodeType", "NodeProvider", "LocalNodeProvider",
           "FakeFileNodeProvider", "Instance", "InstanceManager",
           "GceGpuApi", "FakeGceGpuApi", "GceGpuNodeProvider",
           "gpu_vm_node_type"]
