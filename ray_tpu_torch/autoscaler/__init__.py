"""The port's autoscaler: the reconciler, its persisted instance state
machine and node providers (the local follower-agent provider, the
file-backed fake and KubeRay). The reference's GCE TPU provider
(``gce_tpu``/``gce_rest``: one TPU slice per node over tpu.googleapis.com)
is left out by decision, as ``util/accelerators/tpu.py`` is (ROADMAP.md)."""

from .autoscaler import Autoscaler, NodeType
from .instance_manager import Instance, InstanceManager
from .node_provider import (FakeFileNodeProvider, LocalNodeProvider,
                            NodeProvider)

__all__ = ["Autoscaler", "NodeType", "NodeProvider", "LocalNodeProvider",
           "FakeFileNodeProvider", "Instance", "InstanceManager"]
