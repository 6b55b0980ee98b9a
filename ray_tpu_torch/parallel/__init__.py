"""Multi-device training and serving: the twin of ray_tpu/parallel.

Explicit per-rank SPMD over a ``torch.distributed`` DeviceMesh whose
dimensions are the JAX package's six axes (mesh.py): each rank holds its
local shards, ``use_mesh`` binds the axis names for the calling thread, and
the collectives (collectives.py) are explicit, differentiable calls on an
axis' process group. ``launch`` starts a world of spawned ranks on this
host; ``dryrun`` (imported as a submodule) is the twin of
``__graft_entry__.dryrun_multichip``.
"""

from ray_tpu_torch import _device  # noqa: F401 — numerics settings first

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.launch import launch
from ray_tpu_torch.parallel.mesh import (
    AXES,
    DEFAULT_RULES,
    MESH_AXIS_DP,
    MESH_AXIS_EP,
    MESH_AXIS_FSDP,
    MESH_AXIS_PP,
    MESH_AXIS_SP,
    MESH_AXIS_TP,
    MeshSpec,
    NamedSharding,
    P,
    PartitionSpec,
    ShardingRules,
    act_sharding,
    constrain,
    current_mesh,
    hybrid_mesh,
    local_mesh_devices,
    param_shardings,
    sharding_for,
    use_mesh,
)
from ray_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from ray_tpu_torch.parallel.ring_attention import (reference_attention,
                                                   ring_attention)

__all__ = [
    "AXES",
    "DEFAULT_RULES",
    "MESH_AXIS_DP",
    "MESH_AXIS_EP",
    "MESH_AXIS_FSDP",
    "MESH_AXIS_PP",
    "MESH_AXIS_SP",
    "MESH_AXIS_TP",
    "MeshSpec",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardingRules",
    "act_sharding",
    "collectives",
    "constrain",
    "current_mesh",
    "hybrid_mesh",
    "launch",
    "local_mesh_devices",
    "param_shardings",
    "pipeline_apply",
    "reference_attention",
    "ring_attention",
    "sharding_for",
    "stack_stage_params",
    "use_mesh",
]
