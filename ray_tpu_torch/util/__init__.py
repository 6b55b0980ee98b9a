"""ray_tpu_torch.util — placement groups, scheduling strategies, the state
API, ActorPool, metrics and tracing (the port's copies of ray_tpu.util's
runtime utilities)."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util import scheduling_strategies, state
from ray_tpu_torch.util.actor_pool import ActorPool

__all__ = [
    "ActorPool",
    "PlacementGroup",
    "get_placement_group",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
    "scheduling_strategies",
    "state",
]
