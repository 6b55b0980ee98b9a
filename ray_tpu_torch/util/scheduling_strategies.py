"""Scheduling strategies for tasks and actors.

(reference: python/ray/util/scheduling_strategies.py —
PlacementGroupSchedulingStrategy:17, NodeAffinitySchedulingStrategy:43.)
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object  # PlacementGroup
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    def to_spec(self) -> dict:
        return {
            "kind": "pg",
            "pg_id": self.placement_group.id,
            "bundle": self.placement_group_bundle_index,
        }


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False

    def to_spec(self) -> dict:
        return {"kind": "node_affinity", "node_id": self.node_id, "soft": self.soft}


@dataclass
class NodeLabelSchedulingStrategy:
    """Match nodes by label equality (hard constraints only for now)."""

    hard: dict = field(default_factory=dict)

    def to_spec(self) -> dict:
        return {"kind": "node_label", "hard": dict(self.hard)}


def strategy_to_spec(strategy) -> dict | None:
    if strategy is None:
        return None
    if hasattr(strategy, "to_spec"):
        return strategy.to_spec()
    raise TypeError(f"not a scheduling strategy: {strategy!r}")
