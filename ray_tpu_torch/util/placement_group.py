"""Placement groups: atomic multi-bundle resource reservations.

(reference: python/ray/util/placement_group.py — placement_group():146,
PlacementGroup handle :42; strategies resolved by the GCS placement-group
manager, src/ray/gcs/gcs_placement_group_manager.h:50. The TPU-native
`SLICE` strategy places one bundle per node of one ICI slice, selected by
the `ray_tpu_torch.slice` node label — see _private/pg_policy.py.)
"""

from __future__ import annotations

from typing import Sequence

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.worker import ObjectRef


class PlacementGroup:
    """Handle to a (possibly pending) placement group."""

    def __init__(self, pg_id: str, bundles: list[dict] | None = None):
        self._id = pg_id
        self._bundles = bundles

    @property
    def id(self) -> str:
        return self._id

    @property
    def bundle_specs(self) -> list[dict]:
        if self._bundles is None:
            from ray_tpu_torch._private.api import _get_worker

            table = _get_worker().pg_table()
            self._bundles = table.get(self._id, {}).get("bundles", [])
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def ready(self) -> ObjectRef:
        """ObjectRef that becomes ready when the group is placed — usable with
        ray_tpu_torch.get / ray_tpu_torch.wait like the reference's pg.ready()."""
        from ray_tpu_torch._private.gcs import pg_ready_oid

        return ObjectRef(pg_ready_oid(self._id))

    def wait(self, timeout_seconds: float | None = None) -> bool:
        from ray_tpu_torch._private.api import _get_worker

        return _get_worker().pg_wait(self._id, timeout=timeout_seconds)

    def __repr__(self):
        return f"PlacementGroup({self._id[:12]}…)"

    def __reduce__(self):
        return (PlacementGroup, (self._id, self._bundles))


def placement_group(
    bundles: Sequence[dict],
    strategy: str = "PACK",
    name: str = "",
    lifetime: str | None = None,
) -> PlacementGroup:
    """Reserve `bundles` (list of resource dicts) atomically across the cluster.

    Strategies: PACK, SPREAD, STRICT_PACK, STRICT_SPREAD, and the TPU-native
    SLICE (one bundle per node of a single TPU slice).
    """
    from ray_tpu_torch._private.api import _get_worker

    from ray_tpu_torch._private.pg_policy import STRATEGIES

    if strategy not in STRATEGIES:
        raise ValueError(f"unknown placement strategy {strategy!r}; expected one of {STRATEGIES}")
    bundles = [dict(b) for b in bundles]
    pg_id = PlacementGroupID().hex()
    from ray_tpu_torch._private.task_spec import validate_pg

    validate_pg({"pg_id": pg_id, "bundles": bundles, "strategy": strategy,
                 "name": name})
    _get_worker().create_pg(pg_id, bundles, strategy, name)
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch._private.api import _get_worker

    _get_worker().remove_pg(pg.id)


def get_placement_group(name: str) -> PlacementGroup:
    from ray_tpu_torch._private.api import _get_worker

    pg_id = _get_worker().get_named_pg(name)
    if pg_id is None:
        raise ValueError(f"no placement group named {name!r}")
    return PlacementGroup(pg_id)


def placement_group_table() -> dict:
    from ray_tpu_torch._private.api import _get_worker

    return _get_worker().pg_table()
