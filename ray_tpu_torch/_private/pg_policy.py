"""Bundle-placement policies for placement groups.

Pure functions: given the live nodes' free capacity (+ labels) and a bundle
list, return a per-bundle node assignment or None if unplaceable right now.

(reference: src/ray/gcs/gcs_placement_group_scheduler.h:281 +
raylet/scheduling/policy/bundle_scheduling_policy.h — STRICT_PACK / PACK /
STRICT_SPREAD / SPREAD. `SLICE`, from the JAX package: one bundle per node
of the nodes sharing one SLICE_LABEL value. The port detects no slice
labels (a TPU notion); a node carries one only when given it through
``labels=``.)
"""

from __future__ import annotations

SLICE_LABEL = "ray_tpu_torch.slice"

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD", "SLICE")


def _fits(avail: dict, res: dict) -> bool:
    """Exact comparison — both sides must share one representation (the
    GCS passes fixed-point integer units on both; see fixed_point.py).
    The old float epsilon is gone: quantization makes it unnecessary."""
    return all(avail.get(k, 0) >= v for k, v in res.items())


def _deduct(avail: dict, res: dict) -> None:
    for k, v in res.items():
        avail[k] = avail.get(k, 0.0) - v


def _sum_bundles(bundles: list[dict]) -> dict:
    out: dict[str, float] = {}
    for b in bundles:
        for k, v in b.items():
            out[k] = out.get(k, 0.0) + v
    return out


def _utilization(node) -> float:
    """Max over resources of used/total — the packing score."""
    score = 0.0
    for k, tot in node.total.items():
        if tot > 0:
            score = max(score, (tot - node.available.get(k, 0.0)) / tot)
    return score


def place_bundles(nodes: list, bundles: list[dict], strategy: str) -> list[str] | None:
    """Return [node_id per bundle] or None. Does not mutate node state."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown placement strategy {strategy!r}")
    # DRAINING nodes are alive but scheduled around: running work drains
    # off; nothing new lands (reference: GCS DrainNode semantics)
    alive = [n for n in nodes if n.alive and not getattr(n, "draining", False)]
    if not alive:
        return None

    if strategy == "STRICT_PACK":
        need = _sum_bundles(bundles)
        for n in sorted(alive, key=_utilization):
            if _fits(n.available, need):
                return [n.node_id] * len(bundles)
        return None

    if strategy == "PACK":
        # best effort: try one node first, then first-fit over nodes by utilization
        need = _sum_bundles(bundles)
        for n in sorted(alive, key=_utilization):
            if _fits(n.available, need):
                return [n.node_id] * len(bundles)
        scratch = {n.node_id: dict(n.available) for n in alive}
        order = sorted(alive, key=_utilization)
        out = []
        for b in bundles:
            for n in order:
                if _fits(scratch[n.node_id], b):
                    _deduct(scratch[n.node_id], b)
                    out.append(n.node_id)
                    break
            else:
                return None
        return out

    if strategy == "STRICT_SPREAD":
        if len(bundles) > len(alive):
            return None
        scratch = {n.node_id: dict(n.available) for n in alive}
        used: set[str] = set()
        out = []
        for b in bundles:
            for n in sorted(alive, key=_utilization):
                if n.node_id not in used and _fits(scratch[n.node_id], b):
                    used.add(n.node_id)
                    out.append(n.node_id)
                    break
            else:
                return None
        return out

    if strategy == "SPREAD":
        scratch = {n.node_id: dict(n.available) for n in alive}
        loads = {n.node_id: _utilization(n) for n in alive}
        out = []
        for b in bundles:
            cands = sorted(alive, key=lambda n: (loads[n.node_id], n.node_id))
            for n in cands:
                if _fits(scratch[n.node_id], b):
                    _deduct(scratch[n.node_id], b)
                    loads[n.node_id] += 0.1  # nudge round-robin
                    out.append(n.node_id)
                    break
            else:
                return None
        return out

    # SLICE: one bundle per node, all nodes sharing one slice label value
    slices: dict[str, list] = {}
    for n in alive:
        lbl = n.labels.get(SLICE_LABEL)
        if lbl is not None:
            slices.setdefault(lbl, []).append(n)
    for lbl in sorted(slices):
        members = slices[lbl]
        if len(members) < len(bundles):
            continue
        scratch = {n.node_id: dict(n.available) for n in members}
        used: set[str] = set()
        out = []
        for b in bundles:
            for n in sorted(members, key=lambda n: n.node_id):
                if n.node_id not in used and _fits(scratch[n.node_id], b):
                    used.add(n.node_id)
                    _deduct(scratch[n.node_id], b)
                    out.append(n.node_id)
                    break
            else:
                break
        if len(out) == len(bundles):
            return out
    return None


def pick_node_hybrid(nodes: list, res: dict, local_node_id: str | None,
                     threshold: float | None = None) -> str | None:
    """Hybrid pack/spread for ordinary tasks: prefer the local node, pack onto
    low-utilization nodes until the threshold, then least-utilized first.
    (reference: raylet/scheduling/policy/scheduling_policy.h:66)"""
    if threshold is None:
        from ray_tpu_torch._private.ray_config import RayConfig

        threshold = RayConfig.instance().hybrid_threshold
    alive = [n for n in nodes if n.alive and not getattr(n, "draining", False)]
    ordered = sorted(alive, key=lambda n: (n.node_id != local_node_id, n.node_id))
    for n in ordered:
        if _utilization(n) < threshold and _fits(n.available, res):
            return n.node_id
    fallback = sorted(alive, key=_utilization)
    for n in fallback:
        if _fits(n.available, res):
            return n.node_id
    return None
