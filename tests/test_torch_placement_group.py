"""The port's placement groups, scheduling strategies and virtual-node
cluster against the JAX package's.

Twins of tests/test_placement_group.py: the pure placement policy (both
packages in turn on the same nodes), then each runtime's virtual-node
``Cluster`` (a fresh one per test on each side, as the reference's
fixture) with two accelerator nodes of one slice: the port's accelerator
resource is "GPU" (``add_node(num_gpus=)``) and its slice label
``ray_tpu_torch.slice``, where the JAX package has "TPU" and
``ray_tpu.slice``. Each scenario returns what the reference asserts.
"""

from __future__ import annotations

import time

import pytest

from torch_twins import is_port, pair, same, sub


class _N:
    def __init__(self, node_id, total, labels=None, alive=True):
        self.node_id = node_id
        self.total = dict(total)
        self.available = dict(total)
        self.labels = labels or {}
        self.alive = alive


def _accel(rt) -> str:
    return "GPU" if is_port(rt) else "TPU"


def _slice(rt) -> str:
    return sub(rt, "_private.pg_policy").SLICE_LABEL


# ---------------------------------------------------------------- pure policy


def _place(rt, nodes, bundles, strategy):
    return sub(rt, "_private.pg_policy").place_bundles(nodes, bundles,
                                                       strategy)


def test_strict_pack_single_node():
    pair(lambda rt: _place(rt, [_N("a", {"CPU": 4}), _N("b", {"CPU": 2})],
                           [{"CPU": 2}, {"CPU": 2}], "STRICT_PACK"),
         ["a", "a"])


def test_strict_pack_unplaceable():
    pair(lambda rt: _place(rt, [_N("a", {"CPU": 2}), _N("b", {"CPU": 2})],
                           [{"CPU": 2}, {"CPU": 2}], "STRICT_PACK"), None)


def test_strict_spread_needs_distinct_nodes():
    def scn(rt):
        nodes = [_N("a", {"CPU": 4})]
        one = _place(rt, nodes, [{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD")
        nodes.append(_N("b", {"CPU": 1}))
        got = _place(rt, nodes, [{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD")
        return one, got is not None and len(set(got)) == 2

    pair(scn, (None, True))


def test_pack_spills_when_one_node_cannot_hold_all():
    def scn(rt):
        got = _place(rt, [_N("a", {"CPU": 4}), _N("b", {"CPU": 4})],
                     [{"CPU": 2}] * 3, "PACK")
        return got is not None and len(got) == 3 and len(set(got)) == 2

    pair(scn, True)


def test_spread_distributes():
    def scn(rt):
        got = _place(rt, [_N("a", {"CPU": 4}), _N("b", {"CPU": 4})],
                     [{"CPU": 1}] * 4, "SPREAD")
        return got is not None and set(got) == {"a", "b"}

    pair(scn, True)


def test_slice_strategy_selects_one_slice():
    def scn(rt):
        acc, lbl = _accel(rt), _slice(rt)
        nodes = [
            _N("a", {"CPU": 4, acc: 4}, {lbl: "s0"}),
            _N("b", {"CPU": 4, acc: 4}, {lbl: "s0"}),
            _N("c", {"CPU": 4, acc: 4}, {lbl: "s1"}),
            _N("d", {"CPU": 4}),
        ]
        got = _place(rt, nodes, [{acc: 4}, {acc: 4}], "SLICE")
        return got is not None and set(got) == {"a", "b"}

    pair(scn, True)


def test_slice_strategy_skips_too_small_slices():
    def scn(rt):
        acc, lbl = _accel(rt), _slice(rt)
        nodes = [_N("a", {acc: 4}, {lbl: "s0"}),
                 _N("b", {acc: 4}, {lbl: "s1"}),
                 _N("c", {acc: 4}, {lbl: "s1"})]
        got = _place(rt, nodes, [{acc: 4}, {acc: 4}], "SLICE")
        return got is not None and set(got) == {"b", "c"}

    pair(scn, True)


def test_hybrid_prefers_local_below_threshold():
    def scn(rt):
        pick = sub(rt, "_private.pg_policy").pick_node_hybrid
        a, b = _N("a", {"CPU": 4}), _N("b", {"CPU": 4})
        first = pick([a, b], {"CPU": 1}, "a")
        a.available["CPU"] = 1.0  # 75% utilized → past threshold
        return first, pick([a, b], {"CPU": 1}, "a")

    pair(scn, ("a", "b"))


# ------------------------------------------------------------------------ e2e


@pytest.fixture
def clusters():
    """Each runtime's Cluster: a head and two accelerator nodes of slice
    s0 (the JAX package's 4 TPUs a node, the port's 4 GPUs)."""
    import ray_tpu
    import ray_tpu_torch

    pkgs = (ray_tpu, ray_tpu_torch)
    out = {}
    for rt in pkgs:
        rt.shutdown()
        c = sub(rt, "cluster_utils").Cluster(
            head_node_args=dict(num_cpus=2, num_workers=1, max_workers=8))
        accel = {"num_gpus" if is_port(rt) else "num_tpus": 4}
        for _ in range(2):
            c.add_node(num_cpus=2, labels={_slice(rt): "s0"}, **accel)
        out[rt.__name__] = c
    yield pkgs, out
    for c in out.values():
        c.shutdown()


def _util(rt):
    return sub(rt, "util")


def _strategies(rt):
    return sub(rt, "util.scheduling_strategies")


def _node_env(rt) -> str:
    return "RAY_TPU_TORCH_NODE_ID" if is_port(rt) else "RAY_TPU_NODE_ID"


def _where(rt):
    key = _node_env(rt)

    @rt.remote
    def where():
        import os

        return os.environ.get(key, "node-0")

    return where


def test_pg_e2e_place_run_remove(clusters):
    pkgs, _ = clusters

    def scn(rt):
        u, s = _util(rt), _strategies(rt)
        pg = u.placement_group([{"CPU": 1}, {"CPU": 1}],
                               strategy="STRICT_SPREAD")
        waited, ready = pg.wait(10), rt.get(pg.ready())
        where = _where(rt)
        hosts = rt.get([where.options(
            scheduling_strategy=s.PlacementGroupSchedulingStrategy(pg, i)
        ).remote() for i in range(2)])
        u.remove_placement_group(pg)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if abs(rt.available_resources().get("CPU", 0) - 6.0) < 1e-6:
                break
            time.sleep(0.05)
        return (waited, ready, len(set(hosts)),
                abs(rt.available_resources()["CPU"] - 6.0) < 1e-6)

    same(pkgs, scn, (True, True, 2, True), serve_cleanup=False)


def test_pg_slice_strategy_e2e(clusters):
    pkgs, _ = clusters

    def scn(rt):
        u, acc = _util(rt), _accel(rt)
        pg = u.placement_group([{acc: 4}, {acc: 4}], strategy="SLICE")
        waited = pg.wait(10)
        nodes = set(u.placement_group_table()[pg.id]["bundle_nodes"])
        u.remove_placement_group(pg)
        return waited, nodes

    same(pkgs, scn, (True, {"node-1", "node-2"}), serve_cleanup=False)


def test_pg_infeasible_raises(clusters):
    pkgs, _ = clusters

    def scn(rt):
        with pytest.raises(sub(rt, "exceptions")
                           .PlacementGroupUnschedulableError):
            _util(rt).placement_group([{"CPU": 100}], strategy="STRICT_PACK")
        return True

    same(pkgs, scn, True, serve_cleanup=False)


def test_pg_named_lookup(clusters):
    pkgs, _ = clusters

    def scn(rt):
        u = _util(rt)
        pg = u.placement_group([{"CPU": 1}], strategy="PACK", name="my-group")
        waited = pg.wait(10)
        same_id = u.get_placement_group("my-group").id == pg.id
        u.remove_placement_group(pg)
        return waited, same_id

    same(pkgs, scn, (True, True), serve_cleanup=False)


def test_pg_pending_until_capacity_frees(clusters):
    pkgs, _ = clusters

    def scn(rt):
        u, acc = _util(rt), _accel(rt)
        pg1 = u.placement_group([{acc: 4}, {acc: 4}],
                                strategy="STRICT_SPREAD")
        w1 = pg1.wait(10)
        pg2 = u.placement_group([{acc: 4}], strategy="PACK")
        early = pg2.wait(0.3)  # every accelerator reserved
        u.remove_placement_group(pg1)
        w2 = pg2.wait(10)
        u.remove_placement_group(pg2)
        return w1, early, w2

    same(pkgs, scn, (True, False, True), serve_cleanup=False)


def test_node_affinity_and_labels(clusters):
    pkgs, _ = clusters

    def scn(rt):
        s, where = _strategies(rt), _where(rt)
        pinned = rt.get(where.options(
            scheduling_strategy=s.NodeAffinitySchedulingStrategy("node-2")
        ).remote())
        labelled = rt.get(where.options(
            scheduling_strategy=s.NodeLabelSchedulingStrategy(
                {_slice(rt): "s0"})).remote())
        return pinned, labelled in ("node-1", "node-2")

    same(pkgs, scn, ("node-2", True), serve_cleanup=False)


def test_node_removal_reschedules_pg(clusters):
    pkgs, cl = clusters

    def scn(rt):
        u, acc = _util(rt), _accel(rt)
        pg = u.placement_group([{acc: 2}], strategy="PACK", name="resilient")
        w1 = pg.wait(10)
        placed_on = u.placement_group_table()[pg.id]["bundle_nodes"][0]
        cl[rt.__name__].remove_node(placed_on)
        w2 = pg.wait(10)
        new_node = u.placement_group_table()[pg.id]["bundle_nodes"][0]
        u.remove_placement_group(pg)
        return w1, w2, new_node != placed_on

    same(pkgs, scn, (True, True, True), serve_cleanup=False)


def test_nodes_listing(clusters):
    pkgs, _ = clusters

    def scn(rt):
        ns = rt.nodes()
        n1 = next(n for n in ns if n["node_id"] == "node-1")
        return ({n["node_id"] for n in ns}, n1["labels"][_slice(rt)],
                n1["total"][_accel(rt)])

    same(pkgs, scn, ({"node-0", "node-1", "node-2"}, "s0", 4.0),
         serve_cleanup=False)


def test_port_cluster_refuses_follower_hosts(clusters):
    """add_host/remove_host work in the port as in the JAX package: a real
    follower agent joins beside the virtual nodes, a task pinned to it runs
    there, and killing it fails its node."""
    pkgs, cl = clusters

    def scn(rt):
        c = cl[rt.__name__]
        host = c.add_host(num_cpus=1)
        key = ("RAY_TPU_TORCH_HOST_ID" if is_port(rt) else "RAY_TPU_HOST_ID")

        @rt.remote
        def where():
            import os

            return os.environ.get(key)

        on = sub(rt, "util.scheduling_strategies").NodeAffinitySchedulingStrategy
        ran = rt.get(where.options(scheduling_strategy=on(node_id=host))
                     .remote(), timeout=60)
        alive = {n["node_id"]: n["alive"] for n in rt.nodes()}
        c.remove_host(host)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(
                n["alive"] for n in rt.nodes() if n["node_id"] == host):
            time.sleep(0.1)
        return (host, ran, alive,
                {n["node_id"]: n["alive"] for n in rt.nodes()})

    host_alive = {"node-0": True, "node-1": True, "node-2": True,
                  "host-3": True}
    same(pkgs, scn, ("host-3", "host-3", host_alive,
                     {**host_alive, "host-3": False}),
         serve_cleanup=False, sequential=True)
