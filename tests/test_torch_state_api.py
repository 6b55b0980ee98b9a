"""Twins of tests/test_state_api.py: the programmatic state API, the
timeline file export, namespaces and the runtime context, in each package.

One module-scoped session per package, prepared as the reference's
fixture prepares its cluster (a named actor, six tasks, a placement
group); each test runs its scenario through ``ray_tpu`` and
``ray_tpu_torch`` and the two sides agree. The compiled-DAG plane's
registry rows (`list_compiled_dags`) are read in
tests/test_torch_dag_observability.py. The driver holds no accelerator:
`{"TPU": []}` in the JAX package is `{"GPU": []}` in the port.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from functools import partial

import pytest

from torch_twins import (is_port, shutdown_runtimes, start_sessions, sub,
                         twin)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_twin = partial(twin, serve_cleanup=False)


def _same(pkgs, scenario, want=None, **kw):
    a, b = _twin(pkgs, scenario, **kw)
    assert a == b, (a, b)
    if want is not None:
        assert a == want, a
    return a


def _prepare(rt):
    @rt.remote
    class Svc:
        def ping(self):
            return "pong"

    @rt.remote
    def work(i):
        return i * 3

    svc = Svc.options(name="state-svc").remote()
    assert rt.get(svc.ping.remote()) == "pong"
    assert rt.get([work.remote(i) for i in range(6)]) == [0, 3, 6, 9, 12, 15]
    pg = sub(rt, "util").placement_group([{"CPU": 1}], strategy="PACK")
    rt.get(pg.ready(), timeout=30)
    return svc


@pytest.fixture(scope="module")
def pkgs():
    out = start_sessions(num_cpus=16, num_workers=2, max_workers=10)
    _twin(out, _prepare)
    yield out
    shutdown_runtimes(out)


def _state(rt):
    return sub(rt, "util.state")


def _scn_nodes_workers(rt):
    state = _state(rt)
    ns = state.list_nodes()
    ws = state.list_workers()
    live = state.list_workers(filters=[("dead", "=", "False")])
    return (bool(ns) and all("node_id" in n for n in ns), len(ws) >= 2,
            bool(live) and all(str(w["dead"]) == "False" for w in live))


def test_list_nodes_workers(pkgs):
    _same(pkgs, _scn_nodes_workers, (True, True, True))


def _scn_actors_and_filters(rt):
    state = _state(rt)
    rows = state.list_actors()
    alive = state.list_actors(filters=[("state", "=", "alive")])
    none = state.list_actors(filters=[("state", "=", "no-such-state")])
    try:
        state.list_actors(filters=[("state", ">", "x")])
        bad = None
    except ValueError as e:
        bad = "filter op" in str(e)
    return (any(a.get("name") == "state-svc" for a in rows),
            bool(alive) and all(a["state"] == "alive" for a in alive),
            none, bad)


def test_list_actors_and_filters(pkgs):
    _same(pkgs, _scn_actors_and_filters, (True, True, [], True))


def _scn_get_actor_by_id(rt):
    state = _state(rt)
    row = state.list_actors(filters=[("name", "=", "state-svc")])[0]
    got = state.get_actor(row["actor_id"])
    return got is not None and got["name"], state.get_actor("nope")


def test_get_actor_by_id(pkgs):
    _same(pkgs, _scn_get_actor_by_id, ("state-svc", None))


def _scn_placement_groups(rt):
    rows = _state(rt).list_placement_groups()
    return bool(rows) and all("placement_group_id" in r for r in rows)


def test_list_placement_groups(pkgs):
    _same(pkgs, _scn_placement_groups, True)


def _scn_tasks_and_summary(rt):
    state = _state(rt)
    deadline = time.time() + 15
    rows = []
    while time.time() < deadline:
        rows = state.list_tasks(filters=[("name", "=", "work")])
        if len(rows) >= 6:
            break
        time.sleep(0.5)
    summary = state.summarize_tasks()
    return len(rows) >= 6, summary["work"]["count"] >= 6, \
        summary["work"]["failed"]


def test_tasks_and_summary(pkgs):
    _same(pkgs, _scn_tasks_and_summary, (True, True, 0))


def _scn_objects_and_limit(rt):
    blob = rt.put(b"y" * 150_000)
    rows = _state(rt).list_objects(limit=5)
    del blob
    return len(rows) <= 5


def test_list_objects_and_limit(pkgs):
    _same(pkgs, _scn_objects_and_limit, True)


def test_timeline_file_export(pkgs, tmp_path):
    def scn(rt):
        out = str(tmp_path / f"tl_{rt.__name__}.json")
        events = rt.timeline(out)
        with open(out) as f:
            doc = json.load(f)
        return isinstance(events, list), "traceEvents" in doc

    _same(pkgs, scn, (True, True))


_SECOND_DRIVER = """
import {pkg} as rt
rt.init(address={addr!r}, namespace="other")

@rt.remote
class Svc:
    def who(self):
        return "ns-other"

a = Svc.options(name="scoped").remote()
assert rt.get(a.who.remote(), timeout=60) == "ns-other"
mine = rt.get_actor("scoped")  # resolves in MY namespace
assert rt.get(mine.who.remote(), timeout=60) == "ns-other"
theirs = rt.get_actor("scoped", namespace="default")
assert rt.get(theirs.who.remote(), timeout=60) == "ns-default"

# nested creation: a TASK submitted by this driver creates a named actor
# and it must land in THIS driver's namespace (the spec carries caller_ns)
@rt.remote
def make_named():
    @rt.remote
    class Inner:
        def tag(self):
            return "inner-other"
    Inner.options(name="nested").remote().__ray_ready__()
    return "made"

assert rt.get(make_named.remote(), timeout=60) == "made"
inner = rt.get_actor("nested")  # same namespace as this driver
assert rt.get(inner.tag.remote(), timeout=60) == "inner-other"
print("OK")
"""


def _scn_namespaces(rt):
    api = sub(rt, "_private.api")

    @rt.remote
    class Svc:
        def who(self):
            return "ns-default"

    rt.get(Svc.options(name="scoped").remote().who.remote())
    found = rt.get_actor("scoped") is not None
    try:
        rt.get_actor("scoped", namespace="other")
        other = None
    except ValueError as e:
        other = "namespace 'other'" in str(e)
    # a second driver in namespace "other" reuses the name, and reaches the
    # first driver's actor only by naming its namespace
    script = _SECOND_DRIVER.format(pkg=rt.__name__, addr=api._node.address)
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=180, cwd=REPO,
                       env={**os.environ, "PYTHONPATH": REPO})
    return found, other, "OK" in r.stdout or r.stderr[-800:]


def test_namespaces_scope_named_actors(pkgs):
    """The same name in different namespaces coexists; get_actor resolves
    in the caller's namespace unless one is given."""
    _same(pkgs, _scn_namespaces, (True, True, True))


def _scn_runtime_context(rt):
    ctx = rt.get_runtime_context()
    driver = (bool(ctx.get_worker_id()), bool(ctx.get_node_id()),
              ctx.namespace, ctx.get_accelerator_ids())

    @rt.remote
    def probe():
        c = rt.get_runtime_context()
        return {"task_id": c.get_task_id(), "worker_id": c.get_worker_id(),
                "ns": c.namespace, "actor_id": c.get_actor_id()}

    got = rt.get(probe.remote())

    @rt.remote
    class A:
        def who(self):
            return rt.get_runtime_context().get_actor_id()

    a = A.remote()
    try:
        return driver, (bool(got["task_id"]), bool(got["worker_id"]),
                        got["actor_id"], got["ns"]), \
            bool(rt.get(a.who.remote()))
    finally:
        rt.kill(a)


def test_runtime_context_surface(pkgs):
    """ids, namespace and accelerators from the driver and from inside
    tasks and actors (reference: ray.get_runtime_context())."""
    ref, port = _twin(pkgs, _scn_runtime_context)
    for side, acc in ((ref, "TPU"), (port, "GPU")):
        assert side == ((True, True, "default", {acc: []}),
                        (True, True, None, "default"), True), side
    assert is_port(pkgs[1])


def _scn_runtime_context_pg_id(rt):
    pg = sub(rt, "util").placement_group([{"CPU": 1}], strategy="PACK")
    rt.get(pg.ready(), timeout=30)
    PGS = sub(rt, "util.scheduling_strategies").PlacementGroupSchedulingStrategy

    @rt.remote
    def where():
        return rt.get_runtime_context().get_placement_group_id()

    inside = rt.get(where.options(scheduling_strategy=PGS(
        placement_group=pg)).remote())
    return inside == pg.id, rt.get(where.remote())


def test_runtime_context_pg_id(pkgs):
    _same(pkgs, _scn_runtime_context_pg_id, (True, None))
