"""The port's declarative Serve config against the JAX package's: schema
validation, build/deploy round trips, and fast-plane replica death.

Twins of tests/test_serve_schema.py. A config's ``import_path`` names a
module-level application: the JAX side's are the reference file's
(``tests.test_serve_schema``), the port's are defined below with the
port's ``serve``. Their callables are a lambda and classes made inside a
builder, pickled by value, so a port replica imports neither file.
"""

from __future__ import annotations

import os
import signal
import textwrap
import time

import pytest

from ray_tpu_torch import serve as tserve
from torch_twins import same, serve_of, start_sessions, stop_sessions, sub

# the port's module-level app graph the import_path can name
noop_dep = tserve.deployment(lambda req: {"ok": True})
noop_app = noop_dep.options(name="noop", num_replicas=2).bind()


def echo_builder(args: dict):
    """App-builder form: callable(args) -> Application."""
    prefix = args.get("prefix", "")

    @tserve.deployment
    class Echo:
        def __call__(self, req):
            return {"echo": prefix + str((req.get("body") or {}).get("x"))}

    return Echo.bind()


def _module(rt) -> str:
    return "tests.test_torch_serve_schema" if rt.__name__ == \
        "ray_tpu_torch" else "tests.test_serve_schema"


def _cfg(rt, text: str) -> str:
    return text.replace("tests.test_serve_schema", _module(rt))


# every twin's proxy listens on an ephemeral port: a fixed one (deploy's
# default is 8000) would be shared with the other runtime's proxy
PORT0 = "http_options:\n  host: 127.0.0.1\n  port: 0\n"

GOOD = textwrap.dedent("""
    applications:
      - name: app1
        route_prefix: /app1
        import_path: tests.test_serve_schema:noop_app
        deployments:
          - name: noop
            num_replicas: 1
            max_ongoing_requests: 4
    http_options:
      host: 127.0.0.1
      port: 0
""")


def _schema(rt):
    return sub(rt, "serve.schema")


def _both():
    import ray_tpu
    import ray_tpu_torch

    return ray_tpu, ray_tpu_torch


def _rejects(rt, text):
    """The SchemaError message of load_config(text), or None."""
    schema = _schema(rt)
    try:
        schema.load_config(_cfg(rt, text))
    except schema.SchemaError as e:
        return str(e)
    return None


def test_load_config_valid():
    def scn(rt):
        cfg = _schema(rt).load_config(_cfg(rt, GOOD))
        app = cfg.applications[0]
        return (type(cfg).__name__, app.name, app.route_prefix,
                app.deployments[0].num_replicas)

    same(_both(), scn, ("ServeDeploySchema", "app1", "/app1", 1),
         serve_cleanup=False)


@pytest.mark.parametrize("mutation, match", [
    ("applications: []", "non-empty 'applications'"),
    ("applications:\n  - name: a\n    import_path: x", "import_path"),
    (GOOD.replace("route_prefix: /app1", "route_prefix: app1"),
     "must start with"),
    (GOOD.replace("num_replicas: 1", "num_replicas: -2"), "must be >= 0"),
    (GOOD.replace("num_replicas: 1", "bogus_field: 1"), "unknown field"),
    (GOOD.replace("port: 0", "port: 0\n  tls: true"), "unknown field"),
    (GOOD + "    extra: 1", "not valid YAML|unknown field"),
])
def test_load_config_rejects(mutation, match):
    import re

    def scn(rt):
        msg = _rejects(rt, mutation)
        return msg is not None and bool(re.search(match, msg)), \
            msg.replace(_module(rt), "<module>") if msg else msg

    same(_both(), scn, serve_cleanup=False)


def test_autoscaling_and_num_replicas_exclusive():
    bad = textwrap.dedent("""
        applications:
          - name: a
            import_path: tests.test_serve_schema:noop_app
            deployments:
              - name: noop
                num_replicas: 2
                autoscaling_config:
                  min_replicas: 1
                  max_replicas: 3
    """)
    out = same(_both(), lambda rt: "mutually exclusive" in (
        _rejects(rt, bad) or ""), serve_cleanup=False)
    assert out is True


def test_duplicate_routes_rejected():
    bad = textwrap.dedent("""
        applications:
          - name: a
            route_prefix: /x
            import_path: tests.test_serve_schema:noop_app
          - name: b
            route_prefix: /x
            import_path: tests.test_serve_schema:noop_app
    """)
    out = same(_both(), lambda rt: "duplicate route_prefix" in (
        _rejects(rt, bad) or ""), serve_cleanup=False)
    assert out is True


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=8, num_workers=2, max_workers=10)
    yield pkgs
    stop_sessions(pkgs)


def test_override_unknown_deployment_rejected(pkgs):
    bad = GOOD.replace("name: noop", "name: nonexistent")

    def scn(rt):
        schema = _schema(rt)
        try:
            schema.deploy(_cfg(rt, bad))
        except schema.SchemaError as e:
            return "do not name deployments" in str(e)
        return None

    same(pkgs, scn, True)


def test_deploy_applies_config_and_serves(pkgs):
    def scn(rt):
        handles = _schema(rt).deploy(_cfg(rt, GOOD))
        # the override took: 1 replica, not the decorator's 2
        return (set(handles), handles["app1"].call_sync({}),
                serve_of(rt).status()["app1_noop"]["target"])

    same(pkgs, scn, ({"app1"}, {"ok": True}, 1))


def test_deploy_app_builder_with_args(pkgs):
    cfg = textwrap.dedent("""
        applications:
          - name: echo
            route_prefix: /echo
            import_path: tests.test_serve_schema:echo_builder
            args:
              prefix: "v:"
    """) + PORT0

    def scn(rt):
        handles = _schema(rt).deploy(_cfg(rt, cfg))
        return handles["echo"].call_sync({"body": {"x": 7}})

    same(pkgs, scn, {"echo": "v:7"})


def test_build_round_trips(pkgs):
    import importlib

    import yaml

    def scn(rt):
        schema = _schema(rt)
        mod, _, attr = f"{_module(rt)}:noop_app".partition(":")
        app = getattr(importlib.import_module(mod), attr)
        cfg_dict = schema.build(app, app_name="rt", route_prefix="/rt",
                                import_path=f"{mod}:{attr}")
        text = yaml.safe_dump(cfg_dict, sort_keys=False) + PORT0
        parsed = schema.load_config(text)
        handles = schema.deploy(text)  # a built config deploys as is
        return (parsed.applications[0].import_path.endswith("noop_app"),
                handles["rt"].call_sync({}))

    same(pkgs, scn, (True, {"ok": True}))


def test_fast_channel_replica_death_retries(pkgs):
    """SIGKILL one replica's worker: the next call_sync retries on the
    survivor instead of failing."""
    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(num_replicas=2)
        class P:
            def __call__(self, req):
                import os

                return os.getpid()

        h = serve.run(P.bind(), name="pids", route_prefix="/pids")
        pids = {h.call_sync({}) for _ in range(20)}
        both = len(pids) == 2  # both replicas serve over the fast plane
        victim = pids.pop()
        os.kill(victim, signal.SIGKILL)
        time.sleep(0.3)
        survivors = {h.call_sync({}, timeout_s=30.0) for _ in range(10)}
        return both, victim not in survivors and bool(survivors)

    same(pkgs, scn, (True, True))
