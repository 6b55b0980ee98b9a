"""Declarative Serve config: the production deployment interface.

(reference: python/ray/serve/schema.py:504 DeploymentSchema, :755
ServeApplicationSchema / ServeDeploySchema — pydantic models consumed by
`serve build` / `serve deploy`; applications name an import_path whose
attribute is a bound Application, plus per-deployment config overrides.
Here: dataclass schemas with explicit validation — same YAML/JSON shape,
errors at parse time with the offending path spelled out.)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any


class SchemaError(ValueError):
    """Config file rejected; message carries the YAML path of the issue."""


_AUTOSCALE_KEYS = {"min_replicas", "max_replicas", "target_ongoing_requests",
                   "upscale_delay_s", "downscale_delay_s",
                   "metrics_interval_s"}
_DEPLOYMENT_KEYS = {"name", "num_replicas", "max_ongoing_requests",
                    "ray_actor_options", "autoscaling_config", "user_config",
                    "graceful_shutdown_timeout_s", "request_router"}
_APP_KEYS = {"name", "route_prefix", "import_path", "args", "deployments"}
_ROOT_KEYS = {"applications", "http_options", "proxy_location"}
_HTTP_KEYS = {"host", "port", "num_proxies"}


def _require(cond: bool, where: str, msg: str) -> None:
    if not cond:
        raise SchemaError(f"{where}: {msg}")


def _check_keys(d: dict, allowed: set, where: str) -> None:
    unknown = set(d) - allowed
    _require(not unknown, where,
             f"unknown field(s) {sorted(unknown)} (allowed: {sorted(allowed)})")


def _check_num(v: Any, where: str, *, integer: bool = False,
               minimum: float | None = None) -> None:
    ok = isinstance(v, int) if integer else isinstance(v, (int, float))
    ok = ok and not isinstance(v, bool)
    _require(ok, where, f"must be a{'n integer' if integer else ' number'}, "
             f"got {type(v).__name__}")
    if minimum is not None:
        _require(v >= minimum, where, f"must be >= {minimum}, got {v}")


@dataclasses.dataclass
class DeploymentSchema:
    """Per-deployment override block (reference: serve/schema.py:504)."""

    name: str
    num_replicas: int | None = None
    max_ongoing_requests: int | None = None
    ray_actor_options: dict | None = None
    autoscaling_config: dict | None = None
    user_config: dict | None = None
    graceful_shutdown_timeout_s: float | None = None
    request_router: str | None = None

    @classmethod
    def parse(cls, d: Any, where: str) -> "DeploymentSchema":
        _require(isinstance(d, dict), where, "must be a mapping")
        _check_keys(d, _DEPLOYMENT_KEYS, where)
        _require(isinstance(d.get("name"), str) and d.get("name"),
                 where, "needs a non-empty 'name'")
        if d.get("num_replicas") is not None:
            _check_num(d["num_replicas"], f"{where}.num_replicas",
                       integer=True, minimum=0)
        if d.get("max_ongoing_requests") is not None:
            _check_num(d["max_ongoing_requests"],
                       f"{where}.max_ongoing_requests", integer=True,
                       minimum=1)
        if d.get("graceful_shutdown_timeout_s") is not None:
            _check_num(d["graceful_shutdown_timeout_s"],
                       f"{where}.graceful_shutdown_timeout_s", minimum=0)
        if d.get("request_router") is not None:
            _require(d["request_router"] in ("pow2", "prefix_aware"),
                     f"{where}.request_router",
                     f"must be 'pow2' or 'prefix_aware', got "
                     f"{d['request_router']!r}")
        for k in ("ray_actor_options", "user_config"):
            if d.get(k) is not None:
                _require(isinstance(d[k], dict), f"{where}.{k}",
                         "must be a mapping")
        ac = d.get("autoscaling_config")
        if ac is not None:
            _require(isinstance(ac, dict), f"{where}.autoscaling_config",
                     "must be a mapping")
            _check_keys(ac, _AUTOSCALE_KEYS, f"{where}.autoscaling_config")
            for k in ("min_replicas", "max_replicas"):
                if k in ac:
                    _check_num(ac[k], f"{where}.autoscaling_config.{k}",
                               integer=True, minimum=0)
            if "min_replicas" in ac and "max_replicas" in ac:
                _require(ac["min_replicas"] <= ac["max_replicas"],
                         f"{where}.autoscaling_config",
                         "min_replicas must be <= max_replicas")
            _require(d.get("num_replicas") is None, where,
                     "num_replicas and autoscaling_config are mutually "
                     "exclusive")
        return cls(**{k: d.get(k) for k in _DEPLOYMENT_KEYS if k in d})


@dataclasses.dataclass
class ServeApplicationSchema:
    """(reference: serve/schema.py:755 — one application: import_path to a
    bound Application (module:attr), route, per-deployment overrides.)"""

    import_path: str
    name: str = "default"
    route_prefix: str | None = "/"
    args: dict = dataclasses.field(default_factory=dict)
    deployments: list[DeploymentSchema] = dataclasses.field(
        default_factory=list)

    @classmethod
    def parse(cls, d: Any, where: str) -> "ServeApplicationSchema":
        _require(isinstance(d, dict), where, "must be a mapping")
        _check_keys(d, _APP_KEYS, where)
        ip = d.get("import_path")
        _require(isinstance(ip, str) and (":" in ip or "." in ip), where,
                 "needs an import_path of the form 'module:attribute'")
        name = d.get("name", "default")
        _require(isinstance(name, str) and name, f"{where}.name",
                 "must be a non-empty string")
        rp = d.get("route_prefix", "/")
        if rp is not None:
            _require(isinstance(rp, str) and rp.startswith("/"),
                     f"{where}.route_prefix", "must start with '/'")
        args = d.get("args") or {}
        _require(isinstance(args, dict), f"{where}.args", "must be a mapping")
        deps = []
        for i, dep in enumerate(d.get("deployments") or []):
            deps.append(DeploymentSchema.parse(
                dep, f"{where}.deployments[{i}]"))
        names = [x.name for x in deps]
        _require(len(names) == len(set(names)), f"{where}.deployments",
                 "duplicate deployment names")
        return cls(import_path=ip, name=name, route_prefix=rp, args=args,
                   deployments=deps)

    def resolve_target(self):
        """Import the bound Application the import_path names. 'mod:attr'
        or dotted 'mod.attr'; a callable attr is invoked with `args` as an
        app builder (reference: serve/_private/api.py build-from-import)."""
        from ray_tpu_torch.serve.deployment import Application

        path = self.import_path
        if ":" in path:
            mod_name, attr = path.split(":", 1)
        else:
            mod_name, _, attr = path.rpartition(".")
        try:
            mod = importlib.import_module(mod_name)
        except ImportError as e:
            raise SchemaError(
                f"applications[{self.name}].import_path: cannot import "
                f"module {mod_name!r}: {e}") from e
        try:
            target = getattr(mod, attr)
        except AttributeError as e:
            raise SchemaError(
                f"applications[{self.name}].import_path: module "
                f"{mod_name!r} has no attribute {attr!r}") from e
        if callable(target) and not isinstance(target, Application):
            target = target(self.args)  # app builder function
        if not isinstance(target, Application):
            raise SchemaError(
                f"applications[{self.name}].import_path: {path!r} is not a "
                f"bound Application (got {type(target).__name__})")
        return target


@dataclasses.dataclass
class ServeDeploySchema:
    """Root config for `serve deploy` (reference: serve/schema.py
    ServeDeploySchema — applications + http_options)."""

    applications: list[ServeApplicationSchema]
    http_options: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, d: Any) -> "ServeDeploySchema":
        _require(isinstance(d, dict), "config", "must be a mapping")
        _check_keys(d, _ROOT_KEYS, "config")
        apps_raw = d.get("applications")
        _require(isinstance(apps_raw, list) and apps_raw, "config",
                 "needs a non-empty 'applications' list")
        apps = [ServeApplicationSchema.parse(a, f"applications[{i}]")
                for i, a in enumerate(apps_raw)]
        names = [a.name for a in apps]
        _require(len(names) == len(set(names)), "applications",
                 "duplicate application names")
        routes = [a.route_prefix for a in apps if a.route_prefix]
        _require(len(routes) == len(set(routes)), "applications",
                 "duplicate route_prefix values")
        http = d.get("http_options") or {}
        _require(isinstance(http, dict), "config.http_options",
                 "must be a mapping")
        _check_keys(http, _HTTP_KEYS, "config.http_options")
        if "port" in http:
            _check_num(http["port"], "config.http_options.port",
                       integer=True, minimum=0)
        if "num_proxies" in http:
            # 0 = the legacy single in-driver proxy; >= 1 = the sharded
            # proxy plane with that many SO_REUSEPORT workers
            _check_num(http["num_proxies"], "config.http_options.num_proxies",
                       integer=True, minimum=0)
        return cls(applications=apps, http_options=http)


def load_config(path_or_text: str) -> ServeDeploySchema:
    """Parse + validate a YAML (or JSON — a YAML subset) config file or
    literal text."""
    import os

    import yaml

    text = path_or_text
    if os.path.exists(path_or_text):
        with open(path_or_text) as f:
            text = f.read()
    try:
        raw = yaml.safe_load(text)
    except yaml.YAMLError as e:
        raise SchemaError(f"config is not valid YAML: {e}") from e
    return ServeDeploySchema.parse(raw)


def _apply_overrides(app_target, overrides: list[DeploymentSchema],
                     app_name: str):
    """Rebind deployments in the imported app graph with the config's
    overrides (reference: deployments listed in the schema override the
    decorator's options — serve/_private/deploy_utils.py)."""
    by_name = {o.name: o for o in overrides}
    known = set()

    for node in app_target.flatten():
        d = node.deployment
        known.add(d.name)
        o = by_name.get(d.name)
        if o is None:
            continue
        opts = {}
        if o.num_replicas is not None:
            opts["num_replicas"] = o.num_replicas
        if o.max_ongoing_requests is not None:
            opts["max_ongoing_requests"] = o.max_ongoing_requests
        if o.ray_actor_options is not None:
            opts["ray_actor_options"] = o.ray_actor_options
        if o.user_config is not None:
            opts["user_config"] = o.user_config
        if o.autoscaling_config is not None:
            opts["autoscaling_config"] = o.autoscaling_config
        if o.graceful_shutdown_timeout_s is not None:
            opts["graceful_shutdown_timeout_s"] = o.graceful_shutdown_timeout_s
        if o.request_router is not None:
            opts["request_router"] = o.request_router
        node.deployment = d.options(**opts)
    missing = set(by_name) - known
    if missing:
        raise SchemaError(
            f"applications[{app_name}].deployments: {sorted(missing)} do "
            f"not name deployments in the application graph "
            f"(graph has: {sorted(known)})")
    return app_target


def deploy(config: "ServeDeploySchema | str", *, _blocking: bool = False):
    """Apply a validated config: import each application, apply overrides,
    serve.run it, and start the HTTP proxy per http_options.
    (reference: `serve deploy` → ServeDeploySchema applied by the
    controller; serve/scripts.py deploy.)"""
    from ray_tpu_torch.serve import api

    if isinstance(config, str):
        config = load_config(config)
    http = config.http_options
    api.start(http_host=http.get("host", "127.0.0.1"),
              http_port=http.get("port", 8000),
              num_proxies=http.get("num_proxies"))
    handles = {}
    for app in config.applications:
        target = _apply_overrides(app.resolve_target(), app.deployments,
                                  app.name)
        handles[app.name] = api.run(target, name=app.name,
                                    route_prefix=app.route_prefix)
    return handles


def build(target, *, app_name: str = "default",
          route_prefix: str | None = "/", import_path: str = "") -> dict:
    """Emit the declarative config dict for a bound Application — the
    inverse of deploy (reference: `serve build` writes the schema YAML for
    a running app graph; serve/scripts.py build)."""
    from ray_tpu_torch.serve.deployment import Application

    if not isinstance(target, Application):
        raise TypeError("serve build expects a bound deployment")
    deps = []
    for node in target.flatten():
        cfg = node.deployment.config
        entry: dict = {"name": node.deployment.name}
        if cfg.autoscaling_config is not None:
            entry["autoscaling_config"] = dataclasses.asdict(
                cfg.autoscaling_config)
        else:
            entry["num_replicas"] = cfg.initial_replicas
        entry["max_ongoing_requests"] = cfg.max_ongoing_requests
        if cfg.ray_actor_options:
            entry["ray_actor_options"] = cfg.ray_actor_options
        if cfg.user_config is not None:
            entry["user_config"] = cfg.user_config
        if cfg.request_router != "pow2":
            entry["request_router"] = cfg.request_router
        deps.append(entry)
    return {
        "applications": [{
            "name": app_name,
            "route_prefix": route_prefix,
            "import_path": import_path or "<module>:<attribute>",
            "deployments": deps,
        }],
    }
