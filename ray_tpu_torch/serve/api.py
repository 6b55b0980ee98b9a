"""serve public API: run / delete / status / shutdown / handles / proxy.

(reference: python/ray/serve/api.py — serve.run:694 deploys an Application
through the controller and returns the ingress DeploymentHandle; serve.start
brings up the proxy; serve.status/delete/shutdown manage lifecycle.)
"""

from __future__ import annotations

import dataclasses
import time

import ray_tpu_torch
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.deployment import Application
from ray_tpu_torch.serve.handle import DeploymentHandle

_proxy = None
_proxy_plane_addr = None  # (host, port) of the sharded ingress, when up


def _get_controller(create: bool = False):
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace="_system")
    except ValueError:
        if not create:
            raise RuntimeError("serve is not running; call serve.run/start first") from None
    # create path. The name may transiently be held by a DYING controller
    # (a concurrent serve.shutdown's kill not yet tombstoned) or won by a
    # concurrent creator — loop resolve→create with backoff so both the
    # "now tombstoned: create again" and "other creator won: resolve it"
    # transitions succeed instead of failing the caller.
    deadline = time.monotonic() + 10.0
    backoff = 0.05
    while True:
        try:
            # crash-restartable control plane: the GCS restarts the
            # controller in place (same actor id, name kept) and its
            # __init__ rebuilds from the persisted serve table; in-flight
            # calls retry on the restarted incarnation (mutations are
            # idempotent — deploys compare blobs, persists are upserts)
            return ServeController.options(
                name=CONTROLLER_NAME, namespace="_system", num_cpus=0.5,
                max_restarts=-1, max_task_retries=-1).remote()
        except ValueError as e:
            # only a NAME conflict is retryable (dying actor or a creation
            # race); any other GCS rejection must surface, not be retried
            # into a misleading "name stayed held" timeout
            if "already exists" not in str(e):
                raise
        try:
            return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace="_system")
        except ValueError:
            pass  # tombstoned between the two attempts: create next pass
        if time.monotonic() >= deadline:
            raise RuntimeError(
                "could not create or resolve the serve controller "
                f"(the name {CONTROLLER_NAME!r} stayed held)")
        time.sleep(backoff)
        backoff = min(backoff * 2, 0.5)


def _resolve_controller(timeout_s: float = 5.0):
    """Re-resolve the controller by name with retry/backoff (reference:
    serve clients look the controller up by name rather than caching a
    dead handle). Used by routers/proxies healing after a controller death
    and by creation races."""
    deadline = time.monotonic() + timeout_s
    backoff = 0.05
    while True:
        try:
            return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace="_system")
        except ValueError:
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "serve is not running; call serve.run/start first") from None
            time.sleep(backoff)
            backoff = min(backoff * 2, 0.5)


def start(*, http_host: str = "127.0.0.1", http_port: int = 8000,
          proxy: bool = True, num_proxies: int | None = None):
    """Ensure controller (and optionally the HTTP ingress) are up.

    ``num_proxies`` selects the ingress topology: 0 (the default, via
    `RayConfig.serve_num_proxies`) keeps the original single in-driver
    ProxyActor; >= 1 starts the controller-managed sharded proxy plane —
    N workers accepting on ONE port (SO_REUSEPORT, or fd-passed acceptor
    where unavailable), routing from the controller's shm routing-table
    broadcast."""
    global _proxy, _proxy_plane_addr
    from ray_tpu_torch._private.ray_config import RayConfig

    controller = _get_controller(create=True)
    if num_proxies is None:
        num_proxies = RayConfig.instance().serve_num_proxies
    if not proxy:
        return controller
    if num_proxies and num_proxies > 0:
        if _proxy_plane_addr is None:
            st = ray_tpu_torch.get(controller.start_proxy_plane.remote(
                http_host, http_port, int(num_proxies)), timeout=60.0)
            _proxy_plane_addr = (st["host"], st["port"])
            # wait until at least one shard is accepting: callers (and
            # every existing test idiom) expect start() to return a
            # connectable ingress
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                st = ray_tpu_torch.get(controller.proxy_status.remote())
                if st and any(s.get("state") == "running"
                              for s in st["shards"].values()):
                    break
                time.sleep(0.05)
    elif _proxy is None:
        from ray_tpu_torch.serve.proxy import ProxyActor

        _proxy = ProxyActor.options(num_cpus=0.5, max_concurrency=32).remote(
            http_host, http_port)
        ray_tpu_torch.get(_proxy.address.remote())  # wait until listening
    return controller


def run(target: Application, *, name: str = "default",
        route_prefix: str | None = "/", _blocking: bool = False,
        proxy: bool = False) -> DeploymentHandle:
    """Deploy an application; returns a handle to its ingress deployment."""
    from ray_tpu_torch._private import serialization as ser

    if not isinstance(target, Application):
        raise TypeError("serve.run expects a bound deployment: d.bind(...)")
    controller = start(proxy=proxy) if proxy else _get_controller(create=True)

    apps = target.flatten()
    specs = []
    for app in apps:
        # replace nested Applications in init args with handles to them
        def to_handle(a):
            if isinstance(a, Application):
                return DeploymentHandle(f"{name}_{a.deployment.name}", controller)
            return a

        args = tuple(to_handle(a) for a in app.init_args)
        kwargs = {k: to_handle(v) for k, v in app.init_kwargs.items()}
        cfg = app.deployment.config
        cfg_dict = {
            "initial_replicas": cfg.initial_replicas,
            "max_ongoing_requests": cfg.max_ongoing_requests,
            "max_queued_requests": cfg.max_queued_requests,
            "ray_actor_options": cfg.ray_actor_options,
            "user_config": cfg.user_config,
            "autoscaling_config": (dataclasses.asdict(cfg.autoscaling_config)
                                   if cfg.autoscaling_config else None),
            "request_router": cfg.request_router,
            "health_check_period_s": cfg.health_check_period_s,
            "health_check_timeout_s": cfg.health_check_timeout_s,
            "graceful_shutdown_timeout_s": cfg.graceful_shutdown_timeout_s,
        }
        specs.append({
            "name": app.deployment.name,
            "callable_blob": ser.dumps(app.deployment.func_or_class),
            "init_args_blob": ser.dumps((args, kwargs)),
            "config": cfg_dict,
        })
    ingress = target.deployment.name
    ray_tpu_torch.get(controller.deploy_application.remote(name, specs, route_prefix, ingress))
    handle = DeploymentHandle(f"{name}_{ingress}", controller)
    return handle


def get_app_handle(name: str = "default") -> DeploymentHandle:
    controller = _get_controller()
    table = ray_tpu_torch.get(controller.get_routing_table.remote(-1))
    ingress = table.get("apps", {}).get(name)
    if ingress is None:
        raise ValueError(f"no application named {name!r}")
    return DeploymentHandle(ingress, controller)


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(f"{app_name}_{deployment_name}", _get_controller())


def status() -> dict:
    return ray_tpu_torch.get(_get_controller().status.remote())


def delete(name: str = "default"):
    ray_tpu_torch.get(_get_controller().delete_application.remote(name))


def http_address() -> tuple[str, int] | None:
    if _proxy_plane_addr is not None:
        return tuple(_proxy_plane_addr)
    if _proxy is None:
        return None
    return tuple(ray_tpu_torch.get(_proxy.address.remote()))


def proxy_status() -> dict | None:
    """Sharded proxy plane status (shard states/health), or None when the
    plane isn't running."""
    return ray_tpu_torch.get(_get_controller().proxy_status.remote())


def shutdown():
    global _proxy, _proxy_plane_addr
    _proxy_plane_addr = None  # plane teardown rides controller.shutdown
    try:
        controller = _get_controller()
    except RuntimeError:
        controller = None
    if _proxy is not None:
        try:
            ray_tpu_torch.get(_proxy.shutdown.remote())
            ray_tpu_torch.kill(_proxy)
        except Exception:
            pass
        _proxy = None
    if controller is not None:
        try:
            ray_tpu_torch.get(controller.shutdown.remote())
            ray_tpu_torch.kill(controller)
        except Exception:
            pass
        # wait until the controller actor is actually DEAD (not merely
        # kill-requested): a next serve.run in this session must either
        # find no actor under the name (→ create) or a live one — never a
        # dying one whose in-flight deploys die with it
        from ray_tpu_torch._private.api import _get_worker

        w = _get_worker()
        if hasattr(w, "rpc"):
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                try:
                    info = w.rpc({"type": "actor_info",
                                  "aid": controller.actor_id})
                except Exception:  # noqa: BLE001
                    break
                if not info.get("found") or info.get("state") == "dead":
                    break
                time.sleep(0.05)
