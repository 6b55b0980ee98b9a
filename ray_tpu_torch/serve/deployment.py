"""@serve.deployment decorator → Deployment → bound Application.

(reference: python/ray/serve/api.py:333 `deployment`, serve/deployment.py
Deployment.bind; an Application is a deployment DAG — here a tree of bound
deployments whose handles are injected at deploy time.)
"""

from __future__ import annotations

import inspect
from typing import Any, Callable

from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


class Deployment:
    def __init__(self, func_or_class: Callable, name: str, config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, *, name=None, num_replicas=None, max_ongoing_requests=None,
                max_queued_requests=None,
                ray_actor_options=None, autoscaling_config=None,
                user_config=None, request_router=None,
                graceful_shutdown_timeout_s=None,
                health_check_period_s=None, health_check_timeout_s=None,
                **_ignored) -> "Deployment":
        cfg = DeploymentConfig(
            num_replicas=(self.config.num_replicas if num_replicas is None
                          else (None if num_replicas == "auto" else num_replicas)),
            max_ongoing_requests=(self.config.max_ongoing_requests
                                  if max_ongoing_requests is None else max_ongoing_requests),
            max_queued_requests=(self.config.max_queued_requests
                                 if max_queued_requests is None
                                 else max_queued_requests),
            ray_actor_options=(dict(self.config.ray_actor_options)
                               if ray_actor_options is None else ray_actor_options),
            autoscaling_config=(self.config.autoscaling_config
                                if autoscaling_config is None else
                                (AutoscalingConfig(**autoscaling_config)
                                 if isinstance(autoscaling_config, dict)
                                 else autoscaling_config)),
            user_config=self.config.user_config if user_config is None else user_config,
            request_router=(self.config.request_router if request_router is None
                            else request_router),
            graceful_shutdown_timeout_s=(
                self.config.graceful_shutdown_timeout_s
                if graceful_shutdown_timeout_s is None
                else graceful_shutdown_timeout_s),
            health_check_period_s=(self.config.health_check_period_s
                                   if health_check_period_s is None
                                   else health_check_period_s),
            health_check_timeout_s=(self.config.health_check_timeout_s
                                    if health_check_timeout_s is None
                                    else health_check_timeout_s),
        )
        if num_replicas == "auto" and cfg.autoscaling_config is None:
            cfg.autoscaling_config = AutoscalingConfig()
        return Deployment(self.func_or_class, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __repr__(self):
        return f"Deployment({self.name})"


class Application:
    """A bound deployment (possibly with other Applications among its init
    args — the deployment graph)."""

    def __init__(self, deployment: Deployment, init_args: tuple, init_kwargs: dict):
        self.deployment = deployment
        self.init_args = init_args
        self.init_kwargs = init_kwargs

    def flatten(self) -> list["Application"]:
        """Dependency-first list of all bound deployments in this graph."""
        seen: list[Application] = []

        def visit(app: Application):
            for a in list(app.init_args) + list(app.init_kwargs.values()):
                if isinstance(a, Application):
                    visit(a)
            if app not in seen:
                seen.append(app)

        visit(self)
        return seen


def deployment(func_or_class=None, *, name=None, num_replicas=1,
               max_ongoing_requests=8, max_queued_requests=-1,
               ray_actor_options=None,
               autoscaling_config=None, user_config=None,
               health_check_period_s: float = 2.0,
               health_check_timeout_s: float = 30.0,
               graceful_shutdown_timeout_s: float = 5.0,
               request_router: str = "pow2"):
    """Decorator usable bare or with options.
    (reference: serve/api.py:333.)"""

    def wrap(target):
        if not (inspect.isclass(target) or callable(target)):
            raise TypeError("@serve.deployment expects a class or function")
        cfg = DeploymentConfig(
            num_replicas=None if num_replicas == "auto" else num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            max_queued_requests=max_queued_requests,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=(AutoscalingConfig(**autoscaling_config)
                                if isinstance(autoscaling_config, dict)
                                else autoscaling_config),
            user_config=user_config,
            health_check_period_s=health_check_period_s,
            health_check_timeout_s=health_check_timeout_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            request_router=request_router,
        )
        if num_replicas == "auto" and cfg.autoscaling_config is None:
            cfg.autoscaling_config = AutoscalingConfig()
        return Deployment(target, name or target.__name__, cfg)

    if func_or_class is not None:
        return wrap(func_or_class)
    return wrap
