"""Serve configuration schemas.

(reference: python/ray/serve/config.py — AutoscalingConfig, DeploymentConfig
pydantic models; here plain dataclasses with the same knobs.)
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class AutoscalingConfig:
    """(reference: serve/config.py AutoscalingConfig + policy in
    serve/_private/autoscaling_policy.py — desired = ceil(total ongoing /
    target_ongoing_requests), clamped, with down-scale smoothing.)"""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.0
    downscale_delay_s: float = 2.0
    metrics_interval_s: float = 0.2


@dataclass
class DeploymentConfig:
    num_replicas: int | None = 1
    max_ongoing_requests: int = 8
    # admission-queue bound: requests beyond max_ongoing wait; once the
    # wait line reaches this depth further arrivals are SHED with
    # RequestShedError (HTTP 503 + Retry-After) instead of queued. -1 =
    # unbounded (the pre-overload-control behavior). Routers also derive
    # their per-replica in-flight window from it (max_ongoing + this).
    # (reference: serve/config.py max_queued_requests)
    max_queued_requests: int = -1
    ray_actor_options: dict = field(default_factory=dict)
    autoscaling_config: AutoscalingConfig | None = None
    user_config: dict | None = None
    # active probing: the controller drives ReplicaActor.check_health every
    # period; a probe that hangs past the timeout (or fails repeatedly)
    # marks the replica unhealthy → drain-and-replace (reference:
    # serve/config.py health_check_{period,timeout}_s)
    health_check_period_s: float = 2.0
    health_check_timeout_s: float = 30.0
    graceful_shutdown_timeout_s: float = 5.0
    # "pow2" | "prefix_aware" (reference: pluggable RequestRouter —
    # request_router/pow_2_router.py, llm prefix_aware/prefix_tree.py)
    request_router: str = "pow2"

    @property
    def initial_replicas(self) -> int:
        if self.autoscaling_config is not None:
            return self.autoscaling_config.min_replicas
        return self.num_replicas or 1
