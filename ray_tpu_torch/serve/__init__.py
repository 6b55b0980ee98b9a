"""ray_tpu_torch.serve — model serving.

The port's copy of ray_tpu/serve over the port's runtime: the same module
paths, public names and wire shapes. Its own names: ``RAY_TPU_TORCH_SERVE_*``
config flags, the controller and proxies in the ``_system`` namespace of the
port's GCS, routing segments ``/dev/shm/rtpt_routes_*``. A replica's
accelerator is the GPU: ``ray_actor_options={"num_gpus": 1}`` grants it one
through ``CUDA_VISIBLE_DEVICES``. ``serve.start`` listens on port 8000
unless given ``http_port``; pass ``http_port=0`` where the JAX package's
Serve may run on the same host.

(reference: python/ray/serve/ — deployments + controller-reconciled replica
actors, DeploymentHandles with power-of-two routing, per-node HTTP proxy,
ongoing-request autoscaling, dynamic batching, model multiplexing.)
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    http_address,
    proxy_status,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle, DeploymentResponse
from ray_tpu_torch.serve.multiplex import multiplexed
from ray_tpu_torch.serve.replica import get_multiplexed_model_id
from ray_tpu_torch.serve.rpc_ingress import RPCClient, start_rpc_ingress
from ray_tpu_torch.serve.schema import (SchemaError, ServeDeploySchema, build,
                                        deploy, load_config)

__all__ = [
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentConfig",
    "DeploymentHandle",
    "DeploymentResponse",
    "batch",
    "delete",
    "deployment",
    "get_app_handle",
    "get_deployment_handle",
    "get_multiplexed_model_id",
    "http_address",
    "multiplexed",
    "proxy_status",
    "run",
    "shutdown",
    "start",
    "start_rpc_ingress",
    "RPCClient",
    "SchemaError",
    "ServeDeploySchema",
    "build",
    "deploy",
    "load_config",
    "status",
]
