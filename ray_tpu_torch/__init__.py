"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's serving and training
paths.

Mirrors ray_tpu's module paths and public names (``ray_tpu_torch.ops.attention``
is the twin of ``ray_tpu.ops.attention``) so each reference module has an
obvious counterpart. Imports torch and numpy only: never jax, never ray_tpu.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no ``device=`` they raise. On a CUDA tensor a
kernel wrapper launches its hand-written Hopper kernel (``csrc/``) or raises;
only a CPU tensor takes the plain PyTorch version.
"""

import torch

from ray_tpu_torch._device import resolve_device

# the port's reference numerics are full f32: no TF32 in matmuls or convs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
