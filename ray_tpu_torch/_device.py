"""Device resolution: CUDA by default, the CPU only when asked for.

Every subpackage that computes (ops, models, llm, train, parallel,
benchmarks) imports this module first, so the port's numerics settings
below hold before any of its matmuls run. The runtime (``init``/``remote``
and the rest) does not import torch.
"""

from __future__ import annotations

import torch

# the port's reference numerics are full f32: no TF32 in matmuls or convs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """`None` → ``cuda`` (raises when no GPU is visible); otherwise the
    device named. Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
