"""Param conversion from the JAX package's tree to the port's.

The two trees have the same names and layouts (models/transformer.py for
the GPT-2, Llama and Mixtral families, MoE experts included;
models/vit.py for ViT), so conversion is a leaf-wise copy onto the device
with a check of every key and shape. JAX bf16 leaves arrive as ml_dtypes
arrays, which torch cannot wrap directly; they cross as their 16-bit
pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models import transformer, vit


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):  # e.g. a bf16 leaf of a checkpoint
        return leaf.detach().clone()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))  # owned, writable


def params_from_jax(tree, cfg: transformer.TransformerConfig | vit.ViTConfig,
                    device=None, dtype: torch.dtype | None = None) -> dict:
    """Numpy-leaf param tree (e.g. ``jax.tree.map(np.asarray, params)`` or a
    checkpoint) of a transformer or ViT config → the port's params on
    `device`. `dtype` casts every leaf once (serving stores weights in
    cfg.dtype: the JAX code casts at each use, so the numbers are the
    same); None keeps the leaves' dtype."""
    device = resolve_device(device)
    shapes = (vit.param_shapes(cfg) if isinstance(cfg, vit.ViTConfig)
              else transformer.param_shapes(cfg))

    def conv(node, shape, path):
        if isinstance(shape, dict):
            if not isinstance(node, dict) or set(node) != set(shape):
                raise ValueError(f"param tree at {'/'.join(path) or '<root>'} "
                                 f"has keys {sorted(node) if isinstance(node, dict) else type(node)}, "
                                 f"expected {sorted(shape)}")
            return {k: conv(node[k], shape[k], path + (k,)) for k in shape}
        t = _to_tensor(node)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"param {'/'.join(path)} has shape "
                             f"{tuple(t.shape)}, expected {tuple(shape)}")
        return t.to(device=device, dtype=dtype or t.dtype)

    return conv(tree, shapes, ())
