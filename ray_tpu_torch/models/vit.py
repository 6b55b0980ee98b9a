"""Vision Transformer, the twin of ray_tpu/models/vit.py.

Pre-norm encoder blocks (LayerNorm, full attention, GELU mlp with biases)
over 16×16 patches and a cls token; the head reads the cls token. The param
tree has the JAX package's names and layouts, layers stacked on dim 0.
Attention goes through ``ops.attention(causal=False)``: at 224² and patch
16, T = 197 is no multiple of 64, so the dense reference runs on the card
too (the flash kernels do not fit it). ``logical_axes`` names each leaf's
dimensions for the mesh rule tables (parallel/mesh.py); a block given a
slice of the heads or of the mlp hidden dim sums its partial output over
the tp axis before the replicated bias, as the transformer's blocks do.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ray_tpu_torch import ops
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.transformer import (_HEADS_AXIS, _MLP_AXIS,
                                              _proj_in, _proj_out, draw,
                                              unstack_layers)
from ray_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    d_ff: int = 4096
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


SIZES = {
    "s16": dict(d_model=384, n_layers=12, n_heads=6, d_ff=1536),
    "b16": dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072),
    "l16": dict(d_model=1024, n_layers=24, n_heads=16, d_ff=4096),
}


def vit_config(size: str = "l16", **overrides) -> ViTConfig:
    base = dict(SIZES[size])
    base.update(overrides)
    return ViTConfig(**base)


def param_shapes(cfg: ViTConfig) -> dict:
    """The param tree's shapes (same tree as the JAX package's init)."""
    L, E, H, Dh, F = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                      cfg.d_ff)
    norm = {"w": (L, E), "b": (L, E)}
    return {
        "patch_embed": (3 * cfg.patch_size ** 2, E),
        "patch_bias": (E,),
        "cls_token": (1, 1, E),
        "pos_embed": (cfg.n_patches + 1, E),
        "layers": {
            "norm1": norm,
            "attn": {"wq": (L, E, H, Dh), "wk": (L, E, H, Dh),
                     "wv": (L, E, H, Dh), "wo": (L, H, Dh, E)},
            "norm2": dict(norm),
            "mlp": {"wi": (L, E, F), "bi": (L, F), "wo": (L, F, E),
                    "bo": (L, E)},
        },
        "final_norm": {"w": (E,), "b": (E,)},
        "head": (E, cfg.num_classes),
    }


def _init_std(path: tuple, cfg: ViTConfig) -> float | None:
    """Normal std of a leaf (the JAX init's), or None for ones/zeros."""
    if any(k in ("norm1", "norm2", "final_norm") for k in path) \
            or path[-1] in ("patch_bias", "bi", "bo"):
        return None
    if path[-1] == "wo":
        return 0.02 / math.sqrt(2 * cfg.n_layers)
    return 0.02


def init(generator: torch.Generator, cfg: ViTConfig, device=None,
         dtype: torch.dtype | None = None) -> dict:
    """Random params drawn on `device`; `dtype` defaults to
    cfg.param_dtype."""
    return draw(generator, param_shapes(cfg), lambda path: _init_std(path, cfg),
                resolve_device(device), dtype or cfg.param_dtype)


def logical_axes(cfg: ViTConfig) -> dict:
    """Same tree as init(), leaves = tuples of logical dim names (the JAX
    package's); stacked layer params get a leading 'layers' dim."""
    norm = {"w": ("embed",), "b": ("embed",)}
    layer = {
        "norm1": norm,
        "attn": {"wq": ("embed", "heads", "head_dim"),
                 "wk": ("embed", "heads", "head_dim"),
                 "wv": ("embed", "heads", "head_dim"),
                 "wo": ("heads", "head_dim", "embed")},
        "norm2": dict(norm),
        "mlp": {"wi": ("embed", "mlp"), "bi": ("mlp",),
                "wo": ("mlp", "embed"), "bo": ("embed",)},
    }
    return {
        "patch_embed": (None, "embed"),
        "patch_bias": ("embed",),
        "cls_token": (None, None, "embed"),
        "pos_embed": (None, "embed"),
        "layers": {k: {n: ("layers",) + t for n, t in v.items()}
                   for k, v in layer.items()},
        "final_norm": dict(norm),
        "head": ("embed", None),
    }


def patchify(images, patch_size: int):
    """[B, H, W, 3] → [B, n_patches, 3*p*p]."""
    B, H, W, C = images.shape
    p = patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def _block(h, p, cfg):
    dt = cfg.dtype
    hn = ops.layer_norm(h, p["norm1"]["w"], p["norm1"]["b"])
    q = _proj_in(hn, p["attn"]["wq"], dt)
    k = _proj_in(hn, p["attn"]["wk"], dt)
    v = _proj_in(hn, p["attn"]["wv"], dt)
    a = ops.attention(q, k, v, causal=False)
    o = _proj_out(a, p["attn"]["wo"], dt)
    if p["attn"]["wo"].shape[0] < cfg.n_heads:
        o = collectives.allreduce(o, _HEADS_AXIS)
    h = h + o
    hn = ops.layer_norm(h, p["norm2"]["w"], p["norm2"]["b"])
    m = ops.gelu(hn @ p["mlp"]["wi"].to(dt) + p["mlp"]["bi"].to(dt))
    o = m @ p["mlp"]["wo"].to(dt)
    if p["mlp"]["wo"].shape[0] < cfg.d_ff:
        o = collectives.allreduce(o, _MLP_AXIS)
    return h + (o + p["mlp"]["bo"].to(dt))


def forward(params, images, cfg: ViTConfig):
    """images [B, H, W, 3] float → logits [B, num_classes] f32."""
    dt = cfg.dtype
    x = patchify(images.to(dt), cfg.patch_size)
    x = x @ params["patch_embed"].to(dt) + params["patch_bias"].to(dt)
    B = x.shape[0]
    cls = params["cls_token"].to(dt).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dt)
    for lp in unstack_layers(params):
        x = _block(x, lp, cfg)
    x = ops.layer_norm(x, params["final_norm"]["w"], params["final_norm"]["b"])
    return (x[:, 0] @ params["head"].to(dt)).float()


def loss_fn(params, batch, cfg: ViTConfig):
    """Mean cross-entropy of ``forward`` on batch = (images, labels)."""
    images, labels = batch
    loss, _ = ops.softmax_cross_entropy(forward(params, images, cfg), labels)
    return loss
