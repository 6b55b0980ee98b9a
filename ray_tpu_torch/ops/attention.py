"""Attention dispatcher.

Models call ``attention(q, k, v, ...)`` with [B, T, H, D] activations (GQA
allowed: fewer KV heads). The automatic choice (``impl=None``) takes the
port's flash kernels (ops/flash_attention.py) where they fit, as
``flash_attention.kernel_fits`` decides from device, dtype and shape alone:
CUDA bf16 tensors with head_dim 64 or 128 and T a multiple of 64. They run
through the ``FlashAttention`` autograd function: the forward kernel, and
the dK/dV and dQ kernels when a gradient flows back, reading the kv heads
in place (no repeat_kv copy). Every other call, CPU tensors included, takes
the dense reference, as the JAX package's auto path takes its reference
for shapes its kernel does not tile. The engine's prompt buckets and the
training sequences are multiples of 64, so serving and training launch the
kernels; ViT's T = 197 takes the reference.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import FlashAttention, kernel_fits

_NEG_INF = -1e30


def repeat_kv(k, *, n_rep: int):
    """[B, T, Hkv, D] → [B, T, Hkv*n_rep, D] by repeating each kv head."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """Unsharded reference: q, k, v [B, T, H, D] with equal head counts,
    computed in f32 with a dense score tensor."""
    B, T, H, D = q.shape
    if scale is None:
        scale = D ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              impl: str | None = None):
    """q: [B, T, H, D]; k, v: [B, T, Hkv, D]. Returns [B, T, H, D].

    impl: None → the flash kernels where ``kernel_fits`` holds, else the
    reference; "flash" → the flash autograd function (its plain versions on
    the CPU; on CUDA it raises for inputs the kernels do not take);
    "reference" → the dense reference on any device.
    """
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    # heads-major views, no copies: the kernels take any strides with a
    # unit last dim, and o comes back dense in q's [B, T, H, D] layout
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if impl is None:
        impl = "flash" if kernel_fits(qh, kh, vh) else "reference"
    if impl == "flash":
        return FlashAttention.apply(qh, kh, vh, causal, scale).transpose(1, 2)
    if impl != "reference":
        raise ValueError(f"impl must be None, 'flash' or 'reference', "
                         f"got {impl!r}")
    k = repeat_kv(k, n_rep=H // Hkv)
    v = repeat_kv(v, n_rep=H // Hkv)
    return reference_attention(q, k, v, causal=causal, scale=scale)
