"""Attention dispatcher.

Models call ``attention(q, k, v, ...)`` with [B, T, H, D] activations (GQA
allowed: fewer KV heads). On CUDA tensors the port's flash kernels
(ops/flash_attention.py) always run, through the ``FlashAttention``
autograd function: the forward kernel, and the dK/dV and dQ kernels when a
gradient flows back. Prompt buckets are powers of two >= 64 and training
sequences multiples of 64, so the 64-row tiles divide every length, and the
kernels read the kv heads in place (no repeat_kv copy). On CPU tensors the
plain reference runs, the same math the JAX package's CPU path uses.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import FlashAttention

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

    impl: None → the flash kernels for CUDA tensors, the reference for CPU
    tensors; "flash" → the flash autograd function (its plain versions on
    the CPU); "reference" → the dense reference on any device.
    """
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl is None:
        impl = "flash" if q.is_cuda else "reference"
    if impl == "flash":
        # heads-major views, no copies: the kernels take any strides with a
        # unit last dim, and o comes back dense in q's [B, T, H, D] layout
        o = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal, scale)
        return o.transpose(1, 2)
    if impl != "reference":
        raise ValueError(f"impl must be None, 'flash' or 'reference', "
                         f"got {impl!r}")
    k = repeat_kv(k, n_rep=H // Hkv)
    v = repeat_kv(v, n_rep=H // Hkv)
    return reference_attention(q, k, v, causal=causal, scale=scale)
