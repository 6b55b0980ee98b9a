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
kernels; ViT's T = 197 takes the reference. With ``sp_axis`` the call is
ring attention over that mesh axis (parallel/ring_attention.py, plain
PyTorch as the JAX package's ring is jnp), kv heads repeated first.
"""

from __future__ import annotations

from ray_tpu_torch.ops.flash_attention import FlashAttention, kernel_fits
from ray_tpu_torch.parallel.ring_attention import (reference_attention,
                                                   ring_attention)


def repeat_kv(k, *, n_rep: int):
    """[B, T, Hkv, D] → [B, T, Hkv*n_rep, D] by repeating each kv head."""
    if n_rep == 1:
        return k
    return k.repeat_interleave(n_rep, dim=2)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              sp_axis: str | None = None, impl: str | None = None):
    """q: [B, T, H, D]; k, v: [B, T, Hkv, D]. Returns [B, T, H, D].

    impl: None → the flash kernels where ``kernel_fits`` holds, else the
    reference; "flash" → the flash autograd function (its plain versions on
    the CPU; on CUDA it raises for inputs the kernels do not take);
    "reference" → the dense reference on any device. sp_axis: when set,
    ring attention over that mesh axis (inputs sequence-sharded, under a
    mesh with that axis); `impl` is then not consulted.
    """
    H, Hkv = q.shape[2], k.shape[2]
    if H % Hkv != 0:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if sp_axis is not None:
        return ring_attention(q, repeat_kv(k, n_rep=H // Hkv),
                              repeat_kv(v, n_rep=H // Hkv), axis_name=sp_axis,
                              causal=causal, scale=scale)
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
