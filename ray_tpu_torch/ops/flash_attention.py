"""Flash-attention forward: the Hopper kernel and its plain PyTorch version.

Counterpart of ray_tpu/ops/flash_attention.py (forward only; the dK/dV and
dQ backward kernels come with training). The kernel is
``csrc/flash_attention_fwd.cu``: blocked online-softmax attention, causal or
full, writing O in bf16 and the per-row logsumexp in f32 — the lse that the
backward and a ring-attention merge will need, as ``_fwd_call`` returns it
in the JAX package.

On a CUDA tensor the wrapper launches the kernel or raises; only a CPU tensor
takes the plain version. The kernel reads kv head ``h // (H / Hkv)`` itself,
so q may have more heads than k/v (GQA) and no repeat_kv copy is made.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
TILE = 64  # q rows and keys per kernel tile; T must be a multiple

KERNEL = _build.Kernel(
    "flash_attention_fwd", "flash_attention_fwd_bf16",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p])


def flash_attention_forward_plain(q, k, v, *, causal: bool, scale: float):
    """Plain version: q [B,H,T,D], k/v [B,Hkv,T,D] → (o [B,H,T,D] in q's
    dtype, lse [B,H,T,1] f32). Computed in f32 with a dense score tensor."""
    H, Hkv = q.shape[1], k.shape[1]
    if H != Hkv:
        k = k.repeat_interleave(H // Hkv, dim=1)
        v = v.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[2]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    B, H, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (T, D):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[1]}")


def _fwd_kernel(q, k, v, *, causal: bool, scale: float):
    _check_inputs(q, k, v)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, got {name} {x.dtype}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit last stride, other strides "
                             "a multiple of 8 and 16-byte alignment")
    if D not in (64, 128):
        raise ValueError(f"flash kernel supports head_dim 64 or 128, got {D}")
    if T % TILE:
        raise ValueError(f"T={T} must be a multiple of the kernel tile {TILE}")
    o = torch.empty_like(q)  # dense q → o shares its strides
    lse = torch.empty((B, H, T, 1), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), B, H, Hkv, T, D, strides, float(scale),
                      int(bool(causal)), stream)
    return o, lse


def _fwd_call(q, k, v, *, causal: bool, scale: float):
    """(o, lse) — the kernel for CUDA tensors, the plain version for CPU
    tensors. q [B,H,T,D]; k/v [B,Hkv,T,D]; any strides with a unit last
    dim on the card."""
    if q.is_cuda:
        return _fwd_kernel(q, k, v, causal=causal, scale=scale)
    _check_inputs(q, k, v)
    return flash_attention_forward_plain(q, k, v, causal=causal, scale=scale)


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            scale: float | None = None):
    """q: [B, H, T, D]; k, v: [B, Hkv, T, D] (heads-major). Returns O
    [B, H, T, D] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, _ = _fwd_call(q, k, v, causal=causal, scale=scale)
    return out
