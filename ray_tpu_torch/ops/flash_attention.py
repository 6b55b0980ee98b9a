"""Flash attention: the Hopper kernels and their plain PyTorch versions.

Counterpart of ray_tpu/ops/flash_attention.py. Three kernels:

- ``csrc/flash_attention_fwd.cu``: blocked online-softmax attention, causal
  or full, writing O in bf16 and the per-row logsumexp in f32 (``_fwd_call``
  returns both, as in the JAX package);
- ``csrc/flash_attention_bwd.cu``: the dQ kernel and the dK/dV kernel of
  the two-kernel flash backward, which recompute p = exp(s - lse) from the
  saved lse. The dQ kernel also computes delta = rowsum(dO * O) and writes
  it out; the dK/dV kernel, launched after it, reads it.

All three are warp-specialised Hopper kernels (TMA loads into 128-byte
swizzled shared memory under mbarriers, wgmma, built for sm_90a only;
``csrc/hopper_tiles.cuh``). Their tiles are 128 rows (64 kv rows in dQ at
head_dim 128), but callers keep the rule T % 64 == 0 (``TILE``): a half tile
at the end is zero-filled by TMA and masked in the kernel.

``FlashAttention`` (a ``torch.autograd.Function``, the counterpart of the
``jax.custom_vjp`` there) ties them together; ``flash_attention`` is its
public form.

On a CUDA tensor a wrapper launches its kernel or raises; only a CPU tensor
takes the plain version. ``kernel_fits`` says, from device, dtype and shape
alone, whether the kernels take a call: the attention dispatcher's
automatic choice, by the same rule the wrappers' checks raise from. The kernels read kv head ``h // (H / Hkv)``
themselves, so q may have more heads than k/v (GQA): no repeat_kv copy is
made, and dK/dV come out per kv head, summed over the q heads of the group.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

_NEG_INF = -1e30
TILE = 64  # q rows and keys per kernel tile; T must be a multiple
HEAD_DIMS = (64, 128)  # the head dims the kernels are built for

_P, _I = ctypes.c_void_p, ctypes.c_int
_TAIL = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _P]

KERNEL = _build.Kernel("flash_attention_fwd", "flash_attention_fwd_bf16",
                       [_P] * 5 + [_I] * 5 + _TAIL)
KERNEL_DKV = _build.Kernel("flash_attention_bwd",
                           "flash_attention_bwd_dkv_bf16",
                           [_P] * 8 + [_I] * 5 + _TAIL)
KERNEL_DQ = _build.Kernel("flash_attention_bwd", "flash_attention_bwd_dq_bf16",
                          [_P] * 8 + [_I] * 5 + _TAIL)


def _repeat_heads(q, k, v):
    H, Hkv = q.shape[1], k.shape[1]
    if H == Hkv:
        return k, v
    return (k.repeat_interleave(H // Hkv, dim=1),
            v.repeat_interleave(H // Hkv, dim=1))


def _scores(q, k, *, causal: bool, scale: float):
    """f32 scores [B,H,T,T] of q against (head-repeated) k, masked."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[2]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_attention_forward_plain(q, k, v, *, causal: bool, scale: float):
    """Plain version: q [B,H,T,D], k/v [B,Hkv,T,D] → (o [B,H,T,D] in q's
    dtype, lse [B,H,T,1] f32). Computed in f32 with a dense score tensor,
    its softmax in float64 on the CPU."""
    k, v = _repeat_heads(q, k, v)
    s = _scores(q, k, causal=causal, scale=scale)
    if s.device.type == "cpu":
        # on the CPU, where this version is the op itself, the softmax's
        # exponentials are taken in float64: a process's first f32
        # torch.exp there can run a kernel off by up to 1.5e-4 relative
        # (seen in fresh worker processes; later calls are exact), which
        # moved an actor's output 9.2e-5 from the Pallas kernel's
        s = s.double()
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse.float()


def backward_delta(o, do):
    """delta = rowsum(dO * O) in f32, [B, H, T]: the softmax Jacobian term
    of the backward. The dQ kernel computes the same sum itself."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_backward_plain(q, k, v, o, lse, do, *, causal: bool,
                                   scale: float):
    """Plain version of the backward: (dq [B,H,T,D], dk/dv [B,Hkv,T,D]) in
    the inputs' dtypes, computed in f32 with dense [T,T] tensors. Follows
    the JAX kernels: delta = rowsum(dO * O) from O as given, p = exp(s - lse)
    from the saved lse, ds = p * (dp - delta) * scale; dk/dv are summed over
    the q heads that share a kv head."""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    kr, vr = _repeat_heads(q, k, v)
    dof = do.float()
    delta = backward_delta(o, do)[..., None]
    p = torch.exp(_scores(q, kr, causal=causal, scale=scale) - lse)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dk = dk.reshape(B, Hkv, H // Hkv, T, D).sum(2)
    dv = dv.reshape(B, Hkv, H // Hkv, T, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, T, D]")
    B, H, T, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (T, D):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"q heads {H} not a multiple of kv heads {k.shape[1]}")


def _kernel_layout_ok(x) -> bool:
    """Strides the kernels take: unit last stride, the others positive
    multiples of 8 elements (16-byte rows, which TMA tensor maps and cp.async
    need), a 16-byte aligned base. [B,T,H,D] activations seen heads-major
    (``transpose(1, 2)``) qualify as they are."""
    return (x.stride(-1) == 1
            and all(s > 0 and s % 8 == 0 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _misfit(shape_q, dtypes: dict):
    """Why the kernels cannot take a q of `shape_q` [B,H,T,D] with inputs
    of `dtypes` (name → dtype): an (exception type, message) pair, or None
    when they fit. The one rule behind both ``kernel_fits`` and the
    wrappers' checks, so the dispatcher and the wrappers cannot disagree."""
    T, D = shape_q[2], shape_q[3]
    if D not in HEAD_DIMS:
        return ValueError, f"flash kernel supports head_dim 64 or 128, got {D}"
    if T % TILE:
        return ValueError, f"T={T} must be a multiple of the kernel tile {TILE}"
    for name, dt in dtypes.items():
        if dt != torch.bfloat16:
            return TypeError, f"flash kernel takes bf16, got {name} {dt}"
    return None


def _fits(shape_q, dtypes: dict, is_cuda: bool) -> bool:
    """Device, dtype and shape only: layout and alignment are not part of
    the choice (a bad stride on the kernel path stays an error)."""
    return is_cuda and _misfit(shape_q, dtypes) is None


def kernel_fits(q, k, v) -> bool:
    """Whether the kernels take heads-major q [B,H,T,D] and k/v [B,Hkv,T,D]:
    all three on CUDA and bf16, D in (64, 128) and T % TILE == 0. The
    attention dispatcher's automatic choice; decided from the tensors'
    metadata before any call."""
    return _fits(q.shape, {"q": q.dtype, "k": k.dtype, "v": v.dtype},
                 q.is_cuda and k.is_cuda and v.is_cuda)


def _check_kernel_args(q, named):
    """Size, dtype, layout and device checks shared by the three kernels,
    all made before the C entry point is called."""
    _check_inputs(q, named["k"], named["v"])
    bad = _misfit(q.shape, {name: x.dtype for name, x in named.items()})
    if bad is not None:
        exc, msg = bad
        raise exc(msg)
    for name, x in named.items():
        if not _kernel_layout_ok(x):
            raise ValueError(f"{name} needs a unit last stride, other strides "
                             "positive multiples of 8 and 16-byte alignment")
    for name, x in named.items():
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device")


def _strides(*xs):
    flat = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _fwd_kernel(q, k, v, *, causal: bool, scale: float):
    _check_kernel_args(q, {"q": q, "k": k, "v": v})
    B, H, T, D = q.shape
    o = torch.empty_like(q)  # dense q → o shares its strides
    lse = torch.empty((B, H, T, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      lse.data_ptr(), B, H, k.shape[1], T, D,
                      _strides(q, k, v, o), float(scale), int(bool(causal)),
                      _stream(q))
    return o, lse


def _bwd_kernel(q, k, v, o, lse, do, *, causal: bool, scale: float):
    """(dq, dk, dv) from the dQ and dK/dV kernels, in that order on one
    stream: the dQ kernel writes delta = rowsum(dO * O), the dK/dV kernel
    reads it."""
    _check_kernel_args(q, {"q": q, "k": k, "v": v, "o": o, "do": do})
    B, H, T, D = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"match q {tuple(q.shape)}")
    if lse.shape != (B, H, T, 1) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("lse must be a contiguous [B, H, T, 1] f32 tensor "
                         "on q's device")
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _dq_launch(q, k, v, do, o, lse, delta, dq, causal=causal, scale=scale)
        _dkv_launch(q, k, v, do, lse, delta, dk, dv, causal=causal,
                    scale=scale)
    return dq, dk, dv


def _dq_launch(q, k, v, do, o, lse, delta, dq, *, causal: bool,
               scale: float):
    """One launch of the dQ kernel on checked inputs (``_bwd_kernel``); it
    writes dq and delta, a contiguous [B, H, T] f32 buffer."""
    B, H, T, D = q.shape
    KERNEL_DQ.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), B, H, k.shape[1], T, D,
                     _strides(q, k, v, do, o, dq), float(scale),
                     int(bool(causal)), _stream(q))


def _dkv_launch(q, k, v, do, lse, delta, dk, dv, *, causal: bool,
                scale: float):
    """One launch of the dK/dV kernel on checked inputs (``_bwd_kernel``),
    after the dQ kernel has written delta."""
    B, H, T, D = q.shape
    KERNEL_DKV.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                      dv.data_ptr(), B, H, k.shape[1], T, D,
                      _strides(q, k, v, do, dk, dv), float(scale),
                      int(bool(causal)), _stream(q))


def _fwd_call(q, k, v, *, causal: bool, scale: float):
    """(o, lse) — the kernel for CUDA tensors, the plain version for CPU
    tensors. q [B,H,T,D]; k/v [B,Hkv,T,D]; any strides with a unit last
    dim on the card."""
    if q.is_cuda:
        return _fwd_kernel(q, k, v, causal=causal, scale=scale)
    _check_inputs(q, k, v)
    return flash_attention_forward_plain(q, k, v, causal=causal, scale=scale)


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool,
                             scale: float):
    """Gradients (dq [B,H,T,D], dk/dv [B,Hkv,T,D]) — the kernels for CUDA
    tensors, the plain version for CPU tensors."""
    if q.is_cuda:
        return _bwd_kernel(q, k, v, o, lse, do, causal=causal, scale=scale)
    _check_inputs(q, k, v)
    return flash_attention_backward_plain(q, k, v, o, lse, do, causal=causal,
                                          scale=scale)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over heads-major q [B,H,T,D] and k/v
    [B,Hkv,T,D]: the forward kernel, and the dK/dV and dQ kernels as its
    backward. Under non-reentrant checkpointing the forward reruns during
    backward and the recomputed (o, lse) are the ones saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = _fwd_call(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.is_cuda and not _kernel_layout_ok(do):
            do = do.contiguous()  # e.g. an expanded gradient of a sum
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              causal=ctx.causal,
                                              scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, scale: float | None = None):
    """Differentiable flash attention, q [B,H,T,D], k/v [B,Hkv,T,D]
    (heads-major). Returns O [B,H,T,D] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, scale)


def flash_attention_forward(q, k, v, *, causal: bool = True,
                            scale: float | None = None):
    """q: [B, H, T, D]; k, v: [B, Hkv, T, D] (heads-major). Returns O
    [B, H, T, D] in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    out, _ = _fwd_call(q, k, v, causal=causal, scale=scale)
    return out
