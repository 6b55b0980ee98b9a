"""The control: the reference's linear layers in float8 (e4m3).

The configurations state bf16 compute, and the nearest precision below
it is float8. Every matmul of a projection, an expert, the router or the
head takes both operands rounded to e4m3 (the activations scaled per row,
a weight per matrix, each by its absolute maximum over 448, e4m3's
largest value), then multiplies in float32; norms, softmax and the
attention scores stay float32, as fp8 serving stacks keep them.
"""

from __future__ import annotations

E4M3_MAX = 448.0


def to_e4m3(torch, t, dim=None):
    """`t` rounded to float8 e4m3 under an absmax scale (per row along
    `dim`, or one for the tensor), returned in t's dtype."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim,
                                                            keepdim=True)
    scale = (amax / E4M3_MAX).clamp_min(1e-30)
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def matmul(torch, precision: str):
    """x @ w in float32, or with both operands in e4m3 first; "bf16", a
    bfloat16 product, is no control: it reads what the served type's
    rounding alone moves."""
    if precision == "f32":
        return lambda x, w: x @ w
    if precision == "bf16":
        return lambda x, w: (x.to(torch.bfloat16)
                             @ w.to(torch.bfloat16)).float()
    if precision != "fp8":
        raise ValueError(f"precision must be 'f32', 'bf16' or 'fp8', got "
                         f"{precision!r}")
    return lambda x, w: to_e4m3(torch, x, -1) @ to_e4m3(torch, w)
