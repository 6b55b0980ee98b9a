"""Normalization ops, computed in f32 and cast back to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x, weight, *, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, *, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    out = y * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
