"""Rotary position embeddings (RoPE), half-rotation convention (Llama-style)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_len: int, *, theta: float = 10000.0,
                     dtype=torch.float32, device=None):
    """[max_len, head_dim//2] cos/sin tables."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def apply_rope(x, cos, sin, *, positions=None):
    """x: [B, T, H, D]; cos/sin: [max_len, D//2]; positions: [B, T] or [T]."""
    B, T, H, D = x.shape
    if positions is None:
        c = cos[:T][None, :, None, :]
        s = sin[:T][None, :, None, :]
    else:
        c = cos[positions]
        s = sin[positions]
        if c.ndim == 2:  # [T, D/2] → [1, T, 1, D/2]
            c, s = c[None, :, None, :], s[None, :, None, :]
        else:            # [B, T, D/2] → [B, T, 1, D/2]
            c, s = c[:, :, None, :], s[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
