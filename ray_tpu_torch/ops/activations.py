"""Gated activations used by the model families."""

from __future__ import annotations

import torch.nn.functional as F


def swiglu(gate, up):
    return F.silu(gate) * up


def geglu(gate, up):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(gate, approximate="tanh") * up


def gelu(x):
    return F.gelu(x, approximate="tanh")
