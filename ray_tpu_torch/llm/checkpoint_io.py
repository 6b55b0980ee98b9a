"""Param checkpoint reading: flat .npz with /-joined tree paths (the format
ray_tpu/llm/checkpoint_io.py writes), read without jax."""

from __future__ import annotations

import numpy as np


def load_params(path: str) -> dict:
    """Flat npz → nested dict of numpy arrays."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    nested: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return nested
