"""Param checkpoint IO: flat .npz with /-joined tree paths, the format
ray_tpu/llm/checkpoint_io.py writes and reads, without jax.

The npz format has no bfloat16. The JAX package's ``save_params`` writes a
bf16 leaf (an ml_dtypes array) as raw 2-byte records, dtype ``|V2``, and its
``load_params`` hands them back as such. Here a bf16 tensor is written as the
same records, and a ``|V2`` leaf is read back as a torch bf16 tensor, so a
checkpoint round-trips bit for bit in either direction.
"""

from __future__ import annotations

import os

import numpy as np

# the dtype np.savez gives a bf16 leaf (ml_dtypes' bfloat16 has no npy
# descriptor of its own, so it is stored as 2-byte void records)
_BF16_RECORD = np.dtype("V2")


def _to_numpy(leaf) -> np.ndarray:
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(params, prefix: str = "") -> dict:
    """Nested dicts/lists/tuples → {"a/b/0": leaf}, the keys jax's
    tree_flatten_with_path gives the JAX package (dict keys in sorted
    order, sequence items by index)."""
    if isinstance(params, dict):
        items = sorted(params.items())
    elif isinstance(params, (list, tuple)):
        items = list(enumerate(params))
    else:
        return {prefix: _to_numpy(params)}
    flat: dict = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def save_params(params, path: str) -> str:
    """Nested dict of torch tensors (or numpy arrays) → flat npz at `path`
    (".npz" appended if missing, as np.savez does). Returns `path`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz",
             **_flatten(params))
    return path


def load_params(path: str) -> dict:
    """Flat npz → nested dict of numpy arrays; bf16 leaves come back as
    torch bf16 tensors (numpy has no bf16)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    nested: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            leaf = data[key]
            if leaf.dtype == _BF16_RECORD:
                import torch

                leaf = torch.from_numpy(leaf.view(np.int16).copy()).view(
                    torch.bfloat16)
            node[parts[-1]] = leaf
    return nested
