"""RLModule: the policy/value network, functional over a dict of tensors.

(reference: rllib/core/rl_module/ — RLModule defines forward_inference /
forward_exploration / forward_train over the checkpointable module state;
here the module is (init, forward) over a params dict, as the port's
models/ are, so a learner keeps its leaves on its device and a runner its
inference copy on the CPU.)

The tree is the JAX package's: ``{"layers": {"0": {"w", "b"}, ...}, "pi":
{"w", "b"}, "vf": {"w", "b"}}`` with every ``w`` in ``[in, out]`` layout, so
a checkpoint or a weight blob of either package loads into the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device


def init(generator: torch.Generator, obs_dim: int, num_actions: int,
         hidden: tuple = (64, 64), device=None) -> dict:
    """He-normal hidden layers, a 0.01-scaled policy head and a unit-scaled
    value head (the reference's scales), drawn from `generator` on its own
    device and placed on `device` (None: ``resolve_device``, the card)."""
    device = resolve_device(device)
    sizes = (obs_dim, *hidden)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * scale).to(device)

    # dict-of-dicts (not a list) so flat path checkpoints round-trip
    params: dict = {"layers": {}}
    for i in range(len(sizes) - 1):
        params["layers"][str(i)] = {
            "w": normal((sizes[i], sizes[i + 1]), math.sqrt(2.0 / sizes[i])),
            "b": torch.zeros(sizes[i + 1], device=device),
        }
    params["pi"] = {"w": normal((sizes[-1], num_actions), 0.01),
                    "b": torch.zeros(num_actions, device=device)}
    params["vf"] = {"w": normal((sizes[-1], 1), 1.0),
                    "b": torch.zeros(1, device=device)}
    return params


def _obs(params: dict, obs) -> torch.Tensor:
    if isinstance(obs, np.ndarray) and not obs.flags.writeable:
        obs = obs.copy()  # e.g. mapped from the object store
    return torch.as_tensor(obs, dtype=torch.float32,
                           device=params["pi"]["w"].device)


def forward(params: dict, obs):
    """obs [B, obs_dim] → (logits [B, A], value [B])."""
    x = _obs(params, obs)
    for i in sorted(params["layers"], key=int):
        layer = params["layers"][i]
        x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[:, 0]
    return logits, value


@torch.no_grad()
def forward_inference(params: dict, obs) -> torch.Tensor:
    logits, _ = forward(params, obs)
    return torch.argmax(logits, dim=-1)


@torch.no_grad()
def forward_exploration(params: dict, obs, generator: torch.Generator):
    """Sample one action per row from softmax(logits) on `generator` →
    (action [B] int64, logp [B], value [B])."""
    logits, value = forward(params, obs)
    logp_all = torch.log_softmax(logits, dim=-1)
    action = torch.multinomial(logp_all.exp(), 1, generator=generator)[:, 0]
    logp = logp_all.gather(1, action[:, None])[:, 0]
    return action, logp, value


def _to_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    return torch.from_numpy(np.array(leaf, np.float32, copy=True))


def _convert_module(tree, device, where: str) -> dict:
    def node(t, keys, path):
        if not isinstance(t, dict) or set(t) != set(keys):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            raise ValueError(f"param tree at {path} has keys {got}, "
                             f"expected {sorted(keys)}")

    node(tree, ("layers", "pi", "vf"), where or "<root>")
    layers = tree["layers"]
    if not isinstance(layers, dict) or not layers or sorted(
            layers, key=int) != [str(i) for i in range(len(layers))]:
        raise ValueError(f"param tree at {where}/layers must hold layers "
                         f"'0'..'n-1', got {sorted(layers)}")
    out: dict = {"layers": {}}
    prev = None

    def leaf_pair(t, path, width_in, width_out):
        node(t, ("w", "b"), path)
        w, b = _to_tensor(t["w"]), _to_tensor(t["b"])
        if w.dim() != 2 or (width_in is not None and w.shape[0] != width_in):
            raise ValueError(f"param {path}/w has shape {tuple(w.shape)}, "
                             f"expected [{width_in}, out]")
        if width_out is not None and w.shape[1] != width_out:
            raise ValueError(f"param {path}/w has shape {tuple(w.shape)}, "
                             f"expected [in, {width_out}]")
        if tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"param {path}/b has shape {tuple(b.shape)}, "
                             f"expected ({w.shape[1]},)")
        return {"w": w.to(device), "b": b.to(device)}

    for i in sorted(layers, key=int):
        out["layers"][i] = leaf_pair(layers[i], f"{where}/layers/{i}", prev,
                                     None)
        prev = out["layers"][i]["w"].shape[1]
    out["pi"] = leaf_pair(tree["pi"], f"{where}/pi", prev, None)
    out["vf"] = leaf_pair(tree["vf"], f"{where}/vf", prev, 1)
    return out


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's numpy-leaf RLModule tree (``jax.device_get`` of its
    params, a weight blob, or a checkpoint) → the port's tensors on `device`
    (None: the card). Keys and shapes are checked: the hidden layers chain,
    both heads read the last hidden width, the value head has one output.
    A multi-module tree ``{module_id: tree}`` converts module by module."""
    device = resolve_device(device)
    if isinstance(tree, dict) and "layers" not in tree and tree and all(
            isinstance(v, dict) and "layers" in v for v in tree.values()):
        return {mid: _convert_module(sub, device, str(mid))
                for mid, sub in tree.items()}
    return _convert_module(tree, device, "")


def to_numpy(params: dict) -> dict:
    """A params tree (single or multi-module) → numpy leaves on the host,
    what ``jax.device_get`` gives the reference (weight blobs)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)
