"""Learner: the SGD side of RL training.

(reference: rllib/core/learner/learner.py:112 + learner_group.py:101 — the
learner owns the module's params and optimizer state and turns a train
batch into minibatch updates. Here the params are a dict of tensors on the
learner's device — the card unless the caller asks for the CPU — updated by
``torch.optim.Adam``, whose rule is optax.adam's.)
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib import rl_module


def compute_gae(rewards, values, dones, last_value, *, gamma: float = 0.99,
                lam: float = 0.95):
    """Time-major [T, N] inputs → (advantages, returns) [T, N], by a reverse
    loop over T on the inputs' device (numpy inputs: the CPU)."""
    rewards = torch.as_tensor(rewards, dtype=torch.float32)
    dev = rewards.device
    values = torch.as_tensor(values, dtype=torch.float32, device=dev)
    dones = torch.as_tensor(dones, device=dev)
    last_value = torch.as_tensor(last_value, dtype=torch.float32, device=dev)
    nonterminal = 1.0 - dones.to(torch.float32)
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    delta = rewards + gamma * v_next * nonterminal - values
    advs = torch.empty_like(values)
    adv = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv = delta[t] + gamma * lam * nonterminal[t] * adv
        advs[t] = adv
    return advs, advs + values


def leaves(params: dict) -> list:
    """The params' tensors in the order of the flat checkpoint keys."""
    if isinstance(params, torch.Tensor):
        return [params]
    return [t for _, v in sorted(params.items()) for t in leaves(v)]


def make_optimizer(params: dict, lr: float) -> torch.optim.Adam:
    """Adam over the params' leaves, in place (optax.adam's defaults: b1
    0.9, b2 0.999, eps 1e-8 outside the square root)."""
    for t in leaves(params):
        t.requires_grad_(True)
    return torch.optim.Adam(leaves(params), lr=lr)


def make_ppo_update(optimizer: torch.optim.Optimizer, *, clip: float = 0.2,
                    vf_coef: float = 0.5, ent_coef: float = 0.01):
    """-> update(params, batch) → metrics: one clipped-surrogate step of
    `optimizer`, whose leaves are `params`' (updated in place). The metrics
    stay tensors on the device; the Learner reads the last ones as floats."""

    def update(params: dict, batch: dict) -> dict:
        logits, value = rl_module.forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["advantages"]
        # the population std, as jnp.std gives
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.minimum(ratio * adv,
                            torch.clamp(ratio, 1 - clip, 1 + clip) * adv).mean()
        vf = 0.5 * torch.mean((value - batch["returns"]) ** 2)
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        total = pg + vf_coef * vf - ent_coef * ent
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        return {"policy_loss": pg.detach(), "vf_loss": vf.detach(),
                "entropy": ent.detach(),
                "approx_kl": torch.mean(batch["logp_old"] - logp).detach(),
                "total_loss": total.detach()}

    return update


def floats(metrics: dict) -> dict:
    """Device scalars → Python floats, in one host copy."""
    if not metrics:
        return {}
    vals = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


def batch_to(batch: dict, device: torch.device) -> dict:
    """numpy arrays (a runner's, read-only when the store maps them) or
    tensors → tensors on `device`."""
    return {k: torch.as_tensor(v if isinstance(v, torch.Tensor)
                               or v.flags.writeable else v.copy(),
                               device=device)
            for k, v in batch.items()}


class Learner:
    """Single-controller learner owning params + optimizer state on its
    device. (reference: core/learner/learner.py:112 — update(batch) →
    metrics.) `device` None is the card (raises without one)."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float = 3e-4,
                 hidden=(64, 64), clip: float = 0.2, vf_coef: float = 0.5,
                 ent_coef: float = 0.01, seed: int = 0, device=None):
        self.device = resolve_device(device)
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = rl_module.init(torch.Generator().manual_seed(seed),
                                     obs_dim, num_actions, hidden,
                                     device=self.device)
        self.optimizer = make_optimizer(self.params, lr)
        self._update = make_ppo_update(self.optimizer, clip=clip,
                                       vf_coef=vf_coef, ent_coef=ent_coef)

    def update(self, batch: dict, *, minibatch_size: int, num_epochs: int,
               rng: np.random.Generator) -> dict:
        batch = batch_to(batch, self.device)
        n = batch["obs"].shape[0]
        metrics: dict = {}
        for _ in range(num_epochs):
            perm = torch.as_tensor(rng.permutation(n), device=self.device)
            for start in range(0, n - minibatch_size + 1, minibatch_size):
                idx = perm[start:start + minibatch_size]
                metrics = self._update(
                    self.params, {k: v[idx] for k, v in batch.items()})
        return floats(metrics)

    def get_weights_blob(self) -> bytes:
        from ray_tpu_torch._private import serialization as ser

        return ser.dumps(rl_module.to_numpy(self.params))
