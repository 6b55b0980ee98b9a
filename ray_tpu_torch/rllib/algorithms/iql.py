"""IQL — implicit Q-learning for offline continuous control.

(reference: rllib/algorithms/iql/ — IQLConfig/IQL per Kostrikov et al.
2021: never queries Q on out-of-distribution actions. Three pieces:
  1. a state-value net V trained by EXPECTILE regression toward the
     target critics' value of the DATA action (tau > 0.5 biases V toward
     the upper envelope of behavior-supported returns),
  2. twin critics trained by MSE toward r + gamma * V(s') — no actor in
     the backup at all,
  3. the policy extracted by advantage-weighted regression:
     max E[exp(beta * (Q - V)) * log pi(a_data | s)].
Reuses the SAC critic networks (sac.py) and the transition loader from
cql.py; the data and every param live on the learner's device.)
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.cql import OfflineBatches, load_transitions
from ray_tpu_torch.rllib.algorithms.dqn import snapshot
from ray_tpu_torch.rllib.algorithms.sac import (_HALF_LOG_2PI, _mlp,
                                                _mlp_init, _step, polyak_,
                                                q_value, sac_optimizers)


class IQLConfig(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.offline_data = None
        self.obs_dim = None
        self.action_dim = None
        self.action_scale = 1.0
        self.train_batch_size = 256
        self.num_updates_per_step = 200
        self.tau = 0.005               # polyak for target critics
        self.expectile = 0.7           # V regression expectile (paper: 0.7)
        self.beta = 3.0                # AWR inverse temperature
        self.max_weight = 100.0        # AWR weight clip

    def offline(self, *, offline_data=None, obs_dim=None, action_dim=None,
                action_scale=None, train_batch_size=None,
                num_updates_per_step=None, expectile=None, beta=None,
                max_weight=None, tau=None, **_ignored) -> "IQLConfig":
        for name, val in (("offline_data", offline_data),
                          ("obs_dim", obs_dim), ("action_dim", action_dim),
                          ("action_scale", action_scale),
                          ("train_batch_size", train_batch_size),
                          ("num_updates_per_step", num_updates_per_step),
                          ("expectile", expectile), ("beta", beta),
                          ("max_weight", max_weight), ("tau", tau)):
            if val is not None:
                setattr(self, name, val)
        return self


def _gaussian_logp_of(actor_params, obs, actions):
    """log pi(a|s) of DATA actions under a plain Gaussian actor: an MLP
    mean plus a state-INDEPENDENT learnable log-std (the original IQL
    implementation's policy class). Unlike SAC's tanh-squashed Gaussian,
    weighted regression toward data actions stays well-conditioned — no
    atanh blow-up near the action boundary, and the shared std cannot
    collapse per-state around a wrong mean early in training. Actions are
    clipped to the valid range only at evaluation time."""
    mu = _mlp(actor_params["net"], obs)
    log_std = torch.clamp(actor_params["log_std"], -5.0, 2.0)
    return torch.sum(-0.5 * ((actions - mu) / torch.exp(log_std)) ** 2
                     - log_std - _HALF_LOG_2PI, dim=-1)


def _gaussian_mean(actor_params, obs, action_scale: float):
    return torch.clamp(_mlp(actor_params["net"], obs), -action_scale,
                       action_scale)


def init_iql_params(generator: torch.Generator, obs_dim: int,
                    action_dim: int, hidden=(64, 64), device=None) -> dict:
    """Twin critics, a plain-Gaussian actor (see _gaussian_logp_of) and an
    expectile V net; IQL has no temperature, so no log_alpha leaf."""
    params = {
        "q1": _mlp_init(generator, (obs_dim + action_dim, *hidden, 1), device),
        "q2": _mlp_init(generator, (obs_dim + action_dim, *hidden, 1), device),
        "actor": {
            "net": _mlp_init(generator, (obs_dim, *hidden, action_dim),
                             device),
        },
        "v": _mlp_init(generator, (obs_dim, *hidden, 1), device),
    }
    params["actor"]["log_std"] = torch.zeros(
        action_dim, device=params["v"]["0"]["w"].device)
    return params


def make_iql_update(optimizers: dict, *, gamma: float, tau: float,
                    action_scale: float, expectile: float, beta: float,
                    max_weight: float):
    """-> update(params, target_q, batch) → metrics: the V step, the
    critics toward r + gamma V'(s') from the UPDATED V, the AWR actor step,
    then polyak; in place, metrics as device tensors. (`action_scale` is
    the reference's argument; the update clips no action.)"""
    del action_scale

    def update(params, target_q, batch):
        # --- V: expectile regression toward min target-Q of data actions
        with torch.no_grad():
            tq = torch.minimum(
                q_value(target_q["q1"], batch["obs"], batch["actions"]),
                q_value(target_q["q2"], batch["obs"], batch["actions"]))
        v = _mlp(params["v"], batch["obs"])[:, 0]
        diff = tq - v
        w = torch.where(diff > 0, expectile, 1.0 - expectile)
        v_loss = torch.mean(w * diff ** 2)
        _step(optimizers["v"], v_loss, learner_mod.leaves(params["v"]))
        v_now = v.detach()

        # --- critics: MSE toward r + gamma * V(s'); V (not the actor)
        # carries the policy-improvement signal
        with torch.no_grad():
            v_next = _mlp(params["v"], batch["next_obs"])[:, 0]
            nonterminal = 1.0 - batch["dones"].to(torch.float32)
            target = batch["rewards"] + gamma * nonterminal * v_next
        q1 = q_value(params["q1"], batch["obs"], batch["actions"])
        q2 = q_value(params["q2"], batch["obs"], batch["actions"])
        q_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)
        _step(optimizers["q"], q_loss, learner_mod.leaves(
            {"q1": params["q1"], "q2": params["q2"]}))

        # --- policy: advantage-weighted regression on data actions
        adv = tq - v_now
        weights = torch.clamp(torch.exp(beta * adv), max=max_weight)
        logp = _gaussian_logp_of(params["actor"], batch["obs"],
                                 batch["actions"])
        pi_loss = -torch.mean(weights * logp)
        _step(optimizers["actor"], pi_loss,
              learner_mod.leaves(params["actor"]))

        polyak_(target_q, {"q1": params["q1"], "q2": params["q2"]}, tau)
        return {"v_loss": v_loss.detach(), "q_loss": q_loss.detach(),
                "pi_loss": pi_loss.detach(), "q_mean": torch.mean(q1.detach()),
                "v_mean": torch.mean(v_now), "adv_mean": torch.mean(adv),
                "mean_weight": torch.mean(weights)}

    return update


class IQL(Algorithm):
    def _setup(self):
        cfg = self.config
        if cfg.offline_data is None or cfg.obs_dim is None or cfg.action_dim is None:
            raise ValueError(
                "IQL needs .offline(offline_data=..., obs_dim=..., "
                "action_dim=...)")
        self._batches = OfflineBatches(load_transitions(cfg.offline_data),
                                       self.device, cfg.seed)
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = init_iql_params(
            torch.Generator().manual_seed(cfg.seed), cfg.obs_dim,
            cfg.action_dim, cfg.model_hidden, device=self.device)
        self.target_q = snapshot({"q1": self.params["q1"],
                                  "q2": self.params["q2"]})
        self.optimizers = sac_optimizers(self.params, cfg.lr, third="v")
        self._update = make_iql_update(
            self.optimizers, gamma=cfg.gamma, tau=cfg.tau,
            action_scale=cfg.action_scale, expectile=cfg.expectile,
            beta=cfg.beta, max_weight=cfg.max_weight)
        self._num_updates = 0

    def training_step(self) -> dict:
        cfg = self.config
        m: dict = {}
        for batch in self._batches.iteration(cfg.num_updates_per_step,
                                             cfg.train_batch_size):
            m = self._update(self.params, self.target_q, batch)
            self._num_updates += 1
        out = learner_mod.floats(m)
        out["num_updates"] = self._num_updates
        return out

    def compute_single_action(self, obs) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.device)[None]
            return _gaussian_mean(self.params["actor"], x,
                                  self.config.action_scale)[0].cpu().numpy()


IQLConfig.algo_class = IQL
