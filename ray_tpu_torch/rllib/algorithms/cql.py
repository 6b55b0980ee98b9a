"""CQL — conservative Q-learning for offline continuous control.

(reference: rllib/algorithms/cql/ — CQLConfig/CQL layers the conservative
regularizer of Kumar et al. 2020 on top of the SAC losses: in addition to
the soft Bellman backup, each critic is penalized by
``logsumexp_a Q(s,a) - Q(s, a_data)`` so Q-values on out-of-distribution
actions are pushed DOWN, which is what keeps a policy trained purely from
a static dataset from exploiting Q-function extrapolation errors. The
logsumexp is estimated from uniform-random and current-policy action
samples with importance correction, as in the paper's CQL(H) variant.)

Reuses the SAC networks and steps (sac.py); there are no env runners —
the data source is a static dataset of {obs, action, reward, next_obs,
done} transitions, held on the learner's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import snapshot
from ray_tpu_torch.rllib.algorithms.sac import (_gaussian, _step,
                                                actor_and_alpha_steps,
                                                actor_mean, actor_sample,
                                                init_sac_params, polyak_,
                                                q_value, sac_optimizers,
                                                soft_target)


class CQLConfig(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.offline_data = None
        self.obs_dim = None
        self.action_dim = None
        self.action_scale = 1.0
        self.train_batch_size = 256
        self.num_updates_per_step = 200
        self.tau = 0.005
        self.initial_alpha = 0.1
        self.autotune_alpha = True
        self.target_entropy = None
        self.cql_alpha = 1.0           # weight of the conservative penalty
        self.num_cql_actions = 8       # sampled actions per logsumexp term

    def offline(self, *, offline_data=None, obs_dim=None, action_dim=None,
                action_scale=None, train_batch_size=None,
                num_updates_per_step=None, cql_alpha=None,
                num_cql_actions=None, initial_alpha=None, tau=None,
                **_ignored) -> "CQLConfig":
        for name, val in (("offline_data", offline_data),
                          ("obs_dim", obs_dim), ("action_dim", action_dim),
                          ("action_scale", action_scale),
                          ("train_batch_size", train_batch_size),
                          ("num_updates_per_step", num_updates_per_step),
                          ("cql_alpha", cql_alpha),
                          ("num_cql_actions", num_cql_actions),
                          ("initial_alpha", initial_alpha), ("tau", tau)):
            if val is not None:
                setattr(self, name, val)
        return self


def make_cql_update(optimizers: dict, *, gamma: float, tau: float,
                    action_scale: float, target_entropy: float,
                    autotune: bool, cql_alpha: float, n_actions: int):
    """-> update(params, target_q, batch, generator=None, noise=None) →
    metrics: SAC's step (sac.make_sac_update) with the conservative
    penalty in the critics' loss. `noise` takes the place of every draw
    from `generator`: "next" and "pi" [B, d] as SAC's, "unif" [n, B, d]
    (already on [-scale, scale]), "cur" and "nxt" [n, B, d] (standard
    normal, the policy samples on obs and on next_obs)."""
    log_3n = math.log(3 * n_actions)

    def _conservative_penalty(params, batch, q_data, generator, noise):
        """CQL(H): logsumexp over sampled actions minus the data action's Q,
        per critic. Uniform samples are importance-corrected by the uniform
        density; policy samples by their log-prob. The 3n sampled actions
        go through each critic as one [3n, B] batch."""
        obs, d = batch["obs"], batch["actions"].shape[-1]
        B = obs.shape[0]
        unif = noise.get("unif")
        if unif is None:
            unif = (torch.rand((n_actions, B, d), generator=generator,
                               device=generator.device, dtype=obs.dtype)
                    .to(obs.device) * (2.0 * action_scale) - action_scale)
        with torch.no_grad():  # the policy's samples carry no gradient
            draws = []
            for key in ("cur", "nxt"):
                z = noise.get(key)
                draws.append(z if z is not None else _gaussian(
                    generator, (n_actions, B, d), obs))
            pi_cur, logp_cur = actor_sample(params["actor"], obs, None,
                                            action_scale, draws[0])
            pi_nxt, logp_nxt = actor_sample(params["actor"],
                                            batch["next_obs"], None,
                                            action_scale, draws[1])
            # actor_sample's logp is the density of tanh(u) on [-1,1]^d;
            # the action it returns lives on [-scale, scale]^d — add the
            # change-of-variables term so policy rows are commensurate with
            # the uniform rows in the logsumexp
            scale_corr = d * math.log(action_scale)
            log_unif_density = -math.log(2.0 * action_scale) * d
            corr = torch.cat([
                torch.full_like(logp_cur, log_unif_density),
                logp_cur - scale_corr, logp_nxt - scale_corr], dim=0)
        acts = torch.cat([unif, pi_cur, pi_nxt], dim=0)      # [3n, B, d]
        obs3 = obs.expand(acts.shape[0], *obs.shape)
        pen = 0.0
        for name in ("q1", "q2"):
            cat = q_value(params[name], obs3, acts) - corr   # [3n, B]
            lse = torch.logsumexp(cat, dim=0) - log_3n
            pen = pen + torch.mean(lse - q_data[name])
        return pen

    def update(params, target_q, batch, generator=None, noise=None):
        noise = noise or {}
        target = soft_target(params, target_q, batch, gamma=gamma,
                             action_scale=action_scale, generator=generator,
                             noise=noise.get("next"))
        q_data = {q: q_value(params[q], batch["obs"], batch["actions"])
                  for q in ("q1", "q2")}
        bellman = (torch.mean((q_data["q1"] - target) ** 2)
                   + torch.mean((q_data["q2"] - target) ** 2))
        penalty = _conservative_penalty(params, batch, q_data, generator,
                                        noise)
        q_loss = bellman + cql_alpha * penalty
        _step(optimizers["q"], q_loss, learner_mod.leaves(
            {"q1": params["q1"], "q2": params["q2"]}))
        metrics = actor_and_alpha_steps(
            params, optimizers, batch, q_loss,
            torch.mean(q_data["q1"].detach()), action_scale=action_scale,
            target_entropy=target_entropy, autotune=autotune,
            generator=generator, noise=noise.get("pi"))
        metrics["cql_penalty"] = penalty.detach()
        polyak_(target_q, {"q1": params["q1"], "q2": params["q2"]}, tau)
        return metrics

    return update


def load_transitions(offline_data) -> dict:
    """Materialize a transition dataset ({obs, action, reward, next_obs,
    done} rows) into stacked float32 numpy arrays."""
    rows_iter = (offline_data.iter_rows()
                 if hasattr(offline_data, "iter_rows") else iter(offline_data))
    obs, acts, rews, nxt, dones = [], [], [], [], []
    for row in rows_iter:
        obs.append(np.asarray(row["obs"], np.float32))
        acts.append(np.asarray(row["action"], np.float32).reshape(-1))
        rews.append(float(row["reward"]))
        nxt.append(np.asarray(row["next_obs"], np.float32))
        dones.append(bool(row.get("done", False)))
    return {"obs": np.stack(obs), "actions": np.stack(acts),
            "rewards": np.asarray(rews, np.float32),
            "next_obs": np.stack(nxt), "dones": np.asarray(dones, bool)}


class OfflineBatches:
    """A transition dataset on the learner's device, and each iteration's
    uniform minibatch indices drawn at once from the seeded numpy
    generator (one host-to-device copy an iteration)."""

    def __init__(self, data: dict, device, seed: int):
        self.data = learner_mod.batch_to(data, device)
        self.n = len(data["rewards"])
        self.device = device
        self.rng = np.random.default_rng(seed)

    def iteration(self, num_updates: int, batch_size: int):
        sel = torch.as_tensor(self.rng.integers(
            0, self.n, (num_updates, batch_size)), device=self.device)
        for row in sel:
            yield {k: v[row] for k, v in self.data.items()}


class CQL(Algorithm):
    def _setup(self):
        cfg = self.config
        if cfg.offline_data is None or cfg.obs_dim is None or cfg.action_dim is None:
            raise ValueError(
                "CQL needs .offline(offline_data=..., obs_dim=..., "
                "action_dim=...)")
        self._batches = OfflineBatches(load_transitions(cfg.offline_data),
                                       self.device, cfg.seed)
        target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                          else -float(cfg.action_dim))
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = init_sac_params(
            torch.Generator().manual_seed(cfg.seed), cfg.obs_dim,
            cfg.action_dim, hidden=cfg.model_hidden,
            initial_alpha=cfg.initial_alpha, device=self.device)
        self.target_q = snapshot({"q1": self.params["q1"],
                                  "q2": self.params["q2"]})
        self.optimizers = sac_optimizers(self.params, cfg.lr)
        self._update = make_cql_update(
            self.optimizers, gamma=cfg.gamma, tau=cfg.tau,
            action_scale=cfg.action_scale, target_entropy=target_entropy,
            autotune=cfg.autotune_alpha, cql_alpha=cfg.cql_alpha,
            n_actions=cfg.num_cql_actions)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 7)
        self._num_updates = 0

    def training_step(self) -> dict:
        cfg = self.config
        m: dict = {}
        for batch in self._batches.iteration(cfg.num_updates_per_step,
                                             cfg.train_batch_size):
            m = self._update(self.params, self.target_q, batch,
                             self.generator)
            self._num_updates += 1
        out = learner_mod.floats(m)
        out["num_updates"] = self._num_updates
        return out

    def compute_single_action(self, obs) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.device)[None]
            return actor_mean(self.params["actor"], x,
                              self.config.action_scale)[0].cpu().numpy()


CQLConfig.algo_class = CQL
