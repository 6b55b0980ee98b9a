"""APPO: asynchronous PPO — IMPALA's decoupled actor-learner machinery with
a clipped surrogate objective and a periodically-refreshed target policy.

(reference: rllib/algorithms/appo/ — APPO = IMPALA architecture + PPO
surrogate; the target network anchors the update so stale rollouts can't
blow it up, and V-trace still corrects the off-policy value targets. The
learner subclasses ImpalaLearner and overrides ONLY the loss + the
target-refresh hook; runners, streams, restart-on-death and async weight
pushes are inherited unchanged.)
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithms.dqn import snapshot
from ray_tpu_torch.rllib.algorithms.impala import (IMPALA, IMPALAConfig,
                                                   ImpalaLearner)
from ray_tpu_torch.rllib.env import make_vec_env


class APPOConfig(IMPALAConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.clip_param = 0.2
        self.kl_coeff = 0.1
        self.target_update_frequency = 4  # learner updates between refreshes

    def training(self, *, kl_coeff=None,
                 target_update_frequency=None, **kwargs) -> "APPOConfig":
        super().training(**kwargs)  # clip_param rides the base handler
        for name, val in (("kl_coeff", kl_coeff),
                          ("target_update_frequency", target_update_frequency)):
            if val is not None:
                setattr(self, name, val)
        return self


class AppoLearner(ImpalaLearner):
    """V-trace advantages + PPO clipped surrogate + target-policy KL."""

    def __init__(self, *args, clip_param: float = 0.2, kl_coeff: float = 0.1,
                 target_update_frequency: int = 4, **kwargs):
        self.clip_param = clip_param
        self.kl_coeff = kl_coeff
        self.target_update_frequency = max(1, int(target_update_frequency))
        super().__init__(*args, **kwargs)

    def _loss(self, p, target_params, batch):
        target_logp, logp_all, values, vs, pg_adv = self._policy_terms(
            p, batch)
        # the population std, as jnp.std gives
        adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(correction=0) + 1e-8)
        # clipped surrogate on the behavior-policy ratio
        ratio = torch.exp(target_logp - batch["behavior_logp"])
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param) * adv)
        pg_loss = -torch.mean(surr)
        vf_loss = 0.5 * torch.mean((vs - values) ** 2)
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        # KL(target || current) anchors the update across async staleness
        # (reference: appo's lagging target network, not last-iter weights,
        # because rollouts arrive at arbitrary lag); no gradient reaches the
        # target
        T, N = batch["rewards"].shape
        with torch.no_grad():
            t_logits, _ = rl_module.forward(target_params,
                                            batch["obs"].reshape(T * N, -1))
            t_logp_all = torch.log_softmax(t_logits, dim=-1)
        kl = torch.mean(torch.sum(
            torch.exp(t_logp_all) * (t_logp_all - logp_all), dim=-1))
        loss = (pg_loss + self.vf_coef * vf_loss - self.ent_coef * ent
                + self.kl_coeff * kl)
        return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": ent,
                      "kl": kl}

    def _post_update(self):
        if self.version % self.target_update_frequency == 0:
            self.target_params = snapshot(self.params)


class APPO(IMPALA):
    """IMPALA's runner/stream/restart machinery with the APPO learner."""

    def _setup(self):
        cfg = self.config
        probe = make_vec_env(cfg.env_id, 1, cfg.seed)
        self.learner = AppoLearner(
            probe.obs_dim, probe.num_actions, lr=cfg.lr,
            hidden=cfg.model_hidden, vf_coef=cfg.vf_loss_coeff,
            ent_coef=cfg.entropy_coeff, gamma=cfg.gamma,
            rho_bar=getattr(cfg, "rho_bar", 1.0),
            c_bar=getattr(cfg, "c_bar", 1.0),
            clip_param=cfg.clip_param, kl_coeff=cfg.kl_coeff,
            target_update_frequency=cfg.target_update_frequency,
            seed=cfg.seed, device=self.device)
        self._start_runners()


APPOConfig.algo_class = APPO
