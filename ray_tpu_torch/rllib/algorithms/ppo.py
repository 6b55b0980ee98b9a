"""PPO: clipped-surrogate policy optimization.

(reference: rllib/algorithms/ppo/ — PPOConfig + PPO(Algorithm);
training_step (algorithm.py:2274 pattern): sample from EnvRunnerGroup →
GAE → epochs of minibatch SGD on the Learner → sync weights back to
runners. GAE and the updates run on the learner's device (learner.py).)
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup


class PPOConfig(AlgorithmConfig):
    algo_class = None  # set below


def _train_batch(samples: list, device, gamma: float, lam: float) -> dict:
    """Runner fragments (time-major numpy) → one flat train batch on
    `device`, with GAE advantages and returns computed there."""
    batches = []
    for s in samples:
        s = learner_mod.batch_to(
            {k: s[k] for k in ("obs", "actions", "logp", "values", "rewards",
                               "dones", "last_value")}, device)
        advs, rets = learner_mod.compute_gae(
            s["rewards"], s["values"], s["dones"], s["last_value"],
            gamma=gamma, lam=lam)
        T, N = s["rewards"].shape
        batches.append({
            "obs": s["obs"].reshape(T * N, -1),
            "actions": s["actions"].reshape(T * N),
            "logp_old": s["logp"].reshape(T * N),
            "advantages": advs.reshape(T * N),
            "returns": rets.reshape(T * N),
        })
    return {k: torch.cat([b[k] for b in batches]) for k in batches[0]}


class PPO(Algorithm):
    def _setup(self):
        cfg = self.config
        if cfg.policies is not None:
            self._setup_multi_agent()
            return
        probe = make_vec_env(cfg.env_id, 1, cfg.seed)
        self.learner = learner_mod.Learner(
            probe.obs_dim, probe.num_actions, lr=cfg.lr,
            hidden=cfg.model_hidden, clip=cfg.clip_param,
            vf_coef=cfg.vf_loss_coeff, ent_coef=cfg.entropy_coeff,
            seed=cfg.seed, device=self.device)
        self.runner_group = EnvRunnerGroup(
            cfg.env_id, num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner, seed=cfg.seed)

    def _setup_multi_agent(self):
        """Per-policy Learners + MultiAgentEnvRunnerGroup (reference:
        PPO handles multi-agent through the same Algorithm class once
        config.multi_agent() is set; learners are per-module —
        core/learner + multi_rl_module.py)."""
        cfg = self.config
        from ray_tpu_torch.rllib.multi_agent_env import make_multi_agent_env
        from ray_tpu_torch.rllib.multi_agent_runner import \
            MultiAgentEnvRunnerGroup
        from ray_tpu_torch.rllib.multi_rl_module import RLModuleSpec

        mapping = cfg.policy_mapping_fn or (lambda agent_id: "default_policy")
        probe = make_multi_agent_env(cfg.env_id, 1, cfg.seed,
                                     **cfg.env_config)
        # infer unspecified policy specs from the first agent mapped there
        specs: dict[str, RLModuleSpec] = {}
        for pid, spec in cfg.policies.items():
            served = [a for a in probe.agent_ids if mapping(a) == pid]
            if not served:
                raise ValueError(
                    f"policy {pid!r} has no agents under policy_mapping_fn")
            # every agent a policy serves must share one interface — a
            # mismatch would otherwise only surface as a shape error
            # inside the remote runner, where the fault-tolerant group
            # swallows it into a silent kill/respawn loop
            dims = {(probe.obs_dims[a], probe.num_actions[a])
                    for a in served}
            if len(dims) > 1:
                raise ValueError(
                    f"policy {pid!r} serves agents with mismatched "
                    f"(obs_dim, num_actions): "
                    f"{ {a: (probe.obs_dims[a], probe.num_actions[a]) for a in served} }")
            obs_dim, n_act = next(iter(dims))
            if spec is not None:
                if (spec.obs_dim, spec.num_actions) != (obs_dim, n_act):
                    raise ValueError(
                        f"policy {pid!r} spec ({spec.obs_dim}, "
                        f"{spec.num_actions}) does not match its agents' "
                        f"env interface ({obs_dim}, {n_act})")
                specs[pid] = spec
                continue
            specs[pid] = RLModuleSpec(obs_dim, n_act, cfg.model_hidden)
        unmapped = [a for a in probe.agent_ids
                    if mapping(a) not in cfg.policies]
        if unmapped:
            raise ValueError(
                f"agents {unmapped} map outside configured policies "
                f"{sorted(cfg.policies)}")
        self.learners = {
            pid: learner_mod.Learner(
                s.obs_dim, s.num_actions, lr=cfg.lr, hidden=s.hidden,
                clip=cfg.clip_param, vf_coef=cfg.vf_loss_coeff,
                ent_coef=cfg.entropy_coeff, seed=cfg.seed + 31 * i,
                device=self.device)
            for i, (pid, s) in enumerate(sorted(specs.items()))
        }
        self.runner_group = MultiAgentEnvRunnerGroup(
            cfg.env_id, num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner,
            mapping_fn=mapping, seed=cfg.seed, env_config=cfg.env_config)
        self._agent_episode_returns = {a: [] for a in probe.agent_ids}

    def _multi_agent_step(self) -> dict:
        from ray_tpu_torch._private import serialization as ser

        cfg = self.config
        blob = ser.dumps({pid: rl_module.to_numpy(lrn.params)
                          for pid, lrn in self.learners.items()})
        samples = self.runner_group.sample(blob, cfg.rollout_fragment_length)
        if not samples:
            return {}
        metrics: dict = {}
        for pid, lrn in self.learners.items():
            mine = [s[pid] for s in samples if pid in s]
            if not mine:
                continue
            batch = _train_batch(mine, lrn.device, cfg.gamma, cfg.lam)
            mb = min(cfg.minibatch_size, batch["obs"].shape[0])
            metrics[pid] = lrn.update(batch, minibatch_size=mb,
                                      num_epochs=cfg.num_epochs,
                                      rng=self.rng)
        for s in samples:
            per_agent = s.get("__episode_returns__", {})
            step_all: list[float] = []
            for a, vals in per_agent.items():
                self._agent_episode_returns.setdefault(a, []).extend(vals)
                step_all.extend(vals)
            self._episode_returns.extend(step_all)
        return metrics

    def training_step(self) -> dict:
        cfg = self.config
        if cfg.policies is not None:
            return self._multi_agent_step()
        blob = self.learner.get_weights_blob()
        samples = self.runner_group.sample(blob, cfg.rollout_fragment_length)
        if not samples:
            return {}
        batch = _train_batch(samples, self.learner.device, cfg.gamma, cfg.lam)
        for s in samples:
            self._episode_returns.extend(s["episode_returns"])
        mb = min(cfg.minibatch_size, batch["obs"].shape[0])
        return self.learner.update(batch, minibatch_size=mb,
                                   num_epochs=cfg.num_epochs, rng=self.rng)


PPOConfig.algo_class = PPO
