"""DQN: double Q-learning with a target network and replay buffer.

(reference: rllib/algorithms/dqn/ — DQNConfig/DQN with replay + target-net
sync + double-Q; Rainbow extensions out of scope. The online and target
params live on the learner's device; rollout exploration is epsilon-greedy
on the CPU runners.)
"""

from __future__ import annotations

import torch

from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, _merge
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.replay import ReplayBuffer


class DQNConfig(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.buffer_size = 50_000
        self.train_batch_size = 64
        self.target_update_freq = 200     # updates between target syncs
        self.num_updates_per_step = 8
        self.learning_starts = 500        # min transitions before updates
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_decay_steps = 5_000  # env steps to anneal over
        self.double_q = True

    def training(self, *, buffer_size=None, train_batch_size=None,
                 target_update_freq=None, num_updates_per_step=None,
                 learning_starts=None, epsilon_initial=None,
                 epsilon_final=None, epsilon_decay_steps=None,
                 double_q=None, **kwargs) -> "DQNConfig":
        super().training(**kwargs)
        for name, val in (("buffer_size", buffer_size),
                          ("train_batch_size", train_batch_size),
                          ("target_update_freq", target_update_freq),
                          ("num_updates_per_step", num_updates_per_step),
                          ("learning_starts", learning_starts),
                          ("epsilon_initial", epsilon_initial),
                          ("epsilon_final", epsilon_final),
                          ("epsilon_decay_steps", epsilon_decay_steps),
                          ("double_q", double_q)):
            if val is not None:
                setattr(self, name, val)
        return self


def snapshot(params: dict) -> dict:
    """A detached copy of the params: the target network."""
    if isinstance(params, torch.Tensor):
        return params.detach().clone()
    return {k: snapshot(v) for k, v in params.items()}


def make_dqn_update(optimizer: torch.optim.Optimizer, *, gamma: float,
                    double_q: bool):
    """-> update(params, target_params, batch) → metrics: one TD step of
    `optimizer` (whose leaves are `params`') on the Huber loss at delta 1
    (optax.huber_loss's default), the target held constant."""

    def update(params: dict, target_params: dict, batch: dict) -> dict:
        actions = batch["actions"].long()
        q_all, _ = rl_module.forward(params, batch["obs"])       # [B, A]
        q = q_all.gather(1, actions[:, None])[:, 0]
        with torch.no_grad():  # the stop-gradient target
            qt_all, _ = rl_module.forward(target_params, batch["next_obs"])
            if double_q:
                qo_all, _ = rl_module.forward(params, batch["next_obs"])
                a_star = torch.argmax(qo_all, dim=-1)
                q_next = qt_all.gather(1, a_star[:, None])[:, 0]
            else:
                q_next = qt_all.max(dim=-1).values
            nonterminal = 1.0 - batch["dones"].to(torch.float32)
            target = batch["rewards"] + gamma * nonterminal * q_next
        td = q - target
        loss = torch.nn.functional.huber_loss(q, target, reduction="mean",
                                              delta=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        td = td.detach()
        return {"td_error_mean": td.abs().mean(), "q_mean": q.detach().mean(),
                "total_loss": loss.detach()}

    return update


class DQN(Algorithm):
    def _setup(self):
        cfg = self.config
        probe = make_vec_env(cfg.env_id, 1, cfg.seed)
        self.obs_dim, self.num_actions = probe.obs_dim, probe.num_actions
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = rl_module.init(torch.Generator().manual_seed(cfg.seed),
                                     self.obs_dim, self.num_actions,
                                     cfg.model_hidden, device=self.device)
        self.target_params = snapshot(self.params)
        self._make_optimizer()
        self.buffer = ReplayBuffer(cfg.buffer_size, self.obs_dim,
                                   seed=cfg.seed)
        self.runner_group = EnvRunnerGroup(
            cfg.env_id, num_runners=cfg.num_env_runners,
            num_envs_per_runner=cfg.num_envs_per_runner, seed=cfg.seed)
        self._env_steps = 0
        self._num_updates = 0

    def _make_optimizer(self):
        cfg = self.config
        self.optimizer = learner_mod.make_optimizer(self.params, cfg.lr)
        self._update = make_dqn_update(self.optimizer, gamma=cfg.gamma,
                                       double_q=cfg.double_q)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def training_step(self) -> dict:
        cfg = self.config
        from ray_tpu_torch._private import serialization as ser

        blob = ser.dumps(rl_module.to_numpy(self.params))
        samples = self.runner_group.sample_epsilon_greedy(
            blob, cfg.rollout_fragment_length, self._epsilon())
        for s in samples:
            T, N = s["rewards"].shape
            self.buffer.add_batch(
                s["obs"].reshape(T * N, -1), s["actions"].reshape(T * N),
                s["rewards"].reshape(T * N),
                s["next_obs"].reshape(T * N, -1), s["dones"].reshape(T * N))
            self._env_steps += T * N
            self._episode_returns.extend(s["episode_returns"])
        metrics: dict = {"epsilon": self._epsilon(),
                         "buffer_size": len(self.buffer)}
        if len(self.buffer) < cfg.learning_starts:
            return metrics
        m: dict = {}
        for _ in range(cfg.num_updates_per_step):
            batch = learner_mod.batch_to(
                self.buffer.sample(cfg.train_batch_size), self.device)
            m = self._update(self.params, self.target_params, batch)
            self._num_updates += 1
            if self._num_updates % cfg.target_update_freq == 0:
                self.target_params = snapshot(self.params)
        metrics.update(learner_mod.floats(m))
        metrics["num_updates"] = self._num_updates
        return metrics

    def save(self, path: str) -> str:
        import os

        from ray_tpu_torch.llm import checkpoint_io

        os.makedirs(path, exist_ok=True)
        checkpoint_io.save_params(self.params, os.path.join(path, "module"))
        return path

    def restore(self, path: str) -> None:
        import os

        from ray_tpu_torch.llm import checkpoint_io

        _merge(self.params, checkpoint_io.load_params(
            os.path.join(path, "module")))
        self.target_params = snapshot(self.params)
        self._make_optimizer()  # fresh Adam state, as the reference's init


DQNConfig.algo_class = DQN
