"""AlgorithmConfig builder + Algorithm base.

(reference: rllib/algorithms/algorithm_config.py — the fluent
.environment()/.env_runners()/.training() builder; algorithm.py:213
Algorithm with train() → result dict and save/restore via Checkpointable.)

The port adds ``.learners(device=)``: where the learner's params and
optimizer live. None (the default) is the card and raises without one, as
``resolve_device(None)`` does; ``"cpu"`` is the CPU. The env runners are
CPU actors whatever it says (env_runner.py).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


class AlgorithmConfig:
    def __init__(self):
        self.env_id: Any = "CartPole-v1"
        self.num_env_runners = 2
        self.num_envs_per_runner = 8
        self.rollout_fragment_length = 64
        self.lr = 3e-4
        self.gamma = 0.99
        self.lam = 0.95
        self.minibatch_size = 256
        self.num_epochs = 4
        self.clip_param = 0.2
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.model_hidden = (64, 64)
        self.seed = 0
        self.env_config: dict = {}
        # multi-agent (reference: algorithm_config.py multi_agent() —
        # policies + policy_mapping_fn switch the whole stack to the
        # MultiAgentEnvRunner / per-policy learner path)
        self.policies: dict | None = None
        self.policy_mapping_fn = None
        # the learner's device: None is the card (resolve_device)
        self.learner_device = None

    def environment(self, env=None, *, env_config=None,
                    **_ignored) -> "AlgorithmConfig":
        if env is not None:
            self.env_id = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None,
                    **_ignored) -> "AlgorithmConfig":
        """(reference: algorithm_config.py:multi_agent — `policies` names
        the module ids (dict id -> RLModuleSpec-or-None, or an iterable of
        ids with specs inferred from the env), `policy_mapping_fn`
        (agent_id) -> policy_id decides which module serves which agent.)"""
        if policies is not None:
            if isinstance(policies, dict):
                self.policies = dict(policies)
            else:
                self.policies = {p: None for p in policies}
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def env_runners(self, *, num_env_runners=None, num_envs_per_env_runner=None,
                    rollout_fragment_length=None, **_ignored) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, gamma=None, lambda_=None, minibatch_size=None,
                 num_epochs=None, clip_param=None, vf_loss_coeff=None,
                 entropy_coeff=None, model=None, **_ignored) -> "AlgorithmConfig":
        for name, v in (("lr", lr), ("gamma", gamma), ("lam", lambda_),
                        ("minibatch_size", minibatch_size),
                        ("num_epochs", num_epochs), ("clip_param", clip_param),
                        ("vf_loss_coeff", vf_loss_coeff),
                        ("entropy_coeff", entropy_coeff)):
            if v is not None:
                setattr(self, name, v)
        if model and "fcnet_hiddens" in model:
            self.model_hidden = tuple(model["fcnet_hiddens"])
        return self

    def learners(self, *, device=None, **_ignored) -> "AlgorithmConfig":
        """Where the learner lives: ``"cuda"`` (what None means too) or
        ``"cpu"``. The port's own builder method: the JAX package's learner
        is wherever jax puts it."""
        if device is not None:
            self.learner_device = device
        return self

    def debugging(self, *, seed=None, **_ignored) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def build(self) -> "Algorithm":
        return self.algo_class(self)


def _merge(old: dict, new) -> None:
    """Copy a loaded checkpoint tree into the live params in place (an
    optimizer holds the live tensors), cast to each leaf's dtype; keys and
    shapes must match."""
    if isinstance(old, dict):
        if not isinstance(new, dict) or set(old) != set(new):
            raise ValueError(f"checkpoint keys {sorted(new)} do not match "
                             f"the module's {sorted(old)}")
        for k in old:
            _merge(old[k], new[k])
        return
    src = torch.as_tensor(new)
    if tuple(src.shape) != tuple(old.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(src.shape)} for "
                         f"a param of shape {tuple(old.shape)}")
    with torch.no_grad():
        old.copy_(src.to(dtype=old.dtype))


class Algorithm:
    """(reference: rllib/algorithms/algorithm.py:213 — iteration =
    training_step(); results carry env_runners/learner metric trees.)"""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch._device import resolve_device

        self.config = config
        # resolved first: without a card and without .learners(device=
        # "cpu") the build raises before any runner starts
        self.device = resolve_device(config.learner_device)
        self.iteration = 0
        self._episode_returns: list[float] = []
        self.rng = np.random.default_rng(config.seed)
        self._setup()

    def _setup(self):
        raise NotImplementedError

    def training_step(self) -> dict:
        raise NotImplementedError

    def train(self) -> dict:
        self.iteration += 1
        metrics = self.training_step()
        recent = self._episode_returns[-100:]
        out = {
            "training_iteration": self.iteration,
            "env_runners": {
                "episode_return_mean": float(np.mean(recent)) if recent else float("nan"),
                "num_episodes": len(self._episode_returns),
            },
            "learners": metrics,
        }
        # multi-agent: per-agent return means alongside the aggregate
        # (reference: result dicts carry env_runners/module_... subtrees)
        agent_returns = getattr(self, "_agent_episode_returns", None)
        if agent_returns:
            out["env_runners"]["agent_episode_returns"] = {
                a: float(np.mean(v[-100:])) if v else float("nan")
                for a, v in agent_returns.items()
            }
        return out

    def save(self, path: str) -> str:
        from ray_tpu_torch.llm import checkpoint_io

        os.makedirs(path, exist_ok=True)
        learners = getattr(self, "learners", None)
        if learners is not None:  # multi-agent: one subdir per module id
            for mid, lrn in learners.items():
                checkpoint_io.save_params(lrn.params,
                                          os.path.join(path, "module", mid))
        else:
            checkpoint_io.save_params(self.learner.params,
                                      os.path.join(path, "module"))
        return path

    def restore(self, path: str) -> None:
        from ray_tpu_torch.llm import checkpoint_io

        learners = getattr(self, "learners", None)
        if learners is not None:
            for mid, lrn in learners.items():
                _merge(lrn.params, checkpoint_io.load_params(
                    os.path.join(path, "module", mid)))
        else:
            _merge(self.learner.params, checkpoint_io.load_params(
                os.path.join(path, "module")))

    def stop(self):
        if hasattr(self, "runner_group"):
            self.runner_group.shutdown()
