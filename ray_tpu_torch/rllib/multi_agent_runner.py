"""MultiAgentEnvRunner: the multi-agent rollout actor.

(reference: rllib/env/multi_agent_env_runner.py:68 — owns ONE
MultiAgentEnv + a MultiRLModule; maps each agent's observation through
the policy-mapping function to the module that serves it, and returns
per-module sample batches. rllib/env/env_runner_group.py:69 fans runners
out across actors and replaces failed ones.

All agents mapped to a module are batched into ONE forward per step —
[n_mapped_agents * N, obs_dim] — so a runner does len(modules) forwards
per step regardless of agent count, and the returned per-module batches
are time-major [T, n_mapped * N, ...], ready for the same GAE + PPO update
the single-agent path uses. Placement as env_runner.py's: a CPU actor, its
module copies on ``device="cpu"``, one seeded ``torch.Generator``.)
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.env_runner import (RUNNER_NUM_CPUS, EnvRunnerGroup,
                                            _params, _runner_torch)


@ray_tpu_torch.remote(num_cpus=RUNNER_NUM_CPUS, num_gpus=0)
class MultiAgentEnvRunner:
    def __init__(self, env_id, num_envs: int, mapping_blob: bytes,
                 seed: int = 0, env_config: dict | None = None):
        from ray_tpu_torch._private import serialization as ser
        from ray_tpu_torch.rllib.multi_agent_env import make_multi_agent_env

        self.gen = _runner_torch(seed)
        self.env = make_multi_agent_env(env_id, num_envs, seed,
                                        **(env_config or {}))
        self.obs = self.env.reset(seed)
        self.num_envs = num_envs
        # policy_mapping_fn(agent_id) -> module_id, fixed for the run
        # (reference: AlgorithmConfig.multi_agent(policy_mapping_fn=...))
        self.mapping = ser.loads(mapping_blob)
        self.agents_of: dict[str, list[str]] = {}
        for a in self.env.agent_ids:
            self.agents_of.setdefault(self.mapping(a), []).append(a)

    def _forward_policy(self, params, agents: list[str]):
        """One batched exploration forward for every agent this module
        serves: obs [n_agents * N, obs] -> per-agent action slices."""
        from ray_tpu_torch.rllib import rl_module

        stacked = np.concatenate([self.obs[a] for a in agents], axis=0)
        action, logp, value = rl_module.forward_exploration(
            params, stacked, self.gen)
        return action.numpy(), logp.numpy(), value.numpy(), stacked

    def sample(self, params_blob: bytes, num_steps: int) -> dict:
        """Roll `num_steps`; returns {module_id: time-major batch} where
        the batch axis is n_mapped_agents * N (agent-major blocks), plus
        bootstrap values and per-agent episode returns."""
        import torch

        from ray_tpu_torch.rllib import rl_module

        params_multi = _params(params_blob)
        T, N = num_steps, self.num_envs
        bufs = {}
        for mid, agents in self.agents_of.items():
            M = len(agents) * N
            obs_dim = self.env.obs_dims[agents[0]]
            bufs[mid] = {
                "obs": np.zeros((T, M, obs_dim), np.float32),
                "actions": np.zeros((T, M), np.int32),
                "logp": np.zeros((T, M), np.float32),
                "values": np.zeros((T, M), np.float32),
                "rewards": np.zeros((T, M), np.float32),
                "dones": np.zeros((T, M), np.bool_),
            }
        for t in range(T):
            act_dict = {}
            for mid, agents in self.agents_of.items():
                action, logp, value, stacked = self._forward_policy(
                    params_multi[mid], agents)
                b = bufs[mid]
                b["obs"][t] = stacked
                b["actions"][t] = action
                b["logp"][t] = logp
                b["values"][t] = value
                for j, a in enumerate(agents):
                    act_dict[a] = action[j * N:(j + 1) * N]
            self.obs, rews, dones, _ = self.env.step(act_dict)
            for mid, agents in self.agents_of.items():
                b = bufs[mid]
                b["rewards"][t] = np.concatenate(
                    [rews[a] for a in agents])
                b["dones"][t] = np.concatenate([dones[a] for a in agents])
        out = {}
        for mid, agents in self.agents_of.items():
            stacked = np.concatenate([self.obs[a] for a in agents], axis=0)
            with torch.no_grad():
                _, last_value = rl_module.forward(params_multi[mid], stacked)
            b = bufs[mid]
            b["last_value"] = last_value.numpy()
            out[mid] = b
        out["__episode_returns__"] = self.env.drain_episode_returns()
        return out

    def ping(self) -> bool:
        return True


class MultiAgentEnvRunnerGroup(EnvRunnerGroup):
    """(reference: env/env_runner_group.py:69 — the same healthy-set
    management as the single-agent group; only the runner factory differs,
    so sample()'s kill-and-replace fault tolerance is inherited.)"""

    def __init__(self, env_id, *, num_runners: int = 2,
                 num_envs_per_runner: int = 8, mapping_fn=None, seed: int = 0,
                 env_config: dict | None = None):
        from ray_tpu_torch._private import serialization as ser

        # set before super().__init__ — the base constructor calls
        # _make_runner, which needs these
        self.env_config = env_config or {}
        self._mapping_blob = ser.dumps(mapping_fn)
        super().__init__(env_id, num_runners=num_runners,
                         num_envs_per_runner=num_envs_per_runner, seed=seed)

    def _make_runner(self, seed: int):
        return MultiAgentEnvRunner.remote(
            self.env_id, self.num_envs_per_runner, self._mapping_blob,
            seed, self.env_config)
