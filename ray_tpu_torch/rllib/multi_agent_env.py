"""Multi-agent vectorized environments.

(reference: rllib/env/multi_agent_env.py:30 — MultiAgentEnv hosts multiple
agents identified by string AgentIDs; reset/step speak per-agent dicts and
per-agent termination. The reference's canonical test envs are
MultiAgentCartPole — one independent CartPole per agent — and the
rock-paper-scissors / coordination matrix games in rllib/examples/envs.

Design difference: the reference steps ONE env per runner and
vectorizes via many runner processes; here each env object is itself
vectorized over N sub-envs (batch-first numpy, like env.py's VectorEnv),
so a single policy forward per step serves N x n_agents decisions. All
agents act every step (simultaneous-move games); per-agent termination is
a per-agent [N] bool with independent auto-reset, the vector equivalent
of the reference's per-agent "done" dict + "__all__". A numpy copy of the
JAX package's module: the same seed gives bit-equal observations, rewards
and dones.)
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.env import CartPoleVecEnv


class MultiAgentVecEnv:
    """Batch-first multi-agent API.

    reset() -> {agent_id: obs [N, obs_dim]}
    step({agent_id: actions [N]}) ->
        ({agent_id: obs}, {agent_id: rew [N]}, {agent_id: done [N]}, info)

    `agent_ids` is the fixed roster (reference: MultiAgentEnv.possible_agents);
    every agent observes and acts each step. Sub-env auto-reset is per
    agent, so agents' episodes are independent unless the env couples them.
    """

    agent_ids: list[str]
    num_envs: int
    obs_dims: dict[str, int]
    num_actions: dict[str, int]

    def reset(self, seed: int | None = None) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: dict[str, np.ndarray]):
        raise NotImplementedError

    def drain_episode_returns(self) -> dict[str, list[float]]:
        raise NotImplementedError


class MultiAgentCartPoleVecEnv(MultiAgentVecEnv):
    """K independent CartPole dynamics, one per agent, vectorized over N
    sub-envs (reference: rllib/examples/envs/classes/multi_agent/...
    MultiAgentCartPole — the standard multi-agent smoke/learning env).
    Agents are physically independent; what's shared is the runner's
    batched inference and, under a shared policy mapping, the weights."""

    def __init__(self, num_envs: int = 16, seed: int = 0, num_agents: int = 2):
        self.agent_ids = [f"agent_{i}" for i in range(num_agents)]
        self.num_envs = num_envs
        self._envs = {
            a: CartPoleVecEnv(num_envs=num_envs, seed=seed + 131 * i)
            for i, a in enumerate(self.agent_ids)
        }
        self.obs_dims = {a: 4 for a in self.agent_ids}
        self.num_actions = {a: 2 for a in self.agent_ids}

    def reset(self, seed: int | None = None):
        return {a: e.reset(None if seed is None else seed + 131 * i)
                for i, (a, e) in enumerate(self._envs.items())}

    def step(self, actions):
        obs, rews, dones = {}, {}, {}
        for a, e in self._envs.items():
            obs[a], rews[a], dones[a], _ = e.step(actions[a])
        return obs, rews, dones, {}

    def drain_episode_returns(self):
        return {a: e.drain_episode_returns() for a, e in self._envs.items()}


class CoordinationGameVecEnv(MultiAgentVecEnv):
    """Two-player repeated coordination game where the agents' rewards are
    COUPLED — the env that makes policy interaction observable (reference:
    the matrix-game examples under rllib/examples/envs; same role as
    rock_paper_scissors for testing multi-policy learning).

    Each step both agents pick one of A actions. Payoff: +1 to both if the
    actions match on action 0, +0.5 if they match on any other action, 0 on
    mismatch — so the unique optimum needs BOTH policies to converge on
    action 0. Obs is the one-hot of the opponent's previous action (plus a
    leading "first step" flag), episodes are fixed `episode_len` steps.
    Random play scores ~episode_len * (1 + 0.5*(A-1))/A^2; coordinated play
    scores episode_len."""

    def __init__(self, num_envs: int = 16, seed: int = 0, *,
                 num_actions: int = 3, episode_len: int = 25):
        self.agent_ids = ["player_0", "player_1"]
        self.num_envs = num_envs
        self.A = num_actions
        self.episode_len = episode_len
        self.obs_dims = {a: num_actions + 1 for a in self.agent_ids}
        self.num_actions = {a: num_actions for a in self.agent_ids}
        self.rng = np.random.default_rng(seed)
        self.steps = np.zeros(num_envs, np.int64)
        self.prev = {a: np.full(num_envs, -1, np.int64) for a in self.agent_ids}
        self.episode_returns = {a: np.zeros(num_envs) for a in self.agent_ids}
        self.completed: dict[str, list[float]] = {a: [] for a in self.agent_ids}

    def _obs_for(self, agent: str) -> np.ndarray:
        other = self.agent_ids[1 - self.agent_ids.index(agent)]
        prev = self.prev[other]
        out = np.zeros((self.num_envs, self.A + 1), np.float32)
        first = prev < 0
        out[first, 0] = 1.0
        rows = ~first
        out[rows, 1 + prev[rows]] = 1.0
        return out

    def reset(self, seed: int | None = None):
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.steps[:] = 0
        for a in self.agent_ids:
            self.prev[a][:] = -1
            self.episode_returns[a][:] = 0
        return {a: self._obs_for(a) for a in self.agent_ids}

    def step(self, actions):
        # copy: these are stored into self.prev and mutated on reset —
        # never alias caller-owned action buffers
        a0 = np.array(actions["player_0"], np.int64, copy=True)
        a1 = np.array(actions["player_1"], np.int64, copy=True)
        match = a0 == a1
        rew = np.where(match & (a0 == 0), 1.0,
                       np.where(match, 0.5, 0.0)).astype(np.float32)
        self.prev["player_0"], self.prev["player_1"] = a0, a1
        self.steps += 1
        done = self.steps >= self.episode_len
        rews = {}
        for a in self.agent_ids:
            self.episode_returns[a] += rew
            rews[a] = rew
        if done.any():
            for a in self.agent_ids:
                self.completed[a].extend(
                    self.episode_returns[a][done].tolist())
                self.episode_returns[a][done] = 0
                self.prev[a][done] = -1
            self.steps[done] = 0
        obs = {a: self._obs_for(a) for a in self.agent_ids}
        return obs, rews, {a: done.copy() for a in self.agent_ids}, {}

    def drain_episode_returns(self):
        out = {a: self.completed[a] for a in self.agent_ids}
        self.completed = {a: [] for a in self.agent_ids}
        return out


MULTI_AGENT_ENV_REGISTRY = {
    "MultiAgentCartPole": MultiAgentCartPoleVecEnv,
    "CoordinationGame": CoordinationGameVecEnv,
}


def make_multi_agent_env(env_id, num_envs: int, seed: int = 0,
                         **env_config) -> MultiAgentVecEnv:
    if callable(env_id):
        return env_id(num_envs=num_envs, seed=seed, **env_config)
    return MULTI_AGENT_ENV_REGISTRY[env_id](num_envs=num_envs, seed=seed,
                                            **env_config)
