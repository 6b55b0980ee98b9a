"""Vectorized environments (numpy, dependency-free).

(reference: RLlib consumes gymnasium envs via EnvRunners
(rllib/env/single_agent_env_runner.py:68); the framework ships a built-in
vectorized CartPole so rollout/learning paths are self-contained — physics
per the classic control formulation. A numpy copy of the JAX package's
module: the same seed gives bit-equal observations, rewards and dones.)
"""

from __future__ import annotations

import numpy as np


class VectorEnv:
    """Batch-first env API: reset()->obs [N,obs]; step(actions [N]) ->
    (obs, reward [N], done [N], info). Auto-resets finished sub-envs."""

    num_envs: int
    obs_dim: int
    num_actions: int

    def reset(self, seed: int | None = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        raise NotImplementedError


class CartPoleVecEnv(VectorEnv):
    """N independent CartPole-v1 dynamics, vectorized over numpy."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    X_LIMIT = 2.4
    THETA_LIMIT = 12 * np.pi / 180
    MAX_STEPS = 500

    def __init__(self, num_envs: int = 16, seed: int = 0):
        self.num_envs = num_envs
        self.obs_dim = 4
        self.num_actions = 2
        self.rng = np.random.default_rng(seed)
        self.state = np.zeros((num_envs, 4), np.float64)
        self.steps = np.zeros(num_envs, np.int64)
        self.episode_returns = np.zeros(num_envs, np.float64)
        self.completed_returns: list[float] = []

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, (self.num_envs, 4))
        self.steps[:] = 0
        self.episode_returns[:] = 0
        return self.state.astype(np.float32)

    def _reset_rows(self, rows: np.ndarray):
        self.state[rows] = self.rng.uniform(-0.05, 0.05, (rows.sum(), 4))
        self.steps[rows] = 0
        self.episode_returns[rows] = 0

    def step(self, actions: np.ndarray):
        x, x_dot, th, th_dot = self.state.T
        force = np.where(actions == 1, self.FORCE, -self.FORCE)
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos, sin = np.cos(th), np.sin(th)
        tmp = (force + pole_ml * th_dot**2 * sin) / total_mass
        th_acc = (self.GRAVITY * sin - cos * tmp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * cos**2 / total_mass))
        x_acc = tmp - pole_ml * th_acc * cos / total_mass
        x = x + self.DT * x_dot
        x_dot = x_dot + self.DT * x_acc
        th = th + self.DT * th_dot
        th_dot = th_dot + self.DT * th_acc
        self.state = np.stack([x, x_dot, th, th_dot], axis=1)
        self.steps += 1
        terminated = (np.abs(x) > self.X_LIMIT) | (np.abs(th) > self.THETA_LIMIT)
        truncated = self.steps >= self.MAX_STEPS
        done = terminated | truncated
        reward = np.ones(self.num_envs, np.float32)
        self.episode_returns += reward
        for r in self.episode_returns[done]:
            self.completed_returns.append(float(r))
        if done.any():
            self._reset_rows(done)
        return self.state.astype(np.float32), reward, done, {}

    def drain_episode_returns(self) -> list[float]:
        out, self.completed_returns = self.completed_returns, []
        return out


class PendulumVecEnv(VectorEnv):
    """N independent Pendulum-v1 dynamics (classic control formulation):
    continuous torque in [-2, 2], obs = (cos th, sin th, th_dot), reward
    -(th^2 + 0.1 th_dot^2 + 0.001 a^2), 200-step episodes."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    def __init__(self, num_envs: int = 16, seed: int = 0):
        self.num_envs = num_envs
        self.obs_dim = 3
        self.num_actions = 0          # discrete-action API: none
        self.action_dim = 1           # continuous torque
        self.action_low = -self.MAX_TORQUE
        self.action_high = self.MAX_TORQUE
        self.rng = np.random.default_rng(seed)
        self.th = np.zeros(num_envs)
        self.th_dot = np.zeros(num_envs)
        self.steps = np.zeros(num_envs, np.int64)
        self.episode_returns = np.zeros(num_envs, np.float64)
        self.completed_returns: list[float] = []

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self.th), np.sin(self.th), self.th_dot],
                        axis=1).astype(np.float32)

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.th = self.rng.uniform(-np.pi, np.pi, self.num_envs)
        self.th_dot = self.rng.uniform(-1.0, 1.0, self.num_envs)
        self.steps[:] = 0
        self.episode_returns[:] = 0
        return self._obs()

    def step(self, actions: np.ndarray):
        a = np.clip(np.asarray(actions, np.float64).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th_norm = ((self.th + np.pi) % (2 * np.pi)) - np.pi
        reward = -(th_norm ** 2 + 0.1 * self.th_dot ** 2 + 0.001 * a ** 2)
        self.th_dot = np.clip(
            self.th_dot + (3 * self.G / (2 * self.L) * np.sin(self.th)
                           + 3.0 / (self.M * self.L ** 2) * a) * self.DT,
            -self.MAX_SPEED, self.MAX_SPEED)
        self.th = self.th + self.th_dot * self.DT
        self.steps += 1
        self.episode_returns += reward
        done = self.steps >= self.MAX_STEPS
        info = {}
        if done.any():
            # Pendulum never terminates — done is always a TIME-LIMIT
            # truncation. Bootstrapping code needs the pre-reset final
            # observation and the truncation mask, or it would zero the
            # continuation value at step 200 (a biased Bellman target).
            info = {"truncated": done.copy(), "final_obs": self._obs()}
            self.completed_returns.extend(self.episode_returns[done].tolist())
            rows = done
            self.th[rows] = self.rng.uniform(-np.pi, np.pi, rows.sum())
            self.th_dot[rows] = self.rng.uniform(-1.0, 1.0, rows.sum())
            self.steps[rows] = 0
            self.episode_returns[rows] = 0
        return self._obs(), reward.astype(np.float32), done, info

    def drain_episode_returns(self) -> list[float]:
        out, self.completed_returns = self.completed_returns, []
        return out


ENV_REGISTRY = {"CartPole-v1": CartPoleVecEnv,
                "Pendulum-v1": PendulumVecEnv}


def make_vec_env(env_id, num_envs: int, seed: int = 0) -> VectorEnv:
    if callable(env_id):
        return env_id(num_envs=num_envs, seed=seed)
    return ENV_REGISTRY[env_id](num_envs=num_envs, seed=seed)
