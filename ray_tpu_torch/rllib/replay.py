"""Replay buffer for off-policy algorithms.

(reference: rllib/utils/replay_buffers/ — EpisodeReplayBuffer and the
prioritized variants behind DQN/SAC; here a flat uniform ring buffer in
numpy, sampled into the learner's update batches.)
"""

from __future__ import annotations

import numpy as np


class ReplayBuffer:
    """Uniform-sampling ring buffer over transitions."""

    def __init__(self, capacity: int, obs_dim: int, seed: int = 0,
                 action_dim: int = 0):
        """action_dim=0 → discrete int actions; >0 → continuous
        [capacity, action_dim] float actions (SAC)."""
        self.capacity = int(capacity)
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        if action_dim > 0:
            self.actions = np.zeros((capacity, action_dim), np.float32)
        else:
            self.actions = np.zeros((capacity,), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.dones = np.zeros((capacity,), np.bool_)
        self.rng = np.random.default_rng(seed)
        self._idx = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> None:
        """Append [B, ...] arrays of transitions."""
        n = len(actions)
        idx = (self._idx + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.next_obs[idx] = next_obs
        self.dones[idx] = dones
        self._idx = int((self._idx + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))

    def sample(self, batch_size: int) -> dict:
        idx = self.rng.integers(0, self._size, size=batch_size)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "dones": self.dones[idx],
        }
