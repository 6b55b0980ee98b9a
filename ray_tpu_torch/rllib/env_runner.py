"""EnvRunner: the rollout actor.

(reference: rllib/env/single_agent_env_runner.py:68 — owns a vector env +
inference-only module copy; sample() returns batched trajectories;
EnvRunnerGroup (env/env_runner_group.py:69) fans out across actors and
restarts failed ones (FaultAwareApply, env/env_runner.py:36).)

Placement: runners are CPU actors (``num_gpus=0``, one CPU each, as the
reference's are). Each runs its inference copy of the module on
``device="cpu"`` with a seeded ``torch.Generator`` and limits torch's
intra-op threads to its CPU share, so many runners on one host do not
oversubscribe it. Only the learner lives on the card.
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch

# each runner's CPU share, and so its torch intra-op threads
RUNNER_NUM_CPUS = 1


def _runner_torch(seed: int):
    """torch, limited to the runner's CPU share, and the runner's seeded
    CPU generator."""
    import torch

    torch.set_num_threads(RUNNER_NUM_CPUS)
    return torch.Generator(device="cpu").manual_seed(seed)


def _params(params_blob: bytes) -> dict:
    """A learner's weight blob (numpy leaves) → the runner's CPU copy."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.rllib import rl_module

    return rl_module.params_from_jax(ser.loads(params_blob), device="cpu")


@ray_tpu_torch.remote(num_cpus=RUNNER_NUM_CPUS, num_gpus=0)
class EnvRunner:
    def __init__(self, env_id, num_envs: int, seed: int = 0):
        from ray_tpu_torch.rllib.env import make_vec_env

        self.gen = _runner_torch(seed)
        self.env = make_vec_env(env_id, num_envs, seed)
        self.obs = self.env.reset(seed)
        self.num_envs = num_envs
        self._params_blob = None  # pushed by set_weights (IMPALA streaming)

    def _rollout(self, params, num_steps: int) -> dict:
        """Shared on-policy rollout loop: time-major buffers for one
        fragment (sample() adds values/bootstrap for GAE; stream_rollouts
        relabels logp as the behavior policy for V-trace)."""
        from ray_tpu_torch.rllib import rl_module

        T, N = num_steps, self.num_envs
        obs_buf = np.zeros((T, N, self.env.obs_dim), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        for t in range(T):
            action, logp, value = rl_module.forward_exploration(
                params, self.obs, self.gen)
            action = action.numpy()
            obs_buf[t] = self.obs
            act_buf[t] = action
            logp_buf[t] = logp.numpy()
            val_buf[t] = value.numpy()
            self.obs, rew_buf[t], done_buf[t], _ = self.env.step(action)
        return {"obs": obs_buf, "actions": act_buf, "logp": logp_buf,
                "values": val_buf, "rewards": rew_buf, "dones": done_buf}

    def sample(self, params_blob: bytes, num_steps: int) -> dict:
        """Roll `num_steps` per sub-env; returns time-major arrays
        [T, N, ...] plus bootstrap values for GAE."""
        import torch

        from ray_tpu_torch.rllib import rl_module

        params = _params(params_blob)
        out = self._rollout(params, num_steps)
        with torch.no_grad():
            _, last_value = rl_module.forward(params, self.obs)
        out["last_value"] = last_value.numpy()
        out["episode_returns"] = self.env.drain_episode_returns()
        return out

    def sample_epsilon_greedy(self, params_blob: bytes, num_steps: int,
                              epsilon: float) -> dict:
        """Off-policy rollout: epsilon-greedy over Q-values (the module's
        pi head doubles as the Q head). Returns transitions incl. next_obs
        for replay (reference: DQN rollout workers)."""
        import torch

        from ray_tpu_torch.rllib import rl_module

        params = _params(params_blob)
        T, N = num_steps, self.num_envs
        obs_buf = np.zeros((T, N, self.env.obs_dim), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        rew_buf = np.zeros((T, N), np.float32)
        next_buf = np.zeros((T, N, self.env.obs_dim), np.float32)
        done_buf = np.zeros((T, N), np.bool_)
        rng = np.random.default_rng(int(torch.randint(
            0, 2**31 - 1, (), generator=self.gen)))
        for t in range(T):
            greedy = rl_module.forward_inference(params, self.obs).numpy()
            explore = rng.random(N) < epsilon
            random_a = rng.integers(0, self.env.num_actions, N)
            action = np.where(explore, random_a, greedy).astype(np.int32)
            obs_buf[t] = self.obs
            act_buf[t] = action
            self.obs, rew_buf[t], done_buf[t], _ = self.env.step(action)
            next_buf[t] = self.obs
        return {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "next_obs": next_buf, "dones": done_buf,
            "episode_returns": self.env.drain_episode_returns(),
        }

    def set_weights(self, params_blob: bytes) -> None:
        """Async weight push from the learner (IMPALA): picked up by the
        streaming rollout loop at its next batch boundary. Runs on a second
        concurrency slot while stream_rollouts occupies the first."""
        self._params_blob = params_blob

    def stream_rollouts(self, num_steps: int, max_batches: int = 1_000_000):
        """Continuous trajectory stream (IMPALA's decoupled sampling):
        yields time-major batches produced with the most recently pushed
        weights, tagging each with the behavior policy's logp so the
        learner can V-trace-correct the off-policy gap. Producer-side
        backpressure bounds how far ahead of the learner this runs."""
        import time as _time

        while self._params_blob is None:  # first weight push may race us in
            _time.sleep(0.01)
        for _ in range(max_batches):
            roll = self._rollout(_params(self._params_blob), num_steps)
            yield {
                "obs": roll["obs"], "actions": roll["actions"],
                "behavior_logp": roll["logp"], "rewards": roll["rewards"],
                "dones": roll["dones"],
                "bootstrap_obs": np.asarray(self.obs, np.float32),
                "episode_returns": self.env.drain_episode_returns(),
            }

    def ping(self) -> bool:
        return True


class EnvRunnerGroup:
    """(reference: env/env_runner_group.py:69 — healthy-set management +
    restart of dead runners.)"""

    def __init__(self, env_id, *, num_runners: int = 2, num_envs_per_runner: int = 8,
                 seed: int = 0):
        self.env_id = env_id
        self.num_envs_per_runner = num_envs_per_runner
        self.seed = seed
        self.runners = [self._make_runner(seed + 1000 * i)
                        for i in range(num_runners)]

    def _make_runner(self, seed: int):
        """Runner factory — subclasses (MultiAgentEnvRunnerGroup) override
        this so __init__ and the fault-tolerant replace path share it."""
        return EnvRunner.remote(self.env_id, self.num_envs_per_runner, seed)

    def _collect(self, refs) -> list[dict]:
        out = []
        for i, ref in refs:
            try:
                out.append(ray_tpu_torch.get(ref, timeout=120.0))
            except Exception:
                # fault tolerance: replace the failed runner; its sample is lost
                # this iteration (reference: FaultAwareApply restart semantics).
                # Kill first — a merely-slow runner would otherwise leak alive.
                try:
                    ray_tpu_torch.kill(self.runners[i])
                except Exception:
                    pass
                self.runners[i] = self._make_runner(self.seed + 7777 + i)
        return out

    def sample(self, params_blob: bytes, num_steps: int) -> list[dict]:
        return self._collect([(i, r.sample.remote(params_blob, num_steps))
                              for i, r in enumerate(self.runners)])

    def sample_epsilon_greedy(self, params_blob: bytes, num_steps: int,
                              epsilon: float) -> list[dict]:
        return self._collect(
            [(i, r.sample_epsilon_greedy.remote(params_blob, num_steps, epsilon))
             for i, r in enumerate(self.runners)])

    def shutdown(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
