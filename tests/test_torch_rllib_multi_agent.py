"""The port's multi-agent RLlib against the JAX package's.

Parity on the CPU: the multi-agent envs are bit-equal to the reference's
for the same seeds and actions. Then twins of
tests/test_rllib_multi_agent.py (all 7) against the port's runtime, with
the reference's thresholds and iteration counts; the learners on the CPU
(``.learners(device="cpu")``), the runners CPU actors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import (CoordinationGameVecEnv,
                                 MultiAgentCartPoleVecEnv, MultiRLModuleSpec,
                                 PPOConfig, RLModuleSpec, init_multi)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This process's torch on one intra-op thread, as each env runner's:
    a 64-wide MLP gains nothing from more, and under the suite's parallel
    workers spinning OpenMP threads slow each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("env_id,env_config,n_act", [
    ("MultiAgentCartPole", {"num_agents": 3}, 2),
    ("CoordinationGame", {"num_actions": 3, "episode_len": 7}, 3)])
def test_multi_agent_envs_bit_equal_to_the_reference(env_id, env_config,
                                                     n_act):
    from ray_tpu.rllib import multi_agent_env as jenv
    from ray_tpu_torch.rllib import multi_agent_env as penv

    for seed in (0, 5):
        ref, port = (m.make_multi_agent_env(env_id, 4, seed, **env_config)
                     for m in (jenv, penv))
        assert port.agent_ids == ref.agent_ids
        assert port.obs_dims == ref.obs_dims
        assert port.num_actions == ref.num_actions
        o1, o2 = ref.reset(seed), port.reset(seed)
        for a in ref.agent_ids:
            np.testing.assert_array_equal(o2[a], o1[a])
        rng = np.random.default_rng(seed)
        for _ in range(120):
            acts = {a: rng.integers(0, n_act, 4) for a in ref.agent_ids}
            out1 = ref.step(acts)
            out2 = port.step(acts)
            for d1, d2 in zip(out1[:3], out2[:3]):
                assert set(d1) == set(d2)
                for a in d1:
                    assert d1[a].dtype == d2[a].dtype
                    np.testing.assert_array_equal(d2[a], d1[a])
        assert port.drain_episode_returns() == ref.drain_episode_returns()


@pytest.fixture
def rl_cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=16, num_workers=2, max_workers=8)
    yield
    ray_tpu_torch.shutdown()


# ------------------------------ twins of tests/test_rllib_multi_agent.py


def test_multi_agent_cartpole_env_api():
    env = MultiAgentCartPoleVecEnv(num_envs=4, seed=0, num_agents=3)
    assert env.agent_ids == ["agent_0", "agent_1", "agent_2"]
    obs = env.reset(0)
    assert set(obs) == set(env.agent_ids)
    assert all(o.shape == (4, 4) for o in obs.values())
    total_done = {a: 0 for a in env.agent_ids}
    for _ in range(300):
        acts = {a: np.random.randint(0, 2, 4) for a in env.agent_ids}
        obs, rews, dones, _ = env.step(acts)
        for a in env.agent_ids:
            assert rews[a].shape == (4,)
            total_done[a] += dones[a].sum()
    rets = env.drain_episode_returns()
    for a in env.agent_ids:
        # random play ends episodes; per-agent returns tracked separately
        assert total_done[a] > 0
        assert len(rets[a]) == total_done[a]


def test_coordination_game_env_coupled_rewards():
    env = CoordinationGameVecEnv(num_envs=8, seed=0, num_actions=3,
                                 episode_len=10)
    env.reset(0)
    # matching on 0 pays 1 to BOTH; mismatch pays 0 to both
    obs, rews, dones, _ = env.step({"player_0": np.zeros(8, np.int64),
                                    "player_1": np.zeros(8, np.int64)})
    assert np.allclose(rews["player_0"], 1.0)
    assert np.allclose(rews["player_1"], 1.0)
    # each player's obs encodes the OPPONENT's previous action (one-hot 0)
    assert np.allclose(obs["player_0"][:, 1], 1.0)
    obs, rews, dones, _ = env.step({"player_0": np.zeros(8, np.int64),
                                    "player_1": np.ones(8, np.int64)})
    assert np.allclose(rews["player_0"], 0.0)
    assert np.allclose(rews["player_1"], 0.0)
    # fixed-length truncation with per-agent completed returns
    for _ in range(8):
        _, _, dones, _ = env.step({"player_0": np.zeros(8, np.int64),
                                   "player_1": np.zeros(8, np.int64)})
    assert dones["player_0"].all() and dones["player_1"].all()
    rets = env.drain_episode_returns()
    assert len(rets["player_0"]) == 8


def test_multi_rl_module_spec_init():
    spec = MultiRLModuleSpec({
        "p0": RLModuleSpec(obs_dim=4, num_actions=2),
        "p1": RLModuleSpec(obs_dim=4, num_actions=3, hidden=(32,)),
        "p2": RLModuleSpec(obs_dim=4, num_actions=2),
    })
    params = init_multi(torch.Generator().manual_seed(0), spec, device="cpu")
    assert set(params) == {"p0", "p1", "p2"}
    assert params["p0"]["pi"]["w"].shape[-1] == 2
    assert params["p1"]["pi"]["w"].shape == (32, 3)
    # independent inits: same-shape policies get different weights
    assert not np.allclose(params["p0"]["layers"]["0"]["w"].numpy(),
                           params["p2"]["layers"]["0"]["w"].numpy())


def test_multi_agent_runner_batches_per_policy(rl_cluster):
    """The runner returns one time-major batch PER POLICY with the batch
    axis n_mapped_agents * N, and a single policy forward serves all of
    its agents."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.rllib import rl_module
    from ray_tpu_torch.rllib.multi_agent_runner import MultiAgentEnvRunner

    mapping = {"agent_0": "shared", "agent_1": "shared", "agent_2": "solo"}
    runner = MultiAgentEnvRunner.remote(
        "MultiAgentCartPole", 4, ser.dumps(mapping.get), 0,
        {"num_agents": 3})
    params = {
        "shared": rl_module.init(torch.Generator().manual_seed(0), 4, 2,
                                 device="cpu"),
        "solo": rl_module.init(torch.Generator().manual_seed(1), 4, 2,
                               device="cpu"),
    }
    out = ray_tpu_torch.get(runner.sample.remote(
        ser.dumps(rl_module.to_numpy(params)), 8), timeout=120)
    assert set(out) == {"shared", "solo", "__episode_returns__"}
    assert out["shared"]["obs"].shape == (8, 2 * 4, 4)  # 2 agents x 4 envs
    assert out["solo"]["obs"].shape == (8, 1 * 4, 4)
    assert out["shared"]["last_value"].shape == (8,)
    assert set(out["__episode_returns__"]) == set(mapping)


def test_multi_agent_ppo_shared_policy_learns(rl_cluster):
    """One shared policy serving both CartPole agents reaches the same
    learning bar as single-agent PPO (reference:
    tuned_examples/ppo/multi_agent_cartpole_ppo.py)."""
    algo = (
        PPOConfig()
        .environment("MultiAgentCartPole", env_config={"num_agents": 2})
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .training(lr=1e-3, minibatch_size=256, num_epochs=4)
        .multi_agent(policies=["shared"],
                     policy_mapping_fn=lambda agent_id: "shared")
        .learners(device="cpu")
        .debugging(seed=0)
        .build()
    )
    try:
        first, last = None, None
        for _ in range(12):
            result = algo.train()
            ret = result["env_runners"]["episode_return_mean"]
            if not np.isnan(ret):
                if first is None:
                    first = ret
                last = ret
        assert first is not None and last is not None
        assert last > first + 20, (first, last)
        assert last > 60, last
        per_agent = result["env_runners"]["agent_episode_returns"]
        assert set(per_agent) == {"agent_0", "agent_1"}
        # the SHARED policy serves both agents: both improve together
        assert all(v > 40 for v in per_agent.values()), per_agent
    finally:
        algo.stop()


def test_multi_agent_ppo_independent_policies_coordinate(rl_cluster):
    """Two INDEPENDENT policies co-adapt in the coordination game: the
    optimum (both always play action 0) requires each policy to learn
    against the other's evolving behavior — the interaction single-agent
    training can't express."""
    algo = (
        PPOConfig()
        .environment("CoordinationGame",
                     env_config={"num_actions": 3, "episode_len": 25})
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=50)
        .training(lr=3e-3, minibatch_size=256, num_epochs=4,
                  entropy_coeff=0.003)
        .multi_agent(policies=["p0", "p1"],
                     policy_mapping_fn=lambda aid: {"player_0": "p0",
                                                    "player_1": "p1"}[aid])
        .learners(device="cpu")
        .debugging(seed=1)
        .build()
    )
    try:
        assert set(algo.learners) == {"p0", "p1"}
        last = None
        for _ in range(25):
            result = algo.train()
            ret = result["env_runners"]["episode_return_mean"]
            if not np.isnan(ret):
                last = ret
        # random play in a 3-action game scores ~25*(1+0.5*2)/9 = 5.6;
        # coordinated play scores 25. Require clear co-adaptation.
        assert last is not None and last > 15, last
    finally:
        algo.stop()


def test_multi_agent_checkpoint_restore(rl_cluster, tmp_path):
    cfg = (
        PPOConfig()
        .environment("MultiAgentCartPole", env_config={"num_agents": 2})
        .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                     rollout_fragment_length=16)
        .multi_agent(policies=["a", "b"],
                     policy_mapping_fn=lambda aid: {"agent_0": "a",
                                                    "agent_1": "b"}[aid])
        .learners(device="cpu")
        .debugging(seed=0)
    )
    algo = cfg.build()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        want = {pid: rl_module_leaves(lrn.params)
                for pid, lrn in algo.learners.items()}
    finally:
        algo.stop()

    algo2 = cfg.build()
    try:
        algo2.restore(path)
        for pid, lrn in algo2.learners.items():
            got = rl_module_leaves(lrn.params)
            assert len(got) == len(want[pid])
            for w, g in zip(want[pid], got):
                np.testing.assert_allclose(w, g, rtol=1e-6, atol=1e-6)
        # restored policies keep training (multi-agent step runs clean)
        algo2.train()
    finally:
        algo2.stop()


def rl_module_leaves(params) -> list:
    from ray_tpu_torch.rllib.learner import leaves

    return [t.detach().cpu().numpy().copy() for t in leaves(params)]


def test_multi_agent_config_validation():
    # an agent whose mapping points outside the configured policies fails
    # at build time, not as a KeyError mid-rollout
    cfg = (
        PPOConfig()
        .environment("MultiAgentCartPole", env_config={"num_agents": 2})
        .multi_agent(policies=["only_agent_0"],
                     policy_mapping_fn=lambda aid: aid)
        .learners(device="cpu")
    )
    with pytest.raises(ValueError, match="map outside|no agents"):
        cfg.build()
