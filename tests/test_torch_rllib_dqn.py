"""The port's DQN against the JAX package's.

Parity on the CPU, inputs from a numpy seed: one and three
``make_dqn_update`` steps (double Q on and off) from the same params,
target params, fresh Adam state and minibatches give params and metrics
within 2e-5 (f32). Then twins of tests/test_rllib_dqn.py against the port's
runtime, with the reference's thresholds and iteration counts; the learner
on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ray_tpu_torch

PARITY_TOL = 2e-5  # f32 update steps, port vs JAX package


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This process's torch on one intra-op thread, as each env runner's:
    a 64-wide MLP gains nothing from more, and under the suite's parallel
    workers spinning OpenMP threads slow each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree) -> dict:
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update({f"{k}/{p}": x for p, x in _leaves(v).items()})
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _dqn_minibatch(seed, n=64):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": np.ones(n, np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "dones": rng.random(n) < 0.2,
    }


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_update_matches_the_reference(double_q, steps):
    import jax
    import optax

    from ray_tpu.rllib import rl_module as jrl
    from ray_tpu.rllib.algorithms.dqn import make_dqn_update as jmake
    from ray_tpu_torch.rllib import learner, rl_module
    from ray_tpu_torch.rllib.algorithms.dqn import make_dqn_update, snapshot

    jax.config.update("jax_platforms", "cpu")
    jp = jax.device_get(jrl.init(jax.random.PRNGKey(0), 4, 2))
    # a target that differs from the online params, as after some updates
    jt = jax.device_get(jrl.init(jax.random.PRNGKey(1), 4, 2))
    opt = optax.adam(1e-3)
    jupdate = jmake(opt, gamma=0.99, double_q=double_q)
    jstate = opt.init(jp)
    params = rl_module.params_from_jax(jp, device="cpu")
    target = rl_module.params_from_jax(jt, device="cpu")
    target0 = snapshot(target)
    tupdate = make_dqn_update(learner.make_optimizer(params, 1e-3),
                              gamma=0.99, double_q=double_q)
    for step in range(steps):
        mb = _dqn_minibatch(step)
        jp, jstate, jm = jupdate(jp, jt, jstate,
                                 {k: jax.numpy.asarray(v)
                                  for k, v in mb.items()})
        tm = tupdate(params, target, learner.batch_to(
            mb, torch.device("cpu")))
    a, b = _leaves(params), _leaves(jax.device_get(jp))
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=PARITY_TOL,
                                   atol=PARITY_TOL, err_msg=k)
    tm, jm = learner.floats(tm), {k: float(v) for k, v in jm.items()}
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= PARITY_TOL * max(1.0, abs(jm[k])), \
            (k, tm[k], jm[k])
    # the target is held constant (no gradient reaches it)
    for k, v in _leaves(target0).items():
        np.testing.assert_array_equal(_leaves(target)[k], v)


# --------------------------------------- twins of tests/test_rllib_dqn.py


@pytest.fixture(scope="module")
def session():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4, num_workers=2, max_workers=8)
    yield
    ray_tpu_torch.shutdown()


def test_replay_buffer_ring_and_sampling():
    from ray_tpu_torch.rllib import ReplayBuffer

    rb = ReplayBuffer(capacity=10, obs_dim=3, seed=0)
    for i in range(4):
        rb.add_batch(np.full((3, 3), i, np.float32), np.full((3,), i, np.int32),
                     np.full((3,), float(i), np.float32),
                     np.full((3, 3), i + 1, np.float32),
                     np.zeros((3,), np.bool_))
    assert len(rb) == 10  # 12 added into capacity 10
    batch = rb.sample(8)
    assert batch["obs"].shape == (8, 3)
    # oldest entries (i=0) were overwritten by the ring
    assert batch["actions"].min() >= 0


def test_dqn_learns_cartpole(session):
    from ray_tpu_torch.rllib import DQNConfig

    algo = (
        DQNConfig()
        .environment(env="CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8)
        .training(lr=1e-3, gamma=0.99, buffer_size=20_000,
                  train_batch_size=64, target_update_freq=200,
                  num_updates_per_step=48, learning_starts=400,
                  epsilon_decay_steps=4_000)
        .learners(device="cpu")
        .debugging(seed=0)
        .build()
    )
    try:
        best = 0.0
        for i in range(40):
            result = algo.train()
            mean = result["env_runners"]["episode_return_mean"]
            if mean == mean:  # not NaN
                best = max(best, mean)
            if best >= 60.0:
                break
        assert best >= 60.0, f"DQN failed to learn (best mean return {best})"
        assert result["learners"]["num_updates"] > 0
        assert result["learners"]["epsilon"] < 1.0
    finally:
        algo.stop()


def test_dqn_save_restore(tmp_path, session):
    from ray_tpu_torch.rllib import DQNConfig

    algo = (DQNConfig().environment(env="CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4)
            .training(learning_starts=50, num_updates_per_step=2)
            .learners(device="cpu")
            .build())
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        algo2 = (DQNConfig().environment(env="CartPole-v1")
                 .env_runners(num_env_runners=1, num_envs_per_env_runner=4)
                 .learners(device="cpu")
                 .build())
        algo2.restore(path)
        a, b = _leaves(algo.params), _leaves(algo2.params)
        assert set(a) == set(b)
        assert all(np.allclose(a[k], b[k]) for k in a)
        # the target follows the restored params, the Adam state is fresh
        t = _leaves(algo2.target_params)
        assert all(np.array_equal(t[k], b[k]) for k in b)
        assert not algo2.optimizer.state
        algo2.stop()
    finally:
        algo.stop()


@pytest.mark.slow  # the original is slow: conftest marks all of its module
def test_bc_imitates_offline_dataset(session):
    """BC on a synthetic expert dataset (action = deterministic fn of obs)
    reaches high imitation accuracy; works from a ray_tpu_torch.data
    Dataset."""
    import ray_tpu_torch.data as rtd
    from ray_tpu_torch.rllib import BCConfig

    rng = np.random.default_rng(0)
    rows = []
    for _ in range(2000):
        obs = rng.normal(size=4).astype(np.float32)
        action = int(obs[0] + obs[2] > 0)  # "expert" rule
        rows.append({"obs": obs.tolist(), "action": action})
    ds = rtd.from_items(rows)

    algo = (BCConfig()
            .offline(offline_data=ds, obs_dim=4, num_actions=2,
                     train_batch_size=256)
            .training(lr=1e-2)
            .learners(device="cpu")
            .debugging(seed=0)
            .build())
    acc = 0.0
    for _ in range(8):
        result = algo.train()
        acc = result["learners"]["imitation_accuracy"]
        if acc >= 0.95:
            break
    assert acc >= 0.9, f"BC did not imitate (accuracy {acc})"
    assert result["learners"]["num_samples_trained"] == 2000
    # the learned policy matches the expert rule on fresh samples
    test_obs = rng.normal(size=(64, 4)).astype(np.float32)
    pred = algo.predict(test_obs)
    want = (test_obs[:, 0] + test_obs[:, 2] > 0).astype(np.int32)
    assert (pred == want).mean() >= 0.9
