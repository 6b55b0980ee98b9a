"""The port's RLlib core and PPO against the JAX package's.

Parity on the CPU, inputs from a numpy seed, the JAX package on the CPU:
- the vector envs and the replay buffer are bit-equal for the same seeds;
- ``rl_module.forward`` on ``params_from_jax`` of the reference's init
  within 2e-5 (f32);
- ``compute_gae`` within 1e-5;
- one and three ``make_ppo_update`` steps from the same params, fresh Adam
  state and minibatch: params and metrics within 2e-5;
- ``forward_exploration`` samples the softmax (a chi-square test);
- checkpoints both ways: the JAX package's PPO (single and multi-agent)
  saves and the port restores, and the other way, with equal greedy
  actions on seeded observations.

Then twins of tests/test_rllib.py against the port's runtime, with the
reference's thresholds and iteration counts; the learner on the CPU
(``.learners(device="cpu")``: without it and without a card a build
raises), the runners CPU actors as always.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import CartPoleVecEnv, PPOConfig, compute_gae

PARITY_TOL = 2e-5  # f32 forward and update steps, port vs JAX package
GAE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This process's torch on one intra-op thread, as each env runner's:
    a 64-wide MLP gains nothing from more, and under the suite's parallel
    workers spinning OpenMP threads slow each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _leaves(tree) -> dict:
    """Flat {path: numpy} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update({f"{k}/{p}": x for p, x in _leaves(v).items()})
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def _assert_trees_close(port, ref, tol):
    a, b = _leaves(port), _leaves(ref)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


def _jax_params(seed, obs_dim=4, num_actions=2, hidden=(64, 64)):
    jax = _jax()
    from ray_tpu.rllib import rl_module as jrl

    return jax.device_get(jrl.init(jax.random.PRNGKey(seed), obs_dim,
                                   num_actions, hidden))


# ------------------------------------------------------------------ envs


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_vec_envs_bit_equal_to_the_reference(env_id):
    from ray_tpu.rllib import env as jenv
    from ray_tpu_torch.rllib import env as penv

    for seed in (0, 7):
        ref, port = (m.make_vec_env(env_id, 6, seed) for m in (jenv, penv))
        assert type(port).__name__ == type(ref).__name__
        np.testing.assert_array_equal(port.reset(seed), ref.reset(seed))
        rng = np.random.default_rng(seed)
        for _ in range(450):  # past Pendulum's 200-step truncations
            if env_id == "CartPole-v1":
                act = rng.integers(0, 2, 6)
            else:
                act = rng.uniform(-3, 3, (6, 1)).astype(np.float32)
            o1, r1, d1, i1 = ref.step(act)
            o2, r2, d2, i2 = port.step(act)
            for x, y in ((o1, o2), (r1, r2), (d1, d2)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(y, x)
            assert set(i1) == set(i2)
            for k in i1:
                np.testing.assert_array_equal(i2[k], i1[k])
        assert port.drain_episode_returns() == ref.drain_episode_returns()


def test_replay_buffer_bit_equal_to_the_reference():
    from ray_tpu.rllib.replay import ReplayBuffer as Ref
    from ray_tpu_torch.rllib import ReplayBuffer

    rng = np.random.default_rng(3)
    for action_dim in (0, 2):
        ref = Ref(50, 4, seed=5, action_dim=action_dim)
        port = ReplayBuffer(50, 4, seed=5, action_dim=action_dim)
        for _ in range(7):  # 7 x 9 rows wrap the 50-row ring
            n = 9
            acts = (rng.integers(0, 3, n) if action_dim == 0 else
                    rng.normal(size=(n, action_dim)).astype(np.float32))
            rows = (rng.normal(size=(n, 4)).astype(np.float32), acts,
                    rng.normal(size=n).astype(np.float32),
                    rng.normal(size=(n, 4)).astype(np.float32),
                    rng.random(n) < 0.3)
            ref.add_batch(*rows)
            port.add_batch(*rows)
            assert len(port) == len(ref)
            a, b = port.sample(16), ref.sample(16)
            assert set(a) == set(b)
            for k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------------- rl_module


def test_forward_matches_the_reference_on_its_params():
    jax = _jax()
    from ray_tpu.rllib import rl_module as jrl
    from ray_tpu_torch.rllib import rl_module

    for seed, (obs_dim, n_act, hidden) in enumerate(
            [(4, 2, (64, 64)), (3, 5, (32,)), (7, 3, (16, 8, 16))]):
        jp = _jax_params(seed, obs_dim, n_act, hidden)
        params = rl_module.params_from_jax(jp, device="cpu")
        obs = np.random.default_rng(seed).normal(
            size=(33, obs_dim)).astype(np.float32)
        jl, jv = jax.device_get(jrl.forward(jp, obs))
        tl, tv = rl_module.forward(params, obs)
        np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=PARITY_TOL,
                                   atol=PARITY_TOL)
        np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=PARITY_TOL,
                                   atol=PARITY_TOL)
        # the greedy action: argmax of logits within 2e-5, so compare where
        # the reference's top two are apart by more than the tolerance
        top2 = np.sort(jl, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 4 * PARITY_TOL
        want = np.asarray(jrl.forward_inference(jp, obs))
        got = rl_module.forward_inference(params, obs).numpy()
        np.testing.assert_array_equal(got[clear], want[clear])


def test_params_from_jax_checks_keys_and_shapes():
    from ray_tpu_torch.rllib import rl_module

    jp = _jax_params(0)
    params = rl_module.params_from_jax(jp, device="cpu")
    assert params["layers"]["0"]["w"].shape == (4, 64)  # [in, out] kept
    assert params["pi"]["w"].device.type == "cpu"
    multi = rl_module.params_from_jax({"a": jp, "b": _jax_params(1)},
                                      device="cpu")
    assert set(multi) == {"a", "b"}
    assert not torch.equal(multi["a"]["vf"]["w"], multi["b"]["vf"]["w"])
    bad = {**jp, "pi": {"w": jp["pi"]["w"][:10], "b": jp["pi"]["b"]}}
    with pytest.raises(ValueError, match="pi/w"):
        rl_module.params_from_jax(bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        rl_module.params_from_jax({**jp, "extra": {}}, device="cpu")
    with pytest.raises(ValueError, match="vf/w"):
        rl_module.params_from_jax(
            {**jp, "vf": {"w": np.zeros((64, 2), np.float32),
                          "b": np.zeros(2, np.float32)}}, device="cpu")


def test_forward_exploration_samples_the_softmax():
    """Actions follow softmax(logits) by distribution: a chi-square test
    per row over 4,000 draws (1% critical value of chi2 with 2 degrees of
    freedom: 9.21), on a seeded generator."""
    from ray_tpu_torch.rllib import rl_module

    params = rl_module.init(torch.Generator().manual_seed(0), 4, 3,
                            device="cpu")
    with torch.no_grad():  # logits far from uniform
        params["pi"]["w"].mul_(20.0)
    obs = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
    probs = torch.softmax(rl_module.forward(params, obs)[0], -1).detach()
    assert probs.max() > 0.5 and probs.min() > 0.02
    gen = torch.Generator().manual_seed(1)
    draws = 4000
    counts = np.zeros((5, 3))
    for _ in range(draws):
        action, logp, value = rl_module.forward_exploration(params, obs, gen)
        counts[np.arange(5), action.numpy()] += 1
    np.testing.assert_allclose(logp.exp().numpy(),
                               probs.numpy()[np.arange(5), action.numpy()],
                               rtol=1e-6)
    expected = probs.numpy() * draws
    chi2 = ((counts - expected) ** 2 / expected).sum(axis=1)
    assert (chi2 < 9.21).all(), chi2


# --------------------------------------------------------------- learner


def test_compute_gae_matches_the_reference():
    from ray_tpu.rllib.learner import compute_gae as jgae

    rng = np.random.default_rng(0)
    T, N = 64, 16
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.1
    last = rng.normal(size=(N,)).astype(np.float32)
    ja, jr = jgae(rewards, values, dones, last, gamma=0.99, lam=0.95)
    ta, tr = compute_gae(torch.from_numpy(rewards), torch.from_numpy(values),
                         torch.from_numpy(dones), torch.from_numpy(last),
                         gamma=0.99, lam=0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=GAE_TOL,
                               atol=GAE_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=GAE_TOL,
                               atol=GAE_TOL)


def _ppo_minibatch(seed, n=256):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, 2))
    logp_all = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    actions = rng.integers(0, 2, n).astype(np.int32)
    return {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": actions,
        "logp_old": logp_all[np.arange(n), actions].astype(np.float32),
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": (rng.normal(size=n) * 5).astype(np.float32),
    }


@pytest.mark.parametrize("steps", [1, 3])
def test_ppo_update_matches_the_reference(steps):
    """The same params, fresh Adam state (optax.adam against torch.optim.
    Adam) and minibatches: params and metrics within 2e-5."""
    jax = _jax()
    import optax

    from ray_tpu.rllib.learner import make_ppo_update as jmake
    from ray_tpu_torch.rllib import learner, rl_module

    jp = _jax_params(0)
    opt = optax.adam(1e-3)
    jupdate = jmake(opt, clip=0.2, vf_coef=0.5, ent_coef=0.01)
    jstate = opt.init(jp)
    params = rl_module.params_from_jax(jp, device="cpu")
    tupdate = learner.make_ppo_update(learner.make_optimizer(params, 1e-3),
                                      clip=0.2, vf_coef=0.5, ent_coef=0.01)
    for step in range(steps):
        mb = _ppo_minibatch(step)
        jp, jstate, jm = jupdate(jp, jstate, {k: jax.numpy.asarray(v)
                                              for k, v in mb.items()})
        tm = tupdate(params, learner.batch_to(mb, torch.device("cpu")))
    _assert_trees_close(params, jax.device_get(jp), PARITY_TOL)
    tm, jm = learner.floats(tm), {k: float(v) for k, v in jm.items()}
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= PARITY_TOL * max(1.0, abs(jm[k])), \
            (k, tm[k], jm[k])


def test_learner_without_a_card_raises_unless_asked_for_the_cpu():
    from ray_tpu_torch.rllib import DQNConfig
    from ray_tpu_torch.rllib.learner import Learner

    if torch.cuda.is_available():
        pytest.skip("a card is visible: None means the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Learner(4, 2)
    # an algorithm resolves its learner's device before any runner starts
    for cfg in (PPOConfig(), DQNConfig()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.environment("CartPole-v1").build()
    assert Learner(4, 2, device="cpu").params["pi"]["w"].device.type == "cpu"


def test_weights_blob_holds_host_numpy_leaves():
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.rllib.learner import Learner

    lrn = Learner(4, 2, device="cpu", seed=3)
    tree = ser.loads(lrn.get_weights_blob())
    leaves = _leaves(tree)
    assert leaves and all(type(v) is np.ndarray and v.dtype == np.float32
                          for v in leaves.values())
    _assert_trees_close(lrn.params, tree, 0.0)
    # the same seed gives the same init on any device (drawn on the CPU)
    _assert_trees_close(Learner(4, 2, device="cpu", seed=3).params, tree, 0.0)


# -------------------------------------------------- checkpoints both ways
# Each package's algorithm is built with no env runner, so no session (and
# no store segment) is needed; its params are moved off their init by a
# learner update on a seeded minibatch before each save.


def _rllib(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.rllib")


def _config(pkg: str, multi: bool):
    cfg = _rllib(pkg).PPOConfig().env_runners(num_env_runners=0)
    if multi:
        cfg = (cfg.environment("MultiAgentCartPole",
                               env_config={"num_agents": 2})
               .multi_agent(policies=["a", "b"],
                            policy_mapping_fn=lambda aid: {
                                "agent_0": "a", "agent_1": "b"}[aid]))
    else:
        cfg = cfg.environment("CartPole-v1")
    if pkg == "ray_tpu_torch":  # the port's own builder method
        cfg = cfg.learners(device="cpu")
    return cfg.debugging(seed=0).build()


def _learners(algo, multi: bool) -> dict:
    return dict(algo.learners) if multi else {"module": algo.learner}


def _step(algo, multi: bool, seed: int) -> None:
    for i, lrn in enumerate(_learners(algo, multi).values()):
        lrn.update(_ppo_minibatch(seed + i), minibatch_size=256,
                   num_epochs=1, rng=np.random.default_rng(seed))


def _greedy_equal(jparams, tparams):
    from ray_tpu.rllib import rl_module as jrl
    from ray_tpu_torch.rllib import rl_module

    obs = np.random.default_rng(11).normal(size=(1024, 4)).astype(np.float32)
    want = np.asarray(jrl.forward_inference(jparams, obs))
    got = rl_module.forward_inference(tparams, obs).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("multi", [False, True], ids=["ppo", "multi_agent"])
def test_checkpoints_read_both_ways(tmp_path, multi):
    jax = _jax()
    jalgo = _config("ray_tpu", multi)
    talgo = _config("ray_tpu_torch", multi)
    # the JAX package saves, the port restores
    _step(jalgo, multi, 0)
    talgo.restore(jalgo.save(str(tmp_path / "jax_ckpt")))
    for mid, jl in _learners(jalgo, multi).items():
        jp = jax.device_get(jl.params)
        tp = _learners(talgo, multi)[mid].params
        _assert_trees_close(tp, jp, 0.0)
        _greedy_equal(jp, tp)
    # the port trains on and saves; the JAX package restores
    _step(talgo, multi, 5)
    jalgo.restore(talgo.save(str(tmp_path / "port_ckpt")))
    for mid, tl in _learners(talgo, multi).items():
        jp = jax.device_get(_learners(jalgo, multi)[mid].params)
        _assert_trees_close(tl.params, jp, 0.0)
        _greedy_equal(jp, tl.params)


# ------------------------------------------- twins of tests/test_rllib.py


@pytest.fixture
def rl_cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=16, num_workers=2, max_workers=8)
    yield
    ray_tpu_torch.shutdown()


def test_cartpole_env_vectorized():
    env = CartPoleVecEnv(num_envs=4, seed=0)
    obs = env.reset(0)
    assert obs.shape == (4, 4)
    total_done = 0
    for _ in range(300):
        obs, rew, done, _ = env.step(np.random.randint(0, 2, 4))
        assert obs.shape == (4, 4) and rew.shape == (4,)
        total_done += done.sum()
    # random policy can't balance 300 steps: episodes must have ended+reset
    assert total_done > 0
    assert len(env.drain_episode_returns()) == total_done
    assert np.all(np.abs(obs[:, 0]) <= env.X_LIMIT)


def test_gae_matches_reference_impl():
    T, N = 5, 3
    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.2
    last_value = rng.normal(size=(N,)).astype(np.float32)
    gamma, lam = 0.99, 0.95

    advs, rets = compute_gae(rewards, values, dones, last_value,
                             gamma=gamma, lam=lam)
    # naive python reference
    want = np.zeros((T, N), np.float32)
    adv_next = np.zeros(N, np.float32)
    v_next = last_value.copy()
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * v_next * nonterminal - values[t]
        adv_next = delta + gamma * lam * nonterminal * adv_next
        want[t] = adv_next
        v_next = values[t]
    np.testing.assert_allclose(np.asarray(advs), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(rets), want + values, rtol=1e-5,
                               atol=1e-5)


def test_ppo_learns_cartpole(rl_cluster):
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=64)
        .training(lr=1e-3, minibatch_size=256, num_epochs=4)
        .learners(device="cpu")
        .debugging(seed=0)
        .build()
    )
    first = None
    last = None
    for i in range(12):
        result = algo.train()
        ret = result["env_runners"]["episode_return_mean"]
        if first is None and not np.isnan(ret):
            first = ret
        if not np.isnan(ret):
            last = ret
    algo.stop()
    assert first is not None and last is not None
    # 12 iterations of PPO must clearly beat the random policy (~20)
    assert last > first + 15, f"no learning: {first} → {last}"
    assert result["learners"]["total_loss"] == result["learners"]["total_loss"]


def test_ppo_checkpoint_roundtrip(rl_cluster, tmp_path):
    algo = (
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .learners(device="cpu")
        .build()
    )
    algo.train()
    path = algo.save(str(tmp_path / "ckpt"))
    w0 = _leaves(algo.learner.params)
    algo2 = PPOConfig().environment("CartPole-v1").env_runners(
        num_env_runners=1, num_envs_per_env_runner=4).learners(
        device="cpu").build()
    algo2.restore(path)
    w1 = _leaves(algo2.learner.params)
    assert set(w0) == set(w1)
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])
    # restored in place: the optimizer still steps the live leaves
    from ray_tpu_torch.rllib.learner import leaves

    assert all(p is q for p, q in zip(
        algo2.learner.optimizer.param_groups[0]["params"],
        leaves(algo2.learner.params)))
    algo.stop()
    algo2.stop()


def test_env_runner_fault_tolerance(rl_cluster):
    from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
    from ray_tpu_torch.rllib.learner import Learner

    group = EnvRunnerGroup("CartPole-v1", num_runners=2, num_envs_per_runner=2)
    learner = Learner(4, 2, device="cpu")
    blob = learner.get_weights_blob()
    assert len(group.sample(blob, 8)) == 2
    ray_tpu_torch.kill(group.runners[0])  # simulate node loss
    out = group.sample(blob, 8)     # lost runner's sample dropped, replaced
    assert len(out) >= 1
    out = group.sample(blob, 8)     # replacement is live again
    assert len(out) == 2
    group.shutdown()


def test_stream_rollouts_follow_pushed_weights(rl_cluster):
    """IMPALA's decoupled sampling (ported now, driven by IMPALA in the
    next slice): a runner with two concurrency slots streams time-major
    batches under the most recently pushed weights."""
    from ray_tpu_torch.rllib import rl_module
    from ray_tpu_torch.rllib.env_runner import EnvRunner
    from ray_tpu_torch.rllib.learner import Learner

    runner = EnvRunner.options(max_concurrency=2).remote("CartPole-v1", 3, 5)
    try:
        stream = runner.stream_rollouts.options(
            num_returns="streaming").remote(6, max_batches=3)
        lrn = Learner(4, 2, device="cpu", seed=1)
        ray_tpu_torch.get(runner.set_weights.remote(lrn.get_weights_blob()),
                          timeout=60)
        batches = [ray_tpu_torch.get(ref, timeout=120) for ref in stream]
        assert len(batches) == 3
        for b in batches:
            assert b["obs"].shape == (6, 3, 4)
            assert b["actions"].shape == b["behavior_logp"].shape == (6, 3)
            assert b["bootstrap_obs"].shape == (3, 4)
            # behavior logp is the pushed policy's log-probability
            logits, _ = rl_module.forward(lrn.params, b["obs"].reshape(-1, 4))
            want = torch.log_softmax(logits, -1).gather(
                1, torch.tensor(b["actions"].reshape(-1, 1)).long())
            np.testing.assert_allclose(b["behavior_logp"].reshape(-1),
                                       want.detach().numpy()[:, 0],
                                       rtol=1e-5, atol=1e-6)
        assert ray_tpu_torch.get(runner.ping.remote(), timeout=60)
    finally:
        ray_tpu_torch.kill(runner)
