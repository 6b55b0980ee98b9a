"""The port's SAC against the JAX package's.

Parity on the CPU, inputs from a numpy seed, the JAX package on the CPU:
- ``actor_sample`` (with the reference's own Gaussian draws passed as
  ``noise=``), ``actor_mean`` and ``q_value`` on ``params_from_jax`` of the
  reference's init, within 2e-5 (f32);
- one and three ``make_sac_update`` steps, autotune on and off, from the
  same params, target twins, fresh Adam states and minibatches, with the
  draws the reference's update makes from its keys: params, target twins
  and metrics within 2e-5;
- checkpoints both ways: the JAX package's SAC saves and the port
  restores, and the other way, with equal ``compute_single_action`` on
  seeded observations within 2e-5.

Then twins of tests/test_rllib_appo_sac.py against the port's runtime,
with the reference's thresholds and iteration counts; the learner on the
CPU, the runners CPU actors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ray_tpu_torch

PARITY_TOL = 2e-5  # f32 forward and update steps, port vs JAX package
OBS_DIM, ACT_DIM, SCALE = 3, 2, 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This process's torch on one intra-op thread, as each env runner's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _leaves(tree) -> dict:
    if not isinstance(tree, dict):
        return {"": tree.detach().cpu().numpy() if isinstance(
            tree, torch.Tensor) else np.asarray(tree)}
    out = {}
    for k, v in sorted(tree.items()):
        out.update({f"{k}/{p}".rstrip("/"): x
                    for p, x in _leaves(v).items()})
    return out


def _assert_trees_close(port, ref, tol):
    a, b = _leaves(port), _leaves(ref)
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


def _assert_metrics_close(port: dict, ref: dict, tol):
    assert set(port) == set(ref)
    for k in ref:
        assert abs(port[k] - float(ref[k])) <= tol * max(1.0, abs(
            float(ref[k]))), (k, port[k], ref[k])


def _jax_sac_params(seed, hidden=(32, 32)):
    jax = _jax()
    from ray_tpu.rllib.algorithms.sac import init_sac_params

    return jax.device_get(init_sac_params(jax.random.PRNGKey(seed), OBS_DIM,
                                          ACT_DIM, hidden=hidden,
                                          initial_alpha=0.2))


def _obs(seed, n=33):
    return np.random.default_rng(seed).normal(
        size=(n, OBS_DIM)).astype(np.float32)


# --------------------------------------------------------------- networks


def test_networks_match_the_reference_on_its_params():
    jax = _jax()
    from ray_tpu.rllib.algorithms import sac as jsac
    from ray_tpu_torch.rllib.algorithms import sac

    jp = _jax_sac_params(0)
    params = sac.params_from_jax(jp, device="cpu")
    _assert_trees_close(params, jp, 0.0)
    obs = _obs(1)
    key = jax.random.PRNGKey(5)
    ja, jlogp = jax.device_get(jsac.actor_sample(jp["actor"], obs, key,
                                                 action_scale=SCALE))
    # the reference's own draw: normal(key, mu.shape)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        key, (obs.shape[0], ACT_DIM))))
    ta, tlogp = sac.actor_sample(params["actor"], torch.from_numpy(obs),
                                 action_scale=SCALE, noise=noise)
    np.testing.assert_allclose(ta.detach().numpy(), ja, rtol=PARITY_TOL,
                               atol=PARITY_TOL)
    np.testing.assert_allclose(tlogp.detach().numpy(), jlogp,
                               rtol=PARITY_TOL, atol=PARITY_TOL)
    np.testing.assert_allclose(
        sac.actor_mean(params["actor"], torch.from_numpy(obs),
                       SCALE).detach().numpy(),
        np.asarray(jsac.actor_mean(jp["actor"], obs, SCALE)),
        rtol=PARITY_TOL, atol=PARITY_TOL)
    act = np.random.default_rng(2).uniform(
        -SCALE, SCALE, (obs.shape[0], ACT_DIM)).astype(np.float32)
    for q in ("q1", "q2"):
        np.testing.assert_allclose(
            sac.q_value(params[q], torch.from_numpy(obs),
                        torch.from_numpy(act)).detach().numpy(),
            np.asarray(jsac.q_value(jp[q], obs, act)), rtol=PARITY_TOL,
            atol=PARITY_TOL)
    # a generator's draw is a tanh-squashed Gaussian sample in range
    ga, glogp = sac.actor_sample(params["actor"], torch.from_numpy(obs),
                                 torch.Generator().manual_seed(0), SCALE)
    assert ga.shape == (obs.shape[0], ACT_DIM) and glogp.shape == (33,)
    assert bool((ga.abs() <= SCALE).all())


def test_params_from_jax_checks_keys_and_shapes():
    jax = _jax()
    from ray_tpu.rllib.algorithms.iql import IQLConfig
    from ray_tpu_torch.rllib.algorithms import sac

    jp = _jax_sac_params(0)
    params = sac.params_from_jax(jp, device="cpu")
    assert params["log_alpha"].shape == ()
    assert params["actor"]["0"]["w"].shape == (OBS_DIM, 32)  # [in, out]
    bad = {**jp, "q1": {**jp["q1"], "2": {"w": np.zeros((32, 2), np.float32),
                                          "b": np.zeros(2, np.float32)}}}
    with pytest.raises(ValueError, match="q1/2/w"):
        sac.params_from_jax(bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        sac.params_from_jax({**jp, "extra": {}}, device="cpu")
    with pytest.raises(ValueError, match="log_alpha"):
        sac.params_from_jax({**jp, "log_alpha": np.zeros(1, np.float32)},
                            device="cpu")
    with pytest.raises(ValueError, match="layers"):
        sac.params_from_jax({**jp, "q2": {"1": jp["q2"]["1"]}}, device="cpu")
    # IQL's tree: {q1, q2, actor: {net, log_std}, v}
    rows = [{"obs": [0.0] * OBS_DIM, "action": [0.0] * ACT_DIM,
             "reward": 0.0, "next_obs": [0.0] * OBS_DIM}]
    ji = (IQLConfig().offline(offline_data=rows, obs_dim=OBS_DIM,
                              action_dim=ACT_DIM)
          .training(model={"fcnet_hiddens": [16]}).build())
    tree = jax.device_get(ji.params)
    iql = sac.params_from_jax(tree, device="cpu")
    _assert_trees_close(iql, tree, 0.0)
    with pytest.raises(ValueError, match="log_std"):
        sac.params_from_jax({**tree, "actor": {
            **tree["actor"], "log_std": np.zeros(3, np.float32)}},
            device="cpu")
    with pytest.raises(ValueError, match="v/0/w"):
        sac.params_from_jax({**tree, "v": {"0": {
            "w": np.zeros((OBS_DIM + 1, 1), np.float32),
            "b": np.zeros(1, np.float32)}}}, device="cpu")


# ---------------------------------------------------------------- update


def _sac_batch(seed, n=64):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, OBS_DIM)).astype(np.float32),
        "actions": rng.uniform(-SCALE, SCALE, (n, ACT_DIM)).astype(
            np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, OBS_DIM)).astype(np.float32),
        "dones": rng.random(n) < 0.2,
    }


def sac_noise(jax, key, n: int) -> dict:
    """The Gaussian draws the reference's SAC update makes from `key`."""
    k1, k2 = jax.random.split(key)
    return {name: torch.from_numpy(np.asarray(jax.random.normal(
        k, (n, ACT_DIM)))) for name, k in (("next", k1), ("pi", k2))}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("autotune", [True, False])
def test_sac_update_matches_the_reference(autotune, steps):
    jax = _jax()
    import optax

    from ray_tpu.rllib.algorithms.sac import make_sac_update as jmake
    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import sac

    jp = _jax_sac_params(0)
    # target twins off the online ones, as after some updates
    jt_all = _jax_sac_params(1)
    jt = {"q1": jt_all["q1"], "q2": jt_all["q2"]}
    opts = [optax.adam(1e-3) for _ in range(3)]
    jstates = {"actor": opts[0].init(jp["actor"]),
               "q": opts[1].init({"q1": jp["q1"], "q2": jp["q2"]}),
               "alpha": opts[2].init(jp["log_alpha"])}
    kw = dict(gamma=0.97, tau=0.05, action_scale=SCALE,
              target_entropy=-float(ACT_DIM), autotune=autotune)
    jupdate = jmake(*opts, **kw)
    params = sac.params_from_jax(jp, device="cpu")
    target = sac.params_from_jax({**jt_all}, device="cpu")
    target = {"q1": target["q1"], "q2": target["q2"]}
    tupdate = sac.make_sac_update(sac.sac_optimizers(params, 1e-3), **kw)
    for step in range(steps):
        mb = _sac_batch(step)
        key = jax.random.PRNGKey(100 + step)
        jp, jt, jstates, jm = jupdate(
            jp, jt, jstates, {k: jax.numpy.asarray(v)
                              for k, v in mb.items()}, key)
        tm = tupdate(params, target, learner.batch_to(
            mb, torch.device("cpu")), noise=sac_noise(jax, key, 64))
    _assert_trees_close(params, jax.device_get(jp), PARITY_TOL)
    _assert_trees_close(target, jax.device_get(jt), PARITY_TOL)
    _assert_metrics_close(learner.floats(tm), jax.device_get(jm),
                          PARITY_TOL)
    if not autotune:
        assert float(params["log_alpha"]) == pytest.approx(np.log(0.2))


def test_actor_step_leaves_the_critics_alone():
    """The actor's loss reads the critics: its step must neither move
    them nor leave gradients on them."""
    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import sac
    from ray_tpu_torch.rllib.algorithms.dqn import snapshot

    params = sac.init_sac_params(torch.Generator().manual_seed(0), OBS_DIM,
                                 ACT_DIM, device="cpu")
    opts = sac.sac_optimizers(params, 1e-3)
    q_before = snapshot({"q1": params["q1"], "q2": params["q2"]})
    batch = learner.batch_to(_sac_batch(0), torch.device("cpu"))
    sac.actor_and_alpha_steps(
        params, opts, batch, torch.zeros(()), torch.zeros(()),
        action_scale=SCALE, target_entropy=-2.0, autotune=True,
        generator=torch.Generator().manual_seed(1), noise=None)
    for k, v in _leaves(q_before).items():
        np.testing.assert_array_equal(_leaves(
            {"q1": params["q1"], "q2": params["q2"]})[k], v)
    assert all(t.grad is None for t in learner.leaves(
        {"q1": params["q1"], "q2": params["q2"]}))


# -------------------------------------------------- checkpoints both ways
# Each package's SAC is built with no env runner, so no session is needed;
# its params are moved off their init by an update on a seeded minibatch
# before each save.


def _sac(pkg: str):
    import importlib

    cfg = (importlib.import_module(f"{pkg}.rllib").SACConfig()
           .environment("Pendulum-v1").env_runners(num_env_runners=0)
           .training(model={"fcnet_hiddens": [32, 32]}))
    if pkg == "ray_tpu_torch":
        cfg = cfg.learners(device="cpu")
    return cfg.debugging(seed=0).build()


def _pendulum_batch(seed, n=64):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
            "rewards": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
            "dones": np.zeros(n, bool)}


def _same_actions(jalgo, talgo):
    obs = np.random.default_rng(11).normal(size=(256, 3)).astype(np.float32)
    want = np.stack([jalgo.compute_single_action(o) for o in obs])
    got = np.stack([talgo.compute_single_action(o) for o in obs])
    np.testing.assert_allclose(got, want, rtol=PARITY_TOL, atol=PARITY_TOL)


def test_checkpoints_read_both_ways(tmp_path):
    jax = _jax()
    from ray_tpu_torch.rllib import learner

    jalgo, talgo = _sac("ray_tpu"), _sac("ray_tpu_torch")
    # the JAX package saves, the port restores
    jalgo.params, jalgo.target_q, jalgo.opt_states, _ = jalgo._update(
        jalgo.params, jalgo.target_q, jalgo.opt_states,
        {k: jax.numpy.asarray(v) for k, v in _pendulum_batch(0).items()},
        jax.random.PRNGKey(3))
    talgo.restore(jalgo.save(str(tmp_path / "jax_ckpt")))
    _assert_trees_close(talgo.params, jax.device_get(jalgo.params), 0.0)
    _assert_trees_close(talgo.target_q, {"q1": talgo.params["q1"],
                                         "q2": talgo.params["q2"]}, 0.0)
    assert all(not o.state for o in talgo.optimizers.values())
    _same_actions(jalgo, talgo)
    # the port trains on and saves; the JAX package restores
    talgo._update(talgo.params, talgo.target_q, learner.batch_to(
        _pendulum_batch(1), torch.device("cpu")), talgo.generator)
    jalgo.restore(talgo.save(str(tmp_path / "port_ckpt")))
    _assert_trees_close(talgo.params, jax.device_get(jalgo.params), 0.0)
    _same_actions(jalgo, talgo)
    # restored in place: the fresh optimizers step the live leaves
    assert all(p is q for p, q in zip(
        talgo.optimizers["actor"].param_groups[0]["params"],
        learner.leaves(talgo.params["actor"])))


def test_sac_without_a_card_raises_unless_asked_for_the_cpu():
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, IQLConfig,
                                     MARWILConfig, SACConfig)

    if torch.cuda.is_available():
        pytest.skip("a card is visible: None means the card")
    for cfg in (SACConfig().environment("Pendulum-v1"), BCConfig(),
                MARWILConfig(), CQLConfig(), IQLConfig()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cfg.build()


# --------------------------------- twins of tests/test_rllib_appo_sac.py


@pytest.fixture
def rl_cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=16, num_workers=2, max_workers=10)
    yield
    ray_tpu_torch.shutdown()


def test_pendulum_env_physics():
    from ray_tpu_torch.rllib.env import PendulumVecEnv

    env = PendulumVecEnv(num_envs=3, seed=0)
    obs = env.reset(0)
    assert obs.shape == (3, 3)
    # cos^2 + sin^2 == 1
    np.testing.assert_allclose(obs[:, 0] ** 2 + obs[:, 1] ** 2, 1.0,
                               atol=1e-5)
    total = np.zeros(3)
    for _ in range(200):
        obs, r, d, _ = env.step(np.zeros((3, 1)))
        assert (r <= 0).all()  # reward is a negative cost
        total += r
    assert d.all()  # 200-step episodes
    assert env.drain_episode_returns()  # completed returns recorded


def test_sac_actor_logprob_matches_empirical_density():
    """Tanh-Gaussian log-prob vs the EMPIRICAL histogram density of its own
    samples: a sign error (or omission) in the squash correction shifts
    exp(logp) away from the histogram and fails this check."""
    from ray_tpu_torch.rllib.algorithms.sac import actor_sample, init_sac_params

    scale = 2.0
    params = init_sac_params(torch.Generator().manual_seed(0), 3, 1,
                             device="cpu")
    obs = torch.zeros((200_000, 3))  # one state, many samples
    with torch.no_grad():
        a, logp = actor_sample(params["actor"], obs,
                               torch.Generator().manual_seed(1),
                               action_scale=scale)
    a = a.numpy()[:, 0]
    logp = logp.numpy()
    assert (np.abs(a) <= scale).all()
    assert np.isfinite(logp).all()
    # NOTE: actor_sample's logp is the density of the UNSCALED tanh(u);
    # p(a) for the scaled action adds a -log(scale) shift
    density = np.exp(logp) / scale
    hist, edges = np.histogram(a, bins=25, range=(-scale, scale),
                               density=True)
    for lo, hi, h in zip(edges[:-1], edges[1:], hist):
        sel = (a >= lo) & (a < hi)
        if sel.sum() < 2000:
            continue  # tail bins: too noisy to compare
        np.testing.assert_allclose(np.mean(density[sel]), h, rtol=0.25)


@pytest.mark.slow
def test_appo_learns_cartpole(rl_cluster):
    from ray_tpu_torch.rllib import APPOConfig

    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=48)
        .training(lr=3e-3, clip_param=0.3)
        .learners(device="cpu")
        .debugging(seed=0)
        .build()
    )
    rets = []
    for _ in range(16):
        result = algo.train()
        r = result["env_runners"]["episode_return_mean"]
        if not np.isnan(r):
            rets.append(r)
    algo.stop()
    assert rets, "no episodes completed"
    # random CartPole averages ~20-25; learning must beat it clearly
    assert max(rets[-4:]) > 40.0, rets


@pytest.mark.slow
def test_appo_survives_runner_death(rl_cluster):
    from ray_tpu_torch.rllib import APPOConfig

    algo = (
        APPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .learners(device="cpu")
        .debugging(seed=1)
        .build()
    )
    r1 = algo.train()
    assert r1["learners"]["batches_consumed"] > 0
    ray_tpu_torch.kill(algo._runners[0])
    r2 = algo.train()
    r3 = algo.train()
    algo.stop()
    assert (r2["learners"]["batches_consumed"]
            + r3["learners"]["batches_consumed"]) > 0
    assert r3["learners"]["num_healthy_runners"] == 2


@pytest.mark.slow
def test_sac_learns_pendulum(rl_cluster):
    from ray_tpu_torch.rllib import SACConfig

    algo = (
        SACConfig()
        .environment("Pendulum-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=25)
        .training(lr=1e-3, learning_starts=600, num_updates_per_step=128,
                  train_batch_size=128)
        .learners(device="cpu")
        .debugging(seed=0)
        .build()
    )
    rets = []
    for _ in range(70):
        result = algo.train()
        r = result["env_runners"]["episode_return_mean"]
        if not np.isnan(r):
            rets.append(r)
    algo.stop()
    assert rets, "no episodes completed"
    # random Pendulum sits around -1100..-1400 per 200-step episode;
    # a learning policy must clearly improve on that
    assert max(rets[-4:]) > -800.0, rets


def test_sac_rejects_discrete_env(rl_cluster):
    from ray_tpu_torch.rllib import SACConfig

    with pytest.raises(ValueError, match="continuous"):
        (SACConfig().environment("CartPole-v1").learners(device="cpu")
         .debugging(seed=0).build())
