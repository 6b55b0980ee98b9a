"""The port's DreamerV3 against the JAX package's.

Parity on the CPU, inputs from a numpy seed, the JAX package on the CPU and
no JAX session started; torch on one thread. A categorical sample is the
argmax of its log-probs plus Gumbel draws in both packages
(``jax.random.categorical``), so the reference's own draws, taken with
``jax.random.gumbel`` from the keys it splits, enter the port as
``noise=`` and the port's samples are the reference's exactly:
- ``symlog``/``symexp``, ``_dense`` and ``_gru`` on ``params_from_jax`` of
  the reference's init, ``_sample_z`` (the sample exact, its log-probs and
  straight-through gradient within 2e-5), ``_kl_cat``, and
  ``params_from_jax``'s key and shape checks;
- one and three world-model updates and dream updates from the same params
  and fresh Adam states: params, feats, slow critic, return EMA and metrics
  within 2e-5 (f32); the actor's step moves no other leaf and the slow
  critic is a clone;
- the runner's policy step, the sequence buffer's windows (bit-equal) and
  one ``train()`` iteration past warm-up on the CPU.

Then twins of tests/test_rllib_dreamer.py against the port's runtime, with
the reference's thresholds and iteration counts; the learner on the CPU,
the runners CPU actors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ray_tpu_torch

PARITY_TOL = 2e-5  # f32 forward and update steps, port vs JAX package
OBS_DIM, NUM_ACTIONS = 4, 2
SMALL = {"model_hidden": (32,), "deter_dim": 24, "stoch_dims": 4,
         "stoch_classes": 5, "embed_dim": 16, "batch_size_B": 4,
         "batch_length_T": 6, "horizon_H": 5}


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


def _cfgs(**over):
    """The same small config in both packages."""
    from ray_tpu.rllib.algorithms.dreamerv3 import DreamerV3Config as J
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import DreamerV3Config as T

    out = []
    for cls in (J, T):
        cfg = cls()
        for k, v in {**SMALL, **over}.items():
            setattr(cfg, k, v)
        out.append(cfg)
    return out


def _jax_params(seed: int = 0, **over):
    jax = _jax()
    from ray_tpu.rllib.algorithms.dreamerv3 import init_dreamer_params

    jcfg, _ = _cfgs(**over)
    return jax.device_get(init_dreamer_params(
        jax.random.PRNGKey(seed), OBS_DIM, NUM_ACTIONS, jcfg))


def _gumbel(jax, key, shape) -> torch.Tensor:
    """The draws jax.random.categorical(key, logits) adds to `shape`'s
    logits."""
    return torch.from_numpy(np.array(jax.random.gumbel(key, shape)))


# --------------------------------------------------------------- modules


def test_modules_match_the_reference_on_its_params():
    jax = _jax()
    from ray_tpu.rllib.algorithms import dreamerv3 as jd
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    x = np.array([-100.0, -3.5, -1.0, 0.0, 0.25, 7.0, 30.0], np.float32)
    np.testing.assert_allclose(td.symlog(torch.from_numpy(x)).numpy(),
                               np.asarray(jd.symlog(x)), rtol=PARITY_TOL)
    np.testing.assert_allclose(td.symexp(torch.from_numpy(x / 10)).numpy(),
                               np.asarray(jd.symexp(x / 10)),
                               rtol=PARITY_TOL)
    jp = _jax_params()
    params = td.params_from_jax(jp, device="cpu")
    _assert_trees_close(params, jp, 0.0)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(9, OBS_DIM)).astype(np.float32)
    for act_final in (True, False):
        np.testing.assert_allclose(
            td._dense(params["encoder"], torch.from_numpy(obs),
                      final_linear=act_final).numpy(),
            np.asarray(jd._dense(jp["encoder"], obs,
                                 final_linear=act_final)),
            rtol=PARITY_TOL, atol=PARITY_TOL)
    z_dim = SMALL["stoch_dims"] * SMALL["stoch_classes"]
    xin = rng.normal(size=(9, z_dim + NUM_ACTIONS)).astype(np.float32)
    h = np.tanh(rng.normal(size=(9, SMALL["deter_dim"]))).astype(np.float32)
    np.testing.assert_allclose(
        td._gru(params["gru"], torch.from_numpy(xin),
                torch.from_numpy(h)).numpy(),
        np.asarray(jd._gru(jp["gru"], xin, h)), rtol=PARITY_TOL,
        atol=PARITY_TOL)
    # the port's own init: the reference's tree, shapes and scales
    _, tcfg = _cfgs()
    own = td.init_dreamer_params(torch.Generator().manual_seed(0), OBS_DIM,
                                 NUM_ACTIONS, tcfg, device="cpu")
    assert {k: v.shape for k, v in _leaves(own).items()} == {
        k: v.shape for k, v in _leaves(jp).items()}
    assert float(own["gru"]["b"].abs().sum()) == 0.0
    again = td.init_dreamer_params(torch.Generator().manual_seed(0), OBS_DIM,
                                   NUM_ACTIONS, tcfg, device="cpu")
    for k, v in _leaves(again).items():
        np.testing.assert_array_equal(_leaves(own)[k], v)


def test_sample_z_and_kl_match_the_reference_with_its_draws():
    jax = _jax()
    from ray_tpu.rllib.algorithms import dreamerv3 as jd
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    S, C = SMALL["stoch_dims"], SMALL["stoch_classes"]
    logits = np.random.default_rng(1).normal(
        size=(3, 7, S * C)).astype(np.float32) * 2.0
    key = jax.random.PRNGKey(2)
    jz, jlg = jd._sample_z(logits, key, S, C)
    noise = _gumbel(jax, key, (3, 7, S, C))
    tl = torch.from_numpy(logits).requires_grad_(True)
    tz, tlg = td._sample_z(tl, None, S, C, noise)
    # the forward is the reference's one-hot, sample for sample
    np.testing.assert_array_equal(tz.detach().numpy().reshape(3, 7, S, C)
                                  .argmax(-1),
                                  np.asarray(jz).reshape(3, 7, S, C)
                                  .argmax(-1))
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz),
                               atol=1e-6)
    np.testing.assert_allclose(tlg.detach().numpy(), np.asarray(jlg),
                               rtol=PARITY_TOL, atol=PARITY_TOL)
    # the straight-through gradient: probs' gradient through a sampled
    # forward
    w = np.random.default_rng(3).normal(size=(3, 7, S * C)).astype(
        np.float32)
    jgrad = jax.grad(lambda lgt: jax.numpy.sum(
        jd._sample_z(lgt, key, S, C)[0] ** 2 * w))(logits)
    (tgrad,) = torch.autograd.grad(torch.sum(tz ** 2 * torch.from_numpy(w)),
                                   tl)
    assert float(np.abs(np.asarray(jgrad)).sum()) > 0
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad),
                               rtol=PARITY_TOL, atol=PARITY_TOL)
    # a generator's draws: one-hot forward, in range
    gz, _ = td._sample_z(torch.from_numpy(logits), torch.Generator()
                         .manual_seed(0), S, C)
    np.testing.assert_allclose(gz.numpy().reshape(3, 7, S, C).sum(-1), 1.0,
                               atol=1e-5)
    g = td.gumbel(torch.Generator().manual_seed(0), (100_000,),
                  torch.zeros(()))
    assert bool(torch.isfinite(g).all())
    # the standard Gumbel's mean is Euler's constant
    assert abs(float(g.mean()) - 0.5772) < 0.02
    # KL between two stacked categoricals
    lg_q = np.array(jd._sample_z(logits[::-1].copy(), key, S, C)[1])
    np.testing.assert_allclose(
        td._kl_cat(tlg.detach(), torch.from_numpy(lg_q)).numpy(),
        np.asarray(jd._kl_cat(jlg, lg_q)), rtol=PARITY_TOL, atol=PARITY_TOL)


def test_params_from_jax_checks_keys_and_shapes():
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    jp = _jax_params()
    params = td.params_from_jax(jp, device="cpu")
    assert list(params) == list(td.PARAM_KEYS)
    D = SMALL["deter_dim"]
    assert params["gru"]["wh"].shape == (D, 3 * D)
    with pytest.raises(ValueError, match="keys"):
        td.params_from_jax({**jp, "extra": {}}, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        td.params_from_jax({k: v for k, v in jp.items() if k != "critic"},
                           device="cpu")
    with pytest.raises(ValueError, match="gru"):
        td.params_from_jax({**jp, "gru": {**jp["gru"], "wh": np.zeros(
            (D, 2 * D), np.float32)}}, device="cpu")
    with pytest.raises(ValueError, match="gru/b"):
        td.params_from_jax({**jp, "gru": {**jp["gru"], "b": np.zeros(
            3 * D + 1, np.float32)}}, device="cpu")
    with pytest.raises(ValueError, match="critic/1/w"):
        td.params_from_jax({**jp, "critic": {**jp["critic"], "1": {
            "w": np.zeros((32, 2), np.float32),
            "b": np.zeros(2, np.float32)}}}, device="cpu")
    with pytest.raises(ValueError, match="posterior/0/w"):
        td.params_from_jax({**jp, "posterior": {**jp["posterior"], "0": {
            "w": np.zeros((D, 32), np.float32),
            "b": np.zeros(32, np.float32)}}}, device="cpu")
    with pytest.raises(ValueError, match="actor/1/w"):
        td.params_from_jax({**jp, "actor": {**jp["actor"], "1": {
            "w": np.zeros((32, NUM_ACTIONS + 1), np.float32),
            "b": np.zeros(NUM_ACTIONS + 1, np.float32)}}}, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        td.params_from_jax({**jp, "decoder": {"1": jp["decoder"]["1"]}},
                           device="cpu")


# ------------------------------------------------------------ world model


def _wm_batch(seed: int, T: int, B: int) -> dict:
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, NUM_ACTIONS, (T, B))
    return {
        "obs": rng.normal(size=(T, B, OBS_DIM)).astype(np.float32),
        "actions_onehot": np.eye(NUM_ACTIONS, dtype=np.float32)[prev],
        "rewards": rng.normal(size=(T, B)).astype(np.float32) * 2.0,
        "dones": rng.random((T, B)) < 0.15,
        "is_first": (rng.random((T, B)) < 0.15).astype(np.float32),
    }


def wm_noise(jax, key, T: int, B: int, S: int, C: int) -> torch.Tensor:
    """The Gumbel draws the reference's world-model update makes from
    `key`: one key per step, shared by the posterior and the prior."""
    return torch.stack([_gumbel(jax, k, (B, S, C))
                        for k in jax.random.split(key, T)])


@pytest.mark.parametrize("steps", [1, 3])
def test_world_model_update_matches_the_reference(steps):
    jax = _jax()
    import optax

    from ray_tpu.rllib.algorithms.dreamerv3 import \
        make_world_model_update as jmake
    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    jcfg, tcfg = _cfgs()
    T, B = jcfg.batch_length_T, jcfg.batch_size_B
    S, C = jcfg.stoch_dims, jcfg.stoch_classes
    jp = _jax_params()
    wm = {k: jp[k] for k in td.WM_KEYS}
    opt = optax.adam(jcfg.world_lr)
    jstate = opt.init(wm)
    jupdate = jmake(opt, jcfg, NUM_ACTIONS)
    params = td.params_from_jax(jp, device="cpu")
    twm = {k: params[k] for k in td.WM_KEYS}
    tupdate = td.make_world_model_update(
        learner.make_optimizer(twm, tcfg.world_lr), tcfg, NUM_ACTIONS)
    for step in range(steps):
        mb = _wm_batch(step, T, B)
        key = jax.random.PRNGKey(100 + step)
        wm, jstate, jfeats, jm = jupdate(
            wm, jstate, {k: jax.numpy.asarray(v) for k, v in mb.items()},
            key)
        tfeats, tm = tupdate(twm, learner.batch_to(mb, torch.device("cpu")),
                             noise=wm_noise(jax, key, T, B, S, C))
    _assert_trees_close(twm, jax.device_get(wm), PARITY_TOL)
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats),
                               rtol=PARITY_TOL, atol=PARITY_TOL)
    assert not tfeats.requires_grad
    _assert_metrics_close(learner.floats(tm), jax.device_get(jm),
                          PARITY_TOL)
    # the actor and the critic are not the world model's
    _assert_trees_close({k: params[k] for k in ("actor", "critic")},
                        {k: jp[k] for k in ("actor", "critic")}, 0.0)


def test_world_model_gradients_clip_elementwise():
    """A reward far off its target gives gradients past 100 on the reward
    head: the update clips each element to [-100, 100], not the norm."""
    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    jp = _jax_params()
    _, tcfg = _cfgs()
    params = td.params_from_jax(jp, device="cpu")
    twm = {k: params[k] for k in td.WM_KEYS}
    seen = {}

    class Spy(torch.optim.SGD):
        def step(self, closure=None):
            seen["grads"] = [p.grad.clone() for p in
                             self.param_groups[0]["params"]]
            return super().step(closure)

    opt = Spy([t.requires_grad_(True) for t in learner.leaves(twm)],
              lr=0.0)
    T, B = tcfg.batch_length_T, tcfg.batch_size_B
    mb = _wm_batch(0, T, B)
    mb["rewards"] = mb["rewards"] * 0 + 1e30
    td.make_world_model_update(opt, tcfg, NUM_ACTIONS)(
        twm, learner.batch_to(mb, torch.device("cpu")),
        torch.Generator().manual_seed(0))
    top = max(float(g.abs().max()) for g in seen["grads"])
    assert top == td.GRAD_CLIP
    assert any(0 < float(g.abs().max()) < td.GRAD_CLIP
               for g in seen["grads"])


# ---------------------------------------------------------------- dreams


def _feats0(seed: int, N: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    S, C = SMALL["stoch_dims"], SMALL["stoch_classes"]
    h = np.tanh(rng.normal(size=(N, SMALL["deter_dim"])))
    z = np.eye(C)[rng.integers(0, C, (N, S))].reshape(N, S * C)
    return np.concatenate([h, z], -1).astype(np.float32)


def dream_noise(jax, key, H: int, N: int, S: int, C: int) -> dict:
    """The Gumbel draws the reference's dream update makes from `key`: one
    key per imagined step, split into the action's and the latent's."""
    acts, zs = [], []
    for k in jax.random.split(key, H):
        ka, kz = jax.random.split(k)
        acts.append(_gumbel(jax, ka, (N, NUM_ACTIONS)))
        zs.append(_gumbel(jax, kz, (N, S, C)))
    return {"action": torch.stack(acts), "z": torch.stack(zs)}


@pytest.mark.parametrize("steps", [1, 3])
def test_dream_update_matches_the_reference(steps):
    jax = _jax()
    import optax

    from ray_tpu.rllib.algorithms.dreamerv3 import make_dream_update as jmake
    from ray_tpu_torch.rllib import learner
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td
    from ray_tpu_torch.rllib.algorithms.dqn import snapshot

    jcfg, tcfg = _cfgs()
    H, S, C = jcfg.horizon_H, jcfg.stoch_dims, jcfg.stoch_classes
    N = 24
    jp = _jax_params()
    # the slow critic off the critic, as after some updates
    jslow = _jax_params(1)["critic"]
    aopt, copt = optax.adam(jcfg.actor_lr), optax.adam(jcfg.critic_lr)
    jstates = {"actor": aopt.init(jp["actor"]),
               "critic": copt.init(jp["critic"])}
    jema = np.float32(2.5)
    jupdate = jmake(aopt, copt, jcfg, NUM_ACTIONS)
    params = td.params_from_jax(jp, device="cpu")
    slow = td.params_from_jax(_jax_params(1), device="cpu")["critic"]
    tema = torch.tensor(2.5)
    tupdate = td.make_dream_update(
        learner.make_optimizer(params["actor"], tcfg.actor_lr),
        learner.make_optimizer(params["critic"], tcfg.critic_lr), tcfg,
        NUM_ACTIONS)
    frozen = snapshot({k: params[k] for k in td.WM_KEYS})
    for step in range(steps):
        f0 = _feats0(step, N)
        key = jax.random.PRNGKey(200 + step)
        jp, jslow, jstates, jema, jm = jupdate(jp, jslow, jstates, jema,
                                               jax.numpy.asarray(f0), key)
        tema, tm = tupdate(params, slow, tema, torch.from_numpy(f0),
                           noise=dream_noise(jax, key, H, N, S, C))
    jp = jax.device_get(jp)
    _assert_trees_close(params, jp, PARITY_TOL)
    _assert_trees_close(slow, jax.device_get(jslow), PARITY_TOL)
    assert abs(float(tema) - float(jema)) <= PARITY_TOL * float(jema)
    _assert_metrics_close(learner.floats(tm), jax.device_get(jm),
                          PARITY_TOL)
    # the actor's loss read the world model and the heads: no leaf of
    # theirs moved or holds a gradient
    for k, v in _leaves(frozen).items():
        np.testing.assert_array_equal(
            _leaves({k2: params[k2] for k2 in td.WM_KEYS})[k], v)
    assert all(t.grad is None for t in learner.leaves(
        {k: params[k] for k in td.WM_KEYS}))
    assert all(t.grad is None for t in learner.leaves(slow))


def test_imagine_rolls_from_the_real_states_untracked():
    """feats[0] is feats0 (the feature before step 0's transition), the
    latents are one-hot, the same draws give the same roll, and nothing
    of it is tracked."""
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    _, tcfg = _cfgs()
    H, S, C, N = tcfg.horizon_H, tcfg.stoch_dims, tcfg.stoch_classes, 7
    params = td.params_from_jax(_jax_params(), device="cpu")
    f0 = torch.from_numpy(_feats0(0, N))
    g = torch.Generator().manual_seed(0)
    noise = {"action": td.gumbel(g, (H, N, NUM_ACTIONS), f0),
             "z": td.gumbel(g, (H, N, S, C), f0)}
    feats, acts = td.imagine(params, f0, tcfg, NUM_ACTIONS, noise=noise)
    assert feats.shape == (H, N, f0.shape[1]) and acts.shape == (H, N)
    torch.testing.assert_close(feats[0], f0, rtol=0, atol=0)
    z = feats[..., tcfg.deter_dim:].reshape(H, N, S, C)
    torch.testing.assert_close(z.sum(-1), torch.ones(H, N, S))
    again, acts2 = td.imagine(params, f0, tcfg, NUM_ACTIONS, noise=noise)
    torch.testing.assert_close(again, feats, rtol=0, atol=0)
    assert torch.equal(acts, acts2)
    assert not feats.requires_grad
    # a generator's own draws: another roll from the same start
    other, _ = td.imagine(params, f0, tcfg, NUM_ACTIONS,
                          torch.Generator().manual_seed(1))
    torch.testing.assert_close(other[0], f0, rtol=0, atol=0)


def test_slow_critic_is_a_clone_of_the_critic():
    from ray_tpu_torch.rllib import DreamerV3Config, learner
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import WM_KEYS

    algo = (DreamerV3Config().env_runners(num_env_runners=0)
            .learners(device="cpu").debugging(seed=0).build())
    crit, slow = (learner.leaves(algo.params["critic"]),
                  learner.leaves(algo.slow_critic))
    for a, b in zip(crit, slow):
        assert a.untyped_storage().data_ptr() != \
            b.untyped_storage().data_ptr()
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
        assert not b.requires_grad
    # the three Adams hold exactly their subtrees' live leaves
    assert [p for g in algo.world_opt.param_groups for p in g["params"]] \
        == learner.leaves({k: algo.params[k] for k in WM_KEYS})
    assert algo.actor_opt.param_groups[0]["params"] == learner.leaves(
        algo.params["actor"])
    assert algo.critic_opt.param_groups[0]["params"] == crit
    assert algo.ret_ema.device.type == "cpu" and float(algo.ret_ema) == 1.0
    algo.stop()


# ------------------------------------------------------ runner and buffer


def test_policy_step_matches_the_reference_runner():
    """The JAX runner's jitted policy step (its class built here, no
    session) against the port's, on converted params, with the runner's
    key split into the latent's and the action's draws."""
    jax = _jax()
    from ray_tpu._private import serialization as jser
    from ray_tpu.rllib.algorithms.dreamerv3 import _DreamerRunner
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    jcfg, tcfg = _cfgs()
    S, C, N = jcfg.stoch_dims, jcfg.stoch_classes, 6
    jrunner = _DreamerRunner._cls("CartPole-v1", N, jser.dumps(jcfg), 0)
    jp = _jax_params()
    params = td.params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(4)
    h = np.tanh(rng.normal(size=(N, jcfg.deter_dim))).astype(np.float32)
    z = _feats0(5, N)[:, jcfg.deter_dim:]
    obs = rng.normal(size=(N, OBS_DIM)).astype(np.float32)
    prev = rng.integers(0, NUM_ACTIONS, N)
    first = np.array([1, 0, 0, 1, 0, 0], np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jh, jz, ja = jrunner._policy(
            {k: jp[k] for k in td.RUNNER_KEYS}, h, z, obs, prev, first, key)
        kz, ka = jax.random.split(key)
        th, tz, ta = td.policy_step(
            params, torch.from_numpy(h), torch.from_numpy(z),
            torch.from_numpy(obs), torch.from_numpy(prev),
            torch.from_numpy(first), NUM_ACTIONS, S, C,
            noise={"z": _gumbel(jax, kz, (N, S, C)),
                   "action": _gumbel(jax, ka, (N, NUM_ACTIONS))})
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                                   rtol=PARITY_TOL, atol=PARITY_TOL)
        np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz),
                                   atol=1e-6)
        h, z = np.array(jh), np.array(jz)


def test_runner_sample_keeps_the_references_layout():
    """The port's runner class, built here: [N, T] arrays under the
    reference's keys, prev_actions[t] the action before obs[t], is_first
    after every done; with its params the policy path."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.rllib import rl_module
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td

    _, tcfg = _cfgs()
    N, T = 3, 40
    runner = td._DreamerRunner._cls("CartPole-v1", N, ser.dumps(tcfg), 7)
    assert runner.ping()
    params = td.init_dreamer_params(torch.Generator().manual_seed(0),
                                    OBS_DIM, NUM_ACTIONS, tcfg, device="cpu")
    blob = ser.dumps(rl_module.to_numpy(
        {k: params[k] for k in td.RUNNER_KEYS}))
    for random_actions in (True, False):
        s = runner.sample(blob, T, random_actions=random_actions)
        assert set(s) == {"obs", "actions", "prev_actions", "rewards",
                          "dones", "is_first", "episode_returns"}
        assert s["obs"].shape == (N, T, OBS_DIM)
        for k in ("actions", "prev_actions", "rewards", "dones",
                  "is_first"):
            assert s[k].shape == (N, T), k
        np.testing.assert_array_equal(s["prev_actions"][:, 1:],
                                      s["actions"][:, :-1])
        np.testing.assert_array_equal(s["is_first"][:, 1:],
                                      s["dones"][:, :-1].astype(np.float32))
        assert set(np.unique(s["actions"])) <= {0, 1}
    # the recurrent state carries across calls and resets where a
    # new episode starts
    assert runner.h.shape == (N, tcfg.deter_dim)
    assert float(runner.h.abs().sum()) > 0


def _rollout(seed: int, N: int, T: int) -> dict:
    rng = np.random.default_rng(seed)
    acts = rng.integers(0, NUM_ACTIONS, (N, T))
    dones = rng.random((N, T)) < 0.05
    return {"obs": rng.normal(size=(N, T, OBS_DIM)).astype(np.float32),
            "actions": acts,
            "prev_actions": np.concatenate([np.zeros((N, 1), np.int64),
                                            acts[:, :-1]], 1),
            "rewards": np.ones((N, T), np.float32),
            "dones": dones,
            "is_first": np.concatenate([np.ones((N, 1), np.float32),
                                        dones[:, :-1].astype(np.float32)],
                                       1)}


def test_sequence_buffer_windows_are_bit_equal():
    from ray_tpu.rllib.algorithms.dreamerv3 import _SequenceBuffer as J
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import _SequenceBuffer as T

    jb, tb = J(300, OBS_DIM, seed=3), T(300, OBS_DIM, seed=3)
    assert jb.sample(4, 8) is None and tb.sample(4, 8) is None
    for i in range(6):  # past capacity: the oldest streams drop
        r = _rollout(i, 4, 16 + 8 * i)
        jb.add_rollout(r)
        tb.add_rollout(r)
        for B, L in ((5, 8), (2, 16)):
            a, b = jb.sample(B, L), tb.sample(B, L)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
        assert (jb.size, len(jb.streams)) == (tb.size, len(tb.streams))


def test_time_major_is_the_references_batch():
    jax = _jax()
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import time_major

    batch = _rollout(0, 5, 9)
    got = time_major(batch, NUM_ACTIONS)
    want = {
        "obs": np.swapaxes(batch["obs"], 0, 1),
        "actions_onehot": np.asarray(jax.nn.one_hot(
            np.swapaxes(batch["prev_actions"], 0, 1), NUM_ACTIONS)),
        "rewards": np.swapaxes(batch["rewards"], 0, 1),
        "dones": np.swapaxes(batch["dones"], 0, 1),
        "is_first": np.swapaxes(batch["is_first"], 0, 1).astype(np.float32)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_compute_single_action_matches_the_reference():
    """Both packages' DreamerV3 (no runner, no session) on the same params:
    equal actions on seeded observations with the reference's draws."""
    jax = _jax()
    from ray_tpu.rllib import DreamerV3Config as J
    from ray_tpu_torch.rllib import DreamerV3Config as T
    from ray_tpu_torch.rllib.algorithms import dreamerv3 as td
    from ray_tpu_torch.rllib.learner import leaves

    jalgo = J().env_runners(num_env_runners=0).debugging(seed=0).build()
    talgo = (T().env_runners(num_env_runners=0).learners(device="cpu")
             .debugging(seed=0).build())
    jp = jax.device_get(jalgo.params)
    with torch.no_grad():
        for a, b in zip(leaves(talgo.params),
                        leaves(td.params_from_jax(jp, device="cpu"))):
            a.copy_(b)
    cfg = talgo.config
    noise = _gumbel(jax, jax.random.PRNGKey(0),
                    (1, cfg.stoch_dims, cfg.stoch_classes))
    obs = np.random.default_rng(11).normal(size=(64, OBS_DIM)).astype(
        np.float32)
    want = [jalgo.compute_single_action(o) for o in obs]
    got = [talgo.compute_single_action(o, noise=noise) for o in obs]
    assert got == want
    assert len(set(want)) == 2  # both actions occur: the check has teeth
    own = [talgo.compute_single_action(o) for o in obs[:4]]
    assert own == [talgo.compute_single_action(o) for o in obs[:4]]
    jalgo.stop()
    talgo.stop()


def test_dreamer_refuses_an_env_without_discrete_actions():
    from ray_tpu_torch.rllib import DreamerV3Config

    with pytest.raises(ValueError, match="discrete-action"):
        (DreamerV3Config().environment("Pendulum-v1")
         .env_runners(num_env_runners=0).learners(device="cpu").build())


def test_dreamer_without_a_card_raises_unless_asked_for_the_cpu():
    from ray_tpu_torch.rllib import DreamerV3Config

    if torch.cuda.is_available():
        pytest.skip("a card is visible: None means the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DreamerV3Config().env_runners(num_env_runners=0).build()


# --------------------------------- twins of tests/test_rllib_dreamer.py


@pytest.fixture
def rl_cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=16, num_workers=2, max_workers=10)
    yield
    ray_tpu_torch.shutdown()


def test_symlog_symexp_inverse():
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import symexp, symlog

    x = torch.tensor([-100.0, -1.0, 0.0, 0.5, 30.0])
    np.testing.assert_allclose(symexp(symlog(x)).numpy(), x.numpy(),
                               rtol=1e-5)


def test_rssm_shapes_and_straight_through():
    from ray_tpu_torch.rllib.algorithms.dreamerv3 import (DreamerV3Config,
                                                          _sample_z,
                                                          init_dreamer_params)

    cfg = DreamerV3Config()
    params = init_dreamer_params(torch.Generator().manual_seed(0), 4, 2, cfg,
                                 device="cpu")
    assert set(params) == {"encoder", "gru", "prior", "posterior",
                           "decoder", "reward", "continue", "actor",
                           "critic"}
    z_dim = cfg.stoch_dims * cfg.stoch_classes
    logits = torch.randn((3, z_dim), generator=torch.Generator()
                         .manual_seed(1))
    z, lg = _sample_z(logits, torch.Generator().manual_seed(2),
                      cfg.stoch_dims, cfg.stoch_classes)
    assert z.shape == (3, z_dim)
    # forward value is one-hot per latent
    zr = z.numpy().reshape(3, cfg.stoch_dims, cfg.stoch_classes)
    np.testing.assert_allclose(zr.sum(-1), 1.0, atol=1e-5)
    # straight-through: gradients flow to the logits despite sampling
    lgt = logits.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(torch.sum(_sample_z(
        lgt, torch.Generator().manual_seed(2), cfg.stoch_dims,
        cfg.stoch_classes)[0] ** 2), lgt)
    assert float(grad.abs().sum()) > 0.0


def test_train_iteration_past_warmup_on_the_cpu(rl_cluster):
    """Warm-up fills the buffer with random actions, the next iteration
    runs the updates: every metric finite, params and the slow critic on
    the CPU, the runners' policy path taken."""
    import math

    from ray_tpu_torch.rllib import DreamerV3Config

    algo = (DreamerV3Config()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=32)
            .training(learning_starts=128, num_updates_per_step=2,
                      batch_size_B=4, batch_length_T=16, horizon_H=5)
            .learners(device="cpu")
            .debugging(seed=0)
            .build())
    try:
        r1 = algo.train()
        assert r1["learners"] == {"env_steps": 128}
        before = {k: v.copy() for k, v in _leaves(algo.params).items()}
        r2 = algo.train()
        lm = r2["learners"]
        assert lm["env_steps"] == 256 and lm["num_updates"] == 2
        for k in ("wm_loss", "wm_recon", "wm_reward", "wm_continue",
                  "wm_kl", "actor_loss", "critic_loss", "dream_return",
                  "actor_entropy"):
            assert math.isfinite(lm[k]), (k, lm)
        after = _leaves(algo.params)
        assert any(not np.array_equal(before[k], after[k]) for k in before)
        assert {t.device.type for t in _torch_leaves(algo.params)} == {"cpu"}
        assert {t.device.type for t in _torch_leaves(algo.slow_critic)} == \
            {"cpu"}
        assert algo.compute_single_action(np.zeros(OBS_DIM)) in (0, 1)
    finally:
        algo.stop()


def _torch_leaves(tree):
    from ray_tpu_torch.rllib.learner import leaves

    return leaves(tree)


@pytest.mark.slow
def test_dreamerv3_learns_cartpole(rl_cluster):
    from ray_tpu_torch.rllib import DreamerV3Config

    algo = (DreamerV3Config()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(learning_starts=512, num_updates_per_step=8)
            .learners(device="cpu")
            .debugging(seed=0)
            .build())
    rets = []
    for _ in range(40):
        result = algo.train()
        r = result["env_runners"]["episode_return_mean"]
        if not np.isnan(r):
            rets.append(r)
    algo.stop()
    assert rets, "no episodes completed"
    # random CartPole averages ~20-25; the dreamed policy must clearly beat
    # it (the reference curve here reaches ~120 by 20k env steps)
    assert max(rets[-10:]) > 60.0, rets[-10:]
    # the world model must actually be fitting
    assert result["learners"]["wm_loss"] < 2.0
