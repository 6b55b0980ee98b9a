"""The port's IMPALA and APPO learners against the JAX package's.

Parity on the CPU, inputs from a numpy seed, the JAX package on the CPU:
- ``_vtrace`` with rho and c clipping active (behaviour != target) and
  dones inside the fragment, within 2e-5;
- one and three IMPALA and APPO updates (APPO's target refreshed at
  ``target_update_frequency=2``) from ``params_from_jax`` of the reference
  learner's params and a fresh Adam state, with batches whose gradient
  norm exceeds optax.clip_by_global_norm's 40: params, target params and
  metrics within 2e-5 (f32).

Then twins of tests/test_rllib_impala.py against the port's runtime, with
the reference's thresholds and iteration counts; the learner on the CPU,
the runners CPU actors.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ray_tpu_torch

PARITY_TOL = 2e-5  # f32 V-trace and update steps, port vs JAX package


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This process's torch on one intra-op thread, as each env runner's
    (a 64-wide MLP gains nothing from more, and spinning OpenMP threads
    slow each small op many times over under the suite's workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


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


def _assert_trees_close(port, ref, tol):
    a, b = _leaves(port), _leaves(ref)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


def _assert_metrics_close(port: dict, ref: dict, tol):
    assert set(port) == set(ref)
    for k in ref:
        assert abs(port[k] - float(ref[k])) <= tol * max(1.0, abs(
            float(ref[k]))), (k, port[k], ref[k])


def _vtrace_inputs(seed, T=24, N=5):
    rng = np.random.default_rng(seed)
    return {
        "target_logp": np.log(rng.uniform(0.05, 1.0, (T, N))).astype(
            np.float32),
        "behavior_logp": np.log(rng.uniform(0.05, 1.0, (T, N))).astype(
            np.float32),
        "rewards": rng.normal(size=(T, N)).astype(np.float32),
        "values": rng.normal(size=(T, N)).astype(np.float32),
        "dones": rng.random((T, N)) < 0.15,
        "last_value": rng.normal(size=N).astype(np.float32),
    }


@pytest.mark.parametrize("rho_bar,c_bar", [(1.0, 1.0), (2.0, 0.5)])
def test_vtrace_matches_the_reference(rho_bar, c_bar):
    jax = _jax()
    from ray_tpu.rllib.algorithms.impala import _vtrace as jvtrace
    from ray_tpu_torch.rllib.algorithms.impala import _vtrace

    x = _vtrace_inputs(0)
    ratio = np.exp(x["target_logp"] - x["behavior_logp"])
    # both clips bind somewhere, and some fragments end inside
    assert (ratio > rho_bar).any() and (ratio > c_bar).any()
    assert x["dones"].any()
    jvs, jadv = jax.device_get(jvtrace(
        *(jax.numpy.asarray(x[k]) for k in x), gamma=0.97, rho_bar=rho_bar,
        c_bar=c_bar))
    vs, adv = _vtrace(*(torch.from_numpy(x[k]) for k in x), gamma=0.97,
                      rho_bar=rho_bar, c_bar=c_bar)
    assert not vs.requires_grad and not adv.requires_grad
    np.testing.assert_allclose(vs.numpy(), jvs, rtol=PARITY_TOL,
                               atol=PARITY_TOL)
    np.testing.assert_allclose(adv.numpy(), jadv, rtol=PARITY_TOL,
                               atol=PARITY_TOL)


def _impala_batch(seed, T=16, N=6, reward_scale=30.0, obs_scale=1.0):
    """A runner's time-major batch; at the default scales the gradient's
    global norm passes 40 and the clip binds."""
    rng = np.random.default_rng(seed)
    return {
        "obs": (rng.normal(size=(T, N, 4)) * obs_scale).astype(np.float32),
        "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
        "behavior_logp": np.log(rng.uniform(0.2, 0.8, (T, N))).astype(
            np.float32),
        "rewards": (rng.normal(size=(T, N)) * reward_scale).astype(
            np.float32),
        "dones": rng.random((T, N)) < 0.1,
        "bootstrap_obs": rng.normal(size=(N, 4)).astype(np.float32),
    }


def _learners(kind: str):
    jax = _jax()
    from ray_tpu.rllib.algorithms import appo as jappo
    from ray_tpu.rllib.algorithms import impala as jimpala
    from ray_tpu_torch.rllib.algorithm import _merge
    from ray_tpu_torch.rllib.algorithms import appo, impala
    from ray_tpu_torch.rllib.algorithms.dqn import snapshot

    kw = dict(lr=1e-3, gamma=0.97, rho_bar=1.0, c_bar=1.0)
    if kind == "appo":
        kw.update(clip_param=0.3, kl_coeff=0.2, target_update_frequency=2)
        ref = jappo.AppoLearner(4, 2, seed=3, **kw)
        port = appo.AppoLearner(4, 2, device="cpu", **kw)
    else:
        ref = jimpala.ImpalaLearner(4, 2, seed=3, **kw)
        port = impala.ImpalaLearner(4, 2, device="cpu", **kw)
    # the reference learner's params, copied into the port's live leaves
    _merge(port.params, jax.device_get(ref.params))
    port.target_params = snapshot(port.params)
    return ref, port


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("kind", ["impala", "appo"])
def test_update_matches_the_reference(kind, steps, monkeypatch):
    jax = _jax()
    from ray_tpu_torch.rllib.algorithms import impala

    norms = []
    clip = impala.clip_by_global_norm_

    def recording(grads, max_norm):
        g_norm = clip(grads, max_norm)
        norms.append(float(g_norm))
        return g_norm

    monkeypatch.setattr(impala, "clip_by_global_norm_", recording)
    ref, port = _learners(kind)
    # three steps: the first below the clip's bound, the others above it
    scales = [(30.0, 1.0)] if steps == 1 else [
        (0.01, 0.01), (30.0, 1.0), (30.0, 1.0)]
    for step, (reward_scale, obs_scale) in enumerate(scales):
        batch = _impala_batch(step, reward_scale=reward_scale,
                              obs_scale=obs_scale)
        jm = ref.update(batch)
        tm = port.update(batch)
    assert norms[-1] > impala.MAX_GRAD_NORM  # the clip path ran
    if steps == 3:
        assert norms[0] < impala.MAX_GRAD_NORM
    _assert_trees_close(port.params, jax.device_get(ref.params), PARITY_TOL)
    _assert_trees_close(port.target_params,
                        jax.device_get(ref.target_params), PARITY_TOL)
    _assert_metrics_close(tm, jm, PARITY_TOL)
    assert tm["weights_version"] == jm["weights_version"] == steps
    if kind == "appo":
        # refreshed after the 2nd update: a clone, not the live leaves
        from ray_tpu_torch.rllib.learner import leaves

        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
            leaves(port.target_params), leaves(port.params)))
        if steps == 3:  # the target holds step 2's params, not step 3's
            assert any(not torch.equal(a, b) for a, b in zip(
                leaves(port.target_params), leaves(port.params)))


def test_weights_blob_and_learner_device():
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.rllib import IMPALAConfig
    from ray_tpu_torch.rllib.algorithms.impala import ImpalaLearner

    lrn = ImpalaLearner(4, 2, device="cpu", seed=5)
    tree = ser.loads(lrn.get_weights_blob())
    _assert_trees_close(lrn.params, tree, 0.0)
    assert all(type(v) is np.ndarray for v in _leaves(tree).values())
    if not torch.cuda.is_available():
        # None is the card: without one a build raises before any runner
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ImpalaLearner(4, 2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            IMPALAConfig().environment("CartPole-v1").build()


def test_streams_run_at_most_their_window_ahead(rl_cluster):
    """`_generator_backpressure_num_objects` bounds how far a streaming
    actor method runs ahead of its consumer (IMPALA's runners: 2 batches,
    ``impala.STREAM_AHEAD``); None keeps the runtime's 16."""
    import time

    from ray_tpu_torch.rllib.algorithms import impala

    @ray_tpu_torch.remote
    class Producer:
        def __init__(self):
            self.n = 0

        def items(self, k):
            for i in range(k):
                self.n += 1
                yield i

        def made(self):
            return self.n

    got = {}
    for window in (impala.STREAM_AHEAD, None):
        p = Producer.options(max_concurrency=2).remote()
        gen = p.items.options(num_returns="streaming",
                              _generator_backpressure_num_objects=window
                              ).remote(40)
        deadline = time.monotonic() + 30
        want = (window or 16) + 1  # the item that found the window full
        while (ray_tpu_torch.get(p.made.remote(), timeout=30) < want
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(0.5)
        got[window] = ray_tpu_torch.get(p.made.remote(), timeout=30)
        first = ray_tpu_torch.get(gen.next_item(timeout=30), timeout=30)
        assert first == 0
        del gen
        ray_tpu_torch.kill(p)
    assert got == {impala.STREAM_AHEAD: impala.STREAM_AHEAD + 1, None: 17}


# ------------------------------------- twins of tests/test_rllib_impala.py


@pytest.fixture
def rl_cluster():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=16, num_workers=2, max_workers=10)
    yield
    ray_tpu_torch.shutdown()


def test_vtrace_on_policy_reduces_to_gae_targets():
    """With target == behavior policy and c_bar=rho_bar=1, vs matches the
    lambda=1 discounted-return recursion."""
    from ray_tpu_torch.rllib.algorithms.impala import _vtrace

    T, N = 6, 3
    rng = np.random.default_rng(0)
    logp = torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32))
    rewards = torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32))
    values = torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32))
    dones = torch.zeros((T, N), dtype=torch.bool)
    last_v = torch.from_numpy(rng.normal(size=(N,)).astype(np.float32))
    vs, adv = _vtrace(logp, logp, rewards, values, dones, last_v,
                      gamma=0.9, rho_bar=1.0, c_bar=1.0)
    # on-policy, no truncation: vs_t = r_t + gamma vs_{t+1}; vs_T-1 uses V(x_T)
    expect = np.zeros((T, N), np.float32)
    nxt = last_v.numpy()
    for t in reversed(range(T)):
        expect[t] = rewards[t].numpy() + 0.9 * nxt
        nxt = expect[t]
    np.testing.assert_allclose(vs.numpy(), expect, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_impala_learns_cartpole(rl_cluster):
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                     rollout_fragment_length=48)
        .training(lr=3e-3)
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
def test_impala_survives_runner_death(rl_cluster):
    from ray_tpu_torch.rllib import IMPALAConfig

    algo = (
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=32)
        .learners(device="cpu")
        .debugging(seed=1)
        .build()
    )
    r1 = algo.train()
    assert r1["learners"]["batches_consumed"] > 0
    # kill one rollout actor mid-run
    ray_tpu_torch.kill(algo._runners[0])
    r2 = algo.train()
    r3 = algo.train()
    algo.stop()
    # the iteration after the kill still consumed batches and the pool healed
    assert (r2["learners"]["batches_consumed"]
            + r3["learners"]["batches_consumed"]) > 0
    assert r3["learners"]["num_healthy_runners"] == 2
