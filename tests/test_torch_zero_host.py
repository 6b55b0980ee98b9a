"""The port's host-plane ZeRO-1 (``ZeroShardedOptimizer`` over the actor
ring) against the JAX package's.

Twins of tests/test_zero.py:245-275: two ranks flatten the params,
reduce-scatter the mean gradient over the host ring (f32, or int8 with
error feedback), update their 1/W shard and allgather it back. Each side
holds its ranks equal, its params (f32) or loss (int8) to an unsharded
baseline of its own framework, and its optimizer state under 0.62 x the
baseline's; across the packages the f32 runs agree. The problem's params
and inputs come from numpy seeds, the same on both sides.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_twins import is_port, kill_made, start_sessions, sub, twin

W0 = (np.random.default_rng(0).standard_normal((37, 19)) * 0.5).astype(
    np.float32)
XS = [np.random.default_rng(10 + r).standard_normal((32, 37)).astype(
    np.float32) for r in range(2)]


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _zero_worker(rt):
    """The reference's ZeroWorker on package `rt`, its train functions
    defined here too: a worker unpickles them by value and never imports
    this file."""
    pkg = rt.__name__

    def _jax_train(group, steps, opt_kind, compression, w0, x):
        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu.train import zero
        from ray_tpu.train.optim import adamw_int8

        params = {"w": jnp.asarray(w0), "b": jnp.zeros((19,))}

        def loss_fn(p, xb):
            return jnp.mean(jnp.tanh(xb @ p["w"] + p["b"]) ** 2)

        opt = (adamw_int8(1e-2, weight_decay=0.01) if opt_kind == "int8"
               else optax.adamw(1e-2, weight_decay=0.01))
        zopt = zero.ZeroShardedOptimizer(opt, group_name=group,
                                         grad_compression=compression)
        state = zopt.init(params)
        for _ in range(steps):
            loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(x))
            params, state = zopt.step(params, grads, state)
        return (float(loss), zopt.state_bytes(state), np.asarray(params["w"]))


    def _port_train(group, steps, opt_kind, compression, w0, x):
        import functools

        import torch

        from ray_tpu_torch import train as tr

        params = {"w": torch.from_numpy(w0.copy()), "b": torch.zeros(19)}

        def loss_fn(p, xb):
            return torch.mean(torch.tanh(xb @ p["w"] + p["b"]) ** 2)

        make = tr.adamw_int8 if opt_kind == "int8" else tr.adamw
        zopt = tr.ZeroShardedOptimizer(
            functools.partial(make, learning_rate=1e-2, weight_decay=0.01),
            group_name=group, grad_compression=compression)
        state = zopt.init(params)
        xt = torch.from_numpy(x)
        for _ in range(steps):
            leaves = [t.requires_grad_(True) for t in tr.param_leaves(params)]
            loss = loss_fn(params, xt)
            grads = dict(zip(params, torch.autograd.grad(loss, leaves)))
            params, state = zopt.step(params, grads, state)
        return (loss.item(), zopt.state_bytes(state),
                params["w"].detach().numpy())


    @rt.remote
    class ZeroWorker:
        def init_collective_group(self, world_size, rank, backend,
                                  group_name):
            import importlib

            importlib.import_module(pkg + ".util.collective") \
                .init_collective_group(world_size, rank, backend=backend,
                                       group_name=group_name)
            self.rank = rank
            self.g = group_name

        def train(self, steps, opt_kind, grad_compression, w0, x):
            return (_port_train if pkg == "ray_tpu_torch" else _jax_train)(
                self.g, steps, opt_kind, grad_compression, w0, x)

        def opt_state_gauge(self):
            import importlib

            met = importlib.import_module(pkg + ".util.metrics")
            rec = [m for m in met.snapshot()
                   if m["name"] == "ray_tpu_train_opt_state_bytes"]
            return rec[0]["series"] if rec else []

    return ZeroWorker


def _baseline(rt, steps, opt_kind):
    """Unsharded dp baseline of `rt`'s framework: every rank updates with
    the mean gradient."""
    if is_port(rt):
        import torch

        from ray_tpu_torch import train as tr

        params = {"w": torch.from_numpy(W0.copy()), "b": torch.zeros(19)}
        make = tr.adamw_int8 if opt_kind == "int8" else tr.adamw
        opt = make(params, 1e-2, weight_decay=0.01)
        leaves = tr.param_leaves(params)
        for _ in range(steps):
            losses, grads = [], []
            for x in XS:
                loss = torch.mean(torch.tanh(
                    torch.from_numpy(x) @ params["w"] + params["b"]) ** 2)
                losses.append(loss.item())
                grads.append(torch.autograd.grad(loss, leaves))
            for p, g0, g1 in zip(leaves, *grads):
                p.grad = (g0 + g1) / 2
            opt.step()
            opt.zero_grad(set_to_none=True)
        return (losses[0], tr.optimizer_state_bytes(opt),
                params["w"].detach().numpy())
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.train.optim import adamw_int8, optimizer_state_bytes

    params = {"w": jnp.asarray(W0), "b": jnp.zeros((19,))}

    def loss_fn(p, xb):
        return jnp.mean(jnp.tanh(xb @ p["w"] + p["b"]) ** 2)

    opt = (adamw_int8(1e-2, weight_decay=0.01) if opt_kind == "int8"
           else optax.adamw(1e-2, weight_decay=0.01))
    state = opt.init(params)
    for _ in range(steps):
        pairs = [jax.value_and_grad(loss_fn)(params, jnp.asarray(x))
                 for x in XS]
        grads = jax.tree.map(lambda *g: sum(g) / 2, *[g for _, g in pairs])
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return (float(pairs[0][0]), optimizer_state_bytes(state),
            np.asarray(params["w"]))


_made: dict = {}


def _run_group(rt, steps, opt_kind, compression, name):
    ws = [_zero_worker(rt).remote() for _ in range(2)]
    _made.setdefault(rt.__name__, []).extend(ws + [name])
    sub(rt, "util.collective").create_collective_group(
        ws, 2, [0, 1], group_name=name)
    out = rt.get([w.train.remote(steps, opt_kind, compression, W0, XS[r])
                  for r, w in enumerate(ws)], timeout=300)
    return ws, out


def _both(pkgs, scn):
    """scenario on both runtimes at once, each side's results; then every
    actor it made is killed (the reference gives each test a fresh
    cluster)."""
    try:
        return twin(pkgs, scn, serve_cleanup=False)
    finally:
        kill_made(pkgs, _made)


def test_host_zero_exact_parity_fp32(pkgs):
    """f32 AdamW + uncompressed ring: the sharded update is the baseline
    update, partitioned — parity to float tolerance, state ~1/2."""
    def scn(rt):
        _, out = _run_group(rt, 8, "fp32", None, "zfp")
        return out, _baseline(rt, 8, "fp32")

    sides = _both(pkgs, scn)
    for out, (base_loss, base_bytes, base_w) in sides:
        (l0, bytes0, w0), (l1, bytes1, w1) = out
        np.testing.assert_array_equal(w0, w1)  # ranks stay in lockstep
        np.testing.assert_allclose(w0, base_w, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(l0, base_loss, rtol=1e-4)
        assert bytes0 < 0.62 * base_bytes
    (jout, _), (tout, _) = sides
    np.testing.assert_allclose(tout[0][2], jout[0][2], rtol=1e-4, atol=1e-5)


def test_host_zero_int8_grads_int8_state_loss_parity(pkgs):
    """Quantized (error-feedback) reduce-scatter feeding a dp-sharded
    int8-AdamW update: the loss stays within 10 % of the unsharded
    baseline's, and the worker's opt-state gauge is the state it holds."""
    def scn(rt):
        ws, out = _run_group(rt, 12, "int8", "int8_block", "zq")
        series = rt.get(ws[0].opt_state_gauge.remote())
        return out, _baseline(rt, 12, "int8"), series

    for out, (base_loss, base_bytes, _), series in _both(pkgs, scn):
        (l0, bytes0, w0), (l1, bytes1, w1) = out
        np.testing.assert_array_equal(w0, w1)
        np.testing.assert_allclose(l0, base_loss, rtol=0.1)
        assert bytes0 < 0.62 * base_bytes
        assert series and series[0][1] == bytes0
