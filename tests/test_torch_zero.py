"""ZeRO-1 (train/zero.py): twins of tests/test_zero.py's rules-plane and
device-plane tests, the device plane over 4 gloo ranks on the CPU against
the JAX package's unsharded optax baseline. The host-collective plane
(``ZeroShardedOptimizer``) is ROADMAP.md Queue 1 item 12.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch import parallel, train
from ray_tpu_torch.parallel import MeshSpec, P
from ray_tpu_torch.train import zero
from ray_tpu_torch.train.optim import optimizer_state_bytes

W = 4
STEPS, LR = 10, 1e-2


# ------------------------------------------------------------- rules plane


def test_match_partition_rules_params_and_opt_state():
    params = {"layers": {"wq": torch.zeros((4, 8)), "nw": torch.ones((8,))},
              "head": torch.zeros((8, 16)), "count": torch.zeros(())}
    rules = [("layers/wq", P("dp", "tp")), ("head", P(None, "tp")),
             ("nw", P())]
    specs = zero.match_partition_rules(rules, params)
    assert specs["layers"]["wq"] == P("dp", "tp")
    assert specs["head"] == P(None, "tp")
    assert specs["count"] == P()  # scalars never partitioned
    # a torch optimizer's state tree embeds the param paths → same rules
    leaves = train.param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = torch.ones_like(p)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    opt.step()
    state = zero.optimizer_state_tree(opt, params)
    assert set(state) == {"step", "exp_avg", "exp_avg_sq"}
    sspecs = zero.match_partition_rules(rules, state, strict=False)
    flat = [s for k in state for s in _specs(sspecs[k])]
    assert sum(s == P("dp", "tp") for s in flat) == 2  # both moments of wq


def _specs(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _specs(v)]
    return [tree]


def test_match_partition_rules_strict_raises():
    with pytest.raises(ValueError, match="no partition rule"):
        zero.match_partition_rules([("x", P())], {"y": torch.zeros((4, 4))})


def test_zero_shard_spec_folds_dp_into_first_free_divisible_dim():
    mesh = MeshSpec(dp=4, tp=2)
    assert zero.zero_shard_spec(P(), (8, 6), mesh) == P("dp", None)
    assert zero.zero_shard_spec(P(None, "tp"), (8, 6), mesh) == P("dp", "tp")
    # first dim not divisible -> falls to the second
    assert zero.zero_shard_spec(P(), (6, 8), mesh) == P(None, "dp")
    # already dp-sharded or nothing divisible -> unchanged
    assert zero.zero_shard_spec(P("dp"), (8,), mesh) == P("dp")
    assert zero.zero_shard_spec(P(), (3, 5), mesh) == P()
    assert zero.zero_shard_spec(P(), (), mesh) == P()


# ------------------------------------------------------------- device plane

def _toy_problem():
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((64, 16)) * 0.1).astype(np.float32),
              "b": np.zeros((16,), np.float32)}
    x = rng.standard_normal((64, 64)).astype(np.float32)
    y = rng.standard_normal((64, 16)).astype(np.float32)
    return params, (x, y)


def _loss(p, batch):
    xb, yb = batch
    return ((torch.tanh(xb @ p["w"]) + p["b"] - yb) ** 2).mean()


RULES = [("w", P()), ("b", P())]


def _zero_rank(params_np, batch_np):
    from ray_tpu_torch.train.spmd import init_sharded

    mesh = MeshSpec(dp=W).build()
    full = {k: torch.tensor(v) for k, v in params_np.items()}
    opt = functools.partial(train.adamw, learning_rate=LR)
    out = {}
    # make_train_step with zero_axis: the step builds the sharded state
    step, shard_params, bs = train.make_train_step(
        _loss, opt, mesh=mesh, partition_rules=RULES, params_template=full,
        zero_axis="dp", donate=False)
    params = shard_params(full)
    batch = tuple(bs.shard(torch.tensor(t)) for t in batch_np)
    state = None
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
    out["loss"] = float(loss)
    out["params"] = {k: v.detach().numpy() for k, v in params.items()}
    out["bytes"] = zero.sharded_state_bytes(state)
    copy = {k: v.detach().clone() for k, v in full.items()}
    unsharded = opt(copy)
    for p in train.param_leaves(copy):  # one step allocates the state
        p.grad = torch.ones_like(p)
    unsharded.step()
    out["unsharded_bytes"] = optimizer_state_bytes(unsharded)
    out["dims"] = state.dims
    out["moment_shape"] = tuple(state.optimizer.state[
        state.targets[0]]["exp_avg"].shape)
    # make_zero_train_step: init_opt_state straight into the shards
    step2, init_opt_state, shard2, bs2 = zero.make_zero_train_step(
        _loss, full, mesh, opt, RULES, donate=False)
    p2 = shard2(full)
    st2 = init_opt_state(p2)
    p2, st2, loss2 = step2(p2, st2, tuple(bs2.shard(torch.tensor(t))
                                          for t in batch_np))
    out["zero_step"] = (float(loss2), zero.sharded_state_bytes(st2))
    # the refusals need a mesh over an initialised group
    errs = []
    for kw, match in ((dict(zero_axis="dp"), "zero_axis needs partition_rules"),
                      (dict(partition_rules=[(".*", P())]),
                       "needs params_template")):
        try:
            train.make_train_step(_loss, opt, mesh=mesh, **kw)
        except ValueError as e:
            errs.append(match in str(e))
    out["refusals"] = errs
    # init_sharded by regex rules
    tmesh = MeshSpec(tp=W).build()
    emb = init_sharded(
        lambda: {"emb": torch.randn((16, 8), generator=torch.Generator()
                                    .manual_seed(0)),
                 "head": torch.zeros((8, 16))},
        None, tmesh, partition_rules=[("emb", P(None, "tp")),
                                      ("head", P(None, "tp"))])
    out["init_sharded"] = (tuple(emb["emb"].shape), tuple(emb["head"].shape))
    return out


@pytest.fixture(scope="module")
def world():
    params, batch = _toy_problem()
    return params, batch, parallel.launch(
        _zero_rank, W, args=(params, batch), backend="gloo", device="cpu",
        timeout=90)


def _jax_baseline(params, batch):
    import jax
    import jax.numpy as jnp
    import optax

    def loss_fn(p, b):
        xb, yb = b
        return jnp.mean((jnp.tanh(xb @ p["w"]) + p["b"] - yb) ** 2)

    opt = optax.adamw(LR)
    p = jax.tree.map(jnp.asarray, params)
    s = opt.init(p)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p, batch)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    for _ in range(STEPS):
        p, s, loss = step(p, s)
    return float(loss), jax.tree.map(np.asarray, p)


def test_spmd_zero_state_bytes_drop_w_times_with_loss_parity(world):
    params, batch, res = world
    want_loss, want = _jax_baseline(params, batch)
    for r in res:
        # loss parity: same math, only sharded
        np.testing.assert_allclose(r["loss"], want_loss, rtol=1e-4)
        for k in want:
            np.testing.assert_allclose(r["params"][k], want[k], atol=2e-5,
                                       rtol=2e-5)
        # per-rank optimizer state drops ~W x (step counts are not sharded)
        assert r["unsharded_bytes"] / r["bytes"] > 0.9 * W
        # the moments really carry the dp axis: w folds dp into dim 0
        assert r["dims"] == [0, 0]
        assert r["moment_shape"] == (64 // W, 16)


def test_make_zero_train_step_init_opt_state_is_sharded(world):
    _, _, res = world
    for r in res:
        loss, nbytes = r["zero_step"]
        assert np.isfinite(loss)
        assert r["unsharded_bytes"] / nbytes > W - 1


def test_init_sharded_with_partition_rules(world):
    _, _, res = world
    assert all(r["init_sharded"] == ((16, 2), (8, 4)) for r in res)


def test_make_train_step_zero_axis_requires_rules(world):
    _, _, res = world
    assert all(r["refusals"] == [True, True] for r in res)
