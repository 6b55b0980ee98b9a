"""ray_tpu_torch.ops.moe against ray_tpu.ops.moe on the CPU: token-choice
top-k routing with capacity (exact dispatch, ties included), the combine
weights and aux loss, and moe_apply, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu_torch import ops as tops

TOL = 2e-5      # f32 products on both sides; summation order differs
ROUTE_TOL = 1e-6  # combine and aux: the same f32 softmax and sums


def _both(logits, **kw):
    want = jops.topk_routing(jnp.asarray(logits), **kw)
    got = tops.topk_routing(torch.from_numpy(np.asarray(logits)), **kw)
    return want, got


def _assert_same_routing(want, got):
    np.testing.assert_array_equal(got.dispatch.numpy(),
                                  np.asarray(want.dispatch))
    np.testing.assert_allclose(got.combine.numpy(), np.asarray(want.combine),
                               atol=ROUTE_TOL, rtol=ROUTE_TOL)
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss),
                               atol=ROUTE_TOL, rtol=ROUTE_TOL)


@pytest.mark.parametrize("N", [8, 37])
@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 4.0])
@pytest.mark.parametrize("k", [1, 2])
def test_topk_routing_matches_jax(k, capacity_factor, N):
    E = 8
    logits = (np.random.default_rng(N * 10 + k).standard_normal((N, E))
              * 2).astype(np.float32)
    want, got = _both(logits, num_experts=E, k=k,
                      capacity_factor=capacity_factor)
    C = int(max(k * N / E * capacity_factor, 1.0) + 0.9999)
    assert tuple(got.dispatch.shape) == (N, E, C)
    assert got.dispatch.dtype == got.combine.dtype == torch.float32
    _assert_same_routing(want, got)


def test_topk_routing_ties_pick_the_lower_expert_as_jax_does():
    """Equal router logits (bf16-exact values): jax.lax.top_k takes the
    lower expert index first; torch.topk does not promise to, so the port
    selects with a stable descending sort and must agree with JAX."""
    row = np.array([0.1, .5, .5, .5, .2, .5, 0, .3], np.float32)
    logits = np.stack([row, row[::-1].copy(), np.roll(row, 3)])
    logits = np.asarray(jnp.asarray(logits, jnp.bfloat16), np.float32)
    want, got = _both(logits, num_experts=8, k=2, capacity_factor=4.0)
    _assert_same_routing(want, got)
    # row 0 goes to experts 1 and 2, the two lowest of the four tied
    assert got.dispatch[0].sum(-1).nonzero().flatten().tolist() == [1, 2]


def test_topk_routing_matches_jax_on_bf16_router_logits():
    """Router logits as a Mixtral-style layer makes them (bf16 products of
    a normed input and a std-0.02 router), where near and exact ties
    occur: dispatch exactly equal."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((512, 256))).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((256, 8)) * 0.02).to(
        torch.bfloat16)
    logits = (x @ w).float().numpy()
    ties = (np.sort(logits, -1)[:, -3:-1] == np.sort(logits, -1)[:, -2:]).any(-1)
    assert ties.sum() > 0  # the case the stable sort is for
    want, got = _both(logits, num_experts=8, k=2, capacity_factor=1.25)
    _assert_same_routing(want, got)


def test_moe_routing_full_capacity_identity():
    """Twin of tests/test_ops.py::test_moe_routing_full_capacity_identity:
    with generous capacity and k=1, each token goes to its argmax expert."""
    N, E, D = 16, 4, 8
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((N, E)) * 5).float()
    routing = tops.topk_routing(logits, num_experts=E, k=1,
                                capacity_factor=4.0)
    x = torch.from_numpy(rng.standard_normal((N, D))).float()

    def expert_fn(params, xe):  # scale by an expert-specific constant
        return xe * params

    params = torch.arange(1.0, E + 1.0)[:, None, None]  # [E, 1, 1]
    y = tops.moe_apply(x, routing, expert_fn, params)
    top1 = logits.argmax(-1)
    np.testing.assert_allclose(y.numpy(), (x * (top1[:, None] + 1.0)).numpy(),
                               atol=1e-5)


def test_moe_capacity_drops():
    """Twin of tests/test_ops.py::test_moe_capacity_drops: all tokens
    prefer expert 0; capacity ceil(1*8/4*1.0) = 2 keeps two of them."""
    N, E = 8, 4
    logits = torch.tensor([[10.0, 0.0, 0.0, 0.0]]).repeat(N, 1)
    routing = tops.topk_routing(logits, num_experts=E, k=1,
                                capacity_factor=1.0)
    kept = routing.combine.sum(dim=(1, 2))
    assert int((kept > 0.5).sum()) == 2
    assert kept[:2].tolist() == [1.0, 1.0]  # earlier tokens win capacity
    assert routing.aux_loss.item() > 1.0  # heavily imbalanced


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
def test_moe_apply_matches_jax(capacity_factor):
    """The experts' swiglu mlp through dispatch → batched matmuls →
    combine, against the JAX package's vmap over the same stacked
    weights."""
    N, D, F, E, k = 24, 16, 32, 4, 2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    logits = rng.standard_normal((N, E)).astype(np.float32)
    w = {n: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for n, s in (("gate", (E, D, F)), ("up", (E, D, F)),
                      ("down", (E, F, D)))}
    kw = dict(num_experts=E, k=k, capacity_factor=capacity_factor)

    def jexpert(pe, xe):
        h = jops.swiglu(xe @ pe["gate"], xe @ pe["up"])
        return h @ pe["down"]

    def texpert(pe, xe):
        h = tops.swiglu(torch.bmm(xe, pe["gate"]), torch.bmm(xe, pe["up"]))
        return torch.bmm(h, pe["down"])

    want = jops.moe_apply(jnp.asarray(x), jops.topk_routing(
        jnp.asarray(logits), **kw), jexpert, jax.tree.map(jnp.asarray, w))
    got = tops.moe_apply(torch.from_numpy(x), tops.topk_routing(
        torch.from_numpy(logits), **kw), texpert,
        {n: torch.from_numpy(a) for n, a in w.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_topk_routing_refuses_a_wrong_expert_count():
    with pytest.raises(ValueError, match="experts"):
        tops.topk_routing(torch.zeros(4, 8), num_experts=4, k=2)
