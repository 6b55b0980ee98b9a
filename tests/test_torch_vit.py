"""ray_tpu_torch.models.vit against ray_tpu.models.vit on the CPU: forward,
loss and gradients on the JAX package's own weights (a tiny f32 config),
the param tree's conversion, init and the config table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.ops import flash_attention as tflash

TOL = 2e-5  # f32 on both sides; matmul summation order differs

TINY = dict(image_size=32, patch_size=8, num_classes=10, d_model=64,
            n_layers=2, n_heads=4, d_ff=128)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def tiny():
    """Both configs and the JAX init's weights, with random LayerNorm and
    bias values so those paths are live."""
    jcfg = jvit.vit_config("s16", **TINY, dtype=jnp.float32)
    tcfg = tvit.vit_config("s16", **TINY, dtype=torch.float32)
    rng = np.random.default_rng(4)
    tree = jax.tree.map(np.asarray, jvit.init(jax.random.PRNGKey(0), jcfg))
    for path in ("patch_bias", "final_norm/b"):
        node = tree
        *head, last = path.split("/")
        for key in head:
            node = node[key]
        node[last] = (rng.standard_normal(node[last].shape) * 0.1).astype(
            np.float32)
    for sub, name in (("norm1", "b"), ("mlp", "bi"), ("mlp", "bo")):
        leaf = tree["layers"][sub][name]
        tree["layers"][sub][name] = (rng.standard_normal(leaf.shape)
                                     * 0.1).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, convert.params_from_jax(tree, tcfg, "cpu")


def _batch(seed, B=2):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=(B,))
    return images, labels


def test_patchify_matches_jax():
    images, _ = _batch(0)
    want = jvit.patchify(jnp.asarray(images), 8)
    got = tvit.patchify(torch.from_numpy(images), 8)
    assert tuple(got.shape) == (2, 16, 192)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vit_forward_matches_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    images, _ = _batch(1)
    want = jvit.forward(jparams, jnp.asarray(images), jcfg)
    got = tvit.forward(tparams, torch.from_numpy(images), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_vit_loss_and_grads_match_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    images, labels = _batch(2)
    want, jgrads = jax.value_and_grad(jvit.loss_fn)(
        jparams, (jnp.asarray(images), jnp.asarray(labels)), jcfg)
    names = [n for n, _ in _leaves(tparams)]
    params, leaves = {}, []
    for name in names:
        node, src = params, tparams
        *head, last = name.split("/")
        for key in head:
            node, src = node.setdefault(key, {}), src[key]
        node[last] = src[last].detach().clone().requires_grad_()
        leaves.append(node[last])
    loss = tvit.loss_fn(params, (torch.from_numpy(images),
                                 torch.from_numpy(labels)), tcfg)
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=TOL)
    jl = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert set(jl) == set(names)
    for name, g in zip(names, torch.autograd.grad(loss, leaves)):
        np.testing.assert_allclose(g.numpy(), jl[name], atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_vit_tree_round_trips_through_params_from_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    jl = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    tl = dict(_leaves(tparams))
    assert set(tl) == set(jl) and "cls_token" in tl and "head" in tl
    for name, arr in jl.items():
        assert np.array_equal(tl[name].numpy(), arr), name
    bf = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(bf))
    bad = jax.tree.map(np.asarray, jparams)
    bad["pos_embed"] = bad["pos_embed"][:-1]
    with pytest.raises(ValueError, match="pos_embed"):
        convert.params_from_jax(bad, tcfg, "cpu")


def test_vit_init_shapes_match_jax_and_config_table():
    tcfg = tvit.vit_config("s16", **TINY, dtype=torch.float32)
    params = tvit.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    jshapes = jax.eval_shape(lambda: jvit.init(
        jax.random.PRNGKey(0), jvit.vit_config("s16", **TINY)))
    tl, jl = dict(_leaves(params)), dict(_leaves(jshapes))
    assert set(tl) == set(jl)
    for name, t in tl.items():
        assert tuple(t.shape) == tuple(jl[name].shape), name
    assert torch.all(params["layers"]["norm1"]["w"] == 1)
    assert torch.all(params["layers"]["mlp"]["bi"] == 0)
    assert abs(params["pos_embed"].std().item() - 0.02) < 4e-3
    for size in ("s16", "b16", "l16"):
        t, j = tvit.vit_config(size), jvit.vit_config(size)
        assert (t.d_model, t.n_layers, t.n_heads, t.d_ff, t.n_patches,
                t.head_dim) == (j.d_model, j.n_layers, j.n_heads, j.d_ff,
                                j.n_patches, j.head_dim)
    # ViT-L/16 at 224²: T = 197 at head_dim 64, which the flash kernels do
    # not tile, so its attention takes the dense path on the card too
    l16 = tvit.vit_config("l16")
    bf = {n: torch.bfloat16 for n in "qkv"}
    assert not tflash._fits((8, 16, l16.n_patches + 1, l16.head_dim), bf,
                            True)
