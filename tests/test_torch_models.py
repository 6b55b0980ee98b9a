"""ray_tpu_torch.models against ray_tpu.models on the CPU, on TINY-style f32
configs with the JAX package's own weights converted by params_from_jax."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decoding as jdec
from ray_tpu.models import decoding_paged as jdp
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.models import convert, decoding as tdec
from ray_tpu_torch.models import decoding_paged as tdp
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import transformer as ttr

TOL = 2e-5  # f32 on both sides; matmul summation order differs

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
PAGE = 16
MAX_LEN = 64


@pytest.fixture(scope="module")
def tiny():
    jcfg = jtr.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    tcfg = ttr.TransformerConfig(**TINY, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    tparams = convert.params_from_jax(np_tree, tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_params_from_jax_round_trip(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    jl = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    tl = dict(_leaves(tparams))
    assert set(jl) == set(tl)
    for name, arr in jl.items():
        assert np.array_equal(tl[name].numpy(), arr), name
    # bf16 leaves cross as their bit pattern, and dtype= casts once
    bf = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), jparams)
    tb = convert.params_from_jax(bf, tcfg, "cpu")
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["embed"].float().numpy(),
                                  np.asarray(bf["embed"], np.float32))
    cast = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                   "cpu", torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in _leaves(cast))
    bad = jax.tree.map(np.asarray, jparams)
    bad["embed"] = bad["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_jax(bad, tcfg, "cpu")


def test_init_shapes_match_jax_and_config_rules():
    for size in ("tiny", "8b"):
        jcfg = jtr.TransformerConfig(**{**tllama.SIZES[size],
                                        "vocab_size": 128256})
        tcfg = tllama.llama_config(size)
        assert tcfg.num_params() == jcfg.num_params()
    cfg = ttr.TransformerConfig(**TINY, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = ttr.init(gen, cfg, "cpu")
    jshapes = jax.eval_shape(lambda: jtr.init(jax.random.PRNGKey(0),
                                              jtr.TransformerConfig(**TINY)))
    for (name, t), (_, j) in zip(sorted(_leaves(params)),
                                 sorted(_leaves(jshapes))):
        assert tuple(t.shape) == tuple(j.shape), name
    assert torch.all(params["final_norm"]["w"] == 1)
    assert abs(params["embed"].std().item() - 0.02) < 2e-3
    # a MoE config builds; remat_policy="pairs" with MoE raises, as the
    # JAX package's forward does
    moe = ttr.TransformerConfig(**TINY, moe=ttr.MoEConfig(num_experts=4),
                                dtype=torch.float32, remat_policy="pairs")
    moe_params = ttr.init(gen, moe, "cpu")
    assert tuple(moe_params["layers"]["mlp"]["down"].shape) == (2, 4, 128, 64)
    with pytest.raises(ValueError, match="non-MoE"):
        ttr.forward(moe_params, torch.zeros((1, 8), dtype=torch.long), moe)


def test_forward_matches_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    tokens = np.random.default_rng(0).integers(0, 128, size=(2, 24))
    want, _ = jtr.forward(jparams, jnp.asarray(tokens), jcfg)
    got, aux = ttr.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("n", [5, 16, 29])
def test_prefill_logits_and_kv_match_jax(tiny, n):
    jcfg, jparams, tcfg, tparams = tiny
    bucket = 16 if n <= 16 else 32
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = np.random.default_rng(n).integers(1, 127, size=n)
    jl, jkv = jdec.prefill(jparams, jnp.asarray(padded), jnp.int32(n), jcfg)
    tl, tkv = tdec.prefill(tparams, torch.from_numpy(padded).long(), n, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for key in ("k", "v"):
        assert tuple(tkv[key].shape) == (2, bucket, 2, 16)
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=TOL, rtol=TOL)


def _mixed_states(jcfg, jparams, tcfg, tparams, lengths):
    """The same mixed-length batch inserted into a JAX and a port state
    (one active row per length, full page reservation)."""
    MP = MAX_LEN // PAGE
    slots = len(lengths)
    jstate = jdp.init_paged_state(jcfg, slots, MAX_LEN, slots * MP + 1, PAGE)
    tstate = tdp.init_paged_state(tcfg, slots, MAX_LEN, slots * MP + 1, PAGE,
                                  "cpu")
    free = list(range(1, slots * MP + 1))
    for slot, n in enumerate(lengths):
        bucket = PAGE
        while bucket < n:
            bucket *= 2
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = 1 + np.arange(n) % (TINY["vocab_size"] - 2)
        jl, jkv = jdec.prefill(jparams, jnp.asarray(padded), jnp.int32(n), jcfg)
        tl, tkv = tdec.prefill(tparams, torch.from_numpy(padded).long(), n, tcfg)
        first = int(jnp.argmax(jl))
        assert int(torch.argmax(tl)) == first
        row = np.asarray([free.pop() for _ in range(MP)], np.int32)
        jstate = jdp.insert_sequence_paged(
            jstate, slot, jkv, jnp.int32(n), jnp.asarray(first, jnp.int32),
            jnp.asarray(row), jcfg)
        tdp.insert_sequence_paged(tstate, slot, tkv, n, first, row, tcfg)
    return jstate, tstate


@pytest.mark.parametrize("bound", ["tight", "full"])
def test_decode_step_paged_ragged_matches_jax(tiny, bound):
    """Three ragged steps on a mixed-length batch against JAX's, at a
    tight page bound and at the full table."""
    jcfg, jparams, tcfg, tparams = tiny
    lengths = [3, 17, 27, 9]
    jstate, tstate = _mixed_states(jcfg, jparams, tcfg, tparams, lengths)
    nb = 2 if bound == "tight" else MAX_LEN // PAGE
    for _ in range(3):
        jstate, jl = jdp.decode_step_paged_ragged(jparams, jstate, jcfg, nb)
        tstate, tl = tdp.decode_step_paged_ragged(tparams, tstate, tcfg, nb)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)  # writable copy
        jstate = jdec.commit_tokens(jstate, jnp.asarray(nxt))
        tdec.commit_tokens(tstate, torch.from_numpy(nxt))
    for key in ("kp", "vp"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                   atol=TOL, rtol=TOL)
    assert tstate["length"].tolist() == np.asarray(jstate["length"]).tolist()


def test_decode_step_gather_and_reference_agree_with_ragged(tiny):
    """The gather step and the ragged step with impl='reference' are the
    same function on one state (the second oracle)."""
    jcfg, jparams, tcfg, tparams = tiny
    _, s1 = _mixed_states(jcfg, jparams, tcfg, tparams, [4, 20])
    s2 = {k: v.clone() for k, v in s1.items()}
    s1, l1 = tdp.decode_step_paged_ragged(tparams, s1, tcfg, 2,
                                          impl="reference")
    s2, l2 = tdp.decode_step_paged(tparams, s2, tcfg)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=TOL, rtol=TOL)
    tdp.release_slot_paged(s1, 0)
    assert s1["active"].tolist() == [False, True]
    assert s1["length"].tolist() == [0, 21]


def test_gpt2_style_config_matches_jax():
    """LayerNorm, GELU, learned positions, biases and tied embeddings:
    forward, prefill and two ragged decode steps against JAX (the biases
    and LayerNorm params get random values so those paths are live)."""
    kw = dict(TINY, norm="ln", act="gelu", pos="learned", bias=True,
              tie_embeddings=True)
    jcfg = jtr.TransformerConfig(**kw, dtype=jnp.float32, remat=False)
    tcfg = ttr.TransformerConfig(**kw, dtype=torch.float32)
    rng = np.random.default_rng(5)
    jparams = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05, x.dtype),
        jtr.init(jax.random.PRNGKey(1), jcfg))
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    assert "lm_head" not in tparams and "pos_embed" in tparams
    tokens = rng.integers(0, 128, size=(1, 16))
    want, _ = jtr.forward(jparams, jnp.asarray(tokens), jcfg)
    got, _ = ttr.forward(tparams, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    jstate, tstate = _mixed_states(jcfg, jparams, tcfg, tparams, [5, 12])
    for _ in range(2):
        jstate, jl = jdp.decode_step_paged_ragged(jparams, jstate, jcfg, 1)
        tstate, tl = tdp.decode_step_paged_ragged(tparams, tstate, tcfg, 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        jstate = jdec.commit_tokens(jstate, jnp.asarray(nxt))
        tdec.commit_tokens(tstate, torch.from_numpy(nxt))


def test_sampling_greedy_and_top_k():
    logits = torch.tensor([[0.1, 3.0, -1.0, 2.9], [5.0, 0.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    assert tdec.sample(logits, gen, 0.0).tolist() == [1, 0]
    out = tdec.sample_per_row(logits, gen, torch.tensor([0.0, 1.0]),
                              torch.tensor([0, 1], dtype=torch.int32))
    assert out.tolist() == [1, 0]  # greedy row; top-1 row is deterministic
    draws = torch.stack([tdec.sample(logits, gen, 1.0, top_k=2)
                         for _ in range(200)])
    assert set(draws[:, 0].tolist()) <= {1, 3}
    freq = (draws[:, 0] == 1).float().mean().item()  # p = e^3/(e^3+e^2.9)
    assert 0.4 < freq < 0.65


# ------------------------------------------------- the three model families

FAMILY_KW = dict(vocab_size=128, max_seq_len=64, d_model=64, n_layers=2,
                 n_heads=4)


def _family_configs(name):
    """(jax cfg, port cfg): the tiny configs of tests/test_models.py:12-27
    in f32, built by each package's own family factory."""
    from ray_tpu.models import gpt2_config, llama_config, mixtral_config
    from ray_tpu_torch import models as tmodels

    kw = {"gpt2": dict(FAMILY_KW, d_ff=128),
          "llama": dict(FAMILY_KW, n_kv_heads=2, d_ff=96),
          "mixtral": dict(FAMILY_KW, n_kv_heads=2, d_ff=96, num_experts=4,
                          top_k=2)}[name]
    size = {"gpt2": "124m", "llama": "tiny", "mixtral": "tiny"}[name]
    jf = {"gpt2": gpt2_config, "llama": llama_config,
          "mixtral": mixtral_config}[name]
    tf = getattr(tmodels, f"{name}_config")
    return (jf(size, **kw, dtype=jnp.float32, remat=False),
            tf(size, **kw, dtype=torch.float32))


@pytest.fixture(scope="module", params=["gpt2", "llama", "mixtral"])
def family(request):
    jcfg, tcfg = _family_configs(request.param)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    return request.param, jcfg, jparams, tcfg, tparams


def test_family_forward_logits_and_aux_match_jax(family):
    name, jcfg, jparams, tcfg, tparams = family
    assert tcfg.num_params() == jcfg.num_params()
    tokens = np.random.default_rng(1).integers(0, 128, size=(2, 16))
    want, jaux = jtr.forward(jparams, jnp.asarray(tokens), jcfg)
    got, aux = ttr.forward(tparams, torch.from_numpy(tokens), tcfg)
    assert got.shape == (2, 16, 128) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=TOL, rtol=TOL)
    assert (aux.item() > 0) is (name == "mixtral")


def _grad_leaves(tparams):
    """A copy of the tree whose leaves require grad, and its leaf paths."""
    paths = [tuple(p.split("/")) for p, _ in _leaves(tparams)]
    params, leaves = {}, []
    for path in paths:
        node, src = params, tparams
        for key in path[:-1]:
            node, src = node.setdefault(key, {}), src[key]
        node[path[-1]] = src[path[-1]].detach().clone().requires_grad_()
        leaves.append(node[path[-1]])
    return params, paths, leaves


@pytest.mark.parametrize("fused_ce", [False, True])
def test_family_loss_and_grads_match_jax(family, fused_ce):
    """loss_fn (with the MoE aux term for mixtral) and every param's
    gradient against jax.value_and_grad, under the port's default remat."""
    name, jcfg, jparams, tcfg, tparams = family
    tokens = np.random.default_rng(2).integers(0, 128, size=(2, 17))
    want, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg, fused_ce=fused_ce, ce_chunk=16)
    params, paths, leaves = _grad_leaves(tparams)
    assert tcfg.remat
    loss = ttr.loss_fn(params, torch.from_numpy(tokens), tcfg,
                       fused_ce=fused_ce, ce_chunk=16)
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=TOL)
    grads = torch.autograd.grad(loss, leaves)
    jl = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    assert set(jl) == {"/".join(p) for p in paths}
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), jl["/".join(path)], atol=TOL,
                                   rtol=TOL, err_msg="/".join(path))
    if name == "mixtral":  # the aux term is in the loss the gradients see
        hidden_only = ttr.loss_fn(
            tparams, torch.from_numpy(tokens),
            dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, aux_coef=0.0)), fused_ce=fused_ce, ce_chunk=16)
        assert loss.item() - hidden_only.item() > 1e-4


@pytest.mark.parametrize("n", [5, 16, 29])
def test_family_prefill_logits_and_kv_match_jax(family, n):
    """prefill at a padded bucket: for mixtral the padding rows share the
    experts' capacity with the prompt in both packages."""
    name, jcfg, jparams, tcfg, tparams = family
    bucket = 16 if n <= 16 else 32
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = np.random.default_rng(n).integers(1, 127, size=n)
    jl, jkv = jdec.prefill(jparams, jnp.asarray(padded), jnp.int32(n), jcfg)
    tl, tkv = tdec.prefill(tparams, torch.from_numpy(padded).long(), n, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=TOL, rtol=TOL)


def test_family_decode_steps_match_jax(family):
    """Three ragged decode steps of one constructed mixed-length batch in
    both packages (the same rows, so a MoE layer routes the same batch),
    and the gather step agreeing with the ragged one."""
    name, jcfg, jparams, tcfg, tparams = family
    jstate, tstate = _mixed_states(jcfg, jparams, tcfg, tparams,
                                   [3, 17, 27, 9])
    for _ in range(3):
        jstate, jl = jdp.decode_step_paged_ragged(jparams, jstate, jcfg, 2)
        gather = {k: v.clone() for k, v in tstate.items()}
        tstate, tl = tdp.decode_step_paged_ragged(tparams, tstate, tcfg, 2)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        _, gl = tdp.decode_step_paged(tparams, gather, tcfg)
        np.testing.assert_allclose(gl.numpy(), tl.numpy(), atol=TOL,
                                   rtol=TOL)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
        jstate = jdec.commit_tokens(jstate, jnp.asarray(nxt))
        tdec.commit_tokens(tstate, torch.from_numpy(nxt))
    for key in ("kp", "vp"):
        np.testing.assert_allclose(tstate[key].numpy(), np.asarray(jstate[key]),
                                   atol=TOL, rtol=TOL)


def test_moe_tree_round_trips_through_params_from_jax(family):
    name, jcfg, jparams, tcfg, tparams = family
    jl = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert {k for k in jl if k.startswith("layers/mlp/")} == (
        {"layers/mlp/router", "layers/mlp/gate", "layers/mlp/up",
         "layers/mlp/down"} if name == "mixtral" else
        {f"layers/mlp/{k}" for k in ttr.param_shapes(tcfg)["layers"]["mlp"]})
    tl = dict(_leaves(tparams))
    assert set(tl) == set(jl)
    for key, arr in jl.items():
        assert np.array_equal(tl[key].numpy(), arr), key
    bad = jax.tree.map(np.asarray, jparams)
    bad["layers"]["mlp"].pop(next(iter(bad["layers"]["mlp"])))
    with pytest.raises(ValueError, match="layers/mlp"):
        convert.params_from_jax(bad, tcfg, "cpu")
