"""ray_tpu_torch's training path against ray_tpu's on the CPU: loss_fn and
its gradients, the remat policies, the train step against optax.adamw, and
adamw_int8, on tiny f32 configs with the JAX package's own weights."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jtr
from ray_tpu.train import optim as joptim
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.benchmarks import device_profile
from ray_tpu_torch.benchmarks import train_step as tbench
from ray_tpu_torch.models import convert, llama as tllama
from ray_tpu_torch.models import transformer as ttr
from ray_tpu_torch.ops import flash_attention as tflash

TOL = 2e-5  # f32 on both sides; matmul summation order differs

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)


def _pair(seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    jcfg = jtr.TransformerConfig(**{**TINY, **kw}, dtype=jnp.float32,
                                 remat=False)
    tcfg = ttr.TransformerConfig(**{**TINY, **kw}, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(seed), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tokens(seed, B=2, T=24):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                                 size=(B, T + 1))


def _loss_and_grads(tparams, tokens, tcfg, **kw):
    paths = list(_paths(tparams))
    leaves = [_get(tparams, p).detach().requires_grad_() for p in paths]
    params = {}
    for p, leaf in zip(paths, leaves):
        node = params
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = leaf
    loss = ttr.loss_fn(params, torch.from_numpy(tokens), tcfg, **kw)
    return loss, dict(zip(paths, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("fused_ce", [False, True])
def test_loss_and_grads_match_jax(tied, fused_ce):
    """loss_fn and every param's gradient against
    jax.value_and_grad(transformer.loss_fn); ce_chunk 16 pads the 48 rows
    of the fused path to 64 (tied embeddings turn fused CE off in both)."""
    jcfg, jparams, tcfg, tparams = _pair(tie_embeddings=tied)
    tokens = _tokens(1)
    want, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg, fused_ce=fused_ce, ce_chunk=16)
    loss, grads = _loss_and_grads(tparams, tokens, tcfg, fused_ce=fused_ce,
                                  ce_chunk=16)
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=TOL)
    assert set(grads) == set(_paths(jax.tree.map(np.asarray, jgrads)))
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(_get(jgrads, path)),
                                   atol=TOL, rtol=TOL, err_msg=str(path))


@pytest.mark.parametrize("policy", ["nothing", "dots", "pairs"])
def test_remat_policies_match_no_remat(policy):
    """Each remat policy, with attention through the FlashAttention autograd
    function (rerun in backward under checkpointing), gives remat=False's
    loss and gradients."""
    _, _, tcfg, tparams = _pair()
    tokens = _tokens(2)
    base, gbase = _loss_and_grads(tparams, tokens,
                                  dataclasses.replace(tcfg, remat=False),
                                  attn_impl="flash")
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    loss, grads = _loss_and_grads(tparams, tokens, cfg, attn_impl="flash")
    assert abs(loss.item() - base.item()) <= 1e-6
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), gbase[path].numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=str(path))


def test_remat_policy_checks():
    odd = ttr.TransformerConfig(**{**TINY, "n_layers": 3},
                                dtype=torch.float32, remat_policy="pairs")
    params = ttr.init(torch.Generator().manual_seed(0), odd, "cpu")
    with pytest.raises(ValueError, match="even n_layers"):
        ttr.loss_fn(params, torch.from_numpy(_tokens(3)), odd)
    with pytest.raises(ValueError, match="remat_policy"):
        ttr.TransformerConfig(remat_policy="everything")


def test_flash_dispatch_gives_gradients_through_an_opaque_forward(
        monkeypatch):
    """On the card the forward kernel fills O through ctypes, so O carries
    no autograd history of its own. With the forward made opaque the same
    way here, the dispatcher's FlashAttention function must still carry the
    gradient to wq/wk/wv/norm1, equal to the reference path's."""
    real = tflash._fwd_call

    def opaque(*args, **kwargs):
        o, lse = real(*args, **kwargs)
        return o.detach(), lse.detach()

    monkeypatch.setattr(tflash, "_fwd_call", opaque)
    _, _, tcfg, tparams = _pair()
    tokens = _tokens(4)
    _, want = _loss_and_grads(tparams, tokens, tcfg, attn_impl="reference")
    _, got = _loss_and_grads(tparams, tokens, tcfg, attn_impl="flash")
    for name in ("wq", "wk", "wv"):
        path = ("layers", "attn", name)
        assert got[path].abs().sum() > 0
        np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                                   atol=TOL, rtol=TOL)
    path = ("layers", "norm1", "w")
    np.testing.assert_allclose(got[path].numpy(), want[path].numpy(),
                               atol=TOL, rtol=TOL)


def test_train_step_matches_optax_adamw():
    """3 steps of make_train_step + adamw(1e-3, weight_decay=0.01) against 3
    steps of optax.adamw, built as bench.py builds its step."""
    jcfg, jparams, tcfg, tparams = _pair(seed=5)
    tokens = _tokens(6)
    opt = optax.adamw(1e-3, weight_decay=0.01)
    jstate = opt.init(jparams)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def jstep(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(jtr.loss_fn)(params, tokens, jcfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    topt = ttrain.adamw(tparams, 1e-3, weight_decay=0.01)
    tstep = ttrain.make_train_step(
        lambda p, b: ttr.loss_fn(p, b, tcfg), topt)
    tstate = topt.state
    for _ in range(3):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(tokens))
        tparams, tstate, tloss = tstep(tparams, tstate,
                                       torch.from_numpy(tokens))
        np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5,
                                   rtol=1e-5)
    # params within 1e-5 relative per leaf (in norm). Per element the floor
    # is 2 % of lr: Adam divides by sqrt(v), so for a gradient near zero the
    # two frameworks' last-ulp differences become steps of order lr
    for path in _paths(tparams):
        got = _get(tparams, path).detach().numpy()
        want = np.asarray(_get(jparams, path))
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), path
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5,
                                   err_msg=str(path))


def test_adamw_int8_matches_jax():
    """adamw_int8 against the JAX adamw_int8 over 3 steps on the same grads,
    with leaf sizes off the 256 block and a schedule for the rate."""
    rng = np.random.default_rng(7)
    shapes = {"a": (300,), "b": (17, 33), "c": {"d": (256,)}}

    def tree(f):
        return {k: tree_from(v, f) for k, v in shapes.items()}

    def tree_from(v, f):
        return {k: f(s) for k, s in v.items()} if isinstance(v, dict) \
            else f(v)

    p0 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(3)]

    def sched(count):
        return 1e-2 / (1 + count)

    jopt = joptim.adamw_int8(sched, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    topt = ttrain.adamw_int8(tparams, sched, weight_decay=0.01)
    for g in grads:
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        for path in _paths(tparams):
            _get(tparams, path).grad = torch.from_numpy(_get(g, path))
        topt.step()
    for path in _paths(tparams):
        np.testing.assert_allclose(_get(tparams, path).detach().numpy(),
                                   np.asarray(_get(jparams, path)), atol=1e-6,
                                   rtol=1e-6, err_msg=str(path))
    n = sum(int(np.prod(s)) for s in (300, (17, 33), 256))
    assert ttrain.optimizer_state_bytes(topt) < \
        ttrain.optimizer_state_bytes(ttrain.adamw(tparams, 1e-3)) + 8 * n
    q = topt.state[_get(tparams, ("a",))]
    assert q["m_q"].dtype == torch.int8 and q["m_q"].numel() == 512
    assert q["m_scale"].numel() == 2 and q["step"] == 3


def test_adamw_schedule_matches_optax_linear_schedule():
    """adamw with a schedule for the rate against optax.adamw with
    optax.linear_schedule over 5 steps on the same grads: every step's
    update within 2e-5, and the schedule read at the pre-step count."""
    rng = np.random.default_rng(11)
    shapes = {"a": (40,), "b": {"c": (6, 7)}}
    p0 = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                      shapes, is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), p0) for _ in range(5)]
    init, end, n = 1e-2, 1e-3, 4

    def sched(count):  # the port's side: plain Python, no jax
        return init + (end - init) * min(count, n) / n

    jopt = optax.adamw(optax.linear_schedule(init, end, n), weight_decay=0.1)
    jparams = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jparams)
    tparams = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    topt = ttrain.adamw(tparams, sched, weight_decay=0.1)
    for g in grads:
        before = {p: _get(tparams, p).detach().clone() for p in _paths(tparams)}
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                      jparams)
        jparams = optax.apply_updates(jparams, updates)
        for path in _paths(tparams):
            _get(tparams, path).grad = torch.from_numpy(_get(g, path))
        topt.step()
        for path in _paths(tparams):
            np.testing.assert_allclose(
                (_get(tparams, path).detach() - before[path]).numpy(),
                np.asarray(_get(updates, path)), atol=2e-5, rtol=0,
                err_msg=str(path))
    assert [g["schedule_count"] for g in topt.param_groups] == [5]
    assert topt.param_groups[0]["lr"] == pytest.approx(sched(4))


def test_single_device_only_and_measure_needs_the_card():
    """A meshed step needs a DeviceMesh over an initialised process group
    (the meshed steps' parity tests over gloo ranks are in
    test_torch_spmd.py)."""
    class Mesh:  # a DeviceMesh's surface, with no process group behind it
        mesh_dim_names = ("dp",)

        def get_group(self, name):
            raise AssertionError("no group to get")

    _, _, tcfg, tparams = _pair()
    opt = ttrain.adamw(tparams, 1e-3)
    with pytest.raises(RuntimeError, match="not initialised"):
        ttrain.make_train_step(lambda p, b: p, opt, mesh=Mesh(),
                               logical_axes={"a": ("embed",)})
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttrain.make_train_step(lambda p, b: p, opt, mesh=object())
    with pytest.raises(ValueError, match="CUDA"):
        tbench.measure(tcfg, batch=1, seq=8, device="cpu")


def test_llama_3_2_1b_config_and_flops():
    """The training slice's configuration has the published widths and the
    JAX package's param count; the MFU formulas are bench.py's."""
    cfg = tllama.llama_config("1b", tie_embeddings=True, max_seq_len=2048)
    assert (cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (2048, 16, 32, 8, 64, 8192, 128256)
    assert (cfg.remat, cfg.remat_policy) == (True, "nothing")
    jcfg = jtr.TransformerConfig(**{**tllama.SIZES["1b"],
                                    "vocab_size": 128256,
                                    "tie_embeddings": True})
    assert cfg.num_params() == jcfg.num_params() == 1_235_814_400
    six_n, with_attn = tbench.flops_per_token(cfg, 2048)
    assert six_n == 6 * 1_235_814_400
    assert with_attn - six_n == 6 * 16 * 2048 * 32 * 64


def test_profile_kinds_name_the_kernels_of_a_step():
    """The profile's kinds sort the kernels a training step launches."""
    kinds = {
        "void (anonymous namespace)::flash_bwd_dq_kernel<64>(...)":
            "attention (csrc)",
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NTT": "matmul",
        "void at::native::(anonymous namespace)::multi_tensor_apply_kernel"
        "<FusedAdamMathFunctor>": "optimizer",
        "void at::native::reduce_kernel<512, 1>(...)": "reduction",
        "void at::native::index_elementwise_kernel<128, 4>(...)": "index",
        "void at::native::vectorized_elementwise_kernel<4, ...>":
            "elementwise",
        "ampere_sgemm_128x64_nn": "matmul",
        "void some_other_kernel()": "other",
    }
    for name, kind in kinds.items():
        assert device_profile.kind_of(name) == kind, name


def _edges_into(loss, leaf) -> int:
    """How many autograd nodes feed a gradient into `leaf`."""
    seen, stack, n = set(), [loss.grad_fn], 0
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if nxt is not None:
                n += getattr(nxt, "variable", None) is leaf
                stack.append(nxt)
    return n


@pytest.mark.parametrize("remat", [False, True])
def test_each_stacked_leaf_takes_one_gradient_per_backward(remat):
    """forward takes the stacked [L, ...] leaves apart once (torch.unbind):
    each stacked leaf gets one gradient, one stack of its L slices, and one
    accumulation per backward; L indexing views would feed it L full-size
    gradients to add. Loss and gradients stay those of the JAX package."""
    jcfg, jparams, tcfg, tparams = _pair(n_layers=4)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    tokens = _tokens(4)
    paths = list(_paths(tparams))
    leaves = [_get(tparams, p).detach().requires_grad_() for p in paths]
    params = {}
    for p, leaf in zip(paths, leaves):
        node = params
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = leaf
    counts = [0] * len(leaves)
    for i, leaf in enumerate(leaves):
        leaf.register_post_accumulate_grad_hook(
            lambda _, i=i: counts.__setitem__(i, counts[i] + 1))
    loss = ttr.loss_fn(params, torch.from_numpy(tokens), tcfg)
    stacked = [i for i, p in enumerate(paths) if p[0] == "layers"]
    assert stacked and all(_edges_into(loss, leaves[i]) == 1 for i in stacked)
    loss.backward()
    assert counts == [1] * len(leaves)
    want, jgrads = jax.value_and_grad(jtr.loss_fn)(
        jparams, jnp.asarray(tokens), jcfg)
    np.testing.assert_allclose(loss.item(), float(want), atol=TOL, rtol=TOL)
    for path, leaf in zip(paths, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(),
                                   np.asarray(_get(jgrads, path)), atol=TOL,
                                   rtol=TOL, err_msg=str(path))
