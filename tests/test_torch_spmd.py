"""The port's meshed train steps over gloo ranks on the CPU against the JAX
package's on the virtual 8-device CPU mesh: ``make_train_step`` on a tiny
Llama at (dp 2, tp 2) and a tiny Mixtral at (dp 2, ep 2) (losses and
params after 2 AdamW steps), ``make_sp_pp_train_step`` against
tests/test_spmd.py's serial check, ``init_sharded``, ``logits_spec``
against the unsharded fused loss and its gradients, ``forward(sp_axis=)``
against the unsharded forward, and the ``logical_axes`` trees.

One world of 4 ranks runs every case once (a module fixture with its
timeout); the rank functions import torch only, and JAX is imported inside
the tests.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch import parallel, train
from ray_tpu_torch.models import convert, llama, mixtral, transformer
from ray_tpu_torch.parallel import MeshSpec, P, sharding_for, use_mesh

TOL = dict(atol=2e-5, rtol=2e-5)
N = 4
LLAMA = dict(vocab_size=256, max_seq_len=64, d_model=64, n_layers=2,
             n_heads=4, n_kv_heads=2, d_ff=128)
MIXTRAL = dict(vocab_size=128, max_seq_len=64, d_model=64, n_layers=2,
               n_heads=4, n_kv_heads=2, d_ff=96, num_experts=4, top_k=2)
STEPS, LR = 2, 1e-3
SPPP = dict(dp=1, pp=2, sp=2, E=32, H=4, Dh=8, F=64, V=128, B=4, Tg=64,
            n_micro=2)


def _tcfg(kind):
    if kind == "llama":
        return llama.llama_config("tiny", dtype=torch.float32, **LLAMA)
    return mixtral.mixtral_config("tiny", dtype=torch.float32, **MIXTRAL)


def _jcfg(kind):
    import jax.numpy as jnp

    from ray_tpu.models import llama_config, mixtral_config

    if kind == "llama":
        return llama_config("tiny", dtype=jnp.float32, **LLAMA)
    return mixtral_config("tiny", dtype=jnp.float32, **MIXTRAL)


def _loss_kw(kind):
    # the Llama runs the fused head + cross-entropy (vocab-sharded by tp:
    # logits_spec), the Mixtral the unfused loss over vocab-sharded logits
    return dict(fused_ce=True, ce_chunk=16) if kind == "llama" else {}


MESHES = {"llama": dict(dp=2, tp=2), "mixtral": dict(dp=2, ep=2)}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


# ------------------------------------------------------------ the ranks

def _meshed(kind, jparams, tokens):
    cfg = _tcfg(kind)
    mesh = MeshSpec(**MESHES[kind]).build()
    full = convert.params_from_jax(jparams, cfg, device="cpu")
    opt = functools.partial(train.adamw, learning_rate=LR)
    step, shard_params, batch_sharding = train.make_train_step(
        lambda p, b: transformer.loss_fn(p, b, cfg, **_loss_kw(kind)), opt,
        mesh=mesh, logical_axes=transformer.logical_axes(cfg))
    params = shard_params(full)
    state = opt(params)
    batch = batch_sharding.shard(torch.as_tensor(tokens))
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    specs = parallel.param_shardings(mesh, transformer.logical_axes(cfg))
    gathered = parallel.mesh.tree_map(lambda s, p: s.gather(p).numpy(),
                                      specs, params,
                                      is_leaf=lambda x: isinstance(
                                          x, parallel.NamedSharding))
    return {"losses": losses, "params": gathered,
            "local_wq": tuple(params["layers"]["attn"]["wq"].shape)}


def _sp_pp(sp_params, tokens):
    """tests/test_spmd.py's model through make_sp_pp_train_step, sgd(1.0)."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import (collectives, pipeline_apply,
                                        ring_attention)
    from ray_tpu_torch.train.optim import param_leaves

    c = SPPP
    L, E, pp = 2 * c["pp"], c["E"], c["pp"]
    mesh = MeshSpec(dp=c["dp"], pp=pp, sp=c["sp"]).build()
    staged = {k: torch.tensor(v) for k, v in sp_params.items()
              if k != "layers"}
    staged["layers"] = {k: torch.tensor(v).reshape(pp, L // pp, *v.shape[1:])
                        for k, v in sp_params["layers"].items()}
    specs = {"embed": P(), "head": P(),
             "layers": {k: P("pp") for k in staged["layers"]}}
    params = parallel.mesh.tree_map(
        lambda s, p: sharding_for(mesh, s).shard(p).requires_grad_(),
        specs, staged, is_leaf=lambda x: isinstance(x, parallel.P))
    before = _np_tree(params)

    def stage_fn(stage_p, h):
        for i in range(L // pp):
            lp = {k: v[0, i] for k, v in stage_p.items()}
            hn = ops.rms_norm(h, lp["nw"])
            q = torch.einsum("bte,ehd->bthd", hn, lp["wq"])
            a = ring_attention(q, q, q, axis_name="sp", causal=True)
            h = h + torch.einsum("bthd,hde->bte", a, lp["wo"])
            hn = ops.rms_norm(h, lp["nw"])
            h = h + ops.gelu(hn @ lp["wi"]) @ lp["wmo"]
        return h

    def shard_loss(p, toks):
        x = p["embed"][toks]
        Bl, Tl = toks.shape
        mb = Bl // c["n_micro"]
        y = pipeline_apply(stage_fn, p["layers"],
                           x.reshape(c["n_micro"], mb, Tl, E),
                           axis_name="pp").reshape(Bl, Tl, E)
        logits_g = collectives.allgather(y @ p["head"], "sp", axis=1)
        toks_g = collectives.allgather(toks, "sp", axis=1)
        loss, _ = ops.softmax_cross_entropy(logits_g,
                                            torch.roll(toks_g, -1, dims=1))
        return loss

    opt = torch.optim.SGD(param_leaves(params), lr=1.0)
    step = train.make_sp_pp_train_step(
        shard_loss, specs, mesh, opt, batch_spec=P("dp", "sp"),
        loss_axes=("dp", "sp", "pp"))
    batch = sharding_for(mesh, P("dp", "sp")).shard(torch.as_tensor(tokens))
    params, _, loss = step(params, opt, batch)
    grads = parallel.mesh.tree_map(lambda b, a: b - a.detach().numpy(),
                                   before, params)
    return {"loss": float(loss), "grads": grads,
            "stage": parallel.mesh.axis_rank(mesh, "pp")}


def _init_sharded_case():
    from ray_tpu_torch.train.spmd import init_sharded

    cfg = _tcfg("llama")
    mesh = MeshSpec(dp=2, tp=2).build()

    def init():
        return transformer.init(torch.Generator().manual_seed(3), cfg, "cpu")

    local = init_sharded(init, transformer.logical_axes(cfg), mesh)
    full = init()
    specs = parallel.param_shardings(mesh, transformer.logical_axes(cfg))
    same = parallel.mesh.tree_map(
        lambda s, l, f: bool(torch.equal(s.shard(f), l)), specs, local, full,
        is_leaf=lambda x: isinstance(x, parallel.NamedSharding))
    rules = [("embed", P(None, "tp")), (".*", P())]
    by_rules = init_sharded(init, None, mesh, partition_rules=rules)
    return {"same": same, "wq": tuple(local["layers"]["attn"]["wq"].shape),
            "embed_rules": tuple(by_rules["embed"].shape),
            "wq_rules": tuple(by_rules["layers"]["attn"]["wq"].shape)}


def _logits_spec_case(h_np, w_np, labels_np):
    """fused_head_cross_entropy with the vocab over tp = 4: each rank holds
    its [E, V/4] slice; the hidden grad is summed over tp (it is
    replicated there), the head grad stays a slice."""
    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import collectives

    mesh = MeshSpec(tp=N).build()
    with use_mesh(mesh):
        r = collectives.axis_index("tp")
        V_loc = w_np.shape[1] // N
        h = torch.tensor(h_np, requires_grad=True)
        w = torch.tensor(w_np[:, r * V_loc:(r + 1) * V_loc],
                         requires_grad=True)
        loss, n_valid = ops.fused_head_cross_entropy(
            h, w, torch.as_tensor(labels_np), z_loss=1e-3, chunk=8,
            logits_spec=P(None, "tp"))
        (loss / N).backward()
        gh = collectives.allreduce(h.grad, "tp")
    return {"loss": float(loss), "n_valid": float(n_valid),
            "gh": gh.numpy(), "gw": w.grad.numpy()}


def _backward_on_another_thread(jparams, tokens):
    """A CUDA backward runs on autograd's device thread, where the
    forward's ``use_mesh`` is not current: the remat recompute and the
    fused loss's checkpoints must carry the mesh there. The CPU backward
    runs on the calling thread, so a thread stands in for it here."""
    import threading

    cfg = _tcfg("llama")
    mesh = MeshSpec(dp=2, tp=2).build()
    specs = parallel.param_shardings(mesh, transformer.logical_axes(cfg))
    full = convert.params_from_jax(jparams, cfg, device="cpu")
    grads = []
    for threaded in (False, True):
        params = parallel.mesh.tree_map(
            lambda sh, p: sh.shard(p).requires_grad_(), specs, full,
            is_leaf=lambda x: isinstance(x, parallel.NamedSharding))
        batch = sharding_for(mesh, P(("dp", "fsdp"))).shard(
            torch.as_tensor(tokens))
        with use_mesh(mesh):
            loss = transformer.loss_fn(params, batch, cfg, fused_ce=True,
                                       ce_chunk=16)
        if threaded:
            errors = []

            def run():
                try:
                    loss.backward()
                except Exception as e:  # reported below
                    errors.append(repr(e))

            t = threading.Thread(target=run)
            t.start()
            t.join()
            if errors:
                return {"error": errors[0]}
        else:
            loss.backward()
        grads.append([p.grad.clone() for p in train.param_leaves(params)])
    return {"same": all(torch.equal(a, b) for a, b in zip(*grads))}


# transformer.forward(sp_axis=) on 4 sequence shards: rope (the Llama) and
# learned positions (a GPT-2-style stack with biases and layer norm)
SP_CFGS = {"rope": dict(LLAMA),
           "learned": dict(LLAMA, norm="ln", act="gelu", pos="learned",
                           bias=True)}


def _sp_forward(jparams_by_pos, tokens):
    from ray_tpu_torch.parallel import collectives

    mesh = MeshSpec(sp=N).build()
    out = {}
    with use_mesh(mesh):
        T = tokens.shape[1] // N
        r = collectives.axis_index("sp")
        for pos, jparams in jparams_by_pos.items():
            cfg = transformer.TransformerConfig(**SP_CFGS[pos],
                                                dtype=torch.float32)
            params = convert.params_from_jax(jparams, cfg, device="cpu")
            logits, _ = transformer.forward(
                params, torch.as_tensor(tokens[:, r * T:(r + 1) * T]), cfg,
                sp_axis="sp")
            out[pos] = logits.numpy()
    return out


def _world_rank(inp):
    out = {kind: _meshed(kind, inp[kind]["params"], inp[kind]["tokens"])
           for kind in MESHES}
    out["threaded"] = _backward_on_another_thread(inp["llama"]["params"],
                                                  inp["llama"]["tokens"])
    out["sp_pp"] = _sp_pp(inp["sp_pp"]["params"], inp["sp_pp"]["tokens"])
    out["sp_forward"] = _sp_forward(inp["sp_forward"]["params"],
                                    inp["sp_forward"]["tokens"])
    out["init_sharded"] = _init_sharded_case()
    out["logits_spec"] = _logits_spec_case(*inp["logits_spec"])
    return out


def _sp_pp_params():
    rng = np.random.default_rng(1)
    c = SPPP
    L, E, H, Dh, F, V = 2 * c["pp"], c["E"], c["H"], c["Dh"], c["F"], c["V"]
    f = lambda *s: (rng.standard_normal(s) * 0.02).astype(np.float32)  # noqa: E731
    return {"embed": f(V, E),
            "layers": {"wq": f(L, E, H, Dh), "wo": f(L, H, Dh, E),
                       "wi": f(L, E, F), "wmo": f(L, F, E),
                       "nw": np.ones((L, E), np.float32)},
            "head": f(E, V)}


def _inputs():
    import jax

    from ray_tpu.models import transformer as jtr

    inp = {}
    for i, kind in enumerate(MESHES):
        cfg = _jcfg(kind)
        params = jax.tree.map(np.asarray, jtr.init(jax.random.PRNGKey(i), cfg))
        tokens = np.random.default_rng(i).integers(
            0, cfg.vocab_size, size=(4, 17)).astype(np.int32)
        inp[kind] = {"params": params, "tokens": tokens}
    inp["sp_pp"] = {"params": _sp_pp_params(),
                    "tokens": np.random.default_rng(2).integers(
                        0, SPPP["V"], size=(SPPP["B"], SPPP["Tg"])
                    ).astype(np.int32)}
    inp["sp_forward"] = {
        "params": {pos: jax.tree.map(np.asarray, jtr.init(
            jax.random.PRNGKey(7), _jsp_cfg(pos))) for pos in SP_CFGS},
        "tokens": np.random.default_rng(4).integers(
            0, LLAMA["vocab_size"], size=(2, 32)).astype(np.int32)}
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 64, size=20).astype(np.int64)
    labels[[2, 7, 11]] = -100
    inp["logits_spec"] = (rng.standard_normal((20, 16)).astype(np.float32),
                          (rng.standard_normal((16, 64)) * 0.3).astype(
                              np.float32), labels)
    return inp


def _jsp_cfg(pos):
    import jax.numpy as jnp

    from ray_tpu.models.transformer import TransformerConfig

    return TransformerConfig(**SP_CFGS[pos], dtype=jnp.float32, remat=False)


@pytest.fixture(scope="module")
def world():
    inp = _inputs()
    return inp, parallel.launch(_world_rank, N, args=(inp,), backend="gloo",
                                device="cpu", timeout=120)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("kind", list(MESHES))
def test_make_train_step_against_jax_meshed_step(world, kind):
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import transformer as jtr
    from ray_tpu.parallel import MeshSpec as JMesh
    from ray_tpu.train.spmd import make_train_step as jmake

    inp, res = world
    cfg = _jcfg(kind)
    mesh = JMesh(**MESHES[kind]).build(jax.devices()[:N])
    step, shard, batch_sharding = jmake(
        lambda p, b: jtr.loss_fn(p, b, cfg, **_loss_kw(kind)),
        jtr.logical_axes(cfg), mesh, optax.adamw(LR), donate=False)
    params = shard(jax.tree.map(jnp.asarray, inp[kind]["params"]))
    state = jax.jit(optax.adamw(LR).init)(params)
    batch = jax.device_put(jnp.asarray(inp[kind]["tokens"]), batch_sharding)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    want = jax.tree.map(np.asarray, params)
    for r in res:
        np.testing.assert_allclose(r[kind]["losses"], losses, **TOL)
        got = r[kind]["params"]
        for path, w in _leaves(want):
            np.testing.assert_allclose(_get(got, path), w, **TOL,
                                       err_msg="/".join(path))
    if kind == "llama":  # tp really split the heads
        assert res[0]["llama"]["local_wq"] == (2, 64, 2, 16)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_sp_pp_train_step_matches_serial(world):
    """Twin of tests/test_spmd.py::test_pp_sp_train_step_matches_serial at
    (dp 1, pp 2, sp 2): loss and the grads of embed, head and wq."""
    import jax
    import jax.numpy as jnp

    from ray_tpu import ops as jops
    from ray_tpu.parallel.ring_attention import reference_attention

    inp, res = world
    params = jax.tree.map(jnp.asarray, inp["sp_pp"]["params"])
    tokens = jnp.asarray(inp["sp_pp"]["tokens"])

    def serial_loss(p):
        x = p["embed"][tokens]

        def one_layer(h, lp):
            hn = jops.rms_norm(h, lp["nw"])
            q = jnp.einsum("bte,ehd->bthd", hn, lp["wq"])
            a = reference_attention(q, q, q, causal=True)
            h = h + jnp.einsum("bthd,hde->bte", a, lp["wo"])
            hn = jops.rms_norm(h, lp["nw"])
            return h + jax.nn.gelu(hn @ lp["wi"]) @ lp["wmo"], None

        x, _ = jax.lax.scan(one_layer, x, p["layers"])
        loss, _ = jops.softmax_cross_entropy(x @ p["head"],
                                             jnp.roll(tokens, -1, axis=1))
        return loss

    loss, grads = jax.value_and_grad(serial_loss)(params)
    L = 2 * SPPP["pp"]
    per = L // SPPP["pp"]
    for r in res:
        got = r["sp_pp"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for name in ("embed", "head"):
            np.testing.assert_allclose(got["grads"][name],
                                       np.asarray(grads[name]), atol=1e-5,
                                       rtol=1e-4)
        s = got["stage"]
        np.testing.assert_allclose(
            got["grads"]["layers"]["wq"][0],
            np.asarray(grads["layers"]["wq"])[s * per:(s + 1) * per],
            atol=1e-5, rtol=1e-4)


def test_init_sharded_keeps_each_ranks_shard_of_the_full_init(world):
    _, res = world
    for r in res:
        got = r["init_sharded"]
        assert all(v for _, v in _leaves(got["same"]))
        assert got["wq"] == (2, 64, 2, 16)          # heads over tp = 2
        assert got["embed_rules"] == (256, 32)      # the rule's P(None, tp)
        assert got["wq_rules"] == (2, 64, 4, 16)    # ".*" → replicated


def test_logits_spec_against_unsharded_fused_loss(world):
    import jax
    import jax.numpy as jnp

    from ray_tpu import ops as jops

    inp, res = world
    h, w, labels = inp["logits_spec"]

    def loss(h, w):
        return jops.fused_head_cross_entropy(
            h, w, jnp.asarray(labels), z_loss=1e-3, chunk=8)[0]

    want, (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    got_w = np.concatenate([r["logits_spec"]["gw"] for r in res], axis=1)
    for r in res:
        got = r["logits_spec"]
        np.testing.assert_allclose(got["loss"], float(want), **TOL)
        assert got["n_valid"] == 17.0
        np.testing.assert_allclose(got["gh"], np.asarray(gh), **TOL)
    np.testing.assert_allclose(got_w, np.asarray(gw), **TOL)


def test_backward_on_another_thread_recomputes_under_the_mesh(world):
    _, res = world
    for r in res:
        assert r["threaded"] == {"same": True}


@pytest.mark.parametrize("pos", list(SP_CFGS))
def test_forward_sp_axis_matches_the_unsharded_jax_forward(world, pos):
    """forward(sp_axis="sp") on 4 sequence shards (ring attention, positions
    offset by the shard's start) against the JAX forward of the whole
    sequence."""
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtr

    inp, res = world
    sp = inp["sp_forward"]
    want, _ = jtr.forward(jax_tree(sp["params"][pos]),
                          jnp.asarray(sp["tokens"]), _jsp_cfg(pos))
    got = np.concatenate([r["sp_forward"][pos] for r in res], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def jax_tree(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name", ["llama", "mixtral", "gpt2", "vit"])
def test_logical_axes_match_the_jax_package(name):
    from ray_tpu.models import gpt2_config as jgpt2
    from ray_tpu.models import transformer as jtr
    from ray_tpu.models import vit as jvit
    from ray_tpu_torch.models import gpt2, vit

    if name == "vit":
        got = vit.logical_axes(vit.vit_config("s16"))
        want = jvit.logical_axes(jvit.vit_config("s16"))
    elif name == "gpt2":
        got = transformer.logical_axes(gpt2.gpt2_config("124m"))
        want = jtr.logical_axes(jgpt2("124m"))
    else:
        got = transformer.logical_axes(_tcfg(name))
        want = jtr.logical_axes(_jcfg(name))
    assert got == want
