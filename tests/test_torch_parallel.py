"""ray_tpu_torch.parallel over gloo ranks on the CPU against
ray_tpu.parallel under shard_map on the virtual 8-device CPU mesh: the
mesh, every collective (value and gradient), ring attention, the GPipe
pipeline and the fsdp shard round trip.

The ranks are spawned processes (``parallel.launch``) that import torch
only: the rank functions live here, and this module imports JAX inside
the tests, never at the top. Each world runs once per module (a fixture)
and carries its timeout, so a hung collective fails the tests in seconds.
Gradients: a rank seeds a replicated output with 1/n of the cotangent and
a sharded output with its slice (parallel/collectives.py's convention),
which makes the assembled gradient the JAX function's.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import parallel
from ray_tpu_torch.parallel import MeshSpec, collectives, use_mesh

TOL = dict(atol=2e-5, rtol=2e-5)
N = 4                       # ranks of the world
RING = dict(B=2, T=64, H=4, D=16)
PIPE = dict(L=4, n_micro=4, mb=2, dim=8)


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    B, T, H, D = RING.values()
    L, nm, mb, dim = PIPE.values()
    return {
        "x": f(4 * N, 3), "w_full": f(4, 3), "w_gather": f(4 * N, 3),
        "w_scatter": f(N, 3), "w_shard": f(4 * N, 3), "w_a2a": f(N, 3 * N),
        "q": f(B, T, H, D), "k": f(B, T, H, D), "v": f(B, T, H, D),
        "w_ring": f(B, T, H, D),
        "Ws": f(L, dim, dim) * 0.3, "bs": f(L, dim) * 0.1,
        "xp": f(nm, mb, dim), "w_pipe": f(nm, mb, dim),
    }


# ------------------------------------------------------------ the ranks

def _collective_cases(inp, r):
    """(name, fn, cotangent for this rank) for every collective over dp."""
    n = N
    sl = slice(r * 4, (r + 1) * 4)
    return [
        ("allreduce", lambda x: collectives.allreduce(x, "dp"),
         inp["w_full"] / n),
        ("allreduce_mean", lambda x: collectives.allreduce_mean(x, "dp"),
         inp["w_full"] / n),
        ("allgather", lambda x: collectives.allgather(x, "dp", axis=0),
         inp["w_gather"] / n),
        ("reducescatter",
         lambda x: collectives.reducescatter(x, "dp", scatter_dimension=0),
         inp["w_scatter"][r:r + 1]),
        ("broadcast", lambda x: collectives.broadcast(x, "dp", root=2),
         inp["w_full"] / n),
        ("ring_permute", lambda x: collectives.ring_permute(x, "dp", shift=1),
         inp["w_shard"][sl]),
        ("all_to_all", lambda x: collectives.all_to_all(
            x, "dp", split_axis=0, concat_axis=1), inp["w_a2a"][r:r + 1]),
    ]


def _world_rank(inp):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import hybrid_mesh, param_shardings

    r = dist.get_rank()
    out = {"auto": MeshSpec.auto(tp=2, sp=2).shape}
    mesh = MeshSpec.auto(tp=2, sp=2).build()
    out["mesh_shape"] = tuple(mesh.mesh.shape)
    out["mesh_names"] = tuple(mesh.mesh_dim_names)
    hy = hybrid_mesh(dcn_dp=2, tp=2, ranks_per_node=2)
    out["hybrid"] = hy.mesh.numpy()

    # every collective, value and gradient
    dpm = MeshSpec(dp=N).build()
    with use_mesh(dpm):
        out["axis"] = (collectives.axis_index("dp"),
                       collectives.axis_size("dp"))
        for name, fn, cot in _collective_cases(inp, r):
            x = torch.tensor(inp["x"][r * 4:(r + 1) * 4], requires_grad=True)
            y = fn(x)
            g, = torch.autograd.grad((y * torch.tensor(cot)).sum(), x)
            out[name] = (y.detach().numpy(), g.numpy())

    # ring attention over sp = 4, causal and full, with its gradient
    spm = MeshSpec(sp=N).build()
    T_loc = RING["T"] // N
    ts = slice(r * T_loc, (r + 1) * T_loc)
    with use_mesh(spm):
        for causal in (True, False):
            q, k, v = (torch.tensor(inp[n][:, ts], requires_grad=True)
                       for n in ("q", "k", "v"))
            o = parallel.ring_attention(q, k, v, axis_name="sp",
                                        causal=causal)
            gs = torch.autograd.grad(
                (o * torch.tensor(inp["w_ring"][:, ts])).sum(), (q, k, v))
            out[f"ring_{causal}"] = (o.detach().numpy(),
                                     [g.numpy() for g in gs])

    # GPipe at pp = 4 and pp = 2 (two dp replicas), value and gradient
    for label, spec in (("pp4", MeshSpec(pp=4)), ("pp2", MeshSpec(dp=2, pp=2))):
        pm = spec.build()
        with use_mesh(pm):
            pp, stage = (collectives.axis_size("pp"),
                         collectives.axis_index("pp"))
            staged = parallel.stack_stage_params(
                {"W": torch.tensor(inp["Ws"]), "b": torch.tensor(inp["bs"])},
                pp)
            W = staged["W"][stage:stage + 1].clone().requires_grad_()
            b = staged["b"][stage:stage + 1].clone().requires_grad_()

            def stage_fn(p, h):
                for i in range(p["W"].shape[1]):
                    h = torch.tanh(h @ p["W"][0, i] + p["b"][0, i])
                return h

            y = parallel.pipeline_apply(stage_fn, {"W": W, "b": b},
                                        torch.tensor(inp["xp"]),
                                        axis_name="pp")
            n_rep = N  # every rank holds a copy of the replicated output
            gW, gb = torch.autograd.grad(
                (y * torch.tensor(inp["w_pipe"]) / n_rep).sum(), (W, b))
            # the stage grads summed over the dp replicas, as a train step
            if spec.dp > 1:
                gW = collectives.allreduce(gW, "dp")
                gb = collectives.allreduce(gb, "dp")
            out[label] = (y.detach().numpy(), stage, gW.numpy(), gb.numpy())

    # fsdp shard round trip
    fm = MeshSpec(dp=2, fsdp=2).build()
    sh = param_shardings(fm, {"w": ("embed", "mlp"), "b": ("mlp",)})
    w = torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32)
    local = sh["w"].shard(w)
    out["fsdp"] = (tuple(sh["w"].spec), tuple(local.shape),
                   bool(torch.equal(sh["w"].gather(local), w)),
                   float(local.sum()))
    return out


@pytest.fixture(scope="module")
def world():
    inp = _inputs()
    return inp, parallel.launch(_world_rank, N, args=(inp,), backend="gloo",
                                device="cpu", timeout=90)


# ------------------------------------------------------------ the tests

def test_mesh_spec_shape_auto_build(world):
    inp, res = world
    spec = MeshSpec.auto(8, tp=2, sp=2)
    assert spec.dp == 2 and spec.size() == 8
    assert spec.shape == (2, 1, 1, 1, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        MeshSpec.auto(6, tp=4)
    for r in res:
        assert r["auto"] == (1, 1, 1, 1, 2, 2)
        assert r["mesh_shape"] == (1, 1, 1, 1, 2, 2)
        assert r["mesh_names"] == ("dp", "fsdp", "ep", "pp", "sp", "tp")
    assert [r["axis"] for r in res] == [(i, N) for i in range(N)]


def test_hybrid_mesh_dp_leads_over_node_major_ranks(world):
    _, res = world
    for r in res:
        # 2 nodes x 2 ranks, tp inside a node: dp = dcn_dp x 1 leads
        assert r["hybrid"].shape == (2, 1, 1, 1, 1, 2)
        assert r["hybrid"].reshape(2, 2).tolist() == [[0, 1], [2, 3]]


@pytest.fixture(scope="module")
def jax_collectives(world):
    return _jax_collectives(world[0])


def _jax_collectives(inp):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import MeshSpec as JMesh
    from ray_tpu.parallel import collectives as jc
    from ray_tpu.parallel import shard_map

    mesh = JMesh(dp=N).build(jax.devices()[:N])
    JP = jax.sharding.PartitionSpec
    cases = {
        "allreduce": (lambda x: jc.allreduce(x, "dp"), JP(), "w_full"),
        "allreduce_mean": (lambda x: jc.allreduce_mean(x, "dp"), JP(),
                           "w_full"),
        "allgather": (lambda x: jc.allgather(x, "dp", axis=0), JP(),
                      "w_gather"),
        "reducescatter": (lambda x: jc.reducescatter(x, "dp"), JP("dp"),
                          "w_scatter"),
        "broadcast": (lambda x: jc.broadcast(x, "dp", root=2), JP(),
                      "w_full"),
        "ring_permute": (lambda x: jc.ring_permute(x, "dp", shift=1),
                         JP("dp"), "w_shard"),
        "all_to_all": (lambda x: jc.all_to_all(x, "dp", split_axis=0,
                                               concat_axis=1),
                       JP("dp"), "w_a2a"),
    }
    out = {}
    for name, (fn, spec, w) in cases.items():
        f = shard_map(fn, mesh=mesh, in_specs=JP("dp"), out_specs=spec,
                      check_vma=False)
        x = jnp.asarray(inp["x"])
        y = f(x)
        g = jax.grad(lambda x: (f(x) * inp[w]).sum())(x)
        out[name] = (np.asarray(y), np.asarray(g), spec == JP())
    return out


@pytest.mark.parametrize("name", ["allreduce", "allreduce_mean", "allgather",
                                  "reducescatter", "broadcast",
                                  "ring_permute", "all_to_all"])
def test_collective_value_and_gradient(world, jax_collectives, name):
    inp, res = world
    want_y, want_g, replicated = jax_collectives[name]
    ys = [r[name][0] for r in res]
    if replicated:
        for y in ys:
            np.testing.assert_allclose(y, want_y, **TOL)
    else:
        np.testing.assert_allclose(np.concatenate(ys), want_y, **TOL)
    np.testing.assert_allclose(np.concatenate([r[name][1] for r in res]),
                               want_g, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_against_jax(world, causal):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import MeshSpec as JMesh
    from ray_tpu.parallel import ring_attention as jring
    from ray_tpu.parallel import shard_map

    inp, res = world
    mesh = JMesh(sp=N).build(jax.devices()[:N])
    spec = jax.sharding.PartitionSpec(None, "sp", None, None)
    ring = jax.jit(shard_map(
        lambda q, k, v: jring(q, k, v, axis_name="sp", causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec))
    q, k, v = (jnp.asarray(inp[n]) for n in ("q", "k", "v"))
    want = np.asarray(ring(q, k, v))
    grads = jax.grad(lambda q, k, v: (ring(q, k, v) * inp["w_ring"]).sum(),
                     argnums=(0, 1, 2))(q, k, v)
    got = np.concatenate([r[f"ring_{causal}"][0] for r in res], axis=1)
    np.testing.assert_allclose(got, want, **TOL)
    for i, g in enumerate(grads):
        got_g = np.concatenate([r[f"ring_{causal}"][1][i] for r in res],
                               axis=1)
        np.testing.assert_allclose(got_g, np.asarray(g), **TOL)


@pytest.mark.parametrize("label", ["pp4", "pp2"])
def test_pipeline_matches_serial(world, label):
    import jax
    import jax.numpy as jnp

    inp, res = world
    Ws, bs = jnp.asarray(inp["Ws"]), jnp.asarray(inp["bs"])

    def serial(Ws, bs):
        def layer(h, Wb):
            return jnp.tanh(h @ Wb[0] + Wb[1]), None

        return jax.vmap(lambda h: jax.lax.scan(layer, h, (Ws, bs))[0])(
            jnp.asarray(inp["xp"]))

    want = np.asarray(serial(Ws, bs))
    gW, gb = jax.grad(lambda W, b: (serial(W, b) * inp["w_pipe"]).sum(),
                      argnums=(0, 1))(Ws, bs)
    pp = 4 if label == "pp4" else 2
    per = PIPE["L"] // pp
    for r in res:
        y, stage, got_W, got_b = r[label]
        np.testing.assert_allclose(y, want, **TOL)
        np.testing.assert_allclose(got_W[0], np.asarray(gW)[stage * per:
                                                             (stage + 1) * per],
                                   **TOL)
        np.testing.assert_allclose(got_b[0], np.asarray(gb)[stage * per:
                                                             (stage + 1) * per],
                                   **TOL)


def test_fsdp_param_sharding_roundtrip(world):
    _, res = world
    full = np.arange(16 * 32, dtype=np.float32).reshape(16, 32)
    sums = []
    for r in res:
        spec, shape, round_trip, s = r["fsdp"]
        assert spec == ("fsdp", "tp") and shape == (8, 32) and round_trip
        sums.append(s)
    # dp replicas hold the same half; the two fsdp halves make the whole
    assert sums[0] == sums[2] and sums[1] == sums[3]
    assert sums[0] + sums[1] == float(full.sum())


def test_unbound_axis_and_mesh_order_raise():
    with pytest.raises(NameError, match="no mesh in use"):
        collectives.allreduce(torch.ones(2), "dp")
    with pytest.raises(RuntimeError, match="process group is initialised"):
        MeshSpec(dp=2).build()
    assert collectives.pvary(x := torch.ones(2), ("dp",)) is x
    z = collectives.zeros_varying_like((2, 3), torch.float32, x)
    assert z.shape == (2, 3) and not z.any()


def _hang(_):
    import torch.distributed as dist

    if dist.get_rank() == 0:  # rank 0 never joins the allreduce
        import time
        time.sleep(60)
    dist.all_reduce(torch.ones(1))


def test_launch_times_out_a_hung_collective():
    with pytest.raises(TimeoutError, match="deadlocked"):
        parallel.launch(_hang, 2, args=(None,), backend="gloo",
                        device="cpu", timeout=5)


def _raise(_):
    raise ValueError("boom in a rank")


def test_launch_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="boom in a rank"):
        parallel.launch(_raise, 2, args=(None,), backend="gloo",
                        device="cpu", timeout=30)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host "
                    "with no GPU")
@pytest.mark.parametrize("call", ["launch", "dryrun", "mesh_devices"])
def test_entry_points_need_the_card_unless_the_cpu_is_named(call):
    """device None means the GPU: with none visible the world's entry
    points raise before they spawn a rank, as resolve_device does."""
    from ray_tpu_torch.parallel import dryrun

    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "launch":
            parallel.launch(_raise, 2, args=(None,), timeout=5)
        elif call == "dryrun":
            dryrun.dryrun_multichip(2, timeout=5)
        else:
            parallel.local_mesh_devices("cuda")


def test_launch_refuses_nccl_on_the_cpu_and_unknown_names():
    with pytest.raises(ValueError, match="nccl"):
        parallel.launch(_raise, 2, args=(None,), backend="nccl",
                        device="cpu", timeout=5)
    with pytest.raises(ValueError, match="backend"):
        parallel.launch(_raise, 2, args=(None,), backend="mpi",
                        device="cpu", timeout=5)
    assert parallel.local_mesh_devices("cpu") == [torch.device("cpu")]


def test_constrain_returns_the_local_tensor_and_checks_its_dims():
    mesh = MeshSpec(dp=2)  # mesh_shape reads a MeshSpec as a mesh
    x = torch.zeros(4, 8)
    assert parallel.constrain(x, mesh, "batch", None) is x
    with pytest.raises(ValueError, match="no dim"):
        parallel.constrain(torch.zeros(4), mesh, None, "batch")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    """parallel/dryrun.py, the twin of __graft_entry__.dryrun_multichip:
    the gspmd Mixtral step, the pp x sp step and the tp decode, every rank
    finite and agreeing."""
    from ray_tpu_torch.parallel import dryrun

    res = dryrun.dryrun_multichip(n, device="cpu", backend="gloo",
                                  timeout=90)
    ep, tp, _ = dryrun.factor_mesh(n)
    assert res[0]["gspmd"]["mesh"] == {"dp": n // (ep * tp), "ep": ep,
                                       "tp": tp}
    for r in res:
        assert np.isfinite(r["gspmd"]["loss"])
        assert r["gspmd"]["loss"] == res[0]["gspmd"]["loss"]
        assert r["manual"]["loss"] == res[0]["manual"]["loss"]
        assert r["serving"]["tokens"] == res[0]["serving"]["tokens"]
        assert len(r["serving"]["tokens"]) == 4
