"""Multi-rank dry run, the twin of ``__graft_entry__.dryrun_multichip``.

    from ray_tpu_torch.parallel import dryrun
    dryrun.dryrun_multichip(4)                           # nccl, 4 GPUs
    dryrun.dryrun_multichip(4, backend="gloo")           # ranks share cards
    dryrun.dryrun_multichip(4, device="cpu")             # gloo on the CPU

Three programs in one world of n ranks (n = 2 or 4) on the device that
``launch`` resolves (None: the GPU, raising when none is visible):

1. "gspmd": a tiny Mixtral through the meshed ``make_train_step`` over
   dp x ep x tp (factors of n: ep and tp take a 2 each when they can), one
   AdamW step from ``init_sharded`` params; the loss must be finite.
2. "manual": a dense stack through ``make_sp_pp_train_step`` over
   dp x pp x sp, GPipe over pp and ring attention over sp, one SGD step.
3. "serving": ``LLMEngine(mesh=tp n)`` decodes 4 tokens of a tiny Llama.

Returns each rank's results; raises if a program fails on any rank.
"""

from __future__ import annotations


def factor_mesh(n: int) -> tuple[int, int, int]:
    """Split n ranks into (a, b, rest): a and b take one factor of 2 each
    if available, the remainder goes to the third (gspmd: ep, tp, dp;
    manual: pp, sp, dp)."""
    factors = []
    for _ in range(2):
        if n % 2 == 0:
            factors.append(2)
            n //= 2
        else:
            factors.append(1)
    return factors[0], factors[1], n


def _device(kind: str):
    import torch
    import torch.distributed as dist

    if kind == "cuda":
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def _gspmd(dev) -> dict:
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import mixtral, transformer
    from ray_tpu_torch.parallel import MeshSpec
    from ray_tpu_torch.train.spmd import init_sharded, make_train_step

    import torch.distributed as dist

    ep, tp, dp = factor_mesh(dist.get_world_size())
    cfg = mixtral.mixtral_config(
        "tiny", vocab_size=512, max_seq_len=128, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256, num_experts=max(ep * 2, 2),
        top_k=2, dtype=torch.float32)
    mesh = MeshSpec(dp=dp, ep=ep, tp=tp).build()
    axes = transformer.logical_axes(cfg)
    opt = functools.partial(train.adamw, learning_rate=1e-3)
    step, _shard, batch_sharding = make_train_step(
        lambda p, b: transformer.loss_fn(p, b, cfg), opt, mesh=mesh,
        logical_axes=axes)
    params = init_sharded(lambda: transformer.init(
        torch.Generator(device=dev).manual_seed(0), cfg, dev), axes, mesh)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (max(2 * dp, 2), 64)), device=dev)
    params, _state, loss = step(params, opt(params),
                                batch_sharding.shard(tokens))
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"gspmd dp={dp},ep={ep},tp={tp} step: loss {loss}")
    return {"mesh": {"dp": dp, "ep": ep, "tp": tp}, "loss": loss}


def _manual(dev) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ray_tpu_torch import ops
    from ray_tpu_torch.parallel import (MeshSpec, P, collectives,
                                        pipeline_apply, ring_attention,
                                        sharding_for)
    from ray_tpu_torch.train import optim
    from ray_tpu_torch.train.spmd import make_sp_pp_train_step

    pp, sp, dp = factor_mesh(dist.get_world_size())
    E, H, Dh, F, V = 64, 4, 16, 128, 256
    L = 2 * pp
    B_glob, T_glob, n_micro = 2 * dp, 64 * sp, 2
    mesh = MeshSpec(dp=dp, pp=pp, sp=sp).build()
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    full = {"embed": normal(V, E),
            "layers": {"wq": normal(L, E, H, Dh), "wk": normal(L, E, H, Dh),
                       "wv": normal(L, E, H, Dh), "wo": normal(L, H, Dh, E),
                       "wi": normal(L, E, F), "wmo": normal(L, F, E),
                       "nw": torch.ones((L, E), device=dev)},
             "head": normal(E, V)}
    full["layers"] = {k: v.reshape(pp, L // pp, *v.shape[1:])
                      for k, v in full["layers"].items()}
    specs = {"embed": P(), "layers": {k: P("pp") for k in full["layers"]},
             "head": P()}
    params = {"embed": full["embed"], "head": full["head"],
              "layers": {k: sharding_for(mesh, specs["layers"][k]).shard(v)
                         for k, v in full["layers"].items()}}

    def stage_fn(stage_p, h):
        for i in range(L // pp):  # this stage's layers (pp dim is size 1)
            lp = {k: v[0, i] for k, v in stage_p.items()}
            hn = ops.rms_norm(h, lp["nw"])
            q, k, v = (torch.einsum("bte,ehd->bthd", hn, lp[w])
                       for w in ("wq", "wk", "wv"))
            a = ring_attention(q, k, v, axis_name="sp", causal=True)
            h = h + torch.einsum("bthd,hde->bte", a, lp["wo"])
            hn = ops.rms_norm(h, lp["nw"])
            h = h + ops.gelu(hn @ lp["wi"]) @ lp["wmo"]
        return h

    def shard_loss(p, toks):
        # toks: this rank's [B/dp, T/sp]; the labels need the global next
        # token, so logits and tokens are gathered over sp first
        x = p["embed"][toks]
        Bl, Tl = toks.shape
        y = pipeline_apply(stage_fn, p["layers"],
                           x.reshape(n_micro, Bl // n_micro, Tl, E),
                           axis_name="pp").reshape(Bl, Tl, E)
        logits = collectives.allgather(y @ p["head"], "sp", axis=1)
        toks_g = collectives.allgather(toks, "sp", axis=1)
        loss, _ = ops.softmax_cross_entropy(
            logits, torch.roll(toks_g, -1, dims=1))
        return loss

    leaves = optim.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = torch.optim.SGD(leaves, lr=1e-2)
    step = make_sp_pp_train_step(shard_loss, specs, mesh, opt,
                                 batch_spec=P("dp", "sp"),
                                 loss_axes=("dp", "sp", "pp"))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, V, (B_glob, T_glob)),
                             device=dev)
    params, _opt, loss = step(params, opt, sharding_for(
        mesh, P("dp", "sp")).shard(tokens))
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"manual dp={dp},pp={pp},sp={sp} step: loss {loss}")
    return {"mesh": {"dp": dp, "pp": pp, "sp": sp}, "loss": loss}


def _serving(dev) -> dict:
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.models import llama, transformer
    from ray_tpu_torch.parallel import MeshSpec

    n = dist.get_world_size()
    cfg = llama.llama_config(
        "tiny", vocab_size=256, max_seq_len=64, d_model=64, n_layers=2,
        n_heads=n, n_kv_heads=n, d_ff=128, dtype=torch.float32)
    params = transformer.init(torch.Generator(device=dev).manual_seed(0), cfg,
                              dev)
    eng = LLMEngine(cfg, params, max_slots=2, max_len=64, min_bucket=8,
                    mesh=MeshSpec(tp=n).build(), device=dev)
    try:
        out = eng.generate([1, 5, 9, 2], SamplingParams(max_tokens=4))
    finally:
        eng.shutdown()
    if len(out) != 4:
        raise RuntimeError(f"tp decode produced {len(out)} tokens")
    return {"tp": n, "tokens": out}


PROGRAMS = {"gspmd": _gspmd, "manual": _manual, "serving": _serving}


def _rank(device: str) -> dict:
    return {name: fn(_device(device)) for name, fn in PROGRAMS.items()}


def dryrun_multichip(n: int, *, device: str | None = None,
                     backend: str | None = None,
                     timeout: float = 120.0) -> list:
    """Run the three programs in a world of `n` ranks on `device` over
    `backend` (resolved as ``launch`` does)."""
    from ray_tpu_torch.parallel.launch import launch, resolve_world

    device, backend = resolve_world(device, backend)
    results = launch(_rank, n, args=(device,), backend=backend,
                     device=device, timeout=timeout)
    g, m, s = (results[0][k] for k in ("gspmd", "manual", "serving"))
    print(f"dryrun_multichip({n}) on {device} over {backend}: gspmd "
          f"{g['mesh']} ok; manual {m['mesh']} ok; serving tp={s['tp']} ok",
          flush=True)
    return results
