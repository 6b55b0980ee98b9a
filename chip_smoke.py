#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --only-kernels  # phases 1-2: build + kernel checks

Phases, each of which exits non-zero on failure (nothing is caught):

1. Print the card's ``nvidia-smi --query-gpu=name,power.limit`` line and
   build every kernel of ``ray_tpu_torch/csrc`` for sm_90a (one nvcc per
   source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the serving
   path's shapes: flash forward on [1,32,T,128] bf16 (GQA, 8 kv heads) for
   T in {64, 1024, 2048} causal plus a non-causal case; ragged paged decode
   with B=8, Hkv=8, G=4, Dh=128, P=64 over a 257-page pool with mixed
   positions, at pages_bound 1, 16 and 32. bf16 outputs within
   atol = rtol = 2e-2 of the plain version (f32 math rounded to bf16); flash
   lse within 1e-3. Times by CUDA events.
3. Llama-3-8B at full width and depth (random init from a seed, bf16): one
   prefill at bucket 1024 and 4 teacher-forced ragged decode steps, kernels
   against plain versions, compared by cosine and max abs difference of the
   logits.
4. The main path: ``LLMEngine.from_config`` (paged KV, page 64, 8 slots,
   max_len 2048) serves 8 concurrent greedy requests with prompts of 5 to
   1500 tokens and max_tokens 32. Launch counts are zeroed just before and
   read just after; both kernels must have run, the ragged one 32 times per
   decode step.

The line before last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
ATOL = RTOL = 2e-2         # bf16 outputs vs plain f32 math rounded to bf16
LSE_TOL = 1e-3
# model level, per step: kernels vs plain versions (both bf16), and the
# kernels' distance to an f32 run no worse than F32_ERR_RATIO x the plain
# versions' (bf16 rounding differences grow through 32 random layers)
LOGIT_COS_MIN = 0.995
LOGIT_MAX_ABS = 0.6
F32_ERR_RATIO = 2.0
SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


# ------------------------------------------------------------------ phase 2

def check_flash(torch, gen, T: int, causal: bool, timed: bool,
                D: int = 128) -> dict:
    from ray_tpu_torch.ops import flash_attention as fa

    B, H, Hkv = 1, 32, 8
    dev = torch.device("cuda")
    # [B, T, H, D] activations seen heads-major, exactly as ops.attention
    # hands them to the kernel on the prefill path
    q = torch.randn((B, T, H, D), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    k = torch.randn((B, T, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    v = torch.randn((B, T, Hkv, D), generator=gen, device=dev,
                    dtype=torch.bfloat16).transpose(1, 2)
    scale = D ** -0.5
    o, lse = fa._fwd_call(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_attention_forward_plain(
        q.float(), k.float(), v.float(), causal=causal, scale=scale)
    o_ref = o_ref.to(torch.bfloat16).float()
    err = (o.float() - o_ref).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    if not torch.isfinite(o.float()).all():
        fail(f"flash T={T} causal={causal}: non-finite output")
    if not torch.allclose(o.float(), o_ref, atol=ATOL, rtol=RTOL):
        fail(f"flash T={T} causal={causal}: max abs err {err}")
    if lse_err > LSE_TOL:
        fail(f"flash T={T} causal={causal}: lse err {lse_err}")
    pairs = T * (T + 1) / 2 if causal else T * T
    flops = 4.0 * B * H * D * pairs
    nbytes = 2.0 * (2 * B * H * T * D + 2 * B * Hkv * T * D) + 4.0 * B * H * T
    bms, by = bound_ms(nbytes, flops)
    row = {"case": f"flash T={T} D={D} causal={causal}", "shape": [B, H, T, D],
           "kv_heads": Hkv, "max_abs_err": err, "lse_max_abs_err": lse_err,
           "tolerance": ATOL, "lse_tolerance": LSE_TOL, "bound_ms": bms,
           "bound_by": by}
    if timed:
        kr = k.repeat_interleave(H // Hkv, dim=1).contiguous()
        vr = v.repeat_interleave(H // Hkv, dim=1).contiguous()
        qc = q.contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["ms"] = cuda_ms(torch, lambda: fa._fwd_call(
            q, k, v, causal=causal, scale=scale), 20)
        row["plain_ms"] = cuda_ms(torch, lambda: fa.flash_attention_forward_plain(
            q, k, v, causal=causal, scale=scale), 5)
        # yardstick only: one PyTorch call for the same function
        row["library_ms"] = cuda_ms(torch, lambda: sdpa(
            qc, kr, vr, is_causal=causal, scale=scale), 20)
    return row


def ragged_inputs(torch, gen, Dh: int = 128, P: int = 64, N: int = 257):
    B, Hkv, G = 8, 8, 4
    dev = torch.device("cuda")
    q = torch.randn((B, Hkv, G, Dh), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    kp = torch.randn((N, P, Hkv, Dh), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn((N, P, Hkv, Dh), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    # each row owns (N-1)/B distinct pages out of 1..N-1, as the engine grants
    nb = (N - 1) // B
    perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
    tbl = perm.reshape(B, nb).to(torch.int32)
    # mixed positions: first key, page end, page start, a full row, ...
    S = nb * P
    pos = torch.tensor([0, P - 1, P, S - 1, S // 2, S // 4, 2 * P + 2,
                        (3 * S) // 4], dtype=torch.int32, device=dev)
    return q, kp, vp, tbl, pos


def check_ragged(torch, inputs, nb: int, timed: bool) -> dict:
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    q, kp, vp, tbl_full, pos = inputs
    B, Hkv, G, Dh = q.shape
    P = kp.shape[1]
    tbl = tbl_full[:, :nb]  # strided view, as the engine slices it
    scale = Dh ** -0.5
    out = ra.ragged_decode_attention(q, kp, vp, tbl, pos, scale=scale)
    torch.cuda.synchronize()
    ref = ra.ragged_decode_attention_reference(q, kp, vp, tbl, pos,
                                               scale=scale).float()
    err = (out.float() - ref).abs().max().item()
    if not torch.isfinite(out.float()).all():
        fail(f"ragged nb={nb}: non-finite output")
    if not torch.allclose(out.float(), ref, atol=ATOL, rtol=RTOL):
        fail(f"ragged nb={nb}: max abs err {err}")
    live = torch.minimum(pos.long() + 1, torch.full_like(pos.long(), nb * P))
    keys = int(live.sum().item())
    flops = 4.0 * Dh * G * Hkv * keys
    nbytes = (2.0 * 2 * keys * Hkv * Dh + 2 * 2.0 * q.numel()
              + 4.0 * (B * nb + B))
    bms, by = bound_ms(nbytes, flops)
    row = {"case": f"ragged P={P} pages_bound={nb}", "shape": [B, Hkv, G, Dh],
           "page_size": P, "pool_pages": kp.shape[0], "live_keys": keys,
           "max_abs_err": err, "tolerance": ATOL, "bound_ms": bms,
           "bound_by": by}
    if timed:
        row["ms"] = cuda_ms(torch, lambda: ra.ragged_decode_attention(
            q, kp, vp, tbl, pos, scale=scale), 50)
        row["plain_ms"] = cuda_ms(torch, lambda: ra.ragged_decode_attention(
            q, kp, vp, tbl, pos, scale=scale, impl="reference"), 5)
        row["library_ms"] = None  # no single PyTorch call does paged decode
    return row


# ------------------------------------------------------------------ phase 3

def check_model(torch) -> dict:
    """Llama-3-8B, three runs on the same random weights and tokens: the
    kernels (bf16), the plain versions (bf16), and the plain versions with
    f32 compute as the yardstick both bf16 runs are measured against."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import decoding, llama, transformer
    from ray_tpu_torch.models import decoding_paged as dp

    dev = torch.device("cuda")
    cfg = llama.llama_config("8b")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = transformer.init(gen, cfg, dev, dtype=cfg.dtype)
    n, bucket, P, max_len = 1000, 1024, 64, 2048
    rng = np.random.default_rng(SEED)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :n] = rng.integers(0, cfg.vocab_size, size=n)
    tokens = torch.as_tensor(padded, device=dev)
    runs = {"kernel": (cfg, None), "plain": (cfg, "reference"),
            "f32": (cfg32, "reference")}
    logits, kvs, states = {}, {}, {}
    for name, (c, impl) in runs.items():
        logits[name], kvs[name] = decoding.prefill(params, tokens, n, c,
                                                   attn_impl=impl)

    def compare(what):
        k, p, t = (logits[x].float() for x in ("kernel", "plain", "f32"))
        if not all(torch.isfinite(x).all() for x in (k, p, t)):
            fail(f"model {what}: non-finite logits")
        row = {"step": what,
               "cosine": torch.nn.functional.cosine_similarity(
                   k, p, dim=-1).item(),
               "max_abs_diff": (k - p).abs().max().item(),
               "kernel_rel_err_vs_f32": ((k - t).norm() / t.norm()).item(),
               "plain_rel_err_vs_f32": ((p - t).norm() / t.norm()).item()}
        if row["cosine"] < LOGIT_COS_MIN or row["max_abs_diff"] > LOGIT_MAX_ABS \
                or row["kernel_rel_err_vs_f32"] > \
                F32_ERR_RATIO * row["plain_rel_err_vs_f32"] + 1e-3:
            fail(f"model {what}: {row}")
        return row

    rows = [compare("prefill")]
    first = int(torch.argmax(logits["f32"]))
    pages = np.arange(1, max_len // P + 1, dtype=np.int32)
    for name, (c, impl) in runs.items():
        states[name] = dp.init_paged_state(c, 8, max_len,
                                           8 * (max_len // P) + 1, P, dev)
        dp.insert_sequence_paged(states[name], 0, kvs.pop(name), n, first,
                                 pages, c)
    for step in range(4):
        pos = n + step
        bound = 1 << (pos // P).bit_length()  # pow2 >= live pages (engine's)
        for name, (c, impl) in runs.items():
            states[name], lg = dp.decode_step_paged_ragged(
                params, states[name], c, bound,
                impl=impl)
            logits[name] = lg[0]
        rows.append(compare(f"decode {step}"))
        nxt = torch.argmax(logits["f32"]).int().reshape(1).expand(8)
        for name in runs:  # teacher-forced from the f32 run
            decoding.commit_tokens(states[name], nxt)
    busy = decode_busy_share(torch, lambda: dp.decode_step_paged_ragged(
        params, states["kernel"], cfg, 1 << ((n + 4) // P).bit_length()))
    return {"model": "llama-3-8b random init bf16", "prompt": n,
            "bucket": bucket, "cos_min": LOGIT_COS_MIN,
            "max_abs_bound": LOGIT_MAX_ABS, "f32_err_ratio": F32_ERR_RATIO,
            "steps": rows, "decode_step_profile": busy}


def decode_busy_share(torch, step) -> dict:
    """Host wall time of one kernel-path decode step (batch of 8 rows, one
    live) against the device time its kernels add up to, from
    torch.profiler. The gap is host time the device sits idle."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    if not n_kernels:  # the profiler saw no device activity
        return {"wall_ms": wall_ms, "device_ms": "not measured"}
    device_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_kernels": n_kernels, "busy_share": device_ms / wall_ms,
            "top_kernels_ms": [[k[:60], v] for k, v in top]}


# ------------------------------------------------------------------ phase 4

def serve(torch, kernels) -> dict:
    import numpy as np

    from ray_tpu_torch.llm import (LLMConfig, LLMEngine, ModelLoadingConfig,
                                   SamplingParams)

    t0 = time.perf_counter()
    eng = LLMEngine.from_config(LLMConfig(
        model_family="llama",
        model_loading_config=ModelLoadingConfig(model_id="8b"),
        engine_kwargs={"kv_layout": "paged", "page_size": 64, "max_slots": 8,
                       "max_len": 2048, "seed": SEED}))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    try:
        rng = np.random.default_rng(SEED + 1)
        lengths = [5, 64, 65, 300, 700, 1000, 1300, 1500]
        prompts = [rng.integers(0, eng.cfg.vocab_size, size=n).tolist()
                   for n in lengths]
        params = SamplingParams(max_tokens=32, temperature=0.0)
        for k in kernels:
            k.launches = 0  # the main path starts here
        t0 = time.perf_counter()
        reqs = [eng.submit(p, params) for p in prompts]
        outs = [list(r) for r in reqs]
        wall = time.perf_counter() - t0
        launches = {k.symbol: k.launches for k in kernels}
        st = eng.stats()
        n_layers, vocab = eng.cfg.n_layers, eng.cfg.vocab_size
    finally:
        eng.shutdown()
    for n, out in zip(lengths, outs):
        if len(out) != 32 or not all(0 <= t < vocab for t in out):
            fail(f"request with prompt {n}: {len(out)} tokens, ids {out[:4]}")
    steps = st["decode_steps"]
    for sym, count in launches.items():
        if count <= 0:
            fail(f"{sym} never launched on the main path")
    rag = launches["ragged_paged_attention_bf16"]
    if rag != n_layers * steps:
        fail(f"ragged launches {rag} != {n_layers} x {steps} decode steps")
    flash = launches["flash_attention_fwd_bf16"]
    if flash != n_layers * st["prefills"]:
        fail(f"flash launches {flash} != {n_layers} x {st['prefills']} "
             "prefills")
    return {"requests": len(outs), "prompt_lengths": lengths,
            "tokens_out": sum(len(o) for o in outs), "wall_s": wall,
            "engine_build_s": build_s,
            "prefill_ms_mean": 1e3 * st["prefill_seconds"] / st["prefills"],
            "decode_step_ms_mean": 1e3 * st["decode_seconds"] / steps,
            "decode_steps": steps, "decode_occupancy": st["decode_occupancy"],
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "launches": launches}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="stop after building and checking the kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ray_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repo (ray_tpu_torch/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    print(json.dumps({"build_s": build_s, "built": sorted(logs)}), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = [check_flash(torch, gen, T, True, timed=True)
              for T in (64, 1024, 2048)]
    checks.append(check_flash(torch, gen, 1024, False, timed=True))
    rin = ragged_inputs(torch, gen)
    checks += [check_ragged(torch, rin, nb, timed=True) for nb in (1, 16, 32)]
    del rin
    # the other compiled variants (head_dim 64 as in Llama-3.2-1B, smaller
    # pages), checked untimed at small shapes
    checks.append(check_flash(torch, gen, 128, True, timed=False, D=64))
    for Dh, P in ((64, 16), (128, 32)):
        rin = ragged_inputs(torch, gen, Dh=Dh, P=P, N=33)
        checks.append(check_ragged(torch, rin, 4, timed=False))
    print(json.dumps({"card": card, "kernel_checks": checks}), flush=True)

    serving = None
    if not args.only_kernels:
        model = check_model(torch)
        torch.cuda.empty_cache()  # phase 3's model and pools are gone
        print(json.dumps({"card": card, "model_check": model}), flush=True)
        serving = serve(torch, [fa.KERNEL, ra.KERNEL])
        print(json.dumps({"card": card, "serve": serving}), flush=True)
        print(f"serve on {card}: prefill {serving['prefill_ms_mean']:.3f} ms "
              f"mean, decode step {serving['decode_step_ms_mean']:.3f} ms "
              f"mean, {serving['tokens_per_s']:.1f} tokens/s", flush=True)

    flash_main = next(c for c in checks
                      if c["case"] == "flash T=2048 D=128 causal=True")
    ragged_main = next(c for c in checks
                       if c["case"] == "ragged P=64 pages_bound=32")
    launches = serving["launches"] if serving else {}
    kernels = []
    for kern, c, src, rep in (
            (fa.KERNEL, flash_main, "ray_tpu_torch/csrc/flash_attention_fwd.cu",
             "ray_tpu/ops/flash_attention.py:43"),
            (ra.KERNEL, ragged_main,
             "ray_tpu_torch/csrc/ragged_paged_attention.cu",
             "ray_tpu/ops/ragged_paged_attention.py:49")):
        kernels.append({
            "name": kern.symbol, "route": "cuda", "source": src,
            "replaces": rep, "launches": launches.get(kern.symbol, 0),
            "case": c["case"], "max_abs_err": c["max_abs_err"],
            "tolerance": c["tolerance"], "ms": c["ms"], "kernel_ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
