#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase (needs one CUDA card)
    python3 chip_smoke.py --only-kernels  # phases 1-2: build + kernel checks

Phases, each of which exits non-zero on failure (nothing is caught):

1. Print the card's ``nvidia-smi --query-gpu=name,power.limit`` line and
   build every kernel of ``ray_tpu_torch/csrc`` for sm_90a (one nvcc per
   source, all started together), printing ptxas' registers, spills and
   warnings; a spill store in any kernel fails the run.
2. Each of the four kernels against its plain PyTorch version on the card,
   at the main paths' shapes, times by CUDA events (ragged decode: the
   profiler's device time of its two kernels, whose calls are too short
   for events around a host-bound loop):
   - first, untimed, the edge cases of the forward and the backward whose
     kernels work on 128-row tiles while callers need only T % 64 == 0:
     T in {64, 192, 2048} x head_dim {64, 128} x causal/full, batch 2;
   - flash forward on [1,32,T,128] bf16 (GQA, 8 kv heads) for T in {64,
     1024, 2048} causal plus a non-causal case, on [2,32,1024,128] causal
     (a coalesced prefill of two prompts, phase 12b) and on [4,32,2048,64]
     (training); bf16 O within atol = rtol = 2e-2 of the plain version
     (f32 math rounded to bf16), lse within 1e-3;
   - ragged paged decode with B=8, Hkv=8, G=4, Dh=128, P=64 over a 257-page
     pool with mixed positions, at pages_bound 1, 16 and 32, then at
     pages_bound 32 with every row full (pos 2047) and with every row at
     pos 0 (all splits but the first empty), timed, and at pages_bound 23
     (not a multiple of the pages per split) untimed; within 2e-2. One
     counted launch is two device kernels (split pass and merge pass), and
     the time covers both; each row prints the split count and the pages
     per split;
   - untimed, at GPT-2's shapes (phase 9): the forward on [1,12,1024,64]
     causal with as many kv heads as q heads, and ragged decode with
     Hkv=12, G=1, Dh=64, P=64 over a 16-page table;
   - timed, at the shapes of a tensor-parallel rank of Llama-3-8B at tp = 2
     (phase 11): the forward on [1,16,2048,128] causal over 4 kv heads, and
     ragged decode with Hkv=4, G=4, Dh=128, P=64 at pages_bound 32;
   - flash backward (dQ and dK/dV kernels) on [4,32,2048,64] causal
     (training), [1,32,2048,128] causal and [1,32,1024,64] full, timed,
     and on one- and two-tile sequences untimed; each gradient within
     atol = 2e-2 max|ref|, rtol = 2e-2 and a relative Frobenius error of
     1e-2 of the plain backward fed the same (o, lse) and dO, and the
     delta the dQ kernel writes within 1e-4 max|ref| of the plain f32
     delta.
3. Llama-3-8B at full width and depth (random init from a seed, bf16): one
   prefill at bucket 1024 and 4 teacher-forced ragged decode steps, kernels
   against plain versions, compared by cosine and max abs difference of the
   logits.
4. The serving path: ``LLMEngine.from_config`` (paged KV, page 64, 8 slots,
   max_len 2048) serves 8 concurrent greedy requests with prompts of 5 to
   1500 tokens and max_tokens 32. Launch counts are zeroed just before and
   read just after; both kernels must have run, the ragged one 32 times per
   decode step, and no backward kernel. Every path below counts all four
   kernels too.
5. Llama-3.2-1B (tied, random init, f32 params): loss and gradients of one
   [1, 2049] token row through the kernels, the plain versions and the
   plain versions in f32; per gradient group the kernels agree with the
   plain path (cosine) and are no farther from f32 than it.
6. The training path: ``make_train_step`` + ``adamw(1e-4, weight_decay=
   0.01)`` on Llama-3.2-1B, batch 4 x 2048, one warm-up and 10 timed steps
   through ``ray_tpu_torch.benchmarks.train_step.measure``. Losses finite
   and falling; launch counts zeroed just before the timed steps and read
   just after: 32 forward (16 layers, forward and remat recompute), 16
   dK/dV and 16 dQ launches a step, no ragged one.
7. Mixtral-8x7B at full width, 16 of its 32 layers (random init from a
   seed, bf16; the 32 layers' 93.4 GB do not fit the card): phase 3's
   check (one prefill at bucket 1024, 4 teacher-forced ragged decode
   steps, kernels against plain versions and both against f32, phase 3's
   bounds), with the MoE mlp in every layer. The two bf16 runs replay the
   f32 run's routing call by call, so that a near-tied router choice cannot
   flip between runs and compound with depth; per step, the share of
   (token, layer, choice) expert assignments on which the kernel and plain
   runs' own routing agrees.
8. Serving Mixtral, the slice's main path: phase 4's engine and 8 requests
   through ``LLMEngine.from_config(model_family="mixtral")`` at 16 layers;
   launch counts zeroed just before and read just after: flash = 16 x
   prefills, ragged = 16 x decode steps, no backward kernel.
9. The other families and the attention dispatcher on the card: GPT-2
   124M served (4 requests, max_len 1024: the kernels at head_dim 64,
   G = 1, learned positions); ViT-L/16 at batch 8 x 224² (T = 197), one
   forward and one ``loss_fn`` gradient in bf16 against f32 by cosine,
   with no flash launch (T = 197 takes the dense path); and
   ``transformer.forward`` (Llama-3.2-1B) with ``attn_impl=None`` at
   T = 100 bf16 and T = 128 f32 (the dense path, no launch) and T = 128
   bf16 (the forward kernel, one launch a layer), each against the plain
   path within phase 3's bounds.
10. The engine's options, Llama-3-8B at full width and depth (bf16, random
   weights from a seed, built once). First the model functions under
   phase 3's bounds, each against the path it is held to and an f32 run:
   chunked prefill (write_kv_pages, gather_prefix_pages,
   prefill_with_prefix, activate_slot, then 2 ragged decode steps) against
   whole-prompt prefill, the slot decode_step against the ragged paged step,
   verify_step's K = 5 logits and written KV against 5 slot decode steps,
   and LoRA prefill and decode with a random adapter against the adapter
   merged into wq and wv. Then one LLMEngine a run (8 slots, max_len
   2048, page 64), launch counts zeroed just before its traffic and read
   just after:
   paged (phase 4's 8 prompts), slot and paged ``attn_impl="gather"`` (the
   same prompts; first tokens equal the paged run's), prefix cache +
   ``prefill_chunk=512`` (a 1024-token shared prefix with 4 suffixes, the
   first served to its first token before the rest, and a 1500-token
   prompt; hits, misses, tokens reused, chunks, continuation prefills and
   returned pages asserted exactly), ``speculative_k=4`` on the slot layout
   (one token repeated to 1000, whose drafts must be accepted, and 3
   random prompts), LoRA (no adapter, a zero adapter token-exact to it, a
   random one; unload refused while live) and guided decoding (a choice
   FSM and a regex FSM, greedy and at temperature 1, outputs allowed and
   ended by EOS). Flash forward = layers x prefill calls, ragged = layers x
   decode steps on the paged ragged runs and 0 elsewhere, no backward
   kernel.

11. Multi-GPU (ray_tpu_torch.parallel) on the one card. No multi-rank NCCL
   path can run here: NCCL refuses two ranks on one GPU.
   a. A world of one over NCCL: ``MeshSpec().build()`` on a real NCCL
      group; Llama-3.2-1B at phase 6's config takes 3 steps through the
      meshed ``make_train_step`` (dp = 1: every gradient is allreduced over
      the one-rank group) and 3 through the unmeshed step from the same
      params and batch. Losses and params must be equal bit for bit (the
      stated bound is 0: a one-rank allreduce copies, and both runs launch
      the same kernels on the same data); launches per step equal phase
      6's, and the collective calls per step (all on CUDA tensors) > 0.
   b. Two ranks sharing the card over gloo, Llama-3-8B at full width and
      depth, tp = 2. First the main process computes, from seed-0 weights,
      a 1000-token prefill and 2 teacher-forced ragged decode steps with
      the kernels (tp = 1) and with f32 compute, then frees them; each
      rank builds the same weights, keeps its tensor-parallel cut and runs
      the same steps, held to the tp = 1 rows by phase 3's bounds
      (``hold``; the allreduce sums in another order, so bf16 is not
      token-exact). Then ``LLMEngine.from_config(mesh=tp 2)``, paged, serves
      phase 4's 8 prompts on both ranks: both ranks emit the same tokens,
      32 ragged launches per decode step and 32 flash launches per prefill
      on each rank's pool of 4 kv heads, no backward launch. Its times are
      labelled "2 ranks sharing one H100 over gloo": they are no multi-GPU
      numbers.
   c. ``parallel.dryrun.dryrun_multichip(4)`` over gloo, 4 ranks on the
      card: the tiny gspmd Mixtral step (dp x ep x tp), the pp x sp step
      (GPipe, ring attention) and the tp = 4 decode, every program on CUDA
      tensors (gloo takes every collective ``parallel/`` calls on them).

12. PD disaggregation below Serve, on phase 10's Llama-3-8B (built once;
   phase 12 runs right after phase 10, before phase 11 needs the memory).
   It prints /dev/shm's size first: a transfer channel holds
   ``prefetch_depth`` pages of 8 MiB (16 MiB); with less free than one
   channel the phase fails, with less than eight it runs the transfers in
   waves that fit.
   a. Phase 4's 8 prompts: ``decoding.prefill`` at each bucket (the
      monolithic engine's call), ``PagedKVExporter`` (PDConfig's page 64,
      prefetch 2), ``BatchedKVPuller`` into ``KVPageStream``s, and
      ``LLMEngine(**_pd_engine_kwargs(...)).submit_prefilled(kv_stream=)``.
      The greedy tokens must equal those of a monolithic paged LLMEngine
      serving the same prompts token for token; the pages the decode
      engine adopted must equal the exported ones byte for byte (exact
      integer fingerprints of the pool pages read back at adoption,
      against the exported pages'); flash = 32 x 8 prefills and none in the
      decode engine, ragged = 32 x decode steps, no backward kernel; no
      segment of the port's prefix is left after teardown. Both engines
      take the two longest prompts first, with 128 new tokens (the rest
      32): while either is resident every decode step sweeps 32 pages, so
      each row meets the same ragged split shape in both runs whatever the
      arrival timing, which bf16 token-exactness needs.
   b. The 8 prompts from 8 threads into one ``PrefillCoalescer``
      (max_batch 4, PDConfig's window): each row's logits against the
      solo prefill of its prompt and an f32 run under phase 3's bounds,
      flash launches = 32 x the coalescer's batches, jobs = 8.

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
# flash backward, each of dq/dk/dv vs the plain f32 math rounded to bf16:
# elementwise within atol = BWD_TOL * max|ref| and rtol = BWD_TOL (P and dS
# are rounded to bf16 before the second products), and the relative
# Frobenius error within BWD_FRO_TOL
BWD_TOL = 2e-2
BWD_FRO_TOL = 1e-2
# delta = rowsum(dO * O) from the dQ kernel vs the plain f32 sum: the same
# f32 products summed in another order
DELTA_TOL = 1e-4
# model level, per step: kernels vs plain versions (both bf16), and the
# kernels' distance to an f32 run no worse than F32_ERR_RATIO x the plain
# versions' (bf16 rounding differences grow through 32 random layers)
LOGIT_COS_MIN = 0.995
GRAD_COS_MIN = 0.99        # phase 5: per gradient group, kernels vs plain
LOGIT_MAX_ABS = 0.6
F32_ERR_RATIO = 2.0
SEED = 0
# phase 7-8: Mixtral-8x7B's depth cut to fit one 80 GB card in bf16 (46.96 GB
# of weights at 16 layers; 93.4 GB at the published 32)
MIXTRAL_LAYERS = 16
EDGE_CASES = [(T, D, causal) for T in (64, 192, 2048) for D in (64, 128)
              for causal in (True, False)]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def zero(kernels) -> None:
    for k in kernels:
        k.launches = 0


def counts(kernels) -> dict:
    return {k.symbol: k.launches for k in kernels}


def cosine(torch, a, b) -> float:
    return torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()


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


def device_ms(torch, fn, iters: int, key: str) -> tuple[float, dict]:
    """Mean device time one call of fn spends in the kernels whose name
    contains `key`, from torch.profiler: the kernels' own time, without the
    gaps a host-bound stream of calls leaves between them (which CUDA
    events around the loop would count). Also that time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name:
            name = e.name[e.name.index(key):].split("(")[0]
            by_name[name] = (by_name.get(name, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / iters)
    if not by_name:
        fail(f"the profiler saw no device time in kernels named *{key}*")
    return sum(by_name.values()), by_name


def ptxas_summary(logs: dict) -> list[dict]:
    """Registers and spill stores of every compiled entry, from nvcc's
    ``-Xptxas -v`` output."""
    import re

    rows, entry = [], None
    for lib, log in sorted(logs.items()):
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = {"library": lib, "entry": m.group(1)}
                rows.append(entry)
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry is not None:
                entry["spill_stores"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                entry["registers"] = int(m.group(1))
    for r in rows:
        r.setdefault("spill_stores", 0)
    return rows


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else
                                       "operations")


# ------------------------------------------------------------------ phase 2

def check_flash(torch, gen, T: int, causal: bool, timed: bool,
                D: int = 128, B: int = 1, H: int = 32, Hkv: int = 8) -> dict:
    from ray_tpu_torch.ops import flash_attention as fa

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
    heads = "" if (H, Hkv) == (32, 8) else f" H={H} Hkv={Hkv}"
    row = {"case": f"flash B={B} T={T} D={D} causal={causal}{heads}",
           "shape": [B, H, T, D],
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


def check_flash_bwd(torch, gen, B: int, T: int, D: int, causal: bool,
                    timed: bool) -> dict:
    """dQ and dK/dV kernels against the plain backward (f32 math rounded to
    bf16), both fed the forward kernel's (o, lse) and the same dO; and the
    delta the dQ kernel writes against the plain f32 delta."""
    from ray_tpu_torch.ops import flash_attention as fa

    H, Hkv = 32, 8
    dev = torch.device("cuda")

    def act(heads):  # [B, T, heads, D] seen heads-major, as in training
        return torch.randn((B, T, heads, D), generator=gen, device=dev,
                           dtype=torch.bfloat16).transpose(1, 2)

    q, k, v, do = act(H), act(Hkv), act(Hkv), act(H)
    scale = D ** -0.5
    o, lse = fa._fwd_call(q, k, v, causal=causal, scale=scale)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, causal=causal,
                                        scale=scale)
    torch.cuda.synchronize()
    refs = fa.flash_attention_backward_plain(
        q.float(), k.float(), v.float(), o, lse, do.float(), causal=causal,
        scale=scale)
    case = f"flash_bwd B={B} T={T} D={D} causal={causal}"
    row = {"case": case, "shape": [B, H, T, D], "kv_heads": Hkv,
           "atol_rel_max": BWD_TOL, "rtol": BWD_TOL, "fro_tol": BWD_FRO_TOL}
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        got, ref = got.float(), ref.to(torch.bfloat16).float()
        atol = BWD_TOL * ref.abs().max().item()
        err = (got - ref).abs().max().item()
        fro = ((got - ref).norm() / ref.norm()).item()
        row[f"{name}_max_abs_err"], row[f"{name}_rel_fro_err"] = err, fro
        if not torch.isfinite(got).all():
            fail(f"{case}: non-finite {name}")
        if not torch.allclose(got, ref, atol=atol, rtol=BWD_TOL) \
                or fro > BWD_FRO_TOL:
            fail(f"{case}: {name} max abs err {err} (atol {atol}), "
                 f"relative Frobenius err {fro}")
    del refs
    kw = {"causal": causal, "scale": scale}
    # the delta the dQ kernel writes (the backward above kept it internal)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    fa._dq_launch(q, k, v, do, o, lse, delta, dq, **kw)
    torch.cuda.synchronize()
    delta_ref = fa.backward_delta(o, do)
    err = (delta - delta_ref).abs().max().item()
    row["delta_max_abs_err"] = err
    row["delta_atol"] = DELTA_TOL * delta_ref.abs().max().item()
    if not torch.isfinite(delta).all() or err > row["delta_atol"]:
        fail(f"{case}: delta max abs err {err} (atol {row['delta_atol']})")
    pairs = T * (T + 1) / 2 if causal else T * T
    qo_bytes = 2.0 * B * H * T * D    # one bf16 [B,H,T,D] tensor
    kv_bytes = 2.0 * B * Hkv * T * D  # one bf16 [B,Hkv,T,D] tensor
    stat_bytes = 4.0 * B * H * T      # one f32 [B,H,T] lse or delta
    # dK/dV reads q, k, v, dO, lse, delta and writes dK, dV; dQ reads q, k,
    # v, dO, O, lse and writes dQ and delta, whose 2*D FLOPs a row it adds
    row["dkv_bound_ms"], row["dkv_bound_by"] = bound_ms(
        2 * qo_bytes + 4 * kv_bytes + 2 * stat_bytes,
        8.0 * D * pairs * B * H)
    row["dq_bound_ms"], row["dq_bound_by"] = bound_ms(
        4 * qo_bytes + 2 * kv_bytes + 2 * stat_bytes,
        6.0 * D * pairs * B * H + 2.0 * D * B * H * T)
    if timed:
        row["dq_ms"] = cuda_ms(torch, lambda: fa._dq_launch(
            q, k, v, do, o, lse, delta, dq, **kw), 20)
        row["dkv_ms"] = cuda_ms(torch, lambda: fa._dkv_launch(
            q, k, v, do, lse, delta, dk, dv, **kw), 20)
        row["bwd_ms"] = cuda_ms(torch, lambda: fa.flash_attention_backward(
            q, k, v, o, lse, do, **kw), 20)  # both kernels
        row["plain_ms"] = cuda_ms(
            torch, lambda: fa.flash_attention_backward_plain(
                q, k, v, o, lse, do, **kw), 3, warmup=1)
        # yardstick only: autograd through one PyTorch call, backward timed
        qc, dc = q.contiguous().requires_grad_(), do.contiguous()
        kr, vr = (x.repeat_interleave(H // Hkv, dim=1).contiguous()
                  .requires_grad_() for x in (k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qc, kr, vr, is_causal=causal, scale=scale)
        row["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            out, (qc, kr, vr), dc, retain_graph=True), 20)
    return row


def ragged_inputs(torch, gen, Dh: int = 128, P: int = 64, N: int = 257,
                  Hkv: int = 8, G: int = 4):
    B = 8
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


def check_ragged(torch, inputs, nb: int, timed: bool, pos=None,
                 label: str = "") -> dict:
    """The ragged kernels (split and merge pass, one counted launch) against
    the plain version; `pos` replaces the inputs' mixed positions."""
    from ray_tpu_torch.ops import ragged_paged_attention as ra

    q, kp, vp, tbl_full, mixed = inputs
    pos = mixed if pos is None else pos
    B, Hkv, G, Dh = q.shape
    P = kp.shape[1]
    tbl = tbl_full[:, :nb]  # strided view, as the engine slices it
    scale = Dh ** -0.5
    name = f"ragged P={P} pages_bound={nb}{label}"
    out = ra.ragged_decode_attention(q, kp, vp, tbl, pos, scale=scale)
    torch.cuda.synchronize()
    ref = ra.ragged_decode_attention_reference(q, kp, vp, tbl, pos,
                                               scale=scale).float()
    err = (out.float() - ref).abs().max().item()
    if not torch.isfinite(out.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(out.float(), ref, atol=ATOL, rtol=RTOL):
        fail(f"{name}: max abs err {err}")
    S, pps = ra.ragged_splits(B, Hkv, nb, ra._sm_count(q.device.index))
    live = torch.minimum(pos.long() + 1, torch.full_like(pos.long(), nb * P))
    keys = int(live.sum().item())
    flops = 4.0 * Dh * G * Hkv * keys
    nbytes = (2.0 * 2 * keys * Hkv * Dh + 2 * 2.0 * q.numel()
              + 4.0 * (B * nb + B))
    bms, by = bound_ms(nbytes, flops)
    row = {"case": name, "shape": [B, Hkv, G, Dh], "page_size": P,
           "pool_pages": kp.shape[0], "live_keys": keys, "splits": S,
           "pages_per_split": pps, "max_abs_err": err, "tolerance": ATOL,
           "bound_ms": bms, "bound_by": by}
    if timed:
        def call():
            return ra.ragged_decode_attention(q, kp, vp, tbl, pos, scale=scale)

        # device time of the split and merge kernels of one call, and the
        # time a call takes in a back-to-back stream (host included)
        row["ms"], row["ms_by_kernel"] = device_ms(torch, call, 50,
                                                   "ragged_")
        row["call_ms"] = cuda_ms(torch, call, 50)
        row["plain_ms"] = cuda_ms(torch, lambda: ra.ragged_decode_attention(
            q, kp, vp, tbl, pos, scale=scale, impl="reference"), 5)
        row["library_ms"] = None  # no single PyTorch call does paged decode
    return row


# ------------------------------------------------------------------ phase 3

def logit_row(torch, what: str, k, p, t) -> dict:
    """Logits `k` (the path under test, bf16) against `p` (the path it is
    held to, bf16), each against `t` (f32 compute): cosine, max abs
    difference and relative distances to f32. Fails on a non-finite
    value."""
    k, p, t = k.float(), p.float(), t.float()
    if not all(torch.isfinite(x).all() for x in (k, p, t)):
        fail(f"{what}: non-finite logits")
    return {"cosine": torch.nn.functional.cosine_similarity(
                k.flatten(), p.flatten(), dim=0).item(),
            "max_abs_diff": (k - p).abs().max().item(),
            "kernel_rel_err_vs_f32": ((k - t).norm() / t.norm()).item(),
            "plain_rel_err_vs_f32": ((p - t).norm() / t.norm()).item()}


def hold(what: str, row: dict) -> None:
    """Phase 3's bounds: cosine >= LOGIT_COS_MIN, max abs difference <=
    LOGIT_MAX_ABS, and the tested path no farther from f32 than
    F32_ERR_RATIO x the other path (+ 1e-3)."""
    if row["cosine"] < LOGIT_COS_MIN or row["max_abs_diff"] > LOGIT_MAX_ABS \
            or row["kernel_rel_err_vs_f32"] > \
            F32_ERR_RATIO * row["plain_rel_err_vs_f32"] + 1e-3:
        fail(f"{what}: {row}")


class RoutingReplay:
    """Record and replay of ``ops.topk_routing`` (the models call it
    through the ops package). While active, the run named ``run`` gets, call
    by call, the routing the ``source`` run made in the same call; the
    source run records its own. With random weights the router's top-k is
    decided by small margins, so a choice that flipped between two runs
    would change that token's mlp outright and, through attention, every
    later token in the deeper layers: the model check would measure that
    drift, not the kernels. Each call also keeps the run's own, unforced
    choices ([N, E]: which experts kept the row) for the agreement
    statistic."""

    def __init__(self, torch, source: str = "f32"):
        from ray_tpu_torch import ops

        self.torch, self.ops, self.real = torch, ops, ops.topk_routing
        self.source, self.run = source, None
        self.recorded: list = []  # the source run's RoutingInfo, by call
        self.kept: dict = {}      # run -> its own [N, E] choices, by call

    def __enter__(self):
        def replayed(router_logits, *, num_experts, k, capacity_factor=1.25):
            own = self.real(router_logits, num_experts=num_experts, k=k,
                            capacity_factor=capacity_factor)
            kept = self.kept.setdefault(self.run, [])
            kept.append(own.dispatch.sum(-1) > 0)
            if self.run == self.source:
                self.recorded.append(own)
                return own
            forced = self.recorded[len(kept) - 1]
            if forced.dispatch.shape != own.dispatch.shape:
                fail(f"routing replay: call {len(kept) - 1} of run "
                     f"{self.run} routes {tuple(own.dispatch.shape)}, the "
                     f"{self.source} run {tuple(forced.dispatch.shape)}")
            return forced

        self.ops.topk_routing = replayed
        return self

    def __exit__(self, *exc):
        self.ops.topk_routing = self.real

    def agreement(self, a: str, b: str, calls: slice, rows: slice) -> float:
        """Share of run a's kept (row, expert) assignments in `calls` that
        run b's own routing also made."""
        same = total = 0
        for x, y in zip(self.kept[a][calls], self.kept[b][calls]):
            x, y = x[rows], y[rows]
            same += int((x & y).sum())
            total += int(x.sum())
        return same / total


def check_model(torch, cfg, label: str) -> dict:
    """Three runs of `cfg` on the same random weights and tokens: the
    plain versions with f32 compute, the kernels (bf16) and the plain
    versions (bf16), held to the f32 run as the yardstick. For a MoE config
    the bf16 runs replay the f32 run's routing (``RoutingReplay``), and
    each row also reports the share of expert assignments on which the
    kernel and plain runs' own routing agree, over the real rows (the
    prompt's tokens; the one live decode row) and over all rows the layers
    routed (the bucket's padding; the 7 idle slots)."""
    import contextlib
    import dataclasses

    import numpy as np

    from ray_tpu_torch.benchmarks.device_profile import busy_share
    from ray_tpu_torch.models import decoding, transformer
    from ray_tpu_torch.models import decoding_paged as dp

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = transformer.init(gen, cfg, dev, dtype=cfg.dtype)
    n, bucket, P, max_len = 1000, 1024, 64, 2048
    rng = np.random.default_rng(SEED)
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :n] = rng.integers(0, cfg.vocab_size, size=n)
    tokens = torch.as_tensor(padded, device=dev)
    # the f32 run first: under replay it routes for the other two
    runs = {"f32": (cfg32, "reference"), "kernel": (cfg, None),
            "plain": (cfg, "reference")}
    routing = RoutingReplay(torch) if cfg.moe is not None else None
    logits, kvs, states, rows = {}, {}, {}, []

    def compare(what, real_rows):
        row = {"step": what, **logit_row(
            torch, f"model {what}",
            *(logits[x] for x in ("kernel", "plain", "f32")))}
        if routing is not None:  # this step's calls, one a layer
            calls = slice(len(rows) * cfg.n_layers,
                          (len(rows) + 1) * cfg.n_layers)
            row["routing_agree"] = routing.agreement("kernel", "plain", calls,
                                                     real_rows)
            row["routing_agree_all_rows"] = routing.agreement(
                "kernel", "plain", calls, slice(None))
            if not rows:  # prefill: by layer, one call each
                row["routing_agree_by_layer"] = [
                    routing.agreement("kernel", "plain", slice(i, i + 1),
                                      real_rows)
                    for i in range(cfg.n_layers)]
        hold(f"model {what}", row)
        return row

    with routing if routing is not None else contextlib.nullcontext():
        for name, (c, impl) in runs.items():
            if routing is not None:
                routing.run = name
            logits[name], kvs[name] = decoding.prefill(params, tokens, n, c,
                                                       attn_impl=impl)
        rows.append(compare("prefill", slice(0, n)))
        first = int(torch.argmax(logits["f32"]))
        pages = np.arange(1, max_len // P + 1, dtype=np.int32)
        for name, (c, impl) in runs.items():
            states[name] = dp.init_paged_state(c, 8, max_len,
                                               8 * (max_len // P) + 1, P, dev)
            dp.insert_sequence_paged(states[name], 0, kvs.pop(name), n, first,
                                     pages, c)
        for step in range(4):
            pos = n + step
            bound = 1 << (pos // P).bit_length()  # pow2 >= live pages
            for name, (c, impl) in runs.items():
                if routing is not None:
                    routing.run = name
                states[name], lg = dp.decode_step_paged_ragged(
                    params, states[name], c, bound,
                    impl=impl)
                logits[name] = lg[0]
            rows.append(compare(f"decode {step}", slice(0, 1)))
            nxt = torch.argmax(logits["f32"]).int().reshape(1).expand(8)
            for name in runs:  # teacher-forced from the f32 run
                decoding.commit_tokens(states[name], nxt)
    del routing
    # host wall time of one kernel-path decode step (batch of 8 rows, one
    # live; its own routing, as served) against the device time of its
    # kernels
    busy = busy_share(lambda: dp.decode_step_paged_ragged(
        params, states["kernel"], cfg, 1 << ((n + 4) // P).bit_length()))
    return {"model": label, "prompt": n, "bucket": bucket,
            "cos_min": LOGIT_COS_MIN, "max_abs_bound": LOGIT_MAX_ABS,
            "f32_err_ratio": F32_ERR_RATIO,
            "routing": "replayed from the f32 run" if cfg.moe else None,
            "steps": rows, "decode_step_profile": busy}


# ------------------------------------------------------------------ phase 4

SERVE_LENGTHS = [5, 64, 65, 300, 700, 1000, 1300, 1500]


def serve(torch, kernels, family: str = "llama", model_id: str = "8b",
          model_kwargs: dict | None = None, lengths=SERVE_LENGTHS,
          max_len: int = 2048) -> dict:
    """Greedy requests with prompts of `lengths` tokens and max_tokens 32
    through ``LLMEngine.from_config`` of a model family (paged KV, page 64,
    8 slots). The counts of `kernels` are zeroed just before the requests
    and read just after: flash forward = layers x prefills, ragged = layers
    x decode steps, and no backward kernel."""
    import numpy as np

    from ray_tpu_torch.llm import (LLMConfig, LLMEngine, ModelLoadingConfig,
                                   SamplingParams)

    t0 = time.perf_counter()
    eng = LLMEngine.from_config(LLMConfig(
        model_family=family,
        model_loading_config=ModelLoadingConfig(model_id=model_id),
        model_kwargs=dict(model_kwargs or {}),
        engine_kwargs={"kv_layout": "paged", "page_size": 64, "max_slots": 8,
                       "max_len": max_len, "seed": SEED}))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    try:
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, eng.cfg.vocab_size, size=n).tolist()
                   for n in lengths]
        params = SamplingParams(max_tokens=32, temperature=0.0)
        zero(kernels)  # the main path starts here
        t0 = time.perf_counter()
        reqs = [eng.submit(p, params) for p in prompts]
        outs = [list(r) for r in reqs]
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        st = eng.stats()
        n_layers, vocab = eng.cfg.n_layers, eng.cfg.vocab_size
    finally:
        eng.shutdown()
    for n, out in zip(lengths, outs):
        if len(out) != 32 or not all(0 <= t < vocab for t in out):
            fail(f"request with prompt {n}: {len(out)} tokens, ids {out[:4]}")
    steps = st["decode_steps"]
    for sym, count in launches.items():
        served = sym in ("flash_attention_fwd_bf16",
                         "ragged_paged_attention_bf16")
        if served and count <= 0:
            fail(f"{sym} never launched on the main path")
        if not served and count:  # serving runs no backward
            fail(f"{sym} launched {count} times while serving")
    rag = launches["ragged_paged_attention_bf16"]
    if rag != n_layers * steps:
        fail(f"ragged launches {rag} != {n_layers} x {steps} decode steps")
    flash = launches["flash_attention_fwd_bf16"]
    if flash != n_layers * st["prefills"]:
        fail(f"flash launches {flash} != {n_layers} x {st['prefills']} "
             "prefills")
    return {"model": f"{family} {model_id} {model_kwargs or ''}".strip(),
            "n_layers": n_layers, "requests": len(outs),
            "prompt_lengths": list(lengths),
            "tokens_out": sum(len(o) for o in outs), "wall_s": wall,
            "engine_build_s": build_s,
            "prefill_ms_mean": 1e3 * st["prefill_seconds"] / st["prefills"],
            "decode_step_ms_mean": 1e3 * st["decode_seconds"] / steps,
            "decode_steps": steps, "decode_occupancy": st["decode_occupancy"],
            "tokens_per_s": sum(len(o) for o in outs) / wall,
            "launches": launches}


# ------------------------------------------------------------------ phase 5

GRAD_GROUPS = {  # leaf paths of each gradient group compared in phase 5
    "wq": [("layers", "attn", "wq")],
    "wk": [("layers", "attn", "wk")],
    "wv": [("layers", "attn", "wv")],
    "wo": [("layers", "attn", "wo")],
    "mlp": [("layers", "mlp", n) for n in ("wi_gate", "wi_up", "wo")],
    "norms": [("layers", "norm1", "w"), ("layers", "norm2", "w"),
              ("final_norm", "w")],
    "embed": [("embed",)],
}


def train_config():
    from ray_tpu_torch.models import llama

    return llama.llama_config("1b", tie_embeddings=True, max_seq_len=2048)


def check_model_grads(torch, kernels) -> dict:
    """Llama-3.2-1B (random init from a seed, f32 params), loss and
    gradients on one [1, 2049] token row three ways: the kernels (bf16
    compute), the plain versions (bf16) and the plain versions with f32
    compute. Per gradient group: cosine(kernels, plain) >= GRAD_COS_MIN,
    and the kernels' relative distance to the f32 run at most F32_ERR_RATIO
    x the plain path's + 1e-3. The backward kernels must have run in the
    kernel run and in no other."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import transformer

    dev = torch.device("cuda")
    cfg = train_config()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = transformer.init(gen, cfg, dev)
    paths = sorted({p for ps in GRAD_GROUPS.values() for p in ps})

    def leaf(path):
        x = params
        for key in path:
            x = x[key]
        return x

    leaves = [leaf(p).requires_grad_() for p in paths]
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 2049)),
                             device=dev)
    runs = {"kernel": (cfg, None), "plain": (cfg, "reference"),
            "f32": (dataclasses.replace(cfg, dtype=torch.float32),
                    "reference")}
    loss, flat, launches = {}, {}, {}
    for name, (c, impl) in runs.items():
        zero(kernels)
        value = transformer.loss_fn(params, tokens, c, attn_impl=impl)
        grads = dict(zip(paths, torch.autograd.grad(value, leaves)))
        torch.cuda.synchronize()
        launches[name] = counts(kernels)
        loss[name] = value.item()
        flat[name] = {g: torch.cat([grads[p].float().flatten() for p in ps])
                      for g, ps in GRAD_GROUPS.items()}
        del grads
    for name, run_counts in launches.items():
        for k in kernels:
            want = cfg.n_layers if name == "kernel" else 0
            if k.symbol != "flash_attention_fwd_bf16" and \
                    run_counts[k.symbol] != want:
                fail(f"model grads, {name} run: {k.symbol} launched "
                     f"{run_counts[k.symbol]} times, expected {want}")
    rows = {}
    t = loss["f32"]
    for g in GRAD_GROUPS:
        k, p, f = (flat[x][g] for x in ("kernel", "plain", "f32"))
        if not all(torch.isfinite(x).all() for x in (k, p, f)):
            fail(f"model grads {g}: non-finite gradient")
        row = {"cosine": torch.nn.functional.cosine_similarity(
                   k, p, dim=0).item(),
               "kernel_norm": k.norm().item(),
               "kernel_rel_err_vs_f32": ((k - f).norm() / f.norm()).item(),
               "plain_rel_err_vs_f32": ((p - f).norm() / f.norm()).item()}
        rows[g] = row
        if row["kernel_norm"] == 0 or row["cosine"] < GRAD_COS_MIN \
                or row["kernel_rel_err_vs_f32"] > \
                F32_ERR_RATIO * row["plain_rel_err_vs_f32"] + 1e-3:
            fail(f"model grads {g}: {row}")
    loss_row = {"kernel": loss["kernel"], "plain": loss["plain"], "f32": t,
                "kernel_rel_err_vs_f32": abs(loss["kernel"] - t) / abs(t),
                "plain_rel_err_vs_f32": abs(loss["plain"] - t) / abs(t)}
    if not all(np.isfinite(v) for v in loss.values()) or \
            loss_row["kernel_rel_err_vs_f32"] > \
            F32_ERR_RATIO * loss_row["plain_rel_err_vs_f32"] + 1e-3:
        fail(f"model loss: {loss_row}")
    return {"model": "llama-3.2-1b random init, f32 params", "tokens": 2049,
            "cos_min": GRAD_COS_MIN, "f32_err_ratio": F32_ERR_RATIO,
            "loss": loss_row, "grads": rows, "launches": launches}


# ------------------------------------------------------------------ phase 6

def train(torch, kernels) -> dict:
    """The training path: make_train_step + adamw(1e-4, weight_decay=0.01)
    on Llama-3.2-1B, batch 4 x 2048, one warm-up step and 10 timed steps
    through benchmarks.train_step.measure. Launch counts are zeroed just
    before the timed steps and read just after."""
    import math

    from ray_tpu_torch.benchmarks.train_step import measure

    cfg = train_config()
    got = {}
    res = measure(cfg, batch=4, seq=2048, steps=10,
                  before_timed=lambda: zero(kernels),  # the main path starts
                  after_timed=lambda: got.update(counts(kernels)),
                  profile=True)
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"training losses not finite and falling: {losses}")
    L, steps = cfg.n_layers, res["steps"]
    # forward plus its recompute under remat, one dK/dV and one dQ per layer
    want = {"flash_attention_fwd_bf16": 2 * L * steps,
            "flash_attention_bwd_dkv_bf16": L * steps,
            "flash_attention_bwd_dq_bf16": L * steps,
            "ragged_paged_attention_bf16": 0}
    if got != want:
        fail(f"training launches {got}, expected {want}")
    res["launches"] = got
    res["config"] = {"model": "llama-3.2-1b (tied, random init)",
                     "n_layers": L, "d_model": cfg.d_model,
                     "vocab_size": cfg.vocab_size, "remat": cfg.remat,
                     "remat_policy": cfg.remat_policy}
    return res


# ------------------------------------------------------------------ phase 9

def check_vit(torch, kernels) -> dict:
    """ViT-L/16 at its published widths and depth, batch 8 x 224² (T =
    197, head_dim 64), random init from a seed with f32 params: forward
    logits and the gradient of every param from one ``loss_fn`` in bf16
    compute against f32 compute, by cosine (logits: LOGIT_COS_MIN, the
    whole gradient: GRAD_COS_MIN). T = 197 is no multiple of 64, so no
    flash kernel may launch."""
    import dataclasses

    from ray_tpu_torch.models import vit

    dev = torch.device("cuda")
    cfg = vit.vit_config("l16")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = vit.init(gen, cfg, dev)
    images = torch.randn((8, cfg.image_size, cfg.image_size, 3),
                         generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (8,), generator=gen,
                           device=dev)

    def flat(tree):
        for v in tree.values():
            yield from (flat(v) if isinstance(v, dict) else [v])

    leaves = [x.requires_grad_() for x in flat(params)]
    zero(kernels)  # the ViT path starts here
    logits, grads = {}, {}
    for name, dt in (("bf16", cfg.dtype), ("f32", torch.float32)):
        c = dataclasses.replace(cfg, dtype=dt)
        with torch.no_grad():
            logits[name] = vit.forward(params, images, c)
        loss = vit.loss_fn(params, (images, labels), c)
        grads[name] = torch.cat([g.float().flatten() for g in
                                 torch.autograd.grad(loss, leaves)])
    torch.cuda.synchronize()
    launches = counts(kernels)
    row = {"model": "vit-l/16 random init, f32 params", "batch": 8,
           "tokens": cfg.n_patches + 1, "head_dim": cfg.head_dim,
           "logits_cosine": cosine(torch, logits["bf16"], logits["f32"]),
           "grad_cosine": cosine(torch, grads["bf16"], grads["f32"]),
           "grad_norm": grads["bf16"].norm().item(),
           "cos_min": LOGIT_COS_MIN, "grad_cos_min": GRAD_COS_MIN,
           "launches": launches}
    if not all(torch.isfinite(x).all() for x in (*logits.values(),
                                                  *grads.values())):
        fail(f"vit: non-finite logits or gradients: {row}")
    if row["logits_cosine"] < LOGIT_COS_MIN or row["grad_norm"] == 0 \
            or row["grad_cosine"] < GRAD_COS_MIN:
        fail(f"vit: bf16 against f32: {row}")
    if any(launches.values()):
        fail(f"vit at T = 197 launched a flash kernel: {launches}")
    return row


def check_dispatch(torch, kernels) -> dict:
    """``transformer.forward`` with ``attn_impl=None`` on the card where the
    kernels fit and where they do not (Llama-3.2-1B widths and depth, f32
    params): T = 100 in bf16 and T = 128 in f32 take the dense path and
    launch nothing; T = 128 in bf16 launches the forward kernel once a
    layer. Each against the plain path by phase 3's bounds on the logits
    (cosine, max abs difference)."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import transformer

    dev = torch.device("cuda")
    cfg = train_config()
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              cfg, dev)
    rng = np.random.default_rng(SEED)
    rows = []
    for T, dt, want in ((100, torch.bfloat16, 0), (128, torch.float32, 0),
                        (128, torch.bfloat16, cfg.n_layers)):
        c = dataclasses.replace(cfg, dtype=dt)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, T)),
                                 device=dev)
        zero(kernels)  # this case's path starts here
        with torch.no_grad():
            auto, _ = transformer.forward(params, tokens, c)
            torch.cuda.synchronize()
            launches = counts(kernels)
            plain, _ = transformer.forward(params, tokens, c,
                                           attn_impl="reference")
        row = {"T": T, "dtype": str(dt).replace("torch.", ""),
               "launches": launches, "cosine": cosine(torch, auto, plain),
               "max_abs_diff": (auto.float() - plain.float()).abs().max()
               .item()}
        rows.append(row)
        if not torch.isfinite(auto.float()).all():
            fail(f"dispatch {row}: non-finite logits")
        if launches != {k.symbol: (want if k.symbol ==
                                   "flash_attention_fwd_bf16" else 0)
                        for k in kernels}:
            fail(f"dispatch {row}: expected {want} forward launches")
        if row["cosine"] < LOGIT_COS_MIN or row["max_abs_diff"] > \
                LOGIT_MAX_ABS:
            fail(f"dispatch {row}: against the plain path")
    return {"model": "llama-3.2-1b (tied, random init), attn_impl=None",
            "cos_min": LOGIT_COS_MIN, "max_abs_bound": LOGIT_MAX_ABS,
            "cases": rows}


# ----------------------------------------------------------------- phase 10

ENGINE_RUNS = ("paged", "slot", "gather", "prefix_chunk", "speculative",
               "lora", "guided")
ENGINE_MAX_TOKENS = 32
SHARED_PREFIX = 1024           # 16 full pages of 64
SUFFIXES = [60, 150, 280, 400]
LONG_PROMPT = 1500
PREFILL_CHUNK = 512
SPEC_K = 4
LORA_RANK = 8
EOS_ID = 128001                # the guided runs' stop token
CHOICES = [[9906, 1917], [9642, 11, 1314], [2822, 13, 21, 8]]
REGEX = "(ok|no)[0-9]+"        # over single-byte token ids


def engine_model_checks(torch, cfg, params) -> list[dict]:
    """The model functions of the engine's options at Llama-3-8B's width
    and depth, each path under test against the path it is held to (both
    bf16) and against an f32 run, under phase 3's bounds (``hold``); decode
    steps are teacher-forced from the f32 run:

    - chunked prefill: a 384-token first chunk (the flash kernel, bucket
      512) written with write_kv_pages, its 6 pages back through
      gather_prefix_pages padded to 8 with scratch page 0 (filled with
      noise, as inactive rows leave it; prefix_len masks it), the 616-token
      rest by prefill_with_prefix (last logits), activate_slot and 2 ragged
      decode steps, against whole-prompt prefill + insert_sequence_paged
      and the same steps;
    - the slot decode_step against decode_step_paged_ragged on the same
      prompt (2 steps);
    - verify_step's K = 5 logits, and the K rows of K and V it writes,
      against 5 successive slot decode_steps on the same tokens;
    - LoRA prefill and 2 decode_steps with a random rank-8 adapter against
      the adapter merged densely into wq and wv (the f32 run: merged in
      f32)."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import decoding as dec
    from ray_tpu_torch.models import decoding_paged as dp

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    P, S, n, head, K = 64, 2048, 1000, 384, SPEC_K + 1
    rng = np.random.default_rng(SEED + 10)
    toks = rng.integers(0, cfg.vocab_size, size=n).tolist()
    pages = np.arange(1, S // P + 1, dtype=np.int32)
    rows = []

    def tokens(t, bucket):
        x = np.zeros((1, bucket), np.int64)
        x[0, :len(t)] = t
        return torch.as_tensor(x, device=dev)

    def check(what, k, p, t):
        row = {"check": what, **logit_row(torch, what, k, p, t)}
        rows.append(row)
        hold(what, row)

    def paged(c):
        return dp.init_paged_state(c, 8, S, S // P + 1, P, dev)

    def slot(c):
        return dec.init_decode_state(c, 8, S, dev)

    def forced(states, logits32):
        nxt = torch.argmax(logits32).int().reshape(1).expand(8)
        for st in states:
            dec.commit_tokens(st, nxt)

    lg32, kv32 = dec.prefill(params, tokens(toks, 1024), n, cfg32,
                             attn_impl="reference")
    first = int(torch.argmax(lg32))
    lgw, kvw = dec.prefill(params, tokens(toks, 1024), n, cfg)
    st_c = paged(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    for pool in (st_c["kp"], st_c["vp"]):
        pool[:, 0] = torch.randn(pool[:, 0].shape, generator=gen, device=dev,
                                 dtype=pool.dtype)
    _, kv1 = dec.prefill(params, tokens(toks[:head], 512), head, cfg)
    dp.write_kv_pages(st_c, kv1, pages[:512 // P])
    ids = np.zeros((8,), np.int32)
    ids[:head // P] = pages[:head // P]
    k_pre, v_pre = dp.gather_prefix_pages(st_c["kp"], st_c["vp"], ids)
    lgc, kv2 = dp.prefill_with_prefix(params, tokens(toks[head:], 1024),
                                      k_pre, v_pre, head, n - head, cfg)
    dp.write_kv_pages(st_c, kv2, pages[head // P:])
    dp.activate_slot(st_c, 0, pages, n, first)
    del kv1, kv2, k_pre, v_pre
    check("prefill_with_prefix over gathered pages vs whole prefill", lgc,
          lgw, lg32)
    st32, st_w, st_s = paged(cfg32), paged(cfg), slot(cfg)
    dp.insert_sequence_paged(st32, 0, kv32, n, first, pages, cfg32)
    dp.insert_sequence_paged(st_w, 0, kvw, n, first, pages, cfg)
    dec.insert_sequence(st_s, 0, kvw, n, first, cfg)
    for step in range(2):
        bound = 1 << ((n + step) // P).bit_length()
        st32, l32 = dp.decode_step_paged_ragged(params, st32, cfg32, bound,
                                                impl="reference")
        st_w, lw = dp.decode_step_paged_ragged(params, st_w, cfg, bound)
        st_c, lc = dp.decode_step_paged_ragged(params, st_c, cfg, bound)
        st_s, ls = dec.decode_step(params, st_s, cfg)
        check(f"decode {step} after chunked prefill vs after whole prefill",
              lc[0], lw[0], l32[0])
        check(f"slot decode_step {step} vs decode_step_paged_ragged", ls[0],
              lw[0], l32[0])
        forced((st32, st_w, st_c, st_s), l32[0])
    del st32, st_w, st_c, st_s
    # verify_step: K inputs at once against K decode steps on the same tokens
    draft = np.zeros((8, K - 1), np.int32)
    draft[0] = rng.integers(0, cfg.vocab_size, size=K - 1)
    st_v, st_d, st_f = slot(cfg), slot(cfg), slot(cfg32)
    for st, kv, c in ((st_v, kvw, cfg), (st_d, kvw, cfg), (st_f, kv32, cfg32)):
        dec.insert_sequence(st, 0, kv, n, first, c)
    del kv32, kvw
    st_v, lv = dec.verify_step(params, st_v, draft, cfg, K)
    for j in range(K):
        st_d, ld = dec.decode_step(params, st_d, cfg)
        st_f, lf = dec.decode_step(params, st_f, cfg32)
        check(f"verify_step logits {j} vs slot decode_step {j}", lv[0, j],
              ld[0], lf[0])
        if j < K - 1:
            nxt = torch.full((8,), int(draft[0, j]), dtype=torch.int32,
                             device=dev)
            dec.commit_tokens(st_d, nxt)
            dec.commit_tokens(st_f, nxt)
    for name in ("k", "v"):  # the K rows each path wrote
        check(f"verify_step's written {name} rows vs the decode steps'",
              *(st[name][:, 0, n:n + K] for st in (st_v, st_d, st_f)))
    del st_v, st_d, st_f, lv
    # LoRA: a random adapter in the bank against it merged into wq and wv
    bank = dec.init_lora_bank(cfg, 1, LORA_RANK, dev)
    w = lora_adapter(torch, cfg, dev)
    for key, x in w.items():
        bank[key][:, 1] = x
    bank["scale"][1] = 1.0
    attn32, attn = {}, {}
    for key, a, b in (("wq", "A_q", "B_q"), ("wv", "A_v", "B_v")):
        base = params["layers"]["attn"][key]
        attn32[key] = base.float() + torch.einsum(
            "ler,lrhd->lehd", w[a].float(), w[b].float())
        attn[key] = attn32[key].to(base.dtype)

    def merged(new):
        layers = params["layers"]
        return {**params, "layers": {**layers,
                                     "attn": {**layers["attn"], **new}}}

    m_bf16, m_f32 = merged(attn), merged(attn32)
    lgl, kvl = dec.prefill(params, tokens(toks, 1024), n, cfg,
                           lora_bank=bank, lora_idx=1)
    lgm, kvm = dec.prefill(m_bf16, tokens(toks, 1024), n, cfg)
    lgf, kvf = dec.prefill(m_f32, tokens(toks, 1024), n, cfg32,
                           attn_impl="reference")
    check("LoRA prefill vs the adapter merged into wq, wv", lgl, lgm, lgf)
    first = int(torch.argmax(lgf))
    st_l, st_m, st_f = slot(cfg), slot(cfg), slot(cfg32)
    for st, kv, c in ((st_l, kvl, cfg), (st_m, kvm, cfg), (st_f, kvf, cfg32)):
        dec.insert_sequence(st, 0, kv, n, first, c)
    del kvl, kvm, kvf
    slot_lora = torch.zeros((8,), dtype=torch.int64, device=dev)
    slot_lora[0] = 1
    for step in range(2):
        st_l, ll = dec.decode_step(params, st_l, cfg, bank, slot_lora)
        st_m, lm = dec.decode_step(m_bf16, st_m, cfg)
        st_f, lf = dec.decode_step(m_f32, st_f, cfg32)
        check(f"LoRA decode_step {step} vs the merged adapter", ll[0], lm[0],
              lf[0])
        forced((st_l, st_m, st_f), lf[0])
    return rows


def lora_adapter(torch, cfg, device) -> dict:
    """A rank-8 adapter of normal(0, 0.02) factors from a seed, layer-
    stacked as load_lora takes it, in cfg.dtype on `device`."""
    L, E, H, Hkv, Dh = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                        cfg.head_dim)
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    shapes = {"A_q": (L, E, LORA_RANK), "B_q": (L, LORA_RANK, H, Dh),
              "A_v": (L, E, LORA_RANK), "B_v": (L, LORA_RANK, Hkv, Dh)}
    return {k: (torch.randn(s, generator=g) * 0.02).to(device, cfg.dtype)
            for k, s in shapes.items()}


def engine_run(torch, kernels, cfg, params, name: str, options: dict, drive,
               prepare=None) -> dict:
    """One LLMEngine (8 slots, max_len 2048, page 64) on the shared params:
    `prepare(eng)` first, then the launch counts are zeroed, `drive(eng)`
    serves the run's traffic and returns (outputs, extra), and the counts
    are read. Every output must be a non-empty list of valid ids."""
    from ray_tpu_torch.llm import LLMEngine

    eng = LLMEngine(cfg, params, max_slots=8, max_len=2048, page_size=64,
                    seed=SEED, **options)
    try:
        if prepare is not None:
            prepare(eng)
        torch.cuda.synchronize()
        zero(kernels)  # this run's path starts here
        t0 = time.perf_counter()
        outs, extra = drive(eng)
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        st = eng.stats()
    finally:
        eng.shutdown()
    for i, out in enumerate(outs):
        if not out or not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"engine {name}: request {i} gave {out[:8]}")
    spec = st.get("speculative", {})
    steps = st["decode_steps"] + spec.get("steps", 0)
    prefills = st["prefills"] + st["prefix_prefills"]
    tokens = sum(len(o) for o in outs)
    return {"run": name, "options": options, "requests": len(outs),
            "tokens_out": tokens, "wall_s": wall,
            "prefill_ms_mean": 1e3 * st["prefill_seconds"] / prefills,
            "step": "verify" if spec else "decode",
            "step_ms_mean": 1e3 * st["decode_seconds"] / steps,
            "tokens_per_s": tokens / wall, "launches": launches,
            "stats": st, "extra": extra, "outs": outs}


def serve_options(torch, kernels, card: str, cfg, params) -> dict:
    """Phase 10: Llama-3-8B at full width and depth (bf16, random weights
    from a seed, built once by the caller), the model checks of
    ``engine_model_checks``,
    then one LLMEngine a run on those params (ENGINE_RUNS), each shut down
    before the next. Per run, the launch counts are zeroed just before its
    traffic and read just after, and must be exactly: flash forward =
    layers x decode.prefill calls (whole prompts and first chunks; the
    count of those calls is itself asserted), ragged = layers x decode
    steps on the paged ragged runs and 0 elsewhere, no backward kernel."""
    import re

    import numpy as np

    from ray_tpu_torch.llm import GuidedFSM, SamplingParams

    checks = engine_model_checks(torch, cfg, params)
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "engine_model_checks": checks}),
          flush=True)
    V, L = cfg.vocab_size, cfg.n_layers
    greedy = SamplingParams(max_tokens=ENGINE_MAX_TOKENS)
    runs = {}

    def prompts(lengths, seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, V, size=n).tolist() for n in lengths]

    def serve_all(ps, sp=greedy):
        def drive(eng):
            reqs = [eng.submit(p, sp) for p in ps]
            return [list(r) for r in reqs], {}
        return drive

    def run(name, options, drive, prepare=None, *, prefills, ragged,
            full=True):
        row = engine_run(torch, kernels, cfg, params, name, options, drive,
                         prepare)
        shown = row["outs"] if name == "guided" else [o[:8]
                                                      for o in row["outs"]]
        print(json.dumps({"card": card, "engine_run": {**row, "outs": shown}}),
              flush=True)
        st = row["stats"]
        want = {k.symbol: 0 for k in kernels}
        want["flash_attention_fwd_bf16"] = L * st["prefills"]
        want["ragged_paged_attention_bf16"] = \
            L * st["decode_steps"] if ragged else 0
        if row["launches"] != want or st["ragged_kernel"] != ragged:
            fail(f"engine {name}: launches {row['launches']}, expected "
                 f"{want} (ragged kernel {st['ragged_kernel']})")
        if st["prefills"] != prefills:
            fail(f"engine {name}: {st['prefills']} prefill calls, expected "
                 f"{prefills}")
        if full and any(len(o) != ENGINE_MAX_TOKENS for o in row["outs"]):
            fail(f"engine {name}: output lengths "
                 f"{[len(o) for o in row['outs']]}")
        runs[name] = row
        print(f"engine {name} on {card}: prefill {row['prefill_ms_mean']:.3f}"
              f" ms mean, {row['step']} step {row['step_ms_mean']:.3f} ms "
              f"mean, {row['tokens_per_s']:.1f} tokens/s", flush=True)
        return row

    lengths = prompts(SERVE_LENGTHS, SEED + 1)
    first = [o[0] for o in run("paged", {"kv_layout": "paged"},
                               serve_all(lengths), prefills=8,
                               ragged=True)["outs"]]
    for name, options in (("slot", {"kv_layout": "slot"}),
                          ("gather", {"kv_layout": "paged",
                                      "attn_impl": "gather"})):
        got = [o[0] for o in run(name, options, serve_all(lengths),
                                 prefills=8, ragged=False)["outs"]]
        if got != first:
            fail(f"engine {name}: first tokens {got} != the paged run's "
                 f"{first}")

    # prefix cache + chunked prefill
    rng = np.random.default_rng(SEED + 2)
    shared = rng.integers(0, V, size=SHARED_PREFIX).tolist()
    pc = [shared + rng.integers(0, V, size=n).tolist() for n in SUFFIXES]
    pc.append(rng.integers(0, V, size=LONG_PROMPT).tolist())

    def drive_prefix(eng):
        it = iter(eng.submit(pc[0], greedy))
        head = [next(it)]  # its chunks registered the shared blocks
        reqs = [eng.submit(p, greedy) for p in pc[1:]]
        return [head + list(it)] + [list(r) for r in reqs], {}

    staged = [-(-len(p) // PREFILL_CHUNK) for p in (pc[0], pc[-1])]
    row = run("prefix_chunk", {"kv_layout": "paged",
                               "enable_prefix_cache": True,
                               "prefill_chunk": PREFILL_CHUNK},
              drive_prefix, prefills=2, ragged=True)
    st, cache = row["stats"], row["stats"]["prefix_cache"]
    got = {"hits": cache["hits"], "misses": cache["misses"],
           "tokens_reused": cache["tokens_reused"],
           "prefill_chunks_run": st["prefill_chunks_run"],
           "prefix_prefills": st["prefix_prefills"],
           "pages_back": st["free_pages"] + cache["reclaimable_pages"]}
    want = {"hits": 3, "misses": 2, "tokens_reused": 3 * SHARED_PREFIX,
            "prefill_chunks_run": sum(staged),
            "prefix_prefills": 3 + sum(staged) - 2,
            "pages_back": st["num_pages"] - 1}
    if got != want:
        fail(f"engine prefix_chunk: {got}, expected {want}")

    # speculative decoding on the slot layout. The repetitive prompt is one
    # token repeated: random weights continue neither a repeated 64-token
    # pattern nor their own greedy text, but after a constant context
    # their greedy output falls into a short cycle the drafts then predict
    sp_prompts = [[int(rng.integers(0, V))] * 1000] + prompts(
        [300, 700, 1300], SEED + 3)

    def drive_spec(eng):
        reqs = [eng.submit(p, greedy) for p in sp_prompts]
        outs = [list(r) for r in reqs]
        return outs, {"accepted_by_request": [r.accepted for r in reqs]}

    row = run("speculative", {"kv_layout": "slot", "speculative_k": SPEC_K},
              drive_spec, prefills=4, ragged=False)
    if row["extra"]["accepted_by_request"][0] <= 0:
        fail(f"engine speculative: no draft accepted on the repetitive row "
             f"({row['extra']}, {row['stats']['speculative']})")

    # LoRA: no adapter, a zero adapter and a random one in one batch
    rand = {k: v.float().cpu().numpy()
            for k, v in lora_adapter(torch, cfg, "cpu").items()}
    zeros = {k: np.zeros_like(v) for k, v in rand.items()}

    def prepare_lora(eng):
        eng.load_lora("zero", zeros)
        eng.load_lora("rand", rand)

    def drive_lora(eng):
        loaded = eng.list_loras()
        reqs = [eng.submit(lengths[3], greedy, lora=x)
                for x in (None, "zero", "rand")]
        try:
            eng.unload_lora("rand")
        except RuntimeError:
            refused = True
        else:
            refused = False
        outs = [list(r) for r in reqs]
        eng.unload_lora("rand")
        eng.unload_lora("zero")
        return outs, {"loaded": loaded, "unload_refused_while_live": refused,
                      "after_unload": eng.list_loras()}

    row = run("lora", {"kv_layout": "slot", "max_loras": 2,
                       "lora_rank": LORA_RANK}, drive_lora, prepare_lora,
              prefills=3, ragged=False)
    outs, extra = row["outs"], row["extra"]
    if outs[1] != outs[0] or extra != {
            "loaded": ["rand", "zero"], "unload_refused_while_live": True,
            "after_unload": []}:
        fail(f"engine lora: zero adapter {outs[1][:8]} vs none "
             f"{outs[0][:8]}; {extra}")

    # guided decoding on the paged layout, greedy and at temperature 1
    choice = GuidedFSM.from_choices(CHOICES, V, EOS_ID)
    regex = GuidedFSM.from_regex(REGEX, V, EOS_ID)
    g_prompts = prompts([40, 90, 200, 500], SEED + 5)
    kinds = ["choice", "regex", "free", "free"] * 2

    def drive_guided(eng):
        reqs = []
        for temp in (0.0, 1.0):
            for fsm, p in zip((choice, regex, None, None), g_prompts):
                reqs.append(eng.submit(p, SamplingParams(
                    max_tokens=ENGINE_MAX_TOKENS, temperature=temp,
                    stop_token_ids=(EOS_ID,) if fsm else (), guided=fsm)))
        return [list(r) for r in reqs], {"kinds": kinds}

    row = run("guided", {"kv_layout": "paged"}, drive_guided, prefills=8,
              ragged=True, full=False)
    for kind, out in zip(kinds, row["outs"]):
        ended = len(out) < ENGINE_MAX_TOKENS  # stopped on EOS
        ok = {"choice": ended and out in CHOICES,
              "regex": ended and re.fullmatch(
                  REGEX, "".join(chr(t) for t in out)) is not None,
              "free": len(out) == ENGINE_MAX_TOKENS}[kind]
        if not ok:
            fail(f"engine guided: a {kind} row gave {out}")
    return {name: row["launches"] for name, row in runs.items()}


# ----------------------------------------------------------------- phase 12

PD_LONG = 1300          # prompts at least this long sweep 32 pages a step
PD_LONG_TOKENS = 128    # their new tokens: they outlive the other rows
PD_WAIT_S = 120.0


def page_hash(torch, t, w):
    """Exact fingerprint of a page's bytes on the card: its int16 words
    times fixed random int64 weights, summed modulo 2**64 (order-free, so
    equal bytes give equal values)."""
    x = t.contiguous().view(torch.int16).flatten().to(torch.int64)
    return (x * w[:x.numel()]).sum()


def wait_for(pred, what: str, timeout_s: float = PD_WAIT_S) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout_s} s waiting for {what}")
        time.sleep(0.002)


def plane_stages(torch, kv, page_size: int, depth: int) -> dict:
    """The transfer plane's stages for one prefilled bucket, one after the
    other on this thread (no sender, puller or engine thread competing),
    host clock in ms: device-to-host copy of K and V, slicing the pages
    contiguous, copying each message into a channel, reading each back
    with a clone, and copying the pages to the card."""
    from ray_tpu_torch.experimental.channel.mutable_shm import (
        create_mutable_channel)
    from ray_tpu_torch.llm import kv_transfer as kt

    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return out

    k, v = timed("d2h", lambda: (kv["k"].cpu(), kv["v"].cpu()))
    n = k.shape[1] // page_size
    kps, vps = timed("slice", lambda: kt._pages(k, v, 0, n, page_size))
    ch = create_mutable_channel(depth * (k.nbytes + v.nbytes) // n
                                + kt._WIRE_SLACK)
    try:
        ms["channel_write"] = ms["read_clone"] = 0.0
        pages = []
        for i in range(0, n, depth):
            t0 = time.perf_counter()
            ch.write_vectored(kt._pack_page_message(
                i, kps[i:i + depth], vps[i:i + depth]), timeout=0)
            t1 = time.perf_counter()
            view = ch.read_view(timeout=0)
            pages += kt._copy_pages(*kt._unpack_page_view(view))
            del view
            ch.ack_read()
            ms["channel_write"] += 1e3 * (t1 - t0)
            ms["read_clone"] += 1e3 * (time.perf_counter() - t1)
    finally:
        ch.close()
        ch.unlink()
    dev = kv["k"].device
    timed("h2d", lambda: [(kp.to(dev), vp.to(dev)) for _i, kp, vp in pages])
    nbytes = k.nbytes + v.nbytes
    return {"pages": n, "bytes": nbytes, "ms": ms,
            "gb_per_s": {name: nbytes / t / 1e6 for name, t in ms.items()}}


def pd_handoff(torch, kernels, card, cfg, params, prompts, max_tokens, ek,
               want) -> dict:
    """12a: prefill → export → batched pull → streamed admission, against
    the monolithic run's tokens `want`. Returns the run's numbers and the
    solo prefill logits (12b's reference)."""
    import glob
    import shutil

    from ray_tpu_torch._private.constants import SHM_CHANNEL_GLOB, SHM_DIR
    from ray_tpu_torch.llm import LLMEngine, PDConfig, SamplingParams
    from ray_tpu_torch.llm.engine import bucket_for
    from ray_tpu_torch.llm.kv_transfer import (BatchedKVPuller, KVPageStream,
                                               PagedKVExporter)
    from ray_tpu_torch.models import decoding
    from ray_tpu_torch.models import decoding_paged as dp

    dev = torch.device("cuda")
    pd = PDConfig()
    L, P = cfg.n_layers, ek["page_size"]
    page_bytes = 2 * L * P * cfg.kv_heads * cfg.head_dim * 2  # K + V, bf16
    chan_bytes = pd.prefetch_depth * page_bytes + 8192 + 64
    usage = shutil.disk_usage(SHM_DIR)
    print(json.dumps({"card": card, "dev_shm": {
        "total": usage.total, "used": usage.used, "free": usage.free,
        "channel_bytes": chan_bytes}}), flush=True)
    if usage.free < chan_bytes:
        fail(f"{SHM_DIR} has {usage.free} bytes free; one KV transfer "
             f"channel needs {chan_bytes} ({pd.prefetch_depth} pages of "
             f"{page_bytes} bytes + framing)")
    wave = int(min(len(prompts), usage.free // chan_bytes))
    # the long rows first, alone, active before the others arrive
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    n_long = sum(len(p) >= PD_LONG for p in prompts)
    groups = [part[i:i + wave] for part in (order[:n_long], order[n_long:])
              for i in range(0, len(part), wave)]
    shm_before = set(glob.glob(SHM_CHANNEL_GLOB))
    w = torch.randint(-2 ** 62, 2 ** 62, (L * P * cfg.kv_heads * cfg.head_dim,),
                      dtype=torch.int64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    adopted = []
    real_write = dp.write_kv_pages

    def write_and_hash(state, kv, pages):
        real_write(state, kv, pages)
        for pid in list(pages)[:kv["k"].shape[1] // P]:
            adopted.append(torch.stack([page_hash(torch, state[x][:, pid], w)
                                        for x in ("kp", "vp")]))
        return state

    dec = LLMEngine(cfg, params, **ek)
    exporter = PagedKVExporter(send_timeout_s=pd.transfer_timeout_s,
                               prefetch_pages=pd.prefetch_depth)
    puller = BatchedKVPuller()
    dp.write_kv_pages = write_and_hash
    try:
        torch.cuda.synchronize()
        zero(kernels)  # the PD path starts here
        t_start = time.perf_counter()
        kvs, firsts, solo, exported = [], [], [], []
        for p in prompts:
            bucket = bucket_for(len(p), ek["min_bucket"], ek["max_len"])
            toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
            toks[0, :len(p)] = torch.as_tensor(p, device=dev)
            logits, kv = decoding.prefill(params, toks, len(p), cfg)
            solo.append(logits)
            firsts.append(int(torch.argmax(logits)))
            kvs.append(kv)
            exported += [torch.stack([page_hash(torch, kv[x][:, i * P:(i + 1)
                                                             * P], w)
                                      for x in ("k", "v")])
                         for i in range(bucket // P)]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t_start
        prefill_launches = counts(kernels)
        reqs, export_ms, t_pull = {}, {}, {}
        plane_s, streamed = 0.0, [0, 0.0]
        for gi, group in enumerate(groups):
            t_group = time.time()
            st0 = dec.stats()  # the wave's export and transfer start here
            tickets = {}
            for i in group:
                t0 = time.perf_counter()
                tickets[i] = exporter.export(kvs[i]["k"], kvs[i]["v"],
                                             len(prompts[i]), firsts[i], P)
                export_ms[i] = 1e3 * (time.perf_counter() - t0)
            streams = {}
            for i in group:
                t = tickets[i]
                streams[i] = KVPageStream(t["n_pages"], t["page_size"])
                t_pull[i] = time.time()
                puller.pull(t, streams[i], timeout_s=pd.transfer_timeout_s)
                reqs[i] = dec.submit_prefilled(
                    length=t["length"], first_token=t["first_token"],
                    params=SamplingParams(max_tokens=max_tokens[i]),
                    kv_stream=streams[i])
            def landed():
                for i, s in streams.items():
                    if s.take_error() is not None:
                        fail(f"pd: transfer of prompt {len(prompts[i])}: "
                             f"{s.take_error()!r}")
                return all(s.finished_ts for s in streams.values())

            wait_for(landed, f"the pages of wave {gi}")
            plane_s += max(s.finished_ts for s in streams.values()) - t_group
            st1 = dec.stats()
            if st0["active"]:  # decode steps taken while it streamed
                streamed[0] += st1["decode_steps"] - st0["decode_steps"]
                streamed[1] += st1["decode_seconds"] - st0["decode_seconds"]
            wait_for(lambda: all(reqs[i].admitted_ts for i in group),
                     f"the rows of wave {gi} to activate")
            wait_for(lambda: exporter.pending() == 0,
                     f"wave {gi}'s channels to retire")
        st_idle = dec.stats()
        outs = [[firsts[i]] + list(reqs[i]) for i in range(len(prompts))]
        wall = time.perf_counter() - t_start
        launches = counts(kernels)
        st = dec.stats()
    finally:
        dp.write_kv_pages = real_write
        exporter.teardown()
        puller.teardown()
        dec.shutdown()
    stages = plane_stages(torch, kvs[order[0]], P, pd.prefetch_depth)
    del kvs
    wait_for(lambda: not set(glob.glob(SHM_CHANNEL_GLOB)) - shm_before,
             "the transfer segments to be unlinked", 10.0)
    if outs != want:
        bad = [i for i, (a, b) in enumerate(zip(outs, want)) if a != b]
        fail(f"pd: prompts {[len(prompts[i]) for i in bad]} decode "
             f"{[outs[i][:8] for i in bad]}, the monolithic engine "
             f"{[want[i][:8] for i in bad]}")
    adopted = sorted(tuple(h.tolist()) for h in adopted)
    exported = sorted(tuple(h.tolist()) for h in exported)
    if adopted != exported:
        fail(f"pd: the {len(adopted)} adopted pool pages differ from the "
             f"{len(exported)} exported pages")
    flash, ragged = "flash_attention_fwd_bf16", "ragged_paged_attention_bf16"
    want_launches = {k.symbol: 0 for k in kernels}
    want_launches[flash] = L * len(prompts)
    want_launches[ragged] = L * st["decode_steps"]
    if launches != want_launches or prefill_launches[flash] != launches[flash] \
            or st["prefills"] or not st["ragged_kernel"]:
        fail(f"pd: launches {launches} (after the prefills "
             f"{prefill_launches}), expected {want_launches} and no flash "
             f"launch in the decode engine ({st['prefills']} prefills)")
    n_pages = len(exported)
    idle_steps = st["decode_steps"] - st_idle["decode_steps"]
    row = {
        "prompt_lengths": [len(p) for p in prompts],
        "max_tokens": max_tokens, "waves": groups, "pages": n_pages,
        "page_bytes": page_bytes, "bytes": n_pages * page_bytes,
        "plane_gb_per_s": n_pages * page_bytes / plane_s / 1e9,
        "plane_s": plane_s, "prefill_s": prefill_s,
        "export_ms": [export_ms[i] for i in range(len(prompts))],
        "pull_adopt_ms": [1e3 * (reqs[i].admitted_ts - t_pull[i])
                          for i in range(len(prompts))],
        "decode_steps": st["decode_steps"],
        "decode_step_ms_streaming": (1e3 * streamed[1] / streamed[0]
                                     if streamed[0] else None),
        "decode_steps_streaming": streamed[0],
        "decode_step_ms_idle_stream": (
            1e3 * (st["decode_seconds"] - st_idle["decode_seconds"])
            / idle_steps if idle_steps else None),
        "decode_steps_idle_stream": idle_steps,
        "decode_step_ms_mean": 1e3 * st["decode_seconds"] / st["decode_steps"],
        "wall_s": wall, "tokens_out": sum(len(o) for o in outs),
        "plane_stages_longest_prompt": stages,
        "launches": launches, "tokens_exact": True,
        "pages_byte_exact": True, "shm_leaked": 0}
    return row, solo


def pd_coalesced(torch, kernels, card, cfg, params, prompts, ek,
                 solo) -> dict:
    """12b: the 8 prompts from 8 threads into one PrefillCoalescer; each
    row held to the solo prefill and an f32 run under phase 3's bounds."""
    import dataclasses
    import threading

    from ray_tpu_torch.llm import PDConfig
    from ray_tpu_torch.llm.pd import PrefillCoalescer
    from ray_tpu_torch.models import decoding

    dev = torch.device("cuda")
    pd = PDConfig()
    co = PrefillCoalescer(params, cfg, min_bucket=ek["min_bucket"],
                          max_len=ek["max_len"],
                          max_batch=pd.prefill_batch_max,
                          window_s=pd.prefill_batch_window_s)
    res: list = [None] * len(prompts)

    def run(i):
        try:
            res[i] = co.prefill(prompts[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            res[i] = e

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    torch.cuda.synchronize()
    zero(kernels)  # the coalesced prefill path starts here
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=PD_WAIT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(kernels)
    co.teardown()
    if any(t.is_alive() for t in threads):
        fail("pd coalescer: a prefill thread did not return")
    errors = [r for r in res if isinstance(r, BaseException)]
    if errors:
        fail(f"pd coalescer: {errors[0]!r}")
    flash = "flash_attention_fwd_bf16"
    want = {k.symbol: 0 for k in kernels}
    want[flash] = cfg.n_layers * co.batches
    if co.jobs != len(prompts) or launches != want:
        fail(f"pd coalescer: {co.jobs} jobs in {co.batches} batches, "
             f"launches {launches}, expected {want}")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    rows = []
    for i, p in enumerate(prompts):
        logits, _k, _v, bucket = res[i]
        toks = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
        toks[0, :len(p)] = torch.as_tensor(p, device=dev)
        f32, _ = decoding.prefill(params, toks, len(p), cfg32,
                                  attn_impl="reference")
        row = {"prompt": len(p), "bucket": bucket,
               **logit_row(torch, f"pd coalesced row {i}", logits, solo[i],
                           f32),
               "bit_identical_to_solo": bool(torch.equal(logits, solo[i])),
               "first_token_agrees": int(torch.argmax(logits))
               == int(torch.argmax(solo[i]))}
        hold(f"pd coalesced prefill row of prompt {len(p)} vs solo prefill",
             row)
        rows.append(row)
        del f32
    return {"batches": co.batches, "jobs": co.jobs,
            "max_batch": co.max_batch, "window_s": co.window_s,
            "wall_s": wall, "launches": launches, "rows": rows}


def serve_pd(torch, kernels, card: str, cfg, params) -> dict:
    """Phase 12 on phase 10's model: the monolithic reference run, 12a and
    12b. Returns each path's launch counts."""
    import numpy as np

    from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
    from ray_tpu_torch.llm.pd import _pd_engine_kwargs

    t_phase = time.perf_counter()
    ek = _pd_engine_kwargs(LLMConfig(engine_kwargs={
        "max_slots": 8, "max_len": 2048, "seed": SEED}))
    rng = np.random.default_rng(SEED + 1)  # phase 4's prompts
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in SERVE_LENGTHS]
    max_tokens = [PD_LONG_TOKENS if len(p) >= PD_LONG else 32
                  for p in prompts]
    order = sorted(range(len(prompts)), key=lambda i: -len(prompts[i]))
    mono = LLMEngine(cfg, params, **ek)
    try:
        torch.cuda.synchronize()
        zero(kernels)
        t0 = time.perf_counter()
        reqs = {i: mono.submit(prompts[i], SamplingParams(
            max_tokens=max_tokens[i])) for i in order}
        want = [list(reqs[i]) for i in range(len(prompts))]
        mono_wall = time.perf_counter() - t0
        mono_launches = counts(kernels)
        st = mono.stats()
    finally:
        mono.shutdown()
    expect = {k.symbol: 0 for k in kernels}
    expect["flash_attention_fwd_bf16"] = cfg.n_layers * st["prefills"]
    expect["ragged_paged_attention_bf16"] = cfg.n_layers * st["decode_steps"]
    if mono_launches != expect or [len(o) for o in want] != max_tokens:
        fail(f"pd monolithic run: launches {mono_launches}, expected "
             f"{expect}; lengths {[len(o) for o in want]}")
    handoff, solo = pd_handoff(torch, kernels, card, cfg, params, prompts,
                               max_tokens, ek, want)
    print(json.dumps({"card": card, "pd_handoff": handoff}), flush=True)
    print(f"pd handoff on {card}: {handoff['pages']} pages, "
          f"{handoff['bytes']} bytes, plane {handoff['plane_gb_per_s']:.3f} "
          f"GB/s; export {np.mean(handoff['export_ms']):.3f} ms and "
          f"pull/adopt {np.mean(handoff['pull_adopt_ms']):.3f} ms a request "
          f"(mean); decode step {handoff['decode_step_ms_streaming']} ms "
          f"while transfers stream, {handoff['decode_step_ms_idle_stream']} "
          f"ms after; monolithic decode step "
          f"{1e3 * st['decode_seconds'] / st['decode_steps']:.3f} ms; one "
          f"bucket's stages alone (ms): "
          f"{handoff['plane_stages_longest_prompt']['ms']}", flush=True)
    coalesced = pd_coalesced(torch, kernels, card, cfg, params, prompts, ek,
                             solo)
    print(json.dumps({"card": card, "pd_coalesced_prefill": coalesced}),
          flush=True)
    print(f"pd coalesced prefill on {card}: {coalesced['jobs']} prompts in "
          f"{coalesced['batches']} batches, "
          f"{sum(r['bit_identical_to_solo'] for r in coalesced['rows'])} "
          f"rows bit-identical to solo, "
          f"{sum(r['first_token_agrees'] for r in coalesced['rows'])} first "
          f"tokens agree; phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"pd_monolithic": mono_launches, "pd_handoff": handoff["launches"],
            "pd_coalesced_prefill": coalesced["launches"],
            "monolithic": {"wall_s": mono_wall, "stats": st}}


# ----------------------------------------------------------------- phase 11

TP = 2
HOLD_PROMPT, HOLD_BUCKET = 1000, 1024


def mesh_train(torch, kernels) -> dict:
    """11a: a world of one over NCCL. Llama-3.2-1B (phase 6's config, batch
    4 x 2048) takes 3 steps through the meshed make_train_step, then 3
    through the unmeshed step from the same params and batch; both must
    agree bit for bit."""
    import datetime
    import functools
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.benchmarks.train_step import LR, WEIGHT_DECAY
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.parallel import MeshSpec, collectives

    dev = torch.device("cuda")
    cfg = train_config()
    steps, batch, seq = 3, 4, 2048
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          size=(batch, seq + 1)), device=dev)

    def loss_fn(p, b):
        return transformer.loss_fn(p, b, cfg)

    factory = functools.partial(tr.adamw, learning_rate=LR,
                                weight_decay=WEIGHT_DECAY)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = MeshSpec().build()
        backend = dist.get_backend()
        step, shard_params, batch_sharding = tr.make_train_step(
            loss_fn, factory, mesh=mesh,
            logical_axes=transformer.logical_axes(cfg))
        params = shard_params(transformer.init(
            torch.Generator(device=dev).manual_seed(SEED), cfg, dev))
        state = factory(params)
        local = batch_sharding.shard(tokens)
        torch.cuda.synchronize()
        zero(kernels)  # the meshed path starts here
        collectives.calls.clear()
        meshed_losses, step_ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, loss = step(params, state, local)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            meshed_losses.append(loss)
        launches = counts(kernels)
        calls = dict(collectives.calls)
        meshed = [p.detach() for p in tr.param_leaves(params)]
        del state, params
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              cfg, dev)
    opt = tr.adamw(params, LR, weight_decay=WEIGHT_DECAY)
    plain_step = tr.make_train_step(loss_fn, opt)
    plain_losses, plain_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, _, loss = plain_step(params, opt.state, tokens)
        torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t0))
        plain_losses.append(loss)
    loss_diff = max(abs(a.item() - b.item())
                    for a, b in zip(meshed_losses, plain_losses))
    param_diff = max((a.float() - b.detach().float()).abs().max().item()
                     for a, b in zip(meshed, tr.param_leaves(params)))
    del meshed, params, opt
    torch.cuda.empty_cache()
    if loss_diff != 0.0 or param_diff != 0.0:
        fail(f"meshed step (world of one) vs unmeshed: max loss diff "
             f"{loss_diff}, max param diff {param_diff}; the bound is 0")
    L = cfg.n_layers
    per_step = {k: n / steps for k, n in launches.items()}
    want = {"flash_attention_fwd_bf16": 2 * L,
            "flash_attention_bwd_dkv_bf16": L,
            "flash_attention_bwd_dq_bf16": L,
            "ragged_paged_attention_bf16": 0}
    if per_step != want:
        fail(f"meshed step launches per step {per_step}, expected phase "
             f"6's {want}")
    calls_per_step = {k: n / steps for k, n in calls.items()}
    if not calls_per_step or min(calls_per_step.values()) <= 0:
        fail(f"meshed step issued no collective: {calls}")
    return {"backend": backend, "mesh": "MeshSpec() world of one",
            "model": "llama-3.2-1b (tied, random init)", "batch": batch,
            "seq": seq, "steps": steps,
            "losses": [x.item() for x in meshed_losses],
            "max_loss_diff": loss_diff, "max_param_diff": param_diff,
            "bound": 0.0, "launches": launches,
            "launches_per_step": per_step,
            "collective_calls_per_step": calls_per_step,
            # host clock, a sync after each step; the first step also
            # creates the NCCL communicators and the AdamW state
            "meshed_step_ms": step_ms, "unmeshed_step_ms": plain_ms}


def hold_rows(torch, params, cfg, impl, forced=None):
    """Logits [3, V] (f32, on the host) of a HOLD_PROMPT-token prefill at
    bucket HOLD_BUCKET and 2 ragged paged decode steps, the decode inputs
    teacher-forced with `forced` (default: this run's own argmax). The
    pool has the head counts of `params` (a tensor-parallel rank's, under
    its mesh). Returns (rows, the tokens fed)."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import decoding, transformer
    from ray_tpu_torch.models import decoding_paged as dp

    dev = params["embed"].device
    H, Hkv = transformer.local_heads(params)
    state_cfg = dataclasses.replace(cfg, n_heads=H, n_kv_heads=Hkv,
                                    d_head=cfg.head_dim)
    P, max_len = 64, 2048
    rng = np.random.default_rng(SEED + 11)
    padded = np.zeros((1, HOLD_BUCKET), np.int64)
    padded[0, :HOLD_PROMPT] = rng.integers(0, cfg.vocab_size,
                                           size=HOLD_PROMPT)
    logits, kv = decoding.prefill(params, torch.as_tensor(padded, device=dev),
                                  HOLD_PROMPT, cfg, attn_impl=impl)
    rows, fed = [logits], []
    nxt = int(torch.argmax(logits)) if forced is None else forced[0]
    state = dp.init_paged_state(state_cfg, 8, max_len, max_len // P + 1, P,
                                dev)
    dp.insert_sequence_paged(state, 0, kv, HOLD_PROMPT, nxt,
                             np.arange(1, max_len // P + 1, dtype=np.int32),
                             cfg)
    fed.append(nxt)
    for step in range(2):
        bound = 1 << ((HOLD_PROMPT + step) // P).bit_length()
        state, lg = dp.decode_step_paged_ragged(params, state, cfg, bound,
                                                impl=impl)
        rows.append(lg[0])
        if step == 0:
            nxt = int(torch.argmax(lg[0])) if forced is None else forced[1]
            fed.append(nxt)
            decoding.commit_tokens(state, torch.full(
                (8,), nxt, dtype=torch.int32, device=dev))
    out = torch.stack([r.float() for r in rows]).cpu()
    del state, kv
    return out, fed


def tp_serve_rank(forced, lengths):
    """One rank of 11b: Llama-3-8B's tensor-parallel cut (tp = 2) from the
    seed-0 weights, the hold rows teacher-forced with `forced`, then
    LLMEngine.from_config(mesh=tp 2) serving phase 4's prompts."""
    import numpy as np
    import torch

    from ray_tpu_torch.llm import (LLMConfig, LLMEngine, ModelLoadingConfig,
                                   SamplingParams)
    from ray_tpu_torch.llm.engine import shard_params_tp
    from ray_tpu_torch.models import llama, transformer
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import ragged_paged_attention as ra
    from ray_tpu_torch.parallel import MeshSpec, collectives, use_mesh

    kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ, ra.KERNEL]
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = MeshSpec(tp=TP).build()
    cfg = llama.llama_config("8b")
    full = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                            cfg, dev, dtype=cfg.dtype)
    params = shard_params_tp(full, mesh)
    del full
    torch.cuda.empty_cache()
    with use_mesh(mesh):
        rows, _ = hold_rows(torch, params, cfg, None, forced)
        # one gloo allreduce on CUDA tensors at a decode step's [8, 1, E]
        # and a bucket-1024 prefill's [1, 1024, E] (bf16), host clock
        gloo_ms = {}
        for name, shape in (("decode_8x1", (8, 1, cfg.d_model)),
                            ("prefill_1024", (1, 1024, cfg.d_model))):
            x = torch.ones(shape, dtype=cfg.dtype, device=dev)
            collectives.allreduce(x, "tp")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                collectives.allreduce(x, "tp")
            torch.cuda.synchronize()
            gloo_ms[name] = 1e3 * (time.perf_counter() - t0) / 20
    kv_heads = transformer.local_heads(params)[1]
    del params
    torch.cuda.empty_cache()
    eng = LLMEngine.from_config(LLMConfig(
        model_family="llama",
        model_loading_config=ModelLoadingConfig(model_id="8b"),
        engine_kwargs={"kv_layout": "paged", "page_size": 64, "max_slots": 8,
                       "max_len": 2048, "seed": SEED, "mesh": mesh}))
    try:
        rng = np.random.default_rng(SEED + 1)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
                   for n in lengths]
        torch.cuda.synchronize()
        zero(kernels)  # this rank's main path starts here
        t0 = time.perf_counter()
        reqs = [eng.submit(p, SamplingParams(max_tokens=32, temperature=0.0))
                for p in prompts]
        outs = [list(r) for r in reqs]
        wall = time.perf_counter() - t0
        launches = counts(kernels)
        st = eng.stats()
        pool = tuple(eng.state["kp"].shape)
    finally:
        eng.shutdown()
    return {"rows": rows.numpy(), "outs": outs, "launches": launches,
            "stats": st, "wall_s": wall, "pool": pool, "gloo_ms": gloo_ms,
            "kv_heads": kv_heads, "memory_gib":
            torch.cuda.max_memory_allocated(dev) / 2**30}


def serve_tp(torch, card: str) -> dict:
    """11b: the hold rows at tp = 1 and f32 here, then 2 ranks over gloo on
    the card (see the module docstring)."""
    import dataclasses

    from ray_tpu_torch.models import llama, transformer
    from ray_tpu_torch.parallel import launch

    dev = torch.device("cuda")
    cfg = llama.llama_config("8b")
    params = transformer.init(torch.Generator(device=dev).manual_seed(SEED),
                              cfg, dev, dtype=cfg.dtype)
    f32, forced = hold_rows(torch, params, dataclasses.replace(
        cfg, dtype=torch.float32), "reference")
    tp1, _ = hold_rows(torch, params, cfg, None, forced)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(tp_serve_rank, TP, args=(forced, SERVE_LENGTHS),
                   backend="gloo", device="cuda", timeout=600, threads=None)
    spawn_s = time.perf_counter() - t0
    label = f"{TP} ranks sharing one H100 over gloo"
    rows = []
    for what, i in (("prefill", 0), ("decode 0", 1), ("decode 1", 2)):
        for r, res in enumerate(ranks):
            row = {"step": what, "rank": r, **logit_row(
                torch, f"tp={TP} {what} rank {r}",
                torch.as_tensor(res["rows"][i]), tp1[i], f32[i])}
            hold(f"tp={TP} {what} rank {r}", row)
            rows.append(row)
    if ranks[0]["outs"] != ranks[1]["outs"]:
        fail(f"tp={TP} ranks emitted different tokens")
    n_layers = cfg.n_layers
    for r, res in enumerate(ranks):
        st, n = res["stats"], res["launches"]
        for out in res["outs"]:
            if len(out) != 32 or not all(0 <= t < cfg.vocab_size for t in out):
                fail(f"tp rank {r}: a request gave {len(out)} tokens")
        if n["ragged_paged_attention_bf16"] != n_layers * st["decode_steps"]:
            fail(f"tp rank {r}: ragged launches {n} != {n_layers} x "
                 f"{st['decode_steps']} decode steps")
        if n["flash_attention_fwd_bf16"] != n_layers * st["prefills"]:
            fail(f"tp rank {r}: flash launches {n} != {n_layers} x "
                 f"{st['prefills']} prefills")
        if n["flash_attention_bwd_dkv_bf16"] or n["flash_attention_bwd_dq_bf16"]:
            fail(f"tp rank {r}: a backward kernel launched while serving")
        if res["pool"][3] != cfg.kv_heads // TP:
            fail(f"tp rank {r}: pool {res['pool']} is not 4 kv heads")
    st = ranks[0]["stats"]
    return {"label": label, "card": card, "model": "llama-3-8b random init bf16",
            "tp": TP, "hold": rows, "forced_tokens": forced,
            "requests": len(SERVE_LENGTHS), "prompt_lengths": SERVE_LENGTHS,
            "same_tokens_on_every_rank": True,
            "launches_by_rank": [r["launches"] for r in ranks],
            "decode_steps": st["decode_steps"], "prefills": st["prefills"],
            "prefill_ms_mean": 1e3 * st["prefill_seconds"] / st["prefills"],
            "decode_step_ms_mean": 1e3 * st["decode_seconds"]
            / st["decode_steps"],
            "wall_s": ranks[0]["wall_s"], "spawn_to_done_s": spawn_s,
            "pool_shape": ranks[0]["pool"],
            "gloo_allreduce_ms_by_rank": [r["gloo_ms"] for r in ranks],
            "max_memory_gib_by_rank": [r["memory_gib"] for r in ranks]}


def dryrun_tp(torch) -> dict:
    """11c: the dryrun twin on 4 ranks sharing the card over gloo."""
    from ray_tpu_torch.parallel import dryrun

    # gloo takes all_reduce (sum, max), all_gather and all_to_all_single
    # (even and uneven splits) on f32 and bf16 CUDA tensors, the only calls
    # parallel/ makes (its send/recv, which parallel/ never calls, take CPU
    # tensors only), so every program runs on the card
    print("dryrun: every program on CUDA tensors (gloo takes every "
          "collective parallel/ calls on them)", flush=True)
    t0 = time.perf_counter()
    res = dryrun.dryrun_multichip(4, device="cuda", backend="gloo",
                                  timeout=600)
    return {"label": "4 ranks sharing one H100 over gloo", "device": "cuda",
            "wall_s": time.perf_counter() - t0,
            "rank0": res[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernels", action="store_true",
                    help="stop after building and checking the kernels")
    args = ap.parse_args()
    t_script = time.perf_counter()

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
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "warning")):
                print(f"  {name}: {line.strip()}")
    ptxas = ptxas_summary(logs)
    print(json.dumps({"build_s": build_s, "built": sorted(logs),
                      "ptxas": ptxas}), flush=True)
    spilled = [r for r in ptxas if r["spill_stores"]]
    if spilled:
        fail(f"ptxas reports spill stores: {spilled}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the kernels' own tiles are 128 rows: T = 64 and 192 end in a half
    # tile, T = 2048 in whole ones; both head dims, causal and full, forward
    # and backward, untimed
    checks = [check_flash(torch, gen, T, causal, timed=False, D=D, B=2)
              for T, D, causal in EDGE_CASES]
    checks += [check_flash_bwd(torch, gen, 2, T, D, causal, timed=False)
               for T, D, causal in EDGE_CASES]
    checks += [check_flash(torch, gen, T, True, timed=True)
               for T in (64, 1024, 2048)]
    checks.append(check_flash(torch, gen, 1024, False, timed=True))
    # a coalesced prefill's shape (phase 12b: two prompts of bucket 1024)
    checks.append(check_flash(torch, gen, 1024, True, timed=True, B=2))
    checks.append(check_flash(torch, gen, 2048, True, timed=True, D=64, B=4))
    rin = ragged_inputs(torch, gen)
    checks += [check_ragged(torch, rin, nb, timed=True) for nb in (1, 16, 32)]
    B, P = rin[0].shape[0], rin[1].shape[1]
    full = torch.full((B,), 32 * P - 1, dtype=torch.int32, device="cuda")
    checks.append(check_ragged(torch, rin, 32, True, full, " all full"))
    checks.append(check_ragged(torch, rin, 32, True, torch.zeros_like(full),
                               " all at pos 0"))
    checks.append(check_ragged(torch, rin, 23, timed=False))
    del rin
    # the other compiled variants (smaller pages), checked untimed
    for Dh, P in ((64, 16), (128, 32)):
        rin = ragged_inputs(torch, gen, Dh=Dh, P=P, N=33)
        checks.append(check_ragged(torch, rin, 4, timed=False))
    # GPT-2's shapes (phase 9): MHA at head_dim 64, G = 1 in decode
    checks.append(check_flash(torch, gen, 1024, True, timed=False, D=64,
                              H=12, Hkv=12))
    rin = ragged_inputs(torch, gen, Dh=64, P=64, N=129, Hkv=12, G=1)
    checks.append(check_ragged(torch, rin, 16, False, label=" Hkv=12 G=1 "
                               "Dh=64"))
    del rin
    # a tensor-parallel rank's shapes (phase 11): Llama-3-8B at tp = 2
    checks.append(check_flash(torch, gen, 2048, True, timed=True, H=16,
                              Hkv=4))
    rin = ragged_inputs(torch, gen, Hkv=4, G=4)
    checks.append(check_ragged(torch, rin, 32, timed=True, label=" Hkv=4 G=4"))
    del rin
    # the backward at the training path's shape (Llama-3.2-1B, batch 4),
    # at head_dim 128, full attention, and a one-tile sequence
    checks += [check_flash_bwd(torch, gen, 4, 2048, 64, True, timed=True),
               check_flash_bwd(torch, gen, 1, 2048, 128, True, timed=True),
               check_flash_bwd(torch, gen, 1, 1024, 64, False, timed=True),
               check_flash_bwd(torch, gen, 1, 64, 64, True, timed=False),
               check_flash_bwd(torch, gen, 1, 128, 128, False, timed=False)]
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "kernel_checks": checks}), flush=True)

    flash_kernels = [fa.KERNEL, fa.KERNEL_DKV, fa.KERNEL_DQ]
    # every path zeroes and reads all four counts
    all_kernels = flash_kernels + [ra.KERNEL]
    launches = {"serve": {}, "train": {}, "serve_mixtral": {},
                "serve_gpt2": {}, "vit": {},
                **{f"engine_{r}": {} for r in ENGINE_RUNS},
                "pd_monolithic": {}, "pd_handoff": {},
                "pd_coalesced_prefill": {},
                "mesh_train": {}, "serve_tp_rank0": {}, "serve_tp_rank1": {}}
    if not args.only_kernels:
        from ray_tpu_torch.models import llama, mixtral, transformer

        model = check_model(torch, llama.llama_config("8b"),
                            "llama-3-8b random init bf16")
        torch.cuda.empty_cache()  # phase 3's model and pools are gone
        print(json.dumps({"card": card, "model_check": model}), flush=True)
        serving = serve(torch, all_kernels)
        launches["serve"] = serving["launches"]
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "serve": serving}), flush=True)
        print(f"serve on {card}: prefill {serving['prefill_ms_mean']:.3f} ms "
              f"mean, decode step {serving['decode_step_ms_mean']:.3f} ms "
              f"mean, {serving['tokens_per_s']:.1f} tokens/s", flush=True)
        grads = check_model_grads(torch, flash_kernels)
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "model_grads": grads}), flush=True)
        training = train(torch, all_kernels)
        launches["train"] = training["launches"]
        print(json.dumps({"card": card, "train": training}), flush=True)
        print(f"train on {card}: step {training['step_ms']:.3f} ms, "
              f"{training['tokens_per_sec']:.1f} tokens/s, mfu_6nd "
              f"{training['mfu_6nd']:.4f}, peak memory "
              f"{training['max_memory_allocated'] / 2**30:.2f} GiB",
              flush=True)
        del training
        torch.cuda.empty_cache()
        # phase 7: Mixtral-8x7B, full width, 16 of 32 layers
        moe_model = check_model(
            torch, mixtral.mixtral_config("8x7b", n_layers=MIXTRAL_LAYERS),
            f"mixtral-8x7b {MIXTRAL_LAYERS} of 32 layers random init bf16")
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "moe_model_check": moe_model}),
              flush=True)
        # phase 8: serving Mixtral, the slice's main path
        moe_serving = serve(torch, all_kernels, "mixtral", "8x7b",
                            {"n_layers": MIXTRAL_LAYERS})
        launches["serve_mixtral"] = moe_serving["launches"]
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "serve_mixtral": moe_serving}),
              flush=True)
        print(f"serve mixtral-8x7b ({MIXTRAL_LAYERS} layers) on {card}: "
              f"prefill {moe_serving['prefill_ms_mean']:.3f} ms mean, decode "
              f"step {moe_serving['decode_step_ms_mean']:.3f} ms mean, "
              f"{moe_serving['tokens_per_s']:.1f} tokens/s", flush=True)
        # phase 9: GPT-2 served, ViT-L/16, the dispatcher on the card
        gpt2_serving = serve(torch, all_kernels, "gpt2", "124m",
                             lengths=[5, 65, 300, 900], max_len=1024)
        launches["serve_gpt2"] = gpt2_serving["launches"]
        torch.cuda.empty_cache()
        vit_check = check_vit(torch, all_kernels)
        launches["vit"] = vit_check["launches"]
        torch.cuda.empty_cache()
        dispatch = check_dispatch(torch, all_kernels)
        torch.cuda.empty_cache()
        print(json.dumps({"card": card, "serve_gpt2": gpt2_serving,
                          "vit": vit_check, "dispatch": dispatch}),
              flush=True)
        print(f"serve gpt2-124m on {card}: prefill "
              f"{gpt2_serving['prefill_ms_mean']:.3f} ms mean, decode step "
              f"{gpt2_serving['decode_step_ms_mean']:.3f} ms mean, "
              f"{gpt2_serving['tokens_per_s']:.1f} tokens/s", flush=True)
        # phase 10: the engine's options on Llama-3-8B, built once
        cfg8b = llama.llama_config("8b")
        params8b = transformer.init(
            torch.Generator(device="cuda").manual_seed(SEED), cfg8b,
            torch.device("cuda"), dtype=cfg8b.dtype)
        for name, n in serve_options(torch, all_kernels, card, cfg8b,
                                     params8b).items():
            launches[f"engine_{name}"] = n
        torch.cuda.empty_cache()
        # phase 12: PD disaggregation on the same model, before phase 11
        # needs the card's memory
        pd = serve_pd(torch, all_kernels, card, cfg8b, params8b)
        for path in ("pd_monolithic", "pd_handoff", "pd_coalesced_prefill"):
            launches[path] = pd[path]
        del params8b
        torch.cuda.empty_cache()
        # phase 11: multi-GPU on the one card
        meshed = mesh_train(torch, all_kernels)
        launches["mesh_train"] = meshed["launches"]
        print(json.dumps({"card": card, "mesh_train": meshed}), flush=True)
        tp = serve_tp(torch, card)
        launches["serve_tp_rank0"], launches["serve_tp_rank1"] = \
            tp["launches_by_rank"]
        print(json.dumps({"card": card, "serve_tp": tp}), flush=True)
        print(f"serve llama-3-8b tp={TP} ({tp['label']}, {card}): prefill "
              f"{tp['prefill_ms_mean']:.3f} ms mean, decode step "
              f"{tp['decode_step_ms_mean']:.3f} ms mean", flush=True)
        dry = dryrun_tp(torch)
        print(json.dumps({"card": card, "dryrun": dry}), flush=True)

    def case(name):
        return next(c for c in checks if c["case"] == name)

    fwd = case("flash B=4 T=2048 D=64 causal=True")
    bwd = case("flash_bwd B=4 T=2048 D=64 causal=True")
    ragged = case("ragged P=64 pages_bound=32")
    rows = [  # kernel, its path, source, Pallas kernel, case row, numbers
        (fa.KERNEL, "train", "flash_attention_fwd.cu",
         "ray_tpu/ops/flash_attention.py:43", fwd,
         (fwd["max_abs_err"], fwd["ms"], fwd["bound_ms"], fwd["bound_by"])),
        (fa.KERNEL_DKV, "train", "flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:152", bwd,
         (max(bwd["dk_max_abs_err"], bwd["dv_max_abs_err"]), bwd["dkv_ms"],
          bwd["dkv_bound_ms"], bwd["dkv_bound_by"])),
        (fa.KERNEL_DQ, "train", "flash_attention_bwd.cu",
         "ray_tpu/ops/flash_attention.py:197", bwd,
         (bwd["dq_max_abs_err"], bwd["dq_ms"], bwd["dq_bound_ms"],
          bwd["dq_bound_by"])),
        (ra.KERNEL, "serve", "ragged_paged_attention.cu",
         "ray_tpu/ops/ragged_paged_attention.py:49", ragged,
         (ragged["max_abs_err"], ragged["ms"], ragged["bound_ms"],
          ragged["bound_by"]))]
    full = case("ragged P=64 pages_bound=32 all full")
    extra = {ra.KERNEL.symbol: {  # one counted launch is two device kernels
        "device_kernels_per_launch": 2, "splits": ragged["splits"],
        "pages_per_split": ragged["pages_per_split"],
        "all_full_ms": full["ms"], "all_full_bound_ms": full["bound_ms"]}}
    kernels = []
    for kern, path, src, rep, c, (err, ms, bms, by) in rows:
        kernels.append({**extra.get(kern.symbol, {}),
            "name": kern.symbol, "route": "cuda",
            "source": f"ray_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": launches[path].get(kern.symbol), "path": path,
            "launches_by_path": {p: n.get(kern.symbol)  # null: not run
                                 for p, n in launches.items()},
            "case": c["case"], "max_abs_err": err, "ms": ms,
            "plain_ms": c["plain_ms"], "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms, "library_ms": c["library_ms"]})
    print(json.dumps({"card": card, "script_s": time.perf_counter() - t_script}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
