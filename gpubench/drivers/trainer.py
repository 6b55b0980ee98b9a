"""Training through the port's ``TorchTrainer`` with one GPU worker.

The worker's loop (``train_loop``) is a user's loop: each step draws a
fresh batch of token rows from the seed on the device, calls the step of
``make_train_step`` over ``adamw`` and ``transformer.loss_fn``, and calls
``train.report`` with the step's loss. Its set-up builds the params, the
optimizer and the step once and drives that same object through the
checked steps, by the window's own call, before the window takes it on.
The loop reads, on the program's side, each checked step's loss, each
leaf's first gradient from AdamW's first moment after step one (m / (1 -
b1)), and each leaf's change over the checked steps.

End to end: ``train_tok_s``, the tokens of the steps completed in the
window over the window, which ends with its last step.
"""

from __future__ import annotations

import shutil
import tempfile
import time


def batch(torch, seed: int, step: int, rows: int, seq: int, vocab: int,
          device):
    """Step `step`'s token rows [rows, seq + 1], drawn from the seed."""
    from gpubench.common import sub_seed

    gen = torch.Generator(device=device).manual_seed(
        sub_seed(seed, "batch", step))
    return torch.randint(0, vocab, (rows, seq + 1), generator=gen,
                         device=device)


def train_loop(config: dict):
    import torch

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import transformer

    from gpubench import faults, serving, trace, weights
    from gpubench.common import forbidden_modules

    cfg, mix, seed = config["cfg"], config["mix"], config["seed"]
    dev = torch.device(config["device"])
    tc = serving.port_model(torch, cfg)
    o = cfg["optimizer"]
    params = weights.make(torch, cfg, seed, dev, tc.param_dtype)
    opt = tr.adamw(params, o["learning_rate"], b1=o["b1"], b2=o["b2"],
                   eps=o["eps"], weight_decay=o["weight_decay"])
    if config.get("fault") == "state_unchanged":
        opt.step = lambda *a, **kw: None
    loss_fn = faults.training_loss(
        config.get("fault"), lambda p, b: transformer.loss_fn(p, b, tc))
    step = tr.make_train_step(loss_fn, opt)
    B, T = mix["batch"], mix["seq"]
    report_s: list = []

    def one(i: int) -> float:
        tokens = batch(torch, seed, i, B, T, tc.vocab_size, dev)
        _, _, loss = step(params, None, tokens)
        value = loss.item()
        t = time.perf_counter()
        tr.report({"step": i, "loss": value})
        report_s.append(time.perf_counter() - t)
        return value

    named = list(weights.leaves(params))
    start = {"/".join(p): t.detach().to("cpu", copy=True) for p, t in named}
    losses = [one(0)]
    b1 = o["b1"]
    grads = {"/".join(p): float(opt.state[t]["exp_avg"].norm() / (1 - b1))
             if t in opt.state else 0.0 for p, t in named}
    for i in range(1, mix["checked_steps"]):
        losses.append(one(i))
    change = {"/".join(p): float((t.detach() - start["/".join(p)].to(dev))
                                 .norm()) for p, t in named}
    del start
    report_s.clear()

    w0 = time.perf_counter()
    w0_wall = time.time()
    i = mix["checked_steps"]
    sl = tr_out = None
    traced_steps = 0
    pre = None  # (steps, seconds, report_s) before the slice
    while True:
        el = time.perf_counter() - w0
        if config["trace"] and sl is None and tr_out is None \
                and el >= mix["trace_start_s"]:
            pre = (i - mix["checked_steps"], el, list(report_s))
            sl = trace.Slice(torch)
        if sl is not None and el >= mix["trace_start_s"] \
                + mix["trace_length_s"]:
            sl.stop()
            tr_out, sl = sl, None
        if el >= config["seconds"]:
            break
        one(i)
        i += 1
        traced_steps += sl is not None
    w1 = time.perf_counter()
    steps = i - mix["checked_steps"]
    reduced = None
    if tr_out is not None:
        reduced = tr_out.read()
        reduced["steps"] = traced_steps
    # traced runs: the rate and report times of the steps before the
    # slice, which slows the step it records
    n_pre, s_pre, rep = pre or (steps, w1 - w0, report_s)
    out = {"steps": steps, "tokens": steps * B * T, "window_s": w1 - w0,
           "window_start_wall": w0_wall,
           "pre_slice_tokens_per_s": n_pre * B * T / s_pre,
           "report_ms": 1e3 * sum(rep) / max(1, len(rep)),
           "program": {"losses": losses, "grad_norms": grads,
                       "change_norms": change},
           "n_params": sum(t.numel() for _, t in named),
           "trace": reduced, "forbidden": forbidden_modules(),
           "platform": dev.type}
    if dev.type == "cuda":
        out.update(kind=torch.cuda.get_device_name(dev),
                   memory_peak_bytes=torch.cuda.max_memory_allocated(dev))
    tr.report({"bench": out})


def run(ctx) -> dict:
    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import train as tr

    from gpubench.reference import train as reference

    mix = ctx.mix
    storage = tempfile.mkdtemp(prefix="gpubench_train_")
    rt.init(num_cpus=4)
    try:
        result = tr.TorchTrainer(
            train_loop,
            train_loop_config={"cfg": ctx.cfg, "mix": mix, "seed": ctx.seed,
                               "seconds": ctx.seconds, "trace": ctx.trace,
                               "device": ctx.device, "fault": ctx.fault},
            scaling_config=tr.ScalingConfig(
                num_workers=1, use_gpu=ctx.device == "cuda"),
            run_config=tr.RunConfig(storage_path=storage)).fit()
    finally:
        rt.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    ctx.clock.mark("training done, runtime stopped")
    if result.error is not None:
        raise RuntimeError(f"the training run failed: {result.error}")
    out = result.metrics["bench"]
    if out.pop("forbidden"):
        raise RuntimeError("the train worker loaded a forbidden module")
    from gpubench import serving

    vocab = serving.port_model(torch, ctx.cfg).vocab_size
    batches = [batch(torch, ctx.seed, i, mix["batch"], mix["seq"], vocab,
                     ctx.device) for i in range(mix["checked_steps"])]
    from gpubench import check

    ref = reference.run(torch, ctx.cfg, ctx.seed, ctx.device, batches,
                        ctx.cfg["optimizer"], mix["reference_rows"])
    ctx.clock.mark("reference done")
    judged = {"values": check.trained(out["program"], ref),
              "reference": {"losses": ref["losses"]},
              "program": {"losses": out["program"]["losses"]}}
    if ctx.control:
        low = reference.run(torch, ctx.cfg, ctx.seed, ctx.device, batches,
                            ctx.cfg["optimizer"], mix["reference_rows"],
                            precision="fp8")
        judged["control"] = check.trained(low, ref)
    device = {k: out[k] for k in ("platform", "kind", "memory_peak_bytes")
              if k in out}
    return {"e2e": {"train_tok_s": out["tokens"] / out["window_s"],
                    "setup_s": out["window_start_wall"] - ctx.clock.wall_start},
            "attempted": out["steps"], "failed": 0, "device": device,
            "judged": judged, "trace": out["trace"],
            "layer": {"report_ms": out["report_ms"], "trace": out["trace"],
                      "tokens_per_s": out["pre_slice_tokens_per_s"],
                      "n_params": out["n_params"], "seq": mix["seq"],
                      "batch": mix["batch"], "cfg": ctx.cfg}}
