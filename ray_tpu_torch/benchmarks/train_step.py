"""Training-step throughput of the port on one CUDA card.

Counterpart of ``bench.py``'s ``_measure`` (which stays the JAX package's):
random weights from seed 0, one random batch from numpy seed 0 trained on
repeatedly, ``adamw(1e-4, weight_decay=0.01)`` as bench.py's optimizer, one
warm-up step, then timed steps.

    from ray_tpu_torch.benchmarks.train_step import measure
    from ray_tpu_torch.models import llama_config
    measure(llama_config("1b", tie_embeddings=True, max_seq_len=2048),
            batch=4, seq=2048, steps=10)

Step time is CUDA events around the timed steps plus one host sync at the
end; the events are recorded on the device's timeline, so time the device
waits on the host is inside the step. MFU is against the H100's dense bf16
peak (NVIDIA data sheet), by ``bench.py``'s formulas.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.benchmarks.device_profile import busy_share
from ray_tpu_torch.models import transformer
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.train import adamw, make_train_step

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16
LR, WEIGHT_DECAY = 1e-4, 0.01  # bench.py's optax.adamw(1e-4, weight_decay=0.01)
SEED = 0
WARMUP = 1


def flops_per_token(cfg: TransformerConfig, seq: int) -> tuple[float, float]:
    """(6·N, 6·N + causal attention) training FLOPs per token, as bench.py
    counts them: N is every param (embedding included), attention adds
    6·L·S·H·Dh (two matmuls × 2·(S/2)·H·Dh forward, ×3 for training)."""
    six_n = 6.0 * cfg.num_params()
    attn = 6.0 * cfg.n_layers * seq * cfg.n_heads * cfg.head_dim
    return six_n, six_n + attn


def measure(cfg: TransformerConfig, *, batch: int, seq: int, steps: int = 10,
            device=None, before_timed: Callable[[], None] | None = None,
            after_timed: Callable[[], None] | None = None,
            profile: bool = False) -> dict:
    """Train `cfg` for WARMUP + `steps` steps on one repeated random
    [batch, seq + 1] token batch and time the last `steps`.

    `before_timed` / `after_timed` run just before the first and just after
    the last timed step (after its sync), e.g. to zero and read kernel
    launch counts. With `profile`, one more step runs under torch.profiler
    (``busy_share``) after the timed ones. Raises unless the device is a
    CUDA card: a measurement never falls back to the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure times the step on a CUDA card, got {dev}")
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = transformer.init(gen, cfg, dev)
    opt = adamw(params, LR, weight_decay=WEIGHT_DECAY)
    step = make_train_step(
        lambda p, b: transformer.loss_fn(p, b, cfg), opt)
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)), device=dev)
    opt_state = opt.state
    losses = []
    for _ in range(WARMUP):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(loss)
    torch.cuda.synchronize(dev)
    if before_timed is not None:
        before_timed()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize(dev)
    if after_timed is not None:
        after_timed()
    step_ms = start.elapsed_time(end) / steps
    tokens_per_sec = batch * seq / (step_ms / 1e3)
    six_n, with_attn = flops_per_token(cfg, seq)
    out = {
        "tokens_per_sec": tokens_per_sec,
        "step_ms": step_ms,
        "model_params": cfg.num_params(),
        "batch": batch, "seq": seq, "steps": steps, "warmup": WARMUP,
        "mfu_6nd": tokens_per_sec * six_n / PEAK_BF16_FLOPS,
        "mfu_incl_attn": tokens_per_sec * with_attn / PEAK_BF16_FLOPS,
        "losses": [float(x) for x in losses],
        "final_loss": float(losses[-1]),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "device": torch.cuda.get_device_name(dev),
    }
    if profile:
        out["step_profile"] = busy_share(
            lambda: step(params, opt_state, tokens))
    return out
