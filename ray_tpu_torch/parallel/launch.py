"""Start a world of ranks on this host.

    from ray_tpu_torch.parallel import launch
    results = launch(fn, 4, args=(x,), backend="gloo", device="cpu",
                     timeout=60)

Each rank is a process of the *spawn* context (never fork: a parent may
hold threads, JAX's among them, that a forked child would inherit mid-
state). The ranks meet at a ``file://`` rendezvous in a fresh temporary
directory, so concurrent worlds (pytest-xdist workers) never collide on a
port. The device is "cuda" unless the caller names "cpu" (None means
"cuda" and raises when no GPU is visible); the backend is "nccl" on
"cuda" and "gloo" on "cpu" unless named. On "cuda" rank r uses device
r % device_count, so gloo ranks may share one card; NCCL takes one rank a
GPU, and ``launch`` refuses a larger NCCL world before it starts one.

A rank runs ``fn(*args)`` with its process group initialised and returns
a picklable value (numpy, not tensors, so the parent need not import torch
on a device). The launcher has a hard timeout: ``init_process_group`` gets
it too, and when it expires, or any rank raises or dies, every rank is
killed and ``launch`` raises. A deadlocked collective fails in `timeout`
seconds.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback


def resolve_world(device: str | None, backend: str | None) -> tuple[str, str]:
    """The world's (device, backend): device None is "cuda" and raises when
    no GPU is visible, as ``resolve_device`` does; backend None is "nccl" on
    "cuda" and "gloo" on "cpu"."""
    from ray_tpu_torch._device import resolve_device

    if device not in (None, "cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    device = resolve_device(device).type
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if backend == "nccl" and device != "cuda":
        raise ValueError("backend 'nccl' needs device 'cuda'")
    return device, backend


def _rank_main(call_file, rank, world_size, init_file, backend, device,
               timeout, threads, results):
    try:
        with open(call_file, "rb") as f:
            fn, args = pickle.load(f)
        import torch
        import torch.distributed as dist

        if threads:
            torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which kills the world and raises
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world_size: int, *, args: tuple = (),
           backend: str | None = None, device: str | None = None,
           timeout: float = 60.0,
           threads: int | None = 1) -> list:
    """Run ``fn(*args)`` in `world_size` spawned ranks; returns the ranks'
    results in rank order. `fn` must be importable by name (a module-level
    function). `threads` sets each rank's torch intra-op threads (None
    leaves torch's default). Raises RuntimeError with the rank's traceback
    when a rank raises or exits without a result, and TimeoutError when the
    world has not finished in `timeout` seconds; either way every rank is
    killed first."""
    import multiprocessing as mp

    device, backend = resolve_world(device, backend)
    if backend == "nccl":
        import torch

        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"nccl takes one rank a GPU: {world_size} ranks, "
                f"{torch.cuda.device_count()} GPUs visible (name "
                "backend='gloo' for ranks that share a card)")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_world_")
    # the call goes through a file: spawn writes a Process's pickle into
    # the child's pipe and blocks until the child, done importing, reads
    # it, so large args in the pickle would start the ranks one by one
    call_file = os.path.join(tmp, "call.pkl")
    with open(call_file, "wb") as f:
        pickle.dump((fn, args), f)
    results = ctx.Queue()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(call_file, r, world_size, os.path.join(tmp, "rendezvous"),
              backend, device, timeout, threads, results))
        for r in range(world_size)]
    deadline = time.monotonic() + timeout
    got: dict = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(
                    f"world of {world_size} not done in {timeout} s; ranks "
                    f"{missing} still running (a deadlocked collective?)")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.2))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a result may still be in flight from a clean exit
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result") \
                            from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
