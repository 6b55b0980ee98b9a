"""The port's Train orchestration against the JAX package's.

Twins of tests/test_train.py: a trainer's fit on two workers, checkpoints,
failure recovery, errors, dataset shards, the session's collectives,
checkpoint retention and the torch process group; each scenario runs
through both runtimes (one module-scoped session each, tests/torch_twins.py)
and returns what the reference test asserts. The twin of
``test_jax_trainer_spmd_smoke`` trains a tiny Llama from the same weights in
a ``JaxTrainer`` worker (the JAX package's step) and in a ``TorchTrainer``
worker (the port's ``make_train_step``), and holds the losses within 2e-5.
Then the port's own: ``use_gpu`` on a host without a GPU, and a worker whose
constructor raises (ROADMAP Queue 3 I).
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np
import pytest

from torch_twins import is_port, pair, same, start_sessions, sub

TOL = 2e-5  # f32 on both sides; matmul summation order differs


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=12)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _same(pkgs, scn, want=None):
    return same(pkgs, scn, want, serve_cleanup=False)


def _tr(rt):
    return sub(rt, "train")


def _dir(tmp_path, rt) -> str:
    d = tmp_path / rt.__name__
    d.mkdir(exist_ok=True)
    return str(d)


def test_basic_fit_two_workers(pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, _tr(rt)

        def train_fn(config):
            import importlib

            tr = importlib.import_module(pkg + ".train")
            ctx = tr.get_context()
            for i in range(3):
                tr.report({"iter": i, "rank": ctx.get_world_rank(),
                           "world_size": ctx.get_world_size()})

        result = train.DataParallelTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="basic",
                                       storage_path=_dir(tmp_path, rt)),
        ).fit()
        return result.error, result.metrics

    _same(pkgs, scn, (None, {"iter": 2, "rank": 0, "world_size": 2}))


def test_checkpoint_roundtrip(pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, _tr(rt)

        def train_fn(config):
            import importlib
            import tempfile

            tr = importlib.import_module(pkg + ".train")
            for i in range(2):
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "state.txt"), "w") as f:
                        f.write(f"iter={i}")
                    tr.report({"loss": 1.0 - i * 0.1},
                              checkpoint=tr.Checkpoint.from_directory(d))

        result = train.DataParallelTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="ckpt",
                                       storage_path=_dir(tmp_path, rt)),
        ).fit()
        with result.checkpoint.as_directory() as d:
            ranks = sorted(x for x in os.listdir(d) if not x.startswith("."))
            with open(os.path.join(d, "rank_0", "state.txt")) as f:
                return ranks, f.read()

    _same(pkgs, scn, (["rank_0", "rank_1"], "iter=1"))


def test_failure_recovery_resumes_from_checkpoint(pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, _tr(rt)
        marker = os.path.join(_dir(tmp_path, rt), "crashed_once")

        def train_fn(config):
            import importlib
            import tempfile

            tr = importlib.import_module(pkg + ".train")
            start = 0
            ckpt = tr.get_checkpoint()
            if ckpt is not None:
                with ckpt.as_directory() as d:
                    with open(os.path.join(d, "rank_0", "iter.txt")) as f:
                        start = int(f.read()) + 1
            for i in range(start, 4):
                if i == 2 and not os.path.exists(config["marker"]):
                    open(config["marker"], "w").close()
                    os._exit(1)  # actor death, not an exception
                with tempfile.TemporaryDirectory() as d:
                    with open(os.path.join(d, "iter.txt"), "w") as f:
                        f.write(str(i))
                    tr.report({"iter": i, "resumed_from": start},
                              checkpoint=tr.Checkpoint.from_directory(d))

        result = train.DataParallelTrainer(
            train_fn, train_loop_config={"marker": marker},
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                name="ft", storage_path=_dir(tmp_path, rt),
                failure_config=train.FailureConfig(max_failures=2)),
        ).fit()
        return (result.metrics["iter"], result.metrics["resumed_from"],
                os.path.exists(marker))

    _same(pkgs, scn, (3, 2, True))


def test_max_failures_zero_raises(pkgs, tmp_path):
    def scn(rt):
        train = _tr(rt)

        def train_fn(config):
            raise ValueError("boom")

        with pytest.raises(train.TrainingFailedError) as ei:
            train.DataParallelTrainer(
                train_fn, scaling_config=train.ScalingConfig(num_workers=1),
                run_config=train.RunConfig(name="err",
                                           storage_path=_dir(tmp_path, rt)),
            ).fit()
        return "boom" in str(ei.value)

    _same(pkgs, scn, True)


def test_dataset_shards(pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, _tr(rt)

        def train_fn(config):
            import importlib

            tr = importlib.import_module(pkg + ".train")
            shard = tr.get_dataset_shard("train")
            tr.report({"rows": sum(1 for _ in shard.iter_rows())})

        result = train.DataParallelTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="data",
                                       storage_path=_dir(tmp_path, rt)),
            datasets={"train": sub(rt, "data").range(100)},
        ).fit()
        return result.metrics["rows"]

    rows = _same(pkgs, scn)
    assert 0 < rows < 100


def test_collectives_barrier_and_broadcast(pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, _tr(rt)

        def train_fn(config):
            import importlib

            tr = importlib.import_module(pkg + ".train")
            rank = tr.get_context().get_world_rank()
            value = tr.broadcast_from_rank_zero(
                {"seed": 42} if rank == 0 else None)
            tr.collective_barrier()
            tr.report({"seed": value["seed"]})

        return train.DataParallelTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="coll",
                                       storage_path=_dir(tmp_path, rt)),
        ).fit().metrics["seed"]

    _same(pkgs, scn, 42)


def _loops():
    """(the JaxTrainer loop, the TorchTrainer loop), defined in a function
    so they pickle by value: a worker cannot import this file."""

    def _jax_loop(config):
        """The JaxTrainer side: the JAX package's llama, optax.adamw."""
        import functools

        import jax
        import jax.numpy as jnp
        import optax

        from ray_tpu import train as tr
        from ray_tpu.models import llama, transformer

        cfg = llama.llama_config("tiny", **config["cfg"], dtype=jnp.float32)
        params = jax.tree.map(jnp.asarray, config["params"])
        opt = optax.adamw(1e-3, weight_decay=0.01)
        state = opt.init(params)

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def step(params, state, tokens):
            loss, grads = jax.value_and_grad(transformer.loss_fn)(
                params, tokens, cfg)
            updates, state = opt.update(grads, state, params)
            return optax.apply_updates(params, updates), state, loss

        losses = []
        for tokens in config["batches"]:
            params, state, loss = step(params, state, jnp.asarray(tokens))
            losses.append(float(loss))
        tr.report({"losses": losses})


    def _torch_loop(config):
        """The TorchTrainer side: converted params, the port's step."""
        import torch

        from ray_tpu_torch import train as tr
        from ray_tpu_torch.models import convert, llama, transformer

        cfg = llama.llama_config("tiny", **config["cfg"], dtype=torch.float32)
        params = convert.params_from_jax(config["params"], cfg, "cpu")
        opt = tr.adamw(params, 1e-3, weight_decay=0.01)
        step = tr.make_train_step(
            lambda p, b: transformer.loss_fn(p, b, cfg), opt)
        losses = []
        for tokens in config["batches"]:
            params, _, loss = step(params, None, torch.from_numpy(tokens))
            losses.append(loss.item())
        tr.report({"losses": losses})

    return _jax_loop, _torch_loop


def test_jax_trainer_spmd_smoke(pkgs, tmp_path):
    """A JaxTrainer and a TorchTrainer train the same tiny Llama from the
    same weights on the same batches: 3 AdamW steps, losses within 2e-5
    and falling (the reference asserts a falling loss on its own problem)."""
    from ray_tpu.models import llama as jllama
    from ray_tpu.models import transformer as jtr

    cfg = {"vocab_size": 256, "max_seq_len": 64}
    jparams = jtr.init(jax.random.PRNGKey(0), jllama.llama_config(
        "tiny", **cfg, dtype=jax.numpy.float32))
    rng = np.random.default_rng(3)
    batch = rng.integers(0, cfg["vocab_size"], size=(2, 33))
    config = {"cfg": cfg, "params": jax.tree.map(np.asarray, jparams),
              "batches": [batch] * 3}

    jax_loop, torch_loop = _loops()

    def scn(rt):
        train = _tr(rt)
        trainer = (train.TorchTrainer if is_port(rt) else train.JaxTrainer)(
            torch_loop if is_port(rt) else jax_loop,
            train_loop_config=config,
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(name="spmd",
                                       storage_path=_dir(tmp_path, rt)))
        result = trainer.fit()
        return result.error, result.metrics["losses"]

    sides = [scn(rt) for rt in pkgs]
    (jerr, jl), (terr, tl) = sides
    assert jerr is None and terr is None, sides
    np.testing.assert_allclose(tl, jl, rtol=TOL, atol=TOL)
    assert jl[-1] < jl[0]


def test_checkpoint_manager_retention(tmp_path):
    def scn(rt):
        Checkpoint = sub(rt, "train._checkpoint").Checkpoint
        CheckpointConfig = sub(rt, "train.config").CheckpointConfig
        mgr = sub(rt, "train.checkpoint_manager").CheckpointManager(
            CheckpointConfig(num_to_keep=2, checkpoint_score_attribute="acc"))
        paths = []
        for i in range(4):
            p = tmp_path / rt.__name__ / f"ckpt_{i}"
            p.mkdir(parents=True)
            paths.append(str(p))
            mgr.register(Checkpoint(str(p)), {"acc": [0.1, 0.9, 0.5, 0.2][i]})
        kept = [t.checkpoint.path for t in mgr._tracked]
        return ([os.path.basename(k) for k in kept],
                paths[1] in kept, mgr.latest_checkpoint.path == paths[3],
                os.path.exists(paths[0]),
                mgr.best_checkpoint.path == paths[1])

    kept, *rest = pair(scn)
    assert len(kept) == 2 or (len(kept) == 3 and "ckpt_3" in kept)
    assert rest == [True, True, False, True]


def test_torch_backend_gloo_allreduce(pkgs, tmp_path):
    def scn(rt):
        pkg, train = rt.__name__, _tr(rt)

        def train_fn(config):
            import importlib

            import torch
            import torch.distributed as dist

            tr = importlib.import_module(pkg + ".train")
            t = torch.ones(4) * (tr.get_context().get_world_rank() + 1)
            if dist.is_initialized():
                dist.all_reduce(t)
            tr.report({"sum0": float(t[0]),
                       "initialized": dist.is_initialized()})

        result = train.TorchTrainer(
            train_fn, scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(name="torch_gloo",
                                       storage_path=_dir(tmp_path, rt)),
            torch_config=train.TorchConfig(init_port=_free_port()),
        ).fit()
        return result.error, result.metrics

    # one side after the other: two free ports picked at once can be the
    # same port, and the two groups' stores would then collide
    same(pkgs, scn, (None, {"sum0": 3.0, "initialized": True}),
         serve_cleanup=False, sequential=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# --------------------------------------------------------- the port's own


def test_port_torch_config_takes_a_free_port_and_nccl():
    """TorchConfig's default port is a free one, the same for every rank of
    a group; its backend is gloo or nccl (the JAX package's is gloo only)."""
    from ray_tpu_torch.train import TorchConfig

    cfg = TorchConfig()
    envs = [cfg.env_for_worker(r, 2, "127.0.0.1") for r in range(2)]
    assert envs[0]["MASTER_PORT"] == envs[1]["MASTER_PORT"] != "0"
    assert [e["RANK"] for e in envs] == ["0", "1"]
    assert TorchConfig(backend="nccl").backend == "nccl"
    with pytest.raises(ValueError, match="gloo"):
        TorchConfig(backend="mpi")


def test_use_gpu_without_a_gpu_is_unplaceable(pkgs, tmp_path):
    """use_gpu=True on a host with no GPU behaves as the JAX package's
    use_tpu=True on a host with no TPU: the worker bundle cannot be placed
    and the error names it; nothing falls back to the CPU."""
    def scn(rt):
        train = _tr(rt)
        key = "use_gpu" if is_port(rt) else "use_tpu"

        def train_fn(config):
            pass

        t0 = time.monotonic()
        with pytest.raises(train.TrainingFailedError) as ei:
            train.DataParallelTrainer(
                train_fn,
                scaling_config=train.ScalingConfig(num_workers=1,
                                                   **{key: True}),
                run_config=train.RunConfig(name="nogpu",
                                           storage_path=_dir(tmp_path, rt)),
            ).fit()
        msg = str(ei.value)
        accel = "GPU" if is_port(rt) else "TPU"
        return ("PlacementGroupUnschedulableError" in msg,
                f"'{accel}': 1.0" in msg, time.monotonic() - t0 < 60)

    _same(pkgs, scn, (True, True, True))


def _bad_worker(rt):
    @rt.remote
    class BrokenTrainWorker:
        def __init__(self, rank, world_size, env=None):
            raise RuntimeError("no CUDA context on this worker")

        def metadata(self):
            return {}

    return BrokenTrainWorker


def test_port_worker_constructor_error_fails_the_attempt(pkgs, tmp_path,
                                                         monkeypatch):
    """A train worker whose __init__ raises (a GPU worker that cannot build
    its CUDA context) fails the attempt with the constructor's error within
    seconds, attempt after attempt under FailureConfig; fit() then raises
    TrainingFailedError. The controller runs in this process, with the
    worker class its WorkerGroup starts swapped for a broken one; the JAX
    package hangs here (ROADMAP Queue 3 I)."""
    rt = pkgs[1]
    train = _tr(rt)
    wg = sub(rt, "train.worker_group")
    ser = sub(rt, "_private.serialization")
    monkeypatch.setattr(wg, "TrainWorker", _bad_worker(rt))
    controller = sub(rt, "train.controller").TrainController._cls(
        ser.dumps(lambda: None), {},
        ser.dumps(train.ScalingConfig(num_workers=1)),
        ser.dumps(train.RunConfig(
            name="badinit", storage_path=_dir(tmp_path, rt),
            failure_config=train.FailureConfig(max_failures=1))),
        None, None)
    t0 = time.monotonic()
    out = controller.run()
    assert time.monotonic() - t0 < 30
    assert out["state"] == "ERRORED"
    assert [a["outcome"] for a in out["attempts"]] == ["errored", "errored"]
    assert "ActorDiedError" in out["error"]
    assert "RuntimeError" in out["error"] and "no CUDA context" in out["error"]
