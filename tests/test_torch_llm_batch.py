"""The port's batch LLM processor over Data against the JAX package's.

- The twin of tests/test_llm.py::test_batch_processor.
- Parity: both packages' ``build_llm_processor`` on one tiny f32 Llama
  checkpoint (the JAX package's weights, written by its ``save_params``,
  loaded by both through ``model_source``), greedy, at batch sizes 1 and
  3: the generated text is equal row for row.
- The device rule: the port's engine actor, with no card in sight and no
  ``engine_kwargs={"device": "cpu"}``, raises through the processor's
  call; it never computes on the CPU on its own.
- ``map_batches(num_gpus=1)`` asks the port's runtime for ``{"GPU": 1.0}``
  (tasks and the actor pool alike), where the reference's ``num_tpus=1``
  asks for ``{"TPU": 1.0}``; its task sees the GPU it was granted.
"""

from __future__ import annotations

import importlib
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_twins import is_port, same, start_sessions, sub, twin

TINY = dict(vocab_size=300, max_seq_len=128, d_model=64, n_layers=2,
            n_heads=4, n_kv_heads=2, d_ff=128, remat=False)
ENGINE = {"max_slots": 4, "max_len": 128, "min_bucket": 16}


def _llm(rt):
    return importlib.import_module(f"{rt.__name__}.llm")


def _config(rt, model_source=None, device="cpu"):
    """tests/test_llm.py's tiny config; the port's engine on `device`
    (None: the entry points' default)."""
    llm = _llm(rt)
    ek = dict(ENGINE)
    if is_port(rt) and device is not None:
        ek["device"] = device
    return llm.LLMConfig(
        model_loading_config=llm.ModelLoadingConfig(
            model_id="tiny", tokenizer="byte", model_source=model_source),
        model_family="llama",
        model_kwargs=dict(TINY, dtype=torch.float32 if is_port(rt)
                          else jnp.float32),
        engine_kwargs=ek)


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=8, num_workers=2, max_workers=8)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny f32 Llama of the JAX package, saved by its save_params."""
    from ray_tpu import models
    from ray_tpu.llm import checkpoint_io as jckpt

    cfg = models.llama_config("tiny", **TINY, dtype=jnp.float32)
    params = models.transformer.init(jax.random.PRNGKey(3), cfg)
    return jckpt.save_params(
        params, str(tmp_path_factory.mktemp("batch") / "tiny.npz"))


def test_batch_processor(pkgs):
    def scn(rt):
        rd = sub(rt, "data")
        ds = rd.from_items([{"prompt": f"item {i}"} for i in range(6)])
        proc = _llm(rt).build_llm_processor(
            _config(rt), concurrency=1, batch_size=3,
            sampling_params={"max_tokens": 4, "temperature": 0.0})
        try:
            out = proc(ds).take_all()
        finally:
            proc.shutdown()
        return (len(out),
                all("generated" in r and isinstance(r["generated"], str)
                    for r in out),
                sorted(str(r["prompt"]) for r in out))

    same(pkgs, scn, (6, True, sorted(f"item {i}" for i in range(6))),
         serve_cleanup=False)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_processors_generate_the_same_text(pkgs, ckpt, batch_size):
    prompts = ["Once upon a time", "hi", "The quick brown fox jumps",
               "a", "Data pipelines feed the model", "xyz 123"]

    def scn(rt):
        rd = sub(rt, "data")
        ds = rd.from_items([{"prompt": p, "n": i}
                            for i, p in enumerate(prompts)])
        proc = _llm(rt).build_llm_processor(
            _config(rt, ckpt), concurrency=1, batch_size=batch_size,
            sampling_params={"max_tokens": 10, "temperature": 0.0})
        try:
            rows = proc(ds).take_all()
        finally:
            proc.shutdown()
        return [(int(r["n"]), str(r["prompt"]), r["generated"])
                for r in rows]

    out = same(pkgs, scn, serve_cleanup=False)
    assert [r[1] for r in out] == prompts  # batch order is row order
    assert all(r[2] for r in out)


def test_port_processor_raises_without_a_gpu_or_device(pkgs):
    import ray_tpu_torch

    # the session's workers get CUDA_VISIBLE_DEVICES="" (the default
    # worker platform, cpu), so the actor sees no card on any machine
    rd = sub(ray_tpu_torch, "data")
    proc = _llm(ray_tpu_torch).build_llm_processor(
        _config(ray_tpu_torch, device=None), concurrency=1, batch_size=2,
        sampling_params={"max_tokens": 2, "temperature": 0.0})
    try:
        with pytest.raises(Exception, match="no CUDA device is available"):
            proc(rd.from_items([{"prompt": "hi"}, {"prompt": "yo"}]))
    finally:
        proc.shutdown()


@pytest.fixture
def accel_pkgs():
    """Both runtimes with one fake accelerator: a chip for the JAX
    package (RAY_TPU_CHIPS), a GPU for the port (RAY_TPU_TORCH_GPUS)."""
    import ray_tpu
    import ray_tpu_torch

    keys = ("RAY_TPU_CHIPS", "RAY_TPU_TORCH_GPUS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: "1" for k in keys})
    pkgs = (ray_tpu, ray_tpu_torch)
    try:
        for rt in pkgs:
            rt.shutdown()
            rt.init(num_cpus=4, num_workers=0, max_workers=4,
                    **{"num_gpus" if is_port(rt) else "num_tpus": 1})
        yield pkgs
    finally:
        for rt in pkgs:
            rt.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_map_batches_accelerator_asks_for_the_accelerator(accel_pkgs,
                                                          monkeypatch):
    asked = {}
    for rt in accel_pkgs:
        ex = sub(rt, "data.execution")
        real_remote = rt.remote

        def spy(*args, _real=real_remote, _name=rt.__name__, **kw):
            made = _real(*args, **kw)

            def wrap(fn):
                out = made(fn)
                asked.setdefault(_name, []).append(dict(out._resources))
                return out

            return wrap if not args else made

        monkeypatch.setattr(ex.__dict__[rt.__name__], "remote", spy)

    def scn(rt):
        env = "CUDA_VISIBLE_DEVICES" if is_port(rt) else "TPU_VISIBLE_CHIPS"
        kw = {"num_gpus" if is_port(rt) else "num_tpus": 1}

        def visible(batch):
            import os as _os

            import numpy as _np

            return {"v": _np.asarray([_os.environ.get(env, "")]
                                     * len(batch["id"]))}

        ds = sub(rt, "data").range(4).map_batches(visible, **kw)
        seen = sorted({str(r["v"]) for r in ds.take_all()})
        stage = next(s for s in sub(rt, "data").range(4).map_batches(
            lambda b: b, compute="actors", concurrency=1, **kw)._stages()
            if s.compute == "actors")
        pool = sub(rt, "data.execution")._ActorPool(stage, size=1)
        try:
            pool_res = dict(pool._cls._resources)
        finally:
            pool.shutdown()
        return asked[rt.__name__], seen, pool_res

    (jtask, jseen, jpool), (ttask, tseen, tpool) = twin(
        accel_pkgs, scn, serve_cleanup=False)
    # the read stage asks for a CPU, the map stage for the accelerator
    assert {"CPU": 1.0, "TPU": 1.0} in jtask and jpool == {"CPU": 1.0,
                                                          "TPU": 1.0}
    assert {"CPU": 1.0, "GPU": 1.0} in ttask and tpool == {"CPU": 1.0,
                                                          "GPU": 1.0}
    assert [{("GPU" if k == "TPU" else k): v for k, v in r.items()}
            for r in jtask] == ttask
    assert jseen == ["0"] and tseen == ["0"]  # the one granted accelerator
