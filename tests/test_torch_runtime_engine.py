"""The slice as a whole on the CPU: an engine served from an actor of each
runtime.

The numpy params of ``ray_tpu.models.transformer.init`` go into both
object stores. An actor of each package gets the ref, builds its engine
(``LLMEngine(device="cpu")`` in a ray_tpu_torch actor, ``TPUEngine`` in a
ray_tpu actor) and serves the tiny config's prompts, submitted in one
order; the tokens come back through ``get`` and must be greedy
token-exact to each other and to the in-process ``LLMEngine``. A
ray_tpu_torch actor also runs ``ops.attention``'s plain paths on seeded
inputs and returns torch tensors through the store, which match the JAX
Pallas kernel in interpret mode within 2e-5 (f32).
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
ENGINE = dict(max_slots=4, max_len=64, min_bucket=8, kv_layout="paged",
              page_size=8)
PROMPTS = [[1, 5, 9, 2, 7, 4], [3, 1, 4, 1, 5], [7] * 20,
           list(range(30, 70))]
TOL = 2e-5


@pytest.fixture(scope="module")
def jparams():
    import jax

    from ray_tpu.models import transformer as jtr

    jcfg = jtr.TransformerConfig(**TINY, dtype=jax.numpy.float32,
                                 remat=False)
    return jax.tree.map(np.asarray, jtr.init(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def pkgs():
    import ray_tpu
    import ray_tpu_torch

    out = (ray_tpu, ray_tpu_torch)
    for rt in out:
        rt.shutdown()
        rt.init(num_cpus=4, num_workers=1, max_workers=4)
    yield out
    for rt in out:
        rt.shutdown()


def _server(rt):
    """The actor class of `rt` that builds its package's engine from a
    params ref and serves prompts (all submitted, then read back)."""

    @rt.remote
    class Server:
        def __init__(self, params, tiny, engine):
            if rt.__name__ == "ray_tpu_torch":
                import torch

                from ray_tpu_torch.llm import LLMEngine, SamplingParams
                from ray_tpu_torch.models import convert
                from ray_tpu_torch.models import transformer as tr

                cfg = tr.TransformerConfig(**tiny, dtype=torch.float32)
                self.eng = LLMEngine(cfg, convert.params_from_jax(
                    params, cfg, "cpu"), device="cpu", **engine)
            else:
                import jax
                import jax.numpy as jnp

                from ray_tpu.llm import SamplingParams, TPUEngine
                from ray_tpu.models import transformer as tr

                cfg = tr.TransformerConfig(**tiny, dtype=jnp.float32,
                                           remat=False)
                self.eng = TPUEngine(cfg, jax.tree.map(jnp.asarray, params),
                                     **engine)
            self.sp = SamplingParams

        def serve(self, prompts, max_tokens):
            import sys

            reqs = [self.eng.submit(p, self.sp(max_tokens=max_tokens,
                                               temperature=0.0))
                    for p in prompts]
            outs = [list(r) for r in reqs]
            st = self.eng.stats()
            mods = sorted(m for m in sys.modules
                          if m.split(".")[0] in ("ray_tpu", "jax"))
            return outs, st.get("free_pages"), mods

        def stop(self):
            self.eng.shutdown()

    return Server


def _serve_in_actor(rt, params):
    ref = rt.put(params)
    srv = _server(rt).remote(ref, TINY, ENGINE)
    try:
        return rt.get(srv.serve.remote(PROMPTS, 8), timeout=240)
    finally:
        rt.get(srv.stop.remote(), timeout=60)
        rt.kill(srv)


def test_actors_of_both_runtimes_serve_the_same_tokens(pkgs, jparams):
    results: list = [None, None]
    errors: list = [None, None]

    def run(i):
        try:
            results[i] = _serve_in_actor(pkgs[i], jparams)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for e in errors:
        if e is not None:
            raise e
    (j_outs, j_free, _), (t_outs, t_free, t_mods) = results
    assert t_outs == j_outs
    assert t_free == j_free
    # a port worker serving an engine still loads no JAX-package module
    assert t_mods == []

    from ray_tpu_torch.llm import LLMEngine, SamplingParams
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as tr

    cfg = tr.TransformerConfig(**TINY, dtype=torch.float32)
    eng = LLMEngine(cfg, convert.params_from_jax(jparams, cfg, "cpu"),
                    device="cpu", **ENGINE)
    try:
        reqs = [eng.submit(p, SamplingParams(max_tokens=8)) for p in PROMPTS]
        assert [list(r) for r in reqs] == t_outs
    finally:
        eng.shutdown()


def _attention_inputs(seed=3, B=1, T=128, H=4, Hkv=2, D=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


def test_attention_in_an_actor_matches_the_pallas_kernel(pkgs):
    """ops.attention's plain paths (the flash kernel's CPU version and the
    dense reference) in a ray_tpu_torch actor, returned as torch tensors
    through the store, against the JAX Pallas forward in interpret mode."""
    import importlib

    import jax.numpy as jnp

    import ray_tpu_torch as rt

    # the module: ray_tpu.ops exports a function of the same name
    jflash = importlib.import_module("ray_tpu.ops.flash_attention")

    @rt.remote
    class Attn:
        def run(self, inputs):
            import torch

            from ray_tpu_torch import ops

            q, k, v = (torch.from_numpy(x) for x in inputs)
            return {impl or "auto": ops.attention(q, k, v, causal=True,
                                                  impl=impl)
                    for impl in ("flash", None)}

    q, k, v = _attention_inputs(3)
    a = Attn.remote()
    try:
        got = rt.get(a.run.remote((q, k, v)), timeout=120)
    finally:
        rt.kill(a)
    kr, vr = (np.repeat(x, 2, axis=2) for x in (k, v))
    heads = [jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, kr, vr)]
    o, _ = jflash._fwd_call(*heads, causal=True, scale=q.shape[-1] ** -0.5,
                            block_q=128, block_k=128, interpret=True)
    want = np.asarray(o).transpose(0, 2, 1, 3)
    for impl in ("flash", "auto"):
        assert isinstance(got[impl], torch.Tensor)
        assert got[impl].dtype == torch.float32
        np.testing.assert_allclose(got[impl].numpy(), want, atol=TOL,
                                   rtol=TOL, err_msg=impl)
