"""The port's PD deployments on Serve against the JAX package's.

- ``build_pd_openai_app``: the twin of
  tests/test_llm.py::test_pd_disaggregation on the tiny f32 config of
  tests/test_llm.py:124-135, and parity of both packages' PD apps on the
  same f32 weights (a JAX model saved with the JAX package's
  ``save_params``, loaded by both through ``model_source``): greedy
  completions and one SSE stream through their handles give equal text,
  token counts and chunk sequences, and the port's monolithic
  ``build_openai_app`` on the same checkpoint gives the same text.
- An abandoned stream hands back the decode slot, its pages, the pull and
  the prefill side's ticket, in both packages.
- A PD replica with no ``device`` in ``engine_kwargs`` and no visible card
  raises as ``resolve_device`` does: nothing is served on the CPU unless
  asked for.
"""

from __future__ import annotations

import importlib
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_twins import same, serve_of, start_sessions, stop_sessions, twin

pytestmark = pytest.mark.pd

TINY = dict(vocab_size=300, max_seq_len=128, d_model=64, n_layers=2,
            n_heads=4, n_kv_heads=2, d_ff=128, remat=False)
ENGINE = {"max_slots": 4, "max_len": 128, "min_bucket": 16}
PROMPTS = ["Once upon a time", "abc", "The quick brown fox jumps over"]
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield pkgs
    stop_sessions(pkgs)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny f32 Llama of the JAX package, saved by its save_params."""
    from ray_tpu import models
    from ray_tpu.llm import checkpoint_io as jckpt

    cfg = models.llama_config("tiny", **TINY, dtype=jnp.float32)
    params = models.transformer.init(jax.random.PRNGKey(3), cfg)
    return jckpt.save_params(
        params, str(tmp_path_factory.mktemp("pd") / "tiny.npz"))


def _llm(rt):
    return importlib.import_module(f"{rt.__name__}.llm")


def _config(rt, model_source=None, *, device="cpu", **engine):
    """tests/test_llm.py's _tiny_llm_config, for either package; the port's
    engines run on the CPU when asked for."""
    llm = _llm(rt)
    port = rt.__name__ == "ray_tpu_torch"
    ek = {**ENGINE, **engine}
    if port and device is not None:
        ek["device"] = device
    return llm.LLMConfig(
        model_loading_config=llm.ModelLoadingConfig(
            model_id="tiny", tokenizer="byte", model_source=model_source),
        model_family="llama",
        model_kwargs=dict(TINY, dtype=torch.float32 if port else jnp.float32),
        engine_kwargs=ek)


def _untimed(out: dict) -> dict:
    """A reply or chunk without its clock readings."""
    out = dict(out)
    if "usage" in out:
        out["usage"] = {k: v for k, v in out["usage"].items()
                        if k not in ("ttft_s", "total_time_s")}
    return out


def test_pd_disaggregation(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        handle = serve.run(_llm(rt).build_pd_openai_app(_config(rt)),
                           name="pd", route_prefix="/pd")
        out = handle.remote({"prompt": "abc", "max_tokens": 6}).result(
            timeout_s=180)
        serve.delete("pd")
        u = out["usage"]
        # no stop tokens: the budget is spent exactly (first token +
        # decode), and the time to the first token is reported apart from
        # the whole completion's
        return (isinstance(out["choices"][0]["text"], str),
                u["completion_tokens"], 0 < u["ttft_s"] <= u["total_time_s"])

    same(pkgs, scn, (True, 6, True))


def test_pd_apps_serve_the_same_weights_alike(pkgs, ckpt):
    """Greedy completions and a stream's chunks through both packages' PD
    apps on one JAX checkpoint: equal text, token counts and chunk
    sequences; and the port's monolithic server, built on the engine
    settings the PD pools share, gives the same text and counts."""
    def scn(rt):
        serve = serve_of(rt)
        h = serve.run(_llm(rt).build_pd_openai_app(_config(rt, ckpt)),
                      name="pdpar", route_prefix="/pdpar")
        outs = [_untimed(h.remote({"prompt": p, "max_tokens": MAX_TOKENS})
                         .result(timeout_s=180)) for p in PROMPTS]
        stream = [_untimed(c) for c in h.options(
            stream=True, method_name="stream_request").remote(
                {"prompt": PROMPTS[0], "max_tokens": MAX_TOKENS})]
        serve.delete("pdpar")
        return outs, stream

    (jouts, jstream), (touts, tstream) = twin(pkgs, scn)
    assert touts == jouts
    assert tstream == jstream
    assert [o["usage"]["completion_tokens"] for o in touts] == \
        [MAX_TOKENS] * len(PROMPTS)
    assert len(tstream) == MAX_TOKENS + 1  # a chunk a token, then the stop
    assert "".join(c["choices"][0]["text"] for c in tstream) == \
        touts[0]["choices"][0]["text"]

    port = pkgs[1]
    llm, serve = _llm(port), serve_of(port)
    from ray_tpu_torch.llm.pd import _pd_engine_kwargs

    # the monolithic engine on the PD pools' settings (paged, page 64,
    # min_bucket 64): the same shapes, so the same f32 rounding
    mono_cfg = _config(port, ckpt)
    mono_cfg.engine_kwargs = _pd_engine_kwargs(mono_cfg)
    h = serve.run(llm.build_openai_app(mono_cfg), name="mono",
                  route_prefix="/mono")
    try:
        mono = [h.completions.remote({"prompt": p, "max_tokens": MAX_TOKENS})
                .result(timeout_s=180) for p in PROMPTS]
    finally:
        serve.delete("mono")
    assert [(m["choices"][0]["text"], m["usage"]["completion_tokens"])
            for m in mono] == [(o["choices"][0]["text"],
                                o["usage"]["completion_tokens"])
                               for o in touts]


def test_abandoned_stream_reclaims_slot_pages_and_ticket(pkgs):
    """A stream dropped after its first chunks: the decode replica aborts
    the engine request (its slot and pages go back) and the pull, and the
    prefill replica holds no pending transfer. Page 16 makes the prompt's
    transfer four pages, streamed by a sender thread."""
    prompt = "x" * 40

    def scn(rt):
        serve = serve_of(rt)
        h = serve.run(_llm(rt).build_pd_openai_app(
            _config(rt, page_size=16)), name="pdcx", route_prefix="/pdcx")
        gen = h.options(stream=True, method_name="stream_request").remote(
            {"prompt": prompt, "max_tokens": 80})
        it = iter(gen)
        next(it)
        next(it)
        gen.cancel()
        dec = serve.get_deployment_handle("DecodeServer", "pdcx")
        pre = serve.get_deployment_handle("PrefillServer", "pdcx")
        deadline = time.monotonic() + 30
        while True:
            st = dec.engine_stats.remote().result(timeout_s=30)
            tr = pre.transfer_stats.remote().result(timeout_s=30)
            idle = (st["free_slots"] == st["max_slots"]
                    and st["free_pages"] == st["num_pages"] - 1
                    and st["pulls_in_flight"] == 0
                    and tr["pending_transfers"] == 0)
            if (idle and st["aborts"] >= 1) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        serve.delete("pdcx")
        return st["aborts"], idle, st["decode_steps"] < 79

    same(pkgs, scn, (1, True, True))


@pytest.mark.parametrize("server", ["PrefillServer", "DecodeServer"])
def test_pd_replica_without_a_card_raises(server, monkeypatch):
    """No ``device`` in engine_kwargs means the card: where none is visible
    the replica's constructor raises resolve_device's error."""
    from ray_tpu_torch.llm import pd
    from ray_tpu_torch.llm.config import LLMConfig, ModelLoadingConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LLMConfig(
        model_loading_config=ModelLoadingConfig(model_id="tiny"),
        model_family="llama",
        model_kwargs=dict(TINY, dtype=torch.float32),
        engine_kwargs=dict(ENGINE))
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        getattr(pd, server).func_or_class(cfg)
