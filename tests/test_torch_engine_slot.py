"""The slot KV layout and ``attn_impl="gather"`` of ray_tpu_torch's LLMEngine
against ray_tpu's TPUEngine on the CPU, the slot model functions against
ray_tpu.models.decoding, and the refusals both engines share.

Twins of tests/test_llm.py's engine tests on the slot layout:
test_engine_matches_full_forward, test_engine_continuous_batching_isolated_
sequences, test_engine_oversubscription_queues, test_engine_stream_and_stats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JSamplingParams, TPUEngine
from ray_tpu.models import decoding as jdec
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.llm import LLMConfig, LLMEngine, ModelLoadingConfig
from ray_tpu_torch.llm import SamplingParams
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models import transformer as ttr
from tests.test_torch_engine import TINY, _run_concurrent

TOL = 2e-5  # f32 on both sides; matmul summation order differs
ENGINE = dict(max_slots=4, max_len=64, min_bucket=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jtr.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    tcfg = ttr.TransformerConfig(**TINY, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    return jcfg, jparams, tcfg, tparams


def naive_greedy(tparams, tcfg, prompt, n):
    """Greedy continuation by full forwards of the port's transformer."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits, _ = ttr.forward(tparams, torch.tensor([toks]), tcfg)
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def both_engines(tiny, prompts, max_tokens, **kw):
    """Greedy outputs and stats of TPUEngine and LLMEngine, built with the
    same options, on concurrently submitted prompts."""
    jcfg, jparams, tcfg, tparams = tiny
    out = []
    for make, sp in ((lambda: TPUEngine(jcfg, jparams, **kw), JSamplingParams),
                     (lambda: LLMEngine(tcfg, tparams, device="cpu", **kw),
                      SamplingParams)):
        eng = make()
        try:
            got = _run_concurrent(
                lambda p, n: eng.generate(p, sp(max_tokens=n)), prompts,
                max_tokens)
            out.append((got, eng.stats()))
        finally:
            eng.shutdown()
    return out


def _prefilled(jparams, tparams, jcfg, tcfg, prompt, bucket):
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    jl, jkv = jdec.prefill(jparams, jnp.asarray(padded), len(prompt), jcfg)
    tl, tkv = tdec.prefill(tparams, torch.as_tensor(padded).long(),
                           len(prompt), tcfg)
    return (jl, jkv), (tl, tkv)


def test_slot_state_insert_decode_release_match_jax(tiny):
    """init_decode_state, insert_sequence, three decode_steps (teacher-
    forced from the JAX run) and release_slot: the active rows' logits and
    KV within 2e-5 of the JAX functions'."""
    jcfg, jparams, tcfg, tparams = tiny
    js = jdec.init_decode_state(jcfg, 4, 64)
    ts = tdec.init_decode_state(tcfg, 4, 64, "cpu")
    assert {k: (v.shape, str(v.dtype)) for k, v in js.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in ts.items()}
    rows = {0: [3, 9, 27, 81, 5], 2: list(range(1, 12))}
    for slot, prompt in rows.items():
        (jl, jkv), (tl, tkv) = _prefilled(jparams, tparams, jcfg, tcfg,
                                          prompt, 16)
        first = int(jnp.argmax(jl))
        js = jdec.insert_sequence(js, slot, jkv, len(prompt), first, jcfg)
        tdec.insert_sequence(ts, slot, tkv, len(prompt), first, tcfg)
    for name in ("k", "v"):
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   atol=TOL, rtol=TOL)
    for key in ("length", "last_token", "active"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    live = list(rows)
    for _ in range(3):
        js, jlog = jdec.decode_step(jparams, js, jcfg)
        ts, tlog = tdec.decode_step(tparams, ts, tcfg)
        np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                                   atol=TOL, rtol=TOL)
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        js = jdec.commit_tokens(js, nxt)
        tdec.commit_tokens(ts, torch.as_tensor(np.array(nxt)))
        np.testing.assert_array_equal(ts["length"].numpy(),
                                      np.asarray(js["length"]))
    for slot in live:
        n = int(ts["length"][slot])
        for name in ("k", "v"):
            np.testing.assert_allclose(
                ts[name][:, slot, :n].numpy(),
                np.asarray(js[name][:, slot, :n]), atol=TOL, rtol=TOL)
    js = jdec.release_slot(js, 2)
    tdec.release_slot(ts, 2)
    for key in ("length", "active"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))


def test_engine_slot_greedy_token_exact_vs_tpu_engine(tiny):
    """4 concurrent mixed-length prompts on the slot layout: greedy output
    token-exact; no ragged kernel, no pages."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 127, size=n).tolist() for n in (3, 11, 19, 30)]
    (want, jst), (got, st) = both_engines(tiny, prompts, 10,
                                          kv_layout="slot", **ENGINE)
    assert got == want
    assert (st["kv_layout"], st["attn_impl"]) == \
        (jst["kv_layout"], jst["attn_impl"]) == ("slot", "gather")
    assert not st["ragged_kernel"] and "free_pages" not in st
    assert st["buckets"] == jst["buckets"]
    assert st["prefills"] == 4 and st["free_slots"] == 4


def test_engine_paged_gather_token_exact_vs_tpu_engine(tiny):
    """attn_impl="gather" on the paged layout (decode_step_paged, no ragged
    launch) against TPUEngine(attn_impl="gather")."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 127, size=n).tolist() for n in (4, 9, 17, 33)]
    (want, jst), (got, st) = both_engines(
        tiny, prompts, 12, kv_layout="paged", page_size=8,
        attn_impl="gather", **ENGINE)
    assert got == want
    assert st["attn_impl"] == jst["attn_impl"] == "gather"
    assert not st["ragged_kernel"]
    assert st["free_pages"] == jst["free_pages"] == st["num_pages"] - 1


def test_default_layout_is_slot_as_in_tpu_engine(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu")
    jeng = TPUEngine(jcfg, jparams)
    try:
        assert eng.stats()["kv_layout"] == jeng.stats()["kv_layout"] == "slot"
        assert eng.generate([1, 2, 3], SamplingParams(max_tokens=4)) == \
            jeng.generate([1, 2, 3], JSamplingParams(max_tokens=4))
    finally:
        eng.shutdown()
        jeng.shutdown()
    eng = LLMEngine.from_config(LLMConfig(
        model_loading_config=ModelLoadingConfig("tiny"),
        model_kwargs={**TINY, "dtype": torch.float32},
        engine_kwargs={"device": "cpu", "max_slots": 2}))
    try:
        assert eng.stats()["kv_layout"] == "slot"
    finally:
        eng.shutdown()


REFUSED = [
    ({"kv_layout": "bogus"}, ValueError),
    ({"kv_layout": "paged", "page_size": 8, "attn_impl": "bogus"},
     ValueError),
    ({"kv_layout": "slot", "enable_prefix_cache": True}, ValueError),
    ({"kv_layout": "slot", "prefill_chunk": 16}, ValueError),
    ({"kv_layout": "paged", "page_size": 8, "prefill_chunk": 12},
     ValueError),
    ({"kv_layout": "paged", "page_size": 8, "prefill_chunk": 128},
     ValueError),
    ({"kv_layout": "paged", "page_size": 8, "speculative_k": 2}, ValueError),
    ({"speculative_k": 17}, ValueError),
    ({"kv_layout": "paged", "page_size": 8, "max_loras": 2}, ValueError),
    ({"max_loras": 2, "speculative_k": 2}, ValueError),
    ({"max_len": 256}, ValueError),
]


@pytest.mark.parametrize("kw,exc", REFUSED)
def test_engines_refuse_the_same_combinations(tiny, kw, exc):
    jcfg, jparams, tcfg, tparams = tiny
    kw = {"max_slots": 2, "max_len": 64, "min_bucket": 8, **kw}
    with pytest.raises(exc):
        TPUEngine(jcfg, jparams, **kw)
    with pytest.raises(exc):
        LLMEngine(tcfg, tparams, device="cpu", **kw)


# ------------------------------------ twins of tests/test_llm.py (slot layout)

def test_engine_matches_full_forward(tiny):
    """Twin of test_llm.py::test_engine_matches_full_forward."""
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE)
    try:
        prompt = [1, 5, 9, 2, 7]
        out = eng.generate(prompt, SamplingParams(max_tokens=8,
                                                  temperature=0.0))
        assert out == naive_greedy(tparams, tcfg, prompt, 8)
    finally:
        eng.shutdown()


def test_engine_continuous_batching_isolated_sequences(tiny):
    """Twin of test_llm.py::test_engine_continuous_batching_isolated_
    sequences: interleaved rows must not cross-contaminate."""
    _, _, tcfg, tparams = tiny
    prompts = [[1, 5, 9], [3, 3, 8, 2], [7], [2, 4, 6, 8, 10]]
    want = [naive_greedy(tparams, tcfg, p, 6) for p in prompts]
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE)
    try:
        got = _run_concurrent(
            lambda p, n: eng.generate(p, SamplingParams(max_tokens=n)),
            prompts, 6)
    finally:
        eng.shutdown()
    assert got == want


def test_engine_oversubscription_queues(tiny):
    """Twin of test_llm.py::test_engine_oversubscription_queues: more
    requests than slots drain as slots free."""
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu",
                    **{**ENGINE, "max_slots": 2})
    try:
        reqs = [eng.submit([i + 1, i + 2], SamplingParams(max_tokens=4))
                for i in range(6)]
        outs = [list(r) for r in reqs]
        assert all(len(o) == 4 for o in outs)
        assert eng.stats()["free_slots"] == 2
    finally:
        eng.shutdown()


def test_engine_stream_and_stats(tiny):
    """Twin of test_llm.py::test_engine_stream_and_stats."""
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu",
                    **{**ENGINE, "max_slots": 2})
    try:
        toks = list(eng.stream([1, 2, 3], SamplingParams(max_tokens=5)))
        assert len(toks) == 5
        s = eng.stats()
        assert s["max_slots"] == 2 and s["active"] == 0
        assert s["kv_layout"] == "slot" and s["decode_steps"] == 4
    finally:
        eng.shutdown()
