"""Speculative decoding in ray_tpu_torch's LLMEngine against ray_tpu's
TPUEngine on the CPU, and verify_step / commit_accepted against
ray_tpu.models.decoding.

Twins of tests/test_llm_speculative.py: test_verify_step_matches_decode_
step, test_speculative_engine_token_exact, test_speculative_accepts_on_
repetitive_text, test_speculative_batched_isolated, test_speculative_
rejects_paged_layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JSamplingParams, TPUEngine
from ray_tpu.models import decoding as jdec
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.models import decoding as tdec
from tests.test_torch_engine import _run_concurrent
from tests.test_torch_engine_slot import naive_greedy, tiny  # noqa: F401

TOL = 2e-5
SPEC = dict(max_slots=4, max_len=96, min_bucket=8, speculative_k=4)


def _states(tiny, rows: dict, S: int = 64):
    """Both packages' 4-slot states with each prompt of `rows` (slot →
    prompt) prefilled and inserted, its greedy first token as last."""
    jcfg, jparams, tcfg, tparams = tiny
    js = jdec.init_decode_state(jcfg, 4, S)
    ts = tdec.init_decode_state(tcfg, 4, S, "cpu")
    for slot, prompt in rows.items():
        padded = np.zeros((1, 16), np.int32)
        padded[0, :len(prompt)] = prompt
        jl, jkv = jdec.prefill(jparams, jnp.asarray(padded), len(prompt), jcfg)
        _, tkv = tdec.prefill(tparams, torch.as_tensor(padded).long(),
                              len(prompt), tcfg)
        first = int(jnp.argmax(jl))
        js = jdec.insert_sequence(js, slot, jkv, len(prompt), first, jcfg)
        tdec.insert_sequence(ts, slot, tkv, len(prompt), first, tcfg)
    return js, ts


def _check_verify(tiny, js, ts, draft, K, live, upto):
    jcfg, jparams, tcfg, tparams = tiny
    js, jl = jdec.verify_step(jparams, js, jnp.asarray(draft), jcfg, K)
    ts, tl = tdec.verify_step(tparams, ts, draft, tcfg, K)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=TOL, rtol=TOL)
    for slot in live:
        for name in ("k", "v"):
            np.testing.assert_allclose(
                ts[name][:, slot, :upto[slot]].numpy(),
                np.asarray(js[name][:, slot, :upto[slot]]), atol=TOL,
                rtol=TOL)
    return js, ts, np.asarray(jl)


def test_verify_step_and_commit_accepted_match_jax(tiny):
    """verify_step's K logits and the K written KV rows of the active rows,
    then commit_accepted's lengths and last tokens, against the JAX
    functions."""
    K = 3
    rows = {1: [1, 5, 9, 2, 7, 11, 4], 3: [8, 8, 3]}
    js, ts = _states(tiny, rows)
    draft = np.asarray([[0, 0], [4, 9], [0, 0], [3, 3]], np.int32)
    upto = {s: len(p) + K for s, p in rows.items()}
    js, ts, jl = _check_verify(tiny, js, ts, draft, K, list(rows), upto)
    last = np.argmax(jl[:, 1], axis=-1).astype(np.int32)
    counts = np.asarray([0, 2, 0, 1], np.int32)
    js = jdec.commit_accepted(js, jnp.asarray(last), jnp.asarray(counts))
    tdec.commit_accepted(ts, last, counts)
    for key in ("length", "last_token", "active"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))


def test_verify_step_past_the_cache_end_matches_jax(tiny):
    """A row within K of max_len: its writes at positions >= max_len are
    dropped and its rope lookups clamp, as the JAX function's one-hot
    scatter and clamped gathers do (an index_put_ there would raise)."""
    jcfg, jparams, tcfg, tparams = tiny
    K, S = 4, 32
    rows = {0: list(range(1, 14)), 2: [9, 9, 4]}
    js, ts = _states(tiny, rows, S=S)
    # push row 0 to length 30: positions 30..33 straddle the end (S = 32)
    js = dict(js, length=js["length"].at[0].set(30))
    ts["length"][0] = 30
    draft = np.asarray([[5, 6, 7], [0, 0, 0], [1, 2, 3], [0, 0, 0]],
                       np.int32)
    _check_verify(tiny, js, ts, draft, K, [0, 2], {0: S, 2: 3 + K})


def test_speculative_engine_token_exact_and_counters_vs_tpu_engine(tiny):
    """Concurrent repetitive and random prompts: greedy outputs token-exact
    and the drafted and accepted counts equal TPUEngine's (drafts come from
    each request's own history, so they do not depend on batching)."""
    rng = np.random.default_rng(0)
    prompts = [[1, 5, 9, 2] * 4, [3, 3, 3, 3, 3, 3],
               rng.integers(1, 127, size=11).tolist(), [7, 2] * 5]
    jcfg, jparams, tcfg, tparams = tiny
    jeng = TPUEngine(jcfg, jparams, **SPEC)
    teng = LLMEngine(tcfg, tparams, device="cpu", **SPEC)
    try:
        want = _run_concurrent(
            lambda p, n: jeng.generate(p, JSamplingParams(max_tokens=n)),
            prompts, 20)
        reqs = [teng.submit(p, SamplingParams(max_tokens=20))
                for p in prompts]
        got = [list(r) for r in reqs]
        jst, st = jeng.stats()["speculative"], teng.stats()["speculative"]
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert got == want
    assert (st["drafted"], st["accepted"]) == (jst["drafted"],
                                               jst["accepted"])
    assert st["accepted"] > 0
    assert sum(r.accepted for r in reqs) == st["accepted"]


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_speculative_sequential_steps_equal_tpu_engine(tiny, ngram):
    """One request at a time, so the verify steps are the same too:
    outputs, steps, drafted and accepted equal TPUEngine's."""
    jcfg, jparams, tcfg, tparams = tiny
    kw = dict(SPEC, ngram_size=ngram)
    jeng = TPUEngine(jcfg, jparams, **kw)
    teng = LLMEngine(tcfg, tparams, device="cpu", **kw)
    try:
        for p in ([1, 5, 9, 2] * 3, [4, 4, 4, 4], [11, 12, 13]):
            assert teng.generate(p, SamplingParams(max_tokens=16)) == \
                jeng.generate(p, JSamplingParams(max_tokens=16))
        assert teng.stats()["speculative"] == jeng.stats()["speculative"]
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_speculative_row_ending_at_max_len_vs_tpu_engine(tiny):
    """Rows whose last verify steps reach past max_len (prompt trimmed to
    max_len - max_tokens - 1): token-exact, the same counters."""
    jcfg, jparams, tcfg, tparams = tiny
    kw = dict(max_slots=2, max_len=48, min_bucket=8, speculative_k=4)
    rng = np.random.default_rng(2)
    prompts = [[6, 1, 6, 1] * 12, rng.integers(1, 127, size=40).tolist()]
    jeng = TPUEngine(jcfg, jparams, **kw)
    teng = LLMEngine(tcfg, tparams, device="cpu", **kw)
    try:
        for p in prompts:
            assert teng.generate(p, SamplingParams(max_tokens=12)) == \
                jeng.generate(p, JSamplingParams(max_tokens=12))
        assert teng.stats()["speculative"] == jeng.stats()["speculative"]
    finally:
        jeng.shutdown()
        teng.shutdown()


# ---------------------------------------- twins of test_llm_speculative.py

def test_verify_step_matches_decode_step(tiny):
    """Twin of test_llm_speculative.py::test_verify_step_matches_decode_
    step: K sequential decode_steps and one verify_step over the same
    tokens give the same logits and KV."""
    _, _, tcfg, tparams = tiny
    prompt = [1, 5, 9, 2, 7, 11, 4]
    toks = torch.tensor([prompt + [0]])
    logits_last, kv = tdec.prefill(tparams, toks, len(prompt), tcfg)
    first = int(torch.argmax(logits_last))
    sa = tdec.init_decode_state(tcfg, 2, 64, "cpu")
    tdec.insert_sequence(sa, 0, kv, len(prompt), first, tcfg)
    seq_a, logits_a = [first], []
    for _ in range(3):
        sa, lg = tdec.decode_step(tparams, sa, tcfg)
        logits_a.append(lg[0].clone())
        nxt = int(torch.argmax(lg[0]))
        seq_a.append(nxt)
        tdec.commit_tokens(sa, torch.tensor([nxt, 0]))
    sb = tdec.init_decode_state(tcfg, 2, 64, "cpu")
    tdec.insert_sequence(sb, 0, kv, len(prompt), first, tcfg)
    draft = np.asarray([[seq_a[1], seq_a[2]], [0, 0]], np.int32)
    sb, lg3 = tdec.verify_step(tparams, sb, draft, tcfg, 3)
    for j in range(3):
        np.testing.assert_allclose(lg3[0, j].numpy(), logits_a[j].numpy(),
                                   rtol=1e-4, atol=1e-4)
    tdec.commit_accepted(sb, [seq_a[3], 0], [3, 0])
    assert int(sb["length"][0]) == int(sa["length"][0])
    n = int(sa["length"][0])
    np.testing.assert_allclose(sb["k"][:, 0, :n].numpy(),
                               sa["k"][:, 0, :n].numpy(), rtol=1e-4,
                               atol=1e-5)


def test_speculative_engine_token_exact(tiny):
    """Twin of test_llm_speculative.py::test_speculative_engine_token_
    exact."""
    _, _, tcfg, tparams = tiny
    prompt = [1, 5, 9, 2] * 3
    eng = LLMEngine(tcfg, tparams, device="cpu", **SPEC)
    try:
        out = eng.generate(prompt, SamplingParams(max_tokens=16))
        stats = eng.stats()["speculative"]
    finally:
        eng.shutdown()
    assert out == naive_greedy(tparams, tcfg, prompt, 16)
    assert stats["steps"] > 0 and stats["drafted"] == stats["steps"] * 4


def test_speculative_accepts_on_repetitive_text(tiny):
    """Twin of test_llm_speculative.py::test_speculative_accepts_on_
    repetitive_text."""
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu",
                    **dict(SPEC, max_slots=2))
    try:
        out = eng.generate([3] * 6, SamplingParams(max_tokens=40))
        stats = eng.stats()["speculative"]
    finally:
        eng.shutdown()
    assert len(out) == 40
    assert stats["tokens_per_step"] > 1.0, stats
    assert stats["steps"] < 40


def test_speculative_batched_isolated(tiny):
    """Twin of test_llm_speculative.py::test_speculative_batched_
    isolated."""
    _, _, tcfg, tparams = tiny
    prompts = [[1, 5, 1, 5, 1, 5], [7, 2, 7, 2, 7, 2], [9, 9, 9, 9]]
    want = [naive_greedy(tparams, tcfg, p, 10) for p in prompts]
    eng = LLMEngine(tcfg, tparams, device="cpu",
                    **dict(SPEC, speculative_k=3))
    try:
        got = _run_concurrent(
            lambda p, n: eng.generate(p, SamplingParams(max_tokens=n)),
            prompts, 10)
    finally:
        eng.shutdown()
    assert got == want


def test_speculative_rejects_paged_layout(tiny):
    """Twin of test_llm_speculative.py::test_speculative_rejects_paged_
    layout."""
    _, _, tcfg, tparams = tiny
    with pytest.raises(ValueError, match="speculative_k requires"):
        LLMEngine(tcfg, tparams, device="cpu", max_slots=2, max_len=64,
                  min_bucket=64, kv_layout="paged", page_size=64,
                  speculative_k=2)
