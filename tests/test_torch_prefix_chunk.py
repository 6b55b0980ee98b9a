"""The prefix cache and chunked prefill of ray_tpu_torch's LLMEngine against
ray_tpu's TPUEngine on the CPU, and their model functions
(gather_prefix_pages, prefill_with_prefix, insert_sequence_paged_prefix,
write_kv_pages, activate_slot) against ray_tpu.models.decoding_paged.

Twins of tests/test_llm_prefix_cache.py (test_cache_hit_matches_uncached_
logits, test_exact_repeat_reuses_all_full_blocks, test_divergent_prefix_no_
false_hit, test_cache_eviction_under_page_pressure, test_concurrent_mixed_
prompts, test_prefix_cache_requires_paged_layout, test_stats_surface,
test_matched_blocks_survive_eviction_pressure) and of
tests/test_llm_chunked_prefill.py (test_chunked_prefill_token_exact,
test_short_prompts_skip_chunking, test_decode_interleaves_with_long_prefill,
test_chunked_plus_prefix_cache, test_validation), on the port's engine.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JSamplingParams, TPUEngine
from ray_tpu.models import decoding as jdec
from ray_tpu.models import decoding_paged as jdp
from ray_tpu_torch.exceptions import RequestCancelledError
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models import decoding_paged as tdp
from tests.test_torch_engine import _run_concurrent
from tests.test_torch_engine_slot import naive_greedy, tiny  # noqa: F401

TOL = 2e-5
PAGED = dict(max_slots=4, max_len=64, min_bucket=8, kv_layout="paged",
             page_size=8)
CACHE = dict(PAGED, enable_prefix_cache=True)
CHUNK = dict(PAGED, max_len=128, prefill_chunk=16)
SP = SamplingParams


def _engines(tiny, **kw):
    jcfg, jparams, tcfg, tparams = tiny
    return (TPUEngine(jcfg, jparams, **kw),
            LLMEngine(tcfg, tparams, device="cpu", **kw))


def _serve(eng, sp, prompts, n, first=None):
    """Greedy outputs of `prompts`, submitted concurrently; `first`, when
    given, is served to its end before the others are submitted."""
    out = []
    if first is not None:
        out.append(eng.generate(first, sp(max_tokens=n)))
    out += _run_concurrent(lambda p, k: eng.generate(p, sp(max_tokens=k)),
                           prompts, n)
    return out


def _both(tiny, prompts, n, first=None, **kw):
    jeng, teng = _engines(tiny, **kw)
    try:
        want = _serve(jeng, JSamplingParams, prompts, n, first)
        got = _serve(teng, SP, prompts, n, first)
        return (want, jeng.stats()), (got, teng.stats())
    finally:
        jeng.shutdown()
        teng.shutdown()


# ------------------------------------------------------------ model level

def _pools(tiny, prompt, pages, P=8):
    """Both packages' paged states with `prompt`'s prefill KV written into
    `pages` (write_kv_pages), checked equal."""
    jcfg, jparams, tcfg, tparams = tiny
    bucket = len(pages) * P
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    _, jkv = jdec.prefill(jparams, jnp.asarray(padded), len(prompt), jcfg)
    _, tkv = tdec.prefill(tparams, torch.as_tensor(padded).long(),
                          len(prompt), tcfg)
    js = jdp.init_paged_state(jcfg, 2, 64, 17, P)
    ts = tdp.init_paged_state(tcfg, 2, 64, 17, P, "cpu")
    js = jdp.write_kv_pages(js, jkv, jnp.asarray(pages, jnp.int32))
    tdp.write_kv_pages(ts, tkv, np.asarray(pages, np.int32))
    for name in ("kp", "vp"):
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   atol=TOL, rtol=TOL)
    return js, ts


@pytest.mark.parametrize("n_pre,suffix", [(1, 5), (2, 8), (3, 13)])
def test_prefill_with_prefix_matches_jax_and_whole_prefill(tiny, n_pre,
                                                           suffix):
    """gather_prefix_pages (ids padded to a power of two with page 0) and
    prefill_with_prefix against the JAX functions: logits and suffix KV
    within 2e-5; and the logits against a whole-prompt prefill of the same
    tokens."""
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(n_pre)
    P = 8
    prompt = rng.integers(1, 127, size=n_pre * P + suffix).tolist()
    pages = [5, 9, 2][:n_pre]
    js, ts = _pools(tiny, prompt[:n_pre * P], pages)
    npad = 1 << (n_pre - 1).bit_length()
    ids = np.zeros((npad,), np.int32)
    ids[:n_pre] = pages
    jk, jv = jdp.gather_prefix_pages(js["kp"], js["vp"], jnp.asarray(ids))
    tk, tv = tdp.gather_prefix_pages(ts["kp"], ts["vp"], ids)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
    bucket = 16
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :suffix] = prompt[n_pre * P:]
    jl, jkv = jdp.prefill_with_prefix(jparams, jnp.asarray(padded), jk, jv,
                                      n_pre * P, suffix, jcfg)
    tl, tkv = tdp.prefill_with_prefix(tparams, torch.as_tensor(padded).long(),
                                      tk, tv, n_pre * P, suffix, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]),
                                   atol=TOL, rtol=TOL)
    whole = np.zeros((1, 64), np.int64)
    whole[0, :len(prompt)] = prompt
    wl, _ = tdec.prefill(tparams, torch.as_tensor(whole), len(prompt), tcfg)
    np.testing.assert_allclose(tl.numpy(), wl.numpy(), atol=1e-4, rtol=1e-4)


def test_insert_prefix_write_pages_activate_match_jax(tiny):
    """insert_sequence_paged_prefix, write_kv_pages and activate_slot:
    pools and row bookkeeping equal to the JAX functions'."""
    jcfg, jparams, tcfg, tparams = tiny
    js, ts = _pools(tiny, list(range(3, 19)), [4, 7])
    rng = np.random.default_rng(5)
    kv = {k: rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
          for k in ("k", "v")}
    jkv = {k: jnp.asarray(v) for k, v in kv.items()}
    tkv = {k: torch.as_tensor(v) for k, v in kv.items()}
    row = np.zeros((8,), np.int32)
    row[:5] = [4, 7, 11, 12, 13]
    suf = np.asarray([11, 12], np.int32)
    js = jdp.insert_sequence_paged_prefix(
        js, 1, jkv, jnp.asarray(suf), jnp.asarray(row), 21, 42, jcfg)
    tdp.insert_sequence_paged_prefix(ts, 1, tkv, suf, row, 21, 42, tcfg)
    js = jdp.write_kv_pages(js, jkv, jnp.asarray([14, 15], jnp.int32))
    tdp.write_kv_pages(ts, tkv, np.asarray([14, 15], np.int32))
    row0 = np.zeros((8,), np.int32)
    row0[:2] = [14, 15]
    js = jdp.activate_slot(js, 0, jnp.asarray(row0), 9, 7)
    tdp.activate_slot(ts, 0, row0, 9, 7)
    for key in ("kp", "vp"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   atol=TOL, rtol=TOL)
    for key in ("block", "length", "last_token", "active"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))


def test_block_hashes_equal_the_reference(tiny):
    jeng, teng = _engines(tiny, **CACHE)
    try:
        for toks in ([1] * 7, list(range(1, 26)), [5, 9] * 20):
            assert teng._block_hashes(toks) == jeng._block_hashes(toks)
    finally:
        jeng.shutdown()
        teng.shutdown()


# ----------------------------------------------------------- engine parity

def test_prefix_cache_token_exact_and_counters_vs_tpu_engine(tiny):
    """A warm request, then 4 concurrent prompts sharing its 2-block prefix
    and one unrelated prompt: outputs token-exact, and hits, misses,
    tokens_reused, cached_blocks and free pages equal to TPUEngine's."""
    shared = list(range(40, 56))
    prompts = [shared + [i, i + 1, i + 2] for i in range(1, 5)]
    prompts.append([7] * 10)
    (want, jst), (got, st) = _both(tiny, prompts, 6, first=shared + [99],
                                   **CACHE)
    assert got == want
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefix_cache"]["hits"] == 4
    assert st["free_pages"] == jst["free_pages"]
    assert st["prefix_prefills"] == 4 and st["prefills"] == 2


def test_chunked_prefill_token_exact_and_counters_vs_tpu_engine(tiny):
    """Three long prompts (3-4 chunks each) and a short one, concurrent:
    outputs token-exact, prefill_chunks_run equal. The port returns every
    page; TPUEngine keeps the short prompt's 2 pages: with prefill_chunk
    and no prefix cache, its whole-prompt branch of _admit_cached never
    records the row's pages (ray_tpu/llm/engine.py:1325-1335 sets
    _slot_pages only through _register_blocks), so _release_active frees
    none of them."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 127, size=n).tolist() for n in (33, 48, 61, 5)]
    (want, jst), (got, st) = _both(tiny, prompts, 6, **CHUNK)
    assert got == want
    assert st["prefill_chunks_run"] == jst["prefill_chunks_run"] == 10
    assert st["free_pages"] == st["num_pages"] - 1
    assert jst["free_pages"] == st["num_pages"] - 1 - 2


def test_chunked_plus_prefix_cache_counters_vs_tpu_engine(tiny):
    """Chunked prefill with the prefix cache: a 60-token warm request, then
    two prompts sharing its first 5 blocks whose suffixes stream in
    chunks; outputs and every counter equal to TPUEngine's."""
    rng = np.random.default_rng(4)
    warm = rng.integers(1, 100, size=60).tolist()
    prompts = [warm[:40] + rng.integers(1, 100, size=n).tolist()
               for n in (25, 30)]
    (want, jst), (got, st) = _both(tiny, prompts, 5, first=warm,
                                   **dict(CHUNK, enable_prefix_cache=True))
    assert got == want
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefix_cache"]["tokens_reused"] == 2 * 40
    assert st["prefill_chunks_run"] == jst["prefill_chunks_run"]
    assert st["free_pages"] == jst["free_pages"]


def test_abort_reclaims_a_staged_chunked_prefill(tiny):
    """An abort that lands while a request is mid-chunked-prefill returns
    its slot and pages (the staged branch of _abort_one)."""
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu", **CHUNK)
    staged, go = threading.Event(), threading.Event()
    one_chunk = eng._prefill_step

    def step():  # hold the scheduler after the first chunk
        one_chunk()
        staged.set()
        go.wait(30)

    eng._prefill_step = step
    try:
        req = eng.submit(list(range(1, 100)), SP(max_tokens=4))
        assert staged.wait(60)
        assert eng.stats()["prefilling"] == 1
        eng.abort_request(req.rid)
        go.set()
        with pytest.raises(RequestCancelledError):
            list(req)
        deadline = time.time() + 10
        while eng.stats()["free_slots"] != 4 and time.time() < deadline:
            time.sleep(0.01)
        st = eng.stats()
        assert st["free_slots"] == 4 and st["prefilling"] == 0
        assert st["free_pages"] == st["num_pages"] - 1 and st["aborts"] == 1
    finally:
        eng.shutdown()


# ------------------------------------- twins of test_llm_prefix_cache.py

def _cache_engine(tcfg, tparams, **kw):
    return LLMEngine(tcfg, tparams, device="cpu", **{**CACHE, **kw})


def test_cache_hit_matches_uncached_logits(tiny):
    """Twin of test_llm_prefix_cache.py::test_cache_hit_matches_uncached_
    logits."""
    _, _, tcfg, tparams = tiny
    eng = _cache_engine(tcfg, tparams)
    try:
        rng = np.random.default_rng(0)
        prefix = [int(x) for x in rng.integers(1, 100, size=24)]
        for tail in ([3, 1, 4], [2, 7, 1, 8, 2, 8], [9]):
            prompt = prefix + tail
            got = eng.generate(prompt, SP(max_tokens=6, temperature=0.0))
            assert got == naive_greedy(tparams, tcfg, prompt, 6), tail
        st = eng.stats()["prefix_cache"]
        assert st["hits"] >= 2 and st["tokens_reused"] >= 2 * 24
    finally:
        eng.shutdown()


def test_exact_repeat_reuses_all_full_blocks(tiny):
    """Twin of test_llm_prefix_cache.py::test_exact_repeat_reuses_all_full_
    blocks."""
    _, _, tcfg, tparams = tiny
    eng = _cache_engine(tcfg, tparams)
    try:
        prompt = list(range(1, 26))
        out1 = eng.generate(prompt, SP(max_tokens=4))
        out2 = eng.generate(prompt, SP(max_tokens=4))
        assert out1 == out2
        st = eng.stats()["prefix_cache"]
        assert st["hits"] == 1 and st["misses"] == 1
        assert st["tokens_reused"] == 24
    finally:
        eng.shutdown()


def test_divergent_prefix_no_false_hit(tiny):
    """Twin of test_llm_prefix_cache.py::test_divergent_prefix_no_false_
    hit: a changed early block invalidates the later ones."""
    _, _, tcfg, tparams = tiny
    eng = _cache_engine(tcfg, tparams)
    try:
        a = [1] * 8 + [5] * 8 + [9, 9]
        b = [2] * 8 + [5] * 8 + [9, 9]
        assert eng.generate(a, SP(max_tokens=4)) == \
            naive_greedy(tparams, tcfg, a, 4)
        assert eng.generate(b, SP(max_tokens=4)) == \
            naive_greedy(tparams, tcfg, b, 4)
        assert eng.stats()["prefix_cache"]["hits"] == 0
    finally:
        eng.shutdown()


def test_cache_eviction_under_page_pressure(tiny):
    """Twin of test_llm_prefix_cache.py::test_cache_eviction_under_page_
    pressure: zero-ref blocks are evicted, no page leaks."""
    _, _, tcfg, tparams = tiny
    eng = _cache_engine(tcfg, tparams, num_pages=13)
    try:
        rng = np.random.default_rng(1)
        for trial in range(6):
            prompt = [int(x) for x in rng.integers(1, 100, size=17)]
            assert eng.generate(prompt, SP(max_tokens=4)) == \
                naive_greedy(tparams, tcfg, prompt, 4), trial
        st = eng.stats()
        assert st["free_pages"] + st["prefix_cache"]["reclaimable_pages"] \
            == 12
    finally:
        eng.shutdown()


def test_concurrent_mixed_prompts(tiny):
    """Twin of test_llm_prefix_cache.py::test_concurrent_mixed_prompts."""
    _, _, tcfg, tparams = tiny
    eng = _cache_engine(tcfg, tparams)
    try:
        shared = list(range(40, 56))
        prompts = [shared + [i, i + 1] for i in range(1, 5)] + [[7] * 10]
        reqs = [eng.submit(p, SP(max_tokens=5)) for p in prompts]
        for p, r in zip(prompts, reqs):
            assert list(r) == naive_greedy(tparams, tcfg, p, 5), p
    finally:
        eng.shutdown()


def test_prefix_cache_requires_paged_layout(tiny):
    """Twin of test_llm_prefix_cache.py::test_prefix_cache_requires_paged_
    layout."""
    _, _, tcfg, tparams = tiny
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(tcfg, tparams, device="cpu", kv_layout="slot",
                  enable_prefix_cache=True)


def test_stats_surface(tiny):
    """Twin of test_llm_prefix_cache.py::test_stats_surface."""
    _, _, tcfg, tparams = tiny
    eng = _cache_engine(tcfg, tparams)
    try:
        eng.generate(list(range(1, 10)), SP(max_tokens=2))
        st = eng.stats()["prefix_cache"]
        assert set(st) == {"hits", "misses", "hit_rate", "tokens_reused",
                           "cached_blocks", "reclaimable_pages"}
        assert st["cached_blocks"] >= 1
    finally:
        eng.shutdown()


def test_matched_blocks_survive_eviction_pressure(tiny):
    """Twin of test_llm_prefix_cache.py::test_matched_blocks_survive_
    eviction_pressure: eviction takes other zero-ref blocks, never the
    prefix just matched (pinned before allocation)."""
    _, _, tcfg, tparams = tiny
    eng = _cache_engine(tcfg, tparams, num_pages=8)
    try:
        rng = np.random.default_rng(7)
        c_prompt = [int(x) for x in rng.integers(1, 100, size=17)]
        a_prompt = [int(x) for x in rng.integers(1, 100, size=25)]
        for p in (c_prompt, a_prompt):
            assert eng.generate(p, SP(max_tokens=4)) == \
                naive_greedy(tparams, tcfg, p, 4)
        b_prompt = a_prompt[:24] + [int(x) for x in
                                    rng.integers(1, 100, size=8)]
        assert eng.generate(b_prompt, SP(max_tokens=8)) == \
            naive_greedy(tparams, tcfg, b_prompt, 8)
        st = eng.stats()["prefix_cache"]
        assert st["hits"] >= 1 and st["tokens_reused"] >= 24
    finally:
        eng.shutdown()


# ---------------------------------- twins of test_llm_chunked_prefill.py

def _chunk_engine(tcfg, tparams, **kw):
    return LLMEngine(tcfg, tparams, device="cpu", **{**CHUNK, **kw})


def test_chunked_prefill_token_exact(tiny):
    """Twin of test_llm_chunked_prefill.py::test_chunked_prefill_token_
    exact."""
    _, _, tcfg, tparams = tiny
    eng = _chunk_engine(tcfg, tparams)
    try:
        rng = np.random.default_rng(0)
        for n in (33, 48, 61):
            prompt = [int(x) for x in rng.integers(1, 100, size=n)]
            assert eng.generate(prompt, SP(max_tokens=6)) == \
                naive_greedy(tparams, tcfg, prompt, 6), n
        assert eng.stats()["prefill_chunks_run"] >= 9
    finally:
        eng.shutdown()


def test_short_prompts_skip_chunking(tiny):
    """Twin of test_llm_chunked_prefill.py::test_short_prompts_skip_
    chunking."""
    _, _, tcfg, tparams = tiny
    eng = _chunk_engine(tcfg, tparams)
    try:
        assert eng.generate([1, 2, 3, 4, 5], SP(max_tokens=4)) == \
            naive_greedy(tparams, tcfg, [1, 2, 3, 4, 5], 4)
        assert eng.stats()["prefill_chunks_run"] == 0
    finally:
        eng.shutdown()


def test_decode_interleaves_with_long_prefill(tiny):
    """Twin of test_llm_chunked_prefill.py::test_decode_interleaves_with_
    long_prefill."""
    _, _, tcfg, tparams = tiny
    eng = _chunk_engine(tcfg, tparams)
    try:
        short = eng.submit([7, 8, 9], SP(max_tokens=40))
        first = short.out_queue.get(timeout=60)
        rng = np.random.default_rng(1)
        long_prompt = [int(x) for x in rng.integers(1, 100, size=60)]
        long_req = eng.submit(long_prompt, SP(max_tokens=4))
        long_out = list(long_req)
        rest = list(short)
        assert long_out == naive_greedy(tparams, tcfg, long_prompt, 4)
        assert [first] + rest == naive_greedy(tparams, tcfg, [7, 8, 9], 40)
    finally:
        eng.shutdown()


def test_chunked_plus_prefix_cache(tiny):
    """Twin of test_llm_chunked_prefill.py::test_chunked_plus_prefix_
    cache."""
    _, _, tcfg, tparams = tiny
    eng = _chunk_engine(tcfg, tparams, enable_prefix_cache=True)
    try:
        rng = np.random.default_rng(2)
        prefix = [int(x) for x in rng.integers(1, 100, size=40)]
        for tail_n in (25, 30):
            prompt = prefix + [int(x) for x in
                               rng.integers(1, 100, size=tail_n)]
            assert eng.generate(prompt, SP(max_tokens=5)) == \
                naive_greedy(tparams, tcfg, prompt, 5), tail_n
        st = eng.stats()["prefix_cache"]
        assert st["hits"] >= 1 and st["tokens_reused"] >= 40
    finally:
        eng.shutdown()


def test_validation(tiny):
    """Twin of test_llm_chunked_prefill.py::test_validation."""
    _, _, tcfg, tparams = tiny
    with pytest.raises(ValueError, match="prefill_chunk"):
        LLMEngine(tcfg, tparams, device="cpu", kv_layout="paged",
                  page_size=8, prefill_chunk=12)
    with pytest.raises(ValueError, match="paged"):
        LLMEngine(tcfg, tparams, device="cpu", kv_layout="slot",
                  prefill_chunk=16)
