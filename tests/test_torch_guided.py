"""Guided decoding in ray_tpu_torch's LLMEngine against ray_tpu's TPUEngine
on the CPU, and the port's own copy of the FSM builders (llm/guided.py)
against ray_tpu.llm.guided: the same tables on the same inputs.

Twins of tests/test_llm_guided.py (14 of its 16; test_server_guided_choice_
end_to_end and test_server_guided_regex_end_to_end need the serve layer,
not ported yet): test_choices_constraint_exact, test_permissive_fsm_matches_
unconstrained, test_token_sets_template, test_mixed_guided_and_free_batch,
test_guided_with_sampling_temperature, test_guided_rejects_bad_configs,
test_fsm_builders, test_regex_fsm_constrains_engine, test_regex_builder_
semantics, test_budget_aware_closing_completes_unbounded_patterns,
test_regex_parser_clean_errors, test_budget_feasibility_masks_long_
branches, test_regex_escapes_and_class_edge_cases, test_regex_dfa_state_cap.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JSamplingParams, TPUEngine
from ray_tpu.llm import guided as jguided
from ray_tpu.models import llama_config as jllama
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.llm import GuidedFSM, LLMEngine, SamplingParams
from ray_tpu_torch.llm.guided import bias_row
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import llama_config as tllama

VOCAB = 64
EOS = 1
EOS_BYTE = 258
PROMPT = [5, 9, 17, 33, 2, 7]


def _models(vocab, max_seq_len=256):
    size = dict(vocab_size=vocab, max_seq_len=max_seq_len, d_model=64,
                n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)
    jcfg = jllama("tiny", **size, dtype=jnp.float32)
    tcfg = tllama("tiny", **size, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def small():
    return _models(VOCAB)


@pytest.fixture(scope="module")
def byte():
    return _models(300)


def _engine(models, **kw):
    _, _, tcfg, tparams = models
    return LLMEngine(tcfg, tparams, device="cpu",
                     **{"max_slots": 4, "max_len": 256, **kw})


def _text(out):
    return "".join(chr(t) for t in out if t != EOS_BYTE)


# ------------------------------------------------------------- FSM tables

def _canonical(fsm):
    """State order of a breadth-first walk from the start state, taking
    successors by ascending token id. The regex builder numbers its DFA
    states in the iteration order of sets of NFA states, which hash by
    object id, so two builds of one pattern (by the same package) may
    number them differently; compared through this order, equal tables
    mean the same automaton."""
    order, seen = [fsm.start], {fsm.start}
    for s in order:
        for t in fsm.trans[s]:
            if int(t) not in seen:
                seen.add(int(t))
                order.append(int(t))
    assert len(order) == fsm.masks.shape[0]  # every state reachable
    return order


def _same_fsm(f, g):
    """The port's and the reference's tables equal, state for state under
    the canonical order; returns the pairs of corresponding states."""
    of, og = _canonical(f), _canonical(g)
    rank_f = np.empty(len(of), np.int64)
    rank_f[of] = np.arange(len(of))
    rank_g = np.empty(len(og), np.int64)
    rank_g[og] = np.arange(len(og))
    assert np.array_equal(f.masks[of], g.masks[og])
    assert np.array_equal(rank_f[f.trans[of]], rank_g[g.trans[og]])
    assert np.array_equal(f.dist[of], g.dist[og])
    assert f.eos_id == g.eos_id
    return list(zip(of, og))


def _same_tables(f, g):
    """The trie builders number states deterministically: the raw tables
    are equal."""
    assert f.start == g.start
    for key in ("masks", "trans", "dist"):
        assert np.array_equal(getattr(f, key), getattr(g, key)), key
    for s in range(f.masks.shape[0]):
        for remaining in (None, 1, 2, 4):
            assert np.array_equal(bias_row(f, s, remaining=remaining),
                                  jguided.bias_row(g, s, remaining=remaining))


@pytest.mark.parametrize("choices", [
    [[3, 4], [3, 5]], [[10, 11, 12], [10, 20], [30, 31, 32, 33]], [[7]]])
def test_choice_tables_equal_the_reference(choices):
    _same_tables(GuidedFSM.from_choices(choices, VOCAB, EOS),
                 jguided.GuidedFSM.from_choices(choices, VOCAB, EOS))


def test_token_set_tables_equal_the_reference():
    sets = [list(range(40, 50)), list(range(40, 50)), [55]]
    _same_tables(GuidedFSM.from_token_sets(sets, VOCAB, EOS),
                 jguided.GuidedFSM.from_token_sets(sets, VOCAB, EOS))


REGEXES = ["(ok|no)[0-9]+", "a[bc]?d*", "[^x]y+", "[a-z]+-[0-9]+",
           "a|bcdef", r"\d+", r"[\w]", r"\.\+", r"[\--0]",
           "[A-Z][a-z]+-[0-9][0-9]"]


@pytest.mark.parametrize("pattern", REGEXES)
def test_regex_tables_and_bias_rows_equal_the_reference(pattern):
    f = GuidedFSM.from_regex(pattern, 300, EOS_BYTE)
    g = jguided.GuidedFSM.from_regex(pattern, 300, EOS_BYTE)
    for sf, sg in _same_fsm(f, g):
        for remaining in (None, 1, 2, 3, 5, 400):
            assert np.array_equal(
                bias_row(f, sf, remaining=remaining),
                jguided.bias_row(g, sg, remaining=remaining))


# ---------------------------------------------------------- engine parity

@pytest.mark.parametrize("layout", [{"kv_layout": "slot"},
                                    {"kv_layout": "paged", "page_size": 16}])
def test_guided_greedy_token_exact_vs_tpu_engine(byte, layout):
    """A choice request, a regex request and a free row, submitted
    together on each layout: greedy outputs token-exact."""
    jcfg, jparams, tcfg, tparams = byte
    choice = [[104, 105], [121, 101, 115]]
    reqs = [(GuidedFSM.from_choices(choice, 300, EOS_BYTE),
             jguided.GuidedFSM.from_choices(choice, 300, EOS_BYTE)),
            (GuidedFSM.from_regex("(ok|no)[0-9]+", 300, EOS_BYTE),
             jguided.GuidedFSM.from_regex("(ok|no)[0-9]+", 300, EOS_BYTE)),
            (None, None)]
    kw = dict(max_slots=4, max_len=128, min_bucket=16, **layout)
    jeng = TPUEngine(jcfg, jparams, **kw)
    teng = LLMEngine(tcfg, tparams, device="cpu", **kw)
    try:
        want = [list(jeng.submit(PROMPT + [i], JSamplingParams(
            max_tokens=10, stop_token_ids=(EOS_BYTE,), guided=g)))
            for i, (_, g) in enumerate(reqs)]
        got = [list(teng.submit(PROMPT + [i], SamplingParams(
            max_tokens=10, stop_token_ids=(EOS_BYTE,), guided=f)))
            for i, (f, _) in enumerate(reqs)]
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert got == want
    assert got[0] in choice and re.fullmatch(r"(ok|no)[0-9]+", _text(got[1]))


# ---------------------------------------------- twins of test_llm_guided.py

def test_choices_constraint_exact(small):
    """Twin of test_llm_guided.py::test_choices_constraint_exact."""
    choices = [[10, 11, 12], [10, 20], [30, 31, 32, 33]]
    fsm = GuidedFSM.from_choices(choices, VOCAB, EOS)
    eng = _engine(small)
    try:
        for seed_tok in (3, 4, 6, 8):
            out = eng.generate(PROMPT + [seed_tok], SamplingParams(
                max_tokens=8, stop_token_ids=(EOS,), guided=fsm))
            assert [t for t in out if t != EOS] in choices, (seed_tok, out)
    finally:
        eng.shutdown()


def test_permissive_fsm_matches_unconstrained(small):
    """Twin of test_llm_guided.py::test_permissive_fsm_matches_
    unconstrained."""
    eng = _engine(small)
    try:
        base = eng.generate(PROMPT, SamplingParams(max_tokens=10))
        allow_all = GuidedFSM(masks=np.ones((1, VOCAB), bool),
                              trans=np.zeros((1, VOCAB), np.int32))
        assert eng.generate(PROMPT, SamplingParams(
            max_tokens=10, guided=allow_all)) == base
    finally:
        eng.shutdown()


def test_token_sets_template(small):
    """Twin of test_llm_guided.py::test_token_sets_template."""
    digits = list(range(40, 50))
    fsm = GuidedFSM.from_token_sets([digits, digits, [55]], VOCAB, EOS)
    eng = _engine(small)
    try:
        out = eng.generate(PROMPT, SamplingParams(
            max_tokens=8, stop_token_ids=(EOS,), guided=fsm))
        body = [t for t in out if t != EOS]
        assert len(body) == 3
        assert body[0] in digits and body[1] in digits and body[2] == 55
    finally:
        eng.shutdown()


def test_mixed_guided_and_free_batch(small):
    """Twin of test_llm_guided.py::test_mixed_guided_and_free_batch."""
    fsm = GuidedFSM.from_choices([[10, 11], [20, 21]], VOCAB, EOS)
    eng = _engine(small)
    try:
        free = eng.submit(PROMPT, SamplingParams(max_tokens=6))
        g = eng.submit(PROMPT + [8], SamplingParams(
            max_tokens=6, stop_token_ids=(EOS,), guided=fsm))
        free_toks = list(free)
        assert [t for t in g if t != EOS] in ([10, 11], [20, 21])
        assert len(free_toks) == 6
    finally:
        eng.shutdown()


def test_guided_with_sampling_temperature(small):
    """Twin of test_llm_guided.py::test_guided_with_sampling_temperature:
    at a high temperature every sampled token still obeys the mask."""
    fsm = GuidedFSM.from_choices([[10, 11, 12], [20, 21]], VOCAB, EOS)
    eng = _engine(small)
    try:
        for _ in range(3):
            out = eng.generate(PROMPT, SamplingParams(
                max_tokens=8, temperature=1.5, top_k=0,
                stop_token_ids=(EOS,), guided=fsm))
            assert [t for t in out if t != EOS] in ([10, 11, 12], [20, 21])
    finally:
        eng.shutdown()


def test_guided_rejects_bad_configs(small):
    """Twin of test_llm_guided.py::test_guided_rejects_bad_configs."""
    fsm = GuidedFSM.from_choices([[10]], VOCAB, EOS)
    eng = _engine(small, speculative_k=2)
    try:
        with pytest.raises(ValueError, match="speculative"):
            eng.submit(PROMPT, SamplingParams(guided=fsm))
    finally:
        eng.shutdown()
    eng = _engine(small)
    try:
        with pytest.raises(ValueError, match="vocab"):
            eng.submit(PROMPT, SamplingParams(
                guided=GuidedFSM.from_choices([[1]], 8, 2)))
    finally:
        eng.shutdown()


def test_fsm_builders():
    """Twin of test_llm_guided.py::test_fsm_builders."""
    fsm = GuidedFSM.from_choices([[3, 4], [3, 5]], 16, 0)
    assert set(np.nonzero(fsm.masks[fsm.start])[0]) == {3}
    s1 = fsm.step(fsm.start, 3)
    assert set(np.nonzero(fsm.masks[s1])[0]) == {4, 5}
    s2 = fsm.step(s1, 4)
    assert set(np.nonzero(fsm.masks[s2])[0]) == {0}
    b = bias_row(fsm, fsm.start)
    assert b[3] == 0.0 and b[4] < -1e8
    with pytest.raises(ValueError, match="empty"):
        GuidedFSM.from_choices([[]], 16, 0)
    with pytest.raises(ValueError, match="vocab"):
        GuidedFSM.from_choices([[99]], 16, 0)


def test_regex_fsm_constrains_engine(byte):
    """Twin of test_llm_guided.py::test_regex_fsm_constrains_engine."""
    fsm = GuidedFSM.from_regex("(ok|no)[0-9]+", 300, EOS_BYTE)
    eng = _engine(byte, max_slots=2)
    try:
        for seed in (3, 5, 11):
            out = eng.generate([seed, 7, 19], SamplingParams(
                max_tokens=10, stop_token_ids=(EOS_BYTE,), guided=fsm))
            assert re.fullmatch(r"(ok|no)[0-9]+", _text(out)), (seed, out)
    finally:
        eng.shutdown()


def test_regex_builder_semantics():
    """Twin of test_llm_guided.py::test_regex_builder_semantics."""
    f = GuidedFSM.from_regex("a[bc]?d*", 300, 258)
    s = f.start
    assert f.masks[s, ord("a")] and not f.masks[s, ord("b")]
    s1 = f.step(s, ord("a"))
    assert f.masks[s1, 258] and f.masks[s1, ord("b")] and f.masks[s1, ord("d")]
    s2 = f.step(s1, ord("c"))
    assert f.masks[s2, 258] and f.masks[s2, ord("d")] \
        and not f.masks[s2, ord("b")]
    s3 = f.step(s2, ord("d"))
    assert f.masks[s3, ord("d")] and f.masks[s3, 258]
    g = GuidedFSM.from_regex("[^x]y+", 300, 258)
    assert not g.masks[g.start, ord("x")] and g.masks[g.start, ord("q")]
    with pytest.raises(ValueError, match="unbalanced|unexpected"):
        GuidedFSM.from_regex("(ab", 300, 258)
    with pytest.raises(ValueError, match="unterminated"):
        GuidedFSM.from_regex("[ab", 300, 258)
    with pytest.raises(ValueError, match="empty"):
        GuidedFSM.from_regex("", 300, 258)


def test_budget_aware_closing_completes_unbounded_patterns(byte):
    """Twin of test_llm_guided.py::test_budget_aware_closing_completes_
    unbounded_patterns."""
    fsm = GuidedFSM.from_regex("[a-z]+-[0-9]+", 300, 258)
    assert fsm.dist[fsm.start] >= 3
    eng = _engine(byte, max_slots=2)
    try:
        for budget in (4, 5, 8):
            out = eng.generate([9, 3, 17], SamplingParams(
                max_tokens=budget, stop_token_ids=(258,), guided=fsm))
            assert re.fullmatch(r"[a-z]+-[0-9]+", _text(out)), (budget, out)
            assert len(out) <= budget
    finally:
        eng.shutdown()


def test_regex_parser_clean_errors():
    """Twin of test_llm_guided.py::test_regex_parser_clean_errors."""
    for bad in ("a|", "(", "ab(", "a|*"):
        with pytest.raises(ValueError):
            GuidedFSM.from_regex(bad, 300, 258)


def test_budget_feasibility_masks_long_branches(byte):
    """Twin of test_llm_guided.py::test_budget_feasibility_masks_long_
    branches."""
    fsm = GuidedFSM.from_regex("a|bcdef", 300, 258)
    row = bias_row(fsm, fsm.start, remaining=3)
    assert row[ord("a")] == 0.0 and row[ord("b")] < -1e8
    row = bias_row(fsm, fsm.start, remaining=7)
    assert row[ord("a")] == 0.0 and row[ord("b")] == 0.0
    eng = _engine(byte, max_slots=2, max_len=128)
    try:
        for seed in (2, 9, 30):
            out = eng.generate([seed, 4], SamplingParams(
                max_tokens=3, stop_token_ids=(258,), guided=fsm))
            assert re.fullmatch(r"a|bcdef", _text(out)), (seed, out)
    finally:
        eng.shutdown()


def test_regex_escapes_and_class_edge_cases():
    """Twin of test_llm_guided.py::test_regex_escapes_and_class_edge_
    cases."""
    f = GuidedFSM.from_regex(r"\d+", 300, 258)
    assert f.masks[f.start, ord("5")] and not f.masks[f.start, ord("d")]
    f = GuidedFSM.from_regex(r"[\w]", 300, 258)
    assert f.masks[f.start, ord("_")] and f.masks[f.start, ord("Z")]
    with pytest.raises(ValueError, match="unsupported escape"):
        GuidedFSM.from_regex(r"\q", 300, 258)
    f = GuidedFSM.from_regex(r"\.\+", 300, 258)
    assert f.masks[f.start, ord(".")] and not f.masks[f.start, ord("x")]
    with pytest.raises(ValueError, match="empty"):
        GuidedFSM.from_regex("[]", 300, 258)
    with pytest.raises(ValueError, match="empty range"):
        GuidedFSM.from_regex("[z-a]", 300, 258)
    f = GuidedFSM.from_regex(r"[\--0]", 300, 258)
    assert f.masks[f.start, ord("-")] and f.masks[f.start, ord("/")]


def test_regex_dfa_state_cap():
    """Twin of test_llm_guided.py::test_regex_dfa_state_cap."""
    with pytest.raises(ValueError, match="DFA states"):
        GuidedFSM.from_regex(".*a" + "." * 20, 300, 258)
