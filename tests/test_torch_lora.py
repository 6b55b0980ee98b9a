"""Multi-LoRA serving in ray_tpu_torch's LLMEngine against ray_tpu's
TPUEngine on the CPU, and the LoRA bank, prefill and decode step against
ray_tpu.models.decoding.

Twins of tests/test_llm_lora.py: test_zero_adapter_matches_base_exactly,
test_adapter_matches_dense_merge_token_exact, test_per_slot_isolation_mixed_
batch, test_load_unload_refcounts (the twin of
test_lora_served_through_multiplex is in tests/test_torch_llm_server.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JSamplingParams, TPUEngine
from ray_tpu.models import decoding as jdec
from ray_tpu.models import llama_config as jllama
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.llm import (LLMConfig, LLMEngine, LoraConfig,
                               ModelLoadingConfig, SamplingParams)
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import decoding as tdec
from ray_tpu_torch.models import llama_config as tllama

TOL = 2e-5
RANK = 4
SIZE = dict(vocab_size=256, max_seq_len=128, d_model=64, n_layers=2,
            n_heads=4, n_kv_heads=2, d_ff=128)
PROMPT = [5, 9, 17, 33, 2, 71]
SP = SamplingParams(max_tokens=12, temperature=0.0)
JSP = JSamplingParams(max_tokens=12, temperature=0.0)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama("tiny", **SIZE, dtype=jnp.float32)
    tcfg = tllama("tiny", **SIZE, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    return jcfg, jparams, tcfg, tparams


def _rand_adapter(cfg, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    L, E = cfg.n_layers, cfg.d_model
    H, Hkv, Dh = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    return {
        "A_q": rng.normal(0, scale, (L, E, RANK)).astype(np.float32),
        "B_q": rng.normal(0, scale, (L, RANK, H, Dh)).astype(np.float32),
        "A_v": rng.normal(0, scale, (L, E, RANK)).astype(np.float32),
        "B_v": rng.normal(0, scale, (L, RANK, Hkv, Dh)).astype(np.float32),
    }


def _merge(tparams, w, scale=1.0):
    """The adapter folded densely into wq and wv of the port's params."""
    attn = dict(tparams["layers"]["attn"])
    for key, a, b in (("wq", "A_q", "B_q"), ("wv", "A_v", "B_v")):
        d = np.einsum("ler,lrhd->lehd", w[a], w[b]) * scale
        attn[key] = attn[key] + torch.as_tensor(d, dtype=attn[key].dtype)
    return {**tparams, "layers": {**tparams["layers"], "attn": attn}}


def _banks(model, adapters: dict):
    """Both packages' banks with `adapters` (bank index → (weights, scale))
    written in."""
    jcfg, _, tcfg, _ = model
    jb = jdec.init_lora_bank(jcfg, 2, RANK)
    tb = tdec.init_lora_bank(tcfg, 2, RANK, "cpu")
    assert {k: v.shape for k, v in jb.items()} == \
        {k: tuple(v.shape) for k, v in tb.items()}
    for idx, (w, scale) in adapters.items():
        for key, arr in w.items():
            jb[key] = jb[key].at[:, idx].set(jnp.asarray(arr))
            tb[key][:, idx] = torch.as_tensor(arr)
        jb["scale"] = jb["scale"].at[idx].set(scale)
        tb["scale"][idx] = scale
    return jb, tb


def test_lora_prefill_and_decode_step_match_jax(model):
    """init_lora_bank, LoRA prefill (one adapter) and LoRA decode_step
    (one adapter per row, null rows included): logits and KV within 2e-5
    of the JAX functions'."""
    jcfg, jparams, tcfg, tparams = model
    jb, tb = _banks(model, {1: (_rand_adapter(jcfg, 1), 1.0),
                            2: (_rand_adapter(jcfg, 2), 0.5)})
    js = jdec.init_decode_state(jcfg, 4, 64)
    ts = tdec.init_decode_state(tcfg, 4, 64, "cpu")
    slot_lora = [1, 0, 2, 2]
    for slot, idx in enumerate(slot_lora):
        prompt = PROMPT[:3 + slot]
        padded = np.zeros((1, 8), np.int32)
        padded[0, :len(prompt)] = prompt
        jl, jkv = jdec.prefill(jparams, jnp.asarray(padded), len(prompt), jcfg,
                               jb, jnp.int32(idx))
        tl, tkv = tdec.prefill(tparams, torch.as_tensor(padded).long(),
                               len(prompt), tcfg, lora_bank=tb, lora_idx=idx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tkv[name].numpy(),
                                       np.asarray(jkv[name]), atol=TOL,
                                       rtol=TOL)
        first = int(jnp.argmax(jl))
        js = jdec.insert_sequence(js, slot, jkv, len(prompt), first, jcfg)
        tdec.insert_sequence(ts, slot, tkv, len(prompt), first, tcfg)
    jsl = jnp.asarray(slot_lora, jnp.int32)
    tsl = torch.as_tensor(slot_lora)
    for _ in range(2):
        js, jlog = jdec.decode_step(jparams, js, jcfg, jb, jsl)
        ts, tlog = tdec.decode_step(tparams, ts, tcfg, tb, tsl)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL,
                                   rtol=TOL)
        nxt = jnp.argmax(jlog, axis=-1).astype(jnp.int32)
        js = jdec.commit_tokens(js, nxt)
        tdec.commit_tokens(ts, torch.as_tensor(np.array(nxt)))
    for name in ("k", "v"):
        np.testing.assert_allclose(ts[name].numpy(), np.asarray(js[name]),
                                   atol=TOL, rtol=TOL)


def test_lora_engine_mixed_batch_token_exact_vs_tpu_engine(model):
    """Base, two adapters and the base again, submitted together: outputs
    token-exact to TPUEngine with the same adapters loaded."""
    jcfg, jparams, tcfg, tparams = model
    kw = dict(max_slots=4, max_len=128, max_loras=2, lora_rank=RANK)
    jeng = TPUEngine(jcfg, jparams, **kw)
    teng = LLMEngine(tcfg, tparams, device="cpu", **kw)
    try:
        outs = []
        for eng, sp in ((jeng, JSP), (teng, SP)):
            eng.load_lora("a", _rand_adapter(jcfg, 1))
            eng.load_lora("b", _rand_adapter(jcfg, 2), alpha=2.0)
            reqs = [eng.submit(PROMPT, sp, lora=lo)
                    for lo in (None, "a", "b", None)]
            outs.append([list(r) for r in reqs])
        assert outs[1] == outs[0]
        assert teng.list_loras() == jeng.list_loras() == ["a", "b"]
    finally:
        jeng.shutdown()
        teng.shutdown()


def test_load_lora_validates_before_writing(model):
    """A wrong shape refuses the load and returns the bank slot; the bank a
    caller held before a load or unload is left as it was."""
    _, _, tcfg, tparams = model
    eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=2, max_len=128,
                    max_loras=1, lora_rank=RANK)
    try:
        w = _rand_adapter(tcfg, 3)
        with pytest.raises(ValueError, match="shape"):
            eng.load_lora("x", {**w, "B_v": w["B_v"][:, :2]})
        before = eng.lora_bank
        eng.load_lora("x", w)  # the one slot came back
        assert float(before["A_q"].abs().sum()) == 0.0
        loaded = eng.lora_bank
        eng.unload_lora("x")
        assert float(loaded["A_q"][:, 1].abs().sum()) > 0
        assert float(eng.lora_bank["A_q"].abs().sum()) == 0.0
    finally:
        eng.shutdown()


def test_from_config_sizes_the_bank_from_lora_config():
    eng = LLMEngine.from_config(LLMConfig(
        model_loading_config=ModelLoadingConfig("tiny"),
        model_kwargs={**SIZE, "dtype": torch.float32},
        engine_kwargs={"device": "cpu", "max_slots": 2, "max_len": 128},
        lora_config=LoraConfig(max_num_adapters_per_replica=3, lora_rank=2)))
    try:
        assert (eng.max_loras, eng.lora_rank) == (3, 2)
        assert tuple(eng.lora_bank["A_q"].shape[1:]) == (4, 64, 2)
    finally:
        eng.shutdown()


# ------------------------------------------------ twins of test_llm_lora.py

def test_zero_adapter_matches_base_exactly(model):
    """Twin of test_llm_lora.py::test_zero_adapter_matches_base_exactly."""
    _, _, tcfg, tparams = model
    base = LLMEngine(tcfg, tparams, device="cpu", max_slots=2, max_len=128)
    try:
        want = base.generate(PROMPT, SP)
    finally:
        base.shutdown()
    eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=2, max_len=128,
                    max_loras=2, lora_rank=RANK)
    try:
        assert eng.generate(PROMPT, SP) == want
        zeros = {k: np.zeros_like(v)
                 for k, v in _rand_adapter(tcfg, 0).items()}
        eng.load_lora("zero", zeros)
        assert eng.generate(PROMPT, SP, lora="zero") == want
    finally:
        eng.shutdown()


def test_adapter_matches_dense_merge_token_exact(model):
    """Twin of test_llm_lora.py::test_adapter_matches_dense_merge_token_
    exact."""
    _, _, tcfg, tparams = model
    w = _rand_adapter(tcfg, 7)
    alpha = 2.0
    merged = LLMEngine(tcfg, _merge(tparams, w, alpha / RANK), device="cpu",
                       max_slots=2, max_len=128)
    try:
        want = merged.generate(PROMPT, SP)
    finally:
        merged.shutdown()
    eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=2, max_len=128,
                    max_loras=2, lora_rank=RANK)
    try:
        eng.load_lora("ad", w, alpha=alpha)
        assert eng.generate(PROMPT, SP, lora="ad") == want
        assert eng.generate(PROMPT, SP) != want
    finally:
        eng.shutdown()


def test_per_slot_isolation_mixed_batch(model):
    """Twin of test_llm_lora.py::test_per_slot_isolation_mixed_batch."""
    _, _, tcfg, tparams = model
    eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=4, max_len=128,
                    max_loras=2, lora_rank=RANK)
    try:
        eng.load_lora("a", _rand_adapter(tcfg, 1))
        eng.load_lora("b", _rand_adapter(tcfg, 2))
        reqs = [eng.submit(PROMPT, SP), eng.submit(PROMPT, SP, lora="a"),
                eng.submit(PROMPT, SP, lora="b"), eng.submit(PROMPT, SP)]
        outs = [list(r) for r in reqs]
    finally:
        eng.shutdown()
    base_eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=4,
                         max_len=128)
    try:
        base = base_eng.generate(PROMPT, SP)
    finally:
        base_eng.shutdown()
    assert outs[0] == base and outs[3] == base
    assert outs[1] != base and outs[2] != base
    assert outs[1] != outs[2]


def test_load_unload_refcounts(model):
    """Twin of test_llm_lora.py::test_load_unload_refcounts."""
    _, _, tcfg, tparams = model
    eng = LLMEngine(tcfg, tparams, device="cpu", max_slots=2, max_len=128,
                    max_loras=1, lora_rank=RANK)
    try:
        w = _rand_adapter(tcfg, 3)
        eng.load_lora("x", w)
        with pytest.raises(ValueError, match="already loaded"):
            eng.load_lora("x", w)
        with pytest.raises(RuntimeError, match="no free lora slots"):
            eng.load_lora("y", w)
        req = eng.submit(PROMPT, SamplingParams(max_tokens=40), lora="x")
        with pytest.raises(RuntimeError, match="live requests"):
            eng.unload_lora("x")
        list(req)
        eng.unload_lora("x")
        eng.load_lora("y", w)
        assert eng.list_loras() == ["y"]
        with pytest.raises(KeyError):
            eng.submit(PROMPT, SP, lora="x")
    finally:
        eng.shutdown()
