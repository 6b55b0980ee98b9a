"""ray_tpu_torch.llm.LLMEngine against ray_tpu's TPUEngine on the CPU, plus
the port's device rule and its jax-free import. The
engine's other options are held to TPUEngine in test_torch_engine_slot.py,
test_torch_prefix_chunk.py, test_torch_speculative.py, test_torch_lora.py
and test_torch_guided.py."""

import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JSamplingParams, TPUEngine
from ray_tpu.models import transformer as jtr
from ray_tpu_torch.exceptions import DeadlineExceededError, RequestCancelledError
from ray_tpu_torch.llm import LLMConfig, LLMEngine, ModelLoadingConfig
from ray_tpu_torch.llm import SamplingParams, checkpoint_io
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
ENGINE = dict(max_slots=4, max_len=64, min_bucket=8, kv_layout="paged",
              page_size=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jtr.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    tcfg = ttr.TransformerConfig(**TINY, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    return jcfg, jparams, tcfg, tparams


def _run_concurrent(gen, prompts, max_tokens):
    got = [None] * len(prompts)

    def run(i):
        got[i] = gen(prompts[i], max_tokens)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    return got


def _jax_outputs(jcfg, jparams, prompts, max_tokens, **kw):
    eng = TPUEngine(jcfg, jparams, attn_impl="ragged", **{**ENGINE, **kw})
    try:
        return _run_concurrent(
            lambda p, n: eng.generate(p, JSamplingParams(max_tokens=n)),
            prompts, max_tokens), eng.stats()
    finally:
        eng.shutdown()


def _port_outputs(tcfg, tparams, prompts, max_tokens, **kw):
    eng = LLMEngine(tcfg, tparams, device="cpu", **{**ENGINE, **kw})
    try:
        return _run_concurrent(
            lambda p, n: eng.generate(p, SamplingParams(max_tokens=n)),
            prompts, max_tokens), eng.stats()
    finally:
        eng.shutdown()


def test_engine_greedy_token_exact_vs_tpu_engine(tiny):
    """4 concurrent mixed-length prompts: greedy output token-exact."""
    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 127, size=n).tolist() for n in (3, 11, 19, 30)]
    want, _ = _jax_outputs(jcfg, jparams, prompts, 10)
    got, st = _port_outputs(tcfg, tparams, prompts, 10)
    assert got == want
    assert st["attn_impl"] == "ragged" and not st["ragged_kernel"]
    assert st["free_pages"] == st["num_pages"] - 1  # all returned (0=scratch)
    assert st["prefills"] == 4 and st["decode_steps"] >= 9


def test_engine_pool_pressure_backlogs_then_completes(tiny):
    """Twin of test_llm_paged.py::test_paged_pool_pressure_backlogs_then_
    completes: a pool too small for all sequences at once backlogs the rest,
    which still complete token-exact."""
    jcfg, jparams, tcfg, tparams = tiny
    prompts = [[1, 5, 9], [3, 3, 8, 2], [7, 1], [2, 4, 6]]
    want, _ = _jax_outputs(jcfg, jparams, prompts, 16, num_pages=8)
    got, st = _port_outputs(tcfg, tparams, prompts, 16, num_pages=8)
    assert got == want
    assert st["free_pages"] == 7


def test_engine_abort_reclaims_slot_and_pages(tiny):
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE)
    try:
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=40))
        it = iter(req)
        next(it)
        eng.abort_request(req.rid)
        with pytest.raises(RequestCancelledError):
            list(it)
        deadline = time.time() + 10
        while eng.stats()["free_slots"] != 4 and time.time() < deadline:
            time.sleep(0.01)
        st = eng.stats()
        assert st["aborts"] == 1 and st["free_slots"] == 4
        assert st["free_pages"] == st["num_pages"] - 1
    finally:
        eng.shutdown()


def test_engine_expired_deadline_refused_at_admission(tiny):
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE)
    try:
        req = eng.submit([1, 2, 3], SamplingParams(max_tokens=4),
                         deadline_ts=time.time() - 1.0)
        with pytest.raises(DeadlineExceededError):
            list(req)
        assert eng.generate([1, 2, 3], SamplingParams(max_tokens=4))
        assert eng.stats()["aborts"] == 1
    finally:
        eng.shutdown()


def test_engine_unported_knobs_raise(tiny):
    """mesh= takes a DeviceMesh over an initialised process group; the
    tensor-parallel engine's tests over gloo ranks are in
    test_torch_engine_tp.py."""
    _, _, tcfg, tparams = tiny
    with pytest.raises(TypeError, match="DeviceMesh"):
        LLMEngine(tcfg, tparams, device="cpu", **{**ENGINE, "mesh": object()})


def test_entry_points_raise_without_gpu(tiny, monkeypatch):
    """No GPU and no device= → the entry points raise; they never fall back
    to the CPU on their own."""
    _, _, tcfg, tparams = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(tcfg, tparams, **ENGINE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMConfig(model_loading_config=ModelLoadingConfig("tiny")).build_model()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(tcfg, tparams, device="cuda", **ENGINE)


def test_from_config_on_cpu_random_and_checkpoint(tiny, tmp_path):
    """from_config → generate, with random init and with an npz checkpoint
    written by the JAX package (same weights → same tokens)."""
    from ray_tpu.llm import checkpoint_io as jckpt

    jcfg, jparams, tcfg, tparams = tiny
    # llama_config with TINY's widths and rope theta is exactly tcfg
    kw = dict(model_family="llama",
              model_kwargs={**TINY, "rope_theta": 10000.0,
                            "dtype": torch.float32},
              engine_kwargs={**ENGINE, "device": "cpu"})
    eng = LLMEngine.from_config(LLMConfig(
        model_loading_config=ModelLoadingConfig("tiny"), **kw))
    try:
        out = eng.generate([1, 2, 3], SamplingParams(max_tokens=5))
        assert len(out) == 5 and all(0 <= t < 128 for t in out)
    finally:
        eng.shutdown()
    path = jckpt.save_params(jparams, str(tmp_path / "ckpt.npz"))
    loaded = checkpoint_io.load_params(path)
    assert np.array_equal(loaded["embed"], np.asarray(jparams["embed"]))
    eng = LLMEngine.from_config(LLMConfig(
        model_loading_config=ModelLoadingConfig("tiny", model_source=path),
        **kw))
    try:
        want = LLMEngine(tcfg, tparams, device="cpu", **ENGINE)
        try:
            assert eng.generate([4, 5, 6], SamplingParams(max_tokens=6)) == \
                want.generate([4, 5, 6], SamplingParams(max_tokens=6))
        finally:
            want.shutdown()
    finally:
        eng.shutdown()


def test_byte_tokenizer_matches_jax():
    from ray_tpu.llm.tokenizer import ByteTokenizer as JByteTokenizer
    from ray_tpu_torch.llm import ByteTokenizer

    text = "paged KV \u00e9\u4e2d"
    tt, jt = ByteTokenizer(), JByteTokenizer()
    assert tt.encode(text) == jt.encode(text)
    assert tt.encode(text, add_bos=False) == jt.encode(text, add_bos=False)
    ids = tt.encode(text) + [tt.EOS, tt.PAD]
    assert tt.decode(ids) == jt.decode(ids) == text
    assert (tt.vocab_size, tt.eos_token_id) == (jt.vocab_size, jt.eos_token_id)


def test_package_imports_without_jax_or_ray_tpu():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models\n"
        "import ray_tpu_torch.llm, ray_tpu_torch.exceptions\n"
        "import ray_tpu_torch.ops._build, ray_tpu_torch.models.convert\n"
        "import ray_tpu_torch.llm.checkpoint_io, ray_tpu_torch.llm.guided\n"
        "import ray_tpu_torch.train, ray_tpu_torch.benchmarks\n"
        "import ray_tpu_torch.benchmarks.train_step\n"
        "import ray_tpu_torch.ops.moe, ray_tpu_torch.models.vit\n"
        "import ray_tpu_torch.models.gpt2, ray_tpu_torch.models.mixtral\n"
        "import ray_tpu_torch.parallel, ray_tpu_torch.parallel.dryrun\n"
        "import ray_tpu_torch.train.zero\n"
        "import ray_tpu_torch.llm.kv_transfer, ray_tpu_torch.llm.pd\n"
        "import ray_tpu_torch.experimental.channel.mutable_shm\n"
        "import ray_tpu_torch.util.metrics, ray_tpu_torch._private.constants\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and\n"
        "       (m == 'ray_tpu' or m.startswith(('ray_tpu.', 'jax')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# ------------------------------------------------- the other model families

MIXTRAL = dict(vocab_size=128, max_seq_len=128, d_model=64, n_layers=2,
               n_heads=4, n_kv_heads=2, d_ff=96, num_experts=4, top_k=2)


def test_mixtral_engine_greedy_token_exact_vs_tpu_engine():
    """Mixtral (MoE in every layer) through both engines, requests submitted
    one after the other: a MoE layer's output depends on every row of the
    call (the slots share the experts' capacity), so both engines must
    decode the same batch, which concurrent submission does not promise."""
    from ray_tpu.models import mixtral_config as jmixtral
    from ray_tpu_torch.models import mixtral_config as tmixtral

    jcfg = jmixtral("tiny", **MIXTRAL, dtype=jnp.float32, remat=False)
    tcfg = tmixtral("tiny", **MIXTRAL, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 127, size=n).tolist() for n in (3, 11, 19, 30)]
    jeng = TPUEngine(jcfg, jparams, attn_impl="ragged", **ENGINE)
    try:
        want = [jeng.generate(p, JSamplingParams(max_tokens=10))
                for p in prompts]
    finally:
        jeng.shutdown()
    teng = LLMEngine(tcfg, tparams, device="cpu", **ENGINE)
    try:
        got = [teng.generate(p, SamplingParams(max_tokens=10))
               for p in prompts]
        st = teng.stats()
    finally:
        teng.shutdown()
    assert got == want
    assert st["prefills"] == 4 and st["free_pages"] == st["num_pages"] - 1


@pytest.mark.parametrize("family,size,kwargs", [
    ("gpt2", "124m", dict(vocab_size=128, max_seq_len=128, d_model=64,
                          n_layers=2, n_heads=4, d_ff=128)),
    ("mixtral", "tiny", MIXTRAL)])
def test_from_config_builds_each_family_on_cpu(family, size, kwargs):
    eng = LLMEngine.from_config(LLMConfig(
        model_family=family, model_loading_config=ModelLoadingConfig(size),
        model_kwargs={**kwargs, "dtype": torch.float32},
        engine_kwargs={**ENGINE, "device": "cpu"}))
    try:
        out = eng.generate([1, 2, 3], SamplingParams(max_tokens=5))
        assert len(out) == 5 and all(0 <= t < 128 for t in out)
        assert (eng.cfg.moe is not None) is (family == "mixtral")
        assert (eng.cfg.pos, eng.cfg.tie_embeddings) == (
            ("learned", True) if family == "gpt2" else ("rope", False))
    finally:
        eng.shutdown()


def test_build_model_refuses_an_unknown_family():
    with pytest.raises(ValueError, match="'gpt2', 'llama' or 'mixtral'"):
        LLMConfig(model_family="vit").build_model("cpu")
