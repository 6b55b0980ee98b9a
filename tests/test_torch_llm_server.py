"""The port's OpenAI LLM server, tokenizer loading and checkpoint writing
against the JAX package's.

- ``llm/checkpoint_io.save_params``: what the port writes, the JAX
  package's ``load_params`` reads bit for bit, and the reverse, at f32 and
  bf16 (ROADMAP Queue 3 F).
- ``load_tokenizer``: the byte tokenizer, a local tokenizer directory, and
  no fallback to bytes when transformers is missing.
- ``LLMServer`` / ``build_openai_app`` on each runtime's Serve: the twin of
  tests/test_llm.py::test_llm_server_openai_surface, and parity of the two
  servers on the same f32 weights (a JAX model saved with the JAX
  package's ``save_params``, loaded by both through ``model_source``):
  completions, chat, streamed chunks, guided choice and regex, LoRA
  adapters through ``multiplexed`` (twins of
  tests/test_llm_guided.py::test_server_guided_*_end_to_end and
  tests/test_llm_lora.py::test_lora_served_through_multiplex), and a
  cancelled stream that aborts its engine request.
"""

from __future__ import annotations

import importlib
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twins import same, serve_of, start_sessions, stop_sessions, twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=300, max_seq_len=128, d_model=64, n_layers=2,
            n_heads=4, n_kv_heads=2, d_ff=128, remat=False)
ENGINE = {"max_slots": 4, "max_len": 128, "min_bucket": 16}
RANK = 4
# engine stats keys one engine has and the other lacks, by design: the
# port's engine also reports where it runs and which decode kernel it
# took, and counts and times its prefills and decode steps (the card's
# serving numbers come from these)
PORT_ONLY_STATS = {"device", "ragged_kernel", "prefills", "prefix_prefills",
                   "prefill_seconds", "decode_seconds", "decode_slot_steps",
                   "decode_launch_seconds", "decode_sync_seconds",
                   "decode_launch_cpu_seconds"}
JAX_ONLY_STATS: set = set()


# ----------------------------------------------------- checkpoint_io (F)


def _tree(dtype_np, dtype_t, seed):
    rng = np.random.default_rng(seed)
    vals = {"embed": rng.normal(size=(6, 4)).astype(np.float32),
            "layers": {"attn": {"wq": rng.normal(size=(2, 4, 3))
                                .astype(np.float32)}},
            "final_norm": {"w": rng.normal(size=(4,)).astype(np.float32)}}

    def conv(v, fn):
        return {k: conv(x, fn) for k, x in v.items()} if isinstance(v, dict) \
            else fn(v)

    return (conv(vals, lambda a: jnp.asarray(a, dtype=dtype_np)),
            conv(vals, lambda a: torch.from_numpy(a).to(dtype_t)))


def _bits_jax(leaf) -> bytes:
    return np.asarray(leaf).tobytes()


def _bits_torch(leaf) -> bytes:
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.asarray(leaf))
    return t.contiguous().view(torch.uint8).numpy().tobytes() \
        if t.dtype == torch.bfloat16 else t.numpy().tobytes()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_save_params_read_by_jax_load_params(dtype, tmp_path):
    from ray_tpu.llm import checkpoint_io as jckpt
    from ray_tpu_torch.llm import checkpoint_io

    jtree, ttree = _tree(getattr(jnp, dtype), getattr(torch, dtype), 0)
    path = checkpoint_io.save_params(ttree, str(tmp_path / "port.npz"))
    got = _flat(jckpt.load_params(path))
    want = _flat(jtree)
    assert set(got) == set(want)
    for k in want:  # the JAX package's bf16 leaves come back as |V2 records
        assert np.asarray(got[k]).tobytes() == _bits_jax(want[k]), k
        assert np.asarray(got[k]).shape == tuple(want[k].shape), k
    # and the same bytes the JAX package's own save_params writes
    jpath = jckpt.save_params(jtree, str(tmp_path / "jax.npz"))
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_save_params_read_by_port_load_params(dtype, tmp_path):
    from ray_tpu.llm import checkpoint_io as jckpt
    from ray_tpu_torch.llm import checkpoint_io

    jtree, ttree = _tree(getattr(jnp, dtype), getattr(torch, dtype), 1)
    path = jckpt.save_params(jtree, str(tmp_path / "jax.npz"))
    got = _flat(checkpoint_io.load_params(path))
    want = _flat(ttree)
    assert set(got) == set(want)
    for k in want:
        leaf = got[k]
        if dtype == "bfloat16":
            assert isinstance(leaf, torch.Tensor) and \
                leaf.dtype == torch.bfloat16, (k, type(leaf))
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert _bits_torch(leaf) == _bits_torch(want[k]), k
    # the port's round trip keeps every bit too
    again = checkpoint_io.save_params(checkpoint_io.load_params(path),
                                      str(tmp_path / "again"))
    with np.load(path) as a, np.load(again + ".npz") as b:
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


# --------------------------------------------------------- load_tokenizer


def _tokenizer_dir(tmp_path) -> str:
    """A local word-level tokenizer directory, built offline."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {"[UNK]": 0, "[EOS]": 1, "hello": 2, "world": 3, "serve": 4}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                                   eos_token="[EOS]")
    path = str(tmp_path / "tok")
    fast.save_pretrained(path)
    return path


def test_load_tokenizer_byte_and_local_dir(tmp_path):
    from ray_tpu.llm.tokenizer import load_tokenizer as jload
    from ray_tpu_torch.llm import ByteTokenizer, load_tokenizer

    for spec in (None, "byte"):
        tok = load_tokenizer(spec)
        assert isinstance(tok, ByteTokenizer)
        assert tok.encode("hé") == jload(spec).encode("hé")
    path = _tokenizer_dir(tmp_path)
    tok, jtok = load_tokenizer(path), jload(path)
    text = "hello serve world nope"
    assert tok.encode(text) == jtok.encode(text) == [2, 4, 3, 0]
    assert tok.eos_token_id == jtok.eos_token_id == 1


def test_load_tokenizer_directory_needs_transformers(tmp_path):
    """Without transformers a directory spec raises ImportError; it never
    falls back to bytes (nothing is downloaded either)."""
    code = ("import sys\n"
            "sys.modules['transformers'] = None\n"
            "from ray_tpu_torch.llm import load_tokenizer\n"
            "assert type(load_tokenizer('byte')).__name__ == 'ByteTokenizer'\n"
            "try:\n"
            f"    load_tokenizer({str(tmp_path)!r})\n"
            "except ImportError:\n"
            "    print('raised')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "raised"


# ------------------------------------------------------------- the servers


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=16, num_workers=2, max_workers=12)
    yield pkgs
    stop_sessions(pkgs)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny f32 Llama of the JAX package, saved by its save_params."""
    from ray_tpu import models
    from ray_tpu.llm import checkpoint_io as jckpt

    cfg = models.llama_config("tiny", **TINY, dtype=jnp.float32)
    params = models.transformer.init(jax.random.PRNGKey(7), cfg)
    return jckpt.save_params(
        params, str(tmp_path_factory.mktemp("llm") / "tiny.npz"))


def _llm(rt):
    return importlib.import_module(f"{rt.__name__}.llm")


def _config(rt, model_source=None, lora_dir=None, **engine):
    llm = _llm(rt)
    port = rt.__name__ == "ray_tpu_torch"
    ek = {**ENGINE, **engine, **({"device": "cpu"} if port else {})}
    extra = {}
    if lora_dir is not None:
        extra["lora_config"] = importlib.import_module(
            f"{rt.__name__}.llm.config").LoraConfig(
            dynamic_lora_loading_path=lora_dir,
            max_num_adapters_per_replica=2, lora_rank=RANK)
    return llm.LLMConfig(
        model_loading_config=llm.ModelLoadingConfig(
            model_id="tiny", tokenizer="byte", model_source=model_source),
        model_family="llama",
        model_kwargs=dict(TINY, dtype=torch.float32 if port else jnp.float32),
        engine_kwargs=ek, **extra)


def test_llm_server_openai_surface(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        handle = serve.run(_llm(rt).build_openai_app(_config(rt)),
                           name="llm", route_prefix="/llm")
        out = handle.completions.remote(
            {"prompt": "hi", "max_tokens": 8}).result(timeout_s=120)
        chat = handle.chat.remote(
            {"messages": [{"role": "user", "content": "hey"}],
             "max_tokens": 4}).result(timeout_s=120)
        # /v1/stats surfaces engine observability over the same entry
        st = handle.remote({"path": "/v1/stats"}).result(timeout_s=60)
        serve.delete("llm")
        return (out["object"], out["usage"]["completion_tokens"] <= 8,
                isinstance(out["choices"][0]["text"], str),
                chat["object"], "message" in chat["choices"][0],
                st["max_slots"] >= 1 and "kv_layout" in st)

    same(pkgs, scn, ("text_completion", True, True, "chat.completion",
                     True, True))


def _strip_times(out: dict) -> dict:
    out = dict(out)
    out["usage"] = {k: v for k, v in out["usage"].items()
                    if k != "total_time_s"}
    return out


def test_llm_servers_serve_the_same_weights_alike(pkgs, ckpt):
    """Greedy completions, chat, a stream's chunks and guided decoding,
    through both servers' handles, on one JAX checkpoint: equal text,
    token counts and chunk sequences; /v1/stats with the same keys but the
    ones each engine has by design."""
    body = {"prompt": "Once upon a time", "max_tokens": 12}

    def scn(rt):
        serve = serve_of(rt)
        h = serve.run(_llm(rt).build_openai_app(_config(rt, ckpt)),
                      name="par", route_prefix="/par")
        out = {
            "completion": _strip_times(
                h.completions.remote(body).result(timeout_s=120)),
            "chat": _strip_times(h.chat.remote(
                {"messages": [{"role": "user", "content": "hey there"}],
                 "max_tokens": 9}).result(timeout_s=120)),
            "stream": list(h.options(
                stream=True, method_name="completions_stream").remote(body)),
            "chat_stream": list(h.options(
                stream=True, method_name="chat_stream").remote(
                    {"messages": [{"role": "user", "content": "yo"}],
                     "max_tokens": 5})),
            "choice": _strip_times(h.completions.remote(
                {"prompt": "pick:", "max_tokens": 16,
                 "guided_choice": ["yes", "no", "maybe"]}).result(
                    timeout_s=120)),
            "regex": _strip_times(h.completions.remote(
                {"prompt": "id:", "max_tokens": 12,
                 "guided_regex": "[A-Z][a-z]+-[0-9][0-9]"}).result(
                    timeout_s=120)),
        }
        stats = h.remote({"path": "/v1/stats"}).result(timeout_s=60)
        serve.delete("par")
        return out, set(stats)

    (jout, jkeys), (tout, tkeys) = twin(pkgs, scn)
    assert tout == jout
    assert tout["completion"]["usage"]["completion_tokens"] == 12
    joined = "".join(c["choices"][0]["text"] for c in tout["stream"])
    assert joined == tout["completion"]["choices"][0]["text"]
    assert len(tout["stream"]) == 13  # a chunk a token, then the stop chunk
    assert tout["choice"]["choices"][0]["text"] in ("yes", "no", "maybe")
    assert re.fullmatch(r"[A-Z][a-z]+-[0-9][0-9]",
                        tout["regex"]["choices"][0]["text"])
    assert tkeys - jkeys == PORT_ONLY_STATS
    assert jkeys - tkeys == JAX_ONLY_STATS


def _rand_adapter(seed, scale=0.1):
    rng = np.random.default_rng(seed)
    L, E, H, Hkv, Dh = TINY["n_layers"], TINY["d_model"], TINY["n_heads"], \
        TINY["n_kv_heads"], TINY["d_model"] // TINY["n_heads"]
    return {"A_q": rng.normal(0, scale, (L, E, RANK)).astype(np.float32),
            "B_q": rng.normal(0, scale, (L, RANK, H, Dh)).astype(np.float32),
            "A_v": rng.normal(0, scale, (L, E, RANK)).astype(np.float32),
            "B_v": rng.normal(0, scale, (L, RANK, Hkv, Dh))
            .astype(np.float32)}


def test_lora_served_through_multiplex(pkgs, ckpt, tmp_path):
    """Requests whose `model` names an adapter load it from
    dynamic_lora_loading_path through the multiplex cache; the LRU evicts
    and reloads; both servers give the same text on the same weights."""
    adir = tmp_path / "adapters"
    adir.mkdir()
    for name, seed in (("ad1", 11), ("ad2", 12)):
        np.savez(adir / f"{name}.npz", alpha=np.float32(RANK),
                 **_rand_adapter(seed))
    np.savez(adir / "adzero.npz", **{k: np.zeros_like(v) for k, v in
                                     _rand_adapter(0).items()})
    body = {"prompt": "hello", "max_tokens": 8, "temperature": 0.0}

    def scn(rt):
        serve = serve_of(rt)
        h = serve.run(_llm(rt).build_openai_app(
            _config(rt, ckpt, lora_dir=str(adir))), name="llm",
            route_prefix="/llm")

        def ask(model=None):
            b = body if model is None else {**body, "model": model}
            out = h.call_sync({"path": "/llm/completions", "method": "POST",
                               "body": b}, timeout_s=120)
            return out["model"], out["choices"][0]["text"]

        base, zero, one, two, again = (ask(), ask("adzero"), ask("ad1"),
                                       ask("ad2"), ask("ad1"))
        try:
            h.call_sync({"path": "/llm/completions", "method": "POST",
                         "body": {**body, "model": "adbogus"}},
                        timeout_s=60)
            bogus = None
        except Exception as e:  # noqa: BLE001 — the message is the result
            bogus = bool(re.search("adbogus|FileNotFound", str(e)))
        serve.delete("llm")
        return base, zero, one, two, again, bogus

    base, zero, one, two, again, bogus = same(pkgs, scn)
    assert zero == ("adzero", base[1])  # a zero adapter is the base model
    assert one[1] != base[1] and two[0] == "ad2"
    assert again == one  # the evicted adapter reloads
    assert bogus is True


def test_cancelled_stream_aborts_the_engine_request(pkgs):
    """The replica's cancel hook reaches engine.abort_request: a stream
    cancelled after its first chunk frees its slot long before its 100
    tokens."""
    def scn(rt):
        serve = serve_of(rt)
        h = serve.run(_llm(rt).build_openai_app(_config(rt, max_len=128)),
                      name="cx", route_prefix="/cx")
        gen = h.options(stream=True, method_name="completions_stream").remote(
            {"prompt": "abc", "max_tokens": 100})
        next(iter(gen))
        gen.cancel()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            st = h.engine_stats.remote().result(timeout_s=30)
            if st["aborts"] >= 1 and st["free_slots"] == st["max_slots"]:
                break
            time.sleep(0.1)
        serve.delete("cx")
        return st["aborts"], st["free_slots"] == st["max_slots"]

    same(pkgs, scn, (1, True))
