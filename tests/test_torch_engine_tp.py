"""LLMEngine(mesh=tp 2) over 2 gloo ranks on the CPU, every rank emitting
the same tokens, greedy token-exact against ray_tpu's TPUEngine on a
2-device ``Mesh(devs[:2], ("tp",))`` with the same options, prompts and
adapter (twins of tests/test_llm_paged.py's tensor-parallel tests): slot
and paged layouts with a concurrent batch, the prefix cache with chunked
prefill, speculative decoding, LoRA, an abort and an expired deadline
(tokens and counters); and against the unmeshed LLMEngine. PD admission
(``submit_prefilled``) is refused under the mesh.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import parallel
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as ttr

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
SLOT = dict(max_slots=2, max_len=64, min_bucket=8)
PAGED = dict(max_slots=4, max_len=64, min_bucket=8, kv_layout="paged",
             page_size=8)
PROMPTS = [[1, 5, 9, 2, 7, 4], [3, 1, 4, 1, 5], [7] * 20,
           list(range(30, 70))]
# the engine options under the mesh (the JAX engine refuses none of them
# there), each against the unmeshed engine with the same options
OPTIONS = {
    "prefix_chunk": dict(PAGED, enable_prefix_cache=True, prefill_chunk=16),
    "speculative": dict(SLOT, speculative_k=3),
    "lora": dict(SLOT, max_loras=1, lora_rank=4),
}


def _adapter():
    rng = np.random.default_rng(5)
    L, E, H, Hkv, Dh, r = 2, 64, 4, 2, 16, 4
    return {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
            for k, s in (("A_q", (L, E, r)), ("B_q", (L, r, H, Dh)),
                         ("A_v", (L, E, r)), ("B_v", (L, r, Hkv, Dh)))}


def _port_engine(params, mesh=None):
    """Engine factory: the port's LLMEngine on the CPU."""
    return lambda **options: LLMEngine(_tcfg(), params, device="cpu",
                                       mesh=mesh, **options)


def _serve_option(make, SP, name):
    """The option's traffic on the engine `make(**options)` builds, with
    the engine's SamplingParams class `SP`: a shared 24-token prefix with
    two suffixes (prefix cache, 16-token chunks), repetitive prompts
    (speculation), an adapter on one of two rows (LoRA)."""
    eng = make(**OPTIONS[name])
    try:
        if name == "lora":
            eng.load_lora("a", _adapter())
            reqs = [eng.submit(PROMPTS[0], SP(max_tokens=8)),
                    eng.submit(PROMPTS[0], SP(max_tokens=8), lora="a")]
        elif name == "speculative":
            reqs = [eng.submit([1, 2, 3] * 6, SP(max_tokens=16)),
                    eng.submit(PROMPTS[3], SP(max_tokens=16))]
        else:
            shared = list(range(40, 64))
            first = eng.generate(shared + [1, 2], SP(max_tokens=4))
            reqs = [eng.submit(shared + [3, 4, 5], SP(max_tokens=6)),
                    eng.submit(PROMPTS[3], SP(max_tokens=6))]
        outs = [list(r) for r in reqs]
        if name == "prefix_chunk":
            outs.insert(0, first)
        st = eng.stats()
    finally:
        eng.shutdown()
    keep = {k: st[k] for k in ("prefix_cache", "speculative", "free_pages",
                               "prefill_chunks_run") if k in st}
    return {"outs": outs, "stats": keep}


def _cancel(make, SP, errors):
    """An abort (a long request cancelled as soon as it is submitted) and an
    expired deadline, then a request that must still be served: under a
    mesh the ranks agree on both before acting on them. `errors` is the
    engine's (RequestCancelledError, DeadlineExceededError)."""
    import time

    eng = make(**SLOT)
    out = []
    try:
        long = eng.submit([1, 2, 3], SP(max_tokens=60))
        eng.abort_request(long.rid)
        late = eng.submit([4, 5], SP(max_tokens=4),
                          deadline_ts=time.time() - 1.0)
        for req, err in zip((long, late), errors):
            try:
                list(req)
                out.append("served")
            except err:
                out.append(err.__name__)
        out.append(eng.generate(PROMPTS[1], SP(max_tokens=4)))
        out.append(eng.stats()["aborts"])
    finally:
        eng.shutdown()
    return out


def _tcfg():
    return ttr.TransformerConfig(**TINY, dtype=torch.float32)


def _serve(make, SP, options, max_tokens):
    """Every prompt submitted at once (the same order on every rank), then
    read back; plus the second prompt alone."""
    eng = make(**options)
    try:
        reqs = [eng.submit(p, SP(max_tokens=max_tokens)) for p in PROMPTS]
        batched = [list(r) for r in reqs]
        single = eng.generate(PROMPTS[1], SP(max_tokens=6))
        st = eng.stats()
    finally:
        eng.shutdown()
    return {"batched": batched, "single": single,
            "free_pages": st.get("free_pages"),
            "num_pages": st.get("num_pages")}


def _port_errors():
    from ray_tpu_torch.exceptions import (DeadlineExceededError,
                                          RequestCancelledError)

    return RequestCancelledError, DeadlineExceededError


def _tp_rank(jparams):
    from ray_tpu_torch.parallel import MeshSpec

    params = convert.params_from_jax(jparams, _tcfg(), "cpu")
    mesh = MeshSpec(tp=2).build()
    make = _port_engine(params, mesh)
    out = {}
    for name, options in (("slot", SLOT), ("paged", PAGED)):
        out[name] = _serve(make, SamplingParams, options, 8)
        eng = make(**options)
        try:  # the rank-local state: n_kv_heads / tp heads, contiguous
            key = "kp" if name == "paged" else "k"
            out[name]["kv_shape"] = tuple(eng.state[key].shape)
            out[name]["kv_contiguous"] = eng.state[key].is_contiguous()
            out[name]["wq"] = tuple(eng.params["layers"]["attn"]["wq"].shape)
        finally:
            eng.shutdown()
    for name in OPTIONS:
        out[name] = _serve_option(make, SamplingParams, name)
    out["cancel"] = _cancel(make, SamplingParams, _port_errors())
    eng = make(**PAGED)
    try:  # PD admission is refused under the mesh, before any request
        page = torch.zeros((2, 8, 2, 16))
        eng.submit_prefilled(length=3, first_token=1, k_pages=[page],
                             v_pages=[page])
    except NotImplementedError as e:
        out["pd_refusal"] = str(e)
    finally:
        eng.shutdown()
    return out


@pytest.fixture(scope="module")
def tiny():
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import transformer as jtr

    jcfg = jtr.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    jparams = jax.tree.map(np.asarray, jtr.init(jax.random.PRNGKey(0), jcfg))
    return jcfg, jparams


@pytest.fixture(scope="module")
def world(tiny):
    return parallel.launch(_tp_rank, 2, args=(tiny[1],), backend="gloo",
                           device="cpu", timeout=90)


def _tpu_engine(tiny):
    """Engine factory: ray_tpu's TPUEngine on a 2-device tp mesh of the
    conftest's fake CPU devices."""
    import jax
    from jax.sharding import Mesh

    from ray_tpu.llm import TPUEngine

    jcfg, jparams = tiny
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("tp",))
    params = jax.tree.map(jax.numpy.asarray, jparams)
    return lambda **options: TPUEngine(jcfg, params, mesh=mesh, **options)


def _jsp(**kw):
    from ray_tpu.llm import SamplingParams as JSamplingParams

    return JSamplingParams(temperature=0.0, **kw)


def _unmeshed(tiny):
    return _port_engine(convert.params_from_jax(tiny[1], _tcfg(), "cpu"))


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_tensor_parallel_engine_token_exact(tiny, world, layout):
    """Twin of test_tensor_parallel_engine_matches_single_chip (slot) and
    test_tensor_parallel_paged_engine (paged): TPUEngine on a 2-device tp
    mesh serving the same concurrent batch and single prompt, every rank
    the same tokens and the same free pages."""
    options = SLOT if layout == "slot" else PAGED
    want = _serve(_tpu_engine(tiny), _jsp, options, 8)
    for r in world:
        for key in ("batched", "single", "free_pages", "num_pages"):
            assert r[layout][key] == want[key], key
    assert world[0][layout] == world[1][layout]


@pytest.mark.parametrize("layout", ["slot", "paged"])
def test_tensor_parallel_engine_matches_unmeshed_engine(tiny, world, layout):
    options = SLOT if layout == "slot" else PAGED
    want = _serve(_unmeshed(tiny), SamplingParams, options, 8)
    for r in world:
        assert r[layout]["batched"] == want["batched"]
        assert r[layout]["free_pages"] == want["free_pages"]


def test_rank_local_state_is_contiguous_kv_head_shard(world):
    for r in world:
        # [L, slots, max_len, Hkv/tp, Dh] and [L, pages, P, Hkv/tp, Dh]
        assert r["slot"]["kv_shape"] == (2, 2, 64, 1, 16)
        assert r["paged"]["kv_shape"][3:] == (1, 16)
        assert r["slot"]["kv_contiguous"] and r["paged"]["kv_contiguous"]
        assert r["slot"]["wq"] == (2, 64, 2, 16)  # q heads 4 → 2 a rank


@pytest.mark.parametrize("name", list(OPTIONS))
def test_engine_options_under_the_mesh_match_unmeshed(tiny, world, name):
    want = _serve_option(_unmeshed(tiny), SamplingParams, name)
    for r in world:
        assert r[name] == want
    if name == "prefix_chunk":
        assert want["stats"]["prefix_cache"]["hits"] >= 1
    if name == "speculative":
        assert want["stats"]["speculative"]["accepted"] > 0


@pytest.mark.parametrize("name", list(OPTIONS))
def test_engine_options_under_the_mesh_match_tpu_engine(tiny, world, name):
    """Each option under the mesh against TPUEngine on its 2-device tp
    mesh with the same option, traffic and adapter: tokens and counters."""
    want = _serve_option(_tpu_engine(tiny), _jsp, name)
    for r in world:
        assert r[name] == want


def test_abort_and_deadline_agreed_across_ranks(tiny, world):
    from ray_tpu.exceptions import (DeadlineExceededError,
                                    RequestCancelledError)

    want = _cancel(_unmeshed(tiny), SamplingParams, _port_errors())
    assert want[:2] == ["RequestCancelledError", "DeadlineExceededError"]
    assert want[3] == 2
    ref = _cancel(_tpu_engine(tiny), _jsp,
                  (RequestCancelledError, DeadlineExceededError))
    for r in world:
        assert r["cancel"] == want == ref


def test_submit_prefilled_under_mesh_is_refused_naming_roadmap(world):
    """A tp rank's pool holds n_kv_heads / tp heads and a ticket's channel
    has one reader: PD admission under mesh= raises and names its
    ROADMAP.md item."""
    for r in world:
        assert "mesh" in r["pd_refusal"]
        assert "ROADMAP.md Queue 1" in r["pd_refusal"]
