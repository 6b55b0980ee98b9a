"""PD disaggregation in the port: ray_tpu_torch's paged-KV shm transfer
plane, LLMEngine.submit_prefilled and the prefill coalescer, on the CPU.

Twins of tests/test_llm_pd.py on the same tiny f32 model (the JAX
package's ``transformer.init(PRNGKey(0))`` weights through
``convert.params_from_jax``): the port's handoff (port prefill → port
exporter → port puller → port engine) is greedy token-exact to the JAX
package's TPUEngine serving the same prompts monolithically, in every form
of submit_prefilled and on both layouts. Plus prefill_batch against the
JAX function, the coalescer, and the ticket and config against the JAX
package's. The refusal under ``mesh=`` is pinned in
test_torch_engine_tp.py, whose gloo world builds meshed engines.
"""

import dataclasses
import glob
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import SamplingParams as JSamplingParams, TPUEngine
from ray_tpu.models import transformer as jtr
from ray_tpu_torch._private.constants import (SHM_CHANNEL_GLOB,
                                              SHM_CHANNEL_PREFIX, SHM_DIR)
from ray_tpu_torch.llm import LLMEngine, SamplingParams
from ray_tpu_torch.llm.engine import bucket_for
from ray_tpu_torch.llm.kv_transfer import (BatchedKVPuller, KVPageStream,
                                           KVTransferError, PagedKVExporter,
                                           pull_all, pull_pages)
from ray_tpu_torch.models import convert, decoding
from ray_tpu_torch.models import transformer as ttr

pytestmark = pytest.mark.pd

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
PAGE = 16
MAX_LEN = 64
TOL = 2e-5  # f32 on both sides; matmul summation order differs
# 1, 2, 4 and 4 pages: sync tickets and threaded ones (prefetch 2)
PROMPTS = [[1, 5, 9, 2, 7], [3] * 20, list(range(2, 35)), list(range(2, 50))]
JOIN_S = 60.0


@pytest.fixture(scope="module")
def tiny():
    jcfg = jtr.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    tcfg = ttr.TransformerConfig(**TINY, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    return jcfg, jparams, tcfg, tparams


def _engine_kw(layout: str, kw: dict) -> dict:
    if layout == "paged":
        base = dict(max_slots=4, max_len=MAX_LEN, min_bucket=PAGE,
                    kv_layout="paged", page_size=PAGE)
    else:
        base = dict(max_slots=2, max_len=MAX_LEN, min_bucket=PAGE)
    return {**base, **kw}


def _port_engine(tiny, layout="paged", **kw):
    return LLMEngine(tiny[2], tiny[3], device="cpu", **_engine_kw(layout, kw))


def _tpu_engine(tiny, layout="paged", **kw):
    return TPUEngine(tiny[0], tiny[1], **_engine_kw(layout, kw))


def _jax_generate(tiny, prompts, max_tokens, layout="paged"):
    """The JAX package's monolithic engine serving `prompts` one after the
    other: (outputs, stats)."""
    eng = _tpu_engine(tiny, layout)
    try:
        outs = [eng.generate(p, JSamplingParams(max_tokens=max_tokens,
                                                temperature=0.0))
                for p in prompts]
        return outs, eng.stats()
    finally:
        eng.shutdown()


def _prefill_ticket(tiny, prompt, exporter, *, page_size=PAGE,
                    min_bucket=PAGE, max_len=MAX_LEN):
    """The prefill half of the PD path in the port: prompt forward →
    greedy first token → page export."""
    tcfg, tparams = tiny[2], tiny[3]
    n = len(prompt)
    bucket = bucket_for(n, min_bucket, max_len)
    padded = torch.zeros((1, bucket), dtype=torch.int64)
    padded[0, :n] = torch.as_tensor(prompt)
    logits, kv = decoding.prefill(tparams, padded, n, tcfg)
    first = int(torch.argmax(logits))
    return exporter.export(kv["k"], kv["v"], n, first, page_size)


def _shm_channels() -> set:
    return set(glob.glob(SHM_CHANNEL_GLOB))


def _wait(pred, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)


def _submit(dec, form, ticket, sp, puller):
    """One transferred request through `form` of submit_prefilled."""
    kw = dict(length=ticket["length"], first_token=ticket["first_token"],
              params=sp)
    if form == "stream":
        stream = KVPageStream(ticket["n_pages"], ticket["page_size"])
        puller.pull(ticket, stream, timeout_s=30.0)
        return dec.submit_prefilled(kv_stream=stream, **kw)
    k_pages, v_pages = pull_all(ticket, timeout_s=30.0)
    if form == "pages":
        return dec.submit_prefilled(k_pages=k_pages, v_pages=v_pages, **kw)
    return dec.submit_prefilled(torch.cat(k_pages, dim=1),
                                torch.cat(v_pages, dim=1), **kw)


COUNTERS = ("decode_steps", "active", "free_slots", "aborts", "free_pages")


@pytest.mark.parametrize("form", ["whole", "pages", "stream"])
@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_pd_handoff_token_exact_vs_tpu_engine(tiny, layout, form):
    """Twin of test_pd_page_handoff_token_exact, over every form of
    submit_prefilled and both layouts: the port's prefill → exporter →
    pull → submit_prefilled emits exactly the tokens of TPUEngine serving
    the same prompts monolithically, with the same counters."""
    want, jst = _jax_generate(tiny, PROMPTS, 8, layout)
    dec = _port_engine(tiny, layout)
    exporter = PagedKVExporter(send_timeout_s=10.0)
    puller = BatchedKVPuller()
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    try:
        got = []
        for prompt in PROMPTS:
            ticket = _prefill_ticket(tiny, prompt, exporter)
            assert ticket["n_pages"] == bucket_for(
                len(prompt), PAGE, MAX_LEN) // PAGE
            req = _submit(dec, form, ticket, sp, puller)
            got.append([ticket["first_token"]] + list(req))
        assert got == want
        st = dec.stats()
        assert st["prefills"] == 0 and st["streaming"] == 0
        assert {k: st[k] for k in COUNTERS if k in jst} == \
            {k: jst[k] for k in COUNTERS if k in jst}
    finally:
        exporter.teardown()
        puller.teardown()
        dec.shutdown()


def test_pd_transfer_metrics_counted(tiny):
    from ray_tpu_torch.util import metrics as met

    exporter = PagedKVExporter(send_timeout_s=10.0)
    try:
        ticket = _prefill_ticket(tiny, list(range(1, 20)), exporter)
        pull_all(ticket, timeout_s=10.0)
        by_name = {m["name"]: m for m in met.snapshot()}
        pages = sum(v for _t, v in
                    by_name["ray_tpu_llm_pd_kv_pages_total"]["series"])
        bytes_ = sum(v for _t, v in
                     by_name["ray_tpu_llm_pd_transfer_bytes_total"]["series"])
        assert pages >= ticket["n_pages"]
        assert bytes_ > 0
    finally:
        exporter.teardown()


def test_decode_slot_admission_under_concurrency(tiny):
    """More transferred requests than decode slots AND a page pool too
    small to host them all at once: the backlog path drains everything,
    token-exact to TPUEngine, without cross-contamination."""
    prompts = [[i + 1] * 20 for i in range(6)]
    want, _ = _jax_generate(tiny, prompts, 8)
    # 2 slots, pool of 5 usable pages; each request needs 2 → at most two
    # resident, the rest ride the backlog
    dec = _port_engine(tiny, max_slots=2, num_pages=6)
    exporter = PagedKVExporter(send_timeout_s=30.0)
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    try:
        got = [None] * len(prompts)

        def run(i):
            ticket = _prefill_ticket(tiny, prompts[i], exporter)
            k_pages, v_pages = pull_all(ticket, timeout_s=30.0)
            req = dec.submit_prefilled(
                length=ticket["length"], first_token=ticket["first_token"],
                params=sp, k_pages=k_pages, v_pages=v_pages)
            got[i] = [ticket["first_token"]] + list(req)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        _join(threads)
        assert got == want
        st = dec.stats()
        assert st["active"] == 0 and st["free_pages"] == 5
    finally:
        exporter.teardown()
        dec.shutdown()


def test_transfer_plane_teardown_no_shm_leaks(tiny):
    """Completed, never-pulled, and aborted transfers all retire their
    /dev/shm segments (under the port's own prefix)."""
    before = _shm_channels()
    exporter = PagedKVExporter(send_timeout_s=30.0)
    # short fuse ONLY for the never-pulled leg
    impatient = PagedKVExporter(send_timeout_s=0.5)
    prompt = list(range(1, 20))
    t1 = _prefill_ticket(tiny, prompt, exporter)
    pull_all(t1, timeout_s=10.0)
    # never pulled: the sender times out (0.5s) and unlinks on its own
    _prefill_ticket(tiny, prompt, impatient)
    t3 = _prefill_ticket(tiny, prompt, exporter)
    exporter.abort(t3["ticket"])
    assert _wait(lambda: exporter.pending() == 0)
    assert _wait(lambda: impatient.pending() == 0)
    exporter.teardown()
    impatient.teardown()
    assert _wait(lambda: _shm_channels() - before == set()), \
        f"leaked: {_shm_channels() - before}"


def test_prefill_death_mid_transfer_clean_error(tiny):
    """A prefill side dying mid-transfer surfaces as KVTransferError naming
    the ticket; the decode engine keeps serving."""
    dec = _port_engine(tiny)
    exporter = PagedKVExporter(send_timeout_s=10.0)
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    try:
        ticket = _prefill_ticket(tiny, list(range(1, 40)), exporter)
        assert ticket["n_pages"] >= 3
        pulled = []
        with pytest.raises(KVTransferError) as ei:
            for i, kp, vp in pull_pages(ticket, timeout_s=10.0):
                pulled.append(i)
                if len(pulled) == 1:
                    exporter.abort(ticket["ticket"])  # the prefill dies
        assert ticket["ticket"] in str(ei.value)
        assert len(pulled) < ticket["n_pages"]

        # a ticket whose channel is already gone:
        with pytest.raises(KVTransferError, match="not found"):
            list(pull_pages({**ticket, "ticket": "tkt2",
                             "path": f"{SHM_DIR}/{SHM_CHANNEL_PREFIX}gone"},
                            1.0))

        # the decode pool is unharmed: a fresh request serves end to end
        want, _ = _jax_generate(tiny, [[1, 5, 9]], 8)
        t2 = _prefill_ticket(tiny, [1, 5, 9], exporter)
        k_pages, v_pages = pull_all(t2, timeout_s=10.0)
        req = dec.submit_prefilled(
            length=t2["length"], first_token=t2["first_token"], params=sp,
            k_pages=k_pages, v_pages=v_pages)
        assert [t2["first_token"]] + list(req) == want[0]
    finally:
        exporter.teardown()
        dec.shutdown()


def test_submit_prefilled_exact_fit_and_validation(tiny):
    """length + max_tokens == max_len exactly fits; one past it is refused.
    Mixed and mismatched page forms are refused."""
    dec = _port_engine(tiny)
    exporter = PagedKVExporter(send_timeout_s=10.0)
    try:
        ticket = _prefill_ticket(tiny, [1, 5, 9, 2, 7], exporter)
        k_pages, v_pages = pull_all(ticket, timeout_s=10.0)
        n = ticket["length"]
        req = dec.submit_prefilled(
            length=n, first_token=ticket["first_token"],
            params=SamplingParams(max_tokens=MAX_LEN - n),
            k_pages=k_pages, v_pages=v_pages)
        out = [ticket["first_token"]] + list(req)
        assert len(out) == MAX_LEN - n
        with pytest.raises(ValueError, match="does not fit"):
            dec.submit_prefilled(
                length=n, first_token=0,
                params=SamplingParams(max_tokens=MAX_LEN - n + 1),
                k_pages=k_pages, v_pages=v_pages)
        with pytest.raises(ValueError, match="not both"):
            dec.submit_prefilled(k_pages[0], v_pages[0], n, 0,
                                 k_pages=k_pages, v_pages=v_pages)
        with pytest.raises(ValueError, match="equal-length"):
            dec.submit_prefilled(length=n, first_token=0,
                                 k_pages=k_pages, v_pages=[])
    finally:
        exporter.teardown()
        dec.shutdown()


def test_streamed_admission_token_exact_partial_pages(tiny):
    """A SLOW sender streams pages while the decode engine keeps emitting
    tokens for another request, and the slow request's output is still
    token-exact to TPUEngine. The fast request finishes while the slow
    transfer is still open (the overlap, observed)."""
    prompt = list(range(2, 50))
    fast_prompt = [1, 5, 9]
    want, _ = _jax_generate(tiny, [prompt], 8)
    fast_want, _ = _jax_generate(tiny, [fast_prompt], 6)
    dec = _port_engine(tiny)
    # one page per message, 120ms apart: a 4-page transfer stays open
    # ~0.5s while decode runs
    slow = PagedKVExporter(send_timeout_s=30.0, prefetch_pages=1,
                           page_interval_s=0.12)
    puller = BatchedKVPuller()
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    try:
        ticket = _prefill_ticket(tiny, prompt, slow)
        assert ticket["n_pages"] >= 3 and not ticket.get("sync")
        stream = KVPageStream(ticket["n_pages"], ticket["page_size"])
        puller.pull(ticket, stream, timeout_s=30.0)
        req = dec.submit_prefilled(
            length=ticket["length"], first_token=ticket["first_token"],
            params=sp, kv_stream=stream)
        # while pages stream, a fresh request decodes end to end
        fast = dec.submit(fast_prompt, SamplingParams(max_tokens=6,
                                                      temperature=0.0))
        fast_got = list(fast)
        fast_done_ts = time.time()
        assert fast_got == fast_want[0]
        got = [ticket["first_token"]] + list(req)
        assert got == want[0]
        assert stream.finished_ts is not None
        assert fast_done_ts < stream.finished_ts, \
            "decode did not emit while pages were still streaming"
        st = dec.stats()
        assert st["streaming"] == 0 and st["active"] == 0
    finally:
        slow.teardown()
        puller.teardown()
        dec.shutdown()


def test_prefill_death_mid_stream_after_first_page(tiny):
    """The prefill side dies AFTER the first page was adopted: the request
    fails with a per-request KVTransferError, the slot and every granted
    page are reclaimed, no /dev/shm leaks, and the engine keeps serving."""
    before = _shm_channels()
    dec = _port_engine(tiny)
    slow = PagedKVExporter(send_timeout_s=30.0, prefetch_pages=1,
                           page_interval_s=0.1)
    exporter = PagedKVExporter(send_timeout_s=10.0)
    puller = BatchedKVPuller()
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    try:
        free_pages0 = dec.stats()["free_pages"]
        ticket = _prefill_ticket(tiny, list(range(2, 50)), slow)
        stream = KVPageStream(ticket["n_pages"], ticket["page_size"])
        puller.pull(ticket, stream, timeout_s=30.0)
        req = dec.submit_prefilled(
            length=ticket["length"], first_token=ticket["first_token"],
            params=sp, kv_stream=stream)
        assert _wait(lambda: stream.fed >= 1)
        slow.abort(ticket["ticket"])  # the prefill side dies mid-stream
        with pytest.raises(KVTransferError) as ei:
            list(req)
        assert ticket["ticket"] in str(ei.value)
        assert _wait(lambda: dec.stats()["streaming"] == 0)
        st = dec.stats()
        assert st["active"] == 0
        assert st["free_slots"] == st["max_slots"]
        assert st["free_pages"] == free_pages0
        # the engine keeps serving (streamed path)
        want, _ = _jax_generate(tiny, [[1, 5, 9]], 8)
        t2 = _prefill_ticket(tiny, [1, 5, 9], exporter)
        s2 = KVPageStream(t2["n_pages"], t2["page_size"])
        puller.pull(t2, s2, timeout_s=10.0)
        req2 = dec.submit_prefilled(
            length=t2["length"], first_token=t2["first_token"], params=sp,
            kv_stream=s2)
        assert [t2["first_token"]] + list(req2) == want[0]
        assert _wait(lambda: slow.pending() == 0)
        assert _wait(lambda: exporter.pending() == 0)
    finally:
        slow.teardown()
        exporter.teardown()
        puller.teardown()
        dec.shutdown()
    assert _wait(lambda: _shm_channels() - before == set()), \
        f"leaked: {_shm_channels() - before}"


def test_batched_puller_multiplexes_concurrent_transfers(tiny):
    """One puller drives N concurrent transfers, and the drain path retires
    a ticket without adopting it."""
    before = _shm_channels()
    # threaded (non-sync) tickets, so the puller multiplexes live channels
    exporter = PagedKVExporter(send_timeout_s=30.0, prefetch_pages=1,
                               page_interval_s=0.01)
    puller = BatchedKVPuller()
    prompts = [[i + 1] * 40 for i in range(4)]
    try:
        tickets = [_prefill_ticket(tiny, p, exporter) for p in prompts]
        streams = [KVPageStream(t["n_pages"], t["page_size"])
                   for t in tickets]
        for t, s in zip(tickets, streams):
            puller.pull(t, s, timeout_s=30.0)
        assert _wait(lambda: all(s.finished_ts for s in streams))
        for t, s in zip(tickets, streams):
            got = sorted(i for i, _k, _v in s.take_ready())
            assert got == list(range(t["n_pages"]))
        assert puller.pending() == 0
        t = _prefill_ticket(tiny, prompts[0], exporter)
        puller.drain(t, timeout_s=30.0)
        assert _wait(lambda: exporter.pending() == 0)
    finally:
        exporter.teardown()
        puller.teardown()
    assert _wait(lambda: _shm_channels() - before == set())


def test_transfer_roundtrip_bfloat16():
    """bf16 KV crosses the raw wire bit-exactly on both the sync and the
    threaded path (through a uint8 view: numpy has no bf16)."""
    g = torch.Generator().manual_seed(0)
    k = torch.randn((2, 32, 2, 16), generator=g).to(torch.bfloat16)
    v = torch.randn((2, 32, 2, 16), generator=g).to(torch.bfloat16)
    sync_ex = PagedKVExporter(send_timeout_s=10.0)
    slow_ex = PagedKVExporter(send_timeout_s=10.0, prefetch_pages=1,
                              page_interval_s=0.01)  # forces threaded
    puller = BatchedKVPuller()
    try:
        t = sync_ex.export(k, v, 20, 7, 16)
        assert t["sync"] and t["dtype"] == "bfloat16"
        kp, vp = pull_all(t, timeout_s=10.0)
        assert kp[0].dtype == torch.bfloat16
        for i in range(t["n_pages"]):
            assert torch.equal(kp[i], k[:, i * 16:(i + 1) * 16])
            assert torch.equal(vp[i], v[:, i * 16:(i + 1) * 16])
        t2 = slow_ex.export(k, v, 20, 7, 16)
        assert not t2["sync"]
        stream = KVPageStream(t2["n_pages"], 16)
        puller.pull(t2, stream, timeout_s=10.0)
        assert _wait(lambda: stream.finished_ts is not None)
        ready = sorted(stream.take_ready(), key=lambda x: x[0])
        assert [i for i, _k, _v in ready] == list(range(t2["n_pages"]))
        for i, kpage, vpage in ready:
            assert torch.equal(kpage, k[:, i * 16:(i + 1) * 16])
            assert torch.equal(vpage, v[:, i * 16:(i + 1) * 16])
    finally:
        sync_ex.teardown()
        slow_ex.teardown()
        puller.teardown()


def test_submit_prefilled_kv_stream_validation(tiny):
    dec = _port_engine(tiny)
    try:
        stream = KVPageStream(2, PAGE)
        with pytest.raises(ValueError, match="kv_stream alone"):
            dec.submit_prefilled(length=5, first_token=0,
                                 k_pages=[None], v_pages=[None],
                                 kv_stream=stream)
        with pytest.raises(ValueError, match="must agree"):
            dec.submit_prefilled(length=5, first_token=0,
                                 kv_stream=KVPageStream(2, PAGE * 2))
        with pytest.raises(ValueError, match="needs k/v"):
            dec.submit_prefilled(length=5, first_token=0)
    finally:
        dec.shutdown()


def test_submit_prefilled_pages_on_slot_engine(tiny):
    """A slot-layout decode engine accepts page-form packs (assembled on
    the host) and the whole-array form, both token-exact to TPUEngine."""
    prompt = [1, 5, 9, 2, 7]
    want, _ = _jax_generate(tiny, [prompt], 8, "slot")
    dec = _port_engine(tiny, "slot")
    exporter = PagedKVExporter(send_timeout_s=10.0)
    sp = SamplingParams(max_tokens=8, temperature=0.0)
    try:
        ticket = _prefill_ticket(tiny, prompt, exporter)
        k_pages, v_pages = pull_all(ticket, timeout_s=10.0)
        req = dec.submit_prefilled(
            length=ticket["length"], first_token=ticket["first_token"],
            params=sp, k_pages=k_pages, v_pages=v_pages)
        assert [ticket["first_token"]] + list(req) == want[0]
        # whole-array form, as numpy arrays
        k = np.concatenate([p.numpy() for p in k_pages], axis=1)
        v = np.concatenate([p.numpy() for p in v_pages], axis=1)
        req = dec.submit_prefilled(k, v, ticket["length"],
                                   ticket["first_token"], sp)
        assert [ticket["first_token"]] + list(req) == want[0]
    finally:
        exporter.teardown()
        dec.shutdown()


def test_budget_spent_by_first_token_frees_the_slot(tiny):
    """max_tokens=1: the transferred first token is the whole output; the
    engine ends the request at admission without adopting anything."""
    dec = _port_engine(tiny)
    exporter = PagedKVExporter(send_timeout_s=10.0)
    puller = BatchedKVPuller()
    try:
        ticket = _prefill_ticket(tiny, list(range(2, 50)), exporter)
        req = _submit(dec, "pages", ticket, SamplingParams(max_tokens=1),
                      puller)
        assert list(req) == []
        st = dec.stats()
        assert st["free_slots"] == st["max_slots"] and st["decode_steps"] == 0
        # the drain path consumes a ticket without adopting it
        t2 = _prefill_ticket(tiny, list(range(2, 50)), exporter)
        puller.drain(t2, timeout_s=10.0)
        assert _wait(lambda: exporter.pending() == 0)
    finally:
        exporter.teardown()
        puller.teardown()
        dec.shutdown()


# ----------------------------------------------------- the prefill tier


def test_prefill_batch_matches_jax(tiny):
    """decoding.prefill_batch against the JAX function: rows of unequal
    length in one bucket, logits at each row's last position and the KV."""
    from ray_tpu.models import decoding as jdec

    jcfg, jparams, tcfg, tparams = tiny
    rng = np.random.default_rng(3)
    lengths = np.asarray([5, 32, 17], np.int32)
    tokens = np.zeros((3, 32), np.int32)
    for b, n in enumerate(lengths):
        tokens[b, :n] = rng.integers(1, 128, size=n)
    jl, jkv = jdec.prefill_batch(jparams, jnp.asarray(tokens),
                                 jnp.asarray(lengths), jcfg)
    tl, tkv = decoding.prefill_batch(tparams, torch.as_tensor(
        tokens, dtype=torch.int64), lengths, tcfg)
    assert tl.shape == (3, 128) and tkv["k"].shape == (2, 3, 32, 2, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tkv[key].numpy(), np.asarray(jkv[key]),
                                   atol=TOL, rtol=TOL)


def _coalescer(tiny, **kw):
    from ray_tpu_torch.llm.pd import PrefillCoalescer

    return PrefillCoalescer(tiny[3], tiny[2], min_bucket=PAGE,
                            max_len=MAX_LEN, **kw)


def _coalesce(co, prompts):
    """Queue every prompt while the baton is held, then release it: the
    batches are then decided by the queue alone, not by thread timing.
    Returns each prompt's result or exception."""
    out = [None] * len(prompts)

    def run(i):
        try:
            out[i] = co.prefill(prompts[i])
        except Exception as e:  # noqa: BLE001 — the test inspects it
            out[i] = e

    with co._cond:
        co._leader_active = True
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    assert _wait(lambda: len(co._pending) == len(prompts))
    with co._cond:
        co._leader_active = False
        co._cond.notify_all()
    _join(threads)
    return out


def test_prefill_coalescer_rows_equal_solo_prefill(tiny):
    """Three prompts of bucket 32 and two of bucket 16: power-of-two takes
    give batches of 2 + 1 and 2, and each row equals its prompt's solo
    prefill."""
    tcfg, tparams = tiny[2], tiny[3]
    prompts = [list(range(2, 22)), [3] * 30, list(range(40, 57)),
               [1, 5, 9], list(range(60, 72))]
    co = _coalescer(tiny, max_batch=4)
    try:
        out = _coalesce(co, prompts)
    finally:
        co.teardown()
    assert (co.batches, co.jobs) == (3, 5)
    for prompt, (logits, k, v, bucket) in zip(prompts, out):
        n = len(prompt)
        assert bucket == bucket_for(n, PAGE, MAX_LEN)
        padded = torch.zeros((1, bucket), dtype=torch.int64)
        padded[0, :n] = torch.as_tensor(prompt)
        sl, skv = decoding.prefill(tparams, padded, n, tcfg)
        torch.testing.assert_close(logits, sl, atol=TOL, rtol=TOL)
        torch.testing.assert_close(k, skv["k"], atol=TOL, rtol=TOL)
        torch.testing.assert_close(v, skv["v"], atol=TOL, rtol=TOL)


def test_prefill_coalescer_error_releases_every_waiter(tiny, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("injected prefill failure")

    monkeypatch.setattr(decoding, "prefill_batch", boom)
    co = _coalescer(tiny, max_batch=4)
    try:
        out = _coalesce(co, [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10]])
    finally:
        co.teardown()
    assert all(isinstance(e, RuntimeError) and "injected" in str(e)
               for e in out)
    assert (co.batches, co.jobs) == (0, 0)
    with pytest.raises(RuntimeError, match="torn down"):
        co.prefill([1, 2])


# ------------------------------------------ the ticket and config vs JAX


def test_ticket_matches_reference_exporter():
    """The port's ticket carries the JAX package's keys, with equal values
    for the same KV (but the ticket id and channel path)."""
    from ray_tpu.llm.kv_transfer import PagedKVExporter as JExporter

    rng = np.random.default_rng(1)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    ours, ref = PagedKVExporter(), JExporter()
    try:
        for args in ((k[:, :16], v[:, :16], 5, 3, 16), (k, v, 50, 7, 16)):
            a = ours.export(torch.as_tensor(args[0]), torch.as_tensor(args[1]),
                            *args[2:])
            b = ref.export(*args)
            assert set(a) == set(b)
            assert {x: a[x] for x in a if x not in ("ticket", "path")} == \
                {x: b[x] for x in b if x not in ("ticket", "path")}
    finally:
        ours.teardown()
        ref.teardown()


def test_pd_config_and_engine_kwargs_match_reference():
    from ray_tpu.llm import config as jconfig
    from ray_tpu.llm import pd as jpd
    from ray_tpu_torch.llm import config as tconfig
    from ray_tpu_torch.llm import pd as tpd

    assert dataclasses.asdict(tconfig.PDConfig()) == \
        dataclasses.asdict(jconfig.PDConfig())
    for ek, pdc in (({}, None), ({"min_bucket": 16}, {"page_size": 32}),
                    ({"kv_layout": "slot"}, None),
                    ({"page_size": 16, "min_bucket": 128}, None)):
        got = tpd._pd_engine_kwargs(tconfig.LLMConfig(
            engine_kwargs=dict(ek),
            pd_config=tconfig.PDConfig(**pdc) if pdc else None))
        want = jpd._pd_engine_kwargs(jconfig.LLMConfig(
            engine_kwargs=dict(ek),
            pd_config=jconfig.PDConfig(**pdc) if pdc else None))
        assert got == want


def test_metrics_record_as_the_reference_registry():
    """The port's metrics module against ray_tpu.util.metrics: the same
    operations give the same snapshot series; get_or_create returns the
    live metric and a fresh one after the registry is cleared."""
    from ray_tpu.util import metrics as jmet
    from ray_tpu_torch.util import metrics as tmet

    def drive(met, suffix):
        c = met.get_or_create(met.Counter, f"pd_test_c_{suffix}", "c")
        assert met.get_or_create(met.Counter, f"pd_test_c_{suffix}") is c
        c.inc(2.0)
        c.inc(1.5, tags={"phase": "prefill"})
        with pytest.raises(ValueError):
            c.inc(-1.0)
        g = met.get_or_create(met.Gauge, f"pd_test_g_{suffix}", "g")
        g.set(4.0)
        g.inc(2.0)
        g.dec(1.0, tags={"x": 1})
        h = met.get_or_create(met.Histogram, f"pd_test_h_{suffix}", "h",
                              boundaries=[0.01, 0.1, 1.0], tag_keys=("p",))
        for x in (0.005, 0.05, 0.5, 5.0, 0.1):
            h.observe(x, tags={"p": "decode"})
        by = {m["name"]: m for m in met.snapshot()}
        return [(by[f"pd_test_{k}_{suffix}"]["kind"],
                 sorted(by[f"pd_test_{k}_{suffix}"]["series"], key=str))
                for k in "cgh"]

    assert drive(tmet, "port") == drive(jmet, "ref")
    c = tmet.get_or_create(tmet.Counter, "pd_test_c_port")
    tmet.clear_registry()
    assert tmet.get_or_create(tmet.Counter, "pd_test_c_port") is not c
    assert [m["name"] for m in tmet.snapshot()] == ["pd_test_c_port"]
