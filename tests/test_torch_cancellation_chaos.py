"""Twins of tests/test_cancellation_chaos.py: clients drop mid-decode under
concurrency, in each package.

Each scenario runs once per package, one after the other (the pacing is
timed), on the package's own exporter, puller, engines and Serve: a side
aborts or drops only its own work and checks only its own shm prefix. The
two sides then agree: the same outcomes, and survivors with the same
tokens (the same f32 weights; the port's are converted from the JAX
package's).
"""

from __future__ import annotations

import glob
import http.client
import importlib
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twins import (private_channel_dirs, serve_of, start_sessions,
                         stop_sessions, twin)

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128)
PAGE = 16
MAX_LEN = 64


@pytest.fixture(scope="module")
def tiny_model():
    """The JAX package's tiny f32 model and the port's copy of it."""
    from ray_tpu.models import transformer as jtr
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models import transformer as ttr

    jcfg = jtr.TransformerConfig(**TINY, dtype=jnp.float32, remat=False)
    tcfg = ttr.TransformerConfig(**TINY, dtype=torch.float32)
    jparams = jtr.init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                      "cpu")
    return {"ray_tpu": (jcfg, jparams), "ray_tpu_torch": (tcfg, tparams)}


class _Side:
    """One package's PD pieces: engines, exporter, puller, the serve-free
    prefill half, its cancellation errors and its shm channel prefix."""

    def __init__(self, pkg: str, model):
        self.pkg = pkg
        self.port = pkg == "ray_tpu_torch"
        self.cfg, self.params = model
        kv = importlib.import_module(f"{pkg}.llm.kv_transfer")
        eng = importlib.import_module(f"{pkg}.llm.engine")
        self.BatchedKVPuller = kv.BatchedKVPuller
        self.KVPageStream = kv.KVPageStream
        self.KVTransferError = kv.KVTransferError
        self.PagedKVExporter = kv.PagedKVExporter
        self.SamplingParams = eng.SamplingParams
        self.bucket_for = eng.bucket_for
        self.Engine = eng.LLMEngine if self.port else eng.TPUEngine
        self.RequestCancelledError = importlib.import_module(
            f"{pkg}.exceptions").RequestCancelledError
        self.prefix = importlib.import_module(
            f"{pkg}._private.constants").SHM_CHANNEL_PREFIX
        self.shm = importlib.import_module(
            f"{pkg}.experimental.channel.mutable_shm")
        self.decoding = importlib.import_module(f"{pkg}.models.decoding")

    def shm_channels(self) -> set:
        """The package's channel segments in its channel directory (a
        per-test one under `private_channels`: the host-wide /dev/shm also
        holds other processes' live channels)."""
        return set(glob.glob(os.path.join(self.shm._DIR, self.prefix + "*")))

    def paged_engine(self, **kw):
        kw.setdefault("max_slots", 4)
        kw.setdefault("max_len", MAX_LEN)
        kw.setdefault("min_bucket", PAGE)
        kw.setdefault("kv_layout", "paged")
        kw.setdefault("page_size", PAGE)
        if self.port:
            kw["device"] = "cpu"
        return self.Engine(self.cfg, self.params, **kw)

    def prefill_ticket(self, prompt, exporter) -> dict:
        """The prefill half of the PD path, serve-free: prompt forward →
        greedy first token → page export."""
        n = len(prompt)
        bucket = self.bucket_for(n, PAGE, MAX_LEN)
        if self.port:
            padded = torch.zeros((1, bucket), dtype=torch.int64)
            padded[0, :n] = torch.as_tensor(prompt)
            logits, kv = self.decoding.prefill(self.params, padded, n,
                                               self.cfg)
            first = int(torch.argmax(logits))
            return exporter.export(kv["k"], kv["v"], n, first, PAGE)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = prompt
        logits, kv = self.decoding.prefill(self.params, jnp.asarray(padded),
                                           jnp.int32(n), self.cfg)
        first = int(jnp.argmax(logits))
        return exporter.export(np.asarray(kv["k"]), np.asarray(kv["v"]),
                               n, first, PAGE)


@pytest.fixture
def private_channels(monkeypatch, tmp_path):
    """Each package's channels in a directory of this test's own (readers
    open a channel by the path its ticket carries), so a leak check sees
    only this test's segments, not those of tests running beside it."""
    private_channel_dirs(monkeypatch, tmp_path)


def _sides(tiny_model):
    return [_Side(pkg, tiny_model[pkg]) for pkg in ("ray_tpu", "ray_tpu_torch")]


def _wait_pool_restored(eng, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = eng.stats()
        if (st["free_slots"] == st["max_slots"]
                and st["free_pages"] == st["num_pages"] - 1):
            return st
        time.sleep(0.02)
    raise AssertionError(f"pool not restored: {eng.stats()}")


# ----------------------------------------------------------- transfer plane


def _puller_abort(side: _Side):
    before = side.shm_channels()
    slow = side.PagedKVExporter(send_timeout_s=30.0, prefetch_pages=1,
                                page_interval_s=0.12)
    puller = side.BatchedKVPuller()
    try:
        ticket = side.prefill_ticket(list(range(2, 50)), slow)
        threaded = not ticket.get("sync")
        stream = side.KVPageStream(ticket["n_pages"], ticket["page_size"])
        puller.pull(ticket, stream, timeout_s=30.0)
        aborted = puller.abort(ticket["ticket"])
        deadline = time.monotonic() + 10.0
        while stream._error is None and time.monotonic() < deadline:
            time.sleep(0.02)
        failed = (isinstance(stream._error, side.KVTransferError)
                  and "cancel" in str(stream._error).lower())
        # the sender observes the closed channel and retires
        deadline = time.monotonic() + 10.0
        while slow.pending() and time.monotonic() < deadline:
            time.sleep(0.05)
        retired = slow.pending() == 0
        # a settled or unknown ticket's abort is a no-op
        again = (puller.abort(ticket["ticket"]),
                 puller.abort("no-such-ticket"))
    finally:
        slow.teardown()
        puller.teardown()
    return (threaded, aborted, failed, retired, again,
            side.shm_channels() - before)


@pytest.mark.pd
def test_puller_abort_kills_transfer_and_retires_sender(tiny_model,
                                                         private_channels):
    """BatchedKVPuller.abort mid-stream: the sink fails with a cancellation
    KVTransferError, the sender's next write sees the closed channel and
    retires the transfer, and teardown leaves no segment behind."""
    got = [_puller_abort(s) for s in _sides(tiny_model)]
    assert got[0] == got[1] == (True, True, True, True, (False, False),
                                set()), got


# ----------------------------------------------------------- engine + PD


def _storm(side: _Side):
    before = side.shm_channels()
    mono = side.paged_engine()
    dec = side.paged_engine()
    # 0.15 s a page: a 4-page dropped transfer stays open ~0.6 s, so the
    # abort at 0.25 s lands mid-transfer
    slow = side.PagedKVExporter(send_timeout_s=30.0, prefetch_pages=1,
                                page_interval_s=0.15)
    puller = side.BatchedKVPuller()
    sp = side.SamplingParams(max_tokens=12, temperature=0.0)
    prompts = [list(range(2, 40)),   # PD survivor
               list(range(2, 52)),   # PD dropped (engine + ticket abort)
               [1, 5, 9, 2],         # plain survivor
               [3] * 48]             # PD dropped (ticket abort only)
    try:
        want = [mono.generate(prompts[0], sp), None,
                mono.generate(prompts[2], sp), None]
        tickets = {i: side.prefill_ticket(prompts[i], slow)
                   for i in (0, 1, 3)}
        streams = {i: side.KVPageStream(t["n_pages"], t["page_size"])
                   for i, t in tickets.items()}
        for i, t in tickets.items():
            puller.pull(t, streams[i], timeout_s=30.0)
        reqs = {i: dec.submit_prefilled(
                    length=t["length"], first_token=t["first_token"],
                    params=sp, kv_stream=streams[i])
                for i, t in tickets.items()}
        reqs[2] = dec.submit(prompts[2], sp)
        results: dict = {}

        def consume(i, req):
            try:
                results[i] = list(req)
            except BaseException as e:  # noqa: BLE001 — the outcome
                results[i] = e

        threads = [threading.Thread(target=consume, args=(i, r))
                   for i, r in reqs.items()]
        for t in threads:
            t.start()
        time.sleep(0.25)  # the dropped transfers are mid-stream
        # client drops, in both orders the serve layer can issue them:
        # request 3 only the ticket abort, so the transfer failure must
        # reclaim its slot on its own; it goes first, while its 4-page
        # transfer is still open (under load the wait below can outlast
        # it). Request 1 gets DecodeServer._abort's pair (engine abort,
        # then the ticket). Its ticket abort waits for the engine's to
        # land: otherwise the puller's thread may fail the stream first,
        # the slot comes back as a transfer failure and the engine counts
        # no abort
        third = puller.abort(tickets[3]["ticket"])
        dec.abort_request(reqs[1].rid)
        deadline = time.monotonic() + 10.0
        while dec.stats()["aborts"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        puller.abort(tickets[1]["ticket"])
        for t in threads:
            t.join(timeout=60.0)
        hung = any(t.is_alive() for t in threads)
        dropped = (isinstance(results[1], (side.RequestCancelledError,
                                           side.KVTransferError)),
                   isinstance(results[3], side.KVTransferError))
        survivors = ([tickets[0]["first_token"]] + list(results[0])
                     if isinstance(results[0], list) else results[0],
                     results[2])
        st = _wait_pool_restored(dec)
        # the engine keeps serving after the storm
        after = (mono.generate(prompts[2], sp), dec.generate(prompts[2], sp))
    finally:
        slow.teardown()
        puller.teardown()
        mono.shutdown()
        dec.shutdown()
    return {"pkg": side.pkg, "third_aborted": third, "hung": hung,
            "dropped": dropped,
            "survivors": survivors, "want": (want[0], want[2]),
            "aborts": st["aborts"] >= 1, "after": after,
            "leaked": side.shm_channels() - before}


@pytest.mark.pd
def test_disconnect_storm_survivors_token_exact(tiny_model,
                                                private_channels):
    """PD requests with streamed admission and plain decodes at once; half
    the clients drop mid-decode (engine abort and ticket abort, the calls
    the serve layer makes on disconnect). Every slot and page returns, no
    segment leaks, and the survivors give exactly the monolithic engine's
    tokens, in both packages and across them."""
    jax_side, port_side = (_storm(s) for s in _sides(tiny_model))
    for got in (jax_side, port_side):
        assert got["third_aborted"] is True and got["hung"] is False, got
        assert got["dropped"] == (True, True), got
        assert got["survivors"] == got["want"], got
        assert got["aborts"] is True, got
        assert got["after"][0] == got["after"][1], got
        assert got["leaked"] == set(), got
    assert port_side["survivors"] == jax_side["survivors"]


# ----------------------------------------------------------------- serve


@pytest.fixture
def pkgs():
    pkgs = start_sessions(num_cpus=8, num_workers=2, max_workers=10)
    yield pkgs
    stop_sessions(pkgs)


@pytest.mark.serve_chaos
def test_http_disconnect_storm_interrupts_every_stream(pkgs):
    """N concurrent SSE clients all drop mid-stream: every replica-side
    generator is interrupted (none runs to completion); the proxy's
    abandoned-stream cancel keeps up under a disconnect storm."""
    N = 4

    def scn(rt):
        serve = serve_of(rt)

        @serve.deployment(max_ongoing_requests=8)
        class StormTarget:
            def __init__(self):
                self.interrupted = 0
                self.completed = 0

            def stream_request(self, request: dict):
                import time as _time

                try:
                    for i in range(100):
                        yield {"i": i}
                        _time.sleep(0.1)
                    self.completed += 1
                except GeneratorExit:
                    self.interrupted += 1
                    raise

            def __call__(self, request: dict):
                return {"interrupted": self.interrupted,
                        "completed": self.completed}

        serve.start(http_port=0)
        handle = serve.run(StormTarget.bind(), name="storm",
                           route_prefix="/storm")
        _, port = serve.http_address()
        statuses: list = []

        def drop_one():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            payload = json.dumps({})
            conn.request("POST", "/storm", body=payload,
                         headers={"Content-Type": "application/json",
                                  "Accept": "text/event-stream",
                                  "Content-Length": str(len(payload))})
            resp = conn.getresponse()
            statuses.append(resp.status)
            resp.read1(64)  # the stream is live
            resp.close()  # drop the fd for real (see the cancellation twins)
            conn.close()

        threads = [threading.Thread(target=drop_one) for _ in range(N)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=30.0)
        deadline = time.monotonic() + 20.0
        state = None
        while time.monotonic() < deadline:
            state = handle.call_sync({}, timeout_s=10.0)
            if state["interrupted"] >= N:
                break
            time.sleep(0.2)
        return (statuses == [200] * N, state["interrupted"] >= N,
                state["completed"])

    a, b = twin(pkgs, scn)
    assert a == b == (True, True, 0), (a, b)
