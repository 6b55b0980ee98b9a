"""Prefill/decode disaggregation over the paged-KV shm transfer plane.

The port of ray_tpu/llm/pd.py:

- ``_pd_engine_kwargs``: one normalisation of ``engine_kwargs`` for BOTH
  pools (the paged layout, ``PDConfig.page_size``, ``min_bucket >=
  page_size``), so prefill buckets always slice into whole decode pages;
- ``PrefillCoalescer``: concurrent same-bucket prompts share one ``[B, T]``
  ``decoding.prefill_batch`` forward;
- ``PrefillServer``: the prompt-only forward through the coalescer (the
  flash forward on the card), the first token sampled from the replica's
  own ``torch.Generator``, and the KV exported as it lies on the device
  through ``kv_transfer.PagedKVExporter``; its reply is a small ticket;
- ``DecodeServer``: streamed admission of the ticket's pages through a
  ``BatchedKVPuller`` into ``LLMEngine.submit_prefilled(kv_stream=...)``
  (ragged decode on the card), tokens streamed as the engine produces them;
- ``PDProxyServer``: composes the two pools, streams the decode leg and
  reports the time-to-first-token split by phase
  (``ray_tpu_llm_pd_ttft_seconds``);
- ``build_pd_openai_app``: the three deployments as one application.

Prefill and decode replicas share one host (/dev/shm). Their engines run
on the card unless ``engine_kwargs={"device": "cpu"}``; a replica without
a GPU grant reaches the card only when the runtime's ``worker_platform`` is
not ``"cpu"``.

(reference: llm/_internal/serve/serving_patterns/prefill_decode/pd_server.py
— a PDProxyServer sends each request to a prefill deployment, transfers the
KV cache to a decode deployment, and streams tokens from the decoder.)
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from ray_tpu_torch import serve
from ray_tpu_torch.exceptions import DeadlineExceededError
from ray_tpu_torch.llm.config import LLMConfig, PDConfig
from ray_tpu_torch.llm.engine import SamplingParams, bucket_for
from ray_tpu_torch.llm.kv_transfer import (BatchedKVPuller, KVPageStream,
                                           PagedKVExporter, pull_all)
from ray_tpu_torch.llm.tokenizer import load_tokenizer
from ray_tpu_torch.serve import replica as _replica
from ray_tpu_torch.serve import request_context as _rc
from ray_tpu_torch.util import tracing as _tracing

logger = logging.getLogger(__name__)

_TTFT_BOUNDS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0)


def _ttft_histogram():
    from ray_tpu_torch.util import metrics as met

    return met.get_or_create(
        met.Histogram, "ray_tpu_llm_pd_ttft_seconds",
        "PD time-to-first-token split by phase (prefill: request->ticket; "
        "decode: dispatch->first decode-produced token)",
        boundaries=list(_TTFT_BOUNDS), tag_keys=("phase",))


def _pd_engine_kwargs(llm_config: LLMConfig) -> dict:
    """One normalisation of engine_kwargs shared by BOTH pools, so prefill
    bucketing and the decode page pool never disagree on shapes: PD
    defaults to the paged layout with pd_config.page_size, and min_bucket
    is raised so every prompt bucket slices into whole pages."""
    pd = llm_config.pd_config or PDConfig()
    ek = dict(llm_config.engine_kwargs)
    ek.setdefault("kv_layout", "paged")
    ek.setdefault("page_size", pd.page_size)
    if ek["kv_layout"] == "paged":
        ek["min_bucket"] = max(ek.get("min_bucket", 32), ek["page_size"])
    return ek


class _PrefillJob:
    __slots__ = ("ids", "n", "bucket", "event", "logits", "k", "v", "error")

    def __init__(self, ids, n, bucket):
        self.ids = ids
        self.n = n
        self.bucket = bucket
        self.event = threading.Event()
        self.logits = self.k = self.v = None
        self.error: BaseException | None = None


class PrefillCoalescer:
    """Admission batching for the dedicated prefill tier.

    Concurrent same-bucket prompts coalesce into ONE ``[B, T]``
    ``decoding.prefill_batch`` forward, which a monolithic engine cannot
    do: its prefills interleave with decode steps one prompt at a time.
    Baton-passing combiner, no thread of its own: the first waiting caller
    becomes the leader, runs ONE batch (the same-bucket jobs queued at that
    moment, its own included; a power-of-two count up to ``max_batch``),
    releases leadership, and waiting callers promote themselves.
    ``window_s`` lets the leader wait for stragglers first. Causality
    keeps each row equal to a solo ``[1, T]`` prefill up to the rounding
    of the batched kernels.
    """

    def __init__(self, params, cfg, *, min_bucket: int, max_len: int,
                 max_batch: int = 4, window_s: float = 0.0):
        self.params = params
        self.cfg = cfg
        self.min_bucket = min_bucket
        self.max_len = max_len
        self.max_batch = max(1, int(max_batch))
        self.window_s = float(window_s)
        self._cond = threading.Condition()
        self._pending: list = []
        self._leader_active = False
        self._stop = False
        self.batches = 0   # forwards run
        self.jobs = 0      # prompts served (jobs/batches = mean batch)

    def _run(self, batch: list) -> None:
        from ray_tpu_torch.models import decoding

        try:
            T = batch[0].bucket
            tb = np.zeros((len(batch), T), np.int64)
            lens = np.zeros((len(batch),), np.int64)
            for b, j in enumerate(batch):
                tb[b, :j.n] = j.ids
                lens[b] = j.n
            dev = self.params["embed"].device
            logits, kv = decoding.prefill_batch(
                self.params, torch.as_tensor(tb, device=dev), lens, self.cfg)
            for b, j in enumerate(batch):
                j.logits = logits[b]
                j.k = kv["k"][:, b]
                j.v = kv["v"][:, b]
            self.batches += 1
            self.jobs += len(batch)
        except BaseException as e:  # noqa: BLE001 — the waiters MUST be
            # released with the failure, or every straggler hangs forever
            for j in batch:
                j.error = e
        finally:
            for j in batch:
                j.event.set()

    def prefill(self, token_ids: list):
        """Blocking: (logits_at_last [V], k [L, T, Hkv, Dh],
        v [L, T, Hkv, Dh], bucket) for this prompt, computed in whichever
        coalesced forward picked the job up."""
        n = len(token_ids)
        job = _PrefillJob(list(token_ids), n,
                          bucket_for(n, self.min_bucket, self.max_len))
        if n > job.bucket:
            raise ValueError(
                f"prompt of {n} tokens exceeds max_len {self.max_len}")
        with self._cond:
            if self._stop:
                raise RuntimeError("prefill coalescer is torn down")
            self._pending.append(job)
        while not job.event.is_set():
            with self._cond:
                while (not job.event.is_set() and self._leader_active
                       and not self._stop):
                    self._cond.wait(timeout=0.5)
                if job.event.is_set():
                    break
                if self._stop:
                    job.error = RuntimeError(
                        "prefill coalescer torn down mid-batch")
                    break
                self._leader_active = True
            try:
                if self.window_s:
                    time.sleep(self.window_s)  # sparse arrivals: wait a beat
                with self._cond:
                    batch = []
                    if self._pending:
                        bucket = self._pending[0].bucket  # FIFO fairness
                        group = [j for j in self._pending
                                 if j.bucket == bucket][:self.max_batch]
                        # floor to a power of two: few batch shapes, and no
                        # padded rows; leftovers take the next baton
                        take = 1 << (len(group).bit_length() - 1)
                        batch = group[:take]
                        for j in batch:
                            self._pending.remove(j)
                if batch:
                    self._run(batch)
            finally:
                with self._cond:
                    self._leader_active = False
                    self._cond.notify_all()
        if job.error is not None:
            raise job.error
        return job.logits, job.k, job.v, job.bucket

    def teardown(self) -> None:
        """Fail queued jobs and refuse new ones. Safe to call twice."""
        with self._cond:
            self._stop = True
            pending, self._pending = self._pending, []
            self._cond.notify_all()
        for j in pending:
            j.error = RuntimeError("prefill coalescer torn down")
            j.event.set()


@serve.deployment(max_ongoing_requests=8)
class PrefillServer:
    """Prompt-only forward: pages the prefilled KV into the transfer plane
    and returns the ticket and the first sampled token."""

    def __init__(self, llm_config: LLMConfig):
        ek = _pd_engine_kwargs(llm_config)
        pd = llm_config.pd_config or PDConfig()
        # the card unless engine_kwargs asks for the CPU; raises when no
        # card is visible (resolve_device), never computes on the CPU
        self.cfg, self.params = llm_config.build_model(ek.get("device"))
        self.page_size = ek["page_size"]
        self.min_bucket = max(ek.get("min_bucket", 32), self.page_size)
        self.max_len = ek.get("max_len", self.cfg.max_seq_len)
        # replica methods run on several threads, and the coalescer wakes a
        # whole batch of them at once: each draw from the replica's one
        # generator happens under the lock, or concurrent requests could
        # sample from the same generator state
        self._gen = torch.Generator(
            device=self.params["embed"].device).manual_seed(ek.get("seed", 0))
        self._gen_lock = threading.Lock()
        self.exporter = PagedKVExporter(
            send_timeout_s=pd.transfer_timeout_s,
            prefetch_pages=pd.prefetch_depth)
        # admission batching: concurrent prompts share one [B, T] forward
        self.coalescer = PrefillCoalescer(
            self.params, self.cfg, min_bucket=self.min_bucket,
            max_len=self.max_len, max_batch=pd.prefill_batch_max,
            window_s=pd.prefill_batch_window_s)

    def prefill(self, token_ids: list, temperature: float = 0.0) -> dict:
        """Returns the transfer TICKET (kv_transfer.py); the KV itself
        streams page by page to whichever decode replica pulls it.
        Concurrent calls coalesce into one batched forward
        (PrefillCoalescer) before each row exports its own ticket."""
        from ray_tpu_torch.models import decoding

        n = len(token_ids)
        t0 = time.time()
        # raises ValueError for a prompt longer than max_len
        logits, k, v, bucket = self.coalescer.prefill(list(token_ids))
        with self._gen_lock:
            first = int(decoding.sample(logits[None, :], self._gen,
                                        temperature)[0])
        _tracing.emit_child_span("pd:prefill_forward", t0, time.time(),
                                 tokens=n, bucket=bucket)
        # sampled requests: the sender thread runs outside the request's
        # contextvar scope, so its pd:kv_send span context rides the ticket
        return self.exporter.export(k, v, n, first, self.page_size,
                                    trace_ctx=_tracing.inject())

    def abort_transfer(self, ticket_id: str) -> None:
        """Best-effort: retire an exported ticket whose consumer went away
        (client disconnect before or while the decode side pulled), so the
        sender stops now instead of at its send timeout. A ticket another
        replica exported, or one already settled, is a no-op."""
        self.exporter.abort(ticket_id)

    def transfer_stats(self) -> dict:
        return {"pending_transfers": self.exporter.pending(),
                "failed_transfers": self.exporter.failures,
                "last_failure": self.exporter.last_failure,
                "page_size": self.page_size,
                "prefill_batches": self.coalescer.batches,
                "prefill_jobs": self.coalescer.jobs}

    def __del__(self):
        try:
            self.coalescer.teardown()
            self.exporter.teardown()
        except Exception:
            pass


@serve.deployment(max_ongoing_requests=8)
class DecodeServer:
    """Continues generation from a transferred paged-KV prefix, admitting
    pulled pages straight into the engine's continuous-batching slots."""

    def __init__(self, llm_config: LLMConfig):
        from ray_tpu_torch.llm.engine import LLMEngine

        pd = llm_config.pd_config or PDConfig()
        cfg = dataclasses.replace(llm_config,
                                  engine_kwargs=_pd_engine_kwargs(llm_config))
        self.engine = LLMEngine.from_config(cfg)
        self.pull_timeout_s = pd.transfer_timeout_s
        # ONE polling thread serves every in-flight transfer of this replica
        # (streamed admission); None: pull everything, then admit
        self.puller = BatchedKVPuller() if pd.batched_pull else None

    def decode_stream(self, ticket: dict, params: dict | None = None):
        """Generator over generated token ids: the transferred first token
        at once (time-to-first-token does not wait for the page transfer),
        then the engine's tokens as the decode loop produces them. By
        default admission STREAMS: the ticket registers with the replica's
        batched puller and the engine adopts pages as they arrive, so
        decode of other slots overlaps this transfer and the slot activates
        on the last page. Transfer failures raise KVTransferError, a
        per-request error; the engine and the other requests keep serving.

        Sampled requests emit the decode side's phase spans here:
        ``pd:kv_transfer`` (the page pull), ``pd:admission`` (submit → slot
        bind, from the engine's request stamps) and ``pd:decode`` (first
        engine token → stream end)."""
        from ray_tpu_torch.llm.engine import _iter_request
        from ray_tpu_torch.llm.kv_transfer import pull_pages

        # the generator body runs across many __next__ calls, always on the
        # activated task's thread: the captured context is the one stable
        # handle for retroactive spans
        ctx = _tracing.current_context()
        sp = SamplingParams(**(params or {}))
        yield ticket["first_token"]
        if sp.max_tokens <= 1:
            # the transferred token spent the budget: drain the channel so
            # the prefill side retires it, but take no slot
            if self.puller is not None:
                self.puller.drain(ticket, timeout_s=self.pull_timeout_s)
            else:
                for _ in pull_pages(ticket, timeout_s=self.pull_timeout_s):
                    pass
            return
        t_pull = time.time()
        deadline_ts = _replica.request_deadline() or 0.0
        if self.puller is not None:
            stream = KVPageStream(ticket["n_pages"], ticket["page_size"])
            self.puller.pull(ticket, stream, timeout_s=self.pull_timeout_s)
            req = self.engine.submit_prefilled(
                length=ticket["length"], first_token=ticket["first_token"],
                params=sp, kv_stream=stream, deadline_ts=deadline_ts)
        else:
            stream = None
            k_pages, v_pages = pull_all(ticket, timeout_s=self.pull_timeout_s)
            _tracing.emit_span_for(ctx, "pd:kv_transfer", t_pull, time.time(),
                                   ticket=ticket.get("ticket", ""),
                                   pages=ticket["n_pages"])
            req = self.engine.submit_prefilled(
                length=ticket["length"], first_token=ticket["first_token"],
                params=sp, k_pages=k_pages, v_pages=v_pages,
                deadline_ts=deadline_ts)

        fin = {"done": False}

        def _abort():
            """Reclaim both planes mid-stream: the decode slot and its pages
            (engine abort) and the page transfer in flight (puller abort,
            which closes the channel, so the prefill side's sender retires
            its ticket too). Finished requests are no-ops in both."""
            if fin["done"]:
                return
            try:
                self.engine.abort_request(req.rid)
                if self.puller is not None:
                    self.puller.abort(ticket.get("ticket", ""))
            finally:
                _rc.count_cancellation("pd")

        # a cancel seen by the serve plane (client disconnect, cancel(), a
        # caller that timed out) reaches here through the replica
        _replica.on_cancel(_abort)
        n = 0
        t_dec = time.time()
        try:
            for tok in _iter_request(req):
                if n == 0 and ctx is not None:
                    if stream is not None:
                        # streamed: the transfer overlapped decode, and its
                        # span closes at the stream's last page
                        _tracing.emit_span_for(
                            ctx, "pd:kv_transfer", t_pull,
                            stream.finished_ts or time.time(),
                            ticket=ticket.get("ticket", ""),
                            pages=ticket["n_pages"])
                    if req.admitted_ts:
                        # the engine stamped the slot bind: the admission
                        # wait is known now
                        _tracing.emit_span_for(ctx, "pd:admission",
                                               req.submitted_ts,
                                               req.admitted_ts)
                n += 1
                yield tok
            fin["done"] = True
        finally:
            if not fin["done"]:
                # the consumer left the stream (GeneratorExit from the
                # replica's close()) or it failed mid-decode: reclaim now
                _abort()
            if ctx is not None:
                _tracing.emit_span_for(ctx, "pd:decode", t_dec, time.time(),
                                       tokens=n)

    def decode(self, ticket: dict, params: dict | None = None) -> list:
        """Blocking form, for callers that do not stream."""
        return list(self.decode_stream(ticket, params))

    def engine_stats(self) -> dict:
        st = self.engine.stats()
        if self.puller is not None:
            st["pulls_in_flight"] = self.puller.pending()
        return st

    def __del__(self):
        try:
            if self.puller is not None:
                self.puller.teardown()
            self.engine.shutdown()
        except Exception:
            pass


@serve.deployment
class PDProxyServer:
    """(reference: pd_server.py PDProxyServer — composes the two pools.)

    The decode leg is a Serve streaming handle: tokens are forwarded as
    they are produced, and the time to the first token is measured and
    exported per phase (``ray_tpu_llm_pd_ttft_seconds``)."""

    def __init__(self, prefill_handle, decode_handle, tokenizer_spec="byte",
                 request_timeout_s: float = 120.0):
        self.prefill = prefill_handle
        self.decode = decode_handle
        self.tokenizer = load_tokenizer(tokenizer_spec)
        self.request_timeout_s = request_timeout_s
        self._m_ttft = _ttft_histogram()

    def _pump(self, body: dict, timing: dict):
        """Drive one request through both pools, yielding token ids as they
        arrive; ``timing`` gets the latency split for ``usage``."""
        ids = self.tokenizer.encode(body.get("prompt", ""))
        timing["prompt_tokens"] = len(ids)
        t0 = time.monotonic()
        w0 = time.time()
        # the proxy's request deadline (set by the HTTP ingress) rides into
        # both pools; each leg's blocking wait is clamped to what is left,
        # so a queued prefill cannot eat the decode's time
        deadline_ts = _replica.request_deadline()
        budget_s = self.request_timeout_s
        if deadline_ts:
            rem = _rc.deadline_remaining(deadline_ts)
            if rem is not None:
                if rem <= 0:
                    _rc.count_cancellation("pd")
                    raise DeadlineExceededError(
                        "pd proxy: deadline expired before prefill dispatch")
                budget_s = min(budget_s, rem)
        ticket = self.prefill.prefill.remote(
            ids, float(body.get("temperature", 0.0)),
            _deadline_ts=deadline_ts,
        ).result(timeout_s=budget_s)
        # the first token is sampled by prefill and rides the ticket: its
        # arrival is the request's time-to-first-token
        timing["ttft_s"] = time.monotonic() - t0
        self._m_ttft.observe(timing["ttft_s"], tags={"phase": "prefill"})
        _tracing.emit_child_span("pd:prefill", w0, w0 + timing["ttft_s"],
                                 prompt_tokens=len(ids))
        t1 = time.monotonic()
        w1 = time.time()
        stream = self.decode.options(
            stream=True, stream_item_timeout_s=self.request_timeout_s,
        ).decode_stream.remote(
            ticket, {"max_tokens": int(body.get("max_tokens", 32)),
                     "temperature": float(body.get("temperature", 0.0))},
            _deadline_ts=deadline_ts)
        finished = False
        try:
            for i, tok in enumerate(stream):
                if i == 1:
                    # the first token decode produced: page pull, slot
                    # admission and one decode step, the decode half of the
                    # time-to-first-token split
                    decode_ttft = time.monotonic() - t1
                    timing["decode_ttft_s"] = decode_ttft
                    self._m_ttft.observe(decode_ttft, tags={"phase": "decode"})
                    _tracing.emit_child_span("pd:decode_first_token", w1,
                                             w1 + decode_ttft)
                yield tok
            finished = True
        finally:
            if not finished:
                # abandoned mid-decode (client gone) or failed: cancel the
                # decode replica's stream (which aborts the engine request
                # and the page pull), and retire the exported ticket on the
                # prefill tier so its sender stops too, best-effort
                cancel = getattr(stream, "cancel", None)
                if cancel is not None:
                    try:
                        cancel()
                    except Exception as e:  # noqa: BLE001 — best-effort
                        logger.debug("pd decode-stream cancel failed: %r", e)
                try:
                    self.prefill.abort_transfer.remote(
                        ticket.get("ticket", ""))
                except Exception as e:  # noqa: BLE001 — best-effort
                    logger.debug("pd prefill abort_transfer failed: %r", e)
        timing["total_time_s"] = time.monotonic() - t0

    def _usage(self, timing: dict, n_out: int) -> dict:
        return {"prompt_tokens": timing.get("prompt_tokens", 0),
                "completion_tokens": n_out,
                # time to the first token, apart from the whole completion's
                "ttft_s": round(timing.get("ttft_s", 0.0), 4),
                "total_time_s": round(timing.get("total_time_s", 0.0), 4)}

    def _record(self, request: dict, timing: dict, t0: float,
                n_out: int, status) -> None:
        """The PD flight-recorder entry: the HTTP proxy's, plus the prefill
        and decode halves of the time to the first token."""
        rec = {"request_id": request.get("request_id") or _rc.new_request_id(),
               "component": "pd_proxy", "ts": time.time(),
               "phases": {"prefill": round(timing.get("ttft_s", 0.0), 6),
                          "decode_first_token": round(
                              timing.get("decode_ttft_s", 0.0), 6)},
               "completion_tokens": n_out}
        _rc.record_request(rec, t0, status=status)

    def __call__(self, request: dict) -> dict:
        body = request.get("body") or request
        timing: dict = {}
        t0 = time.perf_counter()
        status = "error"
        out_ids: list = []
        try:
            out_ids = list(self._pump(body, timing))
            status = 200
        finally:
            # failed requests (KVTransferError, replica death) are the ones
            # the flight recorder must explain: record either way
            self._record(request, timing, t0, len(out_ids), status)
        return {"choices": [{"index": 0,
                             "text": self.tokenizer.decode(out_ids),
                             "finish_reason": "stop"}],
                "usage": self._usage(timing, len(out_ids))}

    def stream_request(self, request: dict):
        """Streaming HTTP entry (SSE through the proxy): one chunk a token,
        then a final chunk with the usage, as LLMServer.stream_request."""
        body = request.get("body") or request
        timing: dict = {}
        n = 0
        t0 = time.perf_counter()
        status = "aborted"  # GeneratorExit (client gone) or mid-stream error
        gen = self._pump(body, timing)
        try:
            for tok in gen:
                n += 1
                yield {"object": "text_completion.chunk",
                       "choices": [{"index": 0,
                                    "text": self.tokenizer.decode([tok]),
                                    "finish_reason": None}]}
            status = "stream"
        finally:
            # close explicitly: on abandonment the pump's finally must run
            # now (cancel the decode stream, retire the prefill ticket), not
            # whenever the suspended frame is collected
            gen.close()
            self._record(request, timing, t0, n, status)
        yield {"object": "text_completion.chunk",
               "choices": [{"index": 0, "text": "", "finish_reason": "stop"}],
               "usage": self._usage(timing, n)}


def build_pd_openai_app(llm_config: LLMConfig) -> serve.Application:
    pd = llm_config.pd_config or PDConfig()
    prefill = PrefillServer.options(
        num_replicas=pd.num_prefill_replicas).bind(llm_config)
    decode = DecodeServer.options(
        num_replicas=pd.num_decode_replicas).bind(llm_config)
    return PDProxyServer.bind(
        prefill, decode,
        llm_config.model_loading_config.tokenizer or "byte")
