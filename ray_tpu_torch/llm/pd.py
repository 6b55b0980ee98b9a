"""Prefill/decode disaggregation below Serve: the prefill tier's batching
and the engine settings both pools share.

The port of the part of ray_tpu/llm/pd.py that needs no Serve:

- ``_pd_engine_kwargs``: one normalisation of ``engine_kwargs`` for BOTH
  pools (the paged layout, ``PDConfig.page_size``, ``min_bucket >=
  page_size``), so prefill buckets always slice into whole decode pages;
- ``PrefillCoalescer``: concurrent same-bucket prompts share one ``[B, T]``
  ``decoding.prefill_batch`` forward;
- ``_ttft_histogram``: the PD time-to-first-token metric.

The JAX package's ``PrefillServer``, ``DecodeServer``, ``PDProxyServer``
and ``build_pd_openai_app`` are Serve deployments and wait for the Serve
layer's port. Their composition below Serve is: prefill
(``decoding.prefill`` or a coalescer) → ``kv_transfer.PagedKVExporter``
ticket → ``BatchedKVPuller`` into a ``KVPageStream`` →
``LLMEngine.submit_prefilled(kv_stream=...)``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ray_tpu_torch.llm.config import LLMConfig, PDConfig
from ray_tpu_torch.llm.engine import bucket_for

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
