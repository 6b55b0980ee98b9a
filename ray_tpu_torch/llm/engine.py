"""LLMEngine: continuous-batching inference on one GPU.

The counterpart of ray_tpu/llm/engine.py ``TPUEngine`` with
``kv_layout="paged"`` and ``attn_impl="ragged"``. The scheduler thread owns
the device state and runs the continuous-batching loop (admit → prefill into
a free slot → one decode step for every live row → emit/eject):

- prompt lengths are padded to power-of-two buckets (>= page_size), so
  every prefill is whole pages and the flash kernel's tiles divide it,
- KV lives in a shared page pool; each admission is granted every page the
  sequence will ever touch, and a request that does not fit waits in a
  backlog until pages free up,
- each decode step sweeps only ``_pages_bound()`` block-table columns: the
  power-of-two bound on the batch's live page span,
- sampling is per row on the device; only the sampled ids cross to the host.

On the card, prefill attention is the flash kernel and decode attention the
ragged paged kernel (as in ray_tpu/llm/engine.py:306-307, the ragged kernel
runs iff the device can run it); on the CPU both take their plain versions.
The slot layout, prefix cache, chunked prefill, speculative decoding, LoRA,
guided decoding, PD ``submit_prefilled`` and a multi-GPU mesh are not ported
yet: asking for one raises and names its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.exceptions import DeadlineExceededError, RequestCancelledError
from ray_tpu_torch.models import decoding
from ray_tpu_torch.models import decoding_paged as dp
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.ops import flash_attention


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet; see ROADMAP.md Queue 1")


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    stop_token_ids: tuple = ()
    guided: object | None = None  # not ported: must stay None


@dataclasses.dataclass
class _Request:
    rid: int
    tokens: list
    params: SamplingParams
    out_queue: queue.SimpleQueue = dataclasses.field(default_factory=queue.SimpleQueue)
    slot: int = -1
    generated: int = 0
    # the row's device length at activation, mirrored host-side so the
    # ragged decode step can bound its page sweep without a readback
    length0: int = 0
    # absolute wall-clock deadline (0 = none)
    deadline_ts: float = 0.0

    def __iter__(self):
        """Yield generated tokens as they are produced."""
        return _iter_request(self)


_SENTINEL = object()


class _EngineError:
    """End-of-stream marker carrying the scheduler's failure."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _RequestError(_EngineError):
    """End-of-stream marker for a per-request failure (cancel, deadline)."""


def _iter_request(req: _Request):
    while True:
        tok = req.out_queue.get()
        if tok is _SENTINEL:
            return
        if isinstance(tok, _RequestError):
            raise tok.exc
        if isinstance(tok, _EngineError):
            raise RuntimeError("engine scheduler died mid-generation") from tok.exc
        yield tok


def bucket_for(n: int, min_bucket: int, max_len: int) -> int:
    """Smallest power-of-two bucket >= n (starting at min_bucket, capped at
    max_len)."""
    b = min_bucket
    while b < n and b < max_len:
        b *= 2
    return min(b, max_len)


class LLMEngine:
    """Continuous-batching engine on one GPU (or the CPU when asked for);
    the counterpart of ``ray_tpu.llm.engine.TPUEngine``."""

    def __init__(self, cfg: TransformerConfig, params: dict, *,
                 max_slots: int = 8, max_len: int | None = None,
                 min_bucket: int = 32, seed: int = 0,
                 kv_layout: str = "paged", page_size: int = 64,
                 num_pages: int | None = None,
                 max_prefills_per_step: int = 2,
                 enable_prefix_cache: bool = False,
                 prefill_chunk: int | None = None,
                 speculative_k: int = 0, mesh=None, max_loras: int = 0,
                 attn_impl: str = "auto", device=None):
        if kv_layout != "paged":
            raise _not_ported(f"kv_layout={kv_layout!r} (the slot layout)")
        if enable_prefix_cache:
            raise _not_ported("enable_prefix_cache (the prefix cache)")
        if prefill_chunk is not None:
            raise _not_ported("prefill_chunk (chunked prefill)")
        if speculative_k:
            raise _not_ported("speculative_k (speculative decoding)")
        if max_loras:
            raise _not_ported("max_loras (LoRA serving)")
        if mesh is not None:
            raise _not_ported("mesh (multi-GPU serving)")
        if attn_impl not in ("auto", "ragged"):
            raise ValueError(
                f"attn_impl must be 'auto' or 'ragged', got {attn_impl!r} "
                "(the gather step, models/decoding_paged.py "
                "decode_step_paged, is kept as a test oracle only)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.max_len = max_len or cfg.max_seq_len
        if self.max_len > cfg.max_seq_len:
            raise ValueError(
                f"engine max_len {self.max_len} exceeds the model's "
                f"max_seq_len {cfg.max_seq_len} (rope tables are sized by "
                "the model config)")
        if page_size <= 0 or (page_size & (page_size - 1)):
            raise ValueError("page_size must be a positive power of two")
        if self.max_len % page_size:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of page_size "
                f"{page_size} (buckets reshape into whole pages)")
        min_bucket = max(min_bucket, page_size)
        if self.device.type == "cuda":
            # every prefill bucket must tile into the flash kernel's rows
            tile = flash_attention.TILE
            min_bucket = max(min_bucket, tile)
            if self.max_len % tile:
                raise ValueError(f"max_len {self.max_len} must be a multiple "
                                 f"of the flash kernel's tile {tile} on CUDA")
        if min_bucket % page_size:
            raise ValueError(
                f"min_bucket {min_bucket} must be a multiple of page_size "
                f"{page_size} (every prompt bucket reshapes into whole pages)")
        self.max_slots = max_slots
        self.kv_layout = kv_layout
        self.attn_impl = "ragged"
        self.buckets = []
        b = min_bucket
        while b < self.max_len:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(self.max_len)
        self.page_size = page_size
        self.max_pages_per_seq = -(-self.max_len // page_size)
        # default pool = full reservation (+1 scratch); pass num_pages lower
        # to oversubscribe device memory against short real sequences
        self.num_pages = num_pages or (max_slots * self.max_pages_per_seq + 1)
        self.state = dp.init_paged_state(cfg, max_slots, self.max_len,
                                         self.num_pages, page_size, self.device)
        self._free_pages = list(range(1, self.num_pages))  # 0 = scratch
        self._slot_pages: dict[int, list] = {}
        self._ragged_kernel = self.device.type == "cuda"
        self.decode_steps = 0
        self.decode_slot_steps = 0  # sum of active slots over decode steps
        self.prefills = 0
        self.prefill_seconds = 0.0  # prefill + first-token sync, host clock
        self.decode_seconds = 0.0   # decode step + sampling sync, host clock
        # per-row sampling params on the device, updated only at admission
        self._temps = torch.zeros((max_slots,), dtype=torch.float32,
                                  device=self.device)
        self._topks = torch.zeros((max_slots,), dtype=torch.int32,
                                  device=self.device)
        self.max_prefills_per_step = max(1, int(max_prefills_per_step))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._free = list(range(max_slots))
        self._by_slot: dict[int, _Request] = {}
        self._waiting: queue.SimpleQueue = queue.SimpleQueue()
        self._backlog: list = []  # admitted-later queue (page pressure)
        self._rid = itertools.count()
        self._work = threading.Event()
        self._stop = False
        self._error: BaseException | None = None
        # cancellation plane: abort_request() rids land in _abort_q; the
        # scheduler applies them at the top of its next pass. Rids whose
        # request is still in _waiting stay in _abort_pending (monotonic
        # stamp) until _admit pops the request; stale ones age out.
        self._abort_q: queue.SimpleQueue = queue.SimpleQueue()
        self._abort_pending: dict[int, float] = {}
        self.aborts = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # ---------------------------------------------------------------- public

    @classmethod
    def from_config(cls, llm_config) -> "LLMEngine":
        """Single construction point (the servers' and batch paths' entry)."""
        ek = dict(llm_config.engine_kwargs)
        cfg, params = llm_config.build_model(ek.get("device"))
        return cls(cfg, params,
                   max_slots=ek.get("max_slots", 8),
                   max_len=ek.get("max_len", cfg.max_seq_len),
                   min_bucket=ek.get("min_bucket", 32),
                   seed=ek.get("seed", 0),
                   kv_layout=ek.get("kv_layout", "paged"),
                   page_size=ek.get("page_size", 64),
                   num_pages=ek.get("num_pages"),
                   max_prefills_per_step=ek.get("max_prefills_per_step", 2),
                   enable_prefix_cache=ek.get("enable_prefix_cache", False),
                   prefill_chunk=ek.get("prefill_chunk"),
                   speculative_k=ek.get("speculative_k", 0),
                   attn_impl=ek.get("attn_impl", "auto"),
                   mesh=ek.get("mesh"),
                   max_loras=ek.get("max_loras", 0),
                   device=ek.get("device"))

    def _check_alive(self):
        if self._error is not None:
            raise RuntimeError("engine scheduler died") from self._error
        if self._stop:
            raise RuntimeError("engine is shut down")

    def submit(self, token_ids: list, params: SamplingParams | None = None,
               *, lora: str | None = None,
               deadline_ts: float = 0.0) -> _Request:
        self._check_alive()
        params = params or SamplingParams()
        if params.guided is not None:
            raise _not_ported("SamplingParams.guided (guided decoding)")
        if lora is not None:
            raise _not_ported("lora= (LoRA serving)")
        token_ids = list(token_ids)
        if not token_ids:
            raise ValueError("empty prompt: at least one token is required")
        limit = self.max_len - params.max_tokens - 1
        if limit <= 0:
            raise ValueError("max_tokens leaves no room for the prompt")
        token_ids = token_ids[-limit:]
        need = self._pages_needed(len(token_ids), self._bucket(len(token_ids)),
                                  params.max_tokens)
        if need > self.num_pages - 1:  # page 0 is scratch
            raise ValueError(
                f"request needs {need} KV pages but the pool only has "
                f"{self.num_pages - 1}; raise num_pages or shrink "
                f"prompt/max_tokens")
        req = _Request(next(self._rid), token_ids, params,
                       deadline_ts=float(deadline_ts or 0.0))
        self._waiting.put(req)
        self._work.set()
        return req

    def submit_prefilled(self, *args, **kwargs):
        raise _not_ported("submit_prefilled (PD disaggregation)")

    def generate(self, token_ids: list, params: SamplingParams | None = None,
                 *, lora: str | None = None) -> list:
        """Blocking: returns the generated token ids."""
        return list(self.stream(token_ids, params, lora=lora))

    def stream(self, token_ids: list, params: SamplingParams | None = None,
               *, lora: str | None = None):
        """Yields token ids as they are produced."""
        req = self.submit(token_ids, params, lora=lora)
        yield from _iter_request(req)

    def abort_request(self, rid: int) -> None:
        """Cancel an in-flight request by rid: the scheduler reclaims its
        slot and pages at the top of its next pass, and the caller's
        iterator raises RequestCancelledError. Thread-safe; an unknown or
        finished rid is a no-op that ages out."""
        self._abort_q.put(int(rid))
        self._work.set()

    def shutdown(self):
        self._stop = True
        self._work.set()
        self._thread.join(timeout=5.0)
        self._drain_all(None)

    def _drain_all(self, error: BaseException | None):
        """Unblock every waiting caller: end-of-stream, or the failure."""
        marker = _EngineError(error) if error is not None else _SENTINEL
        for req in list(self._by_slot.values()):
            req.out_queue.put(marker)
        for req in self._backlog:
            req.out_queue.put(marker)
        self._backlog.clear()
        while True:
            try:
                self._waiting.get_nowait().out_queue.put(marker)
            except queue.Empty:
                break

    # ------------------------------------------------------------- scheduler

    def _bucket(self, n: int) -> int:
        return bucket_for(n, self.buckets[0], self.max_len)

    def _pages_needed(self, prompt_len: int, bucket: int, max_tokens: int) -> int:
        """All pages this sequence will EVER touch, granted up front (no
        mid-flight allocation → no page-starvation deadlock): the prompt
        bucket plus generated positions up to prompt_len + max_tokens."""
        last_pos = min(prompt_len + max_tokens, self.max_len - 1)
        return max(bucket // self.page_size, last_pos // self.page_size + 1)

    def _pages_bound(self) -> int:
        """Power-of-two bound on the batch's live page span (host mirror of
        the device lengths): the ragged decode step sweeps only this many
        block-table columns."""
        P = self.page_size
        need = 1
        for req in self._by_slot.values():
            pos = req.length0 + max(0, req.generated - 1)
            need = max(need, pos // P + 1)
        b = 1
        while b < need:
            b *= 2
        return min(b, self.max_pages_per_seq)

    def _next_waiting(self):
        if self._backlog:
            return self._backlog.pop(0)
        try:
            return self._waiting.get_nowait()
        except queue.Empty:
            return None

    def _admit(self):
        admitted = 0
        while self._free and admitted < self.max_prefills_per_step:
            req = self._next_waiting()
            if req is None:
                return
            if self._cancel_at_admission(req):
                continue
            n = len(req.tokens)
            bucket = self._bucket(n)
            need = self._pages_needed(n, bucket, req.params.max_tokens)
            # cheap feasibility check BEFORE paying for the prefill
            if need > len(self._free_pages):
                self._backlog.append(req)
                return  # page pressure: stop admitting this round
            slot = self._free.pop()
            req.slot = slot
            t0 = time.perf_counter()
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = req.tokens
            logits, kv = decoding.prefill(
                self.params, torch.as_tensor(padded, device=self.device), n,
                self.cfg)
            first = decoding.sample(logits[None, :], self._gen,
                                    req.params.temperature, req.params.top_k)
            pages = [self._free_pages.pop() for _ in range(need)]
            self._slot_pages[slot] = pages
            padded_pages = np.zeros((self.max_pages_per_seq,), np.int32)
            padded_pages[:need] = pages
            dp.insert_sequence_paged(self.state, slot, kv, n, first[0],
                                     padded_pages, self.cfg)
            first_id = int(first[0])  # syncs: the prefill is done here
            self.prefills += 1
            self.prefill_seconds += time.perf_counter() - t0
            req.length0 = n
            self._temps[slot] = float(req.params.temperature)
            self._topks[slot] = int(req.params.top_k)
            self._by_slot[slot] = req
            admitted += 1
            self._emit(req, first_id)

    def _emit(self, req: _Request, token_id: int):
        req.generated += 1
        eos = token_id in req.params.stop_token_ids
        if not eos:
            req.out_queue.put(token_id)
        if eos or req.generated >= req.params.max_tokens:
            self._release_active(req)
            req.out_queue.put(_SENTINEL)

    def _release_active(self, req: _Request) -> None:
        """Return an active row's slot and pages to their pools — shared by
        normal completion (_emit) and mid-stream abort (_abort_one)."""
        dp.release_slot_paged(self.state, req.slot)
        self._free_pages.extend(self._slot_pages.pop(req.slot, ()))
        self._free.append(req.slot)
        del self._by_slot[req.slot]

    # -------------------------------------------------- cancellation plane

    def _abort_one(self, req: _Request, err: BaseException) -> bool:
        """Reclaim one request (active slot or page-pressure backlog) and
        surface `err` to its caller. False when it is in neither."""
        if req.slot >= 0 and self._by_slot.get(req.slot) is req:
            self._release_active(req)
        elif req in self._backlog:
            self._backlog.remove(req)
        else:
            return False
        req.out_queue.put(_RequestError(err))
        self.aborts += 1
        return True

    def _apply_aborts(self) -> None:
        now = time.monotonic()
        while True:
            try:
                self._abort_pending.setdefault(self._abort_q.get_nowait(), now)
            except queue.Empty:
                break
        if not self._abort_pending:
            return
        for req in list(self._by_slot.values()) + list(self._backlog):
            if req.rid in self._abort_pending and self._abort_one(
                    req, RequestCancelledError(f"request {req.rid} cancelled")):
                del self._abort_pending[req.rid]
        for rid, t in list(self._abort_pending.items()):
            if now - t > 120.0:
                del self._abort_pending[rid]

    def _expire_deadlines(self) -> None:
        now = time.time()
        for reqs in (self._by_slot.values(), self._backlog):
            for req in list(reqs):
                if req.deadline_ts and now > req.deadline_ts:
                    self._abort_one(req, DeadlineExceededError(
                        f"request {req.rid} deadline exceeded "
                        f"({now - req.deadline_ts:.3f}s past)"))
                    self._abort_pending.pop(req.rid, None)

    def _cancel_at_admission(self, req: _Request) -> bool:
        if self._abort_pending.pop(req.rid, None) is not None:
            err: BaseException = RequestCancelledError(
                f"request {req.rid} cancelled before admission")
        elif req.deadline_ts and time.time() > req.deadline_ts:
            err = DeadlineExceededError(
                f"request {req.rid} deadline expired during queue wait")
        else:
            return False
        req.out_queue.put(_RequestError(err))
        self.aborts += 1
        return True

    def _loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — engine death must unblock callers
            self._error = e
            self._drain_all(e)
            raise

    def _loop_inner(self):
        while not self._stop:
            self._apply_aborts()
            self._expire_deadlines()
            if (not self._by_slot and self._waiting.empty()
                    and not self._backlog):
                self._work.wait(timeout=0.1)
                self._work.clear()
                continue
            self._admit()
            if not self._by_slot:
                continue
            t_step = time.perf_counter()
            self.state, logits = dp.decode_step_paged_ragged(
                self.params, self.state, self.cfg, self._pages_bound())
            toks = decoding.sample_per_row(logits, self._gen, self._temps,
                                           self._topks)
            decoding.commit_tokens(self.state, toks)
            toks_host = toks.cpu().numpy()
            self.decode_steps += 1
            self.decode_slot_steps += len(self._by_slot)
            self.decode_seconds += time.perf_counter() - t_step
            for slot, req in list(self._by_slot.items()):
                self._emit(req, int(toks_host[slot]))

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        return {"free_slots": len(self._free), "active": len(self._by_slot),
                "waiting": self._waiting.qsize() + len(self._backlog),
                "max_slots": self.max_slots, "buckets": list(self.buckets),
                "kv_layout": self.kv_layout, "attn_impl": self.attn_impl,
                "ragged_kernel": self._ragged_kernel,
                "device": str(self.device),
                "decode_steps": self.decode_steps,
                "prefills": self.prefills,
                "prefill_seconds": self.prefill_seconds,
                "decode_seconds": self.decode_seconds,
                "aborts": self.aborts,
                "decode_occupancy": (self.decode_slot_steps / self.decode_steps
                                     if self.decode_steps else 0.0),
                "free_pages": len(self._free_pages),
                "num_pages": self.num_pages,
                "page_size": self.page_size}
