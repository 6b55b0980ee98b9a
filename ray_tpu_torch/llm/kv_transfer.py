"""Paged-KV transfer plane for PD disaggregation, on torch tensors.

The port of ray_tpu/llm/kv_transfer.py. The prefill→decode handoff moves
the prefilled KV prefix at paged-KV **page granularity** over
`MutableShmChannel` with a ticket/pull protocol:

- the prefill side computes the prompt KV and ``export()``s it: the KV
  comes to the host once (one device-to-host copy of K and of V when it is
  on the card), is sliced into ``[L, page_size, Hkv, Dh]`` pages, and a
  per-ticket shm channel carries them in messages of up to
  ``prefetch_pages`` pages (the seqlock write blocks until the reader
  consumed the previous message: one message in flight per transfer). A
  prefix that fits ONE message is written synchronously in ``export()``
  itself ("sync" tickets, no sender thread; the reader retires the
  channel);
- the ticket is a small dict (channel path, page count, shapes, first
  token): whoever routes it never holds KV;
- the decode side attaches by path. A ``BatchedKVPuller`` (one polling
  thread for every in-flight transfer) feeds a ``KVPageStream`` that the
  engine adopts pages from as they arrive
  (``LLMEngine.submit_prefilled(kv_stream=...)``); ``pull_pages()`` /
  ``pull_all()`` are the blocking single-ticket surface.

Page bytes cross the channel raw (vectored writes, zero-copy read views;
pickle frames only the small per-message header), through a uint8 view of
the page so bf16 needs no buffer protocol of its own. The header carries
the torch dtype's name. A page read off the channel is cloned before the
ack, since the writer may overwrite the buffer after it.

Both ends share one host (/dev/shm). The request-phase histograms and
tracing spans of the JAX package's plane belong to Serve's request context
and land with the Serve layer's port.
"""

from __future__ import annotations

import logging
import pickle
import struct
import threading
import time
import uuid

import torch

from ray_tpu_torch.experimental.channel.channel import ChannelClosed
from ray_tpu_torch.experimental.channel.mutable_shm import (
    MutableShmChannel, create_mutable_channel)

logger = logging.getLogger(__name__)

# framing slack per page message (length prefix + pickled header); the
# payload itself is raw page bytes written vectored into the channel
_WIRE_SLACK = 8192

_LEN = struct.Struct("<q")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _raw_bytes(t: torch.Tensor):
    """Zero-copy byte view of a contiguous CPU tensor, through uint8 (a
    bf16 tensor has no numpy counterpart)."""
    return memoryview(t.view(torch.uint8).reshape(-1).numpy())


def _pack_page_message(start: int, kps: list, vps: list) -> list:
    """Raw frame for one transfer message: [len][pickled tiny header]
    [k0][v0][k1][v1]...: page bytes go into the channel vectored, never
    through pickle, one memcpy per side."""
    hdr = pickle.dumps({"i": int(start), "n": len(kps),
                        "shape": tuple(kps[0].shape),
                        "dtype": _dtype_name(kps[0].dtype)},
                       protocol=pickle.HIGHEST_PROTOCOL)
    parts = [_LEN.pack(len(hdr)), hdr]
    for kp, vp in zip(kps, vps):
        parts.append(_raw_bytes(kp))
        parts.append(_raw_bytes(vp))
    return parts


def _unpack_page_view(view):
    """Parse one raw page message. The returned tensors VIEW the channel
    buffer: the caller clones what it keeps BEFORE ack_read()."""
    (hlen,) = _LEN.unpack_from(view, 0)
    meta = pickle.loads(view[_LEN.size:_LEN.size + hlen])
    shape = meta["shape"]
    dt = getattr(torch, meta["dtype"])
    count = 1
    for d in shape:
        count *= d
    nb = count * torch.empty((), dtype=dt).element_size()
    off = _LEN.size + hlen
    kps, vps = [], []
    for _ in range(meta["n"]):
        for out in (kps, vps):
            out.append(torch.frombuffer(view, dtype=torch.uint8, count=nb,
                                        offset=off).view(dt).reshape(shape))
            off += nb
    return meta["i"], kps, vps


def _copy_pages(start: int, kviews: list, vviews: list) -> list:
    """(index, k, v) copies of a message's pages, safe to keep past the
    ack."""
    return [(start + off, kv.clone(), vv.clone())
            for off, (kv, vv) in enumerate(zip(kviews, vviews))]


class KVTransferError(RuntimeError):
    """A KV handoff failed mid-flight: the per-REQUEST failure (the other
    transfers and both pools keep serving)."""


def _metrics():
    from ray_tpu_torch.util import metrics as met

    return (
        met.get_or_create(
            met.Counter, "ray_tpu_llm_pd_transfer_bytes_total",
            "KV bytes moved prefill->decode over the shm transfer plane"),
        met.get_or_create(
            met.Counter, "ray_tpu_llm_pd_kv_pages_total",
            "KV pages moved prefill->decode over the shm transfer plane"),
    )


def _prefetch_metric():
    from ray_tpu_torch.util import metrics as met

    return met.get_or_create(
        met.Counter, "ray_tpu_llm_pd_pages_prefetched_total",
        "KV pages pulled onto the decode host ahead of slot activation "
        "(streamed admission: batched puller + inline sync pulls)")


def _not_found(tid: str, path: str) -> KVTransferError:
    return KVTransferError(
        f"kv transfer {tid}: channel {path} not found — the prefill side "
        "died (or retired the ticket), or prefill and decode are not "
        "co-hosted (shm transfer is same-host)")


def _closed_after(tid: str, done: int, n: int) -> KVTransferError:
    return KVTransferError(
        f"kv transfer {tid}: prefill side closed after {done}/{n} pages "
        "(prefill death or abort mid-transfer)")


class _Transfer:
    __slots__ = ("ticket_id", "channel", "thread", "failed", "created")

    def __init__(self, ticket_id: str, channel: MutableShmChannel):
        self.ticket_id = ticket_id
        self.channel = channel
        self.thread: threading.Thread | None = None  # None = sync transfer
        self.failed: str | None = None
        self.created = time.monotonic()


class PagedKVExporter:
    """Prefill-side registry of in-flight page transfers.

    ``export()`` returns the ticket immediately. A prefix that fits one
    message ("sync") is written in the caller's thread: the reader retires
    the channel, and ``_reap_settled`` sweeps never-pulled ones. Larger
    transfers stream from a sender thread each and retire their channel
    after a ``wait_drained`` barrier. A receiver that never attaches, or
    dies mid-pull, times the sender out after ``send_timeout_s``: the
    channel is torn down either way, so /dev/shm cannot accumulate
    segments.
    """

    def __init__(self, *, send_timeout_s: float = 60.0,
                 prefetch_pages: int = 2, page_interval_s: float = 0.0):
        self.send_timeout_s = float(send_timeout_s)
        # pages per channel message: the transfer's in-flight window
        self.prefetch_pages = max(1, int(prefetch_pages))
        # pacing between messages (tests: a slow sender shows that decode
        # keeps emitting under partial admission)
        self.page_interval_s = float(page_interval_s)
        self._live: dict[str, _Transfer] = {}
        self._lock = threading.Lock()
        # one self-rescheduling timer reaps never-pulled SYNC channels even
        # on an idle exporter (sync transfers have no thread of their own)
        self._reap_timer: threading.Timer | None = None
        self._torn_down = False
        self._m_bytes, self._m_pages = _metrics()
        self.failures = 0        # transfers that did not complete
        self.last_failure = ""   # "<ticket>: <reason>" for triage

    # ------------------------------------------------------------- export

    def export(self, k, v, length: int, first_token: int,
               page_size: int) -> dict:
        """Slice a bucketed prompt KV (``[L, T, Hkv, Dh]`` tensors on the
        card or the host, T a multiple of ``page_size``) into pages and
        start streaming them. Returns the ticket for the decode side."""
        k = torch.as_tensor(k).detach()
        v = torch.as_tensor(v).detach()
        L, T = k.shape[0], k.shape[1]
        if page_size <= 0 or T % page_size:
            raise ValueError(
                f"prefill bucket {T} is not a multiple of page_size "
                f"{page_size}: configure the prefill side with "
                f"min_bucket >= page_size")
        # one device-to-host copy of each; pages are sliced on the host
        k, v = k.cpu(), v.cpu()
        n_pages = T // page_size
        depth = min(self.prefetch_pages, n_pages)
        page_bytes = (k.nbytes + v.nbytes) // n_pages
        tid = uuid.uuid4().hex[:16]
        self._reap_settled()
        ch = create_mutable_channel(depth * page_bytes + _WIRE_SLACK)
        # whole prefix in ONE message: write it now in the caller's thread
        # (a fresh channel never blocks) and let the READER retire the
        # channel; the reaper sweeps never-pulled sync channels
        sync = n_pages <= depth and not self.page_interval_s
        try:
            tr = _Transfer(tid, ch)
            if sync:
                kps, vps = _pages(k, v, 0, n_pages, page_size)
                ch.write_vectored(_pack_page_message(0, kps, vps), timeout=0)
                self._m_bytes.inc(k.nbytes + v.nbytes)
                self._m_pages.inc(n_pages)
                with self._lock:
                    self._live[tid] = tr
                self._arm_reap_timer()
            else:
                with self._lock:
                    self._live[tid] = tr
                tr.thread = threading.Thread(
                    target=self._send, args=(tr, k, v, page_size, n_pages),
                    daemon=True, name=f"pd-kv-send-{tid[:6]}")
                # until start() succeeds the sender's finally owns nothing:
                # a failed spawn is rolled back below
                tr.thread.start()
        except BaseException:
            with self._lock:
                self._live.pop(tid, None)
            ch.close()
            ch.unlink()
            raise
        return {
            "ticket": tid,
            "path": ch.path,
            "capacity": ch.capacity,
            "n_pages": n_pages,
            "prefetch": depth,
            "sync": sync,
            "page_size": page_size,
            "length": int(length),
            "first_token": int(first_token),
            "bucket": T,
            "page_shape": (L, page_size, k.shape[2], k.shape[3]),
            "dtype": _dtype_name(k.dtype),
        }

    def _send(self, tr: _Transfer, k, v, page_size: int, n_pages: int):
        ch = tr.channel
        depth = min(self.prefetch_pages, n_pages)
        try:
            for start in range(0, n_pages, depth):
                m = min(depth, n_pages - start)
                kps, vps = _pages(k, v, start, m, page_size)
                if self.page_interval_s:
                    time.sleep(self.page_interval_s)
                ch.write_vectored(_pack_page_message(start, kps, vps),
                                  timeout=self.send_timeout_s)
                self._m_bytes.inc(sum(p.nbytes for p in kps + vps))
                self._m_pages.inc(m)
            # the final message is published but possibly unread: wait for
            # the reader's ack before unlinking the segment
            ch.wait_drained(timeout=self.send_timeout_s)
        except ChannelClosed:
            tr.failed = "closed"  # teardown/abort raced the send: expected
        except TimeoutError:
            tr.failed = "timeout"  # receiver never attached or died mid-pull
            logger.warning("kv transfer %s: send timed out after %.1fs "
                           "(decode side never pulled, or died mid-pull)",
                           tr.ticket_id, self.send_timeout_s)
        except Exception as e:  # noqa: BLE001 — must never leak the segment
            tr.failed = f"{type(e).__name__}: {e}"
            logger.warning("kv transfer %s: sender failed: %s",
                           tr.ticket_id, tr.failed)
        finally:
            ch.close()
            ch.unlink()
            with self._lock:
                self._live.pop(tr.ticket_id, None)
                if tr.failed is not None:
                    self.failures += 1
                    self.last_failure = f"{tr.ticket_id}: {tr.failed}"

    # ---------------------------------------------------------- lifecycle

    def _arm_reap_timer(self) -> None:
        """Keep ONE timer pending while sync transfers are live: a
        never-pulled sync channel retires after send_timeout_s even if this
        exporter never exports again."""
        with self._lock:
            if self._torn_down or self._reap_timer is not None:
                return
            if not any(tr.thread is None for tr in self._live.values()):
                return
            t = threading.Timer(self.send_timeout_s + 1.0, self._reap_tick)
            t.daemon = True
            self._reap_timer = t
        t.start()

    def _reap_tick(self) -> None:
        with self._lock:
            self._reap_timer = None
        self._reap_settled()
        self._arm_reap_timer()  # re-arms iff sync transfers remain

    def _reap_settled(self) -> None:
        """Retire settled SYNC transfers: drained ones silently (the reader
        consumed the message and unlinked the name), expired never-pulled
        ones as failures. Threaded transfers retire in the sender's
        finally; teardown sweeps whatever remains."""
        now = time.monotonic()
        done: list[_Transfer] = []
        with self._lock:
            for tr in list(self._live.values()):
                if tr.thread is not None:
                    continue
                drained = tr.channel.drained()
                expired = now - tr.created > self.send_timeout_s
                if drained or expired:
                    self._live.pop(tr.ticket_id, None)
                    if expired and not drained:
                        tr.failed = "timeout"
                        self.failures += 1
                        self.last_failure = (f"{tr.ticket_id}: timeout "
                                             "(decode side never pulled)")
                    done.append(tr)
        for tr in done:
            tr.channel.close()
            tr.channel.unlink()

    def pending(self) -> int:
        self._reap_settled()
        with self._lock:
            return len(self._live)

    def abort(self, ticket_id: str) -> None:
        """Kill one in-flight transfer (its puller observes ChannelClosed →
        KVTransferError): the prefill side is shutting down or the request
        was cancelled upstream."""
        with self._lock:
            tr = self._live.get(ticket_id)
        if tr is None:
            return
        if tr.thread is None:  # sync transfer: retire it here
            tr.channel.close()
            tr.channel.unlink()
            with self._lock:
                self._live.pop(ticket_id, None)
            return
        tr.channel.close()
        tr.thread.join(timeout=5.0)

    def teardown(self) -> None:
        """Close every live channel, join the senders, unlink the segments.
        Safe to call twice; after it returns /dev/shm holds none of this
        exporter's segments."""
        with self._lock:
            self._torn_down = True
            timer, self._reap_timer = self._reap_timer, None
            live = list(self._live.values())
        if timer is not None:
            timer.cancel()
        for tr in live:
            tr.channel.close()
        for tr in live:
            if tr.thread is not None:
                tr.thread.join(timeout=5.0)
            tr.channel.unlink()  # sync transfers retire here too
        with self._lock:
            for tr in live:
                self._live.pop(tr.ticket_id, None)


def _pages(k, v, start: int, m: int, page_size: int):
    """Pages start..start+m-1 of host K and V, each copied contiguous once
    (a page is a strided slice of the bucket)."""
    sl = [slice((start + i) * page_size, (start + i + 1) * page_size)
          for i in range(m)]
    return ([k[:, s].contiguous() for s in sl],
            [v[:, s].contiguous() for s in sl])


# ----------------------------------------------------------------- receiver


def pull_pages(ticket: dict, timeout_s: float = 60.0):
    """Decode-side pull: attach to the ticket's channel and yield
    ``(index, k_page, v_page)`` in order (each ``[L, page_size, Hkv, Dh]``
    CPU tensors). Every failure surfaces as KVTransferError naming the
    ticket: the per-request error contract."""
    tid = ticket.get("ticket", "?")
    try:
        ch = MutableShmChannel(ticket["path"], ticket["capacity"])
    except FileNotFoundError:
        raise _not_found(tid, ticket["path"]) from None
    i = 0
    try:
        while i < ticket["n_pages"]:
            try:
                view = ch.read_view(timeout=timeout_s)
            except ChannelClosed:
                raise _closed_after(tid, i, ticket["n_pages"]) from None
            except TimeoutError:
                raise KVTransferError(
                    f"kv transfer {tid}: timed out waiting for page {i} of "
                    f"{ticket['n_pages']} after {timeout_s}s") from None
            pages = _copy_pages(*_unpack_page_view(view))
            del view  # release the export before the mapping can close
            ch.ack_read()
            yield from pages
            i += len(pages)
        if ticket.get("sync"):
            # sync transfer fully consumed: the READER retires the channel
            # (the exporter spawned no sender to do it)
            ch.close()
            ch.unlink()
    finally:
        ch.close_mapping()


def pull_all(ticket: dict, timeout_s: float = 60.0):
    """Pull the whole transfer: ``(k_pages, v_pages)`` as ordered lists of
    page tensors, ready for ``LLMEngine.submit_prefilled(k_pages=...)``."""
    k_pages: list = [None] * ticket["n_pages"]
    v_pages: list = [None] * ticket["n_pages"]
    for i, kp, vp in pull_pages(ticket, timeout_s):
        k_pages[i] = kp
        v_pages[i] = vp
    return k_pages, v_pages


# -------------------------------------------------------- streamed admission


class KVPageStream:
    """Thread-safe hand-off between the transfer plane and the engine.

    The puller (or an inline sync pull) ``feed()``s pages as they come off
    the channel; the engine's scheduler ``take_ready()``s them between
    decode steps and adopts each into the paged pool
    (``LLMEngine.submit_prefilled(kv_stream=...)``), activating the slot
    once all ``n_pages`` landed. ``fail()`` turns the in-flight request into
    a per-request error: the engine reclaims the slot and its pages.
    """

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        self._ready: list = []
        self._error: BaseException | None = None
        self.fed = 0
        self.finished_ts: float | None = None
        # set by the engine at submit: wakes the scheduler so a parked loop
        # adopts new pages immediately
        self._wake = None

    # ---------------------------------------------------- transfer side

    def feed(self, index: int, k_page, v_page) -> None:
        with self._lock:
            self._ready.append((int(index), k_page, v_page))
            self.fed += 1
        wake = self._wake
        if wake is not None:
            wake()

    def finish(self) -> None:
        self.finished_ts = time.time()
        wake = self._wake
        if wake is not None:
            wake()

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            self._error = exc
        wake = self._wake
        if wake is not None:
            wake()

    # ------------------------------------------------------ engine side

    def take_ready(self) -> list:
        with self._lock:
            out, self._ready = self._ready, []
            return out

    def take_error(self) -> BaseException | None:
        with self._lock:
            return self._error


class _DiscardSink:
    """Drain-only sink (the decode budget was already spent by the
    transferred token): the channel is still consumed so the prefill side
    retires it, but nothing is adopted."""

    #: pull paths skip the copy out of shm for sinks that drop the pages
    keeps_pages = False

    def feed(self, index, k_page, v_page) -> None:
        pass

    def finish(self) -> None:
        pass

    def fail(self, exc) -> None:
        pass


def pull_sync(ticket: dict, sink) -> bool:
    """Inline pull for single-message ("sync") tickets: the message was
    published before the ticket was returned, so the caller consumes it
    right here, feeds ``sink`` (feed per page, then finish) and retires the
    channel. Returns False when the ticket is not sync (register it with a
    BatchedKVPuller instead)."""
    if not ticket.get("sync"):
        return False
    tid = ticket.get("ticket", "?")
    try:
        ch = MutableShmChannel(ticket["path"], ticket["capacity"])
    except FileNotFoundError:
        raise _not_found(tid, ticket["path"]) from None
    try:
        try:
            view = ch.read_view(timeout=0)
        except (ChannelClosed, TimeoutError):
            raise KVTransferError(
                f"kv transfer {tid}: sync message missing (aborted or "
                "reaped before the pull)") from None
        start, kviews, vviews = _unpack_page_view(view)
        n_fed = len(kviews)
        # a drain-only sink acks without paying the copy
        pages = (_copy_pages(start, kviews, vviews)
                 if getattr(sink, "keeps_pages", True) else [])
        del kviews, vviews, view
        ch.ack_read()
        ch.close()
        ch.unlink()
    finally:
        ch.close_mapping()
    _prefetch_metric().inc(n_fed)
    for idx, kp, vp in pages:
        sink.feed(idx, kp, vp)
    sink.finish()
    return True


class _Pull:
    __slots__ = ("ticket_id", "channel", "sink", "n_pages", "next_i",
                 "timeout_s", "last_progress", "aborted")

    def __init__(self, ticket_id, channel, sink, n_pages, timeout_s, now):
        self.ticket_id = ticket_id
        self.channel = channel
        self.sink = sink
        self.n_pages = n_pages
        self.next_i = 0
        self.timeout_s = timeout_s
        self.last_progress = now
        self.aborted = False  # abort(): finished by the polling thread


class BatchedKVPuller:
    """One polling thread multiplexes EVERY in-flight ticket pull.

    A thread per transfer would park N readers in the seqlock wait; here a
    single thread sweeps all registered channels per cycle with
    non-blocking ``poll()`` reads, so N concurrent transfers cost one wake,
    and pages flow into their ``KVPageStream`` sinks as the sender publishes
    them. Single-message ("sync") tickets bypass the thread: they are
    consumed inline at ``pull()``.
    """

    def __init__(self, *, name: str = "pd-kv-pull"):
        self._lock = threading.Lock()
        self._pulls: list[_Pull] = []
        self._work = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._name = name
        self._m_prefetched = _prefetch_metric()

    # ------------------------------------------------------ registration

    def pull(self, ticket: dict, sink, timeout_s: float = 60.0) -> None:
        """Register one transfer; returns immediately. ``sink`` receives
        ``feed(i, k_page, v_page)`` per page in order, then ``finish()``, or
        ``fail(KVTransferError)`` on death/timeout. Raises KVTransferError
        at once when the channel is already gone."""
        tid = ticket.get("ticket", "?")
        if self._stop:
            raise KVTransferError(f"kv transfer {tid}: puller is torn down")
        if pull_sync(ticket, sink):
            return
        try:
            ch = MutableShmChannel(ticket["path"], ticket["capacity"])
        except FileNotFoundError:
            raise _not_found(tid, ticket["path"]) from None
        p = _Pull(tid, ch, sink, int(ticket["n_pages"]), float(timeout_s),
                  time.monotonic())
        with self._lock:
            # re-check under the lock: teardown() flips _stop and sweeps
            # _pulls under it, so a racing pull must not register a _Pull
            # nobody will ever service
            if self._stop:
                ch.close_mapping()
                raise KVTransferError(
                    f"kv transfer {tid}: puller is torn down")
            self._pulls.append(p)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name=self._name)
                self._thread.start()
        self._work.set()

    def drain(self, ticket: dict, timeout_s: float = 60.0) -> None:
        """Consume a ticket's pages without adopting them (the transferred
        first token already spent the decode budget)."""
        self.pull(ticket, _DiscardSink(), timeout_s)

    def pending(self) -> int:
        with self._lock:
            return len(self._pulls)

    def abort(self, ticket_id: str) -> bool:
        """Cancel a registered pull (the request was cancelled on the decode
        side). The polling thread, the only reader of the channel, closes
        it (which stops the sender) and fails the sink on its next cycle.
        False for a ticket already finished or consumed inline."""
        with self._lock:
            for p in self._pulls:
                if p.ticket_id == ticket_id:
                    p.aborted = True
                    self._work.set()
                    return True
        return False

    # ------------------------------------------------------------- loop

    def _finish(self, p: _Pull, exc: BaseException | None) -> None:
        # only threaded tickets register here, and their sender retires the
        # channel: the reader only detaches
        p.channel.close_mapping()
        with self._lock:
            if p in self._pulls:
                self._pulls.remove(p)
        if exc is None:
            p.sink.finish()
        else:
            logger.warning("kv transfer %s: pull failed: %s",
                           p.ticket_id, exc)
            p.sink.fail(exc)

    def _sweep_one(self, p: _Pull, now: float) -> bool:
        """Drain every message ready on one channel; True if any page
        moved."""
        progressed = False
        while p.channel.poll():
            view = p.channel.read_view(timeout=0)
            start, kviews, vviews = _unpack_page_view(view)
            n = len(kviews)
            pages = (_copy_pages(start, kviews, vviews)
                     if getattr(p.sink, "keeps_pages", True) else [])
            del kviews, vviews, view
            p.channel.ack_read()
            for idx, kp, vp in pages:
                p.sink.feed(idx, kp, vp)
            p.next_i += n
            self._m_prefetched.inc(n)
            p.last_progress = time.monotonic()
            progressed = True
            if p.next_i >= p.n_pages:
                self._finish(p, None)
                return True
        if not progressed:
            if p.channel.closed():
                # poll() drained whatever was already published, so a
                # flipped flag here means the stream ended incomplete
                self._finish(p, _closed_after(p.ticket_id, p.next_i,
                                              p.n_pages))
            elif now - p.last_progress > p.timeout_s:
                self._finish(p, KVTransferError(
                    f"kv transfer {p.ticket_id}: timed out waiting for page "
                    f"{p.next_i} of {p.n_pages} after {p.timeout_s}s"))
        return progressed

    def _loop(self) -> None:
        quiet_since: float | None = None
        while not self._stop:
            with self._lock:
                pulls = list(self._pulls)
            if not pulls:
                self._work.wait(timeout=0.1)
                self._work.clear()
                quiet_since = None
                continue
            progressed = False
            for p in pulls:
                try:
                    if p.aborted:
                        # reader-side close: the shared flag stops the
                        # sender at its next write; the sink fails so the
                        # engine reclaims the granted slot
                        p.channel.close()
                        self._finish(p, KVTransferError(
                            f"kv transfer {p.ticket_id}: cancelled by the "
                            f"decode side after {p.next_i}/{p.n_pages} "
                            "pages (request aborted)"))
                        progressed = True
                        continue
                    progressed |= self._sweep_one(p, time.monotonic())
                except ChannelClosed:
                    self._finish(p, _closed_after(p.ticket_id, p.next_i,
                                                  p.n_pages))
                except KVTransferError as e:
                    self._finish(p, e)
                except Exception as e:  # noqa: BLE001 — one bad channel
                    # must not take down the other transfers' pull loop
                    self._finish(p, KVTransferError(
                        f"kv transfer {p.ticket_id}: pull failed: "
                        f"{type(e).__name__}: {e}"))
            if progressed:
                quiet_since = None
                continue
            # nothing ready on ANY channel: one escalating, interruptible
            # sleep covers the whole set (a new registration wakes it)
            now = time.monotonic()
            if quiet_since is None:
                quiet_since = now
            quiet = now - quiet_since
            if quiet < 0.002:
                time.sleep(50e-6)
            else:
                self._work.wait(timeout=200e-6 if quiet < 0.02 else 1e-3)
                self._work.clear()

    def teardown(self) -> None:
        """Stop the thread and fail every outstanding pull. Safe to call
        twice; after it returns no mapping of this puller's remains."""
        with self._lock:
            self._stop = True
            t = self._thread
        self._work.set()
        if t is not None:
            t.join(timeout=5.0)
        with self._lock:
            pulls, self._pulls = list(self._pulls), []
        for p in pulls:
            p.channel.close_mapping()
            p.sink.fail(KVTransferError(
                f"kv transfer {p.ticket_id}: puller torn down mid-pull"))
