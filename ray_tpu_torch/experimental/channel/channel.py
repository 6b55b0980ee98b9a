"""Bounded SPSC channel: object-store payloads, actor-brokered refs.

The port's copy of ray_tpu/experimental/channel/channel.py (reference:
experimental/channel/shared_memory_channel.py:151 — write blocks when the
buffer is full until the reader consumes (backpressure); close raises in
blocked peers. The C++ mutable-object plane
(src/ray/core_worker/experimental_mutable_object_manager.h:44) is collapsed
into ref-passing through a tiny broker actor; numpy arrays and tensors
still move through shm via pickle-5 buffers.)
"""

from __future__ import annotations


import ray_tpu_torch


class ChannelClosed(Exception):
    pass


@ray_tpu_torch.remote
class _Broker:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: list = []
        self.closed = False

    def offer(self, ref_hex: str) -> bool:
        if self.closed:
            return False
        if len(self.items) >= self.maxsize:
            return None  # full: caller retries (backpressure)
        self.items.append(ref_hex)
        return True

    def take(self):
        if self.items:
            return self.items.pop(0)
        return False if self.closed else None

    def close(self, drain: bool = False) -> list:
        self.closed = True
        if not drain:
            return []  # readers consume (and free) what's queued, then see closed
        leftover, self.items = self.items, []
        return leftover  # refs the closer must free (no reader will)

    def size(self) -> int:
        return len(self.items)


class Channel:
    def __init__(self, broker, maxsize: int):
        self._broker = broker
        self.maxsize = maxsize

    def write(self, value, timeout: float | None = 60.0) -> None:
        from ray_tpu_torch._private.poll import poll_until

        # pinned: the payload travels broker→reader as a raw id, invisible to
        # the reference counter; the reader (or close) frees it explicitly
        from ray_tpu_torch._private.api import _get_worker

        ref = _get_worker().put(value, pin=True)

        def offer():
            ok = ray_tpu_torch.get(self._broker.offer.remote(ref.hex()))
            if ok is False:
                raise ChannelClosed("channel closed")
            return True if ok else None

        try:
            poll_until(offer, timeout, "channel write timed out (reader too slow)")
        except (ChannelClosed, TimeoutError):
            ray_tpu_torch.free([ref])  # never enqueued: don't leak the payload
            raise

    def read(self, timeout: float | None = 60.0):
        from ray_tpu_torch._private.poll import poll_until
        from ray_tpu_torch._private.worker import ObjectRef

        def take():
            got = ray_tpu_torch.get(self._broker.take.remote())
            if got is False:
                raise ChannelClosed("channel closed and drained")
            return got  # str ref hex, or None → keep polling

        hex_id = poll_until(take, timeout, "channel read timed out")
        ref = ObjectRef(hex_id)
        value = ray_tpu_torch.get(ref)
        ray_tpu_torch.free([ref])  # slot consumed: single-consumer semantics
        return value

    def close(self, drain: bool = False) -> None:
        """Graceful by default: queued items remain readable, then readers see
        ChannelClosed. `drain=True` abandons unread items (frees their
        payloads) — use when no reader will ever come."""
        from ray_tpu_torch._private.worker import ObjectRef

        try:
            leftover = ray_tpu_torch.get(self._broker.close.remote(drain))
            if leftover:
                ray_tpu_torch.free([ObjectRef(h) for h in leftover])
        except Exception:
            pass

    def __reduce__(self):
        return (Channel, (self._broker, self.maxsize))


def create_channel(maxsize: int = 2, *, transport: str = "broker",
                   buffer_bytes: int = 1 << 20):
    """transport="broker" (default): the ref-passing channel, for peers the
    runtime can reach. transport="shm": same-host mutable shared-memory
    channel — microsecond hops, maxsize fixed at 1 (the mutable-buffer
    semantics of the reference's shared_memory_channel.py:151)."""
    if transport == "shm":
        from ray_tpu_torch.experimental.channel.mutable_shm import (
            create_mutable_channel)

        return create_mutable_channel(buffer_bytes)
    broker = _Broker.options(num_cpus=0.1).remote(maxsize)
    return Channel(broker, maxsize)
