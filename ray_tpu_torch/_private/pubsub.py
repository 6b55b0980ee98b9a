"""Long-poll pubsub client over the GCS control plane.

Reference capability: src/ray/pubsub/ — `Publisher`/`SubscriberState`
long-poll channels used for object locations, actor state, logs and errors
(publisher.h:159, subscriber.h:63, python_gcs_subscriber.h).

Channels published by the GCS today: ``actor_state`` (every actor
transition), ``errors`` (task failures). User code can publish to arbitrary
channels with `publish()` — fan-out is per-subscriber buffered queues with a
parked long-poll reply when the queue is empty.
"""

from __future__ import annotations

import uuid
from typing import Any, List, Optional

def _default_worker():
    """The process's CoreWorker: driver (api._worker) or task worker."""
    from ray_tpu_torch._private import api
    from ray_tpu_torch._private.worker import _global_worker

    w = _global_worker or api._worker
    if w is None or not hasattr(w, "rpc"):
        raise RuntimeError("pubsub requires a connected (non-local) session")
    return w


def publish(channel: str, data: Any) -> None:
    """Publish `data` to every subscriber of `channel`."""
    _default_worker().send_no_reply(
        {"type": "publish", "channel": channel, "data": data})


class Subscriber:
    """Subscribe to a GCS pubsub channel; `poll()` long-polls for batches."""

    def __init__(self, channel: str, worker=None):
        self.channel = channel
        self.sub_id = uuid.uuid4().hex[:16]
        self._worker = worker or _default_worker()
        self._closed = False
        # an outstanding long-poll future that timed out client-side: the GCS
        # still holds the parked rid and will answer it on the next publish,
        # so we must keep waiting on THIS future — issuing a fresh poll would
        # let that answer land on a dead rid and lose the batch
        self._inflight = None
        reply = self._worker.rpc({"type": "subscribe", "channel": channel,
                                  "sub_id": self.sub_id})
        if not reply.get("ok"):
            raise RuntimeError(f"subscribe failed: {reply}")

    def poll(self, timeout: Optional[float] = None) -> List[Any]:
        """Return the next batch of messages (possibly empty on timeout or
        after close)."""
        if self._closed:
            return []
        from ray_tpu_torch.exceptions import GetTimeoutError

        if self._inflight is None:
            self._inflight = self._worker.rpc_async(
                {"type": "pubsub_poll", "channel": self.channel,
                 "sub_id": self.sub_id})
        try:
            reply = self._inflight.wait(timeout)
        except GetTimeoutError:
            return []
        self._inflight = None
        if reply.get("closed"):
            self._closed = True
        return reply.get("items", [])

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._worker.rpc({"type": "unsubscribe", "channel": self.channel,
                              "sub_id": self.sub_id}, timeout=5.0)
        except Exception:
            pass
