"""Actor↔actor channels of the port.

(reference: python/ray/experimental/channel/ — shm `Channel` over mutable
plasma objects (shared_memory_channel.py:151). Here a channel is either a
bounded SPSC pipe whose payloads ride the shm object store while only the
refs pass through a rendezvous actor (`Channel`), or a same-host mutable
shared-memory buffer (`MutableShmChannel`), which the compiled-DAG plane
and the PD KV transfer plane run on.)
"""

from ray_tpu_torch.experimental.channel.channel import (Channel, ChannelClosed,
                                                        create_channel)
from ray_tpu_torch.experimental.channel.mutable_shm import (
    MutableShmChannel, create_mutable_channel)

__all__ = ["Channel", "ChannelClosed", "create_channel",
           "MutableShmChannel", "create_mutable_channel"]
