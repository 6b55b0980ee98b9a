"""Channels of the port: the mutable shared-memory SPSC channel the PD
KV transfer plane runs on. The broker-backed ``Channel`` of the JAX
package is an actor and waits for the runtime's port."""

from ray_tpu_torch.experimental.channel.channel import ChannelClosed
from ray_tpu_torch.experimental.channel.mutable_shm import (
    MutableShmChannel, create_mutable_channel)

__all__ = ["ChannelClosed", "MutableShmChannel", "create_mutable_channel"]
