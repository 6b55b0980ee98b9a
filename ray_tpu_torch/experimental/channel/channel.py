"""The channel error type (ray_tpu/experimental/channel/channel.py's
``ChannelClosed``). The broker ``Channel`` there is an actor and is not
ported."""

from __future__ import annotations


class ChannelClosed(Exception):
    pass
