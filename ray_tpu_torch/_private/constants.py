"""Cross-process names of the port: its shm directory and channel prefix.

The port's own copy of the shm names in ray_tpu/_private/constants.py.
The channel prefix differs from the JAX package's (``rtpu_chan_``) on
purpose: a leak check that globs one package's segments must never see the
other's, when both packages' tests run side by side on one host.
"""

from __future__ import annotations

#: tmpfs directory the port's shm segments live in.
SHM_DIR = "/dev/shm"

#: mutable seqlock channel segments (the PD KV transfer plane):
#: f"{SHM_CHANNEL_PREFIX}{uuid}" under SHM_DIR. Leak checks glob
#: SHM_CHANNEL_GLOB and must agree with the creator's naming.
SHM_CHANNEL_PREFIX = "rtpt_chan_"

#: glob matching every live channel segment of the port.
SHM_CHANNEL_GLOB = SHM_DIR + "/" + SHM_CHANNEL_PREFIX + "*"
