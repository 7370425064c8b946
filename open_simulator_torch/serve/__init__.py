"""Resident what-if serving: the device-resident cluster image.

Port of `open_simulator_tpu/serve/`: a persistent cluster image kept on the
device and current by watch-event deltas (serve/image.py), with
copy-on-write what-if sessions dispatched as lanes of the serve fan-outs.
The micro-batching service, HA state and HTTP/gRPC front ends built on it
(serve/batch.py, serve/ha.py, server/) are not ported yet (ROADMAP A10b).
"""

from .image import (  # noqa: F401
    ImageDonatedError,
    ResidentImage,
    StaleImageError,
    WhatIfSession,
)
