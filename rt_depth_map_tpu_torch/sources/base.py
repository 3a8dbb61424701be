# Copy of rt_depth_map_tpu/sources/base.py; the port imports nothing of the JAX package.
"""StereoSource protocol (reference VideoStreamStereoDevice parity).

The reference hands the estimator raw still-encoded buffers
(`struct videoStreamBuffer {char* data; int len;}`,
include/stream/video-stream-stereo-device.h:11-14) which the decoder stage
turns into RGB. A StereoFrame carries either encoded bytes (`data`,
`encoding="mjpeg"`) or an already-decoded RGB array (`array`,
`encoding="raw"`); the engine routes encoded frames through the decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Tuple

import numpy as np


@dataclasses.dataclass
class StereoFrame:
    """One eye's frame buffer."""

    encoding: str  # "mjpeg" | "raw"
    data: Optional[bytes] = None  # encoded bytes (encoding != "raw")
    array: Optional[np.ndarray] = None  # (H, W, 3) uint8 RGB (encoding == "raw")


class StereoSource(Protocol):
    """Synchronized stereo capture (grabOneFrame + getBuffers parity)."""

    width: int
    height: int
    #: frames arrive already rectified (synthetic scenes are constructed in
    #: rectified space); the engine then uses identity remap grids
    rectified: bool

    def grab(self) -> Tuple[StereoFrame, StereoFrame]:
        """Blocking: acquire one synchronized (left, right) pair."""
        ...

    def close(self) -> None: ...
