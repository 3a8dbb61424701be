"""The rectification constants the engine consumes.

Copy of the `RectificationResult` dataclass of
`rt_depth_map_tpu/calib/rectify.py`; the port imports nothing of the JAX
package. Computing the maps from calibration files
(`compute_rectification`) is not ported yet: callers build the result from
their own maps, or pass the JAX package's result, which has the same fields.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np


@dataclasses.dataclass
class RectificationResult:
    """Everything the per-frame pipeline needs, precomputed on host."""

    map_left: np.ndarray  # (H, W, 2) float32 source coords for the left eye
    map_right: np.ndarray
    Q: np.ndarray  # (4, 4) reprojection matrix
    roi: Tuple[int, int, int, int]  # ROI1 intersect ROI2 crop (main.cpp:80-85)
    image_size: Tuple[int, int]  # (width, height) after intrinsics override
    rectify: Any = None  # the stereoRectify outputs, where computed
