"""The engine's constants, carried from numpy onto the port's device.

The system has no learned weights: its parameters are the constants an
Engine derives once, namely the rectification maps cropped to the ROI, the
morphology footprint, the reprojection matrix Q and the HSV thresholds.
`engine_state_from_numpy` turns the numpy attributes of an engine (the JAX
package's `Engine` has the same ones, `pipeline/engine.py:135-163`) into the
port's device state: the remap maps quantized to integer tables, the ellipse
as row segments, Q as float32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from rt_depth_map_tpu.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.morphology import ellipse_kernel, row_segments
from rt_depth_map_tpu_torch.ops.remap import RemapTable, remap_table

MORPH_DX = MORPH_DY = 10  # reference mf-sw.h:11-12 structuring element


@dataclasses.dataclass
class EngineState:
    left: RemapTable  # ROI-cropped left map over the full source frame
    right: RemapTable
    morph_segments: List[Tuple[int, int, int]]
    Q: torch.Tensor  # (4, 4) float32
    hsv_low: torch.Tensor  # (3,) uint8
    hsv_high: torch.Tensor  # (3,) uint8
    matcher: MatcherConfig
    min_object_size: int
    roi: Tuple[int, int, int, int]


def engine_state_from_numpy(map_left: np.ndarray, map_right: np.ndarray,
                            roi, Q: np.ndarray, hsv_low, hsv_high,
                            matcher_config: MatcherConfig,
                            min_object_size: int, device) -> EngineState:
    """Device state from an engine's numpy constants.

    map_left/map_right: full-frame (H, W, 2) float32 source coordinates;
    roi: (x, y, w, h) crop of the rectified view."""
    rx, ry, rw, rh = (int(v) for v in roi)
    src_hw = map_left.shape[:2]
    left = remap_table(map_left[ry: ry + rh, rx: rx + rw], src_hw, device)
    right = remap_table(map_right[ry: ry + rh, rx: rx + rw], src_hw, device)
    return EngineState(
        left=left,
        right=right,
        morph_segments=row_segments(ellipse_kernel(MORPH_DX, MORPH_DY)),
        Q=torch.as_tensor(np.asarray(Q, np.float32), device=device),
        hsv_low=torch.as_tensor(np.asarray(hsv_low, np.uint8), device=device),
        hsv_high=torch.as_tensor(np.asarray(hsv_high, np.uint8), device=device),
        matcher=matcher_config,
        min_object_size=int(min_object_size),
        roi=(rx, ry, rw, rh),
    )
