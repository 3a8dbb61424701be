# Copy of rt_depth_map_tpu/metrics.py; the port imports nothing of the JAX package.
"""Disparity quality metrics -- the judged accuracy numbers (BASELINE.md).

bad_pixel_fraction is the standard stereo benchmark metric: the fraction of
pixels, among those valid in both maps, whose disparity differs by more than
a threshold (default 1 px = 16 sixteenths).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

DISP_SCALE = 16


def bad_pixel_fraction(
    disp: np.ndarray,
    ref: np.ndarray,
    invalid: int = -DISP_SCALE,
    threshold_px: float = 1.0,
) -> float:
    both = (disp != invalid) & (ref != invalid)
    if both.sum() == 0:
        return 0.0
    bad = np.abs(disp.astype(np.int64) - ref.astype(np.int64)) > (
        threshold_px * DISP_SCALE
    )
    return float((bad & both).sum() / both.sum())


def validity_difference(
    disp: np.ndarray, ref: np.ndarray, invalid: int = -DISP_SCALE
) -> float:
    """Fraction of pixels whose valid/invalid status disagrees."""
    return float(((disp != invalid) != (ref != invalid)).mean())


def disparity_report(
    disp: np.ndarray,
    ref: np.ndarray,
    invalid: int = -DISP_SCALE,
) -> Dict[str, float]:
    both = (disp != invalid) & (ref != invalid)
    err = np.abs(disp.astype(np.float64) - ref.astype(np.float64))[both] / DISP_SCALE
    return {
        "bad_pixel_fraction": bad_pixel_fraction(disp, ref, invalid),
        "validity_difference": validity_difference(disp, ref, invalid),
        "valid_fraction": float((disp != invalid).mean()),
        "mean_abs_err_px": float(err.mean()) if err.size else 0.0,
    }
