# Copy of rt_depth_map_tpu/calib/distortion.py; the port imports nothing of the JAX package.
"""Brown-Conrady + rational lens distortion model.

The reference's calibration files carry 14-element distortion vectors with the
rational-model k4..k6 terms populated (intrinsics.yml D1/D2; consumed by
OpenCV inside `initUndistortRectifyMap`, main.cpp:95-96). This module is the
from-scratch equivalent: forward distortion of normalized image coordinates
and the fixed-point iterative inverse (the `cv::undistortPoints` iteration).

Coefficient layout (OpenCV order, any length up to 14, missing = 0):
  [k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy]
Thin-prism s1..s4 are supported; tilted-sensor tau terms are not (always zero
in the reference data) and are rejected if nonzero.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _expand(dist: Optional[np.ndarray]) -> np.ndarray:
    k = np.zeros(14, dtype=np.float64)
    if dist is not None:
        d = np.asarray(dist, dtype=np.float64).ravel()
        if d.size not in (0, 4, 5, 8, 12, 14):
            raise ValueError(f"unsupported distortion vector length {d.size}")
        k[: d.size] = d
    if k[12] != 0.0 or k[13] != 0.0:
        raise NotImplementedError("tilted-sensor (tau) distortion unsupported")
    return k


def distort_normalized(
    x: np.ndarray, y: np.ndarray, dist: Optional[np.ndarray]
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply forward distortion to normalized camera coordinates."""
    k = _expand(dist)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = k[:12]
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    r2 = x * x + y * y
    kr = (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2) / (
        1.0 + ((k6 * r2 + k5) * r2 + k4) * r2
    )
    xy2 = 2.0 * x * y
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r2 * r2
    yd = y * kr + p1 * (r2 + 2.0 * y * y) + p2 * xy2 + s3 * r2 + s4 * r2 * r2
    return xd, yd


def undistort_normalized(
    xd: np.ndarray,
    yd: np.ndarray,
    dist: Optional[np.ndarray],
    iterations: int = 5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Invert the distortion on normalized coordinates.

    Same fixed-point iteration as `cv::undistortPoints` (5 iterations),
    so results match OpenCV to float64 round-off for in-range points.
    """
    k = _expand(dist)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = k[:12]
    x0 = np.asarray(xd, dtype=np.float64)
    y0 = np.asarray(yd, dtype=np.float64)
    x, y = x0.copy(), y0.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        icdist = (1.0 + ((k6 * r2 + k5) * r2 + k4) * r2) / (
            1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
        )
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r2 * r2
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r2 * r2
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return x, y


def distort_points(
    pts: np.ndarray, camera_matrix: np.ndarray, dist: Optional[np.ndarray]
) -> np.ndarray:
    """Project normalized (x, y) points to distorted pixel coordinates."""
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    K = np.asarray(camera_matrix, dtype=np.float64)
    xd, yd = distort_normalized(pts[:, 0], pts[:, 1], dist)
    u = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    v = K[1, 1] * yd + K[1, 2]
    return np.stack([u, v], axis=-1)


def undistort_points(
    pts: np.ndarray,
    camera_matrix: np.ndarray,
    dist: Optional[np.ndarray],
    R: Optional[np.ndarray] = None,
    P: Optional[np.ndarray] = None,
) -> np.ndarray:
    """`cv::undistortPoints` equivalent.

    Pixel points -> normalized, undistorted, optionally rotated by `R` and
    reprojected by `P` (3x3 or 3x4). Returns (N, 2).
    """
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    K = np.asarray(camera_matrix, dtype=np.float64)
    x = (pts[:, 0] - K[0, 2]) / K[0, 0]
    y = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x, y = undistort_normalized(x, y, dist)
    if R is not None:
        R = np.asarray(R, dtype=np.float64)
        xyw = np.stack([x, y, np.ones_like(x)], axis=0)
        xyw = R @ xyw
        x = xyw[0] / xyw[2]
        y = xyw[1] / xyw[2]
    if P is not None:
        P = np.asarray(P, dtype=np.float64)
        u = P[0, 0] * x + P[0, 1] * y + P[0, 2]
        v = P[1, 0] * x + P[1, 1] * y + P[1, 2]
        x, y = u, v
    return np.stack([x, y], axis=-1)
