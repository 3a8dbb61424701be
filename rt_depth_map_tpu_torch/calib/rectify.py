# Copy of rt_depth_map_tpu/calib/rectify.py; the port imports nothing of the JAX package.
"""Stereo rectification (Bouguet) and undistort-rectify map precomputation.

From-scratch re-creation of the OpenCV calls the reference makes once at
startup (`get_rectified_remap_matrices`, main.cpp:53-98):

  * `stereo_rectify`  == cv::stereoRectify(..., CALIB_ZERO_DISPARITY, -1, ...)
  * `init_undistort_rectify_map` == cv::initUndistortRectifyMap (float maps,
    plus optional CV_16SC2-style 1/32-pixel fixed-point quantization so the
    bilinear remap matches OpenCV's fixed-point remap numerics)
  * `compute_rectification` == the whole main.cpp:53-98 flow including the
    ROI1 intersect ROI2 crop (main.cpp:80-85) and the intrinsics-file
    resolution override (main.cpp:87-90).

Validated against cv2.stereoRectify / cv2.initUndistortRectifyMap and the
stored R1/R2/P1/P2/Q oracles in the reference's extrinsics.yml files
(tests/test_calib.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from rt_depth_map_tpu_torch.calib.distortion import (
    distort_normalized,
    undistort_normalized,
)
from rt_depth_map_tpu_torch.calib.fs_yaml import read_filestorage


# ---------------------------------------------------------------------------
# Rotations
# ---------------------------------------------------------------------------


def rodrigues_to_matrix(rvec: np.ndarray) -> np.ndarray:
    """Rotation vector -> rotation matrix (Rodrigues)."""
    r = np.asarray(rvec, dtype=np.float64).ravel()
    theta = float(np.linalg.norm(r))
    if theta < 1e-30:
        return np.eye(3)
    k = r / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def matrix_to_rodrigues(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> rotation vector (Rodrigues)."""
    R = np.asarray(R, dtype=np.float64)
    cos_t = max(-1.0, min(1.0, (np.trace(R) - 1.0) * 0.5))
    theta = float(np.arccos(cos_t))
    if theta < 1e-12:
        return np.zeros(3)
    if abs(theta - np.pi) < 1e-7:
        # theta ~= pi: axis from R + I diagonal
        A = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs from off-diagonals
        if axis[0] > 0:
            axis[1] = np.copysign(axis[1], A[0, 1])
            axis[2] = np.copysign(axis[2], A[0, 2])
        elif axis[1] > 0:
            axis[2] = np.copysign(axis[2], A[1, 2])
        axis /= max(np.linalg.norm(axis), 1e-30)
        return axis * theta
    v = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], dtype=np.float64
    )
    return v * (theta / (2.0 * np.sin(theta)))


# ---------------------------------------------------------------------------
# stereoRectify
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RectifyOutputs:
    R1: np.ndarray
    R2: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    Q: np.ndarray
    roi1: Tuple[int, int, int, int]
    roi2: Tuple[int, int, int, int]


def _camera_principal_shift(
    K: np.ndarray,
    dist: Optional[np.ndarray],
    R_rect: np.ndarray,
    fc_new: float,
    image_size: Tuple[int, int],
) -> Tuple[float, float]:
    """New principal point so the rectified view stays centered.

    Mirrors OpenCV: undistort the 4 image corners, rotate into the rectified
    frame, project with f=fc_new / c=0, and recenter their mean on the image
    center.
    """
    nx, ny = image_size
    corners = np.array(
        [[0.0, 0.0], [nx - 1.0, 0.0], [0.0, ny - 1.0], [nx - 1.0, ny - 1.0]]
    )
    x = (corners[:, 0] - K[0, 2]) / K[0, 0]
    y = (corners[:, 1] - K[1, 2]) / K[1, 1]
    x, y = undistort_normalized(x, y, dist)
    xyw = R_rect @ np.stack([x, y, np.ones_like(x)], axis=0)
    u = fc_new * xyw[0] / xyw[2]
    v = fc_new * xyw[1] / xyw[2]
    cx = (nx - 1) * 0.5 - float(np.mean(u))
    cy = (ny - 1) * 0.5 - float(np.mean(v))
    return cx, cy


def _inner_rectangle(
    K: np.ndarray,
    dist: Optional[np.ndarray],
    R_rect: np.ndarray,
    P_new: np.ndarray,
    image_size: Tuple[int, int],
    grid: int = 9,
) -> Tuple[float, float, float, float]:
    """Largest axis-aligned rectangle of valid (source-visible) pixels.

    OpenCV `icvGetRectangles` inner-rectangle logic on a grid x grid border
    sampling of the source image mapped through the rectification.
    """
    nx, ny = image_size
    us = np.linspace(0, nx - 1, grid)
    vs = np.linspace(0, ny - 1, grid)
    uu, vv = np.meshgrid(us, vs)
    x = (uu.ravel() - K[0, 2]) / K[0, 0]
    y = (vv.ravel() - K[1, 2]) / K[1, 1]
    x, y = undistort_normalized(x, y, dist)
    xyw = R_rect @ np.stack([x, y, np.ones_like(x)], axis=0)
    xn = xyw[0] / xyw[2]
    yn = xyw[1] / xyw[2]
    up = P_new[0, 0] * xn + P_new[0, 2]
    vp = P_new[1, 1] * yn + P_new[1, 2]
    up = up.reshape(grid, grid)
    vp = vp.reshape(grid, grid)
    ix0 = float(np.max(up[:, 0]))
    ix1 = float(np.min(up[:, -1]))
    iy0 = float(np.max(vp[0, :]))
    iy1 = float(np.min(vp[-1, :]))
    return ix0, iy0, ix1 - ix0, iy1 - iy0


def stereo_rectify(
    K1: np.ndarray,
    D1: Optional[np.ndarray],
    K2: np.ndarray,
    D2: Optional[np.ndarray],
    image_size: Tuple[int, int],
    R: np.ndarray,
    T: np.ndarray,
    zero_disparity: bool = True,
    alpha: float = -1.0,
    new_image_size: Optional[Tuple[int, int]] = None,
) -> RectifyOutputs:
    """Bouguet stereo rectification, cv::stereoRectify semantics.

    `image_size` is (width, height). Only alpha < 0 (the reference's setting,
    main.cpp:92) and alpha in [0, 1] without new_image_size scaling refinement
    are supported.
    """
    K1 = np.asarray(K1, dtype=np.float64)
    K2 = np.asarray(K2, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64).ravel()
    nx, ny = image_size
    new_size = new_image_size or image_size

    # Split the relative rotation evenly between the two cameras.
    om = matrix_to_rodrigues(R)
    r_r = rodrigues_to_matrix(-0.5 * om)
    t = r_r @ T

    # Choose the baseline axis (horizontal vs vertical stereo).
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = float(np.linalg.norm(t))
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0

    # Rotation that aligns the baseline with the chosen axis.
    ww = np.cross(t, uu)
    nw = float(np.linalg.norm(ww))
    if nw > 0.0:
        ww *= np.arccos(abs(c) / nt) / nw
    wR = rodrigues_to_matrix(ww)

    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    # New common focal length. (OpenCV <= 3.x shrank fc for strong barrel
    # distortion via a dk1 term; modern OpenCV -- our test oracle -- does
    # not, which is why the 2017-era stored P matrices in the reference's
    # extrinsics.yml have a smaller focal than a fresh stereoRectify run.)
    fc_new = min(K1[idx ^ 1, idx ^ 1], K2[idx ^ 1, idx ^ 1])

    ratio_x = new_size[0] / nx / 2.0
    ratio_y = new_size[1] / ny / 2.0
    ratio = ratio_x if idx == 1 else ratio_y
    fc_new = fc_new * (ratio * 2.0)

    cc1 = _camera_principal_shift(K1, D1, R1, fc_new, new_size)
    cc2 = _camera_principal_shift(K2, D2, R2, fc_new, new_size)
    if zero_disparity:
        cc1 = cc2 = ((cc1[0] + cc2[0]) * 0.5, (cc1[1] + cc2[1]) * 0.5)
    elif idx == 0:
        cy = (cc1[1] + cc2[1]) * 0.5
        cc1, cc2 = (cc1[0], cy), (cc2[0], cy)
    else:
        cx = (cc1[0] + cc2[0]) * 0.5
        cc1, cc2 = (cx, cc1[1]), (cx, cc2[1])

    P1 = np.array(
        [[fc_new, 0, cc1[0], 0], [0, fc_new, cc1[1], 0], [0, 0, 1, 0]],
        dtype=np.float64,
    )
    P2 = np.array(
        [[fc_new, 0, cc2[0], 0], [0, fc_new, cc2[1], 0], [0, 0, 1, 0]],
        dtype=np.float64,
    )
    P2[idx, 3] = t[idx] * fc_new

    Q = np.array(
        [
            [1, 0, 0, -cc1[0]],
            [0, 1, 0, -cc1[1]],
            [0, 0, 0, fc_new],
            [0, 0, -1.0 / t[idx], (cc1[idx] - cc2[idx]) / t[idx]],
        ],
        dtype=np.float64,
    )

    def clip_roi(r):
        x0, y0, w, h = r
        x0i = max(0, int(np.ceil(x0)))
        y0i = max(0, int(np.ceil(y0)))
        x1i = min(new_size[0], x0i + int(np.floor(w)))
        y1i = min(new_size[1], y0i + int(np.floor(h)))
        return (x0i, y0i, max(0, x1i - x0i), max(0, y1i - y0i))

    if alpha < 0:
        # Modern cv::stereoRectify reports the full image as valid when no
        # free-scaling parameter is given (the reference's alpha=-1 path;
        # it takes its working ROI from the calibration files instead,
        # main.cpp:75-85).
        roi1 = roi2 = (0, 0, new_size[0], new_size[1])
    else:
        roi1 = clip_roi(_inner_rectangle(K1, D1, R1, P1, image_size))
        roi2 = clip_roi(_inner_rectangle(K2, D2, R2, P2, image_size))
    return RectifyOutputs(R1=R1, R2=R2, P1=P1, P2=P2, Q=Q, roi1=roi1, roi2=roi2)


# ---------------------------------------------------------------------------
# initUndistortRectifyMap
# ---------------------------------------------------------------------------


def init_undistort_rectify_map(
    K: np.ndarray,
    dist: Optional[np.ndarray],
    R_rect: Optional[np.ndarray],
    P_new: np.ndarray,
    size: Tuple[int, int],
    fixed_point: bool = True,
) -> np.ndarray:
    """Compute the (H, W, 2) float32 source-coordinate grid for rectification.

    For each destination pixel: lift through P_new^{-1}, rotate by
    R_rect^{-1}, re-distort, and project through the original K -- exactly
    cv::initUndistortRectifyMap. With `fixed_point=True` the coordinates are
    quantized to 1/32 px, matching the reference's CV_16SC2 maps
    (main.cpp:95-96) and OpenCV's 5-bit fixed-point bilinear remap.
    """
    K = np.asarray(K, dtype=np.float64)
    P = np.asarray(P_new, dtype=np.float64)[:3, :3]
    Rr = np.eye(3) if R_rect is None else np.asarray(R_rect, dtype=np.float64)
    iR = np.linalg.inv(P @ Rr)
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x = X / W
    y = Y / W
    xd, yd = distort_normalized(x, y, dist)
    map_x = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    if fixed_point:
        map_x = np.round(map_x * 32.0) / 32.0
        map_y = np.round(map_y * 32.0) / 32.0
    return np.stack([map_x, map_y], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# High-level: the main.cpp:53-98 flow
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StereoCalibration:
    """Parsed intrinsics.yml + extrinsics.yml contents."""

    M1: np.ndarray
    D1: np.ndarray
    M2: np.ndarray
    D2: np.ndarray
    R: np.ndarray
    T: np.ndarray
    width: int
    height: int
    roi1: Optional[Tuple[int, int, int, int]] = None
    roi2: Optional[Tuple[int, int, int, int]] = None
    # Stored rectification (oracle data; recomputed rather than trusted,
    # like the reference which only reads ROI/R/T back -- main.cpp:69-78):
    stored: Optional[dict] = None


def load_stereo_calibration(
    intrinsics_file: str, extrinsics_file: str
) -> StereoCalibration:
    intr = read_filestorage(intrinsics_file)
    extr = read_filestorage(extrinsics_file)
    roi1 = extr.get("ROI1")
    roi2 = extr.get("ROI2")
    return StereoCalibration(
        M1=intr["M1"],
        D1=intr.get("D1"),
        M2=intr["M2"],
        D2=intr.get("D2"),
        R=extr["R"],
        T=extr["T"],
        width=int(intr.get("Width", 0)),
        height=int(intr.get("Height", 0)),
        roi1=tuple(int(v) for v in roi1) if roi1 is not None else None,
        roi2=tuple(int(v) for v in roi2) if roi2 is not None else None,
        stored={
            k: extr[k] for k in ("R1", "R2", "P1", "P2", "Q") if k in extr
        },
    )


@dataclasses.dataclass
class RectificationResult:
    """Everything the per-frame pipeline needs, precomputed on host."""

    map_left: np.ndarray  # (H, W, 2) float32 source coords for the left eye
    map_right: np.ndarray
    Q: np.ndarray  # (4, 4) reprojection matrix
    roi: Tuple[int, int, int, int]  # ROI1 intersect ROI2 crop (main.cpp:80-85)
    image_size: Tuple[int, int]  # (width, height) after intrinsics override
    #: the stereoRectify outputs; None for maps that a caller built itself
    rectify: Optional[RectifyOutputs] = None


def compute_rectification(
    intrinsics_file: str,
    extrinsics_file: str,
    image_size: Tuple[int, int],
) -> RectificationResult:
    """The full `get_rectified_remap_matrices` flow (main.cpp:53-98)."""
    cal = load_stereo_calibration(intrinsics_file, extrinsics_file)

    # ROI = ROI1 intersect ROI2 from the files (main.cpp:80-85). Note the
    # reference intersects origins but min()s the *sizes*, not the
    # bottom-right corners -- reproduced faithfully.
    if cal.roi1 and cal.roi2:
        x = max(cal.roi1[0], cal.roi2[0])
        y = max(cal.roi1[1], cal.roi2[1])
        w = min(cal.roi1[2], cal.roi2[2])
        h = min(cal.roi1[3], cal.roi2[3])
        roi = (x, y, w, h)
    else:
        roi = (0, 0, image_size[0], image_size[1])

    # Intrinsics-file resolution override (main.cpp:87-90).
    if cal.width * cal.height != 0:
        image_size = (cal.width, cal.height)

    rect = stereo_rectify(
        cal.M1, cal.D1, cal.M2, cal.D2, image_size, cal.R, cal.T,
        zero_disparity=True, alpha=-1.0,
    )
    map_left = init_undistort_rectify_map(
        cal.M1, cal.D1, rect.R1, rect.P1, image_size
    )
    map_right = init_undistort_rectify_map(
        cal.M2, cal.D2, rect.R2, rect.P2, image_size
    )
    return RectificationResult(
        map_left=map_left,
        map_right=map_right,
        Q=rect.Q,
        roi=roi,
        image_size=image_size,
        rectify=rect,
    )
