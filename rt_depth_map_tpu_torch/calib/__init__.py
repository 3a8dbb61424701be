# Copy of rt_depth_map_tpu/calib/__init__.py; the port imports nothing of the JAX package.
"""Calibration subsystem: OpenCV-FileStorage YAML I/O, distortion model,
stereo rectification (Bouguet), and remap-grid precomputation.

Re-creates the reference's one-time host precompute
`get_rectified_remap_matrices()` (main.cpp:53-98) without an OpenCV
dependency: loads M1/D1/M2/D2 + R/T + ROIs, computes R1/R2/P1/P2/Q via
`stereo_rectify` and float32 remap grids via `init_undistort_rectify_map`.
"""

from rt_depth_map_tpu_torch.calib.fs_yaml import read_filestorage, write_filestorage  # noqa: F401
from rt_depth_map_tpu_torch.calib.distortion import distort_points, undistort_points  # noqa: F401
from rt_depth_map_tpu_torch.calib.rectify import (  # noqa: F401
    StereoCalibration,
    RectificationResult,
    load_stereo_calibration,
    stereo_rectify,
    init_undistort_rectify_map,
    compute_rectification,
)
