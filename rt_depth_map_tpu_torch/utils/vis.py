# Copy of rt_depth_map_tpu/utils/vis.py; the port imports nothing of the JAX package.
"""Frame visualizations (the headless stand-in for the reference's imshow
windows, estimator.cpp:71-81).

disparity_vis reproduces cv::ximgproc::getDisparityVis semantics:
vis = saturate_cast<uchar>(disp * scale / 16).
"""

from __future__ import annotations

import numpy as np


def disparity_vis(disp16: np.ndarray, scale: float = 1.0) -> np.ndarray:
    v = disp16.astype(np.float32) * scale / 16.0
    return np.clip(np.round(v), 0, 255).astype(np.uint8)


def draw_depth_overlay(result) -> np.ndarray:
    """Rectified RGB with white object boxes (rectangle() parity,
    estimator.cpp:248-249); labels are returned by FrameResult.labels()."""
    img = result.rgb_rect.copy()
    H, W = img.shape[:2]
    for box, cm in zip(result.boxes, result.depth_cm):
        x, y, w, h, valid = (int(b) for b in box)
        if not valid or not np.isfinite(cm):
            continue
        x2, y2 = min(x + w, W - 1), min(y + h, H - 1)
        img[y, x:x2] = 255
        img[y2, x:x2] = 255
        img[y:y2, x] = 255
        img[y:y2, x2] = 255
    return img


def save_frame_visualization(path: str, result) -> None:
    """Side-by-side depth overlay | disparity visualization, as PNG."""
    import cv2

    overlay = draw_depth_overlay(result)
    disp = disparity_vis(result.disparity)
    disp_rgb = np.stack([disp] * 3, axis=-1)
    combo = np.concatenate([overlay, disp_rgb], axis=1)
    cv2.imwrite(path, combo[..., ::-1])
