# Copy of rt_depth_map_tpu/golden/postproc.py; the port imports nothing of the JAX package.
"""Golden implementations of the disparity validity post-passes.

cv::validateDisparity (left-right consistency via cost-based right-view
reconstruction) and cv::filterSpeckles (small connected components of
similar disparity invalidated). Oracled against cv2 in tests.
"""

from __future__ import annotations

import numpy as np

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT


def golden_validate_disparity(
    disp: np.ndarray,
    cost: np.ndarray,
    min_disparity: int,
    num_disparities: int,
    disp12_max_diff: int,
) -> np.ndarray:
    """Left-right consistency check, cv::validateDisparity semantics.

    disp: (H, W) int16, x16 fixed point (modified copy returned).
    cost: (H, W) int32 matching cost of the chosen disparity.
    For each row: project every left-pixel disparity into the right view
    keeping the min-cost candidate per right pixel, then invalidate left
    pixels whose disparity disagrees with the right-view winner by more than
    disp12_max_diff (in integer disparities).
    """
    disp = disp.copy()
    H, W = disp.shape
    minD = min_disparity
    maxD = min_disparity + num_disparities
    INVALID = (minD - 1) * DISP_SCALE
    thresh = disp12_max_diff * DISP_SCALE

    for y in range(H):
        disp2 = np.full(W, INVALID, dtype=np.int32)
        disp2cost = np.full(W, np.iinfo(np.int32).max, dtype=np.int64)
        drow = disp[y].astype(np.int32)
        crow = cost[y]
        for x in range(W):
            d = drow[x]
            if d == INVALID:
                continue
            d_int = (d + DISP_SCALE // 2) >> DISP_SHIFT
            x2 = x - d_int
            if 0 <= x2 < W and disp2cost[x2] > crow[x]:
                disp2cost[x2] = crow[x]
                disp2[x2] = d
        for x in range(W):
            d = drow[x]
            if d == INVALID:
                continue
            d_int = (d + DISP_SCALE // 2) >> DISP_SHIFT
            x2 = x - d_int
            if 0 <= x2 < W and abs(disp2[x2] - d) > thresh:
                disp[y, x] = INVALID
    return disp


def golden_filter_speckles(
    disp: np.ndarray,
    new_val: int,
    max_speckle_size: int,
    max_diff: int,
) -> np.ndarray:
    """cv::filterSpeckles semantics.

    4-connected components where adjacent pixels differ by <= max_diff (raw
    int16 units); components with <= max_speckle_size pixels are set to
    new_val. Pixels already equal to new_val are not part of any component.
    """
    disp = disp.copy()
    H, W = disp.shape
    labels = np.zeros((H, W), dtype=np.int32)
    cur_label = 0
    for y0 in range(H):
        for x0 in range(W):
            if labels[y0, x0] or disp[y0, x0] == new_val:
                continue
            cur_label += 1
            stack = [(y0, x0)]
            labels[y0, x0] = cur_label
            comp = []
            while stack:
                y, x = stack.pop()
                comp.append((y, x))
                v = disp[y, x]
                for yy, xx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                    if (
                        0 <= yy < H
                        and 0 <= xx < W
                        and not labels[yy, xx]
                        and disp[yy, xx] != new_val
                        and abs(int(disp[yy, xx]) - int(v)) <= max_diff
                    ):
                        labels[yy, xx] = cur_label
                        stack.append((yy, xx))
            if len(comp) <= max_speckle_size:
                for y, x in comp:
                    disp[y, x] = new_val
    return disp
