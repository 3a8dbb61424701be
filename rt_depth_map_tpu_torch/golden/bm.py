# Copy of rt_depth_map_tpu/golden/bm.py; the port imports nothing of the JAX package.
"""Golden numpy implementation of the Konolige SAD block matcher.

Pins down the exact cv::StereoBM behavior the reference configures at
main.cpp:130/bm-sw.cpp:16-25 (SURVEY.md section 2.9a): X-Sobel prefilter with
cap, windowed SAD cost, WTA with largest-disparity tie-break, texture and
uniqueness checks, x16 fixed-point packing with parabolic subpixel
refinement, cost-based left-right validation, speckle filtering, and the
valid-region / ROI geometry. Output is int16, invalid = (minDisparity-1)*16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from rt_depth_map_tpu_torch.golden.postproc import (
    golden_filter_speckles,
    golden_validate_disparity,
)

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT


def xsobel_prefilter_np(img: np.ndarray, cap: int) -> np.ndarray:
    x = img.astype(np.int32)
    H, W = x.shape
    up = np.concatenate([x[1:2], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[H - 2 : H - 1]], axis=0)

    def dx(row):
        left = np.concatenate([row[:, :1], row[:, :-1]], axis=1)
        right = np.concatenate([row[:, 1:], row[:, -1:]], axis=1)
        return right - left

    d = dx(up) + 2 * dx(x) + dx(down)
    out = np.clip(d, -cap, cap) + cap
    out[:, 0] = cap
    out[:, -1] = cap
    return out.astype(np.uint8)


def _box_sum(a: np.ndarray, w: int) -> np.ndarray:
    """Sliding-window sum of size (w, w), 'valid' region centered: out[y, x]
    = sum over a[y-w2:y+w2+1, x-w2:x+w2+1]; border rows/cols are garbage
    (never read by callers)."""
    w2 = w // 2
    c = np.cumsum(np.cumsum(a, axis=0, dtype=np.int64), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    H, W = a.shape
    out = np.zeros((H, W), dtype=np.int64)
    ys = np.arange(w2, H - w2)
    xs = np.arange(w2, W - w2)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    out[yy, xx] = (
        c[yy + w2 + 1, xx + w2 + 1]
        - c[yy - w2, xx + w2 + 1]
        - c[yy + w2 + 1, xx - w2]
        + c[yy - w2, xx - w2]
    )
    return out


@dataclasses.dataclass
class BMDebug:
    cost: np.ndarray  # (H, W, D) windowed SAD, valid region only
    best_cost: np.ndarray  # (H, W) min SAD (pre-refinement)
    texture: np.ndarray  # (H, W) texture sum


def golden_stereo_bm(
    left: np.ndarray,
    right: np.ndarray,
    num_disparities: int,
    block_size: int = 13,
    min_disparity: int = 0,
    pre_filter_cap: int = 31,
    texture_threshold: int = 10,
    uniqueness_ratio: int = 10,
    speckle_window_size: int = 100,
    speckle_range: int = 32,
    disp12_max_diff: int = 1,
    roi1: Optional[Tuple[int, int, int, int]] = None,
    roi2: Optional[Tuple[int, int, int, int]] = None,
    return_debug: bool = False,
):
    """Full StereoBM-parity matcher. Returns int16 (H, W) disparity x16."""
    assert left.shape == right.shape and left.dtype == np.uint8
    H, W = left.shape
    D = num_disparities
    minD = min_disparity
    w2 = block_size // 2
    INVALID = (minD - 1) * DISP_SCALE

    lp = xsobel_prefilter_np(left, pre_filter_cap).astype(np.int32)
    rp = xsobel_prefilter_np(right, pre_filter_cap).astype(np.int32)

    # Windowed SAD cost volume over true disparity minD + i, i in [0, D).
    cost = np.full((H, W, D), np.iinfo(np.int32).max // 4, dtype=np.int64)
    for i in range(D):
        d = minD + i
        if d >= 0:
            ad = np.abs(lp[:, d:] - rp[:, : W - d]) if d else np.abs(lp - rp)
            ad_full = np.zeros((H, W), dtype=np.int64)
            ad_full[:, d:] = ad
        else:
            ad_full = np.zeros((H, W), dtype=np.int64)
            ad_full[:, : W + d] = np.abs(lp[:, : W + d] - rp[:, -d:])
        cost[:, :, i] = _box_sum(ad_full, block_size)

    # Valid geometry (empirically matched to cv2.StereoBM):
    #   y in [w2, H - w2), x in [max(maxD, 0) + w2, W - w2)
    maxD = minD + D - 1
    x_lo = max(maxD, 0) + w2
    x_hi = W - w2
    y_lo, y_hi = w2, H - w2
    valid = np.zeros((H, W), dtype=bool)
    valid[y_lo:y_hi, x_lo:x_hi] = True

    # ROI restriction (cv::getValidDisparityROI semantics). An unset/empty
    # ROI behaves as the full image rect (verified empirically vs cv2), so
    # the reference's ROI1-only setting (estimator.cpp:54-55, the /*FIXME*/
    # leaves ROI2 unset) still restricts matching to the detected region.
    if roi1 is not None or roi2 is not None:
        def norm(r):
            if r is None or r[2] * r[3] <= 0:
                return (0, 0, W, H)
            return r

        r1x, r1y, r1w, r1h = norm(roi1)
        r2x, r2y, r2w, r2h = norm(roi2)
        if (r1w * r1h, r2w * r2h) != (W * H, W * H):
            rxmin = max(r1x, r2x + maxD) + w2
            rxmax = min(r1x + r1w, r2x + r2w) - w2
            rymin = max(r1y, r2y) + w2
            rymax = min(r1y + r1h, r2y + r2h) - w2
            roi_mask = np.zeros((H, W), dtype=bool)
            if rxmax > rxmin and rymax > rymin:
                roi_mask[rymin:rymax, rxmin:rxmax] = True
            valid &= roi_mask

    # WTA: ties choose the LARGEST disparity (cv2 iterates d descending
    # with strict improvement).
    rev = cost[:, :, ::-1]
    mind_rev = np.argmin(rev, axis=2)
    best_i = D - 1 - mind_rev
    best_cost = np.take_along_axis(cost, best_i[..., None], axis=2)[..., 0]

    # Texture check: window sum of |prefiltered_left - cap|.
    texture = _box_sum(np.abs(lp - pre_filter_cap).astype(np.int64), block_size)
    tex_ok = texture >= texture_threshold

    # Uniqueness: reject if any d outside best +/- 1 has
    # cost <= minsad + minsad*ratio/100 (integer division).
    thresh = best_cost + (best_cost * uniqueness_ratio) // 100
    di = np.arange(D)
    outside = np.abs(di[None, None, :] - best_i[..., None]) > 1
    uniq_bad = np.any(outside & (cost <= thresh[..., None]), axis=2)

    # Subpixel refinement + x16 packing.
    ip = np.clip(best_i + 1, 0, D - 1)
    im = np.clip(best_i - 1, 0, D - 1)
    # border reflection: cost[-1] := cost[1], cost[D] := cost[D-2]
    c_p1 = np.take_along_axis(cost, ip[..., None], axis=2)[..., 0]
    c_m1 = np.take_along_axis(cost, im[..., None], axis=2)[..., 0]
    c_m1 = np.where(best_i == 0, c_p1, c_m1)
    c_p1 = np.where(best_i == D - 1, c_m1, c_p1)
    # In cv2's reversed iteration: p = cost(d_true - 1), n = cost(d_true + 1)
    p = c_m1
    n = c_p1
    denom = p + n - 2 * best_cost + np.abs(p - n)
    num = (p - n) * 256
    # C integer division truncates toward zero
    delta = np.where(
        denom != 0,
        np.sign(num) * (np.abs(num) // np.maximum(denom, 1)),
        0,
    ).astype(np.int64)
    d_true = best_i + minD
    packed = ((d_true * 256 + delta + 15) >> 4).astype(np.int16)

    disp = np.where(valid & tex_ok & ~uniq_bad, packed, INVALID).astype(np.int16)

    if disp12_max_diff >= 0:
        disp = golden_validate_disparity(
            disp, best_cost.astype(np.int32), minD, D, disp12_max_diff
        )
    if speckle_window_size > 0 and speckle_range >= 0:
        disp = golden_filter_speckles(
            disp, INVALID, speckle_window_size, speckle_range * DISP_SCALE
        )

    if return_debug:
        return disp, BMDebug(
            cost=cost, best_cost=best_cost.astype(np.int64), texture=texture
        )
    return disp
