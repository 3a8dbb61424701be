"""Konolige SAD block matcher (cv::StereoBM parity).

Port of `rt_depth_map_tpu/ops/bm.py` `stereo_bm` at any min_disparity, at
strict shapes (GPU kernels need no pad-to-kernel-grid route). The cost and
winner search run in K8 (`ops/cuda/bm_kernel.py`), which takes minD and
returns disparity indices; the texture check,
uniqueness test, subpixel step and the per-frame ROI mask are elementwise
torch, with the ROI scalars left on the device; the left-right check is one launch of
K6's BM entry (`ops/cuda/lr_resolve.py`), and the speckle filter runs on K2,
K7 with its size decision, and one apply launch (`ops/speckle.py`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import (
    bm_cost_wta,
    bm_cost_wta_plain,
    box_sum_2d,
)
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve_bm, lr_resolve_bm_plain
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
from rt_depth_map_tpu_torch.ops.speckle import filter_speckles

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT


def lr_check(disp: torch.Tensor, cost: torch.Tensor, num_disp: int,
             max_diff: int, min_disp: int = 0, plain: bool = False) -> torch.Tensor:
    """cv::validateDisparity parity (ops/bm.py _lr_check) on K6's BM entry:
    `lr_resolve_bm_plain`."""
    return (lr_resolve_bm_plain if plain else lr_resolve_bm)(disp, cost, num_disp,
                                                             max_diff, min_disp)


def stereo_bm(left: torch.Tensor, right: torch.Tensor, cfg: MatcherConfig,
              roi1: Optional[Tuple] = None, roi2: Optional[Tuple] = None,
              plain: bool = False,
              mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """int16 x16 disparity of (H, W) uint8 rectified gray planes.

    roi1/roi2: optional (x, y, w, h), ints or 0-d device tensors; an empty
    ROI means the full frame. plain=True runs the kernels' plain versions;
    mark(name), when given, is called after each stage."""
    mark = mark or (lambda name: None)
    H, W = left.shape
    D = cfg.num_disparities
    minD = cfg.min_disparity
    bs = cfg.block_size
    w2 = bs // 2
    maxD = minD + D - 1
    invalid = (minD - 1) * DISP_SCALE
    dev = left.device

    lp = xsobel_prefilter(left, cfg.pre_filter_cap)
    rp = xsobel_prefilter(right, cfg.pre_filter_cap)
    wta = bm_cost_wta_plain if plain else bm_cost_wta
    best_d, best_cost, c_m1, c_p1, min_out = wta(lp, rp, D, bs, minD)

    ys = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    valid = ((ys >= w2) & (ys < H - w2) & (xs >= max(maxD, 0) + w2)
             & (xs < W - w2))

    if roi1 is not None or roi2 is not None:
        def norm(r):
            r = (0, 0, W, H) if r is None else r
            # a Python int becomes a device fill, not an upload (which
            # would make the host wait for the device)
            r = [v.to(torch.int32) if isinstance(v, torch.Tensor)
                 else torch.full((), v, dtype=torch.int32, device=dev) for v in r]
            nonempty = r[2] * r[3] > 0
            return [torch.where(nonempty, v, f) for v, f in zip(r, (0, 0, W, H))]

        r1x, r1y, r1w, r1h = norm(roi1)
        r2x, r2y, r2w, r2h = norm(roi2)
        # the unclamped maxD, as the reference
        rxmin = torch.maximum(r1x, r2x + maxD) + w2
        rxmax = torch.minimum(r1x + r1w, r2x + r2w) - w2
        rymin = torch.maximum(r1y, r2y) + w2
        rymax = torch.minimum(r1y + r1h, r2y + r2h) - w2
        valid = valid & (xs >= rxmin) & (xs < rxmax) & (ys >= rymin) & (ys < rymax)

    texture = box_sum_2d((lp.to(torch.int32) - cfg.pre_filter_cap).abs(), bs)
    tex_ok = texture >= cfg.texture_threshold

    thresh = best_cost + (best_cost * cfg.uniqueness_ratio) // 100
    uniq_bad = min_out <= thresh

    c_m1 = torch.where(best_d == 0, c_p1, c_m1)
    c_p1 = torch.where(best_d == D - 1, c_m1, c_p1)
    p, n = c_m1, c_p1
    denom = p + n - 2 * best_cost + (p - n).abs()
    num = (p - n) * 256
    # sign(num) * (|num| // denom): truncation toward zero, as the reference
    delta = torch.where(
        denom != 0,
        torch.sign(num) * torch.div(num.abs(), denom.clamp(min=1),
                                    rounding_mode="floor"),
        0)
    # ((best_d + minD) * 256 + delta + 15) >> 4, minD folded into the constant
    packed = (best_d * 256 + delta + (minD * 256 + 15)) >> 4
    disp = torch.where(valid & tex_ok & ~uniq_bad, packed, invalid).to(torch.int16)
    mark("BM prefilter, K8, texture, uniqueness, subpixel")

    if cfg.disp12_max_diff >= 0:
        disp = lr_check(disp, best_cost, D, cfg.disp12_max_diff, minD, plain=plain)
    mark("LR check (K6)")
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(disp, invalid, cfg.speckle_window_size,
                               cfg.speckle_range * DISP_SCALE, plain=plain)
    mark("speckle (K2 + K7 + K2 + apply)")
    return disp
