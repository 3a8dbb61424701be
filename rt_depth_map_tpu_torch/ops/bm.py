"""Konolige SAD block matcher (cv::StereoBM parity).

Port of `rt_depth_map_tpu/ops/bm.py` `stereo_bm` for min_disparity = 0 at
strict shapes (GPU kernels need no pad-to-kernel-grid route). The cost and
winner search run in K8 (`ops/cuda/bm_kernel.py`); the texture check,
uniqueness test, subpixel step and the per-frame ROI mask are elementwise
torch, with the ROI scalars left on the device; the left-right check resolves
through K6 (`ops/cuda/lr_resolve.py`). The speckle filter is not ported yet:
a config that enables it is refused.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rt_depth_map_tpu.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import (
    bm_cost_wta,
    bm_cost_wta_plain,
    box_sum_2d,
)
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve, lr_resolve_plain
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
LR_DPOW = 1 << 13
LR_OFF = 1 << 11


def lr_key_planes(disp: torch.Tensor, cost: torch.Tensor):
    """(d32, in_range, d_int, key) of the LR check: the x16 disparity as
    int32, where its match x - round(d) lies in the image, the rounded
    disparity, and the packed (cost, d) key (2^31-1 outside in_range)."""
    W = disp.shape[1]
    d32 = disp.to(torch.int32)
    d_int = (d32 + DISP_SCALE // 2) >> DISP_SHIFT
    x2 = torch.arange(W, dtype=torch.int32, device=disp.device) - d_int
    in_range = (d32 != -DISP_SCALE) & (x2 >= 0) & (x2 < W)
    key = torch.where(in_range, cost * LR_DPOW + (d32 + LR_OFF), 2**31 - 1)
    return d32, in_range, d_int, key.to(torch.int32)


def lr_check(disp: torch.Tensor, cost: torch.Tensor, num_disp: int,
             max_diff: int, plain: bool = False) -> torch.Tensor:
    """cv::validateDisparity parity (ops/bm.py _lr_check, min_disparity 0):
    pixels whose right-view match disagrees by more than max_diff become
    invalid; projections outside the image are left untouched."""
    invalid = -DISP_SCALE
    d32, in_range, d_int, key = lr_key_planes(disp, cost)
    fn = lr_resolve_plain if plain else lr_resolve
    (rb,) = fn(d_int, key, (d_int,), n_w=num_disp + 1, r_lo=0,
               n_r=num_disp + 1, Dpow=LR_DPOW, c0=-LR_OFF, invalid=invalid)
    disp2_at = torch.where(in_range, rb, invalid)
    bad = in_range & ((disp2_at - d32).abs() > max_diff * DISP_SCALE)
    return torch.where(bad, torch.full_like(disp, invalid), disp)


def _check_config(cfg: MatcherConfig) -> None:
    if cfg.min_disparity != 0:
        raise NotImplementedError("the port's BM supports min_disparity 0 only")
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        raise NotImplementedError(
            "the speckle filter is not ported yet: set speckle_window_size=0")


def stereo_bm(left: torch.Tensor, right: torch.Tensor, cfg: MatcherConfig,
              roi1: Optional[Tuple] = None, roi2: Optional[Tuple] = None,
              plain: bool = False) -> torch.Tensor:
    """int16 x16 disparity of (H, W) uint8 rectified gray planes.

    roi1/roi2: optional (x, y, w, h), ints or 0-d device tensors; an empty
    ROI means the full frame. plain=True runs the kernels' plain versions."""
    _check_config(cfg)
    H, W = left.shape
    D = cfg.num_disparities
    bs = cfg.block_size
    w2 = bs // 2
    maxD = D - 1
    invalid = -DISP_SCALE
    dev = left.device

    lp = xsobel_prefilter(left, cfg.pre_filter_cap)
    rp = xsobel_prefilter(right, cfg.pre_filter_cap)
    wta = bm_cost_wta_plain if plain else bm_cost_wta
    best_d, best_cost, c_m1, c_p1, min_out = wta(lp, rp, D, bs)

    ys = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    valid = (ys >= w2) & (ys < H - w2) & (xs >= maxD + w2) & (xs < W - w2)

    if roi1 is not None or roi2 is not None:
        def norm(r):
            r = (0, 0, W, H) if r is None else r
            r = [torch.as_tensor(v, dtype=torch.int32, device=dev) for v in r]
            nonempty = r[2] * r[3] > 0
            return [torch.where(nonempty, v, f) for v, f in zip(r, (0, 0, W, H))]

        r1x, r1y, r1w, r1h = norm(roi1)
        r2x, r2y, r2w, r2h = norm(roi2)
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
    packed = (best_d * 256 + delta + 15) >> 4
    disp = torch.where(valid & tex_ok & ~uniq_bad, packed, invalid).to(torch.int16)

    if cfg.disp12_max_diff >= 0:
        disp = lr_check(disp, best_cost, D, cfg.disp12_max_diff, plain=plain)
    return disp
