"""Konolige SAD block matcher (cv::StereoBM parity).

Port of `rt_depth_map_tpu/ops/bm.py` `stereo_bm` at any min_disparity, at
strict shapes (GPU kernels need no pad-to-kernel-grid route). The cost and
winner search run in K8 (`ops/cuda/bm_kernel.py`), which takes minD and
returns disparity indices; the texture check,
uniqueness test, subpixel step and the per-frame ROI mask are elementwise
torch, with the ROI scalars left on the device; the left-right check is one launch of
K6's BM entry (`ops/cuda/lr_resolve.py`), and the speckle filter runs on K2,
K7 with its size decision, and one apply launch (`ops/speckle.py`).
While a profiler runs, each step is a span `rtdm.match.<step>`
(`pipeline/stats.py` `span`): `prefilter`, `cost` (K8), `winner`,
`lr_check`, `speckle`.
"""

from __future__ import annotations

from typing import Optional, Tuple

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
from rt_depth_map_tpu_torch.pipeline.stats import span

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT


def lr_check(disp: torch.Tensor, cost: torch.Tensor, num_disp: int,
             max_diff: int, min_disp: int = 0, plain: bool = False) -> torch.Tensor:
    """cv::validateDisparity parity (ops/bm.py _lr_check) on K6's BM entry:
    `lr_resolve_bm_plain`."""
    return (lr_resolve_bm_plain if plain else lr_resolve_bm)(disp, cost, num_disp,
                                                             max_diff, min_disp)


def border_valid(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int,
                 cfg: MatcherConfig) -> torch.Tensor:
    """The pixels StereoBM computes in an (H, W) image (the window inside
    the rows, the search inside the columns) at the rows ys (H', 1) and the
    columns xs (1, W') of it, int32."""
    w2 = cfg.block_size // 2
    maxD = cfg.min_disparity + cfg.num_disparities - 1
    return ((ys >= w2) & (ys < H - w2) & (xs >= max(maxD, 0) + w2)
            & (xs < W - w2))


def winner_disparity(lp: torch.Tensor, wta, cfg: MatcherConfig,
                     valid: torch.Tensor, cols: slice = slice(None)):
    """(disp int16 x16, best_cost int32) at the columns `cols` of lp from K8's
    outputs `wta` over lp's columns: the texture check, the uniqueness test
    and the subpixel step, invalid (minD - 1) * 16 outside `valid`."""
    D = cfg.num_disparities
    minD = cfg.min_disparity
    best_d, best_cost, c_m1, c_p1, min_out = (t[:, cols] for t in wta)
    texture = box_sum_2d((lp.to(torch.int32) - cfg.pre_filter_cap).abs(),
                         cfg.block_size)[:, cols]
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
    invalid = (minD - 1) * DISP_SCALE
    disp = torch.where(valid & tex_ok & ~uniq_bad, packed, invalid).to(torch.int16)
    return disp, best_cost


def stereo_bm(left: torch.Tensor, right: torch.Tensor, cfg: MatcherConfig,
              roi1: Optional[Tuple] = None, roi2: Optional[Tuple] = None,
              plain: bool = False) -> torch.Tensor:
    """int16 x16 disparity of (H, W) uint8 rectified gray planes.

    roi1/roi2: optional (x, y, w, h), ints or 0-d device tensors; an empty
    ROI means the full frame. plain=True runs the kernels' plain versions."""
    H, W = left.shape
    D = cfg.num_disparities
    minD = cfg.min_disparity
    bs = cfg.block_size
    w2 = bs // 2
    maxD = minD + D - 1
    invalid = (minD - 1) * DISP_SCALE
    dev = left.device

    with span("rtdm.match.prefilter"):
        lp = xsobel_prefilter(left, cfg.pre_filter_cap)
        rp = xsobel_prefilter(right, cfg.pre_filter_cap)
    with span("rtdm.match.cost"):
        wta = (bm_cost_wta_plain if plain else bm_cost_wta)(lp, rp, D, bs, minD)
    with span("rtdm.match.winner"):
        ys = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
        xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        valid = border_valid(ys, xs, H, W, cfg)

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

        disp, best_cost = winner_disparity(lp, wta, cfg, valid)

    if cfg.disp12_max_diff >= 0:
        with span("rtdm.match.lr_check"):
            disp = lr_check(disp, best_cost, D, cfg.disp12_max_diff, minD, plain=plain)
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        with span("rtdm.match.speckle"):
            disp = filter_speckles(disp, invalid, cfg.speckle_window_size,
                                   cfg.speckle_range * DISP_SCALE, plain=plain)
    return disp
