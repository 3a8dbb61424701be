"""WLS disparity post-filter (the reference's ENABLE_POST_FILTER feature).

Port of `rt_depth_map_tpu/ops/wls.py`, with its signatures, defaults and
arithmetic: a right-view matcher over the mirrored range
(`right_matcher_config`), a left-right confidence map (`lr_confidence`),
and the Fast Global Smoother of cv2.ximgproc's DisparityWLSFilter
(`fast_global_smoother`: T = 3 sweeps of separable 1-D weighted least
squares with lambda_t = 1.5 * lambda * 4^(T-t) / (4^T - 1), weights
exp(-|I_p - I_q| / sigma_color) on the guide) at the reference's
lambda = 8000, sigma_color = 1.5 (estimator.cpp:63-64).

The confidence, the confident-mean prefill and the rounding are plain
torch, as the reference leaves them to XLA; each sweep's tridiagonal solves
are one launch of the smoother kernel (`ops/cuda/wls.py`), or its plain
version with plain=True and on CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda.wls import tridiag_smooth, tridiag_smooth_plain

DISP_SCALE = 16
#: the confidence floor: below it the float32 Thomas elimination over a
#: zero-confidence run cancels catastrophically (the reference's note)
CONF_FLOOR = 1e-2


def right_matcher_config(cfg: MatcherConfig) -> MatcherConfig:
    """cv2.ximgproc.createRightMatcher parity: the same search range
    mirrored, min_disparity -(minD + D) + 1, with no speckle filter and no
    left-right check of its own."""
    return cfg.replace(
        min_disparity=-(cfg.min_disparity + cfg.num_disparities) + 1,
        speckle_window_size=0,
        disp12_max_diff=-1,
    )


def lr_confidence(disp_left: torch.Tensor, disp_right: torch.Tensor,
                  lrc_thresh: int = 24, invalid_left: int | None = None,
                  invalid_right: int | None = None) -> torch.Tensor:
    """(H, W) float32 confidence in {0, 1}: 1 where the right view's
    disparity at x - round(d) agrees within lrc_thresh (x16 units), 0
    elsewhere, where the match leaves the image, or where either view holds
    its invalid marker (when given; int16-min always counts as invalid)."""
    H, W = disp_left.shape
    dl = disp_left.to(torch.int32)
    xs = torch.arange(W, dtype=torch.int32, device=dl.device)
    x2 = xs - ((dl + DISP_SCALE // 2) >> 4)
    ok = (x2 >= 0) & (x2 < W)
    dr_at = torch.gather(disp_right.to(torch.int32), 1,
                         x2.clamp(0, W - 1).to(torch.int64))
    # right-view disparities are negative (mirrored range)
    consistent = (dl + dr_at).abs() <= lrc_thresh
    valid = (dl > -32768) & ok
    if invalid_left is not None:
        valid = valid & (dl != invalid_left)
    if invalid_right is not None:
        valid = valid & (dr_at != invalid_right)
    return (consistent & valid).to(torch.float32)


def sweep_lambdas(lam: float = 8000.0, num_iter: int = 3):
    """lambda_t = 1.5 * lam * 4^(T-t) / (4^T - 1) of the sweeps t = 1..T."""
    denom = 4.0 ** num_iter - 1.0
    return [1.5 * lam * (4.0 ** (num_iter - t)) / denom
            for t in range(1, num_iter + 1)]


def fast_global_smoother(x: torch.Tensor, guide: torch.Tensor,
                         confidence: torch.Tensor, lam: float = 8000.0,
                         sigma_color: float = 1.5, num_iter: int = 3,
                         plain: bool = False) -> torch.Tensor:
    """FGS smoothing of x (float32) guided by `guide` (uint8 gray), weighted
    by the per-pixel confidence floored at CONF_FLOOR: each of num_iter
    iterations one sweep along the rows, then one along the columns."""
    smooth = tridiag_smooth_plain if plain else tridiag_smooth
    u = x.to(torch.float32)
    conf = torch.clamp(confidence.to(torch.float32), min=CONF_FLOOR)
    # a row sweep solves along the columns of the transposed planes; the
    # confidence and the guide are transposed once for every iteration
    conf_t, guide_t = conf.t().contiguous(), guide.t().contiguous()
    for lam_t in sweep_lambdas(lam, num_iter):
        u = smooth(u.t().contiguous(), conf_t, guide_t, lam_t, sigma_color,
                   dim=0).t().contiguous()
        u = smooth(u, conf, guide, lam_t, sigma_color, dim=0)
    return u


def smoother_inputs(disp_left: torch.Tensor, disp_right: torch.Tensor,
                    cfg: MatcherConfig, lrc_thresh: int = 24):
    """(x, weight, confidence) that `wls_filter` smooths: the left disparity
    as float32 with its invalid pixels prefilled by the mean of the valid
    ones, the data weight (the confidence where the left disparity is
    valid), and the LR confidence."""
    invalid = (cfg.min_disparity - 1) * DISP_SCALE
    invalid_r = -(cfg.min_disparity + cfg.num_disparities) * DISP_SCALE
    conf = lr_confidence(disp_left, disp_right, lrc_thresh,
                         invalid_left=invalid, invalid_right=invalid_r)
    valid = disp_left != invalid
    w = conf * valid.to(torch.float32)
    # prefill zero-confidence pixels with the confident mean, so that the
    # floored data term pulls toward a plausible value instead of zero
    dl = disp_left.to(torch.float32)
    vsum = torch.where(valid, dl, 0.0).sum()
    vmean = vsum / valid.sum().clamp(min=1)
    return torch.where(valid, dl, vmean), w, conf


def wls_filter(disp_left: torch.Tensor, disp_right: torch.Tensor,
               guide_gray: torch.Tensor, cfg: MatcherConfig,
               lam: float = 8000.0, sigma_color: float = 1.5,
               lrc_thresh: int = 24,
               plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Confidence-weighted WLS refinement of the left disparity
    (DisparityWLSFilter.filter parity at the reference's parameter point).

    disp_left/right: int16 x16 maps (the right one from the mirrored
    matcher); guide_gray: (H, W) uint8 rectified left image. Returns
    (filtered int16 x16, confidence float32 in {0, 1})."""
    x, w, conf = smoother_inputs(disp_left, disp_right, cfg, lrc_thresh)
    u = fast_global_smoother(x, guide_gray, w, lam, sigma_color, plain=plain)
    out = torch.round(u).clamp(-32768, 32767).to(torch.int16)
    return out, conf
