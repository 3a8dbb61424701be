"""Semi-global matching (cv::StereoSGBM parity), 8, 5 or 4 paths.

Port of `rt_depth_map_tpu/ops/sgbm.py` `stereo_sgbm` for min_disparity 0
at strict shapes (the TPU's pad-to-kernel-grid route is not needed on the
GPU). After the elementwise plane preprocessing and K3's cost volume
(H, W1, D), the aggregation takes the reference's route for the shape
(`ops/sgbm.py:529-532, 585-612`):

  bidir, 8 paths with W1 % 8 == 0 and H % 16 == 0: K12 to x-major
      (W1, H, D) -> K4 horizontal paths Sh -> K12 back to (H, W1, D) -> K5
      six vertical and diagonal paths + winner-take-all;
  chained, 8 paths otherwise: K9a left-to-right -> K9a right-to-left + that
      partial -> K9c the three top-down paths + partial -> K9d the three
      bottom-up paths + partial, winner-take-all;
  5 paths (cv2 MODE_SGBM): K9a left-to-right -> K9a right-to-left +
      partial -> K9d the three top-down paths + partial, winner-take-all;
  4 paths: K9a left-to-right -> K9d top-down + partial, winner-take-all;

then the inline left-right check on K6 and the speckle filter (K2 + K7 +
K2). Every volume keeps D contiguous. The bidir route's transposes swap the
two pixel axes, as the TPU's K12 turns (H, D, W1) into (W1, D, H) and back
around its K4; the chained route scans the row-major volume directly (the
TPU transposes there only to put D on its sublanes).

`stereo_sgbm` and `Engine.frame_program` take an optional `mark(name)`
callback, called after each stage (the stage profile of `chip_smoke.py`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve, lr_resolve_plain
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (  # noqa: F401
    halfpix,
    plane_stack,
    sgbm_preprocess,
    sgm_cost_volume,
    sgm_cost_volume_plain,
    volume_dtype,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
    partials_fit_int16,
    sgm_final_wta,
    sgm_final_wta_plain,
    sgm_horiz_pass,
    sgm_horiz_pass_plain,
    sgm_vert_pass,
    sgm_vert_pass_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import (
    aggregate_dir,
    sgm_horiz,
    sgm_horiz_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (  # noqa: F401
    sgm_vert_wta,
    sgm_vert_wta_plain,
    wta_uniq_subpix,
)
from rt_depth_map_tpu_torch.ops.cuda.vol_transpose import (
    vol_transpose,
    vol_transpose_plain,
)
from rt_depth_map_tpu_torch.ops.speckle import filter_speckles

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
LR_DPOW = 256  # packs (minS, best) keys; best < D <= 256
BIGKEY = 2**31 - 1
SENT = -(2**31)


def _no_mark(name: str) -> None:
    pass


def sgbm_cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                     block_size: int, pre_filter_cap: int = 0,
                     plain: bool = False, mark: Callable[[str], None] = _no_mark):
    """(C, minX1, W1) of two (H, W) uint8 rectified gray planes
    (ops/sgbm.py `sgbm_cost_volume`, min_disparity 0): the elementwise
    preprocessing, then K3. C is (H, W1, D), int16 where it provably fits."""
    lpl = plane_stack(left, pre_filter_cap)
    rpl = plane_stack(right, pre_filter_cap)
    mark("SGM preprocess: plane_stack x2")
    cost = sgm_cost_volume_plain if plain else sgm_cost_volume
    return cost(lpl, rpl, num_disp, block_size,
                volume_dtype(block_size, pre_filter_cap))


# the reference's direction lists (ops/sgbm.py:234-235), a pixel (y, x)
# following (y - dy, x - dx)
DIRS_PASS1 = ((0, 1), (1, 1), (1, 0), (1, -1))
DIRS_PASS2 = ((0, -1), (-1, -1), (-1, 0), (-1, 1))


def path_count(num_paths: int) -> int:
    """The path count the reference runs for `num_paths` (ops/sgbm.py:621)."""
    return 8 if num_paths >= 8 else (5 if num_paths == 5 else 4)


def aggregate_cost(C: torch.Tensor, p1: int, p2: int,
                   num_paths: int) -> torch.Tensor:
    """(H, W1, D) int32 sum of the path directions (ops/sgbm.py
    `aggregate_cost`): the four causal ones, plus the right-to-left
    horizontal for 5 (cv2 MODE_SGBM), or the other four for 8 (MODE_HH)."""
    dirs = DIRS_PASS1
    if num_paths == 5:
        dirs += DIRS_PASS2[:1]
    elif num_paths >= 8:
        dirs += DIRS_PASS2
    S = torch.zeros(C.shape, dtype=torch.int32, device=C.device)
    for dy, dx in dirs:
        S += aggregate_dir(C, p1, p2, dy, dx)
    return S


def swap_pixel_axes(V: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """(P, Q, D) -> (Q, P, D) through K12: the SGM volumes between the
    row-major (H, W1, D) and the x-major (W1, H, D) layout."""
    fn = vol_transpose_plain if plain else vol_transpose
    return fn(V[:, None])[:, 0]


def lr_key_planes_sgbm(disp: torch.Tensor, best: torch.Tensor,
                       minS: torch.Tensor, minX1: int, width1: int,
                       num_disp: int):
    """K6's inputs of the inline SGBM left-right check, (d_int, key, reads,
    kwargs): each column's winner and packed (minS, best) key over the full
    width (sentinels outside [minX1, minX1 + width1) and where the match
    leaves the image), the two read-back planes (the floor and the ceiling
    of the x16 disparity), and K6's parameters."""
    H, W = disp.shape
    dev = disp.device
    d16 = disp.to(torch.int32)
    xs1 = torch.arange(width1, dtype=torch.int32, device=dev) + minX1
    valid1 = d16[:, minX1: minX1 + width1] != -DISP_SCALE
    x2 = xs1 - best
    in_rng = valid1 & (x2 >= 0) & (x2 < W)
    keyW = torch.full((H, W), BIGKEY, dtype=torch.int32, device=dev)
    keyW[:, minX1: minX1 + width1] = torch.where(in_rng, minS * LR_DPOW + best,
                                                 BIGKEY)
    d_intW = torch.full((H, W), SENT, dtype=torch.int32, device=dev)
    d_intW[:, minX1: minX1 + width1] = best
    reads = ((d16 >> DISP_SHIFT).contiguous(),
             ((d16 + DISP_SCALE - 1) >> DISP_SHIFT).contiguous())
    kw = dict(n_w=num_disp, r_lo=-1, n_r=num_disp + 2, Dpow=LR_DPOW, c0=0,
              invalid=-DISP_SCALE)
    return d_intW, keyW, reads, kw


def lr_check_sgbm(disp: torch.Tensor, best: torch.Tensor, minS: torch.Tensor,
                  minX1: int, width1: int, num_disp: int, max_diff: int,
                  plain: bool = False) -> torch.Tensor:
    """The inline SGBM left-right check (ops/sgbm.py `_lr_check_sgbm`,
    min_disparity 0): the right view's winner per column from the packed
    (minS, best) keys, read back at both the floor and the ceiling of each
    pixel's disparity through K6; a pixel is invalid only when BOTH
    read-backs disagree by more than max_diff."""
    W = disp.shape[1]
    invalid = -DISP_SCALE
    d_intW, keyW, reads, kw = lr_key_planes_sgbm(disp, best, minS, minX1,
                                                 width1, num_disp)
    d_lo, d_hi = reads
    xsW = torch.arange(W, dtype=torch.int32, device=disp.device)
    ok_range = (xsW >= minX1) & (xsW < minX1 + width1)
    validW = ok_range & (disp != invalid)
    oka = ((xsW - d_lo) >= 0) & ((xsW - d_lo) < W)
    okb = ((xsW - d_hi) >= 0) & ((xsW - d_hi) < W)
    fn = lr_resolve_plain if plain else lr_resolve
    d2a, d2b = fn(d_intW, keyW, reads, **kw)
    d2a = torch.where(oka, d2a, invalid)
    d2b = torch.where(okb, d2b, invalid)
    bad = (validW
           & oka & (d2a >= 0) & ((d2a - d_lo).abs() > max_diff)
           & okb & (d2b >= 0) & ((d2b - d_hi).abs() > max_diff))
    return torch.where(bad, torch.full_like(disp, invalid), disp)


def check_config(cfg: MatcherConfig, W: int) -> None:
    """Raise for what the port's SGM does not run at image width W."""
    if cfg.min_disparity != 0:
        raise NotImplementedError("the port's SGM supports min_disparity 0 only")
    if not 0 < cfg.num_disparities < W:
        raise ValueError(f"num_disparities={cfg.num_disparities} needs "
                         f"0 < D < W={W}")


def uses_bidir(num_paths: int, H: int, W: int, D: int) -> bool:
    """The fused bidirectional route's gate (ops/sgbm.py:529-532)."""
    return path_count(num_paths) == 8 and (W - D) % 8 == 0 and H % 16 == 0


def aggregate_bidir(C: torch.Tensor, p1: int, p2: int, uniqueness_ratio: int,
                    plain: bool = False, mark: Callable[[str], None] = _no_mark):
    """(best, minS, dval, uniq) of the 8 paths over the (H, W1, D) volume C
    through the fused kernels: K12, K4, K12, K5."""
    Ct = swap_pixel_axes(C, plain)
    mark("K12 cost volume to x-major")
    Sh_t = (sgm_horiz_plain if plain else sgm_horiz)(Ct, p1, p2)
    del Ct
    mark("K4 horizontal paths")
    Sh = swap_pixel_axes(Sh_t, plain)
    del Sh_t
    mark("K12 horizontal sum to row-major")
    vert = sgm_vert_wta_plain if plain else sgm_vert_wta
    out = vert(C, Sh, p1, p2, uniqueness_ratio)
    mark("K5 vertical + diagonal paths, WTA")
    return out


def aggregate_chained(C: torch.Tensor, paths: int, p1: int, p2: int,
                      uniqueness_ratio: int, plain: bool = False,
                      mark: Callable[[str], None] = _no_mark):
    """(best, minS, dval, uniq) of `paths` (8, 5 or 4) paths over the
    (H, W1, D) volume C through the chained passes, one direction set each:
    K9a (once, or twice from 5 paths), K9c for 8 paths, K9d."""
    horiz = sgm_horiz_pass_plain if plain else sgm_horiz_pass
    final = sgm_final_wta_plain if plain else sgm_final_wta
    if C.dtype == torch.int16 and not partials_fit_int16(p1, p2):
        C = C.to(torch.int32)  # the partials would overflow int16
    S = horiz(C, p1, p2)
    mark(f"K9a left-to-right ({paths}-path)")
    if paths >= 5:
        S = horiz(C, p1, p2, reverse=True, partial=S)
        mark(f"K9a right-to-left + partial ({paths}-path)")
    if paths == 8:
        S = (sgm_vert_pass_plain if plain else sgm_vert_pass)(C, p1, p2,
                                                              partial=S)
        mark("K9c top-down paths + partial (8-path)")
    out = final(C, S, p1, p2, uniqueness_ratio, reverse=paths == 8)
    mark(f"K9d {'bottom-up' if paths == 8 else 'top-down'} paths + partial, "
         f"WTA ({paths}-path)")
    return out


def stereo_sgbm(left: torch.Tensor, right: torch.Tensor, cfg: MatcherConfig,
                plain: bool = False,
                mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """int16 x16 disparity map of (H, W) uint8 rectified gray planes,
    cv::StereoSGBM parity (MODE_HH for 8 paths, MODE_SGBM for 5).
    plain=True runs the kernels' plain versions (the reference for the
    card's kernels); mark(name), when given, is called after each stage."""
    mark = mark or _no_mark
    H, W = left.shape
    check_config(cfg, W)
    D = cfg.num_disparities
    invalid = -DISP_SCALE
    p1 = cfg.p1
    p2 = max(cfg.p2, p1 + 1)

    C, minX1, width1 = sgbm_cost_volume(left, right, D, cfg.block_size,
                                        cfg.pre_filter_cap, plain=plain,
                                        mark=mark)
    mark("K3 cost volume")
    if uses_bidir(cfg.num_paths, H, W, D):
        best, minS, dval, uniq = aggregate_bidir(C, p1, p2, cfg.uniqueness_ratio,
                                                 plain, mark)
    else:
        best, minS, dval, uniq = aggregate_chained(
            C, path_count(cfg.num_paths), p1, p2, cfg.uniqueness_ratio, plain,
            mark)
    del C

    disp = torch.full((H, W), invalid, dtype=torch.int16, device=left.device)
    disp[:, minX1: minX1 + width1] = torch.where(uniq != 0, invalid, dval).to(torch.int16)
    if cfg.disp12_max_diff >= 0:
        disp = lr_check_sgbm(disp, best, minS, minX1, width1, D,
                             cfg.disp12_max_diff, plain=plain)
    mark("LR check (K6 + glue)")
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(disp, invalid, cfg.speckle_window_size,
                               cfg.speckle_range * DISP_SCALE, plain=plain)
    mark("speckle (K2 + K7 + K2)")
    return disp
