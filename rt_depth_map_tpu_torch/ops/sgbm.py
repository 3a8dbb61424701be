"""Semi-global matching (cv::StereoSGBM parity), 8, 5 or 4 paths.

Port of `rt_depth_map_tpu/ops/sgbm.py` `stereo_sgbm` at any min_disparity
minD, at strict shapes (the TPU's pad-to-kernel-grid route is not needed on
the GPU). After the elementwise plane preprocessing and K3's cost volume
(H, W1, D) over the columns [minX1, minX1 + W1) (minD is a column offset of
the right image there), the aggregation takes the reference's route for
the shape (`ops/sgbm.py:529-532, 585-612`; the reference runs its XLA
formulation at minD != 0, which every route equals bit for bit; the
aggregation kernels do not depend on minD):

  bidir, 8 paths with W1 % 8 == 0 and H % 16 == 0: K12 to x-major
      (W1, H, D) -> K4 horizontal paths Sh -> K12 back to (H, W1, D) -> K5
      six vertical and diagonal paths + winner-take-all;
  chained, 8 paths otherwise: K9a left-to-right -> K9a right-to-left + that
      partial -> K9c the three top-down paths + partial -> K9d the three
      bottom-up paths + partial, winner-take-all;
  5 paths (cv2 MODE_SGBM): K9a left-to-right -> K9a right-to-left +
      partial -> K9d the three top-down paths + partial, winner-take-all;
  4 paths: K9a left-to-right -> K9d top-down + partial, winner-take-all;

then the disparity (index + minD, x16), the inline left-right check (one
launch of K6's SGBM entry) and the speckle filter (K2, K7 with the size
decision, K2, the apply), both with the invalid value (minD - 1) * 16.
Every volume keeps D contiguous. The bidir route's transposes swap the
two pixel axes, as the TPU's K12 turns (H, D, W1) into (W1, D, H) and back
around its K4; the chained route scans the row-major volume directly (the
TPU transposes there only to put D on its sublanes).

`stereo_sgbm_batch` matches B frames at once (ops/sgbm.py
`stereo_sgbm_batch`), each frame bit-identical to `stereo_sgbm`. Where the
single frame takes the bidir route at min_disparity 0, every stage is one
launch for the batch: K3's batched entry, K12, K4 and K12 on the volumes
viewed as B * H rows (the horizontal paths and the transposes never mix
rows), K5's batched entry (each frame's diagonal carries start at its own
image border), K6 on the (B * H, W) rows (the LR check is row-local);
only the speckle filter runs frame by frame, as in the reference. Any
other configuration runs `stereo_sgbm` over the frames, as the reference
does.

`stereo_sgbm`, `stereo_sgbm_batch` and `Engine.frame_program` take an
optional `mark(name)` callback, called after each stage (the stage
profile of `chip_smoke.py`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import (
    lr_resolve_sgbm,
    lr_resolve_sgbm_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (  # noqa: F401
    cost_geometry,
    halfpix,
    plane_stack,
    sgbm_preprocess,
    sgm_cost_volume,
    sgm_cost_volume_batch,
    sgm_cost_volume_batch_plain,
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
    sgm_vert_wta_batch,
    sgm_vert_wta_batch_plain,
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


def _no_mark(name: str) -> None:
    pass


def sgbm_cost_volume(left: torch.Tensor, right: torch.Tensor, num_disp: int,
                     block_size: int, pre_filter_cap: int = 0,
                     plain: bool = False, mark: Callable[[str], None] = _no_mark,
                     min_disp: int = 0):
    """(C, minX1, W1) of two (H, W) uint8 rectified gray planes
    (ops/sgbm.py `sgbm_cost_volume`): the elementwise preprocessing, then
    K3. C is (H, W1, D), int16 where it provably fits."""
    lpl = plane_stack(left, pre_filter_cap)
    rpl = plane_stack(right, pre_filter_cap)
    mark("SGM preprocess: plane_stack x2")
    cost = sgm_cost_volume_plain if plain else sgm_cost_volume
    return cost(lpl, rpl, num_disp, block_size,
                volume_dtype(block_size, pre_filter_cap), min_disp)


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


def lr_check_sgbm(disp: torch.Tensor, best: torch.Tensor, minS: torch.Tensor,
                  minX1: int, width1: int, num_disp: int, max_diff: int,
                  min_disp: int = 0, plain: bool = False) -> torch.Tensor:
    """The inline SGBM left-right check (ops/sgbm.py `_lr_check_sgbm`) on
    K6's SGBM entry: `lr_resolve_sgbm_plain`."""
    fn = lr_resolve_sgbm_plain if plain else lr_resolve_sgbm
    return fn(disp, best, minS, minX1, width1, num_disp, max_diff, min_disp)


def check_config(cfg: MatcherConfig, W: int) -> None:
    """Raise for what the port's SGM does not run at image width W."""
    D = cfg.num_disparities
    if not 0 < D < W or cost_geometry(W, D, cfg.min_disparity)[1] < 1:
        raise ValueError(f"num_disparities={D}, min_disparity={cfg.min_disparity} "
                         f"leave no column to match at W={W}")


def uses_bidir(num_paths: int, H: int, W: int, D: int, min_disp: int = 0) -> bool:
    """The fused bidirectional route's gate (ops/sgbm.py:529-532) on the
    cost volume's width W1."""
    W1 = cost_geometry(W, D, min_disp)[1]
    return path_count(num_paths) == 8 and W1 % 8 == 0 and H % 16 == 0


def aggregate_bidir(C: torch.Tensor, p1: int, p2: int, uniqueness_ratio: int,
                    plain: bool = False, mark: Callable[[str], None] = _no_mark):
    """(best, minS, dval, uniq) of the 8 paths over the (H, W1, D) volume C,
    or the (B, H, W1, D) volumes of a batch, through the fused kernels:
    K12, K4, K12 on the (B * H, W1, D) rows (none of them mixes rows), then
    K5 or its batched entry."""
    *_, W1, D = C.shape
    batch = C.dim() == 4
    Ct = swap_pixel_axes(C.view(-1, W1, D), plain)
    mark("K12 cost volume to x-major")
    Sh_t = (sgm_horiz_plain if plain else sgm_horiz)(Ct, p1, p2)
    del Ct
    mark("K4 horizontal paths")
    Sh = swap_pixel_axes(Sh_t, plain).view(C.shape)
    del Sh_t
    mark("K12 horizontal sum to row-major")
    if batch:
        vert = sgm_vert_wta_batch_plain if plain else sgm_vert_wta_batch
    else:
        vert = sgm_vert_wta_plain if plain else sgm_vert_wta
    out = vert(C, Sh, p1, p2, uniqueness_ratio)
    mark("K5 vertical + diagonal paths, WTA" + (" (batch)" if batch else ""))
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
    minD = cfg.min_disparity
    p1 = cfg.p1
    p2 = max(cfg.p2, p1 + 1)

    C, minX1, _ = sgbm_cost_volume(left, right, D, cfg.block_size,
                                   cfg.pre_filter_cap, plain=plain,
                                   mark=mark, min_disp=minD)
    mark("K3 cost volume")
    if uses_bidir(cfg.num_paths, H, W, D, minD):
        best, minS, dval, uniq = aggregate_bidir(C, p1, p2, cfg.uniqueness_ratio,
                                                 plain, mark)
    else:
        best, minS, dval, uniq = aggregate_chained(
            C, path_count(cfg.num_paths), p1, p2, cfg.uniqueness_ratio, plain,
            mark)
    del C
    return _finish(best, minS, dval, uniq, cfg, W, minX1, plain, mark)


def _finish(best, minS, dval, uniq, cfg: MatcherConfig, W: int, minX1: int,
            plain: bool, mark: Callable[[str], None]) -> torch.Tensor:
    """The int16 x16 disparity of one frame or a batch from the winner-take-
    all's (..., H, W1) outputs: the uniqueness test, the LR check on the
    (rows, W) rows, then the speckle filter frame by frame."""
    *lead, H, W1 = best.shape
    D = cfg.num_disparities
    minD = cfg.min_disparity
    invalid = (minD - 1) * DISP_SCALE
    disp = torch.full((*lead, H, W), invalid, dtype=torch.int16,
                      device=best.device)
    if minD:
        dval = dval + minD * DISP_SCALE
    disp[..., minX1: minX1 + W1] = torch.where(uniq != 0, invalid, dval).to(torch.int16)
    if cfg.disp12_max_diff >= 0:
        disp = lr_check_sgbm(disp.view(-1, W), best.view(-1, W1),
                             minS.view(-1, W1), minX1, W1, D,
                             cfg.disp12_max_diff, minD,
                             plain=plain).view(disp.shape)
    mark("LR check (K6)")
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        frames = [filter_speckles(d, invalid, cfg.speckle_window_size,
                                  cfg.speckle_range * DISP_SCALE, plain=plain)
                  for d in disp.view(-1, H, W)]
        disp = frames[0] if not lead else torch.stack(frames)
    mark("speckle (K2 + K7 + K2 + apply)")
    return disp


def uses_batch_route(cfg: MatcherConfig, H: int, W: int) -> bool:
    """Whether `stereo_sgbm_batch` runs its batched kernels (the reference's
    gate, ops/sgbm.py:673-682, without the TPU's W1 % 128 lane tile): the
    bidir route at min_disparity 0."""
    return cfg.min_disparity == 0 and uses_bidir(
        cfg.num_paths, H, W, cfg.num_disparities, 0)


def stereo_sgbm_batch(lefts: torch.Tensor, rights: torch.Tensor,
                      cfg: MatcherConfig, plain: bool = False,
                      mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """(B, H, W) int16 x16 disparities of (B, H, W) uint8 rectified gray
    planes, frame b bit-identical to `stereo_sgbm(lefts[b], rights[b],
    cfg)`. On the batched route each stage is one launch for the B frames
    (module docstring); elsewhere `stereo_sgbm` runs frame by frame."""
    mark = mark or _no_mark
    B, H, W = lefts.shape
    if not uses_batch_route(cfg, H, W):
        return torch.stack([stereo_sgbm(lf, rf, cfg, plain=plain, mark=mark)
                            for lf, rf in zip(lefts, rights)])
    check_config(cfg, W)
    D = cfg.num_disparities
    p1 = cfg.p1
    p2 = max(cfg.p2, p1 + 1)
    lpl = plane_stack(lefts, cfg.pre_filter_cap)
    rpl = plane_stack(rights, cfg.pre_filter_cap)
    mark("SGM preprocess: plane_stack x2 (batch)")
    cost = sgm_cost_volume_batch_plain if plain else sgm_cost_volume_batch
    C, minX1, _ = cost(lpl, rpl, D, cfg.block_size,
                       volume_dtype(cfg.block_size, cfg.pre_filter_cap))
    del lpl, rpl
    mark("K3 cost volume (batch)")
    best, minS, dval, uniq = aggregate_bidir(C, p1, p2, cfg.uniqueness_ratio,
                                             plain, mark)
    del C
    return _finish(best, minS, dval, uniq, cfg, W, minX1, plain, mark)
