"""Width-tiled semi-global matching with overlap margins (port of
`rt_depth_map_tpu/parallel/tiled_sgbm.py`, the "margin" tile mode).

SGM's directional scans are global recurrences, so exact tiling serializes
the tiles along each scan (`parallel/exact_sgbm.py` does it). This mode
instead overlaps the tiles: the P2 cap bounds how far a path's influence
travels, so a margin of a few dozen columns makes tile-local aggregation
match the global result except on a vanishing set of pixels (the budget is
the <=1% bad-pixel bound of `BASELINE.md`; the tests hold it to ~0.1%).

Each rank holds columns [x0, x0 + Wloc) of the rectified pair and fetches
margin + maxD + 2 columns from its left neighbour and margin + 2 from its
right one (zeros at the mesh's edges, as the reference), runs the port's
single-device `stereo_sgbm` on the extended tile without its speckle filter
(K3, then the route the tile's shape takes: K12, K4, K12, K5 or the chained
passes; K6), crops its core columns, re-imposes the global x < maxD and
last-two-columns invalidation, all-gathers, and runs the speckle filter
(K2, K7) replicated.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.sgbm import DISP_SCALE, stereo_sgbm
from rt_depth_map_tpu_torch.ops.speckle import filter_speckles
from rt_depth_map_tpu_torch.parallel.mesh import Mesh
from rt_depth_map_tpu_torch.parallel.tiled_bm import (
    _all_gather_cols,
    _halo_from_left,
    _halo_from_right,
)


def sgbm_tile_program(
    left_loc: torch.Tensor,
    right_loc: torch.Tensor,
    cfg: MatcherConfig,
    W_full: int,
    mesh: Mesh,
    space_axis: str = "space",
    margin: int = 64,
) -> torch.Tensor:
    """Per-rank tile program. left/right_loc: (H, Wloc) uint8 tiles. Returns
    the full (H, W_full) int16 disparity, replicated along the space axis."""
    H, Wloc = left_loc.shape
    maxD = cfg.min_disparity + cfg.num_disparities - 1
    hl = margin + max(maxD, 0) + 2
    hr = margin + 2
    if Wloc < max(hl, hr):
        raise ValueError(
            f"tile width {Wloc} < halo {max(hl, hr)}; use fewer space shards "
            f"or a smaller margin"
        )
    invalid = (cfg.min_disparity - 1) * DISP_SCALE
    idx = mesh.axis_index(space_axis)
    n = mesh.shape[space_axis]

    def extend(img):
        return torch.cat([_halo_from_left(img, hl, mesh, space_axis), img,
                          _halo_from_right(img, hr, mesh, space_axis)], dim=1)

    local_cfg = cfg.replace(speckle_window_size=0)  # speckle is global
    disp_ext = stereo_sgbm(extend(left_loc), extend(right_loc), local_cfg)
    core = disp_ext[:, hl: hl + Wloc]
    # the global computed-x restriction: the single-device matcher leaves
    # x < maxD invalid, which tile 0's extended coordinates shift into its
    # zero halo; the last tile's last two columns saw a zero halo instead
    # of the image's border stencil
    x0 = idx * Wloc
    core = core.clone()
    core[:, : max(min(max(maxD, 0) - x0, Wloc), 0)] = invalid
    if idx == n - 1:
        core[:, max(W_full - 2 - x0, 0):] = invalid
    disp = _all_gather_cols(core, mesh, space_axis)
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(disp, invalid, cfg.speckle_window_size,
                               cfg.speckle_range * DISP_SCALE)
    return disp


def tiled_stereo_sgbm(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: MatcherConfig,
    mesh: Mesh,
    space_axis: str = "space",
    margin: int = 64,
) -> torch.Tensor:
    """Single-frame width-tiled StereoSGBM over `mesh`, near-exact against
    `ops.sgbm.stereo_sgbm` (the overlap approximation of the module).
    left/right: the full (H, W) uint8 rectified planes on this rank's
    device."""
    H, W = left.shape
    n = mesh.shape[space_axis]
    if W % n:
        raise ValueError(f"width {W} does not split into {n} tiles")
    Wloc = W // n
    x0 = mesh.axis_index(space_axis) * Wloc
    return sgbm_tile_program(left[:, x0: x0 + Wloc], right[:, x0: x0 + Wloc],
                             cfg, W, mesh, space_axis, margin)
