"""Exact width-tiled semi-global matching: the scans carried across tiles
(port of `rt_depth_map_tpu/parallel/exact_sgbm.py`, the "exact" tile mode,
`MatcherConfig.tile_mode`'s default).

`parallel/tiled_sgbm.py` tiles SGM with overlap margins (approximate: tiles
never talk during aggregation). This module is the exact counterpart: the
directional recurrences whose paths cross tile boundaries exchange their
boundary-column L state between neighbour ranks, pipelined over row blocks
in a wavefront, so each rank streams its own rows while the carry ripples
across the mesh. The output is bit-identical to the single-device
`ops.sgbm.stereo_sgbm` on every pixel, at any tile width that divides W1.

The cost volume of the tile's own W1 columns comes from K3 with an output
column window (`sgm_cost_volume(..., cols=...)`), run on the plane stacks
of the gathered full images: that window keeps the replicate border of
the whole W1 range on the edge tiles.

How each direction family is tiled (W1 split into n tiles of Wloc columns,
the rows into K blocks of Rb):

  * vertical (dy = +-1, dx = 0): columns are independent: tile-local, one
    job over all H rows;
  * horizontal (dy = 0): the (row, D) carry leaving a tile's last column
    enters its neighbour's first column, same row;
  * diagonal (dy = +-1, dx = +-1): the value shifted in at a tile's edge
    column on row r is the neighbour's edge-column L at row r -+ 1.

Tile i processes row block k of a left-to-right direction at step t = k +
i (right-to-left directions run the mirror wavefront from the last tile),
so K + n - 1 steps in all. Each step first exchanges last step's outboxes,
one `batch_isend_irecv` per direction family, posted by every rank in
every step, then scans the active directions' row blocks: one launch of
`sgm_tile_scan` (`ops/cuda/sgm_tile.py`) a step with any active direction
(a warp a line of each direction, its L added into S atomically: the
integer sum does not depend on the order). The message layout (an
(Rb + 1, D) strip a direction in global row order), the carries, the
direction lists and the default row block are the reference's; a rank
skips the scans of its inactive directions, whose outboxes stay as they
were (the reference computes them and masks with `active`).

Then the tile's last launch, `sgm_tile_final`: the tile-local vertical
paths and the winner-take-all, uniqueness and subpixel step on the tile
from registers (the reference's `_aggregate_dir` calls and
`wta_uniq_subpix`); so a rank makes at most K + n launches a frame. Then
all-gathers of disp1, best and minS, K6's SGBM entry and the speckle filter
(K2, K7) on the gathered maps, replicated.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
    cost_geometry,
    plane_stack,
    sgm_cost_volume,
    volume_dtype,
)
from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import ScanJob, sgm_tile_final, sgm_tile_scan
from rt_depth_map_tpu_torch.ops.sgbm import DISP_SCALE, lr_check_sgbm, path_count
from rt_depth_map_tpu_torch.ops.speckle import filter_speckles
from rt_depth_map_tpu_torch.parallel.mesh import Mesh
from rt_depth_map_tpu_torch.parallel.tiled_bm import _all_gather_cols, _shift


def cross_dirs(num_paths: int):
    """The cross-tile directions (dy, dx) of `num_paths` paths
    (exact_sgbm.py:212-219): dx = +1 ones wave from tile 0, dx = -1 ones
    from tile n - 1."""
    if num_paths >= 8:
        return [(0, 1), (1, 1), (-1, 1), (0, -1), (1, -1), (-1, -1)]
    if num_paths == 5:
        # cv2 MODE_SGBM single-pass parity: 4 causal + reverse horizontal
        return [(0, 1), (1, 1), (1, -1), (0, -1)]
    return [(0, 1), (1, 1), (1, -1)]


def local_dirs(num_paths: int):
    """The tile-local vertical directions (exact_sgbm.py:335-338)."""
    return [(1, 0), (-1, 0)] if num_paths >= 8 else [(1, 0)]


def _tile_cost_volume(lF: torch.Tensor, rF: torch.Tensor, cfg: MatcherConfig,
                      idx: int, Wloc: int) -> torch.Tensor:
    """(H, Wloc, D) windowed BT cost of tile `idx` from the full images:
    K3 over the tile's columns of W1, equal to `sgbm_cost_volume(...)[0][:,
    idx * Wloc:(idx + 1) * Wloc]` (exact_sgbm.py:74)."""
    lpl = plane_stack(lF, cfg.pre_filter_cap)
    rpl = plane_stack(rF, cfg.pre_filter_cap)
    C, _, _ = sgm_cost_volume(lpl, rpl, cfg.num_disparities, cfg.block_size,
                              volume_dtype(cfg.block_size, cfg.pre_filter_cap),
                              cfg.min_disparity, cols=(idx * Wloc, Wloc))
    return C


def _exact_aggregate(C_loc: torch.Tensor, p1: int, p2: int, num_paths: int,
                     mesh: Mesh, space_axis: str, Rb: int) -> torch.Tensor:
    """S (H, Wloc, D) int32: the sum of the cross-tile directions' L on
    this tile, the wavefront of exact_sgbm.py:187-290 (the tile-local
    vertical paths are `sgm_tile_final`'s)."""
    H, Wloc, D = C_loc.shape
    if H % Rb:
        raise ValueError(f"row_block {Rb} does not divide H={H}")
    K = H // Rb
    n = mesh.shape[space_axis]
    idx = mesh.axis_index(space_axis)
    dirs = cross_dirs(num_paths)
    fwd = [i for i, (_, dx) in enumerate(dirs) if dx == 1]
    bwd = [i for i, (_, dx) in enumerate(dirs) if dx == -1]
    zstrip = torch.zeros((Rb + 1, D), dtype=torch.int32, device=C_loc.device)
    outboxes: List[torch.Tensor] = [zstrip for _ in dirs]
    prevs: List[Optional[torch.Tensor]] = [None for _ in dirs]
    S = torch.zeros((H, Wloc, D), dtype=torch.int32, device=C_loc.device)

    for t in range(K + n - 1):
        # exchange last step's boundary strips, one exchange a family, on
        # every rank in every step (a tile at the mesh's edge receives
        # zeros: the OpenCV zero border)
        inboxes: List[Optional[torch.Tensor]] = [None] * len(dirs)
        for family, step in ((fwd, 1), (bwd, -1)):
            if family:
                got = _shift(torch.stack([outboxes[i] for i in family]), mesh,
                             space_axis, step)
                for j, i in enumerate(family):
                    inboxes[i] = got[j]
        jobs, active = [], []
        for i, (dy, dx) in enumerate(dirs):
            k = t - (idx if dx == 1 else n - 1 - idx)
            if not 0 <= k < K:
                continue  # its outbox and prev stay as they were
            start = H - (k + 1) * Rb if dy == -1 else k * Rb
            jobs.append(ScanJob(dy, dx, start, Rb, inboxes[i], outboxes[i],
                                prevs[i]))
            active.append(i)
        if not jobs:
            continue
        results = sgm_tile_scan(C_loc, S, jobs, p1, p2)
        for i, (out, prev) in zip(active, results):
            outboxes[i] = out
            prevs[i] = prev
    return S


def _default_row_block(H: int, n: int) -> int:
    """Largest divisor of H giving >= 4n row blocks (80% wavefront
    occupancy); falls back toward 1 (always a divisor)."""
    target = max(1, H // (4 * n))
    for rb in range(target, 0, -1):
        if H % rb == 0:
            return rb
    return 1


def exact_sgbm_tile_program(
    l_loc: torch.Tensor,
    r_loc: torch.Tensor,
    cfg: MatcherConfig,
    mesh: Mesh,
    space_axis: str = "space",
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """Per-rank tile program (the matcher slot of
    `parallel/pipeline_sharded.py`). l/r_loc: (H, W / n) uint8 column tiles
    of the full rectified pair. Returns the full (H, W) int16 disparity,
    replicated along the space axis, bit-exact against the single-device
    `ops.sgbm.stereo_sgbm`."""
    lF = _all_gather_cols(l_loc, mesh, space_axis)
    rF = _all_gather_cols(r_loc, mesh, space_axis)
    H, W = lF.shape
    n = mesh.shape[space_axis]
    D = cfg.num_disparities
    minD = cfg.min_disparity
    minX1, W1 = cost_geometry(W, D, minD)
    if W1 < 1 or W1 % n:
        raise ValueError(f"W1={W1} does not split into n={n} tiles")
    Wloc = W1 // n
    Rb = row_block if row_block is not None else _default_row_block(H, n)
    p1 = cfg.p1
    p2 = max(cfg.p2, p1 + 1)
    invalid = (minD - 1) * DISP_SCALE
    idx = mesh.axis_index(space_axis)

    C_loc = _tile_cost_volume(lF, rF, cfg, idx, Wloc)
    paths = path_count(cfg.num_paths)
    S = _exact_aggregate(C_loc, p1, p2, paths, mesh, space_axis, Rb)
    best, minS, dval, bad_uniq = sgm_tile_final(C_loc, S, p1, p2,
                                                cfg.uniqueness_ratio,
                                                local_dirs(paths))
    del C_loc, S
    dval = dval + minD * DISP_SCALE
    disp1_loc = torch.where(bad_uniq != 0, invalid, dval).to(torch.int16)

    disp1 = _all_gather_cols(disp1_loc, mesh, space_axis)
    disp = torch.full((H, W), invalid, dtype=torch.int16, device=lF.device)
    disp[:, minX1: minX1 + W1] = disp1
    if cfg.disp12_max_diff >= 0:
        bestF = _all_gather_cols(best, mesh, space_axis)
        minSF = _all_gather_cols(minS, mesh, space_axis)
        disp = lr_check_sgbm(disp, bestF, minSF, minX1, W1, D,
                             cfg.disp12_max_diff, minD)
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(disp, invalid, cfg.speckle_window_size,
                               cfg.speckle_range * DISP_SCALE)
    return disp


def exact_tiled_stereo_sgbm(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: MatcherConfig,
    mesh: Mesh,
    space_axis: str = "space",
    row_block: Optional[int] = None,
) -> torch.Tensor:
    """Single-frame width-tiled StereoSGBM over `mesh`, bit-exact against the
    single-device `ops.sgbm.stereo_sgbm`. left/right: the full (H, W) uint8
    rectified planes on this rank's device; `parallel.tiled_sgbm
    .tiled_stereo_sgbm` is the approximate margin mode."""
    W = left.shape[1]
    n = mesh.shape[space_axis]
    if W % n:
        raise ValueError(f"W={W} does not split into n={n} tiles")
    Wt = W // n
    x0 = mesh.axis_index(space_axis) * Wt
    return exact_sgbm_tile_program(left[:, x0: x0 + Wt], right[:, x0: x0 + Wt],
                                   cfg, mesh, space_axis, row_block)
