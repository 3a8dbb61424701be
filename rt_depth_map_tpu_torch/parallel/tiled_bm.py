"""Width-tiled block matching over a mesh with halo exchange (port of
`rt_depth_map_tpu/parallel/tiled_bm.py`), and the exchange primitives of
the port's tilings.

The image width is sharded over the mesh's "space" axis; each rank matches
its own column tile. Disparity at global column x reads prefiltered left
columns [x - w2, x + w2] and right columns [x - maxD - w2, x + w2 - minD]
(w2 = blockSize // 2, maxD = minDisparity + numDisparities - 1), so each
rank fetches maxD + w2 columns of both planes from its left neighbour and
w2 - min(minD, 0) from its right one (K8 takes two planes of one width),
one send a direction. A tile at the image's edge drops the zeros its
missing neighbour gave: the image ends there, so K8 (`bm_cost_wta`) on
the extended tile computes at its core columns exactly what it computes
there on the whole image. The validity mask, texture, uniqueness and
subpixel steps are `ops/bm.py`'s in global column coordinates. The
left-right check (K6) and the speckle filter (K2, K7) chase matches and
components across the whole image, so the tiles' disparities and costs are
all-gathered and those run replicated.

The exchange primitives, counterparts of `ppermute` and `all_gather`:
`_shift` (a tile's tensor to its neighbour along the axis, zeros where no
tile sends: the OpenCV zero border of the wavefront, `exact_sgbm.py`),
`_halo_from_left`, `_halo_from_right` and `_all_gather_cols`. They move
bytes (a tensor viewed as uint8 along its last dim: gloo's collectives take
no int16). The backend alone picks the transport: on NCCL the bytes stay on
the device; on gloo those of a CUDA tensor go through host memory (several
ranks sharing one card), those of a CPU tensor as they are.

Requires tile width >= maxD + w2 (single-hop halo); at 1280x720, D=128,
bs 13 that holds from 2 to 8 tiles.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from rt_depth_map_tpu_torch.config import MatcherConfig
from rt_depth_map_tpu_torch.ops.bm import (
    DISP_SCALE,
    border_valid,
    lr_check,
    winner_disparity,
)
from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
from rt_depth_map_tpu_torch.ops.speckle import filter_speckles
from rt_depth_map_tpu_torch.parallel.mesh import Mesh


def _via_host(x: torch.Tensor, group) -> bool:
    """gloo moves host memory: a CUDA tensor goes through the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """x's bytes: contiguous, viewed as uint8 along its last dim."""
    return x.contiguous().view(torch.uint8)


def _shift(x: torch.Tensor, mesh: Mesh, axis: str, step: int) -> torch.Tensor:
    """x of the tile `step` places before this one along `axis` (its own x
    goes `step` places on): the ppermute of the tiles i -> i + step; zeros
    where no tile sends. Every rank of the axis's group calls it."""
    n = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    out = torch.zeros_like(x)
    if n == 1:
        return out
    group = mesh.group(axis)
    ranks = mesh.axis_ranks(axis)
    host = _via_host(x, group)
    send = _bytes(x.cpu() if host else x)
    recv = torch.zeros_like(send) if host else _bytes(out)
    ops = []
    if 0 <= idx + step < n:
        ops.append(dist.P2POp(dist.isend, send, ranks[idx + step], group))
    if 0 <= idx - step < n:
        ops.append(dist.P2POp(dist.irecv, recv, ranks[idx - step], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        out.copy_(recv.view(x.dtype))
    return out


def _halo_from_left(x: torch.Tensor, n: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """The last `n` columns of the left neighbour (zeros at tile 0)."""
    return _shift(x[:, -n:], mesh, axis, 1)


def _halo_from_right(x: torch.Tensor, n: int, mesh: Mesh, axis: str) -> torch.Tensor:
    """The first `n` columns of the right neighbour (zeros at the last tile)."""
    return _shift(x[:, :n], mesh, axis, -1)


def _all_gather_cols(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The tiles of the axis side by side along dim 1 (all_gather, tiled)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.dim() != 2:
        raise ValueError(f"_all_gather_cols: a 2-D tensor, got {tuple(x.shape)}")
    group = mesh.group(axis)
    host = _via_host(x, group)
    src = _bytes(x.cpu() if host else x)
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=1).view(x.dtype)
    return out.to(x.device) if host else out


def halo_widths(cfg: MatcherConfig):
    """(left, right) halo columns of a BM tile."""
    w2 = cfg.block_size // 2
    maxD = cfg.min_disparity + cfg.num_disparities - 1
    return max(maxD, 0) + w2, w2 + max(-cfg.min_disparity, 0)


def bm_tile_program(
    lp_loc: torch.Tensor,
    rp_loc: torch.Tensor,
    cfg: MatcherConfig,
    W_full: int,
    mesh: Mesh,
    space_axis: str = "space",
) -> torch.Tensor:
    """The per-rank tile program: halo exchange -> K8 and the winner's
    checks on the tile -> gathered global postprocessing. lp/rp_loc:
    (H, Wloc) prefiltered tiles. Returns the full (H, W_full) disparity,
    replicated along the space axis."""
    D = cfg.num_disparities
    minD = cfg.min_disparity
    invalid = (minD - 1) * DISP_SCALE
    H, Wloc = lp_loc.shape
    n = mesh.shape[space_axis]
    idx = mesh.axis_index(space_axis)
    hl, hr = halo_widths(cfg)
    # the image's own edges, not the zeros of a missing neighbour
    lo = hl if idx > 0 else 0
    hi = hr if idx < n - 1 else 0

    def extend(p):
        left = _halo_from_left(p, hl, mesh, space_axis)
        right = _halo_from_right(p, hr, mesh, space_axis)
        return torch.cat([left[:, hl - lo:], p, right[:, :hi]], dim=1)

    lp_ext, rp_ext = extend(lp_loc), extend(rp_loc)
    wta = bm_cost_wta(lp_ext, rp_ext, D, cfg.block_size, minD)
    x0 = idx * Wloc
    ys = torch.arange(H, dtype=torch.int32, device=lp_loc.device)[:, None]
    xs = torch.arange(x0, x0 + Wloc, dtype=torch.int32, device=lp_loc.device)[None, :]
    valid = border_valid(ys, xs, H, W_full, cfg)
    disp_t, cost_t = winner_disparity(lp_ext, wta, cfg, valid, slice(lo, lo + Wloc))
    # global postprocessing on the gathered tiles (replicated)
    disp = _all_gather_cols(disp_t, mesh, space_axis)
    if cfg.disp12_max_diff >= 0:
        cost = _all_gather_cols(cost_t, mesh, space_axis)
        disp = lr_check(disp, cost, D, cfg.disp12_max_diff, minD)
    if cfg.speckle_window_size > 0 and cfg.speckle_range >= 0:
        disp = filter_speckles(disp, invalid, cfg.speckle_window_size,
                               cfg.speckle_range * DISP_SCALE)
    return disp


def check_tiles(W: int, n: int, cfg: MatcherConfig) -> int:
    """The tile width of W over n tiles; raise where W does not split or the
    halo would need a second hop."""
    if W % n:
        raise ValueError(f"width {W} does not split into {n} tiles")
    Wloc = W // n
    halo = max(halo_widths(cfg))
    if n > 1 and Wloc < halo:
        raise ValueError(f"tile width {Wloc} < halo {halo}; use fewer space shards")
    return Wloc


def tiled_stereo_bm(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: MatcherConfig,
    mesh: Mesh,
    space_axis: str = "space",
) -> torch.Tensor:
    """Single-frame width-tiled StereoBM over `mesh`; bit-identical to
    `ops.bm.stereo_bm` (full-frame ROI). left/right: the full (H, W) uint8
    rectified planes on this rank's device. Returns the full (H, W) int16
    map, replicated across the space axis."""
    H, W = left.shape
    n = mesh.shape[space_axis]
    Wloc = check_tiles(W, n, cfg)
    x0 = mesh.axis_index(space_axis) * Wloc
    lp = xsobel_prefilter(left, cfg.pre_filter_cap)
    rp = xsobel_prefilter(right, cfg.pre_filter_cap)
    return bm_tile_program(lp[:, x0: x0 + Wloc], rp[:, x0: x0 + Wloc], cfg, W,
                           mesh, space_axis)
