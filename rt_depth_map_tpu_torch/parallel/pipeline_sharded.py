"""The multi-rank frame step: frames over the data axis x image width over
the space axis (port of `rt_depth_map_tpu/parallel/pipeline_sharded.py`).

  * "data": independent camera streams or frame batches: each data group
    of ranks processes its own frames (`shard` picks them out of a global
    batch, in place of JAX's `NamedSharding`).
  * "space": image-width tiles inside the matcher, with halo and carry
    exchange between the ranks of a space group; each rank of the group
    holds the group's frames at full width (replicated) and matches its own
    tile.

`make_sharded_step` returns `step(left_rgb, right_rgb)` over a rank's
(B, H, W, 3) uint8 frames, which runs the frame program of
`pipeline/engine.py` on each frame, one after another (a loop, as the
reference's `_map_frames`): gray -> rectify (`rectify_pair`, K1; both
views through `remap_grid`, the identity where it is None) -> the matcher
slot chosen by `kind` and `tile_mode` (`exact_sgbm.py`, `tiled_sgbm.py`
or `tiled_bm.py`, whose outputs are replicated over the space group) ->
the per-frame tail (HSV, morphology, `detect_objects` on K2, /16,
reprojection, `calc_depth`). The step returns the reference's dict keys.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rt_depth_map_tpu_torch.config import EngineConfig
from rt_depth_map_tpu_torch.ops.color import in_range, rgb_to_gray, rgb_to_hsv
from rt_depth_map_tpu_torch.ops.cuda.remap import rectify_pair
from rt_depth_map_tpu_torch.ops.detect import detect_objects
from rt_depth_map_tpu_torch.ops.morphology import (
    ellipse_kernel,
    morph_open_close,
    row_segments,
)
from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
from rt_depth_map_tpu_torch.ops.remap import remap_table
from rt_depth_map_tpu_torch.ops.reproject import (
    calc_depth,
    disparity_fixed_to_float,
    reproject_to_3d,
)
from rt_depth_map_tpu_torch.parallel.exact_sgbm import exact_sgbm_tile_program
from rt_depth_map_tpu_torch.parallel.mesh import Mesh
from rt_depth_map_tpu_torch.parallel.tiled_bm import bm_tile_program, check_tiles
from rt_depth_map_tpu_torch.parallel.tiled_sgbm import sgbm_tile_program

MORPH_DX = MORPH_DY = 10


def make_sharded_step(
    mesh: Mesh,
    cfg: EngineConfig,
    image_size: Tuple[int, int],
    Q: Optional[np.ndarray] = None,
    remap_grid: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[Callable, Callable]:
    """(step, shard): step(left_rgb, right_rgb) for this rank's (B, H, W, 3)
    uint8 frames on `device` -> dict of the (B, H, W) disparity, per-frame
    boxes and depth stats; shard(batch) -> this rank's frames of a global
    batch, whose size divides by mesh.shape['data'] (every rank of a data
    group gets the same frames)."""
    W, H = image_size
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_sharded_step(device='cuda'): CUDA is not available")
    mcfg = cfg.matcher
    if mcfg.kind not in ("bm", "sgm"):
        raise ValueError(f"unknown matcher kind {mcfg.kind!r}")
    if mcfg.kind == "bm":
        check_tiles(W, mesh.shape["space"], mcfg)
    if remap_grid is None:
        gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                             np.arange(H, dtype=np.float32))
        remap_grid = np.stack([gx, gy], axis=-1)
    table = remap_table(remap_grid, (H, W), device)
    Qc = torch.as_tensor(np.asarray(Q if Q is not None else np.eye(4), np.float32),
                         device=device)
    segs = row_segments(ellipse_kernel(MORPH_DX, MORPH_DY))
    hsv = cfg.hsv_range()
    hsv_low = torch.tensor(hsv.low, dtype=torch.uint8, device=device)
    hsv_high = torch.tensor(hsv.high, dtype=torch.uint8, device=device)
    min_size = cfg.scaled_min_object_size(W, H)
    n_space = mesh.shape["space"]
    if W % n_space:
        raise ValueError(f"width {W} does not split into {n_space} tiles")
    Wt = W // n_space
    tile = slice(mesh.axis_index("space") * Wt, (mesh.axis_index("space") + 1) * Wt)

    def matcher(lg: torch.Tensor, rg: torch.Tensor) -> torch.Tensor:
        """The matcher slot (the reference's swappable BlockMatcher wiring):
        raw rectified gray for SGM, prefiltered planes for BM, each cut to
        this rank's tile."""
        if mcfg.kind == "sgm":
            if mcfg.tile_mode == "exact":
                return exact_sgbm_tile_program(lg[:, tile], rg[:, tile], mcfg, mesh)
            return sgbm_tile_program(lg[:, tile], rg[:, tile], mcfg, W, mesh)
        lp = xsobel_prefilter(lg, mcfg.pre_filter_cap)
        rp = xsobel_prefilter(rg, mcfg.pre_filter_cap)
        return bm_tile_program(lp[:, tile], rp[:, tile], mcfg, W, mesh)

    def frame(left_rgb: torch.Tensor, right_rgb: torch.Tensor) -> dict:
        lg = rgb_to_gray(left_rgb)
        rg = rgb_to_gray(right_rgb)
        lrect, rgbr, rrect = rectify_pair(lg, left_rgb, rg, table, table)
        disp = matcher(lrect, rrect)
        mask = in_range(rgb_to_hsv(rgbr), hsv_low, hsv_high)
        filt = morph_open_close(mask, segs)
        boxes = detect_objects(filt, min_size, cfg.max_objects)
        dint = disparity_fixed_to_float(disp)
        xyz = reproject_to_3d(dint, Qc, mcfg.min_disparity, True)
        depth_cm, mean_z, count = calc_depth(xyz, filt, boxes,
                                             cfg.calibration_unit_mm)
        return dict(disparity=disp, boxes=boxes, depth_cm=depth_cm,
                    mean_z=mean_z, count=count, mask=filt)

    def step(left_rgb: torch.Tensor, right_rgb: torch.Tensor) -> dict:
        if left_rgb.shape[1:] != (H, W, 3) or right_rgb.shape != left_rgb.shape:
            raise ValueError(f"step: frames {tuple(left_rgb.shape)} and "
                             f"{tuple(right_rgb.shape)}, expected (B, {H}, {W}, 3)")
        outs = [frame(left_rgb[i], right_rgb[i]) for i in range(left_rgb.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def shard(batch):
        """This rank's frames of a global batch (its data group's slice)."""
        nd = mesh.shape["data"]
        if len(batch) % nd:
            raise ValueError(f"batch of {len(batch)} frames over {nd} data groups")
        per = len(batch) // nd
        i = mesh.axis_index("data")
        return batch[i * per: (i + 1) * per]

    return step, shard
