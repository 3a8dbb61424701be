"""The reference frame: every field of the program's FrameResult, worked out
again in plain PyTorch from the raw views, the float rectification maps, Q
and the configuration's settings (the upstream's frame, estimator.cpp:18-82).
"""

from __future__ import annotations

import torch

from benchmark.reference import bm, sgbm, stages

#: the upstream's morphology footprint (mf-sw.h:11-12)
MORPH_SIZE = 10


def reference_frames(lefts: torch.Tensor, rights: torch.Tensor, scene: dict,
                     config: dict, control=()) -> dict:
    """Fields of the (B, H, W, 3) uint8 raw view pairs, each with a leading
    B: disparity, boxes, depth_cm, mean_z, count, mask, rgb_rect.

    scene: grid_left, grid_right ((H, W, 2) float32 source coordinates) and
    Q. control: the parts computed in the precision below the
    configuration's, "whole_pixels" (disparities without the subpixel step)
    and "bfloat16" (the reprojection and the depth means)."""
    eng, m = config["engine"], config["matcher"]
    B, H, W, _ = lefts.shape
    dev = lefts.device
    tl = stages.fixed_point_map(scene["grid_left"], (H, W), dev)
    tr = stages.fixed_point_map(scene["grid_right"], (H, W), dev)
    lrect = stages.remap(stages.gray(lefts)[..., None], tl)[..., 0]
    rrect = stages.remap(stages.gray(rights)[..., None], tr)[..., 0]
    rgb_rect = stages.remap(lefts, tl)
    rng = config["hsv_range"]
    mask = stages.in_range(stages.hsv(rgb_rect), rng["low"], rng["high"])
    mask = stages.open_close(mask, stages.ellipse(MORPH_SIZE, MORPH_SIZE))
    boxes = stages.detect(mask, eng["minimal_object_size"], eng["max_objects"])
    if m["kind"] == "sgm":
        disp = sgbm.stereo_sgbm(lrect, rrect, m, whole_pixels="whole_pixels" in control)
    else:
        disp = torch.stack([
            bm.stereo_bm(lrect[b], rrect[b], m, stages.matching_region(boxes[b]),
                         whole_pixels="whole_pixels" in control) for b in range(B)])
    depth_cm, mean_z, count = stages.depth(
        disp, mask, boxes, scene["Q"], eng["calibration_unit_mm"], m["min_disparity"],
        dtype=torch.bfloat16 if "bfloat16" in control else torch.float32)
    return dict(disparity=disp, boxes=boxes, depth_cm=depth_cm, mean_z=mean_z,
                count=count, mask=mask, rgb_rect=rgb_rect)
