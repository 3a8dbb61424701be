"""Object boxes from the filtered mask, and the matcher ROI.

Port of `rt_depth_map_tpu/ops/detect.py`: 8-connected components
(findContours RETR_EXTERNAL bounding rects), boxes whose bbox AREA is below
min_size dropped, the first `max_objects` roots in raster order as a fixed
(max_objects, 5) int32 [x, y, w, h, valid] array, and the union bbox of the
valid boxes as the matcher ROI. The roots are picked by one `torch.topk` of
fixed size (the reference's formulation, without its TPU chunking), so the
host never waits for the device here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rt_depth_map_tpu_torch.ops.cc import connected_components_bbox


def detect_objects(mask: torch.Tensor, min_size, max_objects: int,
                   plain: bool = False) -> torch.Tensor:
    """(max_objects, 5) int32 [x, y, w, h, valid] boxes in raster order.

    mask: (H, W) uint8/bool filtered object mask; min_size: minimum bbox area
    (int or 0-d tensor). plain=True runs the CC kernel's plain version."""
    H, W = mask.shape
    active = mask != 0
    labels, maxidx, minx, maxx = connected_components_bbox(active, 8, plain=plain)
    idx = torch.arange(H * W, dtype=torch.int32, device=mask.device)
    labels, maxidx = labels.reshape(-1), maxidx.reshape(-1)
    minx, maxx = minx.reshape(-1), maxx.reshape(-1)
    miny = labels // W
    bw = maxx - minx + 1
    bh = maxidx // W - miny + 1
    keep = active.reshape(-1) & (labels == idx) & (bw * bh >= min_size)
    # the first max_objects roots in raster (== label) order: a top-k of
    # -index over the kept roots, whose size needs no host sync
    none = -(2**30)
    score = torch.where(keep, -idx, none)
    neg, roots = torch.topk(score, max_objects)
    valid = neg != none
    r = torch.where(valid, roots, 0)
    boxes = torch.stack([minx[r], miny[r], bw[r], bh[r],
                         valid.to(torch.int32)], dim=1)
    return torch.where(valid[:, None], boxes, 0)


def matching_region(boxes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Union bbox (x, y, w, h) of the valid boxes, as 0-d int32 tensors that
    stay on the device; (0, 0, 0, 0) when no box is valid."""
    v = boxes[:, 4] > 0
    any_v = v.any()
    hi, lo = 10**6, -(10**6)
    minx = torch.where(v, boxes[:, 0], hi).amin()
    miny = torch.where(v, boxes[:, 1], hi).amin()
    maxx = torch.where(v, boxes[:, 0] + boxes[:, 2], lo).amax()
    maxy = torch.where(v, boxes[:, 1] + boxes[:, 3], lo).amax()
    zero = torch.zeros((), dtype=torch.int32, device=boxes.device)
    return (torch.where(any_v, minx, zero), torch.where(any_v, miny, zero),
            torch.where(any_v, maxx - minx, zero),
            torch.where(any_v, maxy - miny, zero))
