"""8-connected components with their bounding boxes, by min-propagation.

Port of `rt_depth_map_tpu/ops/cc.py` `connected_components_bbox`. Four int32
fields ride one propagation over the edges between active pixels: the label
(minimum linear index of the component), minus the maximum linear index,
minx, and minus maxx. The propagation is K2 (`ops/cuda/cc_sweep.py`), capped
at CC_MAX_ROUNDS sweeps: blob-like masks converge in 2-4, and the cap bounds
adversarial ones, whose components may then split (a subset of the true
union, never a merge).
"""

from __future__ import annotations

from typing import Optional

import torch

from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import (
    seg_min_propagate,
    seg_min_propagate_plain,
)

#: propagation sweeps before the loop stops (the reference's default cap)
CC_MAX_ROUNDS = 16


def connected_components_bbox(active: torch.Tensor, connectivity: int = 8,
                              max_rounds: Optional[int] = CC_MAX_ROUNDS,
                              plain: bool = False):
    """(labels, maxidx, minx, maxx), each (H, W) int32, for the components of
    the bool mask `active`; inactive pixels hold their own values.

    plain=True runs K2's plain PyTorch version on any device."""
    H, W = active.shape
    dev = active.device
    ys = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, :].expand(H, W)
    idx = ys * W + xs
    init = torch.stack([idx, -idx, xs, -xs]).contiguous()

    allowed_h = active[:, :-1] & active[:, 1:]
    allowed_v = active[:-1, :] & active[1:, :]
    se = sw = None
    if connectivity == 8:
        se = active[:-1, :-1] & active[1:, 1:]
        sw = active[:-1, 1:] & active[1:, :-1]
    fn = seg_min_propagate_plain if plain else seg_min_propagate
    # the edge masks are fresh (contiguous) results of `&`
    out = fn(init, active.contiguous(), allowed_h, allowed_v, se, sw,
             max_rounds=max_rounds)
    return out[0], -out[1], out[2], -out[3]
