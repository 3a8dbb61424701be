"""Speckle filter: invalidate small connected regions of similar disparity.

Port of `rt_depth_map_tpu/ops/speckle.py` `filter_speckles`
(cv::filterSpeckles parity): 4-connected components where neighbouring
pixels differ by at most max_diff; the pixels of components with at most
max_size pixels become new_val. The labels and the size decision follow the
reference's TPU path: K2 propagation (`connected_components_scan`), K7's
counts and each root's decision in one entry (`speckle_decision`), a K2
broadcast of the decisions (`component_small_field`), both propagations
capped at CC_MAX_ROUNDS sweeps, and one elementwise launch that writes the
result (`speckle_apply`). Where propagation converges
within the cap, which covers real scenes, the result equals cv2's. Under the
cap a label covers part of its true component, so its count can only fall
and the decision moves toward more invalidation wherever the capped
broadcast reaches; pixels beyond its reach keep their value.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cc import (
    component_small_field,
    connected_components_scan,
    value_edges,
)
from rt_depth_map_tpu_torch.ops.cuda.histogram import (
    speckle_apply,
    speckle_apply_plain,
)


def filter_speckles(disp: torch.Tensor, new_val: int, max_size: int,
                    max_diff: int, plain: bool = False) -> torch.Tensor:
    """(H, W) int16 disparity (x16 units) with the small components set to
    new_val. plain=True runs the kernels' plain versions."""
    active = disp != new_val
    edges = value_edges(disp, active, max_diff)
    labels = connected_components_scan(disp, active, max_diff, plain=plain,
                                       edges=edges)
    field = component_small_field(labels, active, edges, max_size, plain=plain)
    return (speckle_apply_plain if plain else speckle_apply)(disp, field, new_val)
