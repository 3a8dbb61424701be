"""Speckle filter: invalidate small connected regions of similar disparity.

Port of `rt_depth_map_tpu/ops/speckle.py` `filter_speckles`
(cv::filterSpeckles parity): 4-connected components where neighbouring
pixels differ by at most max_diff; the pixels of components with at most
max_size pixels become new_val. The labels and the size decision follow the
reference's TPU path: K2 propagation (`connected_components_scan`), K7
counts and a K2 broadcast of each root's decision (`component_small`), both
propagations capped at CC_MAX_ROUNDS sweeps. Where propagation converges
within the cap, which covers real scenes, the result equals cv2's. Under the
cap a label covers part of its true component, so its count can only fall
and the decision moves toward more invalidation wherever the capped
broadcast reaches; pixels beyond its reach keep their value.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cc import (
    component_small,
    connected_components_scan,
    value_edges,
)


def filter_speckles(disp: torch.Tensor, new_val: int, max_size: int,
                    max_diff: int, plain: bool = False) -> torch.Tensor:
    """(H, W) int16 disparity (x16 units) with the small components set to
    new_val. plain=True runs the kernels' plain versions."""
    active = disp != new_val
    edges = value_edges(disp, active, max_diff)
    labels = connected_components_scan(disp, active, max_diff, plain=plain,
                                       edges=edges)
    small = component_small(labels, active, edges, max_size, plain=plain)
    return torch.where(small, torch.full_like(disp, new_val), disp)
