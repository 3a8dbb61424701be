"""Connected components by min-propagation over edge masks (K2).

Port of `rt_depth_map_tpu/ops/cc.py`:

- `connected_components_bbox`: 8-connected components of a mask with their
  bounding boxes. Four int32 fields ride one propagation over the edges
  between active pixels: the label (minimum linear index of the component),
  minus the maximum linear index, minx, and minus maxx.
- `connected_components_scan`: labels of the components whose neighbouring
  values differ by at most max_diff (the speckle filter's 4-connected
  value-edge mode).
- `component_small_field` / `component_small`: whether each active pixel's
  component has at most max_size pixels, by the TPU path of the reference
  (`cc.py:360-388`): K7 counts each root's pixels and writes the root's
  decision (0 small, 1 big; `speckle_decision`), which K2 min-propagates to
  its members.

The propagation is K2 (`ops/cuda/cc_sweep.py`), capped at CC_MAX_ROUNDS
sweeps: blob-like masks converge in 2-4, and the cap bounds adversarial
ones, whose components may then split (a subset of the true union, never a
merge); pixels the capped decision broadcast does not reach are not small.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import (
    seg_min_propagate,
    seg_min_propagate_plain,
)
from rt_depth_map_tpu_torch.ops.cuda.histogram import (
    speckle_decision,
    speckle_decision_plain,
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


def _linear_index(H: int, W: int, device) -> torch.Tensor:
    return torch.arange(H * W, dtype=torch.int32, device=device).reshape(H, W)


def value_edges(values: torch.Tensor, active: torch.Tensor, max_diff):
    """(allowed_h, allowed_v): 4-connected edges between active pixels whose
    values differ by at most max_diff."""
    v = values.to(torch.int32)
    allowed_h = (active[:, :-1] & active[:, 1:]
                 & ((v[:, :-1] - v[:, 1:]).abs() <= max_diff))
    allowed_v = (active[:-1, :] & active[1:, :]
                 & ((v[:-1, :] - v[1:, :]).abs() <= max_diff))
    return allowed_h, allowed_v


def connected_components_scan(values: torch.Tensor, active: torch.Tensor,
                              max_diff: int,
                              max_rounds: Optional[int] = CC_MAX_ROUNDS,
                              plain: bool = False,
                              edges: Optional[Tuple] = None) -> torch.Tensor:
    """(H, W) int32 labels (minimum linear index per component) of the
    4-connected components of `active` pixels whose neighbouring values
    differ by at most max_diff; inactive pixels keep their own index.
    edges: `value_edges(values, active, max_diff)` when the caller has it."""
    H, W = values.shape
    if edges is None:
        edges = value_edges(values, active, max_diff)
    allowed_h, allowed_v = edges
    fn = seg_min_propagate_plain if plain else seg_min_propagate
    return fn(_linear_index(H, W, values.device), active.contiguous(),
              allowed_h, allowed_v, max_rounds=max_rounds)


def component_small_field(labels: torch.Tensor, active: torch.Tensor,
                          edges: Tuple, max_size: int,
                          max_rounds: Optional[int] = CC_MAX_ROUNDS,
                          plain: bool = False) -> torch.Tensor:
    """(H, W) int32, 0 where the active pixel's 4-connected component over
    `edges` (`value_edges`, as `connected_components_scan` labelled it) has
    at most max_size pixels: each root's decision (0 small, 1 big, BIG
    elsewhere), min-propagated by K2. The root is its component's minimum,
    so min-propagation hands every member the root's decision."""
    active = active.contiguous()
    decide = speckle_decision_plain if plain else speckle_decision
    field = decide(labels, active, max_size)
    allowed_h, allowed_v = edges
    fn = seg_min_propagate_plain if plain else seg_min_propagate
    return fn(field, active, allowed_h, allowed_v, max_rounds=max_rounds)


def component_small(labels: torch.Tensor, active: torch.Tensor, edges: Tuple,
                    max_size: int, max_rounds: Optional[int] = CC_MAX_ROUNDS,
                    plain: bool = False) -> torch.Tensor:
    """(H, W) bool: the active pixel's 4-connected component over `edges`
    has at most max_size pixels (`component_small_field` == 0)."""
    return active & (component_small_field(labels, active, edges, max_size,
                                           max_rounds, plain) == 0)
