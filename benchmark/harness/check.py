"""The comparison that decides `correct`: the program's FrameResults from the
window against the reference's fields for the same frames.

Each number is the worst over the compared frames:

- disparity_px, mask_px, rgb_rect_px: pixels that differ (exact: limit 0);
- boxes: box entries that differ, count: the largest count difference
  (exact);
- depth_nan: boxes whose depth is NaN on one side only (exact);
- depth_rel: the largest relative gap of depth_cm and mean_z where both
  sides are finite (float32 sums in another order on the program's side).
"""

from __future__ import annotations

import numpy as np

BIG = ("disparity", "mask", "rgb_rect")
SMALL = ("boxes", "count", "depth_cm", "mean_z")


def _differ(a: np.ndarray, b: np.ndarray) -> int:
    """Pixels (leading axes) at which a and b differ; every one where the
    shapes do."""
    if a.shape != b.shape:
        return int(max(a.size, b.size))
    ne = a != b
    return int(ne.any(-1).sum() if ne.ndim == 3 else ne.sum())


def compare(prog: dict, ref: dict) -> dict:
    """Numbers of one frame: prog and ref map field names to numpy arrays;
    fields that prog lacks are not compared."""
    out = {}
    for k in BIG:
        if k in prog:
            out[f"{k}_px"] = _differ(prog[k], ref[k])
    if "boxes" in prog:
        out["boxes"] = _differ(prog["boxes"].reshape(-1), ref["boxes"].reshape(-1))
        pc, rc = prog["count"].astype(np.int64), ref["count"].astype(np.int64)
        out["count"] = int(np.abs(pc - rc).max()) if pc.shape == rc.shape else int(1e9)
        nan, rel = 0, 0.0
        for k in ("depth_cm", "mean_z"):
            p, r = prog[k].astype(np.float64), ref[k].astype(np.float64)
            if p.shape != r.shape:
                nan += max(p.size, r.size)
                continue
            nan += int((np.isnan(p) != np.isnan(r)).sum())
            both = np.isfinite(p) & np.isfinite(r)
            if both.any():
                gap = np.abs(p[both] - r[both]) / np.maximum(np.abs(r[both]), 1e-30)
                rel = max(rel, float(gap.max()))
        out["depth_nan"] = nan
        out["depth_rel"] = rel
    return out


def worst(rows) -> dict:
    """The largest of each number over the frames' rows."""
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, v), v)
    return out


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, number, limit)]): every number within its limit,
    and every limit's number read."""
    rows = [(k, numbers.get(k), limits[k]) for k in limits]
    ok = all(v is not None and v <= lim for _, v, lim in rows)
    return ok, rows
