"""3D reprojection and per-box depth statistics.

Port of `rt_depth_map_tpu/ops/reproject.py`: the reference's
`left_disp /= 16.` (round half to even), cv2.reprojectImageTo3D with
handleMissingValues, and calc_depth's masked mean Z per box. Float outputs
agree with the reference to float32 rounding (sums run in another order);
`count` is exact.
"""

from __future__ import annotations

import torch

DISP_SCALE = 16
MISSING_Z = 10000.0
FLT_EPSILON = 1.1920929e-07


def disparity_fixed_to_float(disp16: torch.Tensor) -> torch.Tensor:
    """int16 x16 map -> integer-valued int16 map, rounded half to even."""
    return torch.round(disp16.to(torch.float32) / DISP_SCALE).to(torch.int16)


def reproject_to_3d(disp: torch.Tensor, Q: torch.Tensor, min_disparity: int = 0,
                    handle_missing: bool = True) -> torch.Tensor:
    """(H, W) integer disparity -> (H, W, 3) float32 XYZ; Q: (4, 4) float32."""
    H, W = disp.shape
    d = disp.to(torch.float32)
    xs = torch.arange(W, dtype=torch.float32, device=disp.device)[None, :]
    ys = torch.arange(H, dtype=torch.float32, device=disp.device)[:, None]

    def row(i):
        return Q[i, 0] * xs + Q[i, 1] * ys + Q[i, 2] * d + Q[i, 3]

    X, Y, Z, Wh = row(0), row(1), row(2), row(3)
    inv = torch.where(Wh != 0, 1.0 / Wh, 0.0)
    Z = Z * inv
    if handle_missing:
        Z = torch.where(disp == min_disparity - 1, MISSING_Z, Z)
    return torch.stack([X * inv, Y * inv, Z], dim=-1)


def calc_depth(xyz: torch.Tensor, mask: torch.Tensor, boxes: torch.Tensor,
               calibration_unit: float):
    """(depth_cm, mean_z, count), each (K,): masked mean Z per valid box,
    NaN where a box is invalid or holds no accepted pixel."""
    H, W = mask.shape
    Z = xyz[..., 2]
    ok = (((Z - MISSING_Z).abs() >= FLT_EPSILON) & (Z.abs() <= 1.0e4)
          & (mask != 0))
    xs = torch.arange(W, device=mask.device)[None, None, :]
    ys = torch.arange(H, device=mask.device)[None, :, None]
    x, y, w, h, valid = (boxes[:, i, None, None] for i in range(5))
    inside = (xs >= x) & (xs < x + w) & (ys >= y) & (ys < y + h) & (valid > 0)
    m = inside & ok[None]
    count = m.sum(dim=(1, 2), dtype=torch.int32)
    s = torch.where(m, Z[None], 0.0).sum(dim=(1, 2))
    mean_z = torch.where(count > 0, s / count.clamp(min=1), float("nan"))
    return mean_z * (calibration_unit / 10.0), mean_z, count
