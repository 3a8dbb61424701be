"""Color conversions with OpenCV's 8-bit fixed-point semantics.

Port of `rt_depth_map_tpu/ops/color.py`: RGB->gray, RGB->HSV and the HSV
threshold of the detection path, integer-exact. The HSV `sdiv`/`hdiv`
divisor tables go through float32 division and rounding in the reference;
here they are built once on the host with the same float32 arithmetic, so no
division on the card can flip an entry.
"""

from __future__ import annotations

import numpy as np
import torch

HSV_SHIFT = 12


def _divisor_tables():
    """The 256-entry sdiv[v] and hdiv[diff] tables of color.py:42-45."""
    n = np.maximum(np.arange(256), 1).astype(np.float32)
    sdiv = np.round(np.float32(255 << HSV_SHIFT) / n).astype(np.int32)
    hdiv = np.round(
        np.float32(180 << HSV_SHIFT) / (np.float32(6.0) * n)).astype(np.int32)
    return sdiv, hdiv


SDIV_TABLE, HDIV_TABLE = _divisor_tables()


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) uint8 -> gray (...) uint8, Y = (4899R + 9617G + 1868B
    + 2^13) >> 14."""
    c = rgb.to(torch.int32)
    y = (c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868 + (1 << 13)) >> 14
    return y.to(torch.uint8)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) uint8 -> HSV (..., 3) uint8, OpenCV 8-bit convention."""
    c = rgb.to(torch.int32)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    half = 1 << (HSV_SHIFT - 1)
    sdiv = torch.as_tensor(SDIV_TABLE, device=rgb.device)[v.long()]
    hdiv = torch.as_tensor(HDIV_TABLE, device=rgb.device)[diff.long()]

    s = torch.where(v == 0, 0, (diff * sdiv + half) >> HSV_SHIFT)
    h_raw = torch.where(
        v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h_raw * hdiv + half) >> HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    h = torch.where(diff == 0, 0, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def in_range(img: torch.Tensor, low: torch.Tensor,
             high: torch.Tensor) -> torch.Tensor:
    """cv::inRange: 255 where low <= img <= high on every channel, else 0.
    low/high: (C,) tensors of img's dtype (they may stay on the device)."""
    ok = ((img >= low) & (img <= high)).all(dim=-1)
    return ok.to(torch.uint8) * 255
