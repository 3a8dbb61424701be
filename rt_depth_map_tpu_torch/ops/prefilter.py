"""StereoBM X-Sobel prefilter (OpenCV `prefilterXSobel` parity).

Port of `rt_depth_map_tpu/ops/prefilter.py`:
  d = (s[y-1,x+1]-s[y-1,x-1]) + 2*(s[y,x+1]-s[y,x-1]) + (s[y+1,x+1]-s[y+1,x-1])
  out = clip(d, -cap, cap) + cap
with reflect-101 rows (row -1 -> row 1, row H -> row H-2), replicated
columns, and the first and last columns set to cap.
"""

from __future__ import annotations

import torch


def xsobel_prefilter(img: torch.Tensor, cap: int) -> torch.Tensor:
    """uint8 (H, W) -> uint8 (H, W) prefiltered image."""
    x = img.to(torch.int32)
    H = x.shape[0]
    up = torch.cat([x[1:2], x[:-1]], dim=0)
    down = torch.cat([x[1:], x[H - 2: H - 1]], dim=0)

    def dx(row):
        left = torch.cat([row[:, :1], row[:, :-1]], dim=1)
        right = torch.cat([row[:, 1:], row[:, -1:]], dim=1)
        return right - left

    out = (dx(up) + 2 * dx(x) + dx(down)).clamp(-cap, cap) + cap
    out[:, 0] = cap
    out[:, -1] = cap
    return out.to(torch.uint8)
