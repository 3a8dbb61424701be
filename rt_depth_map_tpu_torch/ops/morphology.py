"""Morphological erode/dilate with elliptical structuring elements.

Port of `rt_depth_map_tpu/ops/morphology.py`: opening then closing
(erode -> dilate -> dilate -> erode) with the 10x10 ellipse of the reference.
The footprint is split into per-row horizontal segments relative to the
anchor (kh // 2, kw // 2); each segment is an integer sliding min/max along
the row, and the rows combine with elementwise min/max. Erode pads with 255,
dilate with 0. Integer ops only: a float convolution could run in TF32 on the
card.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ellipse_kernel(width: int, height: int) -> np.ndarray:
    """cv::getStructuringElement(MORPH_ELLIPSE, (width, height)) parity."""
    r = height // 2
    c = width // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((height, width), dtype=np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            t = c * np.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))
            dx = int(np.round(t))  # saturate_cast<int>: round to nearest
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, width)
            kernel[i, j1:j2] = 1
    return kernel


def row_segments(kernel: np.ndarray) -> List[Tuple[int, int, int]]:
    """(dy, dx_left, dx_right) per nonzero kernel row, relative to the
    anchor (kh // 2, kw // 2)."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    segs = []
    for i in range(kh):
        cols = np.nonzero(kernel[i])[0]
        if cols.size:
            segs.append((i - ay, int(cols[0]) - ax, int(cols[-1]) - ax))
    return segs


def _morph(img: torch.Tensor, segs, is_erode: bool) -> torch.Tensor:
    pad_val = 255 if is_erode else 0
    H, W = img.shape
    maxl = max(-dxl for _, dxl, _ in segs)
    maxr = max(dxr for _, _, dxr in segs)
    maxu = max(-dy for dy, _, _ in segs)
    maxd = max(dy for dy, _, _ in segs)
    xp = F.pad(img[None], (maxl, maxr, maxu, maxd), value=pad_val)[0]
    out = None
    for dy, dxl, dxr in segs:
        L = dxr - dxl + 1
        rows = xp[maxu + dy: maxu + dy + H, maxl + dxl: maxl + dxl + W + L - 1]
        win = rows.unfold(1, L, 1)  # (H, W, L): columns x+dxl .. x+dxr
        red = win.amin(-1) if is_erode else win.amax(-1)
        if out is None:
            out = red
        else:
            out = torch.minimum(out, red) if is_erode else torch.maximum(out, red)
    return out


def erode(img: torch.Tensor, segs) -> torch.Tensor:
    """cv::erode parity (min over the footprint), uint8 (H, W)."""
    return _morph(img, segs, True)


def dilate(img: torch.Tensor, segs) -> torch.Tensor:
    """cv::dilate parity (max over the footprint), uint8 (H, W)."""
    return _morph(img, segs, False)


def morph_open_close(img: torch.Tensor, segs) -> torch.Tensor:
    """Opening then closing: erode -> dilate -> dilate -> erode. `segs` are
    the structuring element's `row_segments`."""
    x = erode(img, segs)
    x = dilate(x, segs)
    x = dilate(x, segs)
    return erode(x, segs)
