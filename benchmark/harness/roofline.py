"""The least time a matcher's work can take on the card: the yardstick of
the `*_roofline_pct` metrics.

The least time is the larger of two bounds: the stage's bytes (its inputs
read once, its outputs written once) over the card's memory rate, and its
operations, in 32-bit lane instructions, over the card's lane rate (SMs x
128 lanes x the boost clock: each SM's four schedulers issue one 32-lane
instruction a clock). Operations are counted from the shapes of the plain
formulation, never from the kernels' launches, at the widest SIMD width the
card has for their type (4 bytes a lane: VABSDIFF4; 2 16-bit values: VADD2,
VMNMX2), so that the bound stays a floor.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peak(device_name: str):
    """(bytes a second, lane instructions a second) of the named card, or
    None for a card the table does not hold."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    return p["bytes_per_s"], p["sms"] * p["lanes_per_sm"] * p["boost_clock_hz"]


def lanes(ops: float, elem_bytes: int) -> float:
    """Lane instructions for `ops` operations on `elem_bytes`-byte values."""
    return ops * elem_bytes / 4


def least_s(nbytes: float, lane_ops: float, device_name: str):
    p = peak(device_name)
    if p is None:
        return None
    return max(nbytes / p[0], lane_ops / p[1])


#: SGM operations a (pixel, disparity): the Birchfield-Tomasi cost of both
#: planes (14), the quarter-weight add (2), the block sum's running window
#: (4) and its clamp (1), on 16-bit values
SGM_COST_OPS = 21
#: a (pixel, disparity, path): the two penalised neighbours (2 adds), three
#: minima, the cost added and the path minimum taken off (2), the running
#: minimum for the next pixel (1), on 16-bit values
SGM_PATH_OPS = 8
#: a (pixel, disparity) of the summed costs: the winner's compare and
#: select, the uniqueness product and compare, and the subpixel neighbours'
#: selects, on 32-bit values
SGM_WTA_OPS = 8


def sgm_work(H: int, W: int, D: int, paths: int, min_disp: int = 0):
    """(bytes, lane instructions) of one frame's SGM matcher: the cost
    volume, the path recurrence and the winner-take-all over the matched
    columns W1. Bytes: the two gray views read, and a 16-bit disparity and
    32-bit cost a matched pixel written."""
    W1 = W + min(min_disp, 0) - max(min_disp + D, 0)
    n = H * W1 * D
    ops = (lanes(SGM_COST_OPS * n, 2) + lanes(SGM_PATH_OPS * n * paths, 2)
           + lanes(SGM_WTA_OPS * n, 4))
    return 2 * H * W + 6 * H * W1, ops


#: BM lane instructions a (pixel, disparity): |L - R| on bytes (1 op), the
#: vertical window's add and subtract and the horizontal one's on 16-bit
#: sums (2 + 2), the winner's minimum on 32 bits (1)
def bm_lanes_per_pd(block: int) -> float:
    wide = 2 if block * block * 255 < 2 ** 16 else 4
    return lanes(1, 1) + lanes(2, 2) + lanes(2, wide) + lanes(1, 4)


def bm_region(H: int, W: int, D: int, block: int, roi, min_disp: int = 0):
    """(y0, y1, x0, x1): the pixels StereoBM matches, the window inside the
    rows and the search inside the columns, within ROI1 (x, y, w, h) where
    it is given and not empty."""
    w2 = block // 2
    maxD = min_disp + D - 1
    y0, y1, x0, x1 = w2, H - w2, max(maxD, 0) + w2, W - w2
    if roi is not None and roi[2] * roi[3] > 0:
        x, y, w, h = roi
        x0, x1 = max(x0, max(x, maxD) + w2), min(x1, min(x + w, W) - w2)
        y0, y1 = max(y0, y + w2), min(y1, min(y + h, H) - w2)
    return y0, max(y1, y0), x0, max(x1, x0)


def bm_work(H: int, W: int, D: int, block: int, roi, min_disp: int = 0):
    """(bytes, lane instructions) of one frame's BM matcher inside its
    matching region: the SAD window per (pixel, disparity) there. Bytes:
    the left rows and columns its windows read and the right ones its
    search reads, and a 16-bit disparity and 32-bit cost a pixel written."""
    y0, y1, x0, x1 = bm_region(H, W, D, block, roi, min_disp)
    n = (y1 - y0) * (x1 - x0)
    if n == 0:
        return 0, 0
    rows = y1 - y0 + block - 1
    cols = x1 - x0 + block - 1
    return rows * (2 * cols + D - 1) + 6 * n, n * D * bm_lanes_per_pd(block)
