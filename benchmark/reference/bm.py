"""Plain PyTorch block matching with cv::StereoBM's semantics.

The upstream's production matcher (wafgo/rt-depth-map main.cpp:130,
bm-sw.cpp:12-26) as OpenCV computes it: the x-Sobel prefilter clipped to
preFilterCap, the sum of absolute differences over a block, the winner with
the largest d on ties, the texture check, the uniqueness test, the subpixel
step in 1/16 px, the matching region from ROI1 (the union of the detected
boxes), cv::validateDisparity's left-right check, and filterSpeckles.
"""

from __future__ import annotations

import torch

from benchmark.reference.stages import DISP_SCALE, DISP_SHIFT, filter_speckles

#: disparities whose block sums are taken at once
D_CHUNK = 32


def prefilter(img: torch.Tensor, cap: int) -> torch.Tensor:
    """prefilterXSobel of (H, W) uint8: reflect-101 rows, replicated
    columns, the first and last column set to cap; int32."""
    x = img.to(torch.int32)
    H = x.shape[0]
    up = torch.cat([x[1:2], x[:-1]], 0)
    down = torch.cat([x[1:], x[H - 2: H - 1]], 0)

    def dx(r):
        return torch.cat([r[:, 1:], r[:, -1:]], 1) - torch.cat([r[:, :1], r[:, :-1]], 1)

    out = (dx(up) + 2 * dx(x) + dx(down)).clamp(-cap, cap) + cap
    out[:, 0] = cap
    out[:, -1] = cap
    return out


def box_sum(a: torch.Tensor, w: int) -> torch.Tensor:
    """Centred w x w window sums over the first two axes of a (H, W, ...)
    tensor, 0 where the window leaves the image."""
    r = w // 2
    H, W = a.shape[:2]
    c = torch.zeros((H + 1, W + 1) + a.shape[2:], dtype=torch.int64, device=a.device)
    c[1:, 1:] = a.cumsum(0).cumsum(1)
    out = torch.zeros_like(a)
    out[r: H - r, r: W - r] = (c[w:, w:] - c[:-w, w:] - c[w:, :-w] + c[:-w, :-w])
    return out


def _cost(lp, rp, D: int, minD: int, block: int) -> torch.Tensor:
    """(H, W, D) int32 block SADs of disparities minD .. minD + D - 1; the
    difference is 0 where x - d leaves the image."""
    H, W = lp.shape
    out = torch.empty((H, W, D), dtype=torch.int32, device=lp.device)
    xs = torch.arange(W, device=lp.device)
    for i0 in range(0, D, D_CHUNK):
        d = torch.arange(minD + i0, minD + min(i0 + D_CHUNK, D), device=lp.device)
        xr = xs[:, None] - d[None, :]
        inside = (xr >= 0) & (xr < W)
        ad = torch.where(inside, (lp[..., None] - rp[:, xr.clamp(0, W - 1)]).abs(), 0)
        out[..., i0: i0 + len(d)] = box_sum(ad, block)
    return out


def validate(disp: torch.Tensor, cost: torch.Tensor, min_disp: int,
             max_diff: int) -> torch.Tensor:
    """cv::validateDisparity on (H, W): each right pixel takes the x16
    disparity of its least-cost left match (the leftmost on ties); a left
    pixel is invalid where that differs from its own by more than max_diff
    pixels."""
    H, W = disp.shape
    invalid = (min_disp - 1) * DISP_SCALE
    d = disp.to(torch.int64)
    xs = torch.arange(W, device=disp.device).view(1, W)
    x2 = xs - ((d + DISP_SCALE // 2) >> DISP_SHIFT)
    ok = (d != invalid) & (x2 >= 0) & (x2 < W)
    big = torch.iinfo(torch.int64).max
    key = torch.where(ok, cost.to(torch.int64) * W + xs, big)
    keys = torch.full((H, W + 1), big, dtype=torch.int64, device=disp.device)
    keys = keys.scatter_reduce(1, torch.where(ok, x2, W), key, "amin")[:, :W]
    disp2 = torch.where(keys == big, invalid, torch.gather(d, 1, torch.where(keys == big, 0, keys % W)))
    other = torch.gather(disp2, 1, x2.clamp(0, W - 1))
    bad = ok & ((other - d).abs() > max_diff * DISP_SCALE)
    return torch.where(bad, invalid, disp)


def stereo_bm(left: torch.Tensor, right: torch.Tensor, m: dict, roi1=None,
              whole_pixels: bool = False) -> torch.Tensor:
    """(H, W) int16 disparity in 1/16 px of one frame's (H, W) uint8
    rectified gray views; roi1 (x, y, w, h) or None (the full frame).
    whole_pixels drops the subpixel step (the control's lower precision)."""
    H, W = left.shape
    D, minD, bs = m["num_disparities"], m["min_disparity"], m["block_size"]
    cap = m["pre_filter_cap"]
    w2 = bs // 2
    invalid = (minD - 1) * DISP_SCALE
    lp, rp = prefilter(left, cap), prefilter(right, cap)
    cost = _cost(lp, rp, D, minD, bs)
    best = D - 1 - cost.flip(-1).argmin(-1)
    best_cost = torch.gather(cost, -1, best[..., None])[..., 0]
    tex_ok = box_sum((lp - cap).abs(), bs) >= m["texture_threshold"]
    thresh = best_cost + (best_cost * m["uniqueness_ratio"]) // 100
    di = torch.arange(D, device=left.device)
    uniq_bad = (((di - best[..., None]).abs() > 1) & (cost <= thresh[..., None])).any(-1)
    c_p1 = torch.gather(cost, -1, (best + 1).clamp(0, D - 1)[..., None])[..., 0]
    c_m1 = torch.gather(cost, -1, (best - 1).clamp(0, D - 1)[..., None])[..., 0]
    del cost
    c_m1 = torch.where(best == 0, c_p1, c_m1)
    c_p1 = torch.where(best == D - 1, c_m1, c_p1)
    denom = c_m1 + c_p1 - 2 * best_cost + (c_m1 - c_p1).abs()
    num = (c_m1 - c_p1) * 256
    delta = torch.where(denom != 0, torch.sign(num) * torch.div(
        num.abs(), denom.clamp(min=1), rounding_mode="floor"), 0)
    if whole_pixels:
        delta = torch.zeros_like(delta)
    packed = ((best + minD) * 256 + delta + 15) >> 4
    maxD = minD + D - 1
    valid = torch.zeros((H, W), dtype=torch.bool, device=left.device)
    valid[w2: H - w2, max(maxD, 0) + w2: W - w2] = True
    if roi1 is not None and roi1[2] * roi1[3] > 0 and tuple(roi1) != (0, 0, W, H):
        x, y, w, h = roi1
        rxmin, rxmax = max(x, maxD) + w2, min(x + w, W) - w2
        rymin, rymax = y + w2, min(y + h, H) - w2
        region = torch.zeros_like(valid)
        if rxmax > rxmin and rymax > rymin:
            region[rymin:rymax, rxmin:rxmax] = True
        valid &= region
    disp = torch.where(valid & tex_ok & ~uniq_bad, packed, invalid).to(torch.int16)
    if m["disp12_max_diff"] >= 0:
        disp = validate(disp, best_cost, minD, m["disp12_max_diff"])
    if m["speckle_window_size"] > 0 and m["speckle_range"] >= 0:
        disp = filter_speckles(disp[None], invalid, m["speckle_window_size"],
                               m["speckle_range"] * DISP_SCALE)[0]
    return disp
