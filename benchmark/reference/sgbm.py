"""Plain PyTorch semi-global matching with cv::StereoSGBM's semantics.

The upstream's matcher (wafgo/rt-depth-map sgbm-sw.cpp:12-24) as OpenCV
computes it: the Birchfield-Tomasi cost of the clipped x-Sobel plane plus a
quarter of the raw plane's, summed over a block with replicated borders;
the path recurrence

    L_r(p, d) = C(p, d) + min(L_r(p - r, d), L_r(p - r, d +- 1) + P1,
                              min_k L_r(p - r, k) + P2) - (min_k L_r(p - r, k) + P2)

over 8 paths (MODE_HH), 5 (MODE_SGBM) or the 4 causal ones; winner-take-all
with the smallest d on ties, SGBM's uniqueness test, the parabolic subpixel
step in 1/16 px, the inline left-right check on both rounded candidates, and
filterSpeckles. Every frame of a (B, H, W) batch is matched at once; each
path direction advances one row or column a step over the whole batch.
"""

from __future__ import annotations

import torch

from benchmark.reference.stages import DISP_SCALE, DISP_SHIFT, filter_speckles

MAX_COST = 32767


def _planes(img: torch.Tensor, ftzero: int):
    """(sobel, raw) int32 planes of (B, H, W) uint8: the x-Sobel clipped to
    [-ftzero, ftzero] + ftzero with replicated rows, both planes 0 in the
    first and last column."""
    x = img.to(torch.int32)
    up = torch.cat([x[:, :1], x[:, :-1]], 1)
    down = torch.cat([x[:, 1:], x[:, -1:]], 1)

    def dx(r):
        return torch.cat([r[..., 1:], r[..., -1:]], -1) - torch.cat([r[..., :1], r[..., :-1]], -1)

    sob = (2 * dx(x) + dx(up) + dx(down)).clamp(-ftzero, ftzero) + ftzero
    raw = x.clone()
    for p in (sob, raw):
        p[..., 0] = 0
        p[..., -1] = 0
    return sob, raw


def _halfpix(p: torch.Tensor):
    """(min, max) of a pixel and its half-way points to both neighbours."""
    al = (p + torch.cat([p[..., :1], p[..., :-1]], -1)) // 2
    ar = (p + torch.cat([p[..., 1:], p[..., -1:]], -1)) // 2
    al[..., 0] = p[..., 0]
    ar[..., -1] = p[..., -1]
    return (torch.minimum(p, torch.minimum(al, ar)),
            torch.maximum(p, torch.maximum(al, ar)))


def _bt(pl, pr, cols, dsp):
    """Birchfield-Tomasi cost (H, W1, D) of one frame's plane pair at the
    left columns `cols` (W1,) and disparities `dsp` (D,): 0 where the right
    column x - d leaves the image."""
    W = pl.shape[-1]
    u0, u1 = _halfpix(pl)
    v0, v1 = _halfpix(pr)
    xr = cols[:, None] - dsp[None, :]
    inside = (xr >= 0) & (xr < W)
    xr = xr.clamp(0, W - 1)
    u, lu0, lu1 = (t[:, cols][..., None] for t in (pl, u0, u1))
    v, rv0, rv1 = (t[:, xr] for t in (pr, v0, v1))
    c0 = torch.clamp(torch.maximum(u - rv1, rv0 - u), min=0)
    c1 = torch.clamp(torch.maximum(v - lu1, lu0 - v), min=0)
    return torch.where(inside, torch.minimum(c0, c1), 0)


def cost_volume(left: torch.Tensor, right: torch.Tensor, D: int, block: int,
                min_disp: int, pre_filter_cap: int):
    """(C (B, H, W1, D) int32, minX1, W1): the block sums of the pixel cost
    over the columns [minX1, minX1 + W1), replicated at that range's and at
    the image's borders."""
    ftzero = max(pre_filter_cap, 15) | 1
    B, H, W = left.shape
    minX1 = max(min_disp + D, 0)
    W1 = W + min(min_disp, 0) - minX1
    dev = left.device
    cols = torch.arange(minX1, minX1 + W1, device=dev)
    dsp = torch.arange(min_disp, min_disp + D, device=dev)
    ls, lr = _planes(left, ftzero)
    rs, rr = _planes(right, ftzero)
    r = block // 2
    xs = torch.arange(W1, device=dev)
    ys = torch.arange(H, device=dev)
    out = torch.empty((B, H, W1, D), dtype=torch.int32, device=dev)
    for b in range(B):
        pix = _bt(ls[b], rs[b], cols, dsp) + (_bt(lr[b], rr[b], cols, dsp) >> 2)
        acc = sum(pix[:, (xs + o).clamp(0, W1 - 1)] for o in range(-r, r + 1))
        out[b] = sum(acc[(ys + o).clamp(0, H - 1)] for o in range(-r, r + 1))
    return out, minX1, W1


def _step(Cs, Lp, minLp, p1, p2):
    """One recurrence step: Cs, Lp (..., D), minLp (...)."""
    big = torch.full_like(Lp[..., :1], MAX_COST)
    lm = torch.cat([big, Lp[..., :-1]], -1)
    lp = torch.cat([Lp[..., 1:], big], -1)
    delta = (minLp + p2)[..., None]
    m = torch.minimum(torch.minimum(Lp, lm + p1), torch.minimum(lp + p1, delta))
    return Cs + m - delta


def _shift_x(t: torch.Tensor, dx: int) -> torch.Tensor:
    """out[..., x, :] = t[..., x - dx, :] along the pixel axis -2, 0 outside."""
    if dx == 0:
        return t
    out = torch.zeros_like(t)
    if dx > 0:
        out[..., dx:, :] = t[..., :-dx, :]
    else:
        out[..., :dx, :] = t[..., -dx:, :]
    return out


def _vertical(C, S, dy: int, dxs, p1, p2) -> None:
    """Adds to S the paths whose previous pixel is (y - dy, x - dx), one
    per dx, all advancing a row at a time."""
    B, H, W1, D = C.shape
    K = len(dxs)
    L = torch.zeros((B, K, W1, D), dtype=C.dtype, device=C.device)
    first = True
    for y in (range(H) if dy > 0 else range(H - 1, -1, -1)):
        if first:
            Lp = torch.zeros_like(L)
            minLp = torch.zeros(L.shape[:-1], dtype=C.dtype, device=C.device)
            first = False
        else:
            Lp = torch.stack([_shift_x(L[:, k], dx) for k, dx in enumerate(dxs)], 1)
            minLp = Lp.amin(-1)
        L = _step(C[:, y][:, None], Lp, minLp, p1, p2)
        S[:, y] += L.sum(1)


def _horizontal(C, S, dxs, p1, p2) -> None:
    """Adds to S the row paths: dx = 1 left to right, dx = -1 right to
    left, both advancing a column at a time."""
    B, H, W1, D = C.shape
    L = None
    for i in range(W1):
        xs = [i if dx > 0 else W1 - 1 - i for dx in dxs]
        Cs = torch.stack([C[:, :, x] for x in xs], 1)
        if L is None:
            Lp = torch.zeros_like(Cs)
            minLp = torch.zeros(Cs.shape[:-1], dtype=C.dtype, device=C.device)
        else:
            Lp, minLp = L, L.amin(-1)
        L = _step(Cs, Lp, minLp, p1, p2)
        for k, x in enumerate(xs):
            S[:, :, x] += L[:, k]


def aggregate(C: torch.Tensor, p1: int, p2: int, num_paths: int) -> torch.Tensor:
    """(B, H, W1, D) int32 sum of the path costs: the four causal paths
    (left to right, and from the row above: up-left, up, up-right), plus the
    right-to-left path for 5, or the four mirrored paths for 8."""
    S = torch.zeros_like(C)
    _horizontal(C, S, (1, -1) if num_paths >= 5 else (1,), p1, p2)
    _vertical(C, S, 1, (1, 0, -1), p1, p2)
    if num_paths >= 8:
        _vertical(C, S, -1, (-1, 0, 1), p1, p2)
    return S


def lr_check(disp, best, minS, minX1: int, min_disp: int, max_diff: int):
    """The inline left-right check: each right pixel takes the integer
    disparity of its least-cost left match (the leftmost on ties); a left
    pixel is invalid where both its floor and ceil candidates see a right
    disparity that differs by more than max_diff."""
    B, H, W = disp.shape
    W1 = best.shape[-1]
    invalid = (min_disp - 1) * DISP_SCALE
    dev = disp.device
    j = torch.arange(W1, device=dev).view(1, 1, W1)
    win = disp[..., minX1: minX1 + W1] != invalid
    d_int = best + min_disp
    x2 = j + minX1 - d_int
    ok = win & (x2 >= 0) & (x2 < W)
    big = torch.iinfo(torch.int64).max
    key = torch.where(ok, minS.to(torch.int64) * W1 + j, big)
    slot = torch.where(ok, x2, W)  # column W collects the discarded keys
    keys = torch.full((B, H, W + 1), big, dtype=torch.int64, device=dev)
    keys = keys.scatter_reduce(2, slot, key, "amin")[..., :W]
    wj = torch.where(keys == big, 0, keys % W1)
    disp2 = torch.where(keys == big, invalid, torch.gather(d_int, 2, wj))
    d1 = disp.to(torch.int64)
    xs = torch.arange(W, device=dev).view(1, 1, W)

    def far(dd):
        xx = xs - dd
        inr = (xx >= 0) & (xx < W)
        other = torch.gather(disp2, 2, xx.clamp(0, W - 1))
        return inr & (other >= min_disp) & ((other - dd).abs() > max_diff)

    bad = (d1 != invalid) & far(d1 >> DISP_SHIFT) & far((d1 + DISP_SCALE - 1) >> DISP_SHIFT)
    return torch.where(bad, invalid, disp)


def stereo_sgbm(left: torch.Tensor, right: torch.Tensor, m: dict,
                whole_pixels: bool = False) -> torch.Tensor:
    """(B, H, W) int16 disparities in 1/16 px of (B, H, W) uint8 rectified
    gray views under the matcher settings `m`. whole_pixels drops the
    subpixel step (the control's lower precision)."""
    B, H, W = left.shape
    D, minD = m["num_disparities"], m["min_disparity"]
    p1 = m["p1"]
    p2 = max(m["p2"], p1 + 1)
    invalid = (minD - 1) * DISP_SCALE
    C, minX1, W1 = cost_volume(left, right, D, m["block_size"], minD, m["pre_filter_cap"])
    S = aggregate(C, p1, p2, m["num_paths"])
    del C
    best = S.argmin(-1)
    minS = torch.gather(S, -1, best[..., None])[..., 0]
    di = torch.arange(D, device=S.device)
    ur = m["uniqueness_ratio"]
    outside = (di - best[..., None]).abs() > 1
    bad_uniq = (outside & (S * (100 - ur) < minS[..., None] * 100)).any(-1)
    sm = torch.gather(S, -1, (best - 1).clamp(0, D - 1)[..., None])[..., 0]
    sp = torch.gather(S, -1, (best + 1).clamp(0, D - 1)[..., None])[..., 0]
    del S
    denom2 = torch.clamp(sm + sp - 2 * minS, min=1)
    num = (sm - sp) * DISP_SCALE + denom2
    sub = torch.sign(num) * torch.div(num.abs(), denom2 * 2, rounding_mode="floor")
    has_nb = (best > 0) & (best < D - 1)
    dval = torch.where(has_nb & (not whole_pixels), best * DISP_SCALE + sub,
                       best * DISP_SCALE) + minD * DISP_SCALE
    disp = torch.full((B, H, W), invalid, dtype=torch.int16, device=left.device)
    disp[..., minX1: minX1 + W1] = torch.where(bad_uniq, invalid, dval).to(torch.int16)
    if m["disp12_max_diff"] >= 0:
        disp = lr_check(disp, best, minS, minX1, minD, m["disp12_max_diff"])
    if m["speckle_window_size"] > 0 and m["speckle_range"] >= 0:
        disp = filter_speckles(disp, invalid, m["speckle_window_size"],
                               m["speckle_range"] * DISP_SCALE)
    return disp
