# Copy of rt_depth_map_tpu/golden/sgbm.py; the port imports nothing of the JAX package.
"""Golden numpy implementation of semi-global matching (cv::StereoSGBM).

Pins the SWSemiGlobalMatcher semantics (reference sgbm-sw.cpp:12-25,
SURVEY.md section 2.9b): Birchfield-Tomasi sampling-insensitive pixel cost on
the clipped x-Sobel response plus quarter-weighted raw-intensity BT, block
window summation with replicated borders, SGM path aggregation
  L_r(p,d) = C(p,d) + min(L_r(p-r,d), L_r(p-r,d+/-1)+P1, min_k L_r(p-r,k)+P2)
             - (min_k L_r(p-r,k) + P2)
over 5 directions (single-pass cv2 MODE_SGBM: four causal + the reverse
within-row horizontal) or 8 (two passes,
MODE_HH), WTA with smallest-d tie-break, SGBM's uniqueness test
(S[d]*(100-ratio) < minS*100 outside best+/-1), parabolic subpixel, inline
cost-based left-right check (floor AND ceil candidates), speckle filter.
Output int16 x16; invalid = (minDisparity-1)*16.

The one difference from the original: `golden_stereo_sgbm` raises
ValueError for a `mode` other than "sgbm", "hh" and "sgbm4", where the
original runs any unknown string as the 4 causal directions.
"""

from __future__ import annotations

import numpy as np

from rt_depth_map_tpu_torch.golden.postproc import golden_filter_speckles

DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
MAX_COST = np.int32(32767)


def _clip_tab(v: np.ndarray, ftzero: int) -> np.ndarray:
    return np.clip(v, -ftzero, ftzero) + ftzero


def sgbm_preprocess(img: np.ndarray, ftzero: int):
    """Per-image (sobel-clipped, raw) planes, OpenCV calcPixelCostBT row prep.

    Row neighbors replicate at top/bottom (n1/s1 = 0 at borders); columns 0
    and width-1 are forced to tab[0] == 0 on both planes.
    """
    x = img.astype(np.int32)
    H, W = x.shape
    up = np.concatenate([x[:1], x[:-1]], axis=0)  # replicate, not reflect
    down = np.concatenate([x[1:], x[-1:]], axis=0)

    def dx(row):
        left = np.concatenate([row[:, :1], row[:, :-1]], axis=1)
        right = np.concatenate([row[:, 1:], row[:, -1:]], axis=1)
        return right - left

    sob = 2 * dx(x) + dx(up) + dx(down)
    sob = _clip_tab(sob, ftzero)
    sob[:, 0] = 0
    sob[:, -1] = 0
    raw = x.copy()
    raw[:, 0] = 0
    raw[:, -1] = 0
    return sob, raw


def _bt_cost_plane(pl: np.ndarray, pr: np.ndarray, min_disp: int, num_disp: int):
    """BT cost for one plane: (H, W, D) int32; cost defined for
    x in [minX1, maxX1), else 0."""
    H, W = pl.shape
    maxD = min_disp + num_disp

    def halfpix(p):
        left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
        right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        al = (p + left) // 2
        ar = (p + right) // 2
        # at column borders OpenCV uses v itself for the missing side
        al[:, 0] = p[:, 0]
        ar[:, -1] = p[:, -1]
        mn = np.minimum(p, np.minimum(al, ar))
        mx = np.maximum(p, np.maximum(al, ar))
        return mn, mx

    u0, u1 = halfpix(pl)
    v0, v1 = halfpix(pr)
    cost = np.zeros((H, W, num_disp), dtype=np.int32)
    for i in range(num_disp):
        d = min_disp + i
        # left x matches right x-d; only x-d in [0, W) contributes
        if d >= 0:
            sl = slice(d, W)
            sr = slice(0, W - d)
        else:
            sl = slice(0, W + d)
            sr = slice(-d, W)
        u = pl[:, sl]
        c0 = np.maximum(0, np.maximum(u - v1[:, sr], v0[:, sr] - u))
        v = pr[:, sr]
        c1 = np.maximum(0, np.maximum(v - u1[:, sl], u0[:, sl] - v))
        cost[:, sl, i] = np.minimum(c0, c1)
    return cost


def sgbm_cost_volume(
    left: np.ndarray,
    right: np.ndarray,
    num_disp: int,
    block_size: int,
    min_disp: int = 0,
    pre_filter_cap: int = 0,
):
    """Windowed pixel cost C: (H, width1, D) int32, where
    width1 = maxX1 - minX1 and column j corresponds to image x = j + minX1.
    Window sums replicate-clamp at both the x range and the image rows."""
    ftzero = max(pre_filter_cap, 15) | 1
    H, W = left.shape
    # OpenCV: maxD = minD + numDisparities (exclusive); minX1 = max(maxD, 0)
    minX1 = max(min_disp + num_disp, 0)
    maxX1 = W + min(min_disp, 0)
    width1 = maxX1 - minX1

    ls, lr = sgbm_preprocess(left, ftzero)
    rs, rr = sgbm_preprocess(right, ftzero)
    pix = _bt_cost_plane(ls, rs, min_disp, num_disp) + (
        _bt_cost_plane(lr, rr, min_disp, num_disp) >> 2
    )
    pix = pix[:, minX1:maxX1]  # (H, width1, D)

    sw2 = block_size // 2
    # horizontal replicated window sum over the width1 axis
    xs = np.arange(width1)
    acc = np.zeros_like(pix)
    for dxo in range(-sw2, sw2 + 1):
        acc += pix[:, np.clip(xs + dxo, 0, width1 - 1)]
    # vertical replicated window sum over rows
    ys = np.arange(H)
    out = np.zeros_like(acc)
    for dyo in range(-sw2, sw2 + 1):
        out += acc[np.clip(ys + dyo, 0, H - 1)]
    return out, minX1, width1


def _aggregate_dir(C: np.ndarray, p1: int, p2: int, dy: int, dx: int):
    """One-direction SGM aggregation over C (H, W1, D) -> L (H, W1, D).

    Previous pixel is (y-dy, x-dx); out-of-range previous => Lp = 0,
    minLp = 0 (OpenCV border initialization).
    """
    H, W1, D = C.shape
    L = np.zeros_like(C)

    def step(Crow, Lp, minLp):
        # Crow, Lp: (N, D); minLp: (N, 1)
        lm = np.concatenate([np.full((Lp.shape[0], 1), MAX_COST), Lp[:, :-1]], axis=1)
        lp_ = np.concatenate([Lp[:, 1:], np.full((Lp.shape[0], 1), MAX_COST)], axis=1)
        delta = minLp + p2
        m = np.minimum(np.minimum(Lp, lm + p1), np.minimum(lp_ + p1, delta))
        return Crow + m - delta

    if dy == 0:
        # horizontal scan along x, in the direction of travel (prev = x - dx
        # must already be computed, so dx=-1 scans right-to-left)
        for x in (range(W1) if dx > 0 else range(W1 - 1, -1, -1)):
            if x - dx < 0 or x - dx >= W1:
                Lp = np.zeros((H, D), dtype=C.dtype)
            else:
                Lp = L[:, x - dx]
            minLp = Lp.min(axis=1, keepdims=True) if x - dx >= 0 and x - dx < W1 else np.zeros((H, 1), dtype=C.dtype)
            L[:, x] = step(C[:, x], Lp, minLp)
        return L

    ys = range(H) if dy > 0 else range(H - 1, -1, -1)
    for y in ys:
        py = y - dy
        if py < 0 or py >= H:
            Lp = np.zeros((W1, D), dtype=C.dtype)
            minLp = np.zeros((W1, 1), dtype=C.dtype)
        else:
            Lprev = L[py]  # (W1, D)
            if dx == 0:
                Lp = Lprev
            elif dx > 0:
                Lp = np.concatenate(
                    [np.zeros((dx, D), dtype=C.dtype), Lprev[:-dx]], axis=0
                )
            else:
                Lp = np.concatenate(
                    [Lprev[-dx:], np.zeros((-dx, D), dtype=C.dtype)], axis=0
                )
            minLp = Lp.min(axis=1, keepdims=True)
            if dx > 0:
                minLp[:dx] = 0
            elif dx < 0:
                minLp[dx:] = 0
        L[y] = step(C[y], Lp, minLp)
    return L


_DIRS_PASS1 = [(0, 1), (1, 1), (1, 0), (1, -1)]  # W, NW, N, NE (prev offsets)
_DIRS_PASS2 = [(0, -1), (-1, -1), (-1, 0), (-1, 1)]  # E, SE, S, SW
MODES = ("sgbm", "hh", "sgbm4")


def golden_stereo_sgbm(
    left: np.ndarray,
    right: np.ndarray,
    num_disparities: int,
    block_size: int = 5,
    min_disparity: int = 0,
    p1: int = 8 * 3 * 5 * 5,
    p2: int = 32 * 3 * 5 * 5,
    uniqueness_ratio: int = 10,
    speckle_window_size: int = 100,
    speckle_range: int = 32,
    disp12_max_diff: int = 1,
    pre_filter_cap: int = 0,
    mode: str = "sgbm",  # "sgbm" (5 paths, cv2 default single-pass:
    # both horizontal + up-left/up/up-right) | "hh" (8 paths, MODE_HH)
    # | "sgbm4" (the 4 causal directions only -- kept for the tiled/
    # sharded direction-family tests)
):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    H, W = left.shape
    D = num_disparities
    minD = min_disparity
    INVALID = (minD - 1) * DISP_SCALE
    p2 = max(p2, p1 + 1)

    C, minX1, width1 = sgbm_cost_volume(
        left, right, D, block_size, minD, pre_filter_cap
    )

    # cv2's single-pass MODE_SGBM aggregates FIVE directions -- the four
    # causal ones plus the right-to-left horizontal (OpenCV sgbm.cpp's
    # extra within-row reverse scan; the docs' "5 directions"). Measured:
    # the 4-dir model diverged 2.2% from cv2 on occlusion-heavy scenes,
    # the 5-dir model 0.43% (HARVEST_R5.txt section 5).
    dirs = list(_DIRS_PASS1)
    if mode == "sgbm":
        dirs += [(0, -1)]
    elif mode == "hh":
        dirs += list(_DIRS_PASS2)
    S = np.zeros_like(C)
    for dy, dx in dirs:
        S += _aggregate_dir(C, p1, p2, dy, dx)

    # WTA: ties -> smallest d
    best = np.argmin(S, axis=2)
    minS = np.take_along_axis(S, best[..., None], axis=2)[..., 0]

    # uniqueness (SGBM form)
    di = np.arange(D)
    outside = np.abs(di[None, None, :] - best[..., None]) > 1
    bad_uniq = np.any(
        outside & (S * (100 - uniqueness_ratio) < minS[..., None] * 100), axis=2
    )

    # subpixel
    bi = best
    has_nb = (bi > 0) & (bi < D - 1)
    sm = np.take_along_axis(S, np.clip(bi - 1, 0, D - 1)[..., None], axis=2)[..., 0]
    sp = np.take_along_axis(S, np.clip(bi + 1, 0, D - 1)[..., None], axis=2)[..., 0]
    denom2 = np.maximum(sm + sp - 2 * minS, 1)
    num = (sm - sp) * DISP_SCALE + denom2
    sub = np.sign(num) * (np.abs(num) // (denom2 * 2))
    dval = np.where(has_nb, bi * DISP_SCALE + sub, bi * DISP_SCALE)
    dval = dval + minD * DISP_SCALE

    disp = np.where(bad_uniq, INVALID, dval).astype(np.int16)
    # restrict to the computed x range
    full = np.full((H, W), INVALID, dtype=np.int16)
    full[:, minX1 : minX1 + width1] = disp
    disp = full

    if disp12_max_diff >= 0:
        # inline LR check: disp2 built from integer bestDisp with minS cost
        for y in range(H):
            disp2 = np.full(W, INVALID, dtype=np.int32)
            disp2cost = np.full(W, np.iinfo(np.int32).max, dtype=np.int64)
            for j in range(width1):
                x = j + minX1
                if disp[y, x] == INVALID:
                    continue
                d_int = int(best[y, j]) + minD
                x2 = x - d_int
                if 0 <= x2 < W and disp2cost[x2] > minS[y, j]:
                    disp2cost[x2] = minS[y, j]
                    disp2[x2] = d_int
            for j in range(width1):
                x = j + minX1
                d1 = int(disp[y, x])
                if d1 == INVALID:
                    continue
                _d = d1 >> DISP_SHIFT
                d_ = (d1 + DISP_SCALE - 1) >> DISP_SHIFT
                _x = x - _d
                x_ = x - d_
                if (
                    0 <= _x < W
                    and disp2[_x] >= minD
                    and abs(disp2[_x] - _d) > disp12_max_diff
                    and 0 <= x_ < W
                    and disp2[x_] >= minD
                    and abs(disp2[x_] - d_) > disp12_max_diff
                ):
                    disp[y, x] = INVALID
    if speckle_window_size > 0 and speckle_range >= 0:
        disp = golden_filter_speckles(
            disp, INVALID, speckle_window_size, speckle_range * DISP_SCALE
        )
    return disp
