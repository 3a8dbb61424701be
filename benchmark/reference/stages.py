"""Plain PyTorch stages of the reference frame, on any device.

Written from OpenCV's documented 8-bit semantics, as the upstream
(wafgo/rt-depth-map, estimator.cpp:18-82) calls them: cvtColor to gray and
to HSV, remap with CV_16SC2 fixed-point maps, inRange, morphologyEx open
then close with a 10x10 ellipse, the external contours' bounding boxes,
filterSpeckles, reprojectImageTo3D and the per-box mean depth. Nothing here
imports the program under test; every table is worked out again from the
float maps, Q and the thresholds that the harness hands to both sides.

Frames are batched: images are (B, H, W[, C]) tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

HSV_SHIFT = 12
DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
MISSING_Z = 10000.0
FLT_EPSILON = 1.1920929e-07


def gray(rgb: torch.Tensor) -> torch.Tensor:
    """cvtColor(RGB2GRAY): Y = (4899 R + 9617 G + 1868 B + 2^13) >> 14."""
    c = rgb.to(torch.int32)
    y = (c[..., 0] * 4899 + c[..., 1] * 9617 + c[..., 2] * 1868 + (1 << 13)) >> 14
    return y.to(torch.uint8)


def _hsv_tables(device):
    """OpenCV's sdiv and hdiv tables (float32 division, then rounding)."""
    n = np.maximum(np.arange(256), 1).astype(np.float32)
    sdiv = np.round(np.float32(255 << HSV_SHIFT) / n).astype(np.int32)
    hdiv = np.round(np.float32(180 << HSV_SHIFT) / (np.float32(6.0) * n)).astype(np.int32)
    return torch.as_tensor(sdiv, device=device), torch.as_tensor(hdiv, device=device)


def hsv(rgb: torch.Tensor) -> torch.Tensor:
    """cvtColor(RGB2HSV), 8-bit: H in [0, 180)."""
    c = rgb.to(torch.int32)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    sdiv, hdiv = _hsv_tables(rgb.device)
    half = 1 << (HSV_SHIFT - 1)
    s = torch.where(v == 0, 0, (diff * sdiv[v.long()] + half) >> HSV_SHIFT)
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff.long()] + half) >> HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    h = torch.where(diff == 0, 0, h)
    return torch.stack([h, s, v], dim=-1)


def in_range(img: torch.Tensor, low, high) -> torch.Tensor:
    """inRange: 255 where low <= img <= high on every channel."""
    lo = torch.as_tensor(low, device=img.device)
    hi = torch.as_tensor(high, device=img.device)
    return ((img >= lo) & (img <= hi)).all(-1).to(torch.uint8) * 255


def fixed_point_map(grid: np.ndarray, src_hw, device):
    """convertMaps to CV_16SC2 + the 1/32 interpolation table index, in
    float32: floor, round half to even to 1/32 px, carry into the integer
    part. Returns (ix, iy, fx, fy, valid) tensors."""
    H, W = src_hw
    g = np.asarray(grid, np.float32)
    mx, my = g[..., 0], g[..., 1]
    flx, fly = np.floor(mx), np.floor(my)
    fx = np.round((mx - flx) * np.float32(32.0)).astype(np.int64)
    fy = np.round((my - fly) * np.float32(32.0)).astype(np.int64)
    ix = flx.astype(np.int64) + (fx >> 5)
    iy = fly.astype(np.int64) + (fy >> 5)
    fx, fy = fx & 31, fy & 31
    valid = (ix >= -1) & (ix <= W - 1) & (iy >= -1) & (iy <= H - 1)
    return tuple(torch.as_tensor(a, device=device) for a in (ix, iy, fx, fy, valid))


def remap(img: torch.Tensor, table) -> torch.Tensor:
    """remap(INTER_LINEAR, BORDER_CONSTANT 0) of (B, H, W, C) uint8 through
    `fixed_point_map`'s table: 10-bit weights, rounded."""
    B, H, W, C = img.shape
    ix, iy, fx, fy, valid = table
    flat = img.reshape(B, H * W, C).to(torch.int32)
    ax, ay = fx[..., None].to(torch.int32), fy[..., None].to(torch.int32)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        lin = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(-1)
        vals = flat[:, lin].reshape(B, *yy.shape, C)
        return torch.where(inside[..., None], vals, 0)

    acc = (tap(iy, ix) * ((32 - ax) * (32 - ay)) + tap(iy, ix + 1) * (ax * (32 - ay))
           + tap(iy + 1, ix) * ((32 - ax) * ay) + tap(iy + 1, ix + 1) * (ax * ay))
    out = (acc + 512) >> 10
    return torch.where(valid[..., None], out, 0).to(torch.uint8)


def ellipse(width: int, height: int) -> np.ndarray:
    """getStructuringElement(MORPH_ELLIPSE, (width, height))."""
    r, c = height // 2, width // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    k = np.zeros((height, width), np.uint8)
    for i in range(height):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.round(c * np.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))))
            k[i, max(c - dx, 0): min(c + dx + 1, width)] = 1
    return k


def _morph(img: torch.Tensor, kernel: np.ndarray, erode: bool) -> torch.Tensor:
    """Min (erode, border 255) or max (dilate, border 0) of (B, H, W) uint8
    over the footprint, anchored at its centre."""
    kh, kw = kernel.shape
    ay, ax = kh // 2, kw // 2
    B, H, W = img.shape
    xp = F.pad(img[:, None], (ax, kw - 1 - ax, ay, kh - 1 - ay),
               value=255 if erode else 0)[:, 0]
    out = None
    for i, j in zip(*np.nonzero(kernel)):
        win = xp[:, i: i + H, j: j + W]
        out = win if out is None else (torch.minimum(out, win) if erode
                                       else torch.maximum(out, win))
    return out.contiguous()


def open_close(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """morphologyEx OPEN then CLOSE: erode, dilate, dilate, erode."""
    x = _morph(mask, kernel, True)
    x = _morph(x, kernel, False)
    x = _morph(x, kernel, False)
    return _morph(x, kernel, True)


def _shift(t: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """out[..., y, x] = t[..., y + dy, x + dx], `fill` outside."""
    H, W = t.shape[-2:]
    out = torch.full_like(t, fill)
    out[..., max(-dy, 0): H - max(dy, 0), max(-dx, 0): W - max(dx, 0)] = \
        t[..., max(dy, 0): H - max(-dy, 0), max(dx, 0): W - max(-dx, 0)]
    return out


NEIGHBOURS_4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
NEIGHBOURS_8 = NEIGHBOURS_4 + ((1, 1), (1, -1), (-1, 1), (-1, -1))


def components(active: torch.Tensor, links) -> torch.Tensor:
    """Exact connected components of (B, H, W) bool `active`: each active
    pixel's label is the least linear index of its component; `links` maps
    a neighbour offset (dy, dx) to the (B, H, W) bool mask of pixels joined
    to their neighbour there. Min-label propagation with pointer jumping,
    to a fixed point; inactive pixels hold H * W."""
    B, H, W = active.shape
    n = H * W
    idx = torch.arange(n, device=active.device).view(1, H, W)
    lab = torch.where(active, idx, n)
    while True:
        prev = lab
        for (dy, dx), ok in links.items():
            lab = torch.where(ok, torch.minimum(lab, _shift(lab, dy, dx, n)), lab)
        flat = lab.reshape(B, n)
        jumped = torch.gather(flat, 1, flat.clamp(max=n - 1))
        lab = torch.where(flat < n, torch.minimum(flat, jumped), flat).view(B, H, W)
        if torch.equal(lab, prev):
            return lab


def detect(mask: torch.Tensor, min_size: int, max_objects: int) -> torch.Tensor:
    """(B, max_objects, 5) int32 [x, y, w, h, valid]: the 8-connected
    components of the mask whose bounding box covers at least min_size
    pixels, the first max_objects in raster order of their first pixel."""
    active = mask != 0
    links = {o: active & _shift(active, *o, False) for o in NEIGHBOURS_8}
    lab = components(active, links)
    B, H, W = mask.shape
    n = H * W
    ys = torch.arange(H, device=mask.device).view(1, H, 1).expand(B, H, W)
    xs = torch.arange(W, device=mask.device).view(1, 1, W).expand(B, H, W)
    key = (lab + torch.arange(B, device=mask.device).view(B, 1, 1) * (n + 1))[active]
    size = B * (n + 1)

    def reduce(vals, how, init):
        out = torch.full((size,), init, dtype=torch.int64, device=mask.device)
        return out.scatter_reduce(0, key, vals[active], how, include_self=True)

    minx, maxx = reduce(xs, "amin", n), reduce(xs, "amax", -1)
    miny, maxy = reduce(ys, "amin", n), reduce(ys, "amax", -1)
    boxes = torch.zeros((B, max_objects, 5), dtype=torch.int32)
    for b in range(B):
        roots = torch.unique(lab[b][active[b]]).tolist()
        k = 0
        for r in roots:
            s = b * (n + 1) + r
            x0, x1, y0, y1 = (int(t[s]) for t in (minx, maxx, miny, maxy))
            w, h = x1 - x0 + 1, y1 - y0 + 1
            if w * h >= min_size and k < max_objects:
                boxes[b, k] = torch.tensor([x0, y0, w, h, 1])
                k += 1
    return boxes.to(mask.device)


def matching_region(boxes: torch.Tensor):
    """The union bounding box (x, y, w, h) of one frame's valid boxes, or
    None where none is valid."""
    v = [b for b in boxes.tolist() if b[4]]
    if not v:
        return None
    x0, y0 = min(b[0] for b in v), min(b[1] for b in v)
    x1, y1 = max(b[0] + b[2] for b in v), max(b[1] + b[3] for b in v)
    return (x0, y0, x1 - x0, y1 - y0)


def filter_speckles(disp: torch.Tensor, new_val: int, max_size: int,
                    max_diff: int) -> torch.Tensor:
    """filterSpeckles on (B, H, W) int16: 4-connected components of pixels
    other than new_val whose neighbours differ by at most max_diff; those of
    at most max_size pixels become new_val."""
    B, H, W = disp.shape
    n = H * W
    v = disp.to(torch.int32)
    active = disp != new_val
    links = {}
    for o in NEIGHBOURS_4:
        nb_active = _shift(active, *o, False)
        nb_v = _shift(v, *o, 0)
        links[o] = active & nb_active & ((v - nb_v).abs() <= max_diff)
    lab = components(active, links)
    key = lab + torch.arange(B, device=disp.device).view(B, 1, 1) * (n + 1)
    sizes = torch.bincount(key[active], minlength=B * (n + 1))
    small = active & (sizes[key.clamp(max=B * (n + 1) - 1)] <= max_size)
    return torch.where(small, torch.tensor(new_val, dtype=disp.dtype,
                                           device=disp.device), disp)


def depth(disp: torch.Tensor, mask: torch.Tensor, boxes: torch.Tensor,
          Q: np.ndarray, unit_mm: float, min_disp: int, dtype=torch.float32):
    """(depth_cm, mean_z, count) of (B, H, W) int16 x16 disparities: the
    disparity /16 rounded half to even, reprojectImageTo3D with
    handleMissingValues in `dtype`, and each valid box's mean Z over its
    masked pixels whose Z is finite and not missing (float64 sums; NaN where
    none). The configuration states float32."""
    B, H, W = disp.shape
    dev = disp.device
    d16 = torch.round(disp.to(torch.float32) / DISP_SCALE).to(torch.int16)
    q = torch.as_tensor(np.asarray(Q, np.float32), device=dev).to(dtype)
    d = d16.to(dtype)
    xs = torch.arange(W, device=dev, dtype=dtype)[None, None, :]
    ys = torch.arange(H, device=dev, dtype=dtype)[None, :, None]

    def row(i):
        return q[i, 0] * xs + q[i, 1] * ys + q[i, 2] * d + q[i, 3]

    Z, Wh = row(2), row(3)
    inv = torch.where(Wh != 0, 1.0 / Wh, torch.zeros((), dtype=dtype, device=dev))
    Z = (Z * inv).to(torch.float32)
    Z = torch.where(d16 == min_disp - 1, MISSING_Z, Z)
    ok = ((Z - MISSING_Z).abs() >= FLT_EPSILON) & (Z.abs() <= 1.0e4) & (mask != 0)
    xi = torch.arange(W, device=dev)[None, None, :]
    yi = torch.arange(H, device=dev)[None, :, None]
    x, y, w, h, valid = (boxes[..., i, None, None] for i in range(5))
    inside = ((xi >= x) & (xi < x + w) & (yi >= y) & (yi < y + h) & (valid > 0))
    m = inside & ok[:, None]
    count = m.sum(dim=(-2, -1), dtype=torch.int32)
    acc = torch.float64 if dtype == torch.float32 else dtype
    s = torch.where(m, Z[:, None].to(acc), 0).sum(dim=(-2, -1))
    mean_z = torch.where(count > 0, s / count.clamp(min=1).to(acc), float("nan"))
    depth_cm = (mean_z * (unit_mm / 10.0)).to(torch.float32)
    return depth_cm, mean_z.to(torch.float32), count
