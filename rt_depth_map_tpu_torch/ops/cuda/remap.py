"""K1: fixed-point bilinear remap of uint8 planes (`csrc/remap.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/remap_plan.py` `remap_bilinear_planned`.
The TPU kernel runs a statically planned select network because the TPU's
gather is slow, and the JAX engine stacks the left gray and RGB planes into
one 4-channel image to fill its lanes. Hopper has real gathers, so the CUDA
kernel gathers from each plane as it is: `rectify_pair` samples both views
of a stereo pair (left gray and RGB, right gray) in one launch, and
`remap_u8` one image of up to 4 channels, on the same device code. A thread
owns 4 consecutive output pixels: their packed table words (`ops/remap.py`
`pack_table`, 8 bytes a pixel, quantized on the host) in two 16-byte loads,
byte taps through the read-only cache, and whole 32-bit stores. It is
bounded by device memory bytes.

`rectify_pair_batch` does the same for B frames of both views in one
launch (the frame a grid dimension: each frame samples its own planes
through the shared tables), the port of K1 over the JAX engine's
row-stacked batch source and its stacked plan.

The wrappers take a table with the fields of `ops/remap.py` `RemapTable`:
the plain versions read its unpacked ix, iy, fx, fy and valid, the kernel its
`packed` words. Each launches the kernel for CUDA tensors and runs its plain
version for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build

#: the largest source side: the packed table holds ix and iy as int16
MAX_SIDE = 32767


def remap_u8_plain(img: torch.Tensor, table) -> torch.Tensor:
    """(H, W, C) uint8 image sampled at the quantized tables -> (Ho, Wo, C)."""
    H, W, C = img.shape
    x0 = table.ix.long()
    y0 = table.iy.long()
    ax = table.fx.to(torch.int32)[..., None]
    ay = table.fy.to(torch.int32)[..., None]
    flat = img.reshape(H * W, C).to(torch.int32)

    def tap(yy, xx):
        inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        lin = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        vals = flat[lin.reshape(-1)].reshape(lin.shape + (C,))
        return torch.where(inside[..., None], vals, 0)

    acc = (tap(y0, x0) * ((32 - ax) * (32 - ay))
           + tap(y0, x0 + 1) * (ax * (32 - ay))
           + tap(y0 + 1, x0) * ((32 - ax) * ay)
           + tap(y0 + 1, x0 + 1) * (ax * ay))
    out = (acc + 512) >> 10
    return torch.where(table.valid.bool()[..., None], out, 0).to(torch.uint8)


def rectify_pair_plain(lgray: torch.Tensor, lrgb: torch.Tensor,
                       rgray: torch.Tensor, left, right):
    """(lrect (Ho, Wo), rgbr (Ho, Wo, 3), rrect (Ho, Wo)): each plane through
    its view's table with `remap_u8_plain`."""
    return (remap_u8_plain(lgray[..., None], left)[..., 0],
            remap_u8_plain(lrgb, left),
            remap_u8_plain(rgray[..., None], right)[..., 0])


def _lib(entry: str, argtypes):
    lib = _build.load("remap")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _build.I
    return lib, fn


def _require_table(table, name: str, hw, shape) -> None:
    if max(hw) > MAX_SIDE:
        raise ValueError(f"{name}: a source of {hw[1]}x{hw[0]} is larger than "
                         f"{MAX_SIDE} on a side")
    _build.require(table.packed, f"{name} table", torch.int64, shape)


def remap_u8(img: torch.Tensor, table) -> torch.Tensor:
    """Bilinear remap of an (H, W, C <= 4) uint8 image through an (Ho, Wo)
    table -> (Ho, Wo, C) uint8."""
    if img.device.type == "cpu":
        return remap_u8_plain(img, table)
    if img.device.type != "cuda":
        raise ValueError(f"remap_u8: unsupported device {img.device}")
    H, W, C = img.shape
    Ho, Wo = table.packed.shape
    _build.require(img, "img", torch.uint8)
    _require_table(table, "remap_u8", (H, W), (Ho, Wo))
    if not 1 <= C <= 4:
        raise ValueError(f"remap_u8: {C} channels, the kernel takes 1 to 4")
    out = torch.empty((Ho, Wo, C), dtype=torch.uint8, device=img.device)
    P, I = _build.P, _build.I
    lib, fn = _lib("rtdm_remap_u8", [P, I, P, I, I, I, P, P])
    with torch.cuda.device(img.device):
        err = fn(table.packed.data_ptr(), Ho * Wo, img.data_ptr(), H, W, C,
                 out.data_ptr(), _build.stream_of(img))
    remap_u8.launches += 1
    _build.check(lib, err, "remap_u8")
    return out


def rectify_pair(lgray: torch.Tensor, lrgb: torch.Tensor, rgray: torch.Tensor,
                 left, right):
    """Both views of a stereo pair in one launch: the left gray (H, W) and
    RGB (H, W, 3) through the `left` table, the right gray (H, W) through
    `right` -> contiguous (lrect (Ho, Wo), rgbr (Ho, Wo, 3), rrect (Ho, Wo))
    uint8."""
    if lgray.device.type == "cpu":
        return rectify_pair_plain(lgray, lrgb, rgray, left, right)
    if lgray.device.type != "cuda":
        raise ValueError(f"rectify_pair: unsupported device {lgray.device}")
    H, W = lgray.shape
    Ho, Wo = left.packed.shape
    _build.require(lgray, "lgray", torch.uint8)
    _build.require(lrgb, "lrgb", torch.uint8, (H, W, 3))
    _build.require(rgray, "rgray", torch.uint8, (H, W))
    _require_table(left, "rectify_pair left", (H, W), (Ho, Wo))
    _require_table(right, "rectify_pair right", (H, W), (Ho, Wo))
    dev = lgray.device
    lrect = torch.empty((Ho, Wo), dtype=torch.uint8, device=dev)
    rgbr = torch.empty((Ho, Wo, 3), dtype=torch.uint8, device=dev)
    rrect = torch.empty((Ho, Wo), dtype=torch.uint8, device=dev)
    P, I = _build.P, _build.I
    lib, fn = _lib("rtdm_rectify_pair", [P, P, I, I, I, P, P, P, P, P, P, P])
    with torch.cuda.device(dev):
        err = fn(left.packed.data_ptr(), right.packed.data_ptr(), Ho * Wo, H, W,
                 lgray.data_ptr(), lrgb.data_ptr(), rgray.data_ptr(),
                 lrect.data_ptr(), rgbr.data_ptr(), rrect.data_ptr(),
                 _build.stream_of(lgray))
    rectify_pair.launches += 1
    _build.check(lib, err, "rectify_pair")
    return lrect, rgbr, rrect


def rectify_pair_batch_plain(lgray: torch.Tensor, lrgb: torch.Tensor,
                             rgray: torch.Tensor, left, right):
    """`rectify_pair_plain` over the frames, stacked."""
    outs = [rectify_pair_plain(lg, lc, rg, left, right)
            for lg, lc, rg in zip(lgray, lrgb, rgray)]
    return tuple(torch.stack(o) for o in zip(*outs))


def rectify_pair_batch(lgray: torch.Tensor, lrgb: torch.Tensor,
                       rgray: torch.Tensor, left, right):
    """Both views of B stereo pairs in one launch: the left gray (B, H, W)
    and RGB (B, H, W, 3) through the `left` table, the right gray (B, H, W)
    through `right` -> contiguous (lrect (B, Ho, Wo), rgbr (B, Ho, Wo, 3),
    rrect (B, Ho, Wo)) uint8, frame b equal to `rectify_pair` on frame
    b's planes."""
    if not _build.on_card(lgray, "rectify_pair_batch"):
        return rectify_pair_batch_plain(lgray, lrgb, rgray, left, right)
    B, H, W = lgray.shape
    Ho, Wo = left.packed.shape
    _build.require(lgray, "lgray", torch.uint8)
    _build.require(lrgb, "lrgb", torch.uint8, (B, H, W, 3))
    _build.require(rgray, "rgray", torch.uint8, (B, H, W))
    _require_table(left, "rectify_pair_batch left", (H, W), (Ho, Wo))
    _require_table(right, "rectify_pair_batch right", (H, W), (Ho, Wo))
    dev = lgray.device
    lrect = torch.empty((B, Ho, Wo), dtype=torch.uint8, device=dev)
    rgbr = torch.empty((B, Ho, Wo, 3), dtype=torch.uint8, device=dev)
    rrect = torch.empty((B, Ho, Wo), dtype=torch.uint8, device=dev)
    P, I = _build.P, _build.I
    lib, fn = _lib("rtdm_rectify_pair_batch",
                   [P, P, I, I, I, I, P, P, P, P, P, P, P])
    with torch.cuda.device(dev):
        err = fn(left.packed.data_ptr(), right.packed.data_ptr(), Ho * Wo, B,
                 H, W, lgray.data_ptr(), lrgb.data_ptr(), rgray.data_ptr(),
                 lrect.data_ptr(), rgbr.data_ptr(), rrect.data_ptr(),
                 _build.stream_of(lgray))
    rectify_pair_batch.launches += 1
    _build.check(lib, err, "rectify_pair_batch")
    return lrect, rgbr, rrect


remap_u8.launches = 0
rectify_pair.launches = 0
rectify_pair_batch.launches = 0
