"""K1: fixed-point bilinear remap of uint8 planes (`csrc/remap.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/remap_plan.py` `remap_bilinear_planned`.
The TPU kernel runs a statically planned select network because the TPU's
gather is slow; Hopper has real gathers, so the CUDA kernel is one thread per
output pixel reading the integer tables that `ops/remap.py` quantizes on the
host. It is bounded by device memory bytes (11 bytes of tables and ~4 cached
taps per channel per pixel); the design keeps every float operation on the
host so the card only does integer arithmetic.

`remap_u8` launches the kernel for CUDA tensors and runs `remap_u8_plain`
for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build


def remap_u8_plain(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
                   fx: torch.Tensor, fy: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(H, W, C) uint8 image sampled at the quantized tables -> (Ho, Wo, C)."""
    H, W, C = img.shape
    x0 = ix.long()
    y0 = iy.long()
    ax = fx.to(torch.int32)[..., None]
    ay = fy.to(torch.int32)[..., None]
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
    return torch.where(valid.bool()[..., None], out, 0).to(torch.uint8)


def _fn():
    lib = _build.load("remap")
    fn = lib.rtdm_remap_u8
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, I, I, I, P, P, P, P, P, P, I, P]
        fn.restype = I
    return lib, fn


def remap_u8(img: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor,
             fx: torch.Tensor, fy: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of an (H, W, C) uint8 image through (Ho, Wo) tables:
    ix, iy int32 window origins, fx, fy uint8 1/32-px fractions, valid uint8
    (0 where the window lies fully outside the image)."""
    if img.device.type == "cpu":
        return remap_u8_plain(img, ix, iy, fx, fy, valid)
    if img.device.type != "cuda":
        raise ValueError(f"remap_u8: unsupported device {img.device}")
    H, W, C = img.shape
    Ho, Wo = ix.shape
    _build.require(img, "img", torch.uint8)
    for name, t, dt in (("ix", ix, torch.int32), ("iy", iy, torch.int32),
                        ("fx", fx, torch.uint8), ("fy", fy, torch.uint8),
                        ("valid", valid, torch.uint8)):
        _build.require(t, name, dt, (Ho, Wo))
    out = torch.empty((Ho, Wo, C), dtype=torch.uint8, device=img.device)
    lib, fn = _fn()
    with torch.cuda.device(img.device):
        err = fn(img.data_ptr(), H, W, C, ix.data_ptr(), iy.data_ptr(),
                 fx.data_ptr(), fy.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), Ho * Wo, _build.stream_of(img))
    remap_u8.launches += 1
    _build.check(lib, err, "remap_u8")
    return out


remap_u8.launches = 0
