"""Bilinear remap with the reference's CV_16SC2 fixed-point maps.

Port of `rt_depth_map_tpu/ops/remap.py` (uint8 path). The float map is
quantized once on the host, exactly as the reference does on every call
(remap.py:39-48): floor, round half to even to 1/32 px, carry. All of it is
float32, as in JAX (numpy would promote `float32 - int32` to float64). The
card then reads integer tables only (K1, `ops/cuda/remap.py`), packed on
the host into one 8-byte word a pixel (`pack_table`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from rt_depth_map_tpu_torch.ops.cuda.remap import remap_u8, remap_u8_plain


@dataclasses.dataclass(frozen=True)
class RemapTable:
    """Quantized map of an (Ho, Wo) output over a (H, W) source image."""

    ix: torch.Tensor  # (Ho, Wo) int32 window column
    iy: torch.Tensor  # (Ho, Wo) int32 window row
    fx: torch.Tensor  # (Ho, Wo) uint8 1/32-px fraction in x
    fy: torch.Tensor  # (Ho, Wo) uint8 1/32-px fraction in y
    valid: torch.Tensor  # (Ho, Wo) uint8, 0 where the window is fully outside
    packed: torch.Tensor  # (Ho, Wo) int64, the same fields (`pack_table`)


def quantize_map(grid: np.ndarray, src_hw: Tuple[int, int]) -> dict:
    """(Ho, Wo, 2) float [x, y] source coordinates -> numpy tables
    (ix, iy int32; fx, fy, valid uint8) for a source of size src_hw."""
    H, W = src_hw
    g = np.asarray(grid, np.float32)
    mx, my = g[..., 0], g[..., 1]
    flx, fly = np.floor(mx), np.floor(my)  # float32
    fx = np.round((mx - flx) * np.float32(32.0)).astype(np.int32)
    fy = np.round((my - fly) * np.float32(32.0)).astype(np.int32)
    ix = flx.astype(np.int32) + (fx >> 5)
    iy = fly.astype(np.int32) + (fy >> 5)
    fx, fy = fx & 31, fy & 31
    valid = (ix >= -1) & (ix <= W - 1) & (iy >= -1) & (iy <= H - 1)
    return dict(ix=ix, iy=iy, fx=fx.astype(np.uint8), fy=fy.astype(np.uint8),
                valid=valid.astype(np.uint8))


def pack_table(ix, iy, fx, fy, valid) -> np.ndarray:
    """The kernel's table: one little-endian 8-byte word a pixel, ix and iy
    as int16 in the low 32 bits (0 where valid == 0: unused there, and they
    may not fit), fx | fy << 5 | valid << 10 in the high 32 bits. Exact for
    sources of at most 32767 on a side (valid ix, iy lie in [-1, side - 1]);
    the kernel's wrappers refuse larger ones."""
    v = np.asarray(valid).astype(bool)
    low = (np.where(v, ix, 0).astype(np.int64) & 0xFFFF) \
        | ((np.where(v, iy, 0).astype(np.int64) & 0xFFFF) << 16)
    high = (np.asarray(fx).astype(np.int64) | np.asarray(fy).astype(np.int64) << 5
            | v.astype(np.int64) << 10)
    return low | high << 32


def remap_table(grid: np.ndarray, src_hw: Tuple[int, int],
                device="cpu") -> RemapTable:
    q = quantize_map(grid, src_hw)
    q["packed"] = pack_table(**q)
    return RemapTable(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                         for k, v in q.items()})


def remap_bilinear(img: torch.Tensor, table: RemapTable,
                   plain: bool = False) -> torch.Tensor:
    """Sample a (H, W) or (H, W, C) uint8 image through `table`.

    plain=True runs the kernel's plain PyTorch version on any device (the
    reference the card's kernel is held against)."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    fn = remap_u8_plain if plain else remap_u8
    out = fn(x.contiguous(), table)
    return out[..., 0] if squeeze else out
