"""K12: swap the outer axes of a volume (`csrc/vol_transpose.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/vol_transpose.py` `vol_transpose`,
the (A, D, B) -> (B, D, A) transpose that carries the SGM cost volume into
the x-major layout of the horizontal paths (K4) and their sum back. The
port's volumes keep D contiguous, so `ops/sgbm.py` hands it (H, 1, W1, D)
and gets (W1, 1, H, D): trailing axes move as one unit. The kernel is bound
by device memory bytes.

`vol_transpose` launches the kernel for CUDA tensors and runs
`vol_transpose_plain` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build


def vol_transpose_plain(x: torch.Tensor) -> torch.Tensor:
    """(A, M, B, ...) -> (B, M, A, ...), contiguous."""
    return x.transpose(0, 2).contiguous()


def _fn():
    lib = _build.load("vol_transpose")
    fn = lib.rtdm_vol_transpose
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, I, I, I, ctypes.c_longlong, P]
        fn.restype = I
    return lib, fn


def vol_transpose(x: torch.Tensor) -> torch.Tensor:
    """(A, M, B, ...) -> (B, M, A, ...): y[b, m, a] = x[a, m, b]; the
    trailing axes (none for the TPU's 3-D form) move as one unit."""
    if x.dim() < 3:
        raise ValueError(f"vol_transpose needs a volume of 3 or more axes, got {x.dim()}")
    if x.device.type == "cpu":
        return vol_transpose_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"vol_transpose: unsupported device {x.device}")
    _build.require(x, "x", x.dtype)
    A, M, B = x.shape[:3]
    if max(A, M, B) >= 2**31:
        raise ValueError(f"vol_transpose: axes too long {tuple(x.shape)}")
    unit = math.prod(x.shape[3:]) * x.element_size()
    y = torch.empty((B, M, A, *x.shape[3:]), dtype=x.dtype, device=x.device)
    lib, fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), y.data_ptr(), A, M, B, unit, _build.stream_of(x))
    vol_transpose.launches += 1
    _build.check(lib, err, "vol_transpose")
    return y


vol_transpose.launches = 0
