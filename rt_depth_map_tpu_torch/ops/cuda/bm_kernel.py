"""K8: StereoBM SAD cost + streaming winner-take-all (`csrc/bm_kernel.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/bm_kernel.py` `bm_cost_wta`. The port's
contract holds on every pixel and is the XLA formulation's
(`rt_depth_map_tpu/ops/bm.py` `_cost_volume`): bs x bs window sums
zero-padded at the border, |L - R| = 0 where x - d < 0. (The Pallas kernel
zero-fills the left border differently, but only outside the region
`stereo_bm` keeps.)

On the H100 the kernel is bounded by shared-memory traffic: it keeps per-d
vertical window sums of a 128-column tile in shared memory, slides them down
the rows, and sums bs of them per pixel and d while a register-resident
winner state walks d; the (D, H, W) volume never reaches device memory.

`bm_cost_wta` launches the kernel for CUDA tensors and runs
`bm_cost_wta_plain` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rt_depth_map_tpu_torch.ops.cuda import _build

MIN_OUTSIDE_NONE = 2**28


def _sliding_sum(x: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """Centred zero-padded sliding sum of odd width `size` along `dim`."""
    w2 = size // 2
    x = x.movedim(dim, -1)
    c = torch.cumsum(F.pad(x, (w2 + 1, w2)), dim=-1, dtype=x.dtype)
    return (c[..., size:] - c[..., :-size]).movedim(-1, dim)


def box_sum_2d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centred size x size zero-padded window sum over the last two dims."""
    return _sliding_sum(_sliding_sum(x, size, -2), size, -1)


def cost_volume(lp: torch.Tensor, rp: torch.Tensor, D: int,
                bs: int) -> torch.Tensor:
    """(D, H, W) int32 windowed SAD, the XLA formulation of ops/bm.py."""
    H, W = lp.shape
    l32 = lp.to(torch.int32)
    r32 = rp.to(torch.int32)
    ad = torch.zeros((D, H, W), dtype=torch.int32, device=lp.device)
    for d in range(D):
        if d < W:
            ad[d, :, d:] = (l32[:, d:] - r32[:, : W - d]).abs()
    return box_sum_2d(ad, bs)


def bm_cost_wta_plain(lp: torch.Tensor, rp: torch.Tensor, num_disp: int,
                      block_size: int):
    """(best_d, best_cost, c_m1, c_p1, min_outside), each (H, W) int32."""
    D = num_disp
    cost = cost_volume(lp, rp, D, block_size)
    di = torch.arange(D, dtype=torch.int32, device=lp.device)[:, None, None]
    kmin = torch.amin(cost * 256 + (D - 1 - di), dim=0)
    best = (D - 1) - (kmin & 255)
    best_cost = kmin >> 8
    b = best.long()[None]
    c_m1 = torch.where(best > 0,
                       torch.gather(cost, 0, (b - 1).clamp(min=0))[0], 0)
    c_p1 = torch.where(best < D - 1,
                       torch.gather(cost, 0, (b + 1).clamp(max=D - 1))[0], 0)
    outside = (di - best[None]).abs() > 1
    min_out = torch.amin(torch.where(outside, cost, MIN_OUTSIDE_NONE), dim=0)
    return best, best_cost, c_m1.to(torch.int32), c_p1.to(torch.int32), min_out


def _fn():
    lib = _build.load("bm_kernel")
    fn = lib.rtdm_bm_cost_wta
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, I, I, I, I, P, P, P, P, P, P]
        fn.restype = I
    return lib, fn


def bm_cost_wta(lp: torch.Tensor, rp: torch.Tensor, num_disp: int,
                block_size: int):
    """(best_d, best_cost, c_m1, c_p1, min_outside) each (H, W) int32 for
    min_disparity = 0. lp/rp: (H, W) uint8 prefiltered planes."""
    if lp.device.type == "cpu":
        return bm_cost_wta_plain(lp, rp, num_disp, block_size)
    if lp.device.type != "cuda":
        raise ValueError(f"bm_cost_wta: unsupported device {lp.device}")
    H, W = lp.shape
    D, bs = int(num_disp), int(block_size)
    if not (1 <= D <= 256) or bs % 2 == 0 or bs * bs * 255 * 256 >= 2**31:
        raise ValueError(f"bm_cost_wta: unsupported D={D}, block_size={bs}")
    _build.require(lp, "lp", torch.uint8)
    _build.require(rp, "rp", torch.uint8, (H, W))
    outs = [torch.empty((H, W), dtype=torch.int32, device=lp.device)
            for _ in range(5)]
    lib, fn = _fn()
    with torch.cuda.device(lp.device):
        err = fn(lp.data_ptr(), rp.data_ptr(), H, W, D, bs,
                 *[o.data_ptr() for o in outs], _build.stream_of(lp))
    bm_cost_wta.launches += 1
    _build.check(lib, err, "bm_cost_wta")
    return tuple(outs)


bm_cost_wta.launches = 0
