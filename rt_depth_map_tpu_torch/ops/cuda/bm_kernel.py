"""K8: StereoBM SAD cost + winner-take-all (`csrc/bm_kernel.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/bm_kernel.py` `bm_cost_wta`. The port's
contract holds on every pixel and is the XLA formulation's
(`rt_depth_map_tpu/ops/bm.py` `_cost_volume`) at any min_disparity minD:
disparity index i is the disparity dd = minD + i, bs x bs window sums
zero-padded at the border, |L(x) - R(x - dd)| taken as 0 where x - dd
leaves [0, W) (at minD < 0 the right border falls inside the valid region:
there the term is 0, not |L - 0|). The outputs and the tie rule (the
largest index) stay in index space. (The Pallas kernel zero-fills the left
border differently, but only outside the region `stereo_bm` keeps.)

Its bound on the H100 is integer instructions (`PERF.md` gives its time
beside that bound). A block owns a tile of output columns (32 a warp) and a
stripe of rows (`bm_plan`, a pure function of the shape and of the SM's
shared memory). It slides the
per-d vertical window sums down the rows in shared memory, 16 d a thread
with byte-SIMD differences, fed from a ring of rows copied one row ahead
with `cp.async`; each warp slides the horizontal window along its 32
pixels in registers, with D over its lanes, and finds each pixel's winner
with warp reductions. The (D, H, W) volume never reaches device memory;
one CUDA launch a call.

`bm_cost_wta` launches the kernel for CUDA tensors and runs
`bm_cost_wta_plain` for CPU tensors; any other device raises. The card
takes 1 <= D <= MAX_D, where the BM LR check's packed key also ends
(`ops/cuda/lr_resolve.py` `lr_key_planes_bm`); the plain version takes any D.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from rt_depth_map_tpu_torch.ops.cuda import _build

MIN_OUTSIDE_NONE = 2**28
#: the most disparities the kernel takes: 12 a lane (csrc/bm_kernel.cu)
MAX_D = 384

#: shared memory the card reserves for each resident block, which is also
#: what a block may not take of its SM's (bytes; sm_80 and later)
SMEM_RESERVED = 1024
#: output columns a warp, one a lane (csrc/bm_kernel.cu BM_PW; 16 or 8 with
#: more warps were slower on the H100: `tools/time_torch_bm.py --ablate`)
PIXELS_PER_WARP = 32
#: the most warps a block takes (BM_MAX_WARPS)
MAX_WARPS = 8
#: the fewest columns of a tile at D <= 128, 128 < D <= 256 and D > 256
#: (on the H100, 128 beat 64 at D = 192 and 256 and tied at D = 128; above
#: D = 256, 64 columns by 48 rows beat 96 by 32, the widest two blocks an
#: SM hold, by 13% at 1920x1080 D = 288 and 384: `tools/time_torch_bm.py
#: --sweep`)
MIN_COLUMNS = (64, 128, 64)
#: the fewest rows of a stripe at D <= 256 and D > 256 (on the H100, 32
#: rows at 1280x720 and 1920x1080 beat 12-24, 40 and 48 at D <= 256:
#: `tools/time_torch_bm.py --sweep`)
MIN_ROWS = (32, 48)


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
                bs: int, min_disp: int = 0) -> torch.Tensor:
    """(D, H, W) int32 windowed SAD, the XLA formulation of ops/bm.py: index
    i holds disparity min_disp + i, |L(x) - R(x - dd)| where 0 <= x - dd < W
    and 0 elsewhere."""
    H, W = lp.shape
    l32 = lp.to(torch.int32)
    r32 = rp.to(torch.int32)
    ad = torch.zeros((D, H, W), dtype=torch.int32, device=lp.device)
    for i in range(D):
        dd = min_disp + i
        lo, hi = max(dd, 0), min(W, W + dd)  # x with 0 <= x - dd < W
        if lo < hi:
            ad[i, :, lo:hi] = (l32[:, lo:hi] - r32[:, lo - dd: hi - dd]).abs()
    return box_sum_2d(ad, bs)


def bm_cost_wta_plain(lp: torch.Tensor, rp: torch.Tensor, num_disp: int,
                      block_size: int, min_disp: int = 0):
    """(best_d, best_cost, c_m1, c_p1, min_outside), each (H, W) int32;
    best_d is the disparity index (best_d + min_disp the disparity)."""
    D = num_disp
    cost = cost_volume(lp, rp, D, block_size, min_disp)
    di = torch.arange(D, dtype=torch.int32, device=lp.device)[:, None, None]
    # the reference's key (ops/bm.py): ties to the largest d, any D
    kmin = torch.amin(cost * D + (D - 1 - di), dim=0)
    best = (D - 1) - kmin % D
    best_cost = kmin // D
    b = best.long()[None]
    c_m1 = torch.where(best > 0,
                       torch.gather(cost, 0, (b - 1).clamp(min=0))[0], 0)
    c_p1 = torch.where(best < D - 1,
                       torch.gather(cost, 0, (b + 1).clamp(max=D - 1))[0], 0)
    outside = (di - best[None]).abs() > 1
    min_out = torch.amin(torch.where(outside, cost, MIN_OUTSIDE_NONE), dim=0)
    return best, best_cost, c_m1.to(torch.int32), c_p1.to(torch.int32), min_out


def lane_k(D: int) -> int:
    """Disparities a lane holds: ceil(D / 32) rounded up to 1, 2, 4 or 8,
    and 12 above D = 256."""
    if D > 256:
        return 12
    k = 1
    while 32 * k < D:
        k *= 2
    return k


def key_bits(D: int) -> int:
    """Bits of the d field of the kernel's packed key cost << bits | (D - 1 - d)."""
    return 8 if D <= 256 else 9


def check_args(D: int, bs: int, what: str) -> None:
    """Raise unless the kernel takes D and an odd block size bs: 1 <= D <=
    MAX_D, and every packed key (cost <= bs^2 * 255) fits in int32."""
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{what}: D={D} is outside the kernel's 1..{MAX_D}")
    if bs % 2 == 0 or bs < 1 or bs * bs * 255 << key_bits(D) >= 2**31:
        raise ValueError(f"{what}: unsupported block_size={bs} at D={D}")


def bm_smem(tx: int, D: int, bs: int) -> int:
    """Shared-memory bytes of a block of `tx` output columns: the uint16
    vertical sums of the tx + bs - 1 halo columns at 32 * K disparities,
    and a ring of bs + 1 rows of L and of R in whole 16-byte pieces, R
    behind a 32-byte pad. The layout is `csrc/bm_kernel.cu` `bm_layout`,
    whose entry point refuses a plan whose size differs from it."""
    cw = tx + bs - 1
    ls = 16 * ((cw + 30) // 16)
    rs = 16 * ((cw + D - 1 + 30) // 16) + 16
    return cw * 32 * lane_k(D) * 2 + (bs + 1) * (ls + rs) + 32


class BmPlan(NamedTuple):
    tx: int  # output columns a block: PIXELS_PER_WARP a warp
    ty: int  # output rows a block
    warps: int
    smem: int  # shared-memory bytes a block
    resident: int  # blocks an SM holds by shared memory


def bm_plan(H: int, W: int, D: int, bs: int, smem_per_sm: int) -> BmPlan:
    """K8's launch plan on an SM of `smem_per_sm` bytes of shared memory:
    tiles of tx = PIXELS_PER_WARP * warps columns by ty rows.

    Tiles take at least MIN_COLUMNS columns; the halo overhead
    (tx + bs - 1) / tx stays at or below 1.2 and the priming overhead
    (ty + bs - 1) / ty at or below 1.5 where the frame is that large, with
    stripes of at least MIN_ROWS rows; the tile narrows until two blocks
    fit in an SM's shared memory (one where none narrower does). A block
    may take all of its SM's but SMEM_RESERVED. Raises if no block fits,
    or if the kernel does not take D or bs (`check_args`)."""
    check_args(D, bs, "bm_plan")

    def resident(tx):
        smem = bm_smem(tx, D, bs)
        if smem > smem_per_sm - SMEM_RESERVED:
            return 0
        return smem_per_sm // (smem + SMEM_RESERVED)

    pw = PIXELS_PER_WARP
    warps = -(-5 * (bs - 1) // pw)  # tx >= 5 * (bs - 1)
    warps = min(max(warps, MIN_COLUMNS[(D > 128) + (D > 256)] // pw), MAX_WARPS,
                max(-(-W // pw), 1))
    while warps > 1 and resident(pw * warps) < 2:
        warps -= 1
    tx = pw * warps
    if resident(tx) < 1:
        raise ValueError(f"bm_plan: no block of D={D}, block_size={bs} fits "
                         f"in {smem_per_sm} bytes of shared memory")
    ty = min(max(2 * (bs - 1), MIN_ROWS[D > 256]), max(H, 1))
    return BmPlan(tx, ty, warps, bm_smem(tx, D, bs), resident(tx))


def _fn():
    lib = _build.load("bm_kernel")
    fn = lib.rtdm_bm_cost_wta
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, P, I, I, I, I, I, P, P, P, P, P, I, I, I, P]
        fn.restype = I
    return lib, fn


def bm_cost_wta(lp: torch.Tensor, rp: torch.Tensor, num_disp: int,
                block_size: int, min_disp: int = 0):
    """(best_d, best_cost, c_m1, c_p1, min_outside) each (H, W) int32 at
    min_disparity `min_disp` (best_d an index into [0, D)). lp/rp: (H, W)
    uint8 prefiltered planes."""
    if lp.device.type == "cpu":
        return bm_cost_wta_plain(lp, rp, num_disp, block_size, min_disp)
    if lp.device.type != "cuda":
        raise ValueError(f"bm_cost_wta: unsupported device {lp.device}")
    H, W = lp.shape
    D, bs = int(num_disp), int(block_size)
    check_args(D, bs, "bm_cost_wta")
    _build.require(lp, "lp", torch.uint8)
    _build.require(rp, "rp", torch.uint8, (H, W))
    outs = [torch.empty((H, W), dtype=torch.int32, device=lp.device)
            for _ in range(5)]
    plan = bm_plan(H, W, D, bs, torch.cuda.get_device_properties(
        lp.device).shared_memory_per_multiprocessor)
    lib, fn = _fn()
    with torch.cuda.device(lp.device):
        err = fn(lp.data_ptr(), rp.data_ptr(), H, W, D, bs, int(min_disp),
                 *[o.data_ptr() for o in outs], plan.warps, plan.ty, plan.smem,
                 _build.stream_of(lp))
    bm_cost_wta.launches += 1
    _build.check(lib, err, "bm_cost_wta")
    return tuple(outs)


bm_cost_wta.launches = 0
