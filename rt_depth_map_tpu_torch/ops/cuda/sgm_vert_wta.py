"""K5: six vertical/diagonal SGM paths + winner-take-all (`csrc/sgm_vert_wta.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/sgm_bidir.py` `sgm_vert_bidir_wta_hdw`:
from the cost volume C and the horizontal sum Sh (K4), the total
S = Sh + L(+1,0) + L(+1,+1) + L(+1,-1) + L(-1,0) + L(-1,+1) + L(-1,-1) and,
per pixel, (best, minS, dval, uniq), each (H, W1) int32: the winner (ties to
the smallest d), its cost, the x16 subpixel disparity without the
min_disparity offset, and 1 where the SGBM uniqueness test fails.

On the H100 two row-synchronous launches of the port's one vertical scan
(`csrc/sgm_vert.cuh`, which K9c, K9d and K11 share) do it: the first walks
the rows down with the three top-down directions and writes S = Sh + their
L once; the second walks up with the other three and does the
winner-take-all from registers. A block owns a band of contiguous columns,
a warp per column or, where W1 needs more warps than the resident blocks
hold, several columns a warp (`vert_plan`). The diagonal carries cross
columns through shared memory inside a band and through row-tagged
device-memory slots between bands, so every band must be resident at once:
the launches are cooperative, and `plan_on_card` sizes the bands from the
blocks the card holds at once (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`
x SMs). What bounds the width is a band's carries in shared memory, about
20 x D bytes a column over W1 / resident blocks columns: 3840x2160 fits at
D = 256.

`sgm_vert_wta_batch` runs B frames of (H, W1, D) in the same pair of
launches, the port of the TPU kernel's lane-stacked form (`seg` and
`true_h`, `sgm_bidir.py:382-390`, `:543-592`): each frame owns whole bands
(grid.y is the frame), so its diagonal carries start from the zero image
border at its first and last column and never read the neighbouring
frame's edge column. The band plan (`batch_plan_on_card`) gives each frame
1/F of the resident blocks; where F = B frames do not fit a launch (their
bands' carries outgrow shared memory), the batch goes in launches of as
many frames as fit, split evenly (`split_batch`).

`sgm_vert_wta` and `sgm_vert_wta_batch` launch the kernels for CUDA tensors
and run their plain versions for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from dataclasses import dataclass
from typing import Callable

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import aggregate_dir

DISP_SCALE = 16
#: the six directions (dy, dx) of K5; a pixel (y, x) follows (y-dy, x-dx)
VERT_DIRS = ((1, 0), (1, 1), (1, -1), (-1, 0), (-1, 1), (-1, -1))
#: most warps of a band (VB_MAX_WARPS in `csrc/sgm_vert.cuh`)
MAX_BAND_COLS = 16
#: shared memory a block may opt into on an H100 (227 KiB)
SMEM_LIMIT = 232448


def wta_uniq_subpix(S: torch.Tensor, uniqueness_ratio: int):
    """(best, minS, dval, uniq) from an aggregated (..., D) int32 volume
    (ops/sgbm.py `wta_uniq_subpix`; uniq as int32 0/1)."""
    D = S.shape[-1]
    di = torch.arange(D, dtype=torch.int32, device=S.device)
    kmin = torch.amin(S * D + di, dim=-1)
    best = torch.remainder(kmin, D)
    minS = torch.div(kmin, D, rounding_mode="floor")
    bestb = best[..., None]
    outside = (di - bestb).abs() > 1
    uniq = (outside & (S * (100 - uniqueness_ratio) < minS[..., None] * 100)).any(-1)
    BIGS = 2**30
    sm = torch.amin(torch.where(di == bestb - 1, S, BIGS), dim=-1)
    sp = torch.amin(torch.where(di == bestb + 1, S, BIGS), dim=-1)
    has_nb = (best > 0) & (best < D - 1)
    sm = torch.where(best > 0, sm, minS)
    sp = torch.where(best < D - 1, sp, minS)
    denom2 = torch.clamp(sm + sp - 2 * minS, min=1)
    num = (sm - sp) * DISP_SCALE + denom2
    sub = torch.sign(num) * torch.div(num.abs(), denom2 * 2, rounding_mode="floor")
    dval = torch.where(has_nb, best * DISP_SCALE + sub, best * DISP_SCALE)
    return (best.to(torch.int32), minS.to(torch.int32), dval.to(torch.int32),
            uniq.to(torch.int32))


def sgm_vert_wta_plain(C: torch.Tensor, Sh: torch.Tensor, p1: int, p2: int,
                       uniqueness_ratio: int):
    """The plain recurrence over the six directions, then the WTA."""
    S = Sh.to(torch.int32).clone()
    for dy, dx in VERT_DIRS:
        S += aggregate_dir(C, p1, p2, dy, dx)
    return wta_uniq_subpix(S, uniqueness_ratio)


@dataclass(frozen=True)
class VertPlan:
    """Bands of the vertical scan: `m` columns a warp, `warps` warps a band,
    `bands` bands (blocks), each of warps * m contiguous columns."""
    m: int
    warps: int
    bands: int


def vert_smem_bytes(warps: int, m: int, D: int, c_bytes: int,
                    s_bytes: int) -> int:
    """A block's dynamic shared memory (`vb_smem_bytes` in
    `csrc/sgm_vert.cuh`): the diagonal carries of two row parities, with
    m > 1 the vertical carries too, and, where the D-vectors are whole
    16-byte pieces, the cp.async ring of C and S_in pixels a warp."""
    ring = 8 if D <= 128 else 4
    ring_bytes = (warps * ring * D * (c_bytes + s_bytes)
                  if D * c_bytes % 16 == 0 and D * s_bytes % 16 == 0 else 0)
    return (4 + (m > 1)) * warps * m * D * 4 + ring_bytes


def vert_plan(W1: int, D: int, resident: int, c_bytes: int = 2,
              s_bytes: int = 4, smem_limit: int = SMEM_LIMIT) -> VertPlan:
    """The bands of a W1-wide launch when `resident` blocks fit on the card
    at once: one column a warp while W1 <= MAX_BAND_COLS x resident, the
    columns spread over every resident block; beyond that the fewest
    columns a warp that keep every band resident and its shared memory
    within a block's. Raises where no plan fits."""
    if W1 < 1 or resident < 1:
        raise ValueError(f"vert_plan: W1={W1}, resident={resident}")
    m = -(-W1 // (MAX_BAND_COLS * resident))
    while m <= W1:
        warps = min(MAX_BAND_COLS, -(-W1 // (m * resident)))
        bands = -(-W1 // (warps * m))
        if (bands <= resident and
                vert_smem_bytes(warps, m, D, c_bytes, s_bytes) <= smem_limit):
            return VertPlan(m, warps, bands)
        m += 1
    raise ValueError(f"vert_plan: no band of W1={W1}, D={D} over {resident} "
                     f"blocks fits a block's shared memory")


def plan_on_card(resident_fn, W1: int, D: int, c_bytes: int,
                 s_bytes: int) -> VertPlan:
    """The plan for the card. `resident_fn(warps, m)` gives the blocks of
    the kernel resident at once (occupancy x SMs) for a band shape: sized
    first from a full band of one-column warps, then again from the shape
    chosen until every band of the plan fits."""
    resident = resident_fn(MAX_BAND_COLS, 1)
    while True:
        plan = vert_plan(W1, D, resident, c_bytes, s_bytes)
        fits = resident_fn(plan.warps, plan.m)
        if plan.bands <= fits:
            return plan
        if fits < 1 or fits >= resident:
            raise RuntimeError(f"the vertical scan cannot make {plan.bands} "
                               f"bands resident ({fits} blocks fit)")
        resident = fits


def resident_fn(lib, entry: str, *lead):
    """plan_on_card's resident_fn from a library's occupancy entry point,
    called as entry(*lead, warps, m, &blocks)."""
    fn = getattr(lib, entry)

    def resident(warps: int, m: int) -> int:
        blocks = ctypes.c_int(0)
        _build.check(lib, fn(*lead, warps, m, ctypes.byref(blocks)), entry)
        return blocks.value
    return resident


def edge_words(plan: VertPlan, D: int, device) -> torch.Tensor:
    """Each band's two edge carries, double-buffered, as zeroed (row tag,
    value) words: tag 0 names no row."""
    return torch.zeros((plan.bands, 2, 2, D), dtype=torch.int64, device=device)


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where it does not start on 32 bytes: the kernels
    move whole vectors of up to 32 bytes."""
    return t if t.data_ptr() % 32 == 0 else t.clone()


def _fn():
    lib = _build.load("sgm_vert_wta")
    fn = lib.rtdm_sgm_vert_wta
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, I, P, P, P, I, I, I, I, I, I, I, I, P, P, P, P, P]
        fn.restype = I
        for name in ("rtdm_sgm_vert_wta_resident",
                     "rtdm_sgm_vert_wta_batch_resident"):
            getattr(lib, name).argtypes = [I, I, I, I,
                                           ctypes.POINTER(ctypes.c_int)]
            getattr(lib, name).restype = I
        lib.rtdm_sgm_vert_wta_batch.argtypes = [P, I, P, P, P] + [I] * 9 + [P] * 5
        lib.rtdm_sgm_vert_wta_batch.restype = I
    return lib, fn


@functools.lru_cache(maxsize=None)
def k5_plan(W1: int, D: int, c_bytes: int, device) -> VertPlan:
    """The bands of K5's launches over an (H, W1, D) volume of c_bytes
    elements on `device`, as `sgm_vert_wta` plans them (kept per shape: the
    occupancy queries behind it cost more host time than a launch)."""
    lib, _ = _fn()
    with torch.cuda.device(device):
        return plan_on_card(resident_fn(lib, "rtdm_sgm_vert_wta_resident",
                                        c_bytes, D), W1, D, c_bytes, 4)


def sgm_vert_wta(C: torch.Tensor, Sh: torch.Tensor, p1: int, p2: int,
                 uniqueness_ratio: int):
    """(best, minS, dval, uniq), each (H, W1) int32, from the (H, W1, D)
    int16/int32 cost volume C and the (H, W1, D) int32 horizontal sum Sh.
    p2 is used as given (callers pass max(p2, p1 + 1))."""
    if C.device.type == "cpu":
        return sgm_vert_wta_plain(C, Sh, p1, p2, uniqueness_ratio)
    if C.device.type != "cuda":
        raise ValueError(f"sgm_vert_wta: unsupported device {C.device}")
    H, W1, D = C.shape
    if not 1 <= D <= 256:
        raise ValueError(f"sgm_vert_wta: unsupported D={D}")
    if C.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"C must be int16 or int32, got {C.dtype}")
    _build.require(C, "C", C.dtype)
    _build.require(Sh, "Sh", torch.int32, (H, W1, D))
    C, Sh = aligned(C), aligned(Sh)
    S = torch.empty((H, W1, D), dtype=torch.int32, device=C.device)
    outs = [torch.empty((H, W1), dtype=torch.int32, device=C.device)
            for _ in range(4)]
    lib, fn = _fn()
    cb = C.element_size()
    plan = k5_plan(W1, D, cb, C.device)
    edge = edge_words(plan, D, C.device)
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), cb, Sh.data_ptr(), S.data_ptr(), edge.data_ptr(),
                 H, W1, D, plan.warps, plan.m, int(p1), int(p2),
                 int(uniqueness_ratio), *[o.data_ptr() for o in outs],
                 _build.stream_of(C))
    sgm_vert_wta.launches += 1
    _build.check(lib, err, "sgm_vert_wta")
    return tuple(outs)


sgm_vert_wta.launches = 0


def sgm_vert_wta_batch_plain(C: torch.Tensor, Sh: torch.Tensor, p1: int,
                             p2: int, uniqueness_ratio: int):
    """`sgm_vert_wta_plain` over the frames: four (B, H, W1) int32 maps."""
    outs = [sgm_vert_wta_plain(c, s, p1, p2, uniqueness_ratio)
            for c, s in zip(C, Sh)]
    return tuple(torch.stack(o) for o in zip(*outs))


@dataclass(frozen=True)
class BatchPlan:
    """A batch in launches of `frames` frames (the last may hold fewer),
    each frame on `plan.bands` bands."""
    frames: int
    plan: VertPlan


def split_batch(B: int, plan_for: Callable[[int], VertPlan]) -> BatchPlan:
    """The fewest launches for B frames, split evenly: `plan_for(F)` plans
    a launch of F frames or raises ValueError / RuntimeError where they do
    not fit. Raises where not even one frame fits."""
    if B < 1:
        raise ValueError(f"split_batch: B={B}")
    for fmax in range(B, 0, -1):
        try:
            plan_for(fmax)
            break
        except (ValueError, RuntimeError):
            continue
    else:
        plan_for(1)  # raises why one frame does not fit
    F = -(-B // -(-B // fmax))  # B over the fewest launches, evenly
    return BatchPlan(F, plan_for(F))


def batch_plan_on_card(resident_fn, B: int, W1: int, D: int, c_bytes: int,
                       s_bytes: int) -> BatchPlan:
    """`split_batch` of `plan_on_card`, a frame of F sharing the resident
    blocks of the batched kernel `resident_fn` reports."""
    def plan_for(F):
        return plan_on_card(lambda warps, m: resident_fn(warps, m) // F, W1, D,
                            c_bytes, s_bytes)
    return split_batch(B, plan_for)


@functools.lru_cache(maxsize=None)
def k5_batch_plan(B: int, W1: int, D: int, c_bytes: int, device) -> BatchPlan:
    """The launches and bands of `sgm_vert_wta_batch` for B frames (kept per
    shape, as `k5_plan`)."""
    lib, _ = _fn()
    with torch.cuda.device(device):
        bp = batch_plan_on_card(
            resident_fn(lib, "rtdm_sgm_vert_wta_batch_resident", c_bytes, D),
            B, W1, D, c_bytes, 4)
    if bp.frames == 1 < B:
        warnings.warn(f"sgm_vert_wta_batch: one frame of W1={W1}, D={D} a "
                      f"launch, {B} launch pairs", RuntimeWarning)
    return bp


def sgm_vert_wta_batch(C: torch.Tensor, Sh: torch.Tensor, p1: int, p2: int,
                       uniqueness_ratio: int):
    """(best, minS, dval, uniq), each (B, H, W1) int32, of B frames: the
    (B, H, W1, D) int16/int32 cost volumes C and (B, H, W1, D) int32
    horizontal sums Sh; frame b equals `sgm_vert_wta(C[b], Sh[b], ...)`.
    One pair of cooperative launches for the batch, or for each group of
    `k5_batch_plan(...).frames` frames where the batch does not fit one."""
    if not _build.on_card(C, "sgm_vert_wta_batch"):
        return sgm_vert_wta_batch_plain(C, Sh, p1, p2, uniqueness_ratio)
    B, H, W1, D = C.shape
    if not 1 <= D <= 256:
        raise ValueError(f"sgm_vert_wta_batch: unsupported D={D}")
    if C.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"C must be int16 or int32, got {C.dtype}")
    _build.require(C, "C", C.dtype)
    _build.require(Sh, "Sh", torch.int32, (B, H, W1, D))
    C, Sh = aligned(C), aligned(Sh)
    dev = C.device
    S = torch.empty((B, H, W1, D), dtype=torch.int32, device=dev)
    outs = [torch.empty((B, H, W1), dtype=torch.int32, device=dev)
            for _ in range(4)]
    lib, _ = _fn()
    cb = C.element_size()
    bp = k5_batch_plan(B, W1, D, cb, dev)
    plan = bp.plan
    starts = range(0, B, bp.frames)
    edge = torch.zeros((len(starts), bp.frames, plan.bands, 2, 2, D),
                       dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        for i, b0 in enumerate(starts):
            F = min(bp.frames, B - b0)
            err = lib.rtdm_sgm_vert_wta_batch(
                C[b0].data_ptr(), cb, Sh[b0].data_ptr(), S[b0].data_ptr(),
                edge[i].data_ptr(), F, H, W1, D, plan.warps, plan.m, int(p1),
                int(p2), int(uniqueness_ratio), *[o[b0].data_ptr() for o in outs],
                _build.stream_of(C))
            sgm_vert_wta_batch.launches += 1
            _build.check(lib, err, "sgm_vert_wta_batch")
    return tuple(outs)


sgm_vert_wta_batch.launches = 0
