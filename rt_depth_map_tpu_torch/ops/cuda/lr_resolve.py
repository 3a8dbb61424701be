"""K6: left-right consistency resolution, and the SGBM and BM left-right
checks built on it (`csrc/lr_resolve.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/lr_resolve.py` `lr_resolve_pallas`.
The TPU kernel runs both steps as shift-reduces over every candidate
disparity; on the H100 the winner step is a scatter with shared-memory
`atomicMin` on the row (min is order-independent, so the result is
deterministic) and the read-back a gather, O(1) work per pixel. One device
routine resolves a block of rows for three entry points:

- `lr_resolve`, the counterpart of `lr_resolve_pallas` with its general
  signature (n_w, r_lo, n_r, Dpow, c0, invalid) on int32 planes, one or two
  read-back planes, and the winner window's start w_lo (0 in the Pallas
  contract; the checks start it at min_disparity);
- `lr_resolve_sgbm`, the SGBM matcher's inline check (`ops/sgbm.py`
  `lr_check_sgbm`), one launch from the matcher's own outputs (the int16
  disparity, `best` and `minS`) to the checked int16 disparity, in place of
  the key planes of `lr_key_planes_sgbm`, the general resolve and the
  comparisons of `lr_resolve_sgbm_plain`;
- `lr_resolve_bm`, the BM matcher's check (`ops/bm.py` `lr_check`), the same
  from the int16 disparity and the winner's cost.

Each launches for CUDA tensors and runs its plain version for CPU tensors;
any other device raises. The plain versions of the two checks are the
composed functions the port ran before it had their entries:
`lr_key_planes_*`, `lr_resolve_plain` and torch comparisons. Both checks
take min_disparity minD: the invalid value is (minD - 1) * 16 (`invalid`)
and the disparity windows start at minD.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build

BIGKEY = 2**31 - 1
SENT = -(2**31)
DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
#: the SGBM key packs (minS, best): best < D <= 256
SGBM_DPOW = 256
#: the BM key packs (cost, d + 2048), d the x16 disparity; where d + 2048
#: leaves [0, 8192) (minD < -127 or minD + D > 383) the key wraps exactly as
#: the reference's int32 arithmetic and floor-mod decode do
BM_DPOW = 1 << 13
BM_OFF = 1 << 11
#: the pixels a thread can hold (template instances of `csrc/lr_resolve.cu`)
LR_PXS = (1, 2, 4, 8)
#: pixels of a row a thread holds where the row fits 1024 threads, and rows
#: a block (tools/time_torch_lr_speckle.py --ablate: 4 pixels a thread beat
#: 8 by a third at 1920x1080 and matched 2; more rows a block gained nothing)
LR_PX = 4
LR_ROWS = 1


def invalid_value(min_disp: int) -> int:
    """The matchers' invalid disparity, (min_disparity - 1) * 16."""
    return (min_disp - 1) * DISP_SCALE


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def lr_plan(W: int):
    """(pixels a thread, threads a row, rows a block) of a launch over rows
    of W pixels: LR_PX pixels a thread, or the fewest of LR_PXS above it
    that keep a row in 1024 threads (whole warps), and as many of LR_ROWS
    rows as 1024 threads hold."""
    for px in LR_PXS:
        tx = max(32, _ceil(_ceil(W, px), 32) * 32)
        if px >= LR_PX and tx <= 1024:
            return px, tx, max(1, min(LR_ROWS, 1024 // tx))
    raise ValueError(f"lr_resolve: rows of {W} pixels, the kernel takes at "
                     f"most {1024 * LR_PXS[-1]}")


def lr_resolve_plain(d_match: torch.Tensor, key: torch.Tensor, rms: tuple, *,
                     n_w: int, r_lo: int, n_r: int, Dpow: int, c0: int,
                     invalid: int, w_lo: int = 0):
    """Read-back planes (one per rm in `rms`), with torch scatter/gather."""
    H, W = d_match.shape
    dev = d_match.device
    xs = torch.arange(W, dtype=torch.int64, device=dev)
    ys = torch.arange(H, dtype=torch.int64, device=dev)[:, None]
    dm = d_match.long()
    x2 = xs - dm
    cand = (dm >= w_lo) & (dm < w_lo + n_w) & (x2 >= 0) & (x2 < W)
    target = torch.where(cand, ys * W + x2, H * W).reshape(-1)
    best = torch.full((H * W + 1,), BIGKEY, dtype=torch.int32, device=dev)
    best = best.scatter_reduce(0, target, key.reshape(-1).to(torch.int32),
                               "amin", include_self=True)[: H * W].reshape(H, W)
    disp2 = torch.where(best != BIGKEY, (best & (Dpow - 1)) + c0, invalid)
    outs = []
    for rm in rms:
        r = rm.long()
        src = xs - r
        ok = (r >= r_lo) & (r < r_lo + n_r) & (src >= 0) & (src < W)
        vals = torch.gather(disp2, 1, src.clamp(0, W - 1))
        outs.append(torch.where(ok, vals, invalid).to(torch.int32))
    return tuple(outs)


def lr_key_planes_sgbm(disp: torch.Tensor, best: torch.Tensor,
                       minS: torch.Tensor, minX1: int, width1: int,
                       num_disp: int, min_disp: int = 0):
    """The general resolve's inputs for the inline SGBM check, (d_int, key,
    reads, kwargs): each column's winner best + min_disp and packed (minS,
    best) key over the full width (sentinels outside [minX1, minX1 + width1)
    and where the match leaves the image), the two read-back planes (the
    floor and the ceiling of the x16 disparity), and the resolve's
    parameters."""
    H, W = disp.shape
    dev = disp.device
    bad_value = invalid_value(min_disp)
    d16 = disp.to(torch.int32)
    xs1 = torch.arange(width1, dtype=torch.int32, device=dev) + minX1
    valid1 = d16[:, minX1: minX1 + width1] != bad_value
    x2 = xs1 - (best + min_disp)
    in_rng = valid1 & (x2 >= 0) & (x2 < W)
    keyW = torch.full((H, W), BIGKEY, dtype=torch.int32, device=dev)
    keyW[:, minX1: minX1 + width1] = torch.where(in_rng, minS * SGBM_DPOW + best,
                                                 BIGKEY)
    d_intW = torch.full((H, W), SENT, dtype=torch.int32, device=dev)
    d_intW[:, minX1: minX1 + width1] = best + min_disp
    reads = ((d16 >> DISP_SHIFT).contiguous(),
             ((d16 + DISP_SCALE - 1) >> DISP_SHIFT).contiguous())
    kw = dict(n_w=num_disp, w_lo=min_disp, r_lo=min_disp - 1, n_r=num_disp + 2,
              Dpow=SGBM_DPOW, c0=min_disp, invalid=bad_value)
    return d_intW, keyW, reads, kw


def lr_resolve_sgbm_plain(disp: torch.Tensor, best: torch.Tensor,
                          minS: torch.Tensor, minX1: int, width1: int,
                          num_disp: int, max_diff: int,
                          min_disp: int = 0) -> torch.Tensor:
    """The inline SGBM left-right check (rt_depth_map_tpu/ops/sgbm.py
    `_lr_check_sgbm`): the right view's winner per column from the packed
    (minS, best) keys, read back at both the floor and the ceiling of each
    pixel's disparity; a pixel is invalid only when BOTH read-backs disagree
    by more than max_diff (a read-back below min_disp never disagrees; an
    invalid one is (min_disp - 1) * 16, as the reference compares it)."""
    W = disp.shape[1]
    d_intW, keyW, reads, kw = lr_key_planes_sgbm(disp, best, minS, minX1,
                                                 width1, num_disp, min_disp)
    bad_value = kw["invalid"]
    d_lo, d_hi = reads
    xsW = torch.arange(W, dtype=torch.int32, device=disp.device)
    ok_range = (xsW >= minX1) & (xsW < minX1 + width1)
    validW = ok_range & (disp != bad_value)
    oka = ((xsW - d_lo) >= 0) & ((xsW - d_lo) < W)
    okb = ((xsW - d_hi) >= 0) & ((xsW - d_hi) < W)
    d2a, d2b = lr_resolve_plain(d_intW, keyW, reads, **kw)
    d2a = torch.where(oka, d2a, bad_value)
    d2b = torch.where(okb, d2b, bad_value)
    bad = (validW
           & oka & (d2a >= min_disp) & ((d2a - d_lo).abs() > max_diff)
           & okb & (d2b >= min_disp) & ((d2b - d_hi).abs() > max_diff))
    return torch.where(bad, torch.full_like(disp, bad_value), disp)


def lr_key_planes_bm(disp: torch.Tensor, cost: torch.Tensor, min_disp: int = 0):
    """(d32, in_range, d_int, key) of the BM check: the x16 disparity as
    int32, where its match x - round(d) lies in the image, the rounded
    disparity, and the packed (cost, d) key (2^31-1 outside in_range)."""
    W = disp.shape[1]
    d32 = disp.to(torch.int32)
    d_int = (d32 + DISP_SCALE // 2) >> DISP_SHIFT
    x2 = torch.arange(W, dtype=torch.int32, device=disp.device) - d_int
    in_range = (d32 != invalid_value(min_disp)) & (x2 >= 0) & (x2 < W)
    key = torch.where(in_range, cost * BM_DPOW + (d32 + BM_OFF), BIGKEY)
    return d32, in_range, d_int, key.to(torch.int32)


def lr_bm_kwargs(num_disp: int, min_disp: int = 0) -> dict:
    """The general resolve's parameters for the BM check: winner and
    read-back over [min_disp, min_disp + D]."""
    return dict(n_w=num_disp + 1, w_lo=min_disp, r_lo=min_disp,
                n_r=num_disp + 1, Dpow=BM_DPOW, c0=-BM_OFF,
                invalid=invalid_value(min_disp))


def lr_resolve_bm_plain(disp: torch.Tensor, cost: torch.Tensor, num_disp: int,
                        max_diff: int, min_disp: int = 0) -> torch.Tensor:
    """cv::validateDisparity parity (rt_depth_map_tpu/ops/bm.py `_lr_check`):
    pixels whose right-view match disagrees by more than max_diff become
    invalid; projections outside the image are left untouched."""
    bad_value = invalid_value(min_disp)
    d32, in_range, d_int, key = lr_key_planes_bm(disp, cost, min_disp)
    (rb,) = lr_resolve_plain(d_int, key, (d_int,),
                             **lr_bm_kwargs(num_disp, min_disp))
    disp2_at = torch.where(in_range, rb, bad_value)
    bad = in_range & ((disp2_at - d32).abs() > max_diff * DISP_SCALE)
    return torch.where(bad, torch.full_like(disp, bad_value), disp)


def _fn(entry: str, argtypes):
    lib = _build.load("lr_resolve")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _build.I
    return lib, fn


def lr_resolve(d_match: torch.Tensor, key: torch.Tensor, rms: tuple, *,
               n_w: int, r_lo: int, n_r: int, Dpow: int, c0: int,
               invalid: int, w_lo: int = 0):
    """Read-back planes, one (H, W) int32 per rm in `rms` (one or two).

    d_match/key: (H, W) int32 candidate-disparity and packed-key planes (key
    already 2^31-1 at non-candidates). The winner search runs over dd in
    [w_lo, w_lo + n_w) (the Pallas kernel's [0, n_w) at w_lo 0); the
    read-back over dd in [r_lo, r_lo + n_r), and pixels whose rm lies
    outside that range, or whose x - rm leaves the row, get `invalid`. Dpow
    must be a power of two."""
    if Dpow <= 0 or Dpow & (Dpow - 1):
        raise ValueError("Dpow must be a power of two")
    if not 1 <= len(rms) <= 2:
        raise ValueError(f"lr_resolve: {len(rms)} read-back planes, it takes 1 or 2")
    if not _build.on_card(d_match, "lr_resolve"):
        return lr_resolve_plain(d_match, key, rms, n_w=n_w, r_lo=r_lo,
                                n_r=n_r, Dpow=Dpow, c0=c0, invalid=invalid,
                                w_lo=w_lo)
    H, W = d_match.shape
    _build.require(d_match, "d_match", torch.int32)
    _build.require(key, "key", torch.int32, (H, W))
    for i, rm in enumerate(rms):
        _build.require(rm, f"rms[{i}]", torch.int32, (H, W))
    out = torch.empty((len(rms), H, W), dtype=torch.int32, device=d_match.device)
    P, I = _build.P, _build.I
    px, _, rows = lr_plan(W)
    lib, fn = _fn("rtdm_lr_resolve", [P, P, P, P] + [I] * 12 + [P, P])
    with torch.cuda.device(d_match.device):
        err = fn(d_match.data_ptr(), key.data_ptr(), rms[0].data_ptr(),
                 rms[-1].data_ptr(), len(rms), H, W, w_lo, n_w, r_lo, n_r, Dpow,
                 c0, invalid, px, rows, out.data_ptr(), _build.stream_of(d_match))
    _build.check(lib, err, "lr_resolve")
    lr_resolve.launches += 1
    return tuple(out.unbind(0))


def lr_resolve_sgbm(disp: torch.Tensor, best: torch.Tensor, minS: torch.Tensor,
                    minX1: int, width1: int, num_disp: int,
                    max_diff: int, min_disp: int = 0) -> torch.Tensor:
    """The inline SGBM check in one launch: `lr_resolve_sgbm_plain`. disp:
    (H, W) int16 x16; best, minS: (H, width1) int32 over the columns
    [minX1, minX1 + width1), best the disparity index (best + min_disp the
    disparity); num_disp <= 256."""
    if not _build.on_card(disp, "lr_resolve_sgbm"):
        return lr_resolve_sgbm_plain(disp, best, minS, minX1, width1, num_disp,
                                     max_diff, min_disp)
    H, W = disp.shape
    if not (0 <= minX1 and width1 >= 0 and minX1 + width1 <= W
            and 0 < num_disp <= SGBM_DPOW):
        raise ValueError(f"lr_resolve_sgbm: columns [{minX1}, {minX1 + width1}) "
                         f"of {W}, D={num_disp} (at most {SGBM_DPOW})")
    _build.require(disp, "disp", torch.int16)
    _build.require(best, "best", torch.int32, (H, width1))
    _build.require(minS, "minS", torch.int32, (H, width1))
    out = torch.empty_like(disp)
    P, I = _build.P, _build.I
    px, _, rows = lr_plan(W)
    lib, fn = _fn("rtdm_lr_check_sgbm", [P, P, P] + [I] * 9 + [P, P])
    with torch.cuda.device(disp.device):
        err = fn(disp.data_ptr(), best.data_ptr(), minS.data_ptr(), H, W, minX1,
                 width1, num_disp, min_disp, max_diff, px, rows, out.data_ptr(),
                 _build.stream_of(disp))
    _build.check(lib, err, "lr_resolve_sgbm")
    lr_resolve_sgbm.launches += 1
    return out


def lr_resolve_bm(disp: torch.Tensor, cost: torch.Tensor, num_disp: int,
                  max_diff: int, min_disp: int = 0) -> torch.Tensor:
    """The BM check in one launch: `lr_resolve_bm_plain`. disp: (H, W)
    int16 x16; cost: (H, W) int32; num_disp <= 384 (K8's limit)."""
    if not _build.on_card(disp, "lr_resolve_bm"):
        return lr_resolve_bm_plain(disp, cost, num_disp, max_diff, min_disp)
    H, W = disp.shape
    if not 0 < num_disp <= (BM_DPOW - BM_OFF) // DISP_SCALE:
        raise ValueError(f"lr_resolve_bm: D={num_disp}, the key holds at most "
                         f"{(BM_DPOW - BM_OFF) // DISP_SCALE}")
    _build.require(disp, "disp", torch.int16)
    _build.require(cost, "cost", torch.int32, (H, W))
    out = torch.empty_like(disp)
    P, I = _build.P, _build.I
    px, _, rows = lr_plan(W)
    lib, fn = _fn("rtdm_lr_check_bm", [P, P] + [I] * 7 + [P, P])
    with torch.cuda.device(disp.device):
        err = fn(disp.data_ptr(), cost.data_ptr(), H, W, num_disp, min_disp,
                 max_diff, px, rows, out.data_ptr(), _build.stream_of(disp))
    _build.check(lib, err, "lr_resolve_bm")
    lr_resolve_bm.launches += 1
    return out


lr_resolve.launches = 0
lr_resolve_sgbm.launches = 0
lr_resolve_bm.launches = 0
