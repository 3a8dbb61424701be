"""K5: six vertical/diagonal SGM paths + winner-take-all (`csrc/sgm_vert_wta.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/sgm_bidir.py` `sgm_vert_bidir_wta_hdw`:
from the cost volume C and the horizontal sum Sh (K4), the total
S = Sh + L(+1,0) + L(+1,+1) + L(+1,-1) + L(-1,0) + L(-1,+1) + L(-1,-1) and,
per pixel, (best, minS, dval, uniq), each (H, W1) int32: the winner (ties to
the smallest d), its cost, the x16 subpixel disparity without the
min_disparity offset, and 1 where the SGBM uniqueness test fails.

On the H100 two row-synchronous launches do it (`csrc/sgm_vert_wta.cu`):
the first walks the rows down with the three top-down directions and writes
S = Sh + their L once; the second walks up with the other three and does
the winner-take-all from registers. A block owns a band of columns (as many
as spread W1 over the card's SMs, at most 16), a warp per column; the
diagonal carries cross columns through shared memory inside a band and
through row-tagged device-memory slots between bands, so every band must be
resident at once: the launches are cooperative, and a shape whose bands
cannot all be resident (W1 > 16 x the card's SMs) is refused and raises.

`sgm_vert_wta` launches the kernels for CUDA tensors and runs
`sgm_vert_wta_plain` for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import aggregate_dir

DISP_SCALE = 16
#: the six directions (dy, dx) of K5; a pixel (y, x) follows (y-dy, x-dx)
VERT_DIRS = ((1, 0), (1, 1), (1, -1), (-1, 0), (-1, 1), (-1, -1))
#: most columns of a band, one warp each (VB_MAX_COLS in
#: `csrc/sgm_vert_wta.cu`)
MAX_BAND_COLS = 16


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


def band_cols(W1: int, device) -> int:
    """Columns of a band of the kernel on `device`: one band per SM where
    the columns allow it (every band must be resident at once)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(MAX_BAND_COLS, -(-W1 // sms))


def _fn():
    lib = _build.load("sgm_vert_wta")
    fn = lib.rtdm_sgm_vert_wta
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, I, P, P, P, I, I, I, I, I, I, I, P, P, P, P, P]
        fn.restype = I
    return lib, fn


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
    # the kernels move whole vectors of up to 32 bytes: a view that starts
    # off that alignment is copied
    C = C if C.data_ptr() % 32 == 0 else C.clone()
    Sh = Sh if Sh.data_ptr() % 32 == 0 else Sh.clone()
    S = torch.empty((H, W1, D), dtype=torch.int32, device=C.device)
    cols = band_cols(W1, C.device)
    bands = -(-W1 // cols)
    # each band's two edge carries, double-buffered, as (row tag, value)
    # words; tag 0 names no row
    edge = torch.zeros((bands, 2, 2, D), dtype=torch.int64, device=C.device)
    outs = [torch.empty((H, W1), dtype=torch.int32, device=C.device)
            for _ in range(4)]
    lib, fn = _fn()
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), C.element_size(), Sh.data_ptr(), S.data_ptr(),
                 edge.data_ptr(), H, W1, D, cols, int(p1), int(p2),
                 int(uniqueness_ratio), *[o.data_ptr() for o in outs],
                 _build.stream_of(C))
    sgm_vert_wta.launches += 1
    _build.check(lib, err, "sgm_vert_wta")
    return tuple(outs)


sgm_vert_wta.launches = 0
