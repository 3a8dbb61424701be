"""K4: the two horizontal SGM paths, Sh = L(0,+1) + L(0,-1) (`csrc/sgm_horiz.cu`).

Replaces `rt_depth_map_tpu/ops/pallas/sgm_bidir.py` `sgm_horiz_bidir_dh`.
As on the TPU, it works on an x-major volume that K12 (`vol_transpose`)
writes: the TPU's is (W1, D, H), the port's (W1, H, D) with D contiguous. A
warp walks a row with D spread over its lanes (the step of
`csrc/sgm_path.cuh`, the design of arXiv 1610.04121). One launch runs both
directions at once, two warps a row that meet in the middle as the TPU
kernel's chains do, each fed from a ring of `cp.async` copies in shared
memory. The kernel is bound by device memory bytes.

Also holds the plain SGM recurrence (`sgm_step`, `aggregate_dir`) of
`rt_depth_map_tpu/ops/sgbm.py`, which the plain versions of K5 and of the
chained passes (`sgm_hdw.py`) and `ops/sgbm.py` `aggregate_cost` reuse.

`sgm_horiz` launches the kernel for CUDA tensors and runs `sgm_horiz_plain`
for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build

MAX_COST = 32767


def sgm_step(Crow: torch.Tensor, Lp: torch.Tensor, p1: int,
             p2: int) -> torch.Tensor:
    """One SGM recurrence step over (N, D) int32 (ops/sgbm.py `_sgm_step`):
    zero Lp rows reproduce OpenCV's zero border."""
    N = Lp.shape[0]
    minLp = Lp.amin(dim=1, keepdim=True)
    fill = torch.full((N, 1), MAX_COST, dtype=Lp.dtype, device=Lp.device)
    lm = torch.cat([fill, Lp[:, :-1]], dim=1)
    lq = torch.cat([Lp[:, 1:], fill], dim=1)
    delta = minLp + p2
    m = torch.minimum(torch.minimum(Lp, lm + p1), torch.minimum(lq + p1, delta))
    return Crow + m - delta


def aggregate_dir(C: torch.Tensor, p1: int, p2: int, dy: int,
                  dx: int) -> torch.Tensor:
    """(H, W1, D) int32 L of direction (dy, dx), a pixel (y, x) following
    (y - dy, x - dx) (ops/sgbm.py `_aggregate_dir`)."""
    H, W1, D = C.shape
    C = C.to(torch.int32)
    out = torch.empty((H, W1, D), dtype=torch.int32, device=C.device)
    if dy == 0:
        L = torch.zeros((H, D), dtype=torch.int32, device=C.device)
        for x in (range(W1) if dx > 0 else range(W1 - 1, -1, -1)):
            L = sgm_step(C[:, x], L, p1, p2)
            out[:, x] = L
        return out
    L = torch.zeros((W1, D), dtype=torch.int32, device=C.device)
    zero = torch.zeros((abs(dx), D), dtype=torch.int32, device=C.device)
    for y in (range(H) if dy > 0 else range(H - 1, -1, -1)):
        if dx > 0:
            Lp = torch.cat([zero, L[:-dx]], dim=0)
        elif dx < 0:
            Lp = torch.cat([L[-dx:], zero], dim=0)
        else:
            Lp = L
        L = sgm_step(C[y], Lp, p1, p2)
        out[y] = L
    return out


def sgm_horiz_plain(Ct: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """Sh (W1, H, D) int32 of the x-major (W1, H, D) cost volume Ct: the sum
    of the two horizontal paths."""
    C = Ct.transpose(0, 1)
    Sh = aggregate_dir(C, p1, p2, 0, 1) + aggregate_dir(C, p1, p2, 0, -1)
    return Sh.transpose(0, 1).contiguous()


def _fn():
    lib = _build.load("sgm_horiz")
    fn = lib.rtdm_sgm_horiz
    if fn.argtypes is None:
        P, I = _build.P, _build.I
        fn.argtypes = [P, I, P, I, I, I, I, I, P]
        fn.restype = I
    return lib, fn


def sgm_horiz(Ct: torch.Tensor, p1: int, p2: int) -> torch.Tensor:
    """Sh = L(0,+1) + L(0,-1), x-major (W1, H, D) int32, of the x-major
    (W1, H, D) int16 or int32 cost volume Ct. p2 is used as given (callers
    pass max(p2, p1 + 1))."""
    if Ct.device.type == "cpu":
        return sgm_horiz_plain(Ct, p1, p2)
    if Ct.device.type != "cuda":
        raise ValueError(f"sgm_horiz: unsupported device {Ct.device}")
    W1, H, D = Ct.shape
    if not 1 <= D <= 256:
        raise ValueError(f"sgm_horiz: unsupported D={D}")
    if Ct.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"Ct must be int16 or int32, got {Ct.dtype}")
    _build.require(Ct, "Ct", Ct.dtype)
    Sh = torch.empty((W1, H, D), dtype=torch.int32, device=Ct.device)
    lib, fn = _fn()
    with torch.cuda.device(Ct.device):
        err = fn(Ct.data_ptr(), Ct.element_size(), Sh.data_ptr(), H, W1, D,
                 int(p1), int(p2), _build.stream_of(Ct))
    sgm_horiz.launches += 1
    _build.check(lib, err, "sgm_horiz")
    return Sh


sgm_horiz.launches = 0
