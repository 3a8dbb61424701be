"""K9a-K9d and K11: the chained SGM passes (`csrc/sgm_hdw.cu`).

Replaces the single-direction Pallas passes of the TPU's chained SGM route
(`rt_depth_map_tpu/ops/sgbm.py` `stereo_sgbm` without the fused
bidirectional kernels: `num_paths` 4 and 5, and 8 paths at H % 16 != 0):

- `sgm_horiz_pass`: one horizontal direction plus an optional partial,
  `rt_depth_map_tpu/ops/pallas/sgm_hdw.py` `sgm_horiz_pass_dh` (K9a) and
  `sgm_horiz_pass_hdw` (K9b). The port's volumes keep D contiguous, so the
  TPU's x-major (W1, D, H) and (W1, H, D) are one layout here, (W1, H, D)
  (`x_major=True`); the chained route scans the row-major (H, W1, D) volume
  directly (`x_major=False`), which spares it two copies of the volume.
- `sgm_vert_pass`: the three directions (dy, 0), (dy, +1), (dy, -1) plus an
  optional partial, top-down (dy = +1) or bottom-up (dy = -1):
  `sgm_hdw.py` `sgm_down_pass_hdw` (K9c) and
  `rt_depth_map_tpu/ops/pallas/sgm_scan.py` `sgm_aggregate_vertical` (K11).
- `sgm_final_wta`: the same three directions added to a partial, then the
  winner-take-all, uniqueness and subpixel outputs (best, minS, dval, uniq),
  each (H, W1) int32: `sgm_hdw.py` `sgm_final_wta_hdw` (K9d).

As on the TPU, the outputs of the first two take the cost volume's dtype:
with an int16 volume a partial holds at most five directions, which fit
int16 while 5 * (P2 - min(P1, 0)) <= 32768 (each direction's L lies in
[C - P2 + min(P1, 0), C], and `volume_dtype` bounds 5 * C); the wrappers
raise otherwise. The horizontal pass is one launch of a warp-per-row scan
fed from a ring of asynchronous copies in shared memory
(`horiz_pass_plan`), bound by device memory bytes and by its step's
integer instructions. The vertical pass
and the final pass are one cooperative launch each of K5's row-synchronous
kernel (`csrc/sgm_vert.cuh`): the three directions of a sense in one walk
over the rows, bands of columns planned as K5's (`sgm_vert_wta.py`
`plan_on_card`), reading C and the partial once and writing the sum once,
or doing the winner-take-all from registers with no scratch volume.

Each wrapper launches its kernels for CUDA tensors and runs its plain
version for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import aggregate_dir
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
    aligned,
    edge_words,
    plan_on_card,
    resident_fn,
    wta_uniq_subpix,
)

#: the dx of the three directions of a vertical set, in launch order
VERT_DX = (0, 1, -1)


def partials_fit_int16(p1: int, p2: int) -> bool:
    """Whether a sum of five directions' L fits int16 below (the volume's
    dtype rule bounds it above)."""
    return 5 * (p2 - min(p1, 0)) <= 32768


def _check(what: str, C: torch.Tensor, partial: Optional[torch.Tensor],
           p1: int, p2: int) -> None:
    """The contract shared by the three wrappers, on any device."""
    if C.dim() != 3 or not 1 <= C.shape[-1] <= 256:
        raise ValueError(f"{what}: C must be (P, Q, D) with 1 <= D <= 256, "
                         f"got {tuple(C.shape)}")
    if C.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"{what}: C must be int16 or int32, got {C.dtype}")
    if partial is not None and (partial.dtype != C.dtype
                                or partial.shape != C.shape):
        raise ValueError(f"{what}: the partial must have C's dtype and shape "
                         f"{C.dtype} {tuple(C.shape)}, got {partial.dtype} "
                         f"{tuple(partial.shape)}")
    if C.dtype == torch.int16 and not partials_fit_int16(p1, p2):
        raise ValueError(f"{what}: an int16 partial sum overflows at "
                         f"p1={p1}, p2={p2}; use an int32 volume")
    if C.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {C.device}")


P, I = _build.P, _build.I


def _fn(name: str, argtypes: list):
    """The library of `csrc/sgm_hdw.cu` and its entry point `name`."""
    lib = _build.load("sgm_hdw")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = I
    return lib, fn


@functools.lru_cache(maxsize=None)
def chained_plan(W1: int, D: int, c_bytes: int, wta: bool, device):
    """The bands of the vertical pass (wta False) or the final pass over an
    (H, W1, D) volume of c_bytes elements on `device`, as the wrappers plan
    them (kept per shape, as K5's)."""
    lib, _ = _fn("rtdm_sgm_vert_resident",
                 [I, I, I, I, I, ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(device):
        return plan_on_card(resident_fn(lib, "rtdm_sgm_vert_resident", c_bytes,
                                        int(wta), D), W1, D, c_bytes, c_bytes)


def _rows(V: torch.Tensor, x_major: bool) -> torch.Tensor:
    """The (H, W1, D) view of a row-major or x-major volume."""
    return V.transpose(0, 1) if x_major else V


# -- K9a / K9b ---------------------------------------------------------------

#: bytes of C (and the partial) the horizontal pass keeps in flight on each
#: SM, shared by the warps there (one a row): the ring depth that was
#: fastest at 1920x1080 D=256 (4 slots) and 1280x720 D=128 (16 without a
#: partial, 8 with one) on an H100, `tools/time_torch_horiz_pass.py --sweep`
HORIZ_IN_FLIGHT_SM = 12 * 1024
#: rows (one warp each) a block of the horizontal pass: 1, 2 and 4 time
#: within 1% of each other there
HORIZ_ROWS = 2
HORIZ_RINGS = (4, 8, 16)
#: bytes of a warp's ring at most (`csrc/sgm_hdw.cu` HP_RING_BYTES)
HORIZ_RING_BYTES = 16384


class HorizPlan(NamedTuple):
    ring: int  # slots a warp: a slot is one pixel's C (and partial) vector
    rows: int  # warps a block
    smem: int  # shared memory bytes a block (0 on the register path)
    ring_path: bool  # False: pixels are not whole 16-byte pieces


def horiz_pass_plan(D: int, c_bytes: int, with_partial: bool, H: int,
                    sms: int) -> HorizPlan:
    """The launch plan of `csrc/sgm_hdw.cu` `rtdm_sgm_horiz_pass` for H rows
    of D disparities of c_bytes each on a card of `sms` SMs (a pure
    function): the fewest ring slots that keep a warp's share of
    HORIZ_IN_FLIGHT_SM ahead of its step (ring - 1 slots are in flight),
    within HORIZ_RING_BYTES a warp, and whether the ring path applies (each
    pixel's D elements are whole 16-byte pieces; the wrapper aligns the
    volumes)."""
    slot = D * c_bytes * (2 if with_partial else 1)
    per_warp = HORIZ_IN_FLIGHT_SM / -(-H // sms)
    rings = [r for r in HORIZ_RINGS if r == HORIZ_RINGS[0] or r * slot <= HORIZ_RING_BYTES]
    ring = next((r for r in rings if (r - 1) * slot >= per_warp), rings[-1])
    ring_path = D * c_bytes % 16 == 0
    return HorizPlan(ring, HORIZ_ROWS, HORIZ_ROWS * ring * slot if ring_path else 0,
                     ring_path)


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def sgm_horiz_pass_plain(C: torch.Tensor, p1: int, p2: int,
                         reverse: bool = False,
                         partial: Optional[torch.Tensor] = None,
                         x_major: bool = False) -> torch.Tensor:
    """L of the direction (0, -1 if reverse else +1) plus `partial`, in C's
    dtype and layout."""
    Cr = _rows(C, x_major)
    S = aggregate_dir(Cr, p1, p2, 0, -1 if reverse else 1)
    if partial is not None:
        S += _rows(partial, x_major)
    out = S.to(C.dtype)
    return out.transpose(0, 1).contiguous() if x_major else out


def sgm_horiz_pass(C: torch.Tensor, p1: int, p2: int, reverse: bool = False,
                   partial: Optional[torch.Tensor] = None,
                   x_major: bool = False) -> torch.Tensor:
    """One horizontal SGM direction, left to right (reverse=False) or right
    to left, plus `partial` when given, over the row-major (H, W1, D) volume
    C or, with x_major, the (W1, H, D) one. The output has C's dtype and
    layout. p2 is used as given (callers pass max(p2, p1 + 1))."""
    _check("sgm_horiz_pass", C, partial, p1, p2)
    if C.device.type == "cpu":
        return sgm_horiz_pass_plain(C, p1, p2, reverse, partial, x_major)
    _build.require(C, "C", C.dtype)
    if partial is not None:
        _build.require(partial, "partial", C.dtype, C.shape)
    C = aligned(C)
    partial = None if partial is None else aligned(partial)
    A, B, D = C.shape
    H, W1 = (B, A) if x_major else (A, B)
    out = torch.empty_like(C)
    plan = horiz_pass_plan(D, C.element_size(), partial is not None, H,
                           _sms(C.device))
    lib, fn = _fn("rtdm_sgm_horiz_pass", [P, I, P, P, I, I, I, I, I, I, I, I, I, P])
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), C.element_size(),
                 None if partial is None else partial.data_ptr(),
                 out.data_ptr(), H, W1, D, int(x_major), int(reverse),
                 int(p1), int(p2), plan.ring, plan.rows, _build.stream_of(C))
    sgm_horiz_pass.launches += 1
    _build.check(lib, err, "sgm_horiz_pass")
    return out


sgm_horiz_pass.launches = 0


# -- K9c / K11 ---------------------------------------------------------------

def sgm_vert_pass_plain(C: torch.Tensor, p1: int, p2: int,
                        reverse: bool = False,
                        partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """partial + L(dy, 0) + L(dy, +1) + L(dy, -1), dy = -1 if reverse else
    +1, (H, W1, D) in C's dtype."""
    dy = -1 if reverse else 1
    S = (torch.zeros(C.shape, dtype=torch.int32, device=C.device)
         if partial is None else partial.to(torch.int32))
    for dx in VERT_DX:
        S = S + aggregate_dir(C, p1, p2, dy, dx)
    return S.to(C.dtype)


def sgm_vert_pass(C: torch.Tensor, p1: int, p2: int, reverse: bool = False,
                  partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The three top-down (reverse=False) or bottom-up SGM directions over
    the (H, W1, D) volume C, plus `partial` when given; the output has C's
    dtype. p2 is used as given (callers pass max(p2, p1 + 1))."""
    _check("sgm_vert_pass", C, partial, p1, p2)
    if C.device.type == "cpu":
        return sgm_vert_pass_plain(C, p1, p2, reverse, partial)
    _build.require(C, "C", C.dtype)
    if partial is not None:
        _build.require(partial, "partial", C.dtype, C.shape)
    C = aligned(C)
    partial = None if partial is None else aligned(partial)
    H, W1, D = C.shape
    out = torch.empty_like(C)
    lib, fn = _fn("rtdm_sgm_vert_pass", [P, I, P, P, P, I, I, I, I, I, I, I, I, P])
    plan = chained_plan(W1, D, C.element_size(), False, C.device)
    edge = edge_words(plan, D, C.device)
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), C.element_size(),
                 None if partial is None else partial.data_ptr(),
                 out.data_ptr(), edge.data_ptr(), H, W1, D, plan.warps, plan.m,
                 int(reverse), int(p1), int(p2), _build.stream_of(C))
    sgm_vert_pass.launches += 1
    _build.check(lib, err, "sgm_vert_pass")
    return out


sgm_vert_pass.launches = 0


# -- K9d ---------------------------------------------------------------------

def sgm_final_wta_plain(C: torch.Tensor, S_partial: torch.Tensor, p1: int,
                        p2: int, uniqueness_ratio: int, reverse: bool = True):
    """wta_uniq_subpix(S_partial + the three vertical directions)."""
    dy = -1 if reverse else 1
    S = S_partial.to(torch.int32)
    for dx in VERT_DX:
        S = S + aggregate_dir(C, p1, p2, dy, dx)
    return wta_uniq_subpix(S, uniqueness_ratio)


def sgm_final_wta(C: torch.Tensor, S_partial: torch.Tensor, p1: int, p2: int,
                  uniqueness_ratio: int, reverse: bool = True):
    """(best, minS, dval, uniq), each (H, W1) int32, of S_partial plus the
    three bottom-up (reverse=True, the 8-path finish) or top-down (the 4-
    and 5-path finish) SGM directions over the (H, W1, D) volume C. p2 is
    used as given (callers pass max(p2, p1 + 1))."""
    _check("sgm_final_wta", C, S_partial, p1, p2)
    if C.device.type == "cpu":
        return sgm_final_wta_plain(C, S_partial, p1, p2, uniqueness_ratio,
                                   reverse)
    _build.require(C, "C", C.dtype)
    _build.require(S_partial, "S_partial", C.dtype, C.shape)
    C, S_partial = aligned(C), aligned(S_partial)
    H, W1, D = C.shape
    outs = [torch.empty((H, W1), dtype=torch.int32, device=C.device)
            for _ in range(4)]
    lib, fn = _fn("rtdm_sgm_final_wta",
                  [P, I, P, P, I, I, I, I, I, I, I, I, I, P, P, P, P, P])
    plan = chained_plan(W1, D, C.element_size(), True, C.device)
    edge = edge_words(plan, D, C.device)
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), C.element_size(), S_partial.data_ptr(),
                 edge.data_ptr(), H, W1, D, plan.warps, plan.m, int(reverse),
                 int(p1), int(p2), int(uniqueness_ratio),
                 *[o.data_ptr() for o in outs], _build.stream_of(C))
    sgm_final_wta.launches += 1
    _build.check(lib, err, "sgm_final_wta")
    return tuple(outs)


sgm_final_wta.launches = 0
