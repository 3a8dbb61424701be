"""The SGM scans of one tile of the exact width tiling (`csrc/sgm_tile.cu`).

Kernels for a stage the reference left to XLA: no Pallas kernel stands
behind them. `rt_depth_map_tpu/parallel/exact_sgbm.py` scans a tile's row
block with two `lax.scan`s (`_diag_core`, `_horiz_core`,
exact_sgbm.py:159-184) and its vertical paths with `ops/sgbm.py`
`_aggregate_dir`, then runs `wta_uniq_subpix` on the tile's sum
(exact_sgbm.py:337-343); on the card a step a launch would be ~10^5 small
launches a 720p frame. Two entry points:

- `sgm_tile_scan` runs a list of `ScanJob`s, one wavefront step of the
  tile's cross-tile directions, in one ordinary launch: a warp a line (a
  row of a horizontal job, a diagonal of a diagonal one), D over its lanes,
  each warp's next costs copied ahead into a ring in shared memory with
  cp.async, its L staged in shared memory and added into S with atomic
  adds, 32 consecutive words an instruction (the jobs of a launch may
  cover the same pixels; integer sums do not depend on the order, so S is
  exact). It takes no vertical job (dx = 0) on the card: those are
  `sgm_tile_final`'s. Nothing is kept between launches, so a step can be
  captured in a CUDA graph.
- `sgm_tile_final` runs the tile's vertical paths ((+1, 0), and (-1, 0) at
  8 paths) and the winner-take-all in one launch: two warps a column walk
  down and up and meet in the middle row, the second halves end each
  pixel's total in registers, where K5's winner-take-all writes (best,
  minS, dval, uniq).

A job is one direction (dy, dx) (a pixel (y, x) following (y - dy, x - dx))
over the rows [row0, row0 + rows) of the tile's (H, W, D) cost volume C,
scanned top-down for dy = +1, bottom-up for dy = -1. Its carries:

- `inbox` (rows + 1, D): the neighbour tile's edge-column L in global row
  order, m[i] at row row0 - 1 + i for dy >= 0, at row row0 + i for
  dy = -1 (exact_sgbm.py's message layout); None is zeros (a tile at the
  mesh's edge: OpenCV's zero border);
- `prev` (W, D): the L of the row before the block in scan order, in
  global column order (the reference keeps it in its flipped "core"
  order); None is zeros.

It adds its L into S (in place) and returns, for dx != 0, the new outbox
(the L of its edge column toward the next tile, x = W - 1 for dx = +1 and
0 for dx = -1, with the old outbox's row of the block before, m[0] = old
m[rows] for dy >= 0 and m[rows] = old m[0] for dy = -1) and, for dy != 0
as well, the new prev (the L of its last row in scan order).

Both wrappers launch their kernel for CUDA tensors and run their plain
version (`sgm_tile_scan_plain`, the reference's scans on `sgm_horiz.py`
`sgm_step`, every direction; `sgm_tile_final_plain`, those scans then
`wta_uniq_subpix`) for CPU tensors; any other device raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from rt_depth_map_tpu_torch.ops.cuda import _build
from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_step
from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import wta_uniq_subpix

#: the most jobs a launch takes (TS_MAX_JOBS in `csrc/sgm_tile.cu`)
MAX_JOBS = 8
#: the vertical directions `sgm_tile_final` takes: top-down alone (5 and 4
#: paths) or both senses (8 paths)
FINAL_DIRS = (((1, 0),), ((1, 0), (-1, 0)))


@dataclasses.dataclass(frozen=True)
class ScanJob:
    """One direction over a block of rows of a tile (see the module)."""

    dy: int
    dx: int
    row0: int
    rows: int
    inbox: Optional[torch.Tensor] = None  # (rows + 1, D) int32
    outbox: Optional[torch.Tensor] = None  # the previous (rows + 1, D) int32
    prev: Optional[torch.Tensor] = None  # (W, D) int32


Result = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32, device=like.device)


def _carried(job: ScanJob, edge: torch.Tensor) -> torch.Tensor:
    """The new outbox: the edge column's L (rows, D) and the old outbox's
    row of the block before."""
    old = job.outbox if job.outbox is not None else _zeros(
        (job.rows + 1, edge.shape[1]), edge)
    if job.dy >= 0:
        return torch.cat([old[-1:], edge], dim=0)
    return torch.cat([edge, old[:1]], dim=0)


def _scan_plain(C: torch.Tensor, S: torch.Tensor, job: ScanJob, p1: int,
                p2: int) -> Result:
    H, W, D = C.shape
    a, R, dy, dx = job.row0, job.rows, job.dy, job.dx
    blk = C[a: a + R].to(torch.int32)
    inbox = job.inbox if job.inbox is not None else _zeros((R + 1, D), C)
    Ls = torch.empty((R, W, D), dtype=torch.int32, device=C.device)
    if dy == 0:
        # _horiz_core: the rows' carries enter at the first column
        carry = inbox[1:]
        for x in (range(W) if dx > 0 else range(W - 1, -1, -1)):
            carry = sgm_step(blk[:, x], carry, p1, p2)
            Ls[:, x] = carry
        S[a: a + R] += Ls
        return _carried(job, Ls[:, W - 1 if dx > 0 else 0]), None
    # _diag_core and _aggregate_dir: a row at a time, the predecessor row
    # shifted by dx, the inbox filling the column the shift leaves
    Lprev = job.prev if job.prev is not None else _zeros((W, D), C)
    for r in (range(R) if dy > 0 else range(R - 1, -1, -1)):
        fill = inbox[r + (0 if dy > 0 else 1)][None]
        if dx > 0:
            Lp = torch.cat([fill, Lprev[:-1]], dim=0)
        elif dx < 0:
            Lp = torch.cat([Lprev[1:], fill], dim=0)
        else:
            Lp = Lprev
        Lprev = sgm_step(blk[r], Lp, p1, p2)
        Ls[r] = Lprev
    S[a: a + R] += Ls
    if dx == 0:
        return None, None
    return _carried(job, Ls[:, W - 1 if dx > 0 else 0]), Lprev


def sgm_tile_scan_plain(C: torch.Tensor, S: torch.Tensor,
                        jobs: Sequence[ScanJob], p1: int, p2: int) -> List[Result]:
    """The jobs one after another: S (H, W, D) int32 gains each job's L (in
    place); returns each job's (new outbox or None, new prev or None)."""
    return [_scan_plain(C, S, job, p1, p2) for job in jobs]


def _check(C: torch.Tensor, S: torch.Tensor, jobs: Sequence[ScanJob],
           what: str = "sgm_tile_scan") -> None:
    H, W, D = C.shape
    if not 1 <= D <= 256:
        raise ValueError(f"{what}: unsupported D={D}")
    if what == "sgm_tile_scan" and not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"sgm_tile_scan: {len(jobs)} jobs, 1 to {MAX_JOBS} a launch")
    if C.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"C must be int16 or int32, got {C.dtype}")
    _build.require(C, "C", C.dtype)
    _build.require(S, "S", torch.int32, (H, W, D))
    for job in jobs:
        if job.dy not in (-1, 0, 1) or job.dx not in (-1, 1):
            raise ValueError(f"sgm_tile_scan: direction ({job.dy}, {job.dx}) on the "
                             f"card (the vertical ones are sgm_tile_final's)")
        if not (0 <= job.row0 and 1 <= job.rows and job.row0 + job.rows <= H):
            raise ValueError(f"sgm_tile_scan: rows [{job.row0}, "
                             f"{job.row0 + job.rows}) outside [0, {H})")
        for name, t, shape in (("inbox", job.inbox, (job.rows + 1, D)),
                               ("outbox", job.outbox, (job.rows + 1, D)),
                               ("prev", job.prev, (W, D))):
            if t is not None:
                _build.require(t, name, torch.int32, shape)


def _fn(name: str, argtypes):
    lib = _build.load("sgm_tile")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = _build.I
    return lib, fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


#: the ctypes argument types of the two C entry points
SCAN_ARGTYPES = [_build.P, _build.I, _build.P] + [_build.I] * 5 + [
    _build.P, _build.P, _build.I, _build.P]
FINAL_ARGTYPES = [_build.P, _build.I, _build.P] + [_build.I] * 7 + [_build.P] * 5


def launch_scan(fn, C: torch.Tensor, S: torch.Tensor, jobs: Sequence[ScanJob],
                p1: int, p2: int):
    """One launch of `rtdm_sgm_tile_scan` (or a copy of it, `fn`) on checked
    CUDA tensors: the job descriptors and the jobs' outputs; returns
    (results, the entry's error code)."""
    H, W, D = C.shape
    results = []
    desc = (ctypes.c_int * (4 * len(jobs)))()
    ptrs = (ctypes.c_void_p * (5 * len(jobs)))()
    for i, job in enumerate(jobs):
        out = torch.empty((job.rows + 1, D), dtype=torch.int32, device=C.device)
        prev = (torch.empty((W, D), dtype=torch.int32, device=C.device)
                if job.dy != 0 else None)
        results.append((out, prev))
        desc[4 * i: 4 * i + 4] = [job.dy, job.dx, job.row0, job.rows]
        ptrs[5 * i: 5 * i + 5] = [_ptr(job.inbox), _ptr(job.outbox), _ptr(out),
                                  _ptr(job.prev), _ptr(prev)]
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), C.element_size(), S.data_ptr(), H, W, D, int(p1),
                 int(p2), desc, ptrs, len(jobs), _build.stream_of(C))
    return results, err


def sgm_tile_scan(C: torch.Tensor, S: torch.Tensor, jobs: Sequence[ScanJob],
                  p1: int, p2: int) -> List[Result]:
    """`sgm_tile_scan_plain` in one launch: C (H, W, D) int16 or int32, S
    (H, W, D) int32 (added to in place), 1 to MAX_JOBS jobs, none of them
    vertical on the card. p2 is used as given (callers pass max(p2, p1 + 1))."""
    if not _build.on_card(C, "sgm_tile_scan"):
        return sgm_tile_scan_plain(C, S, jobs, p1, p2)
    _check(C, S, jobs)
    lib, fn = _fn("rtdm_sgm_tile_scan", SCAN_ARGTYPES)
    results, err = launch_scan(fn, C, S, jobs, p1, p2)
    sgm_tile_scan.launches += 1
    _build.check(lib, err, "sgm_tile_scan")
    return results


sgm_tile_scan.launches = 0


def _final_check(dirs) -> Tuple[Tuple[int, int], ...]:
    dirs = tuple(tuple(d) for d in dirs)
    if dirs not in FINAL_DIRS:
        raise ValueError(f"sgm_tile_final: directions {dirs}, one of {FINAL_DIRS}")
    return dirs


def sgm_tile_final_plain(C: torch.Tensor, S: torch.Tensor, p1: int, p2: int,
                         uniqueness_ratio: int, dirs):
    """The tile's vertical jobs over all its rows added into S (in place),
    then the winner-take-all, uniqueness and subpixel step on S: (best,
    minS, dval, uniq), each (H, W) int32."""
    dirs = _final_check(dirs)
    sgm_tile_scan_plain(C, S, [ScanJob(dy, dx, 0, C.shape[0]) for dy, dx in dirs],
                        p1, p2)
    return wta_uniq_subpix(S, uniqueness_ratio)


def sgm_tile_final(C: torch.Tensor, S: torch.Tensor, p1: int, p2: int,
                   uniqueness_ratio: int, dirs):
    """`sgm_tile_final_plain` in one launch: C (H, W, D) int16 or int32, S
    (H, W, D) int32, the sum of the tile's other directions, which the
    kernel uses as scratch (its contents afterwards are unspecified); dirs
    one of FINAL_DIRS. p2 is used as given."""
    if not _build.on_card(C, "sgm_tile_final"):
        return sgm_tile_final_plain(C, S, p1, p2, uniqueness_ratio, dirs)
    dirs = _final_check(dirs)
    _check(C, S, [], "sgm_tile_final")
    lib, fn = _fn("rtdm_sgm_tile_final", FINAL_ARGTYPES)
    outs, err = launch_final(fn, C, S, p1, p2, uniqueness_ratio, dirs)
    sgm_tile_final.launches += 1
    _build.check(lib, err, "sgm_tile_final")
    return outs


def launch_final(fn, C: torch.Tensor, S: torch.Tensor, p1: int, p2: int,
                 uniqueness_ratio: int, dirs):
    """One launch of `rtdm_sgm_tile_final` (or a copy of it, `fn`) on checked
    CUDA tensors; returns ((best, minS, dval, uniq), the error code)."""
    H, W, D = C.shape
    outs = tuple(torch.empty((H, W), dtype=torch.int32, device=C.device)
                 for _ in range(4))
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), C.element_size(), S.data_ptr(), H, W, D, int(p1),
                 int(p2), int(len(dirs) == 2), int(uniqueness_ratio),
                 *[t.data_ptr() for t in outs], _build.stream_of(C))
    return outs, err


sgm_tile_final.launches = 0
