"""The SGM scans of one tile of the exact width tiling (`csrc/sgm_tile.cu`).

Kernels for a stage the reference left to XLA: no Pallas kernel stands
behind them. `rt_depth_map_tpu/parallel/exact_sgbm.py` scans a tile's row
block with two `lax.scan`s (`_diag_core`, `_horiz_core`,
exact_sgbm.py:159-184) and its vertical paths with `ops/sgbm.py`
`_aggregate_dir`, then runs `wta_uniq_subpix` on the tile's sum
(exact_sgbm.py:337-343); on the card a step a launch would be ~10^5 small
launches a 720p frame. Two entry points:

- `sgm_tile_scan` runs a list of `ScanJob`s, one wavefront step of the
  tile's directions, in one cooperative launch. The jobs that scan the same
  rows in the same sense share one walk ((0, +1) with (+1, +1), (0, -1)
  with (+1, -1)): a warp a row, D over its lanes, every row of the walk
  stepping its columns in lockstep so that the diagonal carry passes
  between neighbour rows through shared memory (and between groups of rows
  through tagged words in device memory); two walks on the same rows in
  opposite horizontal senses meet in the middle column as K4's chains do;
  walks that overlap otherwise wait for the earlier ones. Each element of S
  has one writer at a time, so no atomics; every pixel's costs and sums are
  copied ahead with cp.async. `scan_plan` (pure) groups the jobs. It takes
  no vertical job (dx = 0) on the card: those are `sgm_tile_final`'s.
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

The scan kernel's waits between blocks (the carry words between groups of
rows, the meeting and done words) read words in a scratch buffer tagged
with the launch's tag, which the wrapper hands out, a new one a launch.
So `sgm_tile_scan` refuses to be captured in a CUDA graph (a replay would
reuse the tag and read stale words as fresh). The scratch is one buffer
for each (device, stream), kept for the life of the process and only
grown: a whole row of int64 words a column and disparity for each group of
4 rows of each diagonal walk, ceil(rows / 4) * W * D * 8 bytes a walk. At
720p, D = 128 and four diagonal walks a launch, that is 54 MB at the tile
of 2, 212 MB at n = 1 and 14 MB at n = 4.
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


@dataclasses.dataclass(frozen=True)
class Walk:
    """Jobs of one launch that scan the same rows in the same sense: a
    horizontal job `h` and a diagonal job `d` (indices into the launch's
    jobs, -1: none), columns in sense dx, rows in sense vs (+1 top-down)."""

    dx: int
    vs: int
    h: int
    d: int


@dataclasses.dataclass(frozen=True)
class Unit:
    """The kernel's unit of work over rows [row0, row0 + rows): one walk, or
    two walks in opposite horizontal senses that meet in the middle column
    (`walks`); `waits`: the earlier units on the same rows, which finish
    first."""

    row0: int
    rows: int
    walks: Tuple[Walk, ...]
    waits: Tuple[int, ...] = ()


def scan_plan(jobs: Sequence[ScanJob]) -> List[Unit]:
    """The units of a launch of `jobs` (pure; the kernel runs them): each
    diagonal job a walk, each horizontal job joined to the walk of the
    diagonal job on its rows and sense (a top-down one first) or a walk of
    its own, two walks on the same rows in opposite horizontal senses
    paired; a unit waits for every earlier unit whose rows meet its own.
    Vertical jobs (dx = 0) are refused."""
    if any(job.dx == 0 for job in jobs):
        raise ValueError("scan_plan: a vertical job (dx = 0); those are sgm_tile_final's")
    walks = []  # [row0, rows, dx, vs, h, d]
    for j, job in enumerate(jobs):
        if job.dx != 0 and job.dy != 0:
            walks.append([job.row0, job.rows, job.dx, job.dy, -1, j])
    for j, job in enumerate(jobs):
        if job.dy != 0:
            continue
        free = [w for w in walks if w[:3] == [job.row0, job.rows, job.dx] and w[4] < 0]
        if free:
            max(free, key=lambda w: w[3])[4] = j
        else:
            walks.append([job.row0, job.rows, job.dx, 1, j, -1])
    walks.sort(key=lambda w: min(i for i in w[4:] if i >= 0))
    units, used = [], [False] * len(walks)
    for a, wa in enumerate(walks):
        if used[a]:
            continue
        mate = next((b for b in range(a + 1, len(walks)) if not used[b]
                     and walks[b][:2] == wa[:2] and walks[b][2] == -wa[2]), None)
        members = [wa] if mate is None else [wa, walks[mate]]
        for b in (a, mate):
            if b is not None:
                used[b] = True
        units.append(Unit(wa[0], wa[1], tuple(Walk(*w[2:]) for w in members)))
    return [dataclasses.replace(u, waits=tuple(
        v for v in range(i) if units[v].row0 < u.row0 + u.rows
        and u.row0 < units[v].row0 + units[v].rows)) for i, u in enumerate(units)]


#: rows of a group of a walk (TS_G in `csrc/sgm_tile.cu`): a block of as
#: many warps walks them, a warp a row
GROUP_ROWS = 4


def unit_blocks(unit: Unit) -> int:
    """The kernel's blocks for `unit`: a block a group of GROUP_ROWS rows of
    each walk."""
    return len(unit.walks) * -(-unit.rows // GROUP_ROWS)


def scratch_layout(units: Sequence[Unit], W: int, D: int):
    """(flag words, each walk's first carry-slot word (0 for one without a
    diagonal job), total words) of a launch's scratch: a done word and a
    meeting word a block, then a row of D words a column for each group of
    each diagonal walk; every region starts on 16 bytes (the kernel copies
    the slots with cp.async)."""
    flags = 2 * sum(unit_blocks(u) for u in units)
    words, bufs = flags, []
    for u in units:
        row = []
        for w in u.walks:
            row.append(words if w.d >= 0 else 0)
            if w.d >= 0:
                n = -(-u.rows // GROUP_ROWS) * W * D
                words += n + n % 2
        bufs.append(row)
    return flags, bufs, words


#: each (device, stream)'s scratch words and the last tag handed out: a
#: launch tags its words with a tag no earlier launch on the buffer used,
#: so no launch needs the buffer cleared (but the one after the last tag)
_scratch: dict = {}
#: the last tag (tags are 32 bits; 0 is a cleared word's)
LAST_TAG = 0xFFFFFFFF


def _scratch_for(device: torch.device, words: int):
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf, tag = _scratch.get(key, (None, 0))
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1), dtype=torch.int64, device=device)
        tag = 0
    elif tag == LAST_TAG:  # the tags wrap: clear the words, in stream order
        buf.zero_()
        tag = 0
    _scratch[key] = (buf, tag + 1)
    return buf, tag + 1


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
SCAN_ARGTYPES = [_build.P, _build.I, _build.P, _build.I, _build.I, _build.I, _build.I,
              _build.I, _build.P, _build.P, _build.I, _build.P, _build.P, _build.I,
              _build.P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint, _build.P]
FINAL_ARGTYPES = [_build.P, _build.I, _build.P] + [_build.I] * 7 + [_build.P] * 5


def launch_scan(fn, C: torch.Tensor, S: torch.Tensor, jobs: Sequence[ScanJob],
                p1: int, p2: int):
    """One launch of `rtdm_sgm_tile_scan` (or a copy of it, `fn`) on checked
    CUDA tensors: the plan, the scratch and its tag, the jobs' outputs;
    returns (results, the entry's error code)."""
    H, W, D = C.shape
    results = []
    jdesc = (ctypes.c_int * (4 * len(jobs)))()
    jptrs = (ctypes.c_void_p * (5 * len(jobs)))()
    for i, job in enumerate(jobs):
        out = prev = None
        if job.dx != 0:
            out = torch.empty((job.rows + 1, D), dtype=torch.int32, device=C.device)
            if job.dy != 0:
                prev = torch.empty((W, D), dtype=torch.int32, device=C.device)
        results.append((out, prev))
        jdesc[4 * i: 4 * i + 4] = [job.dy, job.dx, job.row0, job.rows]
        jptrs[5 * i: 5 * i + 5] = [_ptr(job.inbox), _ptr(job.outbox), _ptr(out),
                                   _ptr(job.prev), _ptr(prev)]
    units = scan_plan(jobs)
    flags, bufs, words = scratch_layout(units, W, D)
    udesc = (ctypes.c_int * (12 * len(units)))()
    ubuf = (ctypes.c_longlong * (2 * len(units)))()
    for u, unit in enumerate(units):
        walks = list(unit.walks) + [Walk(0, 0, -1, -1)] * (2 - len(unit.walks))
        udesc[12 * u: 12 * u + 12] = [
            unit.row0, unit.rows, len(unit.walks), sum(1 << v for v in unit.waits),
            *[f for w in walks for f in (w.dx, w.vs, w.h, w.d)]]
        ubuf[2 * u: 2 * u + 2] = bufs[u] + [0] * (2 - len(bufs[u]))
    scratch, tag = _scratch_for(C.device, words)
    with torch.cuda.device(C.device):
        err = fn(C.data_ptr(), C.element_size(), S.data_ptr(), H, W, D,
                 int(p1), int(p2), jdesc, jptrs, len(jobs), udesc, ubuf,
                 len(units), scratch.data_ptr(), scratch.numel(), flags, tag,
                 _build.stream_of(C))
    return results, err


def sgm_tile_scan(C: torch.Tensor, S: torch.Tensor, jobs: Sequence[ScanJob],
                  p1: int, p2: int) -> List[Result]:
    """`sgm_tile_scan_plain` in one launch: C (H, W, D) int16 or int32, S
    (H, W, D) int32 (added to in place), 1 to MAX_JOBS jobs, none of them
    vertical on the card. p2 is used as given (callers pass max(p2, p1 + 1))."""
    if not _build.on_card(C, "sgm_tile_scan"):
        return sgm_tile_scan_plain(C, S, jobs, p1, p2)
    _check(C, S, jobs)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("sgm_tile_scan: cannot be captured in a CUDA graph (each "
                           "launch needs a tag no earlier launch used)")
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
