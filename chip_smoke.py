#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rt_depth_map_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one NVIDIA GPU (Hopper:
the kernels are built for sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

The main path is the flagship frame program: 1280x720, 8-path SGM with
D=128, block size 5, pre_filter_cap 0 and the matcher's default checks
(uniqueness, LR check, speckle filter on). Phases; any failure raises and
the script exits non-zero:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: one nvcc per kernel source in csrc/, all started together, into
     build/torch_kernels/;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the frame programs, exact equality, and the median time
     of both (CUDA events) beside the kernel's time a call of 20 issued back
     to back between two events (device time where the kernel outlasts its
     wrapper's host work) and its device time a call (torch.profiler, the
     call's device activities alone): K1 as the frame
     programs launch it (`rectify_pair`: both views, three planes, one
     launch) and as `remap_u8` (one image of 1 to 4 channels); K2 on the
     frame mask (4 fields, 8-connected),
     on a snake that needs more than the JAX package's 16 sweeps, to its
     fixed point and capped at 16 (the sweep count read from the device
     after a synchronise), its worst cases to the fixed point at 1280x720
     and 1920x1080 (the snake, a dense-noise mask, random disparities; each
     with its sweeps), and on both speckle calls (1
     field, 4-connected value edges) at 1280x720 and 1920x1080; the bidir
     SGM kernels (K12, K4, K5) at the flagship shape and at an odd
     700x1000, D=64 one (K12 also in the TPU's 3-D form; K5 also at a W1
     that leaves its last band of columns ragged); the chained passes
     (K9a/K9b, K9c/K11, K9d: both senses, with and without a partial, int16
     and int32) at the stretch point 1920x1080, D=256 and at the odd shape,
     both K9a calls of the route timed there and at the flagship shape
     (cv2 MODE_SGBM's calls), K9c and K9d also timed at the flagship shape
     (K9d top-down is MODE_SGBM's call); K9a's register path (D=100), a
     view that does not start on 16 bytes, rows shorter than its ring and
     odd (W1 = 1, 3, 37; D = 64 and 256; int16 and int32; both layouts),
     each one CUDA launch a call (the library's own count), and no spill
     in its ring path's kernels (ptxas); the vertical kernel shared by K5,
     K9c and K9d at D=100 (its register path) and at widths beyond 16
     one-column warps on each SM (H=48, W1=3712, D=64; 16 rows at
     W1=3712, D=128), each making
     one CUDA launch a call (K5 two; the library's own count); K2 at widths
     and heights a block does not hold (64x2881, 1428x96: chunked rows and
     columns, capped and uncapped); at 3840x2160 D=128 the frame program,
     detect_objects and the speckle filter against their plain versions,
     and both 8-path routes on one volume (W1 = 3712);
     K3 and K7 at all three (K3 also with an int32 volume, bs 11, at the
     flagship and odd shapes; K7 as the speckle filter's `speckle_decision`
     (count + decision), `label_histogram_banded` and `label_histogram`),
     `speckle_apply` there too, and K6 at the flagship and the stretch
     point (its SGBM entry `lr_resolve_sgbm` and the general `lr_resolve`
     on the planes the plain check builds); K7's three entries also on a
     constant-disparity frame (one root), a checkerboard of one-pixel
     components (every pixel a root) and the cap-bound snake, each with the
     whole speckle filter against its plain version; K6's BM entry
     `lr_resolve_bm` at 720p D=128 and 1920x1080 D=288, and the general
     entry on the BM planes; K4 must make one CUDA launch a call
     (the library's own count); the bidir and chained 8-path routes timed
     on the flagship and stretch volumes, which must give the same winners;
     a snake through the speckle path where the 16-sweep cap binds; K8 at
     1920x1080 also at D=288 and 384 (12 d a lane, a 9-bit key); the BM
     and SGM matchers against the repo's numpy goldens (cv2.StereoBM and
     cv2.StereoSGBM parity: MODE_SGBM, the causal 4 paths and MODE_HH on
     both of its routes);
  4. engine, SGM: Engine.run on a synthetic 1280x720 stream through a
     non-identity rectification with every plain version made to raise on
     a CUDA tensor; the run replays the program it captured (its launch
     counts, the capture's, equal one eager frame's); on an eager frame
     every kernel of the path must have launched (K12 twice a frame, K4
     and K5 once; on every engine phase the LR check's entry,
     `speckle_decision` and `speckle_apply` once a frame, K6's and K7's
     general entries never), and every frame's
     disparity, boxes, mask and count must equal the plain frame program;
     then the frame program's median time and the pipelined frame rate;
  5. stage profile of the SGM frame program (the device time launched
     inside each of its `rtdm.stage.*` and `rtdm.match.*` spans, from a
     torch.profiler trace) and the device's busy share (torch.profiler);
  6. engine, BM (D=128, block size 13, speckle filter on): the same checks
     on its own path, counted apart; its timing, stage profile and device
     time a frame (K8 itself is checked in phase 3 at 720p D=128 and D=192,
     1920x1080 D=256, 288 and 384, D=100 bs=5 and a ragged crop at bs=21);
  7. engine, the stretch point (1920x1080, 8-path SGM, D=256; H % 16 != 0,
     so the chained route): the same checks on two frames, the bidir
     kernels must not launch; its timing and stage profile;
  8. engine, cv2 MODE_SGBM (1280x720, 5 paths, D=128): the same checks, K9c
     and the bidir kernels must not launch; its timing and stage profile;
  9. engine, the default BM matcher on a 1920x1080 camera: a configuration
     written for 1280x720 (D=192, block size 13) scales D with the width to
     288; the same checks on two frames (K8 must launch); its timing and
     stage profile;
 10. engine, the WLS post filter (enable_post_filter) on SGM-8 720p and
     BM-128: the right matcher over the mirrored range (min_disparity -127)
     and the WLS filter on the smoother kernel; the same checks on two
     frames each, `filtered_disparity` within 1 (1/16 px) of the plain frame
     program on 99.9% of the pixels and within 16 everywhere; a frame's
     launches: K3 twice, K12 four times, K4 and K5 twice (SGM), K8 twice
     (BM), the smoother six times; its timing, device time and stage
     profile.

Phase 3 also holds the kernels whose arguments took min_disparity against
their plain versions: K3 at 720p D=128 at -127 (the right matcher's call,
views swapped) and +16, K8 at -127 (720p D=128 bs 13) and -287 (1920x1080
D=288, the right matcher of the default BM matcher there), K6's SGBM and BM
entries at +16 and -8 on the matchers' own outputs; and the smoother kernel
(`tridiag_smooth`, one launch a sweep) along the rows and the columns of the
1280x720 frame's WLS inputs at the first sweep's lambda, and along the rows
under the guide of an unblurred texture (the "fine" scene's left view as
the camera gives it, 1% of whose weights lie below 2^-100), within 1e-5 of
the input's range of
its plain version, beside one scanline alone (one thread walking the chain
of dependent divides: the latency floor of a sweep).

Phase 3 also holds the exact width tiling's kernels at the 720p frame's
tile shape of 2 ranks (576 of W1 = 1152 columns, 90-row blocks): K3's
output column window against the full volume's slice on each tile,
`sgm_tile_scan` against its plain version in every cross-tile direction,
alone and in wavefront steps (timed on the steady step of the six
directions, whose jobs of opposite senses add into the same blocks, and on
a step of four blocks; the steady step also captured in a CUDA graph and
replayed, against the eager call), and `sgm_tile_final` (the tile's vertical paths and the winner-take-all,
checked and timed in both of its modes), each also at an odd tile (97
columns, 7-row blocks, D = 100: the kernels' register path).

 12. the multi-rank paths (`parallel/` on torch.distributed), each rank a
     spawned process on card 0 with every plain version guarded and its
     path's launches required, joined under a deadline: NCCL at world size
     1, the sharded step on a (1, 1) mesh (SGM-8 exact 1280x720 D=128)
     against Engine.process_pair; gloo on one card (the exchanges through
     host memory), (1, 2): the exact tiling and tiled BM-128 at 1280x720
     bit-identical to the single-device port, the margin mode within the
     1% bad-pixel budget, the exact tiling at 1920x1080 D=256, the sharded
     step; (2, 2): the sharded step with B=4 (the dryrun_multichip
     counterpart), every frame's disparity, boxes, mask and count against
     Engine.process_pair; (1, 4) in the same world: the exact tiling at
     1280x720 on 4 tiles. The ms a frame of each is printed; on gloo the
     ranks time-slice one card, so those are not scaling figures.

Phase 3 also holds the batch programs' batched entries against their
plain versions at 1280x720 with B = 4 rigs, timed: K1 (`rectify_pair_batch`,
both views of the four frames in one launch), K3 (`sgm_cost_volume_batch`)
and K5 (`sgm_vert_wta_batch`, int16 and int32 volumes), each one launch (K5
one pair) by the libraries' own counts; K5 also on a batch its band plan
must split (3840x2160's W1 = 3712 at D = 128 on 16 rows) and on a frame of
all-equal costs beside a textured one; and K9b's call beside an elementwise
add of the same bytes (the memory's rate for that stream, single calls and
20 back to back).

 13. the batch program (`step_batch`, `process_batch`: `batch_program`)
     at 1280x720 with B = 4 rigs, SGM-8 D=128 and BM-128: each step's
     launches (the SGM program: the batched K1, K3 and K5 once, K5's two
     CUDA launches, by the wrappers' and the libraries' counts; the
     single-frame entries never) with every plain version guarded, every
     frame equal to the plain single-frame program of its rig's pair; then
     `step_batch` frames/s beside the single-stream `run`, with a step's
     device time, device operations and busy share.

The last lines are the kernels' JSON summary (each kernel's first timed
case, and under `cases` every timed case with its own bound and library
time), the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import inspect
import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H, D, BS = 1280, 720, 128, 5  # the flagship SGM point
BM_D, BM_BS = 128, 13  # bench.py's BM point
ODD = (700, 1000, 64)  # (H, W, D): H % 16 != 0 and W1 % 128 != 0
#: (H, W, D): the stretch point of BASELINE.md and bench.py (8-path SGM);
#: 1080 % 16 == 8 puts it on the chained route
STRETCH = (1080, 1920, 256)
ENGINE_FRAMES = 4  # frames of each checked engine run
POST_FRAMES = 2  # frames of each checked post-filter run (two matchers' plain programs)
STRETCH_FRAMES = 2  # frames of the checked stretch run (its plain program is slow)
TIMED_FRAMES = 30  # frames of the timed engine run
CLI_FRAMES = 30  # frames of each checked CLI run (phase 11)
PRELOAD_FRAMES = 120  # frames of the CLI's run and run_preloaded rates
BATCH = 4  # rigs of the batch program (BASELINE.md: 4x 720p pairs)
BATCH_STEPS = 1  # checked steps of each batch run (4 plain frames each)
BATCH_TIMED_STEPS = 20  # timed steps of each batch run
#: seconds a phase 11 step may take before the run fails (a hang)
CLI_DEADLINE, BATCH_DEADLINE = 300, 300
DEV = "cuda"

#: H100 SXM device memory bytes/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12
#: the card's 32-bit lane instructions a second, set by main()
#: (`_lane_rate`): SMs x 128 lanes x the max SM clock (nvidia-smi). Each
#: SM's four schedulers issue one 32-lane instruction a clock, and integer
#: work can fill them all (adds and logic on the 64 INT32 lanes, IMAD on
#: the FMA pipe beside them); it is half the data sheet's 67 TFLOP/s fp32
#: rate, which counts an FMA as two operations. A bound's operations are
#: counted in these instructions at the widest SIMD the card has for their
#: type (`_lanes`), so that the bound stays a floor.
PEAK_OPS = None
#: the kernels of each frame program: the SGM one (bidir route), the BM
#: one, 8-path SGM on the chained route, and cv2 MODE_SGBM (5 paths)
_SGM_COMMON = ("rectify_pair", "seg_min_propagate", "sgm_cost_volume",
               "lr_resolve_sgbm", "speckle_decision", "speckle_apply")
BIDIR = ("vol_transpose", "sgm_horiz", "sgm_vert_wta")
SGM_PATH = _SGM_COMMON + BIDIR
BM_PATH = ("rectify_pair", "seg_min_propagate", "bm_cost_wta", "lr_resolve_bm",
           "speckle_decision", "speckle_apply")
#: K6's and K7's general entry points, checked in phase 3: no frame program
#: launches them (each stage runs its own entry)
GENERAL = ("lr_resolve", "label_histogram_banded", "label_histogram")
#: launches a frame of the LR check's and the speckle filter's entries on
#: every path
LR_SPECKLE_PER_FRAME = {"speckle_decision": 1, "speckle_apply": 1}
CHAINED_PATH = _SGM_COMMON + ("sgm_horiz_pass", "sgm_vert_pass", "sgm_final_wta")
SGBM5_PATH = _SGM_COMMON + ("sgm_horiz_pass", "sgm_final_wta")
#: the post filter's kernel: the smoother's tridiagonal solves
POST = ("tridiag_smooth",)
#: launches a frame with the post filter on: the right matcher repeats the
#: left one's matching kernels (its LR check and speckle filter are off),
#: and the smoother runs one launch a sweep, two sweeps an iteration, three
#: iterations
POST_PER_FRAME = {
    "sgm": {"sgm_cost_volume": 2, "vol_transpose": 4, "sgm_horiz": 2,
            "sgm_vert_wta": 2, "tridiag_smooth": 6},
    "bm": {"bm_cost_wta": 2, "tridiag_smooth": 6},
}
#: the batched entries of the batch programs (phase 3, phase 13)
BATCH_ENTRIES = ("rectify_pair_batch", "sgm_cost_volume_batch", "sgm_vert_wta_batch")
#: the kernels of the SGM batch program (phase 13): the batched K1, K3
#: and K5, K12, K4 and K6 on the B * H rows, K2 and K7 frame by frame
BATCH_SGM_PATH = ("rectify_pair_batch", "seg_min_propagate", "sgm_cost_volume_batch",
                  "vol_transpose", "sgm_horiz", "sgm_vert_wta_batch",
                  "lr_resolve_sgbm", "speckle_decision", "speckle_apply")
#: wrapper launches a step of the batch program (B = BATCH rigs)
BATCH_PER_STEP = {
    "sgm": {"rectify_pair_batch": 1, "rectify_pair": 0,
            "sgm_cost_volume_batch": 1, "sgm_cost_volume": 0,
            "vol_transpose": 2, "sgm_horiz": 1, "sgm_vert_wta_batch": 1,
            "sgm_vert_wta": 0, "lr_resolve_sgbm": 1,
            "speckle_decision": BATCH, "speckle_apply": BATCH},
    "bm": {"rectify_pair_batch": 1, "rectify_pair": 0,
           "bm_cost_wta": BATCH, "lr_resolve_bm": BATCH},
}
#: (library, count, CUDA launches a step) of the batched K1, K3 and K5
BATCH_LIB_PER_STEP = {
    "sgm": (("remap", "rtdm_remap_kernel_launches", 1),
            ("sgm_cost", "rtdm_sgm_cost_kernel_launches", 1),
            ("sgm_vert_wta", "rtdm_sgm_vert_kernel_launches", 2)),
    "bm": (("remap", "rtdm_remap_kernel_launches", 1),),
}
#: the smoother kernel against its plain version: within this share of the
#: input's range (the same float32 operations in the same order; they part
#: only where the card's expf or the plain version's float64-emulated fused
#: multiply-add rounds otherwise)
SMOOTH_RTOL = 1e-5
#: filtered_disparity against the plain frame program: within 1 (1/16 px)
#: on this share of the pixels and within 16 (1 px) everywhere
WLS_WITHIN_1 = 0.999


def _sync():
    import torch

    torch.cuda.synchronize()


def _time_ms(fn, reps=15, warm=3):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    _sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _b2b_ms(fn, n=20):
    """Milliseconds a call of fn, n calls issued back to back between two
    CUDA events after one to warm up (the host's work before each launch
    overlaps the previous kernel: device time where the kernel outlasts
    that work, the host's time where it does not; as tools/torch_timing.py
    b2b_ms)."""
    import torch

    fn()
    _sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def _wall_ms(fn, reps):
    """Median host milliseconds of fn() through a device synchronise."""
    fn()
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_abs_err(got, ref):
    """The largest |got - ref| over the outputs: an int for integer ones, a
    float for float ones."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} != {r.shape} {r.dtype}")
        if g.is_floating_point():
            err = max(err, float((g.double() - r.double()).abs().max()))
        else:
            err = max(err, int((g.long() - r.long()).abs().max()))
    return err


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(in_bytes: int, out_bytes: int, ops: float):
    """(ms, "bytes" or "operations"): the least time for the work, each
    input read once and each output written once."""
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _lane_rate() -> float:
    """SMs x 128 lanes x the max SM clock of card 0: 32-bit lane
    instructions a second."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    mhz = float(smi.stdout.strip().splitlines()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 128 * mhz * 1e6


def _lanes(ops: float, elem_bytes: int) -> float:
    """32-bit lane instructions for `ops` integer operations on elements of
    `elem_bytes` bytes at the card's SIMD width for them: 4 bytes a lane
    (VABSDIFF4, VADD4, VMNMX4), 2 16-bit values (VADD2, VMNMX2), 1 32-bit."""
    return ops * elem_bytes / 4


def _card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def _require_launched(launches: dict, names, what: str, absent=()) -> None:
    missing = [n for n in names if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels of the path not launched: {missing} "
                             f"(launches {launches})")
    stray = [n for n in absent if launches.get(n, 0) != 0]
    if stray:
        raise AssertionError(f"{what}: kernels of another route launched: {stray} "
                             f"(launches {launches})")


@contextlib.contextmanager
def _no_plain_on_card():
    """While inside, every `*_plain` function of the port's modules raises
    when it is handed a CUDA tensor: a frame program on the card must
    launch the kernels, never their plain versions."""
    import torch

    def guard(name, fn):
        @functools.wraps(fn)
        def guarded(*args, **kwargs):
            for a in (*args, *kwargs.values()):
                if any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in (a if isinstance(a, (tuple, list)) else (a,))):
                    raise AssertionError(f"{name} got a CUDA tensor on the frame path")
            return fn(*args, **kwargs)
        return guarded

    patched = []
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith("rt_depth_map_tpu_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if attr.endswith("_plain") and inspect.isfunction(val):
                patched.append((mod, attr, val))
                setattr(mod, attr, guard(f"{mod_name}.{attr}", val))
    try:
        yield len(patched)
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def _rectification(w, h):
    """Same warp for both eyes (rows stay aligned): a fractional x shift and
    a vertical stretch whose top and bottom rows sample outside the frame."""
    from rt_depth_map_tpu_torch.calib import RectificationResult
    from rt_depth_map_tpu_torch.sources import SyntheticStereoSource

    oy, ox = np.mgrid[0:h, 0:w].astype(np.float32)
    grid = np.stack([ox + 0.3, oy * (h + 8.0) / h - 4.0], axis=-1).astype(np.float32)
    return RectificationResult(
        map_left=grid, map_right=grid.copy(),
        Q=SyntheticStereoSource(w, h).q_matrix(), roi=(0, 0, w, h),
        image_size=(w, h))


def _source(w, h, ring=0, scene="default", seed=11):
    """The synthetic pair of every phase (another seed: another rig's
    texture under the same objects); another scene family (no "default")
    places its own objects."""
    from rt_depth_map_tpu_torch.sources import SyntheticStereoSource
    from rt_depth_map_tpu_torch.sources.synthetic import SyntheticObject

    # disparity = 0.9 * W * 4.8 / z: 92, 69 and 50 px at W = 1280, inside
    # D = 128 (138, 104 and 75 px at W = 1920); placement in 1/1280 and
    # 1/720 of the frame
    sx, sy = w / 1280.0, h / 720.0
    objects = [
        SyntheticObject(x=int(x * sx), y=int(y * sy), w=int(ow * sx),
                        h=int(oh * sy), z_units=z, vx=vx, vy=vy)
        for x, y, ow, oh, z, vx, vy in (
            (180, 120, 300, 220, 60.0, 2.0, 0.0),
            (620, 330, 260, 200, 80.0, 0.0, 1.0),
            (960, 160, 200, 160, 110.0, -1.5, 0.0))
    ]
    src = SyntheticStereoSource(w, h, seed=seed, ring=ring, scene=scene,
                                objects=objects if scene == "default" else None)
    src.rectified = False  # the engine applies the rectification maps
    return src


def _config(kind, w, h, d=D, num_paths=8, post_filter=False):
    """kind "sgm" (D = d), "bm" (bench.py's BM point) or "bm-default" (the
    BM defaults of a configuration written for 1280x720, whose D the engine
    scales with the camera's width: 288 at 1920); post_filter: the WLS post
    filter on."""
    from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig

    if kind == "bm-default":
        return EngineConfig(matcher=MatcherConfig(kind="bm"),
                            enable_post_filter=post_filter)
    if kind == "sgm":
        m = MatcherConfig(kind="sgm", num_disparities=d, block_size=BS,
                          num_paths=num_paths, pre_filter_cap=0)
        nd = d
    else:  # the BM defaults, speckle filter on
        m = MatcherConfig(kind="bm", num_disparities=BM_D, block_size=BM_BS)
        nd = BM_D
    return EngineConfig(width=w, height=h, number_of_disparities=nd, matcher=m,
                        enable_post_filter=post_filter)


def _engine(kind, w, h, ring=0, d=D, num_paths=8, post_filter=False):
    from rt_depth_map_tpu_torch import Engine

    return Engine(_config(kind, w, h, d, num_paths, post_filter),
                  rectification=_rectification(w, h),
                  source=_source(w, h, ring), device=DEV)


def _snake(h, w, arms):
    m = np.zeros((h, w), bool)
    step = h // arms
    for a in range(arms):
        m[a * step, :] = True
        if a + 1 < arms:
            m[a * step: (a + 1) * step + 1, w - 1 if a % 2 == 0 else 0] = True
    return m


def _check_engine(phase, kind, w, h, path, d=D, num_paths=8,
                  frames=ENGINE_FRAMES, absent=(), post_filter=False):
    """Engine.run with every plain version guarded against CUDA tensors
    (`_no_plain_on_card`): after `warmup`'s eager frame the run's first
    frame is captured into CUDA graphs and the others replay them, so the
    wrappers count the capture's launches, which must equal one eager
    frame program's (a replay calls no wrapper). On that eager frame: every
    kernel of the path launched, none of `absent` or of K6's and K7's
    general entries, the LR check's and the speckle filter's entries once.
    Every frame of the run must equal the plain frame program (with the
    post filter, its filtered disparity within 1 on WLS_WITHIN_1 of the
    pixels and 16 everywhere). Returns the engine and the launch counts of
    one eager frame."""
    import torch

    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    eng = _engine(kind, w, h, d=d, num_paths=num_paths, post_filter=post_filter)
    what = (f"phase {phase} {f'sgm-{num_paths}' if kind == 'sgm' else kind} engine "
            f"{w}x{h} D={eng.num_disparities}{' + WLS post filter' if post_filter else ''}")
    eng.warmup()
    results = {}
    ref_src = _source(w, h)
    lf, rf, _, _ = ref_src.render(0)
    with _no_plain_on_card() as guarded:
        reset_launch_counts()
        eng.run(frames=frames, on_frame=lambda i, r: results.__setitem__(i, r),
                print_stats_on_sigint=False)
        captured = {wr.__name__: wr.launches for wr, _, _ in KERNELS}
        reset_launch_counts()
        eng.frame_program(torch.from_numpy(lf).to(DEV), torch.from_numpy(rf).to(DEV))
        launches = {wr.__name__: wr.launches for wr, _, _ in KERNELS}
    (prog,) = eng._graphs._by_shape.values()
    print(f"{what}: {len(results)} frames, {prog.calls - 1} of them replayed from "
          f"{len(prog.segments or ())} captured graphs; launches of an eager frame "
          f"{launches}; no CUDA tensor reached any of {guarded} plain versions",
          flush=True)
    if len(results) != frames:
        raise AssertionError(f"{what} returned {len(results)} frames")
    if prog.segments is None or prog.calls != frames + 1:
        raise AssertionError(f"{what}: the run did not replay its captured program "
                             f"({prog.calls} calls)")
    if captured != launches:
        raise AssertionError(f"{what}: the capture launched {captured}, an eager "
                             f"frame {launches}")
    _require_launched(launches, path, what, absent + GENERAL)
    lr = "lr_resolve_bm" if "bm_cost_wta" in path else "lr_resolve_sgbm"
    per_frame = {lr: 1, **LR_SPECKLE_PER_FRAME}
    got = {k: launches[k] for k in per_frame}
    if got != per_frame:
        raise AssertionError(f"{what}: launches a frame {got}, expected {per_frame}")
    print(f"{what}: launches a frame of the LR check and speckle entries {got}",
          flush=True)

    for i in sorted(results):
        res = results[i]
        lf, rf, _, _ = ref_src.render(i)
        ref = eng.frame_program(torch.from_numpy(lf).to(DEV),
                                torch.from_numpy(rf).to(DEV), plain=True)
        for k in ("disparity", "boxes", "mask", "count"):
            if not np.array_equal(getattr(res, k), ref[k].cpu().numpy()):
                raise AssertionError(f"{what} frame {i}: {k} differs from the "
                                     f"plain program")
        if post_filter:
            f = res.filtered_disparity
            err = np.abs(f.astype(np.int32)
                         - ref["filtered_disparity"].cpu().numpy().astype(np.int32))
            if (f.shape != (h, w) or (err <= 1).mean() < WLS_WITHIN_1
                    or err.max() > 16):
                raise AssertionError(f"{what} frame {i}: filtered_disparity off the "
                                     f"plain program's (max |err| {err.max()}, "
                                     f"{(err <= 1).mean():.5f} within 1)")
            print(f"{what} frame {i}: filtered_disparity max |err| {err.max()} "
                  f"against the plain program, {(err <= 1).mean():.6f} of pixels "
                  f"within 1", flush=True)
        elif res.filtered_disparity is not None:
            raise AssertionError(f"{what}: a filtered disparity without the post filter")
        del ref
        if res.disparity.shape != (h, w) or res.boxes[:, 4].sum() == 0:
            raise AssertionError(f"{what} frame {i}: bad shape or no box")
        valid_in_boxes = res.count[res.boxes[:, 4] > 0]
        if not (valid_in_boxes > 0).any() or not np.isfinite(
                res.depth_cm[res.count > 0]).all():
            raise AssertionError(f"{what} frame {i}: no valid depth in any box")
        print(f"{what} frame {i}: equals the plain program; boxes "
              f"{int(res.boxes[:, 4].sum())} count {res.count.tolist()} "
              f"depth_cm {[round(float(v), 1) for v in res.depth_cm[res.count > 0]]} "
              f"valid disparity {float((res.disparity != -16).mean()):.3f}",
              flush=True)
    return eng, launches


def _timed_run(phase, what, card, eng, left, right, w, h, d=D, num_paths=8,
               frames=TIMED_FRAMES):
    """The frame program's median host time and the pipelined frame rate
    over a ring of 8 pre-rendered frames (a camera delivers frames at
    sensor rate, while painting the synthetic scene per grab would bound
    the loop)."""
    frame_ms = _wall_ms(lambda: eng.frame_program(left, right), reps=10)
    timed = _engine("sgm", w, h, ring=8, d=d, num_paths=num_paths)
    timed.warmup()
    timed.run(frames=frames, print_stats_on_sigint=False)
    fps = timed.stats.wall_frames / timed.stats.wall_seconds
    print(f"phase {phase} {what} timing on {card}: frame program {frame_ms:.3f} ms, "
          f"pipelined run {fps:.2f} frames/s over {frames} frames", flush=True)
    return frame_ms


def _stage_profile(eng, left, right, frames=20):
    """({stage: median device ms}, {matcher step: median device ms}) of the
    frame program over `frames` frames under torch.profiler: a span's time
    is the union of the device operations launched inside it, by
    `benchmark/harness/spans.py`, and each row the median over the
    `rtdm.stage.<stage>` (`rtdm.match.<step>`) spans of that name; launch
    gaps, where the device waits for the host, belong to no stage."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import spans, trace

    eng.frame_program(left, right)
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            eng.frame_program(left, right)
        _sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_thread = spans.launched(events)
    inside = spans.launched_inside(events, lambda n: n.startswith("rtdm.stage."))
    print(f"stage profile: {len(inside)} of {len(trace.device_ops(events))} device "
          f"operations launched inside a stage span", flush=True)
    out = ({}, {})
    for prefix, rows in zip(("rtdm.stage.", "rtdm.match."), out):
        for name in dict.fromkeys(r[0] for r in sorted(spans.ranges(events, prefix),
                                                        key=lambda r: r[2])):
            each = [spans.busy_us(ops) * 1e-3
                    for _, _, ops in spans.instances(events, name, by_thread)]
            rows[name[len(prefix):]] = statistics.median(each)
    return out


def _device_busy(fn, frames=5):
    """(device ms per call, wall ms per call, device operations per call)
    from torch.profiler over `frames` calls of fn; device time sums the
    device activities' self time (kernels, copies, fills), and the
    operations count them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        _sync()
        wall = (time.perf_counter() - t0) * 1e3 / frames
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0) for e in events)
    return dev_us / 1e3 / frames, wall, sum(e.count for e in events) / frames


@contextlib.contextmanager
def _deadline(seconds: float, what: str):
    """A step that outlasts `seconds` (a kernel that hangs) ends the run
    with exit code 1 and every thread's traceback on stderr, instead of
    stalling it."""
    import faulthandler

    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
    print(f"{what}: within its {seconds:.0f} s deadline", flush=True)


def _host_syncs(fn):
    """The sites at which fn() made the host wait for the device, by
    torch.cuda.set_sync_debug_mode("warn"), after a call to warm up (kernel
    builds, first uploads): each the innermost frame of the port (or of
    this script) on the stack of the warning, with the warned line."""
    import os
    import traceback
    import warnings

    import torch

    fn()
    _sync()
    sites = set()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1]  # not this frame
                if "rt_depth_map_tpu_torch" in f.filename
                or f.filename.endswith("chip_smoke.py")]
        where = ours[-1] if ours else None
        sites.add(f"{os.path.relpath(where.filename)}:{where.lineno} -> "
                  f"{os.path.basename(filename)}:{lineno}" if where
                  else f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    _sync()
    return sorted(sites)


def _write_calibration(directory, w, h):
    """intrinsics.yml / extrinsics.yml of a non-identity w x h rig with the
    port's write_filestorage (distortion on both cameras, a small relative
    rotation, a 4.8-unit baseline along x); the ROIs intersect to (8, 12,
    w - 16, h - 16), which keeps 8-path SGM at 1280x720 on the bidir route
    (ROI height % 16 == 0, W1 % 8 == 0)."""
    import os

    from rt_depth_map_tpu_torch.calib import write_filestorage
    from rt_depth_map_tpu_torch.calib.rectify import rodrigues_to_matrix

    def camera(f, cx, cy):
        return np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])

    intr = os.path.join(directory, "intrinsics.yml")
    extr = os.path.join(directory, "extrinsics.yml")
    write_filestorage(intr, {
        "M1": camera(0.9 * w, w / 2 + 1.5, h / 2 - 0.7),
        "D1": np.array([[-0.05, 0.012, 0.001, -0.0005, 0.0]]),
        "M2": camera(0.9 * w + 2.0, w / 2 - 1.0, h / 2 + 0.4),
        "D2": np.array([[-0.04, 0.009, -0.0007, 0.0004, 0.0]]),
        "Width": w, "Height": h})
    write_filestorage(extr, {
        "R": rodrigues_to_matrix(np.array([0.002, -0.004, 0.001])),
        "T": np.array([[-4.8], [0.02], [0.01]]),
        "ROI1": [8, 12, w - 16, h - 16], "ROI2": [4, 8, w - 12, h - 12]})
    return intr, extr


def _fps_of(report: str) -> float:
    """The pipelined throughput of an ExecTimeStats report."""
    for ln in report.splitlines():
        if "pipelined throughput" in ln:
            return float(ln.split(":")[1].split()[0])
    raise AssertionError(f"no pipelined throughput in the report: {report[-500:]}")


def _run_cli(argv, what):
    """cli.main(argv) in this process with the counts set to 0 just before
    and every plain version guarded; (stdout, stderr, launches)."""
    import io

    from rt_depth_map_tpu_torch import cli
    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    out, err = io.StringIO(), io.StringIO()
    with _deadline(CLI_DEADLINE, f"phase 11 {what}"):
        with _no_plain_on_card(), contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            reset_launch_counts()
            rc = cli.main(argv)
            launches = {wr.__name__: wr.launches for wr, _, _ in KERNELS}
    if rc != 0:
        raise AssertionError(f"phase 11 {what}: rc {rc}: {err.getvalue()[-2000:]}")
    for ln in err.getvalue().splitlines():
        if ln.startswith(("rt-depth-map-torch:", "built the kernels", "processed",
                          "intrinsics resolution", "  pipelined throughput")):
            print(f"phase 11 {what}: {ln.strip()}", flush=True)
    return out.getvalue(), err.getvalue(), launches


def _cli_labels_match_plain(argv, out, what, frames, check):
    """Each printed frame's labels (`--print-depth`) against the labels of
    `frame_program(plain=True)` on the same pair, by an engine the CLI's
    own `make_engine` builds from the same arguments (the same
    RectificationResult, configuration and source)."""
    import torch

    from rt_depth_map_tpu_torch import cli
    from rt_depth_map_tpu_torch.pipeline.engine import FrameResult, _to_host

    lines = {}
    for ln in out.splitlines():
        if ln.startswith("frame "):
            i, txt = ln[len("frame "):].split(": ", 1)
            lines[int(i)] = txt
    if sorted(lines) != list(range(frames)):
        raise AssertionError(f"{what}: printed frames {sorted(lines)}")
    eng = cli.make_engine(cli.build_parser().parse_args(argv))
    src = eng.source
    for i in sorted(set(check) & set(lines)):
        lf, rf, _, _ = src.render(i % src.ring if src.ring else i)
        ref = FrameResult(**_to_host(eng.frame_program(
            torch.from_numpy(lf).to(DEV), torch.from_numpy(rf).to(DEV), plain=True)))
        txt = ", ".join(f"({x},{y}) {t}" for x, y, t in ref.labels()) or "no objects"
        if lines[i] != txt:
            raise AssertionError(f"{what} frame {i}: printed {lines[i]!r}, "
                                 f"the plain program gives {txt!r}")
        print(f"{what} frame {i}: labels equal the plain program's: {txt}",
              flush=True)
    if not any("disparity = " in t for t in lines.values()):
        raise AssertionError(f"{what}: no label shows a disparity")
    return eng


def _trace_overlap(fn):
    """Kernel intervals of one fn() call from a torch.profiler trace:
    (kernels, streams, ms during which kernels of two or more streams ran
    at once, pairs of cooperative kernels (K2, the vertical kernel) on two
    streams that overlap in time, cooperative kernels)."""
    import json as _json
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        _sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = _json.load(f)["traceEvents"]
    ks = [(e["ts"], e["ts"] + e["dur"], e["args"].get("stream"), e["name"])
          for e in events if e.get("cat") == "kernel" and "dur" in e]
    # sweep the starts and ends: time with kernels of 2+ streams running
    edges = sorted([(a, 1, st) for a, _, st, _ in ks] + [(b, -1, st) for _, b, st, _ in ks],
                   key=lambda e: e[:2])
    running, busy, shared_us, last = {}, 0, 0.0, None
    for t, step, st in edges:
        if last is not None and busy >= 2:
            shared_us += t - last
        running[st] = running.get(st, 0) + step
        busy = sum(1 for v in running.values() if v > 0)
        last = t
    coop = [k for k in ks if "cc_propagate" in k[3] or "sgm_vert3" in k[3]]
    pairs = sum(1 for i, a in enumerate(coop) for b in coop[i + 1:]
                if a[2] != b[2] and a[0] < b[1] and b[0] < a[1])
    return len(ks), len({k[2] for k in ks}), shared_us / 1e3, pairs, len(coop)


def _coop_streams(card):
    """K2 (a connected-components call) and the vertical kernel (K5) on
    BATCH streams at once, issued back to back so that the device holds
    several of them (the batch mode's host-bound frames never do): each
    result equals the same call on one stream, none hangs, and the trace
    shows whether the cooperative grids overlapped."""
    import torch

    from rt_depth_map_tpu_torch.ops.cc import connected_components_bbox
    from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import sgm_vert_wta

    what = f"phase 11 cooperative kernels on {BATCH} streams"
    g = torch.Generator(device=DEV).manual_seed(0)
    mask = torch.rand((H, W), device=DEV, generator=g) < 0.45
    C = torch.randint(0, 1024, (H, W - D, D), dtype=torch.int16, device=DEV,
                      generator=g)
    Sh = torch.randint(0, 1 << 16, (H, W - D, D), dtype=torch.int32, device=DEV,
                       generator=g)

    def call():
        return connected_components_bbox(mask, 8) + sgm_vert_wta(C, Sh, 600, 2400, 10)

    ref = call()
    streams = [torch.cuda.Stream() for _ in range(BATCH)]

    def burst():
        main = torch.cuda.current_stream()
        outs = []
        for s in streams:
            s.wait_stream(main)
            with torch.cuda.stream(s):
                outs.append(call())
        for s in streams:
            main.wait_stream(s)
        return outs

    with _deadline(BATCH_DEADLINE, what):
        for rep in range(3):
            for b, out in enumerate(burst()):
                if not all(torch.equal(o, r) for o, r in zip(out, ref)):
                    raise AssertionError(f"{what}: stream {b} differs from one "
                                         f"stream (burst {rep})")
        n, n_streams, over_ms, pairs, n_coop = _trace_overlap(burst)
    print(f"{what} on {card}: every result equals one stream's; a burst traced: "
          f"{n} kernels on {n_streams} streams, {over_ms:.3f} ms with kernels of two "
          f"or more streams running, {pairs} pairs of cooperative "
          f"kernels ({n_coop} in all) overlapping across streams", flush=True)
    del C, Sh, ref
    torch.cuda.empty_cache()


def _entry_points(card):
    """Phase 11: the CLI (BM default, SGM-8, run_preloaded) from calibration
    files, the cooperative kernels on four streams, the setters, and the
    host syncs of a frame. Returns {path: launches}."""
    import tempfile

    import torch

    from rt_depth_map_tpu_torch.pipeline.engine import FrameResult, _to_host

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        intr, extr = _write_calibration(tmp, W, H)
        cal = ["-i", intr, "-e", extr, "--source", "synthetic"]
        # the CLI's default matcher: BM, -nd 192 (D = 192 at 1280), bs 13
        argv = cal + ["--frames", str(CLI_FRAMES), "--stats", "--print-depth",
                      "--show-disparity-value"]
        out, err, launches = _run_cli(argv, "cli bm")
        what = f"phase 11 cli bm {W}x{H} D=192"
        if "D=192" not in err or f"processed {CLI_FRAMES} frames" not in err:
            raise AssertionError(f"{what}: {err[-1500:]}")
        _require_launched(launches, BM_PATH, what, BIDIR + ("sgm_cost_volume",))
        _cli_labels_match_plain(argv, out, what, CLI_FRAMES, (0, 1, 7, CLI_FRAMES - 1))
        runs[f"cli bm {W}x{H} D=192"] = launches

        argv = cal + ["--matcher", "sgm", "-nd", "128", "--frames", str(CLI_FRAMES),
                      "--stats", "--print-depth", "--show-disparity-value"]
        out, err, launches = _run_cli(argv, "cli sgm-8")
        what = f"phase 11 cli sgm-8 {W}x{H} D=128"
        if "D=128" not in err or f"processed {CLI_FRAMES} frames" not in err:
            raise AssertionError(f"{what}: {err[-1500:]}")
        _require_launched(launches, SGM_PATH, what, ("bm_cost_wta", "sgm_horiz_pass"))
        _cli_labels_match_plain(argv, out, what, CLI_FRAMES, (0, CLI_FRAMES - 1))
        runs[f"cli sgm-8 {W}x{H} D=128"] = launches

        rates = {}
        for name, extra in (("run", []), ("run_preloaded", ["--preload", "6"])):
            _, err, launches = _run_cli(
                cal + ["--frames", str(PRELOAD_FRAMES), "--stats"] + extra,
                f"cli bm {name}")
            _require_launched(launches, BM_PATH, f"phase 11 cli bm {name}")
            if f"processed {PRELOAD_FRAMES} frames" not in err:
                raise AssertionError(f"phase 11 cli bm {name}: {err[-1500:]}")
            rates[name] = _fps_of(err)
        print(f"phase 11 cli bm {W}x{H} D=192 on {card}: run {rates['run']:.2f} "
              f"frames/s, run_preloaded {rates['run_preloaded']:.2f} frames/s "
              f"({PRELOAD_FRAMES} frames, no consumer)", flush=True)

    _coop_streams(card)

    # -- the setters: the next frame equals a fresh engine's -----------------
    lf, rf, _, _ = _source(W, H).render(0)
    pair = (torch.from_numpy(lf).to(DEV), torch.from_numpy(rf).to(DEV))
    low, high, size = [0, 120, 60], [12, 255, 255], 50000
    eng = _engine("bm", W, H)
    before = FrameResult(**_to_host(eng.frame_program(*pair)))
    eng.set_hsv_thresholds(low, high)
    eng.set_min_object_size(size)
    got = FrameResult(**_to_host(eng.frame_program(*pair)))
    fresh = _engine("bm", W, H)
    fresh.set_hsv_thresholds(low, high)
    fresh.set_min_object_size(size)
    ref = FrameResult(**_to_host(fresh.frame_program(*pair)))
    for k in ("disparity", "boxes", "mask", "count", "rgb_rect", "depth_cm", "mean_z"):
        if not np.array_equal(getattr(got, k), getattr(ref, k), equal_nan=k in (
                "depth_cm", "mean_z")):
            raise AssertionError(f"phase 11 setters: {k} differs from a fresh engine's")
    nb, na = int(before.boxes[:, 4].sum()), int(got.boxes[:, 4].sum())
    if nb == na:
        raise AssertionError(f"phase 11 setters: boxes {nb} -> {na}, no change")
    print(f"phase 11 setters: boxes {nb} -> {na}; the next frame equals a fresh "
          f"engine's with the same values", flush=True)

    # -- host syncs of one frame (set_sync_debug_mode) -----------------------
    for kind in ("sgm", "bm"):
        e = _engine(kind, W, H)
        syncs = _host_syncs(lambda: e.frame_program(*pair))
        print(f"phase 11 host syncs, {kind} frame program: {syncs or 'none'}",
              flush=True)
        if any("rt_depth_map_tpu_torch" in site for site in syncs):
            raise AssertionError(f"phase 11: the {kind} frame program waits for the "
                                 f"device: {syncs}")
        del e
    return runs


# -- the batched entries (phase 3) and the batch programs (phase 13) --------

def _lib_count(lib: str, name: str):
    """A kernel library's own count of its CUDA launches (a ctypes int)."""
    from rt_depth_map_tpu_torch.ops.cuda import _build

    return ctypes.c_int.in_dll(_build.load(lib), name)


def _rig_batch(w, h, step=0):
    """The (B, h, w, 3) uint8 left and right images of BATCH rigs (seeds 0
    to BATCH - 1) at `step`, on the card."""
    import torch

    pairs = [_source(w, h, seed=s).render(step)[:2] for s in range(BATCH)]
    return tuple(torch.from_numpy(np.stack([p[i] for p in pairs])).to(DEV)
                 for i in (0, 1))


def _batch_kernels(check, st, m):
    """Phase 3: the batched K1, K3 and K5 against their plain versions at
    1280x720 with B = BATCH rigs, timed, with their launches by the
    wrappers' and the libraries' counts; K5 also on an int32 volume, on a
    batch its band plan splits into launches of fewer frames, and on a
    frame of all-equal costs beside a textured one (a carry leaked across
    the frames' border would show there). Each bound is B frames' bytes
    (the rectify tables, shared by the frames, once)."""
    import torch

    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda.remap import (
        rectify_pair_batch,
        rectify_pair_batch_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
        sgm_cost_volume_batch,
        sgm_cost_volume_batch_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz
    from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
        k5_batch_plan,
        sgm_vert_wta,
        sgm_vert_wta_batch,
        sgm_vert_wta_batch_plain,
    )

    B = BATCH
    lefts, rights = _rig_batch(W, H)
    planes = (rgb_to_gray(lefts), lefts, rgb_to_gray(rights))
    what = f"{W}x{H} B={B}"

    def counted(fn, lib, name, want, label):
        count = _lib_count(lib, name)
        before = count.value
        out = fn()
        if count.value - before != want:
            raise AssertionError(f"{label}: {count.value - before} CUDA launches "
                                 f"in a call, not {want}")
        return out

    rect = counted(lambda: rectify_pair_batch(*planes, st.left, st.right),
                   "remap", "rtdm_remap_kernel_launches", 1, "rectify_pair_batch")
    out_b = _nbytes(*rect)
    check(rectify_pair_batch, lambda: rectify_pair_batch(*planes, st.left, st.right),
          lambda: rectify_pair_batch_plain(*planes, st.left, st.right),
          f"{what} both views",
          bound=(_nbytes(st.left.packed, st.right.packed, *planes), out_b,
                 16 * out_b))
    lrect, _, rrect = rect
    dtype = sg.volume_dtype(BS, m.pre_filter_cap)
    lpl = sg.plane_stack(lrect, m.pre_filter_cap)
    rpl = sg.plane_stack(rrect, m.pre_filter_cap)
    C = counted(lambda: sgm_cost_volume_batch(lpl, rpl, D, BS, dtype)[0],
                "sgm_cost", "rtdm_sgm_cost_kernel_launches", 1,
                "sgm_cost_volume_batch")
    n = C.numel()
    check(sgm_cost_volume_batch, lambda: sgm_cost_volume_batch(lpl, rpl, D, BS, dtype)[0],
          lambda: sgm_cost_volume_batch_plain(lpl, rpl, D, BS, dtype)[0], what,
          bound=(_nbytes(lpl, rpl), _nbytes(C), _lanes(21 * n, C.element_size())),
          plain_reps=2)
    del lpl, rpl
    W1 = W - D
    p1, p2, ur = m.p1, max(m.p2, m.p1 + 1), m.uniqueness_ratio
    Sh = sg.swap_pixel_axes(sgm_horiz(sg.swap_pixel_axes(C.view(B * H, W1, D)),
                                      p1, p2)).view(B, H, W1, D)
    bp = k5_batch_plan(B, W1, D, C.element_size(), C.device)
    outs = counted(lambda: sgm_vert_wta_batch(C, Sh, p1, p2, ur), "sgm_vert_wta",
                   "rtdm_sgm_vert_kernel_launches", 2 * -(-B // bp.frames),
                   "sgm_vert_wta_batch")
    check(sgm_vert_wta_batch, lambda: sgm_vert_wta_batch(C, Sh, p1, p2, ur),
          lambda: sgm_vert_wta_batch_plain(C, Sh, p1, p2, ur), what + " int16",
          bound=(_nbytes(C, Sh), _nbytes(*outs),
                 _lanes(6 * 8 * n, C.element_size()) + 8 * n), plain_reps=1)
    print(f"phase 3 batched entries {what}: rectify_pair_batch 1 CUDA launch, "
          f"sgm_cost_volume_batch 1, sgm_vert_wta_batch {bp.frames} frames a launch "
          f"pair ({bp.plan}), 2 CUDA launches a pair (the libraries' counts)",
          flush=True)
    Ci = C.to(torch.int32)
    check(sgm_vert_wta_batch, lambda: sgm_vert_wta_batch(Ci, Sh, p1, p2, ur),
          lambda: sgm_vert_wta_batch_plain(Ci, Sh, p1, p2, ur), what + " int32",
          timed=False)
    del Ci
    # a frame of all-equal costs (and no horizontal sum) beside a textured
    # one, each against the single-frame K5
    Ce = torch.stack([C[0], torch.full_like(C[0], 1000)])
    She = torch.stack([Sh[0], torch.zeros_like(Sh[0])])
    eq = sgm_vert_wta_batch(Ce, She, p1, p2, ur)
    for b in range(2):
        if not all(torch.equal(g[b], o) for g, o in
                   zip(eq, sgm_vert_wta(Ce[b].contiguous(), She[b].contiguous(),
                                        p1, p2, ur))):
            raise AssertionError(f"sgm_vert_wta_batch: frame {b} of the equal-cost "
                                 f"batch differs from the single-frame K5")
    check(sgm_vert_wta_batch, lambda: sgm_vert_wta_batch(Ce, She, p1, p2, ur),
          lambda: sgm_vert_wta_batch_plain(Ce, She, p1, p2, ur),
          f"{W}x{H} a textured frame beside one of all-equal costs", timed=False)
    del C, Sh, Ce, She, eq, outs
    # a batch the plan must split: 3840x2160's W1 = 3712 at D = 128 on 16
    # rows, the fewest frames that do not fit one launch
    rng = np.random.default_rng(8)
    vw1, vd = 3712, 128
    Bs = next(b for b in range(2, 9) if k5_batch_plan(b, vw1, vd, 2, DEV).frames < b)
    sp = k5_batch_plan(Bs, vw1, vd, 2, DEV)
    Cs = rng.integers(0, 2300, (Bs, 16, vw1, vd))
    Cs[0, :, -1] = 2300
    Cs[1, :, 0] = 0
    Cs = torch.from_numpy(Cs).to(torch.int16).to(DEV)
    Shs = torch.from_numpy(rng.integers(0, 1 << 14, (Bs, 16, vw1, vd))).to(
        torch.int32).to(DEV)
    pairs = -(-Bs // sp.frames)
    w0 = sgm_vert_wta_batch.launches
    counted(lambda: sgm_vert_wta_batch(Cs, Shs, p1, p2, ur), "sgm_vert_wta",
            "rtdm_sgm_vert_kernel_launches", 2 * pairs, "sgm_vert_wta_batch split")
    if sgm_vert_wta_batch.launches - w0 != pairs:
        raise AssertionError("sgm_vert_wta_batch split: wrapper launches")
    check(sgm_vert_wta_batch, lambda: sgm_vert_wta_batch(Cs, Shs, p1, p2, ur),
          lambda: sgm_vert_wta_batch_plain(Cs, Shs, p1, p2, ur),
          f"16x{vw1} D={vd} B={Bs}: {pairs} launch pairs of {sp.frames} frames",
          timed=False)
    print(f"phase 3 sgm_vert_wta_batch split: B={Bs} at W1={vw1} D={vd} in {pairs} "
          f"launch pairs of <= {sp.frames} frames ({sp.plan}), exact", flush=True)
    del Cs, Shs
    torch.cuda.empty_cache()


def _batch_modes(card):
    """Phase 13: the batch program at 1280x720 with B = BATCH rigs
    (a MultiStreamSource), SGM-8 D=128 and BM-128: each step's
    launches against BATCH_PER_STEP and the libraries' counts of the
    batched K1, K3 and K5 (BATCH_LIB_PER_STEP), with the counts set to 0
    just before and every plain version guarded; every frame equal to the
    plain single-frame program of its rig's pair (depth to rtol 1e-5); then
    `step_batch` frames/s beside `run`, and a step's device ms, device
    operations and busy share. Returns {path: launches}."""
    import torch

    from rt_depth_map_tpu_torch import Engine
    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
    from rt_depth_map_tpu_torch.pipeline.engine import FrameResult, _to_host
    from rt_depth_map_tpu_torch.sources import MultiStreamSource

    runs = {}
    for kind in ("sgm", "bm"):
        cfg = _config(kind, W, H).replace(batch=BATCH)
        rigs = lambda ring=0: MultiStreamSource(  # noqa: E731
            [_source(W, H, ring=ring, seed=s) for s in range(BATCH)])
        what = f"phase 13 batch program {kind} x{BATCH} {W}x{H}"
        eng = Engine(cfg, rectification=_rectification(W, H), source=rigs(),
                     device=DEV)
        refs = []  # the plain single-frame program of each rig
        for step in range(BATCH_STEPS):
            lefts, rights = _rig_batch(W, H, step)
            refs.append([FrameResult(**_to_host(eng.frame_program(
                lefts[b], rights[b], plain=True))) for b in range(BATCH)])
        libs = [(_lib_count(lib, cnt), want)
                for lib, cnt, want in BATCH_LIB_PER_STEP[kind]]
        with _deadline(BATCH_DEADLINE, f"{what} checked steps"):
            with _no_plain_on_card():
                reset_launch_counts()
                lib0 = [c.value for c, _ in libs]
                results = [eng.step_batch() for _ in range(BATCH_STEPS)]
                _sync()
                launches = {wr.__name__: wr.launches for wr, _, _ in KERNELS}
                lib_steps = [(c.value - v0) / BATCH_STEPS
                             for (c, _), v0 in zip(libs, lib0)]
        path = BATCH_SGM_PATH if kind == "sgm" else ("rectify_pair_batch",) + BM_PATH[1:]
        _require_launched(launches, path, what)
        got = {k: launches[k] / BATCH_STEPS for k in BATCH_PER_STEP[kind]}
        if got != BATCH_PER_STEP[kind]:
            raise AssertionError(f"{what}: launches a step {got}, expected "
                                 f"{BATCH_PER_STEP[kind]}")
        if lib_steps != [want for _, want in libs]:
            raise AssertionError(f"{what}: the libraries' CUDA launches a step "
                                 f"{lib_steps}, expected {[w for _, w in libs]}")
        for step, res in enumerate(results):
            for b, ref in enumerate(refs[step]):
                for k in ("disparity", "boxes", "mask", "count", "rgb_rect"):
                    if not np.array_equal(getattr(res[b], k), getattr(ref, k)):
                        raise AssertionError(f"{what} step {step} rig {b}: {k} "
                                             f"differs from the plain program")
                for k in ("depth_cm", "mean_z"):
                    if not np.allclose(getattr(res[b], k), getattr(ref, k),
                                       rtol=1e-5, equal_nan=True):
                        raise AssertionError(f"{what} step {step} rig {b}: {k} "
                                             f"off the plain program's")
                if not res[b].has_objects:
                    raise AssertionError(f"{what} step {step} rig {b}: no box")
        print(f"{what}: {BATCH_STEPS} steps, every frame equals the plain "
              f"single-frame program of its rig's pair; launches a step {got}; "
              f"the libraries' CUDA launches a step (K1, K3, K5) {lib_steps}",
              flush=True)
        runs[f"batch program {kind} x{BATCH} {W}x{H}"] = launches
        del eng
        # timing: step_batch beside the single-stream run
        rates = {}
        lefts, rights = _rig_batch(W, H)
        with _deadline(BATCH_DEADLINE, f"phase 13 {kind} timing"):
            timed = Engine(cfg, rectification=_rectification(W, H),
                           source=rigs(8), device=DEV)
            for _ in range(8):  # render each rig's ring
                timed.step_batch()
            _sync()
            t0 = time.perf_counter()
            for _ in range(BATCH_TIMED_STEPS):
                timed.step_batch()
            fps = BATCH * BATCH_TIMED_STEPS / (time.perf_counter() - t0)
            dev_ms, wall_ms, ops = _device_busy(lambda: timed.process_batch(lefts, rights))
            rates["batch program"] = fps
            print(f"phase 13 batch program {kind} x{BATCH} {W}x{H} timing on {card}: "
                  f"{fps:.2f} frames/s over {BATCH_TIMED_STEPS} steps; a step on "
                  f"the same images each time {wall_ms:.3f} ms of wall, "
                  f"{dev_ms:.3f} ms of device time (busy "
                  f"{dev_ms / wall_ms:.3f}), {ops:g} device operations",
                  flush=True)
            del timed
            single = _engine(kind, W, H, ring=8)
            single.warmup()
            single.run(frames=8, print_stats_on_sigint=False)
            f0, s0 = single.stats.wall_frames, single.stats.wall_seconds
            single.run(frames=BATCH * BATCH_TIMED_STEPS, print_stats_on_sigint=False)
            rates["run"] = ((single.stats.wall_frames - f0)
                            / (single.stats.wall_seconds - s0))
            del single
        print(f"phase 13 {kind} x{BATCH} {W}x{H} frames/s on {card}: "
              + ", ".join(f"{k} {v:.2f}" for k, v in rates.items()), flush=True)
        torch.cuda.empty_cache()
    return runs


# -- the exact width tiling's kernels (phase 3) and phase 12 ---------------

#: the tiles of the phase-3 tiling checks: the 720p frame's W1 over 2 ranks
TILES = 2
#: seconds a phase 12 world may take (its ranks' start included) before it
#: is killed and the run fails
PAR_DEADLINE = 420
#: the kernels of each multi-rank path
EXACT_PATH = ("sgm_cost_volume", "sgm_tile_scan", "sgm_tile_final",
              "lr_resolve_sgbm", "seg_min_propagate", "speckle_decision",
              "speckle_apply")
SHARDED_PATH = ("rectify_pair",) + EXACT_PATH
TILED_BM_PATH = ("bm_cost_wta", "lr_resolve_bm", "seg_min_propagate",
                 "speckle_decision", "speckle_apply")
MARGIN_PATH = ("sgm_cost_volume", "lr_resolve_sgbm", "seg_min_propagate",
               "speckle_decision", "speckle_apply")
SINGLE_SGM = BIDIR + ("sgm_horiz_pass", "sgm_vert_pass", "sgm_final_wta")
#: frames of the (2, 2) sharded step (dryrun_multichip's B = 2 x data)
PAR_BATCH = 4
#: the exact tiling's kernels' designs and the basis of their bounds, for
#: their entries in the kernels line
TILE_DESIGN = {
    "sgm_tile_scan": "a warp a line (a row or a diagonal of a job), D over its "
                     "lanes; costs copied 7 pixels ahead into a per-warp cp.async "
                     "ring (8 slots; a register path where a pixel's costs are not "
                     "whole 16-byte pieces); L staged in shared memory and added "
                     "into S with atomic adds (REDG), 32 consecutive words an "
                     "instruction; one ordinary launch a wavefront step, capturable "
                     "in a CUDA graph. Bound: C read once, S read and written once "
                     "for each distinct row block of the step",
    "sgm_tile_final": "two warps a column meeting in the middle row (one at 5 "
                      "and 4 paths), fed from cp.async rings, ending each pixel in "
                      "the winner-take-all. Bound: C and S read once, the four "
                      "maps written once",
}


def _tiling_kernels(check, lrect, rrect, m):
    """K3's output column window, `sgm_tile_scan` and `sgm_tile_final` at
    the 720p frame's n = 2 tile shape (576 of W1 = 1152 columns, 90-row
    blocks) and at an odd tile (97 columns, 7-row blocks, D = 100 at int16:
    D-vectors that are not whole 16-byte pieces, the kernels' register
    path), against the full volume's slice and the plain versions."""
    import torch

    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
        sgm_cost_volume,
        sgm_cost_volume_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import (
        FINAL_DIRS,
        ScanJob,
        sgm_tile_final,
        sgm_tile_final_plain,
        sgm_tile_scan,
        sgm_tile_scan_plain,
    )
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import _default_row_block, cross_dirs

    dev = lrect.device
    dtype = sg.volume_dtype(BS, m.pre_filter_cap)
    lpl, rpl = sg.plane_stack(lrect, m.pre_filter_cap), sg.plane_stack(rrect, m.pre_filter_cap)
    C, _, W1 = sgm_cost_volume(lpl, rpl, D, BS, dtype)
    wloc = W1 // TILES
    what = f"{H}x{W} D={D} tile of {wloc} columns"
    for i in range(TILES):
        cols = (i * wloc, wloc)
        if not torch.equal(sgm_cost_volume(lpl, rpl, D, BS, dtype, cols=cols)[0],
                           C[:, i * wloc: (i + 1) * wloc]):
            raise AssertionError(f"sgm_cost_volume column window {cols} != the full "
                                 f"volume's slice")
    print(f"phase 3 sgm_cost_volume column windows: each of the {TILES} tiles "
          f"equals the full volume's slice", flush=True)
    cols = (wloc, wloc)  # the last tile: the replicate border on its right
    Cw = sgm_cost_volume(lpl, rpl, D, BS, dtype, cols=cols)[0]
    # the planes of the tile's columns and of the right columns they meet
    check(sgm_cost_volume, lambda: sgm_cost_volume(lpl, rpl, D, BS, dtype, cols=cols)[0],
          lambda: sgm_cost_volume_plain(lpl, rpl, D, BS, dtype, cols=cols)[0],
          f"{what} (column window)",
          bound=(2 * H * (wloc + D + BS) * 8, _nbytes(Cw), _lanes(21 * Cw.numel(), 2)),
          plain_reps=3, primary=False)
    Ct = C[:, :wloc].contiguous()  # tile 0
    # the odd tile: 70 rows, 97 columns and 100 disparities of the volume
    Co = C[:70, :97, :100].contiguous()
    del C, Cw
    p1, p2 = m.p1, max(m.p2, m.p1 + 1)
    g = torch.Generator(device="cpu").manual_seed(3)

    def strip(rows, d):
        return torch.randint(-500, 6000, (rows, d), generator=g,
                             dtype=torch.int32).to(dev)

    def step_jobs(Cv, rb, kf, kb):
        """A wavefront step of 8 paths on tile 0 of 2: every cross-tile
        direction on its block (k = kf from the left, kb from the right),
        random carries."""
        h, w, d = Cv.shape
        jobs = []
        for dy, dx in cross_dirs(8):
            k = kf if dx == 1 else kb
            start = h - (k + 1) * rb if dy == -1 else k * rb
            jobs.append(ScanJob(dy, dx, start, rb, strip(rb + 1, d), strip(rb + 1, d),
                                strip(w, d)))
        return jobs

    rb = _default_row_block(H, TILES)
    # the steady step (k = 4 from the left, 3 from the right: the top-down
    # jobs of each family and the other's bottom-up job on one block), and a
    # step whose directions lie on four blocks (k = 2, 1)
    steady, apart = step_jobs(Ct, rb, 4, 3), step_jobs(Ct, rb, 2, 1)
    # the odd tile's 10 blocks: k = 5, 4 shares blocks there too
    odd = step_jobs(Co, 7, 5, 4)
    # each cross-tile direction alone (the vertical ones are sgm_tile_final's)
    for Cv, where, jobs in ((Ct, what, steady), (Co, "odd tile 70x97 D=100", odd)):
        for job in jobs:
            S0 = torch.zeros(Cv.shape, dtype=torch.int32, device=dev)
            S1 = S0.clone()
            err = _max_abs_err(_flat(S0, sgm_tile_scan(Cv, S0, [job], p1, p2)),
                               _flat(S1, sgm_tile_scan_plain(Cv, S1, [job], p1, p2)))
            if err:
                raise AssertionError(f"sgm_tile_scan ({job.dy}, {job.dx}) {where}: "
                                     f"kernel != plain (max |err| {err})")
            print(f"phase 3 sgm_tile_scan direction ({job.dy}, {job.dx}) rows "
                  f"[{job.row0}, {job.row0 + job.rows}) {where}: exact", flush=True)
        del S0, S1
    for Cv, name, js, timed in ((Ct, f"{what}, a wavefront step, 6 directions", steady, True),
                                (Ct, f"{what}, a step on four blocks", apart, True),
                                (Co, "odd tile 70x97 D=100, a wavefront step", odd, False)):
        Sk = torch.zeros(Cv.shape, dtype=torch.int32, device=dev)
        elems = sum(j.rows for j in js) * Cv.shape[1] * Cv.shape[2]
        # the function's floor: C read once and S read and written once for
        # each distinct row block the directions cover (directions that share
        # a block add into S in one pass; the carries are ~1%); ~8 int32
        # operations an element and direction
        block = sum(rows for _, rows in {(j.row0, j.rows) for j in js}) * Cv.shape[1] * Cv.shape[2]
        check(sgm_tile_scan, lambda js=js, Sk=Sk, Cv=Cv: _flat(Sk, sgm_tile_scan(Cv, Sk, js, p1, p2)),
              lambda js=js, Cv=Cv: _flat(*_plain_scan(Cv, js, p1, p2)), name,
              bound=(block * (Cv.element_size() + 4), block * 4, _lanes(8 * elems, 4)),
              plain_reps=1, timed=timed, primary=name.endswith("6 directions"))
        del Sk
    # the steady step captured in a CUDA graph and replayed twice, S reset
    # between the replays: equal to the eager call (a launch keeps nothing
    # between calls)
    S0 = torch.randint(-5000, 5000, Ct.shape, generator=g, dtype=torch.int32).to(dev)
    S_eager = S0.clone()
    eager = _flat(S_eager, sgm_tile_scan(Ct, S_eager, steady, p1, p2))
    S_graph = S0.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _flat(S_graph, sgm_tile_scan(Ct, S_graph, steady, p1, p2))
    for _ in range(2):
        S_graph.copy_(S0)
        graph.replay()
        err = _max_abs_err(captured, eager)
        if err:
            raise AssertionError(f"sgm_tile_scan {what}: a replayed CUDA graph of the "
                                 f"steady step != the eager call (max |err| {err})")
    print(f"phase 3 sgm_tile_scan {what}: the steady step captured in a CUDA graph, "
          f"replayed twice, equals the eager call; a replay {_b2b_ms(graph.replay):.4f} "
          f"ms back to back", flush=True)
    del graph, captured, eager, S0, S_eager, S_graph
    # the tile's last launch: its vertical paths (both senses at 8 paths,
    # the top-down one at 5 and 4) and the winner-take-all, on a sum S of
    # the other directions (the kernel uses S as scratch: each checked call
    # gets a copy; the timed calls reuse one buffer)
    for Cv, where in ((Ct, what), (Co, "odd tile 70x97 D=100")):
        S0 = torch.randint(0, 60000, Cv.shape, generator=g, dtype=torch.int32).to(dev)
        Sk = S0.clone()
        n = Cv.numel()
        for dirs in FINAL_DIRS[::-1]:
            name = (f"{where}, the vertical paths {'+ and -' if len(dirs) == 2 else '+'} "
                    f"+ winner-take-all")
            check(sgm_tile_final,
                  lambda Cv=Cv, S0=S0, dirs=dirs: sgm_tile_final(Cv, S0.clone(), p1, p2,
                                                                 m.uniqueness_ratio, dirs),
                  lambda Cv=Cv, S0=S0, dirs=dirs: sgm_tile_final_plain(
                      Cv, S0.clone(), p1, p2, m.uniqueness_ratio, dirs), name,
                  # C and S read once, the four (H, W) maps written once;
                  # ~8 int32 operations an element and direction, ~6 for the
                  # winner-take-all
                  bound=(_nbytes(Cv, S0), 16 * n // Cv.shape[2],
                         _lanes((8 * len(dirs) + 6) * n, 4)),
                  plain_reps=1, timed=Cv is Ct,
                  time_fn=lambda Cv=Cv, Sk=Sk, dirs=dirs: sgm_tile_final(
                      Cv, Sk, p1, p2, m.uniqueness_ratio, dirs))
        del S0, Sk
    torch.cuda.empty_cache()


def _plain_scan(C, jobs, p1, p2):
    import torch

    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import sgm_tile_scan_plain

    S = torch.zeros(C.shape, dtype=torch.int32, device=C.device)
    return S, sgm_tile_scan_plain(C, S, jobs, p1, p2)


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def _flat(S, results):
    """S and the jobs' outboxes and prevs, as one tuple (the comparison's)."""
    return (S, *[t for pair in results for t in pair if t is not None])


def _rank_setup(rank, world, port, backend):
    """Bring one rank of a phase 12 world up on card 0: NCCL at world size 1
    straight through init_process_group (`distributed_init` runs no world of
    one), any other world through `distributed_init`."""
    import datetime

    import torch
    import torch.distributed as dist

    from rt_depth_map_tpu_torch.parallel.launch import distributed_init

    if world == 1:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0,
                                timeout=datetime.timedelta(seconds=PAR_DEADLINE))
        # the backend itself on the card: a collective over the world
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        if dist.get_backend() != "nccl" or not torch.equal(x, torch.ones_like(x)):
            raise AssertionError(f"world of one on {dist.get_backend()}: all_reduce {x}")
    elif not distributed_init(f"127.0.0.1:{port}", world, rank, device="cuda",
                              backend=backend, timeout=PAR_DEADLINE):
        raise AssertionError("distributed_init returned False")


def _rank_counts(fn):
    """fn() with the counts set to 0 just before, every rank started
    together; (its result, the launches, this rank's ms)."""
    import torch
    import torch.distributed as dist

    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    dist.barrier()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, {w.__name__: w.launches for w, _, _ in KERNELS}, ms


def _rank_ms(fn, reps=3):
    """Median ms of fn() on this rank, every rank started together."""
    import torch
    import torch.distributed as dist

    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _gray_pair(w, h):
    import torch

    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray

    lf, rf, _, _ = _source(w, h).render(0)
    return (rgb_to_gray(torch.from_numpy(lf).to(DEV)),
            rgb_to_gray(torch.from_numpy(rf).to(DEV)))


def _job_sharded(shape, frames):
    """The sharded step (SGM-8 exact, 1280x720 D=128, through the phases'
    rectification) on `frames` frames; each of this rank's frames against
    Engine.process_pair."""
    import torch

    from rt_depth_map_tpu_torch import Engine
    from rt_depth_map_tpu_torch.parallel import make_mesh
    from rt_depth_map_tpu_torch.parallel.pipeline_sharded import make_sharded_step

    mesh = make_mesh(shape)
    cfg = _config("sgm", W, H)
    rect = _rectification(W, H)
    step, shard = make_sharded_step(mesh, cfg, (W, H), Q=rect.Q,
                                    remap_grid=rect.map_left, device=DEV)
    src = _source(W, H)
    pairs = [src.render(i)[:2] for i in range(frames)]
    mine = shard(list(range(frames)))
    L = torch.from_numpy(np.stack([pairs[i][0] for i in mine])).to(DEV)
    R = torch.from_numpy(np.stack([pairs[i][1] for i in mine])).to(DEV)
    step(L, R)  # warm
    out, launches, _ = _rank_counts(lambda: step(L, R))
    what = f"sharded step {shape} sgm-8 exact {W}x{H} D={D}"
    _require_launched(launches, SHARDED_PATH, what, SINGLE_SGM + GENERAL)
    ms = _rank_ms(lambda: step(L, R)) / len(mine)
    eng = Engine(cfg, rectification=rect, source=_source(W, H), device=DEV)
    bad = {}
    for j, i in enumerate(mine):
        ref = eng.process_pair(*pairs[i])
        for k in ("disparity", "boxes", "mask", "count"):
            if not np.array_equal(out[k][j].cpu().numpy(), getattr(ref, k)):
                bad[f"frame {i} {k}"] = int((out[k][j].cpu().numpy()
                                             != getattr(ref, k)).sum())
        if ref.boxes[:, 4].sum() == 0 or (ref.disparity != -16).mean() < 0.3:
            raise AssertionError(f"{what} frame {i}: no box or few valid pixels")
    if bad:
        raise AssertionError(f"{what}: differs from Engine.process_pair: {bad}")
    return dict(what=what, mode="sharded", frames=mine, launches=launches, ms=ms)


def _job_matcher(shape, mode, w=W, h=H, d=D):
    """One tiled matcher on the synthetic frame's gray planes: "exact" and
    "bm" bit for bit against the single-device port on the card; "margin"
    (an approximation of the single device by design) bit for bit against
    the same ranks' margin program on the host through the plain versions,
    with its difference from the single device reported beside it: the
    share of all pixels off by more than 1 px (tests/test_parallel.py:126-130's
    count), those pixels in each band of 64 columns, the bad-pixel fraction
    among pixels valid in both maps and the validity difference."""
    import torch

    from rt_depth_map_tpu_torch.metrics import bad_pixel_fraction, validity_difference
    from rt_depth_map_tpu_torch.ops.bm import stereo_bm
    from rt_depth_map_tpu_torch.ops.sgbm import stereo_sgbm
    from rt_depth_map_tpu_torch.parallel import make_mesh, tiled_stereo_bm
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import exact_tiled_stereo_sgbm
    from rt_depth_map_tpu_torch.parallel.tiled_sgbm import tiled_stereo_sgbm

    mesh = make_mesh(shape)
    lg, rg = _gray_pair(w, h)
    if mode == "bm":
        mcfg = _config("bm", w, h).matcher
        fn, single, path = tiled_stereo_bm, stereo_bm, TILED_BM_PATH
        what = f"tiled BM-{BM_D} bs {BM_BS} {shape} {w}x{h}"
    else:
        mcfg = _config("sgm", w, h, d).matcher
        fn = exact_tiled_stereo_sgbm if mode == "exact" else tiled_stereo_sgbm
        single = stereo_sgbm
        path = EXACT_PATH if mode == "exact" else MARGIN_PATH
        what = f"{mode} sgm-8 {shape} {w}x{h} D={d}"
    fn(lg, rg, mcfg, mesh)  # warm
    disp, launches, _ = _rank_counts(lambda: fn(lg, rg, mcfg, mesh))
    _require_launched(launches, path, what,
                      (SINGLE_SGM if mode == "exact" else ()) + GENERAL)
    ms = _rank_ms(lambda: fn(lg, rg, mcfg, mesh))
    ref = single(lg, rg, mcfg)
    if mode == "margin":
        t0 = time.perf_counter()
        host = fn(lg.cpu(), rg.cpu(), mcfg, mesh)
        host_s = time.perf_counter() - t0
        if not torch.equal(disp.cpu(), host):
            raise AssertionError(f"{what}: {int((disp.cpu() != host).sum())} pixels "
                                 f"differ from the margin program's plain versions")
    elif not torch.equal(disp, ref):
        raise AssertionError(f"{what}: {int((disp != ref).sum())} pixels differ "
                             f"from the single-device port")
    off = (disp.long() - ref.long()).abs() > 16
    invalid = (mcfg.min_disparity - 1) * 16
    got_np, ref_np = disp.cpu().numpy(), ref.cpu().numpy()
    out = dict(what=what, mode=mode, launches=launches, ms=ms)
    if mode == "margin":
        cols = off.sum(0).cpu().numpy()
        out.update(host_s=host_s, all_frac=float(off.float().mean()),
                   bands=[int(cols[i: i + 64].sum()) for i in range(0, w, 64)],
                   bad_frac=bad_pixel_fraction(got_np, ref_np, invalid),
                   validity=validity_difference(got_np, ref_np, invalid))
    return out


def _rank(rank, world, port, backend, jobs, out_dir):
    """One rank of a phase 12 world: a spawned process on card 0 running
    `jobs` ([(name, kwargs)]) with every plain version guarded."""
    import faulthandler
    import os

    faulthandler.dump_traceback_later(PAR_DEADLINE, exit=True)
    import torch.distributed as dist

    import rt_depth_map_tpu_torch.parallel.pipeline_sharded  # noqa: F401
    from rt_depth_map_tpu_torch import Engine  # noqa: F401
    from rt_depth_map_tpu_torch.parallel import tiled_stereo_bm  # noqa: F401

    _rank_setup(rank, world, port, backend)
    fns = {"sharded": _job_sharded, "matcher": _job_matcher}
    results = []
    with _no_plain_on_card():
        for name, kw in jobs:
            results.append(fns[name](**kw))
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)


def _world(world, backend, jobs):
    """Spawn a world of `world` ranks on card 0 and join it under
    PAR_DEADLINE; each rank's list of job results. A rank that fails or
    hangs fails the phase."""
    import multiprocessing
    import os
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_rank, args=(r, world, port, backend, jobs, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + PAR_DEADLINE
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
        if hung or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"phase 12 {backend} world of {world}: exit codes "
                                 f"{[p.exitcode for p in procs]}, ranks {hung} killed "
                                 f"at the {PAR_DEADLINE} s deadline")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    return results


def _phase12(card):
    """The multi-rank paths (`parallel/`): NCCL at world size 1; gloo worlds
    of 2 and 4 ranks sharing card 0, each rank's kernels on the card, the
    exchanges through host memory. Returns {run: rank 0's launches}."""
    import torch

    torch.cuda.empty_cache()
    shared = "ranks time-sliced on one card, not a scaling figure"
    runs = {}
    t0 = time.perf_counter()
    (r0,), = _world(1, "nccl", [("sharded", dict(shape=(1, 1), frames=1))])
    print(f"phase 12 nccl world of 1, (1, 1) {r0['what']}: equals "
          f"Engine.process_pair; {r0['ms']:.2f} ms a frame on {card}; "
          f"launches {_nonzero(r0['launches'])}", flush=True)
    runs[f"parallel nccl (1, 1) {r0['what']}"] = r0["launches"]

    jobs = [("matcher", dict(shape=(1, 2), mode="exact")),
            ("matcher", dict(shape=(1, 2), mode="bm")),
            ("matcher", dict(shape=(1, 2), mode="margin")),
            ("matcher", dict(shape=(1, 2), mode="exact", w=STRETCH[1], h=STRETCH[0],
                             d=STRETCH[2])),
            ("sharded", dict(shape=(1, 2), frames=1))]
    res = _world(2, "gloo", jobs)
    for j in range(len(jobs)):
        a, b = res[0][j], res[1][j]
        if a["mode"] == "margin":
            verdict = (f"bit-identical to its plain versions on the host "
                       f"({max(a['host_s'], b['host_s']):.1f} s there); against the "
                       f"single-device port: {a['all_frac']:.6f} of all pixels off by "
                       f"> 1 px (by 64-column band {a['bands']}), bad-pixel fraction "
                       f"{a['bad_frac']:.6f} among pixels valid in both, validity "
                       f"difference {a['validity']:.6f}")
        elif a["mode"] == "sharded":
            verdict = "equals Engine.process_pair"
        else:
            verdict = "bit-identical to the single-device port"
        print(f"phase 12 gloo (1, 2) {a['what']}: {verdict} on both ranks; "
              f"{max(a['ms'], b['ms']):.2f} ms a frame ({shared}; {card}); "
              f"rank 0 launches {_nonzero(a['launches'])}", flush=True)
        runs[f"parallel gloo (1, 2) {a['what']}"] = a["launches"]

    res = _world(4, "gloo", [("sharded", dict(shape=(2, 2), frames=PAR_BATCH)),
                             ("matcher", dict(shape=(1, 4), mode="exact"))])
    frames = sorted(f for r in res for f in r[0]["frames"])
    if frames != sorted(list(range(PAR_BATCH)) * 2):
        raise AssertionError(f"phase 12 (2, 2): frames {frames}")
    ms = max(r[0]["ms"] for r in res)
    print(f"phase 12 gloo (2, 2) {res[0][0]['what']}, B={PAR_BATCH}: every frame's "
          f"disparity, boxes, mask and count equal Engine.process_pair on all 4 "
          f"ranks; {ms:.2f} ms a frame ({shared}; {card}); rank 0 launches "
          f"{_nonzero(res[0][0]['launches'])}", flush=True)
    runs[f"parallel gloo (2, 2) {res[0][0]['what']}"] = res[0][0]["launches"]
    x = res[0][1]
    print(f"phase 12 gloo (1, 4) {x['what']}: bit-identical to the single-device "
          f"port on all 4 ranks; {max(r[1]['ms'] for r in res):.2f} ms a frame "
          f"({shared}; {card}); rank 0 launches {_nonzero(x['launches'])}", flush=True)
    runs[f"parallel gloo (1, 4) {x['what']}"] = x["launches"]
    print(f"phase 12 total: {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def main() -> int:
    global PEAK_OPS
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from rt_depth_map_tpu_torch.golden import golden_stereo_bm, golden_stereo_sgbm
    from rt_depth_map_tpu_torch.ops import bm as bm_ops
    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.cc import (
        CC_MAX_ROUNDS,
        component_small,
        component_small_field,
        connected_components_bbox,
        connected_components_scan,
        value_edges,
    )
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, _build
    from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta, bm_cost_wta_plain
    from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import seg_min_propagate
    from rt_depth_map_tpu_torch.ops.cuda.histogram import (
        label_histogram,
        label_histogram_banded,
        label_histogram_plain,
        speckle_apply,
        speckle_apply_plain,
        speckle_decision,
        speckle_decision_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import (
        lr_bm_kwargs,
        lr_key_planes_bm,
        lr_key_planes_sgbm,
        lr_resolve,
        lr_resolve_bm,
        lr_resolve_bm_plain,
        lr_resolve_plain,
        lr_resolve_sgbm,
        lr_resolve_sgbm_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.remap import (
        rectify_pair,
        rectify_pair_plain,
        remap_u8,
        remap_u8_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
        sgm_cost_volume,
        sgm_cost_volume_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
        horiz_pass_plan,
        sgm_final_wta,
        sgm_final_wta_plain,
        sgm_horiz_pass,
        sgm_horiz_pass_plain,
        sgm_vert_pass,
        sgm_vert_pass_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz, sgm_horiz_plain
    from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import chained_plan
    from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
        k5_plan,
        sgm_vert_wta,
        sgm_vert_wta_plain,
    )
    from rt_depth_map_tpu_torch.ops.detect import detect_objects
    from rt_depth_map_tpu_torch.ops.cuda.vol_transpose import (
        vol_transpose,
        vol_transpose_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.wls import tridiag_smooth, tridiag_smooth_plain
    from rt_depth_map_tpu_torch.ops import wls as wls_ops
    from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear
    from rt_depth_map_tpu_torch.ops.speckle import filter_speckles

    # -- 1. device ---------------------------------------------------------
    card = _card()
    dev = torch.device(DEV)
    name = torch.cuda.get_device_name(0)
    PEAK_OPS = _lane_rate()
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()} | "
          f"{PEAK_OPS / 1e12:.2f} T 32-bit lane instructions/s", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    stems = sorted({src.rsplit("/", 1)[1][:-3] for _, src, _ in KERNELS})
    _build.build_all(stems)
    for stem in stems:
        log = _build.build_log.get(stem, "")
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in log.splitlines()
                if "Used " in ln and "registers" in ln]
        spills = sum(int(ln.split("bytes spill stores")[0].split(",")[-1])
                     for ln in log.splitlines() if "bytes spill stores" in ln)
        print(f"phase 2 build {stem}: {_build.build_seconds.get(stem, 0.0):.1f} s, "
              f"{len(regs)} kernels, registers {min(regs, default=0)}-"
              f"{max(regs, default=0)}, spill stores {spills} bytes", flush=True)
        if spills:
            func = ""
            for ln in log.splitlines():
                if "Function properties for " in ln:
                    func = ln.split("Function properties for ")[1].strip()
                if "bytes spill stores" in ln and not ln.strip().startswith("0 bytes"):
                    print(f"phase 2 build {stem} spills: {func}: {ln.strip()}",
                          flush=True)
    print(f"phase 2 build total (parallel): {time.perf_counter() - t0:.1f} s",
          flush=True)
    # K9a's ring path keeps its carries and vectors in registers
    func = ""
    for ln in _build.build_log.get("sgm_hdw", "").splitlines():
        if "Function properties for " in ln:
            func = ln.split("Function properties for ")[1].strip()
        if ("hp_ring_kernel" in func and "bytes spill stores" in ln
                and not ln.strip().startswith("0 bytes")):
            raise AssertionError(f"K9a's ring path spills: {func}: {ln.strip()}")

    # -- 3. kernels vs plain at the frame program's shapes -------------------
    sgm_eng = _engine("sgm", W, H)
    st = sgm_eng.state
    left_np, right_np, _, _ = _source(W, H).render(0)
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    planes = (rgb_to_gray(left), left, rgb_to_gray(right))
    stats = {}

    def check(wrapper, kernel_fn, plain_fn, what, bound=None, library_fn=None,
              plain_reps=15, timed=True, primary=True, tol=0, time_fn=None):
        """Exact equality (float outputs: within tol), then timing
        (timed=False: a variant case, checked only); the first timed primary
        case of a kernel is the one its summary reports, and every timed case
        is listed under its `cases` (bound: (in_bytes, out_bytes, ops);
        library_fn: one PyTorch call computing the same function, timed
        beside every timed case that has one; time_fn: the call timed, where
        the checked one copies an input that the kernel overwrites)."""
        err = _max_abs_err(kernel_fn(), plain_fn())
        if err > tol:
            raise AssertionError(f"{wrapper.__name__} {what}: kernel != plain "
                                 f"(max |err| {err}, tolerance {tol})")
        if not timed:
            entry = stats.setdefault(wrapper.__name__, dict(max_abs_err=0, cases=[]))
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            print(f"phase 3 {wrapper.__name__} {what}: exact", flush=True)
            return
        timed_fn = time_fn or kernel_fn
        ms = _time_ms(timed_fn)
        ms_b2b = _b2b_ms(timed_fn)
        device_ms = _device_busy(timed_fn, frames=20)[0]
        plain_ms = _time_ms(plain_fn, reps=plain_reps, warm=1)
        b_ms, b_by = _bound(*bound)
        lib_ms = _time_ms(library_fn) if library_fn is not None else None
        line = (f"phase 3 {wrapper.__name__} {what}: exact, {ms:.4f} ms, "
                f"{ms_b2b:.4f} ms back to back, {device_ms:.4f} ms device (plain "
                f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}")
        if lib_ms is not None:
            line += f", library {lib_ms:.4f} ms"
        case = dict(what=what, ms=ms, ms_b2b=ms_b2b, device_ms=device_ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)
        entry = stats.setdefault(wrapper.__name__, dict(max_abs_err=0, cases=[]))
        if primary and "ms" not in entry:
            entry.update({k: v for k, v in case.items() if k != "what"})
        entry["cases"].append(case)
        stats[wrapper.__name__]["max_abs_err"] = max(
            stats[wrapper.__name__]["max_abs_err"], err)
        print(line + ")", flush=True)

    # K1 as the frame programs launch it: both views' three planes through
    # the warped maps in one launch (each packed table and source read once,
    # each output written once: 26 bytes a pixel; ~16 int32 operations per
    # output value: four taps, weights, rounding); then remap_u8, one image
    # of 1 to 4 channels on the same device code (3 timed)
    rect = rectify_pair(*planes, st.left, st.right)
    out_b = _nbytes(*rect)
    check(rectify_pair, lambda: rectify_pair(*planes, st.left, st.right),
          lambda: rectify_pair_plain(*planes, st.left, st.right),
          f"{W}x{H} both views",
          bound=(_nbytes(st.left.packed, st.right.packed, *planes), out_b,
                 16 * out_b))
    for c in (3, 1, 2, 4):
        img = left if c == 3 else torch.cat([planes[0][..., None]] * c, -1)
        tab = st.left if c != 1 else st.right
        out_b = tab.packed.numel() * c
        check(remap_u8, lambda i=img, b=tab: remap_u8(i, b),
              lambda i=img, b=tab: remap_u8_plain(i, b), f"{W}x{H} {c} channels",
              bound=(_nbytes(tab.packed, img), out_b, 16 * out_b), timed=c == 3)

    def sweeps_run():
        """The last K2 call's sweep count, a device value: synchronise first."""
        _sync()
        return int(seg_min_propagate.last_rounds)

    def cc_bound(n_fields, n_px, sweeps, diag):
        """K2's bound: fields, mask and edges read once, fields written once;
        ~8 int32 operations per field value and sweep (hop, row and column
        run-min, flags), ~4 more with the hop."""
        return (n_px * (4 * n_fields + 1 + 1), 4 * n_fields * n_px,
                (12 if diag else 8) * n_fields * n_px * sweeps)

    # K2: the frame's filtered mask (4 fields, 8-connected), and a snake that
    # needs more sweeps than the JAX package's cap of 16: to the fixed point
    # (the default) and capped
    frame = sgm_eng.frame_program(left, right, plain=True)
    snake_t = torch.from_numpy(_snake(H, W, H // 8)).to(dev)
    for what, msk, cap in (("frame mask", frame["mask"] != 0, None),
                           ("snake", snake_t, None), ("snake", snake_t, CC_MAX_ROUNDS)):
        connected_components_bbox(msk, 8, max_rounds=cap)
        sweeps = sweeps_run()
        check(seg_min_propagate,
              lambda m=msk, c=cap: connected_components_bbox(m, 8, max_rounds=c),
              lambda m=msk, c=cap: connected_components_bbox(m, 8, max_rounds=c, plain=True),
              f"{what} ({sweeps} sweeps{', capped' if cap else ''})",
              bound=cc_bound(4, msk.numel(), sweeps, True), primary=cap is None)
    full = connected_components_bbox(snake_t, 8)[0]
    full_rounds = sweeps_run()
    capped = connected_components_bbox(snake_t, 8, max_rounds=CC_MAX_ROUNDS)[0]
    if sweeps_run() != CC_MAX_ROUNDS or bool((full == capped).all()):
        raise AssertionError("the round cap did not bind on the snake")
    print(f"phase 3 cc cap: snake stopped at {CC_MAX_ROUNDS} sweeps, its fixed "
          f"point takes {full_rounds}", flush=True)

    # K2's worst cases to the fixed point at 720p and 1080p: the snake, and
    # dense noise: the frame mask's four 8-connected fields on a mask of
    # density 0.5 (above the percolation threshold: long winding
    # components), and the speckle filter's 4-connected value edges on
    # random disparities (the JAX package's adversarial input)
    worst = {}
    for kh, kw in ((720, 1280), (1080, 1920)):
        g = np.random.default_rng(kh)
        noise_mask = torch.from_numpy(g.random((kh, kw)) < 0.5).to(dev)
        noise_disp = torch.from_numpy(
            g.integers(0, 128 * 16, (kh, kw)).astype(np.int16)).to(dev)
        cases = (("snake", torch.from_numpy(_snake(kh, kw, kh // 8)).to(dev), None),
                 ("noise mask", noise_mask, None),
                 ("noise disparity", noise_disp, noise_disp != -16))
        for what, x, act in cases:
            if act is None:
                run = lambda m=x, plain=False: connected_components_bbox(m, 8, plain=plain)
                fields, diag = 4, True
            else:
                run = lambda d=x, a=act, plain=False: connected_components_scan(
                    d, a, 512, plain=plain)
                fields, diag = 1, False
            run()
            sweeps = sweeps_run()
            check(seg_min_propagate, run, lambda r=run: r(plain=True),
                  f"{kw}x{kh} {what} ({sweeps} sweeps)", plain_reps=2, primary=False,
                  bound=cc_bound(fields, kh * kw, sweeps, diag))
            case = stats["seg_min_propagate"]["cases"][-1]
            worst[f"{kw}x{kh} {what}"] = dict(sweeps=sweeps, device_ms=case["device_ms"],
                                              ms_b2b=case["ms_b2b"])
        del noise_mask, noise_disp
    print(f"phase 3 cc to the fixed point: {json.dumps(worst)}", flush=True)

    # the stretch frame, rectified through its own engine's maps
    str_h, str_w, str_d = STRETCH
    str_st = _engine("sgm", str_w, str_h, d=str_d).state
    sl_np, sr_np, _, _ = _source(str_w, str_h).render(0)
    sleft = torch.from_numpy(sl_np).to(dev)
    sright = torch.from_numpy(sr_np).to(dev)
    slrect = remap_bilinear(rgb_to_gray(sleft), str_st.left, plain=True)
    srrect = remap_bilinear(rgb_to_gray(sright), str_st.right, plain=True)

    # K3 on the rectified frames (flagship, stretch) and on a crop of the
    # flagship's at the odd shape; the bidir kernels K12, K4, K12, K5 at the
    # flagship and odd shapes, the chained passes at the stretch and odd
    # shapes; K6 with the SGBM parameters; K7 and K10 on the SGM
    # disparity's value-edge components
    lrect, _, rrect = rectify_pair_plain(*planes, st.left, st.right)
    m = st.matcher
    p1, p2 = m.p1, max(m.p2, m.p1 + 1)
    ur = m.uniqueness_ratio

    def bidir_checks(C, what):
        """K12, K4, K12, K5 against their plain versions; K5's outputs."""
        C4 = C[:, None]
        es = C.element_size()
        # K12 turns the cost volume x-major for K4 and K4's sum back; the
        # library call is torch's own strided copy
        check(vol_transpose, lambda: vol_transpose(C4),
              lambda: vol_transpose_plain(C4), what + " cost volume",
              bound=(_nbytes(C), _nbytes(C), 0),
              library_fn=lambda: C4.transpose(0, 2).contiguous())
        Ct = sg.swap_pixel_axes(C)
        Sh_t = sgm_horiz(Ct, p1, p2)
        # the library counts the CUDA launches it makes
        count = ctypes.c_int.in_dll(_build.load("sgm_horiz"),
                                    "rtdm_sgm_horiz_kernel_launches")
        before = count.value
        sgm_horiz(Ct, p1, p2)
        if count.value - before != 1:
            raise AssertionError(f"sgm_horiz {what}: {count.value - before} CUDA "
                                 f"launches in one call, not 1")
        print(f"phase 3 sgm_horiz {what}: one CUDA launch a call", flush=True)
        # 8 operations per element and direction (min, shuffles, add) at
        # the volume's width
        check(sgm_horiz, lambda: sgm_horiz(Ct, p1, p2),
              lambda: sgm_horiz_plain(Ct, p1, p2), what,
              bound=(_nbytes(Ct), _nbytes(Sh_t), _lanes(2 * 8 * C.numel(), es)),
              plain_reps=2)
        S4 = Sh_t[:, None]
        check(vol_transpose, lambda: vol_transpose(S4),
              lambda: vol_transpose_plain(S4), what + " horizontal sum",
              bound=(_nbytes(Sh_t), _nbytes(Sh_t), 0),
              library_fn=lambda: S4.transpose(0, 2).contiguous())
        Sh = sg.swap_pixel_axes(Sh_t)
        del Ct, Sh_t, C4, S4
        outs = sgm_vert_wta(C, Sh, p1, p2, ur)
        check(sgm_vert_wta, lambda: sgm_vert_wta(C, Sh, p1, p2, ur),
              lambda: sgm_vert_wta_plain(C, Sh, p1, p2, ur), what,
              # six paths at the volume's width, the winner on int32 sums
              bound=(_nbytes(C, Sh), _nbytes(*outs),
                     _lanes(6 * 8 * C.numel(), es) + 8 * C.numel()),
              plain_reps=2)
        return outs

    def chained_checks(C, what):
        """K9a/K9b, K9c/K11 and K9d against their plain versions: the
        8-path route's calls timed, the other senses, partials, layouts and
        dtypes checked; the 8-path route's outputs (bounds: ~8 operations
        per element and path at the volume's width, ~8 more for K9d's
        winner)."""
        n, es = C.numel(), C.element_size()
        # K9a, the route's two calls: left to right, right to left + partial
        hf = sgm_horiz_pass(C, p1, p2)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(C, p1, p2),
              lambda: sgm_horiz_pass_plain(C, p1, p2), what + " L->R",
              bound=(_nbytes(C), _nbytes(hf), _lanes(8 * n, es)), plain_reps=2)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(C, p1, p2, True, hf),
              lambda: sgm_horiz_pass_plain(C, p1, p2, True, hf),
              what + " R->L + partial",
              bound=(_nbytes(C, hf), _nbytes(hf), _lanes(8 * n, es)), plain_reps=1,
              primary=False)
        Sh = sgm_horiz_pass(C, p1, p2, True, hf)
        # the int32 volume (partials_fit_int16 false)
        Ci, hfi = C.to(torch.int32), hf.to(torch.int32)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(Ci, p1, p2),
              lambda: sgm_horiz_pass_plain(Ci, p1, p2), what + " int32 L->R",
              timed=False)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(Ci, p1, p2, True, hfi),
              lambda: sgm_horiz_pass_plain(Ci, p1, p2, True, hfi),
              what + " int32 R->L + partial", timed=False)
        del Ci, hfi
        # K9b, the x-major (W1, H, D) form: the second call of its chain
        # timed
        Ct = C.transpose(0, 1).contiguous()
        hft = hf.transpose(0, 1).contiguous()
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(Ct, p1, p2, False, None, True),
              lambda: sgm_horiz_pass_plain(Ct, p1, p2, False, None, True),
              what + " x-major L->R", timed=False)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(Ct, p1, p2, True, hft, True),
              lambda: sgm_horiz_pass_plain(Ct, p1, p2, True, hft, True),
              what + " x-major R->L + partial (K9b form)",
              bound=(_nbytes(Ct, hft), _nbytes(hft), _lanes(8 * n, es)), plain_reps=1)
        # the same bytes moved by an elementwise add (C and the partial read
        # once, one output written): the rate the card's memory gives such a
        # stream; a single call can end with up to the L2's 50 MB of its
        # output not yet written back, which 20 calls back to back include
        acc = torch.empty_like(hft)
        k9b = lambda: sgm_horiz_pass(Ct, p1, p2, True, hft, True)  # noqa: E731
        add = lambda: torch.add(Ct, hft, out=acc)  # noqa: E731
        k9b_ms, k9b_b2b, add_ms, add_b2b = (_time_ms(k9b), _b2b_ms(k9b),
                                            _time_ms(add), _b2b_ms(add))
        moved = _nbytes(Ct, hft, acc)
        print(f"phase 3 sgm_horiz_pass {what} x-major R->L + partial: "
              f"{moved / 1e9:.4f} GB moved (bound {moved / PEAK_BYTES * 1e3:.4f} ms); "
              f"the kernel {k9b_ms:.4f} ms, {k9b_b2b:.4f} ms back to back; "
              f"torch.add of the same bytes {add_ms:.4f} ms, {add_b2b:.4f} ms back "
              f"to back ({moved / add_b2b / 1e9:.3f} TB/s)", flush=True)
        del Ct, hft, acc
        # K9c, the route's call (top-down + partial); K11's other sense and
        # its int32 contract
        Sa = sgm_vert_pass(C, p1, p2, partial=Sh)
        check(sgm_vert_pass, lambda: sgm_vert_pass(C, p1, p2, partial=Sh),
              lambda: sgm_vert_pass_plain(C, p1, p2, partial=Sh),
              what + " top-down + partial",
              bound=(_nbytes(C, Sh), _nbytes(Sa), _lanes(3 * 8 * n, es)), plain_reps=1)
        check(sgm_vert_pass, lambda: sgm_vert_pass(C, p1, p2, True),
              lambda: sgm_vert_pass_plain(C, p1, p2, True),
              what + " bottom-up", timed=False)
        Ci, Shi = C.to(torch.int32), Sh.to(torch.int32)
        check(sgm_vert_pass, lambda: sgm_vert_pass(Ci, p1, p2),
              lambda: sgm_vert_pass_plain(Ci, p1, p2), what + " int32 top-down",
              timed=False)
        check(sgm_vert_pass, lambda: sgm_vert_pass(Ci, p1, p2, True, Shi),
              lambda: sgm_vert_pass_plain(Ci, p1, p2, True, Shi),
              what + " int32 bottom-up + partial (K11 form)",
              bound=(_nbytes(Ci, Shi), _nbytes(Shi), _lanes(3 * 8 * n, Ci.element_size())),
              plain_reps=1)
        del Ci, Shi
        # K9d: the 8-path finish (bottom-up on the 5-direction partial), and
        # the 5-path one (top-down on the horizontal sum)
        outs = sgm_final_wta(C, Sa, p1, p2, ur, True)
        check(sgm_final_wta, lambda: sgm_final_wta(C, Sa, p1, p2, ur, True),
              lambda: sgm_final_wta_plain(C, Sa, p1, p2, ur, True),
              what + " bottom-up",
              bound=(_nbytes(C, Sa), _nbytes(*outs), _lanes(4 * 8 * n, es)),
              plain_reps=1)
        check(sgm_final_wta, lambda: sgm_final_wta(C, Sh, p1, p2, ur, False),
              lambda: sgm_final_wta_plain(C, Sh, p1, p2, ur, False),
              what + " top-down", timed=False)
        return outs

    def chained_flagship(C, what):
        """K9c and K9d at the flagship shape (cv2 MODE_SGBM's K9d call is
        top-down on the horizontal sum), timed beside the stretch point's
        cases, which the summary reports."""
        n, es = C.numel(), C.element_size()
        # K9a, MODE_SGBM's two calls
        hf = sgm_horiz_pass(C, p1, p2)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(C, p1, p2),
              lambda: sgm_horiz_pass_plain(C, p1, p2), what + " L->R",
              bound=(_nbytes(C), _nbytes(hf), _lanes(8 * n, es)), plain_reps=1,
              primary=False)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(C, p1, p2, True, hf),
              lambda: sgm_horiz_pass_plain(C, p1, p2, True, hf),
              what + " R->L + partial",
              bound=(_nbytes(C, hf), _nbytes(hf), _lanes(8 * n, es)), plain_reps=1,
              primary=False)
        h2 = sgm_horiz_pass(C, p1, p2, True, hf)
        del hf
        Sa = sgm_vert_pass(C, p1, p2, partial=h2)
        check(sgm_vert_pass, lambda: sgm_vert_pass(C, p1, p2, partial=h2),
              lambda: sgm_vert_pass_plain(C, p1, p2, partial=h2),
              what + " top-down + partial",
              bound=(_nbytes(C, h2), _nbytes(Sa), _lanes(3 * 8 * n, es)), plain_reps=1,
              primary=False)
        for rev, case in ((True, " bottom-up"), (False, " top-down (MODE_SGBM)")):
            part = Sa if rev else h2
            outs = sgm_final_wta(C, part, p1, p2, ur, rev)
            check(sgm_final_wta, lambda: sgm_final_wta(C, part, p1, p2, ur, rev),
                  lambda: sgm_final_wta_plain(C, part, p1, p2, ur, rev),
                  what + case,
                  bound=(_nbytes(C, part), _nbytes(*outs), _lanes(4 * 8 * n, es)),
                  plain_reps=1, primary=False)

    def count_checks(labels, act, max_size, what, timed=True):
        """K7's speckle entry (count + decision), then K7 and K10 (the
        count), against their plain versions and torch.bincount. Bound:
        labels (4 B) and the active bytes (1 B) read once, the int32
        field or counts (4 B) written once; ~8 int32 operations a pixel.
        Returns the counts."""
        n = labels.numel()
        lib = (lambda lab=labels, a=act: torch.bincount(lab[a], minlength=n))
        fld = speckle_decision(labels, act, max_size)
        check(speckle_decision, lambda: speckle_decision(labels, act, max_size),
              lambda: speckle_decision_plain(labels, act, max_size), what,
              bound=(_nbytes(labels, act), _nbytes(fld), 8 * n), timed=timed,
              primary=timed)
        cnt = label_histogram(labels, act)
        hb = (_nbytes(labels, act), _nbytes(cnt), 8 * n)
        check(label_histogram_banded,
              lambda: label_histogram_banded(labels, act, max_size),
              lambda: label_histogram_plain(labels, act), what, bound=hb,
              library_fn=lib, timed=timed, primary=timed)
        check(label_histogram, lambda: label_histogram(labels, act),
              lambda: label_histogram_plain(labels, act), what, bound=hb,
              library_fn=lib, timed=timed, primary=timed)
        if not torch.equal(lib().reshape(labels.shape).to(torch.int32), cnt):
            raise AssertionError(f"{what}: label_histogram != torch.bincount")
        return cnt

    flagship = (H, W, D)
    for (h, w, d) in (flagship, STRETCH, ODD):
        if (h, w, d) == STRETCH:
            lr, rr = slrect, srrect
        else:
            lr, rr = lrect[:h, :w].contiguous(), rrect[:h, :w].contiguous()
        dtype = sg.volume_dtype(BS, m.pre_filter_cap)
        lpl, rpl = sg.plane_stack(lr, m.pre_filter_cap), sg.plane_stack(rr, m.pre_filter_cap)
        what = f"{h}x{w} D={d}"
        C = sgm_cost_volume(lpl, rpl, d, BS, dtype)[0]
        n = C.numel()
        # ~21 operations per volume element at its width: two BT costs, the
        # quarter weighting, and the separable sliding window sums
        check(sgm_cost_volume, lambda: sgm_cost_volume(lpl, rpl, d, BS, dtype)[0],
              lambda: sgm_cost_volume_plain(lpl, rpl, d, BS, dtype)[0], what,
              bound=(_nbytes(lpl, rpl), _nbytes(C), _lanes(21 * n, C.element_size())),
              plain_reps=5)
        if (h, w, d) != STRETCH:
            # the int32 volume: bs 11 needs it even at pre_filter_cap 0
            dt11 = sg.volume_dtype(11, m.pre_filter_cap)
            if dt11 != torch.int32:
                raise AssertionError(f"volume_dtype(11, {m.pre_filter_cap}) is {dt11}")
            check(sgm_cost_volume, lambda: sgm_cost_volume(lpl, rpl, d, 11, dt11)[0],
                  lambda: sgm_cost_volume_plain(lpl, rpl, d, 11, dt11)[0],
                  what + " bs=11 int32", timed=False)
        if (h, w, d) != STRETCH:
            outs = bidir_checks(C, what)
            # K5 where the last band of columns is ragged
            W1 = w - d
            plan = k5_plan(W1, d, C.element_size(), dev)
            cols = plan.warps * plan.m
            W1r = W1 - 1 if W1 % cols == 0 else W1
            Cr, Shr = C[:, :W1r].contiguous(), torch.zeros_like(C[:, :W1r], dtype=torch.int32)
            check(sgm_vert_wta, lambda: sgm_vert_wta(Cr, Shr, p1, p2, ur),
                  lambda: sgm_vert_wta_plain(Cr, Shr, p1, p2, ur),
                  f"{h}x{W1r + d} D={d} (W1 {W1r}: bands of {cols}, the last "
                  f"of {W1r - (W1r - 1) // cols * cols})", timed=False)
            del Cr, Shr
        if (h, w, d) == flagship:
            chained_flagship(C, what)
        else:
            outs_c = chained_checks(C, what)
            if (h, w, d) == ODD and _max_abs_err(outs_c, outs) != 0:
                raise AssertionError(f"{what}: the chained route's winners differ "
                                     f"from the bidir route's")
            outs = outs_c
        if (h, w, d) != ODD:
            # both 8-path routes on the flagship and stretch volumes (the
            # port's kernels take any H; the route gate follows the
            # reference's)
            bid_ms = _time_ms(lambda: sg.aggregate_bidir(C, p1, p2, ur), reps=5)
            chn_ms = _time_ms(lambda: sg.aggregate_chained(C, 8, p1, p2, ur), reps=5)
            if _max_abs_err(sg.aggregate_bidir(C, p1, p2, ur),
                            sg.aggregate_chained(C, 8, p1, p2, ur)) != 0:
                raise AssertionError(f"{what}: the bidir and chained routes differ")
            print(f"phase 3 routes {what}: the same winners; bidir (K12, K4, K12, "
                  f"K5) {bid_ms:.4f} ms, chained (K9a, K9a, K9c, K9d) {chn_ms:.4f} ms",
                  flush=True)
        best, minS, dval, uniq = outs
        del outs
        disp = torch.full((h, w), -16, dtype=torch.int16, device=dev)
        disp[:, d:] = torch.where(uniq != 0, -16, dval).to(torch.int16)
        if (h, w, d) != ODD:
            # K6's general entry on the int32 planes the plain check builds,
            # then its SGBM entry, the frame programs' call: the matcher's
            # outputs in (the int16 disparity, best and minS, each read
            # once), the checked int16 disparity out; ~24 int32 operations
            # a pixel
            d_intW, keyW, rms, kw = lr_key_planes_sgbm(disp, best, minS, d, w - d, d)
            outs6 = lr_resolve(d_intW, keyW, rms, **kw)
            check(lr_resolve, lambda: lr_resolve(d_intW, keyW, rms, **kw),
                  lambda: lr_resolve_plain(d_intW, keyW, rms, **kw),
                  f"SGBM planes {what}",
                  bound=(_nbytes(d_intW, keyW, *rms), _nbytes(*outs6), 6 * h * w))
            del d_intW, keyW, rms, outs6
            md = m.disp12_max_diff
            checked = lr_resolve_sgbm(disp, best, minS, d, w - d, d, md)
            check(lr_resolve_sgbm, lambda: lr_resolve_sgbm(disp, best, minS, d, w - d, d, md),
                  lambda: lr_resolve_sgbm_plain(disp, best, minS, d, w - d, d, md), what,
                  bound=(_nbytes(disp, best, minS), _nbytes(checked), 24 * h * w))
            if torch.equal(checked, disp):
                raise AssertionError(f"SGBM LR check {what}: no pixel invalidated")
            disp = checked
        act = disp != -16
        # K2's two speckle calls (1 field, 4-connected value edges): the
        # labels, then each root's small/big decision broadcast
        edges = value_edges(disp, act, m.speckle_range * 16)
        connected_components_scan(disp, act, m.speckle_range * 16, edges=edges)
        sweeps = sweeps_run()
        check(seg_min_propagate,
              lambda: connected_components_scan(disp, act, m.speckle_range * 16,
                                                edges=edges),
              lambda: connected_components_scan(disp, act, m.speckle_range * 16,
                                                plain=True, edges=edges),
              f"{what} speckle labels ({sweeps} sweeps)",
              bound=cc_bound(1, h * w, sweeps, False), plain_reps=5)
        labels = connected_components_scan(disp, act, m.speckle_range * 16)
        small = component_small(labels, act, edges, m.speckle_window_size)
        sweeps = sweeps_run()
        check(seg_min_propagate,
              lambda: component_small(labels, act, edges, m.speckle_window_size),
              lambda: component_small(labels, act, edges, m.speckle_window_size,
                                      plain=True),
              f"{what} speckle decision broadcast ({sweeps} sweeps, "
              f"{int(small.sum())} small pixels)", timed=False)
        count_checks(labels, act, m.speckle_window_size, what + " speckle labels")
        # the filter's last step on the broadcast decisions
        fld = component_small_field(labels, act, edges, m.speckle_window_size)
        applied = speckle_apply(disp, fld, -16)
        check(speckle_apply, lambda: speckle_apply(disp, fld, -16),
              lambda: speckle_apply_plain(disp, fld, -16), what,
              bound=(_nbytes(disp, fld), _nbytes(applied), 4 * h * w))
        cnt = label_histogram(labels, act)
        print(f"phase 3 SGM {what}: {float(act.float().mean()):.3f} of pixels "
              f"valid after the LR check, {int((cnt > 0).sum())} components",
              flush=True)
        del C, best, minS, dval, uniq
        torch.cuda.empty_cache()

    # K12 in the TPU's own 3-D form, (A, D, B) -> (B, D, A), at the shape of
    # its TPU call (one element per unit: the shared-memory tile variant)
    xt = torch.randint(-3000, 3000, (1152, 128, 768), dtype=torch.int16, device=dev)
    check(vol_transpose, lambda: vol_transpose(xt), lambda: vol_transpose_plain(xt),
          "TPU form (1152, 128, 768) int16", bound=(_nbytes(xt), _nbytes(xt), 0))
    del xt

    # the exact width tiling's kernels: K3's output column window and the
    # wavefront's scans at the 720p frame's tile shape of 2 ranks
    _tiling_kernels(check, lrect, rrect, m)

    # the vertical kernel off the frame programs' shapes: D = 100 (pixels
    # that are not whole 16-byte pieces: the register path) on the odd
    # crop, and a volume wider than 16 one-column warps on each SM (H = 48,
    # W1 = 3712 at D = 64, and 3840x2160's W1 = 3712 at D = 128 on 16 rows)
    rng = np.random.default_rng(7)
    oh, ow, _ = ODD
    lr_o, rr_o = lrect[:oh, :ow].contiguous(), rrect[:oh, :ow].contiguous()
    vols = [("700x1000 D=100", sgm_cost_volume(sg.plane_stack(lr_o, m.pre_filter_cap),
                                               sg.plane_stack(rr_o, m.pre_filter_cap),
                                               100, BS, torch.int16)[0])]
    for vh, vw1, vd in ((48, 3712, 64), (16, 3712, 128)):
        vols.append((f"{vh}x{vw1} D={vd} (random)", torch.from_numpy(
            rng.integers(0, 2300, (vh, vw1, vd))).to(torch.int16).to(dev)))
    for what, Cv in vols:
        vw1, vd = Cv.shape[1:]
        h2 = sgm_horiz_pass(Cv, p1, p2, True, sgm_horiz_pass(Cv, p1, p2))
        for rev in (False, True):
            sense = "bottom-up" if rev else "top-down"
            check(sgm_vert_pass, lambda r=rev: sgm_vert_pass(Cv, p1, p2, r, h2),
                  lambda r=rev: sgm_vert_pass_plain(Cv, p1, p2, r, h2),
                  f"{what} {sense} + partial", timed=False)
            check(sgm_final_wta, lambda r=rev: sgm_final_wta(Cv, h2, p1, p2, ur, r),
                  lambda r=rev: sgm_final_wta_plain(Cv, h2, p1, p2, ur, r),
                  f"{what} {sense}", timed=False)
        Shv = h2.to(torch.int32)
        check(sgm_vert_wta, lambda: sgm_vert_wta(Cv, Shv, p1, p2, ur),
              lambda: sgm_vert_wta_plain(Cv, Shv, p1, p2, ur), what, timed=False)
        print(f"phase 3 vertical plans {what}: K5 {k5_plan(vw1, vd, 2, dev)}, K9c "
              f"{chained_plan(vw1, vd, 2, False, dev)}, K9d "
              f"{chained_plan(vw1, vd, 2, True, dev)}", flush=True)
        # each wrapper's CUDA launches of the vertical kernel, from the
        # library's own count: one for K9c and K9d, two for K5
        for lib_name, call, want in (
                ("sgm_hdw", lambda: sgm_vert_pass(Cv, p1, p2, False, h2), 1),
                ("sgm_hdw", lambda: sgm_final_wta(Cv, h2, p1, p2, ur, True), 1),
                ("sgm_vert_wta", lambda: sgm_vert_wta(Cv, Shv, p1, p2, ur), 2)):
            count = ctypes.c_int.in_dll(_build.load(lib_name),
                                        "rtdm_sgm_vert_kernel_launches")
            before = count.value
            call()
            if count.value - before != want:
                raise AssertionError(f"{what}: {count.value - before} CUDA launches "
                                     f"of the vertical kernel in a call, not {want}")
        print(f"phase 3 vertical kernel {what}: K9c 1, K9d 1, K5 2 CUDA launches "
              f"a call", flush=True)
        del Cv, h2, Shv
    del vols

    # the batched entries of the batch programs at 720p, B = BATCH
    _batch_kernels(check, st, m)

    # K9a/K9b off the frame programs' shapes: the register path (D = 100 at
    # int16: pixels that are not whole 16-byte pieces) on the odd crop's
    # volume, a view that does not start on 16 bytes (the wrapper aligns
    # it), and rows shorter than the ring and odd (W1 = 1, 3, 37) at D = 64
    # and 256, int16 and int32; both senses, with and without a partial,
    # row-major and x-major; each call one CUDA launch (the library's count)
    count = ctypes.c_int.in_dll(_build.load("sgm_hdw"),
                                "rtdm_sgm_horiz_pass_kernel_launches")
    flat = torch.from_numpy(rng.integers(0, 2300, 45 * 236 * 64 + 1)).to(
        torch.int16).to(dev)
    hp_vols = [("700x1000 D=100 (register path)", sgm_cost_volume(
        sg.plane_stack(lr_o, m.pre_filter_cap), sg.plane_stack(rr_o, m.pre_filter_cap),
        100, BS, torch.int16)[0]),
        ("45x300 D=64 view at +2 bytes", flat[1:].view(45, 236, 64))]
    for hw1 in (1, 3, 37):
        for hd in (64, 256):
            for hdt in (torch.int16, torch.int32):
                hp_vols.append((f"9x{hw1 + hd} D={hd} {str(hdt)[6:]}", torch.from_numpy(
                    rng.integers(0, 2300, (9, hw1, hd))).to(hdt).to(dev)))
    for what, Cv in hp_vols:
        for xm in (False, True):
            Cx = Cv.transpose(0, 1).contiguous() if xm else Cv
            hfv = sgm_horiz_pass_plain(Cx, p1, p2, False, None, xm)
            for rev, part in ((False, None), (True, None), (False, hfv), (True, hfv)):
                before = count.value
                sgm_horiz_pass(Cx, p1, p2, rev, part, xm)
                if count.value - before != 1:
                    raise AssertionError(f"sgm_horiz_pass {what}: {count.value - before} "
                                         f"CUDA launches in one call, not 1")
                check(sgm_horiz_pass,
                      lambda c=Cx, r=rev, q=part, x=xm: sgm_horiz_pass(c, p1, p2, r, q, x),
                      lambda c=Cx, r=rev, q=part, x=xm: sgm_horiz_pass_plain(
                          c, p1, p2, r, q, x),
                      f"{what}{' x-major' if xm else ''} "
                      f"{'R->L' if rev else 'L->R'}{' + partial' if part is not None else ''}",
                      timed=False)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {f"{hh} rows D={hd} partial={q}": tuple(horiz_pass_plan(hd, 2, q, hh, sms))
             for hh, hd in ((H, D), STRETCH[::2]) for q in (False, True)}
    print(f"phase 3 sgm_horiz_pass: {len(hp_vols)} off-path volumes exact, one CUDA "
          f"launch a call; int16 plans (ring, rows, smem, ring path) {plans}",
          flush=True)
    del hp_vols, flat

    # K2 where a row (W > 2880) or a column (H > 1427) does not fit a block:
    # chunked phases, capped and at the fixed point
    for kh, kw in ((64, 2881), (1428, 96)):
        blobs = np.zeros((kh, kw), bool)
        for _ in range(40):
            y, x = rng.integers(0, kh), rng.integers(0, kw)
            blobs[y: y + rng.integers(2, kh // 2 + 3), x: x + rng.integers(2, kw // 3 + 3)] = True
        blobs |= rng.random((kh, kw)) < 0.02
        bm_t = torch.from_numpy(blobs).to(dev)
        for rounds in (CC_MAX_ROUNDS, None):
            check(seg_min_propagate,
                  lambda b=bm_t, r=rounds: connected_components_bbox(b, 8, max_rounds=r),
                  lambda b=bm_t, r=rounds: connected_components_bbox(b, 8, max_rounds=r,
                                                                     plain=True),
                  f"{kh}x{kw} blobs (chunked, cap {rounds})", timed=False)

    # -- 3840x2160 D=128: the frame program, both 8-path routes on one
    # volume, detect and the speckle filter against their plain versions --
    uh, uw = 2160, 3840
    u_eng = _engine("sgm", uw, uh)
    ul_np, ur_np, _, _ = _source(uw, uh).render(0)
    uleft = torch.from_numpy(ul_np).to(dev)
    uright = torch.from_numpy(ur_np).to(dev)
    ures = u_eng.frame_program(uleft, uright)
    _sync()
    u_ms = _wall_ms(lambda: u_eng.frame_program(uleft, uright), reps=3)
    boxes = detect_objects(ures["mask"], u_eng.state.min_object_size, u_eng.cfg.max_objects)
    if not torch.equal(boxes, detect_objects(ures["mask"], u_eng.state.min_object_size,
                                             u_eng.cfg.max_objects, plain=True)):
        raise AssertionError("detect_objects at 3840x2160 != its plain version")
    print(f"phase 3 {uw}x{uh} D={D}: frame program {u_ms:.3f} ms (bidir route); "
          f"detect_objects equals its plain version ({int(boxes[:, 4].sum())} "
          f"boxes)", flush=True)
    ust = u_eng.state
    ulr = remap_bilinear(rgb_to_gray(uleft), ust.left, plain=True)
    urr = remap_bilinear(rgb_to_gray(uright), ust.right, plain=True)
    del ures, uleft, uright
    Cu = sgm_cost_volume(sg.plane_stack(ulr, m.pre_filter_cap),
                         sg.plane_stack(urr, m.pre_filter_cap), D, BS,
                         sg.volume_dtype(BS, m.pre_filter_cap))[0]
    bid_ms = _time_ms(lambda: sg.aggregate_bidir(Cu, p1, p2, ur), reps=3, warm=1)
    chn_ms = _time_ms(lambda: sg.aggregate_chained(Cu, 8, p1, p2, ur), reps=3, warm=1)
    outs_u = sg.aggregate_bidir(Cu, p1, p2, ur)
    if _max_abs_err(outs_u, sg.aggregate_chained(Cu, 8, p1, p2, ur)) != 0:
        raise AssertionError(f"{uw}x{uh} D={D}: the bidir and chained routes differ")
    print(f"phase 3 routes {uw}x{uh} D={D} (W1 {uw - D}): the same winners; bidir "
          f"(K12, K4, K12, K5) {bid_ms:.4f} ms, chained (K9a, K9a, K9c, K9d) "
          f"{chn_ms:.4f} ms", flush=True)
    del Cu
    udisp = torch.full((uh, uw), -16, dtype=torch.int16, device=dev)
    udisp[:, D:] = torch.where(outs_u[3] != 0, -16, outs_u[2]).to(torch.int16)
    del outs_u
    got = filter_speckles(udisp, -16, m.speckle_window_size, m.speckle_range * 16)
    if not torch.equal(got, filter_speckles(udisp, -16, m.speckle_window_size,
                                            m.speckle_range * 16, plain=True)):
        raise AssertionError("the speckle filter at 3840x2160 != its plain version")
    print(f"phase 3 speckle {uw}x{uh}: equals its plain version "
          f"({int((got != -16).sum())} of {int((udisp != -16).sum())} pixels kept)",
          flush=True)
    del u_eng, udisp, got
    torch.cuda.empty_cache()

    # the speckle path under the cap: a snake disparity whose value-edge
    # propagation needs more than 16 sweeps
    sdisp = torch.where(snake_t, 32, -16).to(torch.int16)
    sact = sdisp != -16
    if torch.equal(connected_components_scan(sdisp, sact, 512, max_rounds=CC_MAX_ROUNDS),
                   connected_components_scan(sdisp, sact, 512)):
        raise AssertionError("the round cap did not bind on the speckle snake")
    for size in (100, H * W):
        got = filter_speckles(sdisp, -16, size, 512)
        ref = filter_speckles(sdisp, -16, size, 512, plain=True)
        if not torch.equal(got, ref):
            raise AssertionError(f"speckle snake, max_size {size}: kernels != plain")
        print(f"phase 3 speckle snake max_size {size}: exact at the fixed point, "
              f"{int((got != -16).sum())} of {int(sact.sum())} pixels kept",
              flush=True)

    # K7's counts where they are hardest, at 1280x720: a constant-disparity
    # frame (one component: every warp's run lands on one root), a
    # checkerboard of one-pixel components (every pixel a root: the tile's
    # table overflows) and the cap-bound snake (the capped K2's labels);
    # then the whole speckle filter on each against its plain version
    checker = torch.from_numpy(np.indices((H, W)).sum(0) % 2 == 0).to(dev)
    for what, adisp in (
            ("constant disparity", torch.full((H, W), 48, dtype=torch.int16, device=dev)),
            ("checkerboard of one-pixel components",
             torch.where(checker, 16, 16 + 32 * m.speckle_range).to(torch.int16)),
            ("cap-bound snake", sdisp)):
        aact = adisp != -16
        alab = connected_components_scan(adisp, aact, m.speckle_range * 16)
        cnt = count_checks(alab, aact, m.speckle_window_size, f"{W}x{H} {what}")
        got = filter_speckles(adisp, -16, m.speckle_window_size, m.speckle_range * 16)
        if not torch.equal(got, filter_speckles(adisp, -16, m.speckle_window_size,
                                                m.speckle_range * 16, plain=True)):
            raise AssertionError(f"speckle filter, {what}: kernels != plain")
        print(f"phase 3 counts {what}: {int((cnt > 0).sum())} roots; the speckle "
              f"filter equals its plain version ({int((got != -16).sum())} of "
              f"{int(aact.sum())} pixels kept)", flush=True)
    del checker, adisp, aact, alab

    # K8 on the rectified, prefiltered frame; K6 on K8's output (BM point)
    bm_cfg = _config("bm", W, H).matcher
    lp = xsobel_prefilter(lrect, bm_cfg.pre_filter_cap)
    rp = xsobel_prefilter(rrect, bm_cfg.pre_filter_cap)
    bm_out = bm_cost_wta(lp, rp, BM_D, BM_BS)
    slp = xsobel_prefilter(slrect, bm_cfg.pre_filter_cap)
    srp = xsobel_prefilter(srrect, bm_cfg.pre_filter_cap)
    # per pixel and d: |L - R| (a byte), the vertical window update (a
    # 16-bit add and subtract), the horizontal one (the same, 32-bit where a
    # window cost passes 16 bits) and the min (32-bit); five (H, W) int32
    # outputs; 720p at D=128 (the BM path's call, primary) and at the
    # reference's default D=192, 1920x1080 at D=256, 288 (the default BM
    # matcher on that camera: phase 9) and 384 (12 d a lane, a 9-bit key),
    # then checked only: D=100 (lanes of 4 d, the last ones idle) and a
    # ragged crop
    for a, b, d, bs, what, timed in (
            (lp, rp, BM_D, BM_BS, f"D={BM_D} bs={BM_BS}", True),
            (lp, rp, 192, BM_BS, f"D=192 bs={BM_BS}", True),
            (slp, srp, str_d, BM_BS, f"{str_w}x{str_h} D={str_d} bs={BM_BS}", True),
            (slp, srp, 288, BM_BS, f"{str_w}x{str_h} D=288 bs={BM_BS}", True),
            (slp, srp, 384, BM_BS, f"{str_w}x{str_h} D=384 bs={BM_BS}", True),
            (lp, rp, 100, 5, "D=100 bs=5", False),
            (lp[3:300, 5:1006].contiguous(), rp[3:300, 5:1006].contiguous(),
             BM_D, 21, "297x1001 D=128 bs=21", False)):
        check(bm_cost_wta, lambda a=a, b=b, d=d, bs=bs: bm_cost_wta(a, b, d, bs),
              lambda a=a, b=b, d=d, bs=bs: bm_cost_wta_plain(a, b, d, bs), what,
              bound=(_nbytes(a, b), 5 * 4 * a.numel(), a.numel() * d * (
                  _lanes(1, 1) + _lanes(2, 2) + 1
                  + _lanes(2, 2 if bs * bs * 255 < 2**16 else 4))),
              plain_reps=5, timed=timed)
    bdisp = bm_ops.stereo_bm(lrect, rrect, bm_cfg.replace(
        disp12_max_diff=-1, speckle_window_size=0), plain=True)
    _, _, d_int, key = lr_key_planes_bm(bdisp, bm_out[1])
    kw = lr_bm_kwargs(BM_D)
    outs6 = lr_resolve(d_int, key, (d_int,), **kw)
    check(lr_resolve, lambda: lr_resolve(d_int, key, (d_int,), **kw),
          lambda: lr_resolve_plain(d_int, key, (d_int,), **kw), "BM planes",
          bound=(_nbytes(d_int, key), _nbytes(*outs6), 6 * H * W))
    # K6's BM entry, the frame programs' call, at 720p D=128 and on the
    # 1920x1080 frame at D=288 (the default BM matcher there): the int16
    # disparity and the winner's cost read once, the int16 result written
    # once; ~16 int32 operations a pixel
    md = bm_cfg.disp12_max_diff
    bdisp288 = bm_ops.stereo_bm(slrect, srrect, bm_cfg.replace(
        num_disparities=288, disp12_max_diff=-1, speckle_window_size=0))
    for bd, cost, bdd, what in (
            (bdisp, bm_out[1], BM_D, f"{W}x{H} D={BM_D}"),
            (bdisp288, bm_cost_wta(slp, srp, 288, BM_BS)[1], 288,
             f"{str_w}x{str_h} D=288")):
        checked = lr_resolve_bm(bd, cost, bdd, md)
        check(lr_resolve_bm, lambda bd=bd, c=cost, d=bdd: lr_resolve_bm(bd, c, d, md),
              lambda bd=bd, c=cost, d=bdd: lr_resolve_bm_plain(bd, c, d, md), what,
              bound=(_nbytes(bd, cost), _nbytes(checked), 16 * bd.numel()))
        if torch.equal(checked, bd):
            raise AssertionError(f"BM LR check {what}: no pixel invalidated")
    del bdisp288
    print(f"phase 3 bm: {int((bdisp != -16).sum())} valid pixels before the LR "
          f"check", flush=True)

    # the BM matcher on the card (K8 + K6, ragged tiles; then with the
    # speckle filter, on a crop holding the 50 px object) against the repo's
    # numpy golden (cv2.StereoBM parity) on 96x300 crops at D=64
    small = bm_cfg.replace(num_disparities=64)
    for (y0, x0), sws in (((H // 4, W // 8), 0),
                          ((H // 4, W * 900 // 1280), small.speckle_window_size)):
        gl = lrect[y0: y0 + 96, x0: x0 + 300].contiguous()
        gr = rrect[y0: y0 + 96, x0: x0 + 300].contiguous()
        ref = golden_stereo_bm(gl.cpu().numpy(), gr.cpu().numpy(), 64, BM_BS,
                               speckle_window_size=sws,
                               speckle_range=small.speckle_range)
        got = bm_ops.stereo_bm(gl, gr, small.replace(speckle_window_size=sws))
        if not np.array_equal(got.cpu().numpy(), ref) or (ref == -16).all():
            raise AssertionError(f"stereo_bm on the card != the numpy golden "
                                 f"(speckle window {sws})")
        print(f"phase 3 stereo_bm 96x300 D=64 speckle window {sws}: equals the "
              f"numpy golden ({int((ref != -16).sum())} valid pixels)", flush=True)

    # the SGM matcher on the card against the repo's numpy golden
    # (cv2.StereoSGBM parity) with the default checks (uniqueness, LR,
    # speckle), on crops of the rectified frame at D=64 holding the 50 px
    # object: one per route (W - D = 232, a multiple of 8)
    sgm64 = m.replace(num_disparities=64)
    y0, x0 = H // 4, W * 900 // 1280
    for mode, paths, h in (("sgbm", 5, 96), ("sgbm4", 4, 96), ("hh", 8, 104),
                           ("hh", 8, 96)):
        gl = lrect[y0: y0 + h, x0: x0 + 296].contiguous()
        gr = rrect[y0: y0 + h, x0: x0 + 296].contiguous()
        ref = golden_stereo_sgbm(gl.cpu().numpy(), gr.cpu().numpy(), 64, BS,
                                 pre_filter_cap=sgm64.pre_filter_cap, mode=mode)
        cfg = sgm64.replace(num_paths=paths)
        got = sg.stereo_sgbm(gl, gr, cfg)
        if not np.array_equal(got.cpu().numpy(), ref) or (ref == -16).all():
            raise AssertionError(f"stereo_sgbm {mode} {h}x296 on the card != the "
                                 f"numpy golden")
        route = "bidir" if sg.uses_bidir(paths, h, 296, 64) else "chained"
        print(f"phase 3 stereo_sgbm {mode} ({paths} paths, {route} route) {h}x296 "
              f"D=64: equals the numpy golden ({int((ref != -16).sum())} valid "
              f"pixels)", flush=True)

    # -- min_disparity != 0, and the WLS smoother ----------------------------
    # K3 at the WLS right matcher's -127 (the views swapped, as the right
    # matcher takes them) and at +16, 720p D=128
    dtype = sg.volume_dtype(BS, m.pre_filter_cap)
    lpl_f = sg.plane_stack(lrect, m.pre_filter_cap)
    rpl_f = sg.plane_stack(rrect, m.pre_filter_cap)
    for md, (a, b), role in ((-127, (rpl_f, lpl_f), "right matcher"),
                             (16, (lpl_f, rpl_f), "left view")):
        C = sgm_cost_volume(a, b, D, BS, dtype, md)[0]
        check(sgm_cost_volume,
              lambda a=a, b=b, md=md: sgm_cost_volume(a, b, D, BS, dtype, md)[0],
              lambda a=a, b=b, md=md: sgm_cost_volume_plain(a, b, D, BS, dtype, md)[0],
              f"{H}x{W} D={D} minD={md} ({role}, W1 {C.shape[1]})",
              bound=(_nbytes(a, b), _nbytes(C), _lanes(21 * C.numel(), C.element_size())),
              plain_reps=3, primary=False)
        del C
    del lpl_f, rpl_f
    # K6's SGBM entry at +16 and -8 on the bidir route's own outputs there
    md12 = m.disp12_max_diff
    for md in (16, -8):
        C, minX1, W1 = sg.sgbm_cost_volume(lrect, rrect, D, BS, m.pre_filter_cap,
                                           min_disp=md)
        best, minS, dval, uniq = sg.aggregate_bidir(C, p1, p2, ur)
        del C
        inv = (md - 1) * 16
        mdisp = torch.full((H, W), inv, dtype=torch.int16, device=dev)
        mdisp[:, minX1: minX1 + W1] = torch.where(uniq != 0, inv,
                                                  dval + md * 16).to(torch.int16)
        args = (mdisp, best, minS, minX1, W1, D, md12, md)
        checked = lr_resolve_sgbm(*args)
        check(lr_resolve_sgbm, lambda a=args: lr_resolve_sgbm(*a),
              lambda a=args: lr_resolve_sgbm_plain(*a), f"{W}x{H} D={D} minD={md}",
              bound=(_nbytes(mdisp, best, minS), _nbytes(checked), 24 * H * W),
              primary=False)
        if torch.equal(checked, mdisp):
            raise AssertionError(f"SGBM LR check minD={md}: no pixel invalidated")
        del best, minS, dval, uniq, mdisp, checked
    # K8 at the right matchers' ranges: -127 (720p D=128 bs 13) and -287
    # (1920x1080 D=288, the default BM matcher's right matcher there), on the
    # swapped prefiltered views
    for a, b, d, md, what in (
            (rp, lp, BM_D, -127, f"D={BM_D} bs={BM_BS} minD=-127 (right matcher)"),
            (srp, slp, 288, -287, f"{str_w}x{str_h} D=288 bs={BM_BS} minD=-287 "
                                  f"(right matcher)")):
        check(bm_cost_wta, lambda a=a, b=b, d=d, md=md: bm_cost_wta(a, b, d, BM_BS, md),
              lambda a=a, b=b, d=d, md=md: bm_cost_wta_plain(a, b, d, BM_BS, md), what,
              bound=(_nbytes(a, b), 5 * 4 * a.numel(), a.numel() * d * (
                  _lanes(1, 1) + _lanes(2, 2) + 1 + _lanes(2, 2))),
              plain_reps=3, primary=False)
    # K6's BM entry at +16 and -8 on the BM matcher's own outputs there
    for md in (16, -8):
        mcfg = bm_cfg.replace(min_disparity=md, disp12_max_diff=-1,
                              speckle_window_size=0)
        bd = bm_ops.stereo_bm(lrect, rrect, mcfg)
        cost = bm_cost_wta(lp, rp, BM_D, BM_BS, md)[1]
        args = (bd, cost, BM_D, bm_cfg.disp12_max_diff, md)
        checked = lr_resolve_bm(*args)
        check(lr_resolve_bm, lambda a=args: lr_resolve_bm(*a),
              lambda a=args: lr_resolve_bm_plain(*a), f"{W}x{H} D={BM_D} minD={md}",
              bound=(_nbytes(bd, cost), _nbytes(checked), 16 * bd.numel()),
              primary=False)
        if torch.equal(checked, bd):
            raise AssertionError(f"BM LR check minD={md}: no pixel invalidated")
    # the smoother on the flagship frame's WLS inputs (the SGM matchers' two
    # disparities, the confidence floored as the smoother floors it), at the
    # first sweep's lambda, along the rows (the wrapper transposes) and the
    # columns: x, the confidence and the guide read once, u written once;
    # ~18 float32 operations a pixel. Then one scanline alone: one thread
    # walks the chain of dependent divides, the latency floor of a sweep.
    dl = sg.stereo_sgbm(lrect, rrect, m)
    dr = sg.stereo_sgbm(rrect, lrect, wls_ops.right_matcher_config(m))
    xs, wgt, _ = wls_ops.smoother_inputs(dl, dr, m)
    cf = torch.clamp(wgt, min=wls_ops.CONF_FLOOR)
    lam1 = wls_ops.sweep_lambdas()[0]
    tol = SMOOTH_RTOL * float(xs.max() - xs.min())
    for dim, along in ((1, "rows"), (0, "columns")):
        u = tridiag_smooth(xs, cf, lrect, lam1, 1.5, dim)
        check(tridiag_smooth, lambda dim=dim: tridiag_smooth(xs, cf, lrect, lam1, 1.5, dim),
              lambda dim=dim: tridiag_smooth_plain(xs, cf, lrect, lam1, 1.5, dim),
              f"{W}x{H} along the {along}, lambda {lam1:.1f}",
              bound=(_nbytes(xs, cf, lrect), _nbytes(u), 18 * H * W), plain_reps=1,
              primary=dim == 1, tol=tol)
    # the same inputs under the guide of an unblurred texture (the "fine"
    # scene's left view as the camera gives it): 1% of its weights lie below
    # 2^-100, whose stored cp the kernel divides on its scaled path
    fine = rgb_to_gray(torch.from_numpy(_source(W, H, scene="fine").render(0)[0]).to(dev))
    check(tridiag_smooth, lambda: tridiag_smooth(xs, cf, fine, lam1, 1.5, 1),
          lambda: tridiag_smooth_plain(xs, cf, fine, lam1, 1.5, 1),
          f"{W}x{H} along the rows, lambda {lam1:.1f}, unblurred-texture guide",
          bound=(_nbytes(xs, cf, fine), _nbytes(u), 18 * H * W), plain_reps=1,
          primary=False, tol=tol)
    for n, along in ((W, "row"), (H, "column")):
        line = (xs.t() if n == W else xs)[:, :1].contiguous()
        one = (cf.t() if n == W else cf)[:, :1].contiguous()
        g1 = (lrect.t() if n == W else lrect)[:, :1].contiguous()
        chain_ms = _time_ms(lambda: tridiag_smooth(line, one, g1, lam1, 1.5, 0))
        print(f"phase 3 tridiag_smooth chain floor: one {along} of {n} pixels alone "
              f"{chain_ms:.4f} ms (events)", flush=True)
    del dl, dr, xs, wgt, cf, u, fine
    torch.cuda.empty_cache()

    # -- 4. the SGM engine (the main path) -----------------------------------
    sgm_eng, sgm_launches = _check_engine(4, "sgm", W, H, SGM_PATH)
    # the TPU's two transposes stay around K4, which is one call a frame
    per_frame = {"vol_transpose": 2, "sgm_horiz": 1, "sgm_vert_wta": 1}
    if any(sgm_launches[k] != n for k, n in per_frame.items()):
        raise AssertionError(f"phase 4: launches {sgm_launches}, expected per "
                             f"frame {per_frame}")
    pair = (left, right)
    _timed_run(4, "SGM", card, sgm_eng, *pair, W, H)
    plain_frame_ms = _wall_ms(lambda: sgm_eng.frame_program(*pair, plain=True), reps=2)
    print(f"phase 4 SGM plain frame program {plain_frame_ms:.1f} ms", flush=True)

    # -- 5. where the SGM frame's time goes ----------------------------------
    def profile(phase, eng, pair, frames):
        stages, steps = _stage_profile(eng, *pair, frames=frames)
        for k, v in stages.items():
            print(f"phase {phase} stage {k}: {v:.4f} ms", flush=True)
        for k, v in steps.items():
            print(f"phase {phase} matcher step {k}: {v:.4f} ms", flush=True)
        print(f"phase {phase} stage sum: {sum(stages.values()):.3f} ms of device time "
              f"launched by the stages", flush=True)
        dev_ms, wall_ms, ops = _device_busy(lambda: eng.frame_program(*pair))
        print(f"phase {phase} torch.profiler: {dev_ms:.3f} ms of device time per "
              f"frame against {wall_ms:.3f} ms of wall time (busy "
              f"{dev_ms / wall_ms:.3f}), {ops:g} device operations a frame",
              flush=True)

    profile(5, sgm_eng, pair, 20)
    del sgm_eng

    # -- 6. the BM engine, its own path -------------------------------------
    bm_eng, bm_launches = _check_engine(6, "bm", W, H, BM_PATH)
    bm_ms = _wall_ms(lambda: bm_eng.frame_program(*pair), reps=10)
    print(f"phase 6 BM timing on {card}: frame program {bm_ms:.3f} ms", flush=True)
    profile(6, bm_eng, pair, 10)
    del bm_eng

    # -- 7. the stretch point: 8-path SGM at 1920x1080, D=256 (chained) ------
    str_eng, str_launches = _check_engine(
        7, "sgm", str_w, str_h, CHAINED_PATH, d=str_d, frames=STRETCH_FRAMES,
        absent=BIDIR)
    spair = (sleft, sright)
    _timed_run(7, f"SGM {str_w}x{str_h} D={str_d}", card, str_eng, *spair,
               str_w, str_h, d=str_d, frames=20)
    profile(7, str_eng, spair, 10)
    del str_eng

    # -- 8. cv2 MODE_SGBM: 5 paths at 1280x720, D=128 ------------------------
    sgbm5_eng, sgbm5_launches = _check_engine(
        8, "sgm", W, H, SGBM5_PATH, num_paths=5,
        absent=BIDIR + ("sgm_vert_pass",))
    _timed_run(8, "MODE_SGBM (5 paths)", card, sgbm5_eng, *pair, W, H,
               num_paths=5)
    profile(8, sgbm5_eng, pair, 10)
    del sgbm5_eng

    # -- 9. the default BM matcher on a 1920x1080 camera (D = 288) -----------
    bmd_eng, bmd_launches = _check_engine(9, "bm-default", str_w, str_h, BM_PATH,
                                          frames=STRETCH_FRAMES)
    if bmd_eng.num_disparities != 288:
        raise AssertionError(f"phase 9: D={bmd_eng.num_disparities}, not 288")
    bmd_ms = _wall_ms(lambda: bmd_eng.frame_program(*spair), reps=10)
    print(f"phase 9 BM 1920x1080 D=288 timing on {card}: frame program "
          f"{bmd_ms:.3f} ms", flush=True)
    profile(9, bmd_eng, spair, 10)
    del bmd_eng

    # -- 10. the WLS post filter: SGM-8 720p and BM-128 ----------------------
    post_runs = {}
    for kind, path in (("sgm", SGM_PATH + POST), ("bm", BM_PATH + POST)):
        p_eng, p_launches = _check_engine(10, kind, W, H, path, frames=POST_FRAMES,
                                          post_filter=True)
        got = {k: p_launches[k] for k in POST_PER_FRAME[kind]}
        if got != POST_PER_FRAME[kind]:
            raise AssertionError(f"phase 10 {kind} + WLS: launches a frame {got}, "
                                 f"expected {POST_PER_FRAME[kind]}")
        print(f"phase 10 {kind} + WLS: launches a frame {got} (the right matcher's "
              f"and the smoother's)", flush=True)
        p_ms = _wall_ms(lambda: p_eng.frame_program(*pair), reps=5)
        print(f"phase 10 {kind} + WLS timing on {card}: frame program {p_ms:.3f} ms",
              flush=True)
        profile(10, p_eng, pair, 5)
        post_runs[kind] = p_launches
        del p_eng
        torch.cuda.empty_cache()

    # -- 11. the entry points: the CLI, cooperative streams, setters, syncs --
    entry_runs = _entry_points(card)

    # -- 12. the multi-rank paths: parallel/ on torch.distributed -----------
    par_runs = _phase12(card)
    tile_launches = next(v for k, v in par_runs.items() if "(2, 2)" in k)

    # -- 13. the batch program ---------------------------------------------
    batch_runs = _batch_modes(card)
    batch_launches = batch_runs[f"batch program sgm x{BATCH} {W}x{H}"]

    # each kernel's launches on the path that runs it: the flagship's for
    # its kernels, the stretch run's for the chained passes, the BM run's
    # for K8, the flagship's with the post filter for the smoother, the
    # (2, 2) sharded step's (rank 0) for the exact tiling's scans, the
    # SGM batch program's for the batched entries (K10 runs on none);
    # launches_by_path holds every run's counts
    runs = {f"sgm-8 {W}x{H} D={D} (bidir)": sgm_launches,
            f"bm {W}x{H} D={BM_D}": bm_launches,
            f"sgm-8 {str_w}x{str_h} D={str_d} (chained)": str_launches,
            f"sgm-5 {W}x{H} D={D} (chained)": sgbm5_launches,
            f"bm {str_w}x{str_h} D=288 (default)": bmd_launches,
            f"sgm-8 {W}x{H} D={D} + WLS": post_runs["sgm"],
            f"bm {W}x{H} D={BM_D} + WLS": post_runs["bm"], **entry_runs, **par_runs,
            **batch_runs}
    kernels = []
    for wrapper, source, replaces in KERNELS:
        n = wrapper.__name__
        s = stats[n]
        launches = (post_runs["sgm"] if n in POST else
                    batch_launches if n in BATCH_ENTRIES else
                    tile_launches if n in ("sgm_tile_scan", "sgm_tile_final") else
                    sgm_launches if n in SGM_PATH else
                    str_launches if n in CHAINED_PATH else bm_launches)[n]
        kernels.append(dict(name=n, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=s["max_abs_err"], ms=s["ms"],
                            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                            bound_by=s["bound_by"], library_ms=s["library_ms"],
                            ms_b2b=s["ms_b2b"], device_ms=s["device_ms"],
                            launches_by_path={k: v[n] for k, v in runs.items()},
                            cases=s["cases"]))
        if n in TILE_DESIGN:
            kernels[-1]["design"] = TILE_DESIGN[n]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
