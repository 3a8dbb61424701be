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
     of both (CUDA events): the bidir SGM kernels (K12, K4, K5) at the
     flagship shape and at an odd 700x1000, D=64 one (K12 also in the TPU's
     3-D form); the chained passes (K9a/K9b, K9c/K11, K9d: both senses,
     with and without a partial, int16 and int32) at the stretch point
     1920x1080, D=256 and at the odd shape; K3, K6 and K7 at all three; the
     bidir and chained routes timed on the stretch volume, which must give
     the same winners; a snake through the speckle path where the 16-sweep
     cap binds; the BM and SGM matchers against the repo's numpy goldens
     (cv2.StereoBM and cv2.StereoSGBM parity: MODE_SGBM, the causal 4 paths
     and MODE_HH on both of its routes);
  4. engine, SGM: Engine.run on a synthetic 1280x720 stream through a
     non-identity rectification with the launch counts set to 0 just
     before; every kernel of the path must have launched, and every frame's
     disparity, boxes, mask and count must equal the plain frame program;
     then the frame program's median time and the pipelined frame rate;
  5. stage profile of the SGM frame program (a CUDA event at each of the
     frame program's stage marks) and the device's busy share
     (torch.profiler);
  6. engine, BM (D=128, block size 13, speckle filter on): the same checks
     on its own path, counted apart;
  7. engine, the stretch point (1920x1080, 8-path SGM, D=256; H % 16 != 0,
     so the chained route): the same checks on two frames, the bidir
     kernels must not launch; its timing and stage profile;
  8. engine, cv2 MODE_SGBM (1280x720, 5 paths, D=128): the same checks, K9c
     and the bidir kernels must not launch; its timing and stage profile.

The last lines are the kernels' JSON summary, the nvidia-smi line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
STRETCH_FRAMES = 2  # frames of the checked stretch run (its plain program is slow)
TIMED_FRAMES = 30  # frames of the timed engine run
DEV = "cuda"

#: H100 SXM peaks (NVIDIA data sheet): device memory bytes/s, and the
#: non-tensor-core fp32 rate, used for the kernels' int32 operations (the
#: data sheet lists no int32 rate; the fp32 rate is the higher one, so the
#: bound stays a lower bound)
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
#: the kernels of each frame program: the SGM one (bidir route), the BM
#: one, 8-path SGM on the chained route, and cv2 MODE_SGBM (5 paths)
_SGM_COMMON = ("remap_u8", "seg_min_propagate", "sgm_cost_volume", "lr_resolve",
               "label_histogram_banded")
BIDIR = ("vol_transpose", "sgm_horiz", "sgm_vert_wta")
SGM_PATH = _SGM_COMMON + BIDIR
BM_PATH = ("remap_u8", "seg_min_propagate", "bm_cost_wta", "lr_resolve",
           "label_histogram_banded")
CHAINED_PATH = _SGM_COMMON + ("sgm_horiz_pass", "sgm_vert_pass", "sgm_final_wta")
SGBM5_PATH = _SGM_COMMON + ("sgm_horiz_pass", "sgm_final_wta")


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


def _max_abs_err(got, ref) -> int:
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} != {r.shape} {r.dtype}")
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


def _source(w, h, ring=0):
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
    src = SyntheticStereoSource(w, h, seed=11, objects=objects, ring=ring)
    src.rectified = False  # the engine applies the rectification maps
    return src


def _config(kind, w, h, d=D, num_paths=8):
    from rt_depth_map_tpu_torch.config import EngineConfig, MatcherConfig

    if kind == "sgm":
        m = MatcherConfig(kind="sgm", num_disparities=d, block_size=BS,
                          num_paths=num_paths, pre_filter_cap=0)
        nd = d
    else:  # the BM defaults, speckle filter on
        m = MatcherConfig(kind="bm", num_disparities=BM_D, block_size=BM_BS)
        nd = BM_D
    return EngineConfig(width=w, height=h, number_of_disparities=nd, matcher=m)


def _engine(kind, w, h, ring=0, d=D, num_paths=8):
    from rt_depth_map_tpu_torch import Engine

    return Engine(_config(kind, w, h, d, num_paths),
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
                  frames=ENGINE_FRAMES, absent=()):
    """Engine.run with the counts set to 0 just before; every kernel of the
    path launched, none of `absent`, and every frame equal to the plain
    frame program. Returns the engine and the launch counts of the run."""
    import torch

    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    what = f"phase {phase} {f'sgm-{num_paths}' if kind == 'sgm' else 'bm'} engine {w}x{h}"
    eng = _engine(kind, w, h, d=d, num_paths=num_paths)
    eng.warmup()
    results = {}
    reset_launch_counts()
    eng.run(frames=frames, on_frame=lambda i, r: results.__setitem__(i, r),
            print_stats_on_sigint=False)
    launches = {wr.__name__: wr.launches for wr, _, _ in KERNELS}
    print(f"{what}: {len(results)} frames, launches {launches}", flush=True)
    if len(results) != frames:
        raise AssertionError(f"{what} returned {len(results)} frames")
    _require_launched(launches, path, what, absent)

    ref_src = _source(w, h)
    for i in sorted(results):
        res = results[i]
        lf, rf, _, _ = ref_src.render(i)
        ref = eng.frame_program(torch.from_numpy(lf).to(DEV),
                                torch.from_numpy(rf).to(DEV), plain=True)
        for k in ("disparity", "boxes", "mask", "count"):
            if not np.array_equal(getattr(res, k), ref[k].cpu().numpy()):
                raise AssertionError(f"{what} frame {i}: {k} differs from the "
                                     f"plain program")
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
    """Median ms of each stage of the SGM frame program: a CUDA event at each
    of `Engine.frame_program`'s stage marks (the events include host launch
    gaps where the device waits)."""
    import torch

    rows = {}

    def one():
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        mark("start")
        eng.frame_program(left, right, mark=mark)
        _sync()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            rows.setdefault(name, []).append(a.elapsed_time(b))

    one()
    rows.clear()
    for _ in range(frames):
        one()
    return {k: statistics.median(v) for k, v in rows.items()}


def _device_busy(fn, frames=5):
    """(device ms per frame, wall ms per frame) from torch.profiler over
    `frames` calls of fn; device time sums the kernels' self device time."""
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
    dev_us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0.0)
                 for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return dev_us / 1e3 / frames, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from rt_depth_map_tpu_torch.golden import golden_stereo_bm, golden_stereo_sgbm
    from rt_depth_map_tpu_torch.ops import bm as bm_ops
    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.cc import (
        CC_MAX_ROUNDS,
        connected_components_bbox,
        connected_components_scan,
    )
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, _build
    from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta, bm_cost_wta_plain
    from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import seg_min_propagate
    from rt_depth_map_tpu_torch.ops.cuda.histogram import (
        label_histogram,
        label_histogram_banded,
        label_histogram_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve, lr_resolve_plain
    from rt_depth_map_tpu_torch.ops.cuda.remap import remap_u8, remap_u8_plain
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import (
        sgm_cost_volume,
        sgm_cost_volume_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
        sgm_final_wta,
        sgm_final_wta_plain,
        sgm_horiz_pass,
        sgm_horiz_pass_plain,
        sgm_vert_pass,
        sgm_vert_pass_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz, sgm_horiz_plain
    from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import (
        sgm_vert_wta,
        sgm_vert_wta_plain,
    )
    from rt_depth_map_tpu_torch.ops.cuda.vol_transpose import (
        vol_transpose,
        vol_transpose_plain,
    )
    from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear
    from rt_depth_map_tpu_torch.ops.speckle import filter_speckles

    # -- 1. device ---------------------------------------------------------
    card = _card()
    dev = torch.device(DEV)
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}", flush=True)

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
            for ln in log.splitlines():
                if "bytes spill stores" in ln and not ln.strip().startswith("0 bytes"):
                    print(f"phase 2 build {stem} spills: {ln.strip()}", flush=True)
    print(f"phase 2 build total (parallel): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 3. kernels vs plain at the frame program's shapes -------------------
    sgm_eng = _engine("sgm", W, H)
    st = sgm_eng.state
    left_np, right_np, _, _ = _source(W, H).render(0)
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    lstack = torch.cat([rgb_to_gray(left)[..., None], left], dim=-1).contiguous()
    rgray = rgb_to_gray(right)[..., None].contiguous()
    stats = {}

    def check(wrapper, kernel_fn, plain_fn, what, bound=None, library_fn=None,
              plain_reps=15, timed=True):
        """Exact equality, then timing (timed=False: a variant case, checked
        only); the first timed case of a kernel is the one its summary
        reports (bound: (in_bytes, out_bytes, ops))."""
        err = _max_abs_err(kernel_fn(), plain_fn())
        if err != 0:
            raise AssertionError(f"{wrapper.__name__} {what}: kernel != plain "
                                 f"(max |err| {err})")
        if not timed:
            stats[wrapper.__name__]["max_abs_err"] = max(
                stats[wrapper.__name__]["max_abs_err"], err)
            print(f"phase 3 {wrapper.__name__} {what}: exact", flush=True)
            return
        ms = _time_ms(kernel_fn)
        plain_ms = _time_ms(plain_fn, reps=plain_reps, warm=1)
        line = f"phase 3 {wrapper.__name__} {what}: exact, {ms:.4f} ms (plain {plain_ms:.3f} ms"
        if bound is not None:
            b_ms, b_by = _bound(*bound)
            line += f", bound {b_ms:.4f} ms by {b_by}"
        if wrapper.__name__ not in stats:
            lib_ms = _time_ms(library_fn) if library_fn is not None else None
            stats[wrapper.__name__] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=lib_ms)
            if lib_ms is not None:
                line += f", library {lib_ms:.4f} ms"
        stats[wrapper.__name__]["max_abs_err"] = max(
            stats[wrapper.__name__]["max_abs_err"], err)
        print(line + ")", flush=True)

    # K1: left 4-channel and right gray planes through the warped maps
    # (~16 operations per output value: four taps, weights, rounding)
    for what, img, tab in (("left gray+RGB", lstack, st.left),
                           ("right gray", rgray, st.right)):
        args = (img, tab.ix, tab.iy, tab.fx, tab.fy, tab.valid)
        out_b = tab.ix.numel() * img.shape[-1]
        check(remap_u8, lambda a=args: remap_u8(*a),
              lambda a=args: remap_u8_plain(*a), what,
              bound=(_nbytes(*args), out_b, 16 * out_b))

    # K2: the frame's filtered mask (4 fields, 8-connected), and a snake on
    # which the cap binds (~8 operations per field value and sweep: hop,
    # row and column run-min, flags)
    frame = sgm_eng.frame_program(left, right, plain=True)
    snake_t = torch.from_numpy(_snake(H, W, H // 8)).to(dev)
    for what, msk in (("frame mask", frame["mask"] != 0), ("snake", snake_t)):
        connected_components_bbox(msk, 8)
        sweeps = seg_min_propagate.last_rounds
        n_px = msk.numel()
        check(seg_min_propagate, lambda m=msk: connected_components_bbox(m, 8),
              lambda m=msk: connected_components_bbox(m, 8, plain=True), what,
              bound=(n_px * (4 * 4 + 1 + 4), 4 * 4 * n_px, 8 * 4 * n_px * sweeps))
    full = connected_components_bbox(snake_t, 8, max_rounds=None)[0]
    full_rounds = seg_min_propagate.last_rounds
    capped = connected_components_bbox(snake_t, 8)[0]
    if seg_min_propagate.last_rounds != CC_MAX_ROUNDS or bool((full == capped).all()):
        raise AssertionError("the round cap did not bind on the snake")
    print(f"phase 3 cc cap: snake stopped at {CC_MAX_ROUNDS} sweeps, its fixed "
          f"point takes {full_rounds}", flush=True)

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
    lrect = remap_bilinear(lstack, st.left, plain=True)[..., 0].contiguous()
    rrect = remap_bilinear(rgray, st.right, plain=True)[..., 0].contiguous()
    m = st.matcher
    p1, p2 = m.p1, max(m.p2, m.p1 + 1)
    ur = m.uniqueness_ratio

    def bidir_checks(C, what):
        """K12, K4, K12, K5 against their plain versions; K5's outputs."""
        C4 = C[:, None]
        # K12 turns the cost volume x-major for K4 and K4's sum back; the
        # library call is torch's own strided copy
        check(vol_transpose, lambda: vol_transpose(C4),
              lambda: vol_transpose_plain(C4), what + " cost volume",
              bound=(_nbytes(C), _nbytes(C), 0),
              library_fn=lambda: C4.transpose(0, 2).contiguous())
        Ct = sg.swap_pixel_axes(C)
        Sh_t = sgm_horiz(Ct, p1, p2)
        # 8 operations per element and direction (min, shuffles, add)
        check(sgm_horiz, lambda: sgm_horiz(Ct, p1, p2),
              lambda: sgm_horiz_plain(Ct, p1, p2), what,
              bound=(_nbytes(Ct), _nbytes(Sh_t), 2 * 8 * C.numel()), plain_reps=2)
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
              bound=(_nbytes(C, Sh), _nbytes(*outs), 6 * 8 * C.numel() + 8 * C.numel()),
              plain_reps=2)
        return outs

    def chained_checks(C, what):
        """K9a/K9b, K9c/K11 and K9d against their plain versions: the
        8-path route's calls timed, the other senses, partials, layouts and
        dtypes checked; the 8-path route's outputs."""
        n = C.numel()
        # K9a, the route's two calls: left to right, right to left + partial
        hf = sgm_horiz_pass(C, p1, p2)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(C, p1, p2),
              lambda: sgm_horiz_pass_plain(C, p1, p2), what + " L->R",
              bound=(_nbytes(C), _nbytes(hf), 8 * n), plain_reps=2)
        check(sgm_horiz_pass, lambda: sgm_horiz_pass(C, p1, p2, True, hf),
              lambda: sgm_horiz_pass_plain(C, p1, p2, True, hf),
              what + " R->L + partial", timed=False)
        Sh = sgm_horiz_pass(C, p1, p2, True, hf)
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
              bound=(_nbytes(Ct, hft), _nbytes(hft), 8 * n), plain_reps=1)
        del Ct, hft
        # K9c, the route's call (top-down + partial); K11's other sense and
        # its int32 contract
        Sa = sgm_vert_pass(C, p1, p2, partial=Sh)
        check(sgm_vert_pass, lambda: sgm_vert_pass(C, p1, p2, partial=Sh),
              lambda: sgm_vert_pass_plain(C, p1, p2, partial=Sh),
              what + " top-down + partial",
              bound=(_nbytes(C, Sh), _nbytes(Sa), 3 * 8 * n), plain_reps=1)
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
              bound=(_nbytes(Ci, Shi), _nbytes(Shi), 3 * 8 * n), plain_reps=1)
        del Ci, Shi
        # K9d: the 8-path finish (bottom-up on the 5-direction partial), and
        # the 5-path one (top-down on the horizontal sum)
        outs = sgm_final_wta(C, Sa, p1, p2, ur, True)
        check(sgm_final_wta, lambda: sgm_final_wta(C, Sa, p1, p2, ur, True),
              lambda: sgm_final_wta_plain(C, Sa, p1, p2, ur, True),
              what + " bottom-up",
              bound=(_nbytes(C, Sa), _nbytes(*outs), 3 * 8 * n + 8 * n),
              plain_reps=1)
        check(sgm_final_wta, lambda: sgm_final_wta(C, Sh, p1, p2, ur, False),
              lambda: sgm_final_wta_plain(C, Sh, p1, p2, ur, False),
              what + " top-down", timed=False)
        return outs

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
        # ~21 operations per volume element: two BT costs, the quarter
        # weighting, and the separable sliding window sums
        check(sgm_cost_volume, lambda: sgm_cost_volume(lpl, rpl, d, BS, dtype)[0],
              lambda: sgm_cost_volume_plain(lpl, rpl, d, BS, dtype)[0], what,
              bound=(_nbytes(lpl, rpl), _nbytes(C), 21 * n), plain_reps=5)
        if (h, w, d) != STRETCH:
            outs = bidir_checks(C, what)
        if (h, w, d) != flagship:
            outs_c = chained_checks(C, what)
            if (h, w, d) == ODD and _max_abs_err(outs_c, outs) != 0:
                raise AssertionError(f"{what}: the chained route's winners differ "
                                     f"from the bidir route's")
            outs = outs_c
        if (h, w, d) == STRETCH:
            # both 8-path routes on the stretch volume (the port's kernels
            # take any H; the route gate follows the reference's)
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
            # the SGBM LR check's K6 call, on the planes lr_check_sgbm builds
            d_intW, keyW, rms, kw = sg.lr_key_planes_sgbm(disp, best, minS, d,
                                                          w - d, d)
            outs6 = lr_resolve(d_intW, keyW, rms, **kw)
            check(lr_resolve, lambda: lr_resolve(d_intW, keyW, rms, **kw),
                  lambda: lr_resolve_plain(d_intW, keyW, rms, **kw),
                  f"SGBM LR check {what}",
                  bound=(_nbytes(d_intW, keyW, *rms), _nbytes(*outs6), 6 * h * w))
            disp = sg.lr_check_sgbm(disp, best, minS, d, w - d, d, m.disp12_max_diff)
        act = disp != -16
        labels = connected_components_scan(disp, act, m.speckle_range * 16)
        cnt = label_histogram(labels, act)
        hb = (_nbytes(labels, act), _nbytes(cnt), h * w)
        lib = (lambda lab=labels, a=act: torch.bincount(lab[a], minlength=lab.numel()))
        check(label_histogram_banded,
              lambda: label_histogram_banded(labels, act, m.speckle_window_size),
              lambda: label_histogram_plain(labels, act), what + " speckle labels",
              bound=hb, library_fn=lib)
        check(label_histogram, lambda: label_histogram(labels, act),
              lambda: label_histogram_plain(labels, act), what + " speckle labels",
              bound=hb, library_fn=lib)
        if not torch.equal(lib().reshape(h, w).to(torch.int32), cnt):
            raise AssertionError("label_histogram != torch.bincount")
        print(f"phase 3 SGM {what}: {float(act.float().mean()):.3f} of pixels "
              f"valid after the LR check, {int((cnt > 0).sum())} components",
              flush=True)
        del C, best, minS, dval, uniq
        torch.cuda.empty_cache()

    # K12 in the TPU's own 3-D form, (A, D, B) -> (B, D, A), at the shape of
    # its TPU call (one element per unit: the shared-memory tile variant)
    xt = torch.randint(-3000, 3000, (1152, 128, 768), dtype=torch.int16, device=dev)
    check(vol_transpose, lambda: vol_transpose(xt), lambda: vol_transpose_plain(xt),
          "TPU form (1152, 128, 768) int16")
    del xt

    # the speckle path under the cap: a snake disparity whose value-edge
    # propagation needs more than 16 sweeps
    sdisp = torch.where(snake_t, 32, -16).to(torch.int16)
    sact = sdisp != -16
    if torch.equal(connected_components_scan(sdisp, sact, 512),
                   connected_components_scan(sdisp, sact, 512, max_rounds=None)):
        raise AssertionError("the round cap did not bind on the speckle snake")
    for size in (100, H * W):
        got = filter_speckles(sdisp, -16, size, 512)
        ref = filter_speckles(sdisp, -16, size, 512, plain=True)
        if not torch.equal(got, ref):
            raise AssertionError(f"speckle snake, max_size {size}: kernels != plain")
        print(f"phase 3 speckle snake max_size {size}: exact under the cap, "
              f"{int((got != -16).sum())} of {int(sact.sum())} pixels kept",
              flush=True)

    # K8 on the rectified, prefiltered frame; K6 on K8's output (BM point)
    bm_cfg = _config("bm", W, H).matcher
    lp = xsobel_prefilter(lrect, bm_cfg.pre_filter_cap)
    rp = xsobel_prefilter(rrect, bm_cfg.pre_filter_cap)
    bm_out = bm_cost_wta(lp, rp, BM_D, BM_BS)
    # ~9 operations per pixel and d: |L - R|, the sliding window updates and
    # the winner update
    check(bm_cost_wta, lambda: bm_cost_wta(lp, rp, BM_D, BM_BS),
          lambda: bm_cost_wta_plain(lp, rp, BM_D, BM_BS), f"D={BM_D} bs={BM_BS}",
          bound=(_nbytes(lp, rp), _nbytes(*bm_out), 9 * H * W * BM_D))
    bdisp = bm_ops.stereo_bm(lrect, rrect, bm_cfg.replace(
        disp12_max_diff=-1, speckle_window_size=0), plain=True)
    _, _, d_int, key = bm_ops.lr_key_planes(bdisp, bm_out[1])
    kw = dict(n_w=BM_D + 1, r_lo=0, n_r=BM_D + 1, Dpow=bm_ops.LR_DPOW,
              c0=-bm_ops.LR_OFF, invalid=-16)
    check(lr_resolve, lambda: lr_resolve(d_int, key, (d_int,), **kw),
          lambda: lr_resolve_plain(d_int, key, (d_int,), **kw), "BM LR check")
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

    # -- 4. the SGM engine (the main path) -----------------------------------
    sgm_eng, sgm_launches = _check_engine(4, "sgm", W, H, SGM_PATH)
    pair = (left, right)
    _timed_run(4, "SGM", card, sgm_eng, *pair, W, H)
    plain_frame_ms = _wall_ms(lambda: sgm_eng.frame_program(*pair, plain=True), reps=2)
    print(f"phase 4 SGM plain frame program {plain_frame_ms:.1f} ms", flush=True)

    # -- 5. where the SGM frame's time goes ----------------------------------
    def profile(phase, eng, pair, frames):
        prof = _stage_profile(eng, *pair, frames=frames)
        for k, v in prof.items():
            print(f"phase {phase} stage {k}: {v:.4f} ms", flush=True)
        print(f"phase {phase} stage sum: {sum(prof.values()):.3f} ms", flush=True)
        dev_ms, wall_ms = _device_busy(lambda: eng.frame_program(*pair))
        print(f"phase {phase} torch.profiler: {dev_ms:.3f} ms of device time per "
              f"frame against {wall_ms:.3f} ms of wall time (busy "
              f"{dev_ms / wall_ms:.3f})", flush=True)

    profile(5, sgm_eng, pair, 20)
    del sgm_eng

    # -- 6. the BM engine, its own path -------------------------------------
    bm_eng, bm_launches = _check_engine(6, "bm", W, H, BM_PATH)
    bm_ms = _wall_ms(lambda: bm_eng.frame_program(*pair), reps=10)
    print(f"phase 6 BM timing on {card}: frame program {bm_ms:.3f} ms", flush=True)
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

    # each kernel's launches on the path that runs it: the flagship's for
    # its kernels, the stretch run's for the chained passes, the BM run's
    # for K8 (K10 runs on none); launches_by_path holds every run's counts
    runs = {f"sgm-8 {W}x{H} D={D} (bidir)": sgm_launches,
            f"bm {W}x{H} D={BM_D}": bm_launches,
            f"sgm-8 {str_w}x{str_h} D={str_d} (chained)": str_launches,
            f"sgm-5 {W}x{H} D={D} (chained)": sgbm5_launches}
    kernels = []
    for wrapper, source, replaces in KERNELS:
        n = wrapper.__name__
        s = stats[n]
        launches = (sgm_launches if n in SGM_PATH else
                    str_launches if n in CHAINED_PATH else bm_launches)[n]
        kernels.append(dict(name=n, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=s["max_abs_err"], ms=s["ms"],
                            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                            bound_by=s["bound_by"], library_ms=s["library_ms"],
                            launches_by_path={k: v[n] for k, v in runs.items()}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
