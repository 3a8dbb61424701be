#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rt_depth_map_tpu_torch) on one card.

Run from the root of a checkout, on a machine with one NVIDIA GPU (Hopper:
the kernels are built for sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: nvcc builds the four kernels from csrc/ into build/torch_kernels/;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes of the 1280x720 BM D=128 frame program, exact equality, and
     the median time of both (CUDA events);
     The whole matcher on the card must also equal the repo's numpy golden
     (cv2.StereoBM parity) on a crop of the frame;
  4. engine: Engine.run on a synthetic 1280x720 stream through a
     non-identity rectification, BM D=128, block size 13, speckle filter
     off; every kernel's launch count must rise, there must be boxes with
     valid disparities, and the frame outputs must equal the plain frame
     program on the same inputs; then the frame program's median time (host
     clock through a synchronise) and the pipelined frame rate.

The last lines are one JSON object per kernel summary, the nvidia-smi line,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

W, H, D, BS = 1280, 720, 128, 13
ENGINE_FRAMES = 6  # frames of the checked engine run
TIMED_FRAMES = 40  # frames of the timed engine run


def _time_ms(fn, reps=15, warm=3):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
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
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
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


def _rectification():
    """Same warp for both eyes (rows stay aligned): a fractional x shift and
    a vertical stretch whose top and bottom rows sample outside the frame."""
    from rt_depth_map_tpu.calib import RectificationResult
    from rt_depth_map_tpu.sources import SyntheticStereoSource

    oy, ox = np.mgrid[0:H, 0:W].astype(np.float32)
    grid = np.stack([ox + 0.3, oy * (H + 8.0) / H - 4.0], axis=-1).astype(np.float32)
    return RectificationResult(
        map_left=grid, map_right=grid.copy(),
        Q=SyntheticStereoSource(W, H).q_matrix(), roi=(0, 0, W, H),
        image_size=(W, H), rectify=None)


def _source(ring=0):
    from rt_depth_map_tpu.sources import SyntheticStereoSource
    from rt_depth_map_tpu.sources.synthetic import SyntheticObject

    # disparity = 0.9 * W * 4.8 / z: 92, 69 and 50 px at W = 1280, inside
    # D = 128; placement in 1/1280 and 1/720 of the frame
    sx, sy = W / 1280.0, H / 720.0
    objects = [
        SyntheticObject(x=int(x * sx), y=int(y * sy), w=int(w * sx),
                        h=int(h * sy), z_units=z, vx=vx, vy=vy)
        for x, y, w, h, z, vx, vy in (
            (180, 120, 300, 220, 60.0, 2.0, 0.0),
            (620, 330, 260, 200, 80.0, 0.0, 1.0),
            (960, 160, 200, 160, 110.0, -1.5, 0.0))
    ]
    src = SyntheticStereoSource(W, H, seed=11, objects=objects, ring=ring)
    src.rectified = False  # the engine applies the rectification maps
    return src


def _config():
    from rt_depth_map_tpu.config import EngineConfig, MatcherConfig

    return EngineConfig(
        width=W, height=H, number_of_disparities=D,
        matcher=MatcherConfig(kind="bm", num_disparities=D, block_size=BS,
                              speckle_window_size=0))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    from rt_depth_map_tpu.golden import golden_stereo_bm
    from rt_depth_map_tpu_torch import Engine
    from rt_depth_map_tpu_torch.ops import bm as bm_ops
    from rt_depth_map_tpu_torch.ops.cc import CC_MAX_ROUNDS, connected_components_bbox
    from rt_depth_map_tpu_torch.ops.cuda import KERNELS, _build, reset_launch_counts
    from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta, bm_cost_wta_plain
    from rt_depth_map_tpu_torch.ops.cuda.cc_sweep import seg_min_propagate
    from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import lr_resolve, lr_resolve_plain
    from rt_depth_map_tpu_torch.ops.cuda.remap import remap_u8, remap_u8_plain
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear

    # -- 1. device ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    for stem in ("remap", "cc_sweep", "bm_kernel", "lr_resolve"):
        _build.load(stem)
        log = [ln.strip() for ln in _build.build_log.get(stem, "").splitlines()
               if "registers" in ln or "spill" in ln]
        print(f"phase 2 build {stem}: {_build.build_seconds.get(stem, 0.0):.1f} s "
              f"{' | '.join(log)}", flush=True)
    print(f"phase 2 build total: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernels vs plain at the frame program's shapes -------------------
    eng = Engine(_config(), rectification=_rectification(), source=_source(),
                 device="cuda")
    st = eng.state
    left_np, right_np, _, _ = _source().render(0)
    left = torch.from_numpy(left_np).to(dev)
    right = torch.from_numpy(right_np).to(dev)
    lstack = torch.cat([rgb_to_gray(left)[..., None], left], dim=-1).contiguous()
    rgray = rgb_to_gray(right)[..., None].contiguous()
    stats = {}

    def check(wrapper, kernel_fn, plain_fn, what):
        """Exact equality, then timing; the first shape checked for a kernel
        is the one its summary reports."""
        err = _max_abs_err(kernel_fn(), plain_fn())
        if err != 0:
            raise AssertionError(f"{wrapper.__name__} {what}: kernel != plain "
                                 f"(max |err| {err})")
        ms, plain_ms = _time_ms(kernel_fn), _time_ms(plain_fn)
        s = stats.setdefault(wrapper.__name__,
                             dict(max_abs_err=0, ms=ms, plain_ms=plain_ms))
        s["max_abs_err"] = max(s["max_abs_err"], err)
        print(f"phase 3 {wrapper.__name__} {what}: exact, {ms:.3f} ms "
              f"(plain {plain_ms:.3f} ms)", flush=True)

    # K1: left 4-channel and right gray planes through the warped maps
    for what, img, tab in (("left gray+RGB", lstack, st.left),
                           ("right gray", rgray, st.right)):
        args = (img, tab.ix, tab.iy, tab.fx, tab.fy, tab.valid)
        check(remap_u8, lambda a=args: remap_u8(*a),
              lambda a=args: remap_u8_plain(*a), what)

    # K2: the frame's filtered mask, and a snake on which the cap binds
    frame = eng.frame_program(left, right, plain=True)
    snake = np.zeros((H, W), bool)
    step = 8
    for a in range(H // step):
        snake[a * step, :] = True
        if a + 1 < H // step:
            snake[a * step: (a + 1) * step + 1, W - 1 if a % 2 == 0 else 0] = True
    snake_t = torch.from_numpy(snake).to(dev)
    for what, m in (("frame mask", frame["mask"] != 0), ("snake", snake_t)):
        check(seg_min_propagate, lambda m=m: connected_components_bbox(m, 8),
              lambda m=m: connected_components_bbox(m, 8, plain=True), what)
    full = connected_components_bbox(snake_t, 8, max_rounds=None)[0]
    full_rounds = seg_min_propagate.last_rounds
    capped = connected_components_bbox(snake_t, 8)[0]
    if seg_min_propagate.last_rounds != CC_MAX_ROUNDS or bool((full == capped).all()):
        raise AssertionError("the round cap did not bind on the snake")
    print(f"phase 3 cc cap: snake stopped at {CC_MAX_ROUNDS} sweeps, its fixed "
          f"point takes {full_rounds}", flush=True)

    # K8 on the rectified, prefiltered frame; K6 on K8's output
    lrect = remap_bilinear(lstack, st.left, plain=True)[..., 0].contiguous()
    rrect = remap_bilinear(rgray, st.right, plain=True)[..., 0].contiguous()
    lp = xsobel_prefilter(lrect, st.matcher.pre_filter_cap)
    rp = xsobel_prefilter(rrect, st.matcher.pre_filter_cap)
    check(bm_cost_wta, lambda: bm_cost_wta(lp, rp, D, BS),
          lambda: bm_cost_wta_plain(lp, rp, D, BS), f"D={D} bs={BS}")
    # the whole frame as matcher region (no ROI): the most LR candidates
    disp = bm_ops.stereo_bm(lrect, rrect, st.matcher.replace(disp12_max_diff=-1),
                            plain=True)
    best_cost = bm_cost_wta_plain(lp, rp, D, BS)[1]
    _, _, d_int, key = bm_ops.lr_key_planes(disp, best_cost)
    kw = dict(n_w=D + 1, r_lo=0, n_r=D + 1, Dpow=bm_ops.LR_DPOW,
              c0=-bm_ops.LR_OFF, invalid=-16)
    check(lr_resolve, lambda: lr_resolve(d_int, key, (d_int,), **kw),
          lambda: lr_resolve_plain(d_int, key, (d_int,), **kw), "BM LR check")
    print(f"phase 3 bm: {int((disp != -16).sum())} valid pixels before the LR "
          f"check", flush=True)

    # the matcher on the card (K8 + K6, ragged tiles) against the repo's numpy
    # golden (cv2.StereoBM parity, rt_depth_map_tpu/golden/bm.py) on a crop
    gl = lrect[H // 4: H // 4 + 96, W // 8: W // 8 + 300].contiguous()
    gr = rrect[H // 4: H // 4 + 96, W // 8: W // 8 + 300].contiguous()
    small = st.matcher.replace(num_disparities=64)
    ref = golden_stereo_bm(gl.cpu().numpy(), gr.cpu().numpy(), 64, BS,
                           speckle_window_size=0)
    got = bm_ops.stereo_bm(gl, gr, small).cpu().numpy()
    if not np.array_equal(got, ref) or (ref == -16).all():
        raise AssertionError("stereo_bm on the card != the numpy golden")
    print(f"phase 3 stereo_bm 96x300 D=64: equals the numpy golden "
          f"({int((ref != -16).sum())} valid pixels)", flush=True)

    # -- 4. engine ---------------------------------------------------------
    eng.warmup()
    results = {}
    reset_launch_counts()
    eng.run(frames=ENGINE_FRAMES, on_frame=lambda i, r: results.__setitem__(i, r),
            print_stats_on_sigint=False)
    launches = {w.__name__: w.launches for w, _, _ in KERNELS}
    print(f"phase 4 engine: {len(results)} frames, launches {launches}", flush=True)
    if len(results) != ENGINE_FRAMES:
        raise AssertionError(f"engine returned {len(results)} frames")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched by the engine: {launches}")

    ref_src = _source()
    for i in sorted(results):
        res = results[i]
        lf, rf, _, _ = ref_src.render(i)
        ref = eng.frame_program(torch.from_numpy(lf).to(dev),
                                torch.from_numpy(rf).to(dev), plain=True)
        for k in ("disparity", "boxes", "mask", "count"):
            if not np.array_equal(getattr(res, k), ref[k].cpu().numpy()):
                raise AssertionError(f"frame {i}: {k} differs from the plain program")
        if res.disparity.shape != (H, W) or res.boxes[:, 4].sum() == 0:
            raise AssertionError(f"frame {i}: bad shape or no box")
        valid_in_boxes = res.count[res.boxes[:, 4] > 0]
        if not (valid_in_boxes > 0).any() or not np.isfinite(
                res.depth_cm[res.count > 0]).all():
            raise AssertionError(f"frame {i}: no valid depth in any box")
        print(f"phase 4 frame {i}: boxes {int(res.boxes[:, 4].sum())} "
              f"count {res.count.tolist()} depth_cm "
              f"{[round(float(v), 1) for v in res.depth_cm[res.count > 0]]}", flush=True)

    pair = (left, right)

    def frame_kernel():
        eng.frame_program(*pair)

    def frame_plain():
        eng.frame_program(*pair, plain=True)

    frame_ms = _wall_ms(frame_kernel, reps=10)
    plain_frame_ms = _wall_ms(frame_plain, reps=5)
    # a ring of 8 pre-rendered frames: a camera delivers frames at sensor
    # rate, while painting the synthetic scene per grab would bound the loop
    timed = Engine(_config(), rectification=_rectification(),
                   source=_source(ring=8), device="cuda")
    timed.warmup()
    timed.run(frames=TIMED_FRAMES, print_stats_on_sigint=False)
    fps = timed.stats.wall_frames / timed.stats.wall_seconds
    print(f"phase 4 timing on {card}: frame program {frame_ms:.2f} ms "
          f"(plain {plain_frame_ms:.2f} ms), pipelined run {fps:.1f} frames/s "
          f"over {TIMED_FRAMES} frames", flush=True)

    kernels = []
    for wrapper, source, replaces in KERNELS:
        s = stats[wrapper.__name__]
        kernels.append(dict(name=wrapper.__name__, route="cuda", source=source,
                            replaces=replaces, launches=launches[wrapper.__name__],
                            max_abs_err=s["max_abs_err"], ms=s["ms"],
                            plain_ms=s["plain_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
