#!/usr/bin/env python3
"""Time the frame programs' LR check and speckle stages (K6, K7 and the glue
around them) in one or more checkouts on one card, each checkout in its own
process, in the order given.

    python3 tools/time_torch_lr_speckle.py ROOT [ROOT ...]
    python3 tools/time_torch_lr_speckle.py --ablate ROOT

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that drift of
the card over the call shows). A process imports the package of its ROOT
only and builds that checkout's kernels into its own `build/`. On each of
four paths (SGM-8 1280x720, SGM-8 1920x1080 D=256, cv2 MODE_SGBM 1280x720,
BM-128 1280x720) it runs the frame program once on chip_smoke.py's first
synthetic frame pair, keeping the arguments the matcher hands its LR check
(`ops/sgbm.py` `lr_check_sgbm`, `ops/bm.py` `lr_check`) and its speckle
filter (`filter_speckles`), and times each stage as that checkout runs it on
those arguments: 20 stages issued back to back between two CUDA events
(`ms_b2b`), chip_smoke.py's CUDA-event median of 51 single stages (`ms`),
and the device time and device operations (kernels, copies, fills) of a
stage and of the whole frame program (torch.profiler). One JSON line a
process: the card's name and power limit, the checkout, the numbers.

`--ablate` builds copies of the checkout's `csrc/lr_resolve.cu` and
`csrc/histogram.cu` into `build/sweep/`, each with a part taken out or
another compile-time constant, and reads each copy's device time a call
(torch.profiler, 20 calls) through its library's entry point:

- K6's SGBM entry on the captured inputs at 1920x1080 D=256 and 1280x720:
  as is at 1, 2, 4 and 8 pixels a thread by 1, 2 and 4 rows a block (where
  a block holds them); at the wrapper's plan without its two block
  barriers, without the shared-memory atomics (a plain store), without
  the read-backs; beside the general entry on the int32 planes the plain
  check builds (the design before this entry);
- K7's speckle entry (memset, count, decision) on the SGM-8 720p frame's
  speckle labels, a constant-disparity frame (one root) and a checkerboard
  of one-pixel components: as is at tiles of 1, 2 and 4 rows and of 512,
  1024 and 2048 pixels; at the wrapper's tile without the shared table
  (each warp's run to a global atomic), with tables of 512 and 2048 slots,
  with 8 probes in place of 2, with scalar loads in place of whole words.

Each case also gives the wrapper's device time by device operation (the
memset and each kernel).

The outputs of a copy with a part taken out are wrong by design; only its
time is read. The copies as is are checked equal to the wrappers.
"""

from __future__ import annotations

import importlib
import sys

import numpy as np
import torch_timing as tt

#: (name, chip_smoke._engine arguments) of the timed paths
PATHS = (("SGM-8 720p", ("sgm", 1280, 720)),
         ("SGM-8 1080p D=256", ("sgm", 1920, 1080, 0, 256)),
         ("MODE_SGBM 720p", ("sgm", 1280, 720, 0, 128, 5)),
         ("BM-128 720p", ("bm", 1280, 720)))


def _capture(cs, torch, args):
    """(engine, frame pair, {stage: (function, args)}) of a path: the LR
    check's and the speckle filter's calls of one frame program."""
    eng = cs._engine(*args)
    w, h = args[1:3]
    lnp, rnp, _, _ = cs._source(w, h).render(0)
    pair = (torch.from_numpy(lnp).to("cuda"), torch.from_numpy(rnp).to("cuda"))
    mod = importlib.import_module("rt_depth_map_tpu_torch.ops."
                                  + ("bm" if args[0] == "bm" else "sgbm"))
    names = {"LR check": "lr_check" if args[0] == "bm" else "lr_check_sgbm",
             "speckle": "filter_speckles"}
    stages = {}

    def keep(stage, fn):
        def kept(*a, **kw):
            stages[stage] = (fn, a, kw)
            return fn(*a, **kw)
        return kept

    originals = {n: getattr(mod, n) for n in names.values()}
    for stage, n in names.items():
        setattr(mod, n, keep(stage, originals[n]))
    try:
        eng.frame_program(*pair)
    finally:
        for n, fn in originals.items():
            setattr(mod, n, fn)
    torch.cuda.synchronize()
    return eng, pair, stages


def _child(root: str) -> dict:
    cs, torch = tt.setup(root)
    out = {"root": root, "card": cs._card()}
    for name, args in PATHS:
        eng, pair, stages = _capture(cs, torch, args)
        res = {}
        for stage, (fn, a, kw) in stages.items():
            call = (lambda fn=fn, a=a, kw=kw: fn(*a, **kw))
            dev_ms, ops = tt.device_profile(torch, call, frames=20)
            res[stage] = dict(ms_b2b=min(tt.b2b_ms(torch, call) for _ in range(3)),
                              ms=cs._time_ms(call, reps=51), device_ms=dev_ms,
                              device_ops=ops)
        dev_ms, ops = tt.device_profile(torch, lambda: eng.frame_program(*pair))
        res["frame"] = dict(device_ms=dev_ms, device_ops=ops)
        out[name] = res
        del eng, pair, stages
        torch.cuda.empty_cache()
    return out


#: (name, substitutions in lr_resolve.cu, (pixels a thread, rows a block)
#: or None for the wrapper's plan, compare)
LR_ABLATIONS = (
    [(f"as is, {px} pixels a thread, {rows} rows a block", [], (px, rows), True)
     for px in (1, 2, 4, 8) for rows in (1, 2, 4)]
    + [("no block barriers", [("  __syncthreads();\n", "")], None, False),
       ("no shared-memory atomics", [("atomicMin(&row[x - dd], key);",
                                      "row[x - dd] = key;")], None, False),
       ("no read-backs", [("const int a = lr_read(row, x, d_lo, p), b = lr_read(row, x, d_hi, p);",
                           "const int a = d_lo + (x & 1), b = d_hi;")], None, False)])

#: (name, substitutions in histogram.cu, pixels of a tile as (rows, pixels):
#: whole rows, or that many pixels where rows is 0; None for the wrapper's,
#: compare)
HIST_ABLATIONS = (
    [(f"as is, tiles of {r} rows", [], (r, 0), True) for r in (1, 2, 4)]
    + [(f"as is, tiles of {n} pixels", [], (0, n), True) for n in (512, 1024, 2048)]
    + [("no shared table", [("hist_add(keys, vals, key, total, counts);",
                             "atomicAdd(&counts[key], total);")], None, True),
       ("table of 512 slots", [("#define HIST_SLOTS_LOG2 7", "#define HIST_SLOTS_LOG2 9")],
        None, True),
       ("table of 2048 slots", [("#define HIST_SLOTS_LOG2 7", "#define HIST_SLOTS_LOG2 11")],
        None, True),
       ("8 probes", [("#define HIST_PROBES 2", "#define HIST_PROBES 8")], None, True),
       ("scalar loads", [("const bool vec = aligned(labels, 16) && aligned(active, 4);\n",
                          "const bool vec = false;\n")], None, True)])


def _builds(stem, ablations, entry, argtypes):
    """The (lib, fn) of each ablation, one build a distinct source."""
    distinct = list(dict.fromkeys(tuple(subs) for _, subs, _, _ in ablations))
    libs = tt.build_ablations(stem, [[(f"{stem}.cu", o, n) for o, n in subs]
                                     for subs in distinct], entry, argtypes)
    return [libs[distinct.index(tuple(subs))] for _, subs, _, _ in ablations]


def _timed(torch, call) -> dict:
    return dict(device_ms=tt.device_profile(torch, call, frames=20)[0],
                ms_b2b=min(tt.b2b_ms(torch, call) for _ in range(3)))


def _by_operation(torch, call, frames=20) -> dict:
    """Device ms a call of each device operation of `call` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            call()
        torch.cuda.synchronize()
    return {e.key[:60]: (getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / frames
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _ablate(root: str) -> dict:
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops.cc import connected_components_scan
    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda.histogram import HIST_TILE, speckle_decision
    from rt_depth_map_tpu_torch.ops.cuda.lr_resolve import (
        lr_key_planes_sgbm,
        lr_plan,
        lr_resolve,
        lr_resolve_sgbm,
    )

    P, I = _build.P, _build.I
    out = {"root": root, "card": cs._card(), "K6 lr_resolve_sgbm": {},
           "K7 speckle_decision": {}}
    lr_libs = _builds("lr_resolve", LR_ABLATIONS, "rtdm_lr_check_sgbm",
                      [P, P, P] + [I] * 9 + [P, P])
    h_libs = _builds("histogram", HIST_ABLATIONS, "rtdm_speckle_decision",
                     [P, P, I, I, I, P, P])

    speckle_in = {}
    for name, args in (PATHS[1], PATHS[0]):
        eng, pair, stages = _capture(cs, torch, args)
        _, (disp, best, minS, minX1, width1, D, md), _ = stages["LR check"]
        if name == "SGM-8 720p":
            speckle_in[f"{name} speckle labels"] = stages["speckle"][1]
        H, W = disp.shape
        ref = lr_resolve_sgbm(disp, best, minS, minX1, width1, D, md)
        res = {"plan (pixels a thread, threads a row, rows a block)": lr_plan(W)}
        for (what, _, plan, compare), (lib, fn) in zip(LR_ABLATIONS, lr_libs):
            px, rows = plan or lr_plan(W)[::2]
            if -(-W // px) > 1024 // rows:
                continue  # a block holds 1024 threads
            o = torch.empty_like(disp)

            def call(lib=lib, fn=fn, o=o, px=px, rows=rows, what=what):
                err = fn(disp.data_ptr(), best.data_ptr(), minS.data_ptr(), H, W,
                         minX1, width1, D, 0, md, px, rows, o.data_ptr(),
                         _build.stream_of(disp))
                _build.check(lib, err, what)

            call()
            torch.cuda.synchronize()
            if compare and not torch.equal(o, ref):
                raise AssertionError(f"K6 {what}: differs from the wrapper")
            res[what] = _timed(torch, call)
        res["the wrapper, by device operation"] = _by_operation(
            torch, lambda: lr_resolve_sgbm(disp, best, minS, minX1, width1, D, md))
        d_intW, keyW, reads, kw = lr_key_planes_sgbm(disp, best, minS, minX1, width1, D)
        res["the general entry on the int32 planes"] = _timed(
            torch, lambda: lr_resolve(d_intW, keyW, reads, **kw))
        out["K6 lr_resolve_sgbm"][f"{W}x{H} D={D}"] = res
        del eng, pair, stages, d_intW, keyW, reads
        torch.cuda.empty_cache()

    h, w = 720, 1280
    checker = torch.from_numpy(np.indices((h, w)).sum(0) % 2 == 0)
    for what, disp in (
            ("constant disparity", torch.full((h, w), 48, dtype=torch.int16)),
            ("checkerboard of one-pixel components",
             torch.where(checker, 16, 1040).to(torch.int16))):
        disp = disp.to("cuda")
        speckle_in[f"{w}x{h} {what}"] = (disp, -16, 100, 512)
    for case, (disp, new_val, max_size, max_diff) in speckle_in.items():
        act = disp != new_val
        labels = connected_components_scan(disp, act, max_diff)
        H, W = labels.shape
        ref = speckle_decision(labels, act, max_size)
        res = {"the wrapper, by device operation": _by_operation(
            torch, lambda: speckle_decision(labels, act, max_size))}
        for (what, _, tile, compare), (lib, fn) in zip(HIST_ABLATIONS, h_libs):
            rows, pixels = tile or (0, HIST_TILE)
            pixels = pixels or -(-rows * W // 4) * 4
            o = torch.empty_like(labels)

            def call(lib=lib, fn=fn, o=o, pixels=pixels, what=what):
                err = fn(labels.data_ptr(), act.data_ptr(), H * W, pixels, max_size,
                         o.data_ptr(), _build.stream_of(labels))
                _build.check(lib, err, what)

            call()
            torch.cuda.synchronize()
            if compare and not torch.equal(o, ref):
                raise AssertionError(f"K7 {what} on {case}: differs from the wrapper")
            res[what] = _timed(torch, call)
        out["K7 speckle_decision"][case] = res
    return out


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": _child, "--ablate-child": _ablate}))
