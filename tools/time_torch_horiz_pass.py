#!/usr/bin/env python3
"""Time the chained route's horizontal SGM pass (K9a, `sgm_horiz_pass`) and
the frame programs around it in one or more checkouts on one card, each
checkout in its own process, in the order given.

    python3 tools/time_torch_horiz_pass.py ROOT [ROOT ...]
    python3 tools/time_torch_horiz_pass.py --sweep ROOT

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that drift of
the card over the call shows). A process imports the package of its ROOT
only, builds that checkout's kernels into its own `build/`, and times, on
chip_smoke.py's rectified synthetic frames (int16 cost volumes from K3):

- the route's two K9a calls, left to right and right to left + the first
  call's output as the partial, at the 1920x1080 D=256 stretch point (the
  8-path chained route) and at 1280x720 D=128 (cv2 MODE_SGBM's calls), with
  chip_smoke.py's CUDA-event median of 51 calls (`ms`) and the time a call
  of 20 issued back to back between two events (`ms_b2b`: the host's work
  before each launch overlaps the previous kernel, so that figure is
  device time alone);
- K4 (`sgm_horiz`, which shares K9a's SGM step) at 1280x720 D=128, timed
  as the K9a calls;
- the device time a frame (torch.profiler, chip_smoke.py `_device_busy`)
  of the stretch point's and MODE_SGBM's frame programs, and the flagship
  SGM-8 1280x720 frame program's host time (median of 10 through a
  synchronise) and device time.

It prints one JSON line a process: the card's name and power limit, the
checkout, and the numbers.

`--sweep` times the four K9a calls of one checkout at every launch plan
the kernel takes (ring of 4, 8 or 16 slots a warp, 1, 2 or 4 rows a
block), calling the library's entry point directly, each plan's output
checked equal to the wrapper's; one JSON line.

`--ablate` builds copies of the checkout's `csrc/sgm_hdw.cu` and headers
into `build/sweep/`, each with one part of the scan's step taken out (the
stores, the copies, the wait on them, the warp's min reduction), and times
the left-to-right call of each on random int16 volumes of the two frame
shapes at the wrapper's plan, beside the source as it stands. The outputs
of an ablated copy are wrong by design; only its time is read. One JSON
line.
"""

from __future__ import annotations

import sys

import torch_timing as tt


def _setup(root: str):
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import sgm_cost_volume
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear

    dev = torch.device("cuda")

    def frames(w, h, d, num_paths=8):
        """An engine, its first frame pair on the card, the int16 cost
        volume of the rectified pair, and P1, P2."""
        eng = cs._engine("sgm", w, h, d=d, num_paths=num_paths)
        lnp, rnp, _, _ = cs._source(w, h).render(0)
        left = torch.from_numpy(lnp).to(dev)
        right = torch.from_numpy(rnp).to(dev)
        st = eng.state
        lr = remap_bilinear(rgb_to_gray(left), st.left, plain=True)
        rr = remap_bilinear(rgb_to_gray(right), st.right, plain=True)
        m = st.matcher
        pc = m.pre_filter_cap
        C = sgm_cost_volume(sg.plane_stack(lr, pc), sg.plane_stack(rr, pc), d,
                            cs.BS, sg.volume_dtype(cs.BS, pc))[0]
        return eng, (left, right), C, m.p1, max(m.p2, m.p1 + 1)

    return cs, torch, frames


def _child(root: str) -> dict:
    cs, torch, frames = _setup(root)
    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import sgm_horiz_pass
    from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz

    out = {"card": cs._card(), "root": root, "ms": {}, "ms_b2b": {},
           "device_ms_a_frame": {}, "frame_ms": {}}

    def time(name, fn):
        out["ms"][name] = cs._time_ms(fn, reps=51)
        out["ms_b2b"][name] = tt.b2b_ms(torch, fn)

    sh, sw, sd = cs.STRETCH
    for (w, h, d), what, paths in (((sw, sh, sd), "1080p D=256", 8),
                                   ((cs.W, cs.H, cs.D), "720p D=128", 5)):
        eng, pair, C, p1, p2 = frames(w, h, d, paths)
        hf = sgm_horiz_pass(C, p1, p2)
        time(f"K9a {what} L->R", lambda: sgm_horiz_pass(C, p1, p2))
        time(f"K9a {what} R->L + partial",
             lambda: sgm_horiz_pass(C, p1, p2, True, hf))
        del C, hf
        name = "stretch" if paths == 8 else "MODE_SGBM"
        out["device_ms_a_frame"][name] = cs._device_busy(
            lambda: eng.frame_program(*pair))[0]
        del eng
        torch.cuda.empty_cache()
    eng, pair, C, p1, p2 = frames(cs.W, cs.H, cs.D)
    # K4 (the bidir route's horizontal kernel) shares the SGM step
    Ct = sg.swap_pixel_axes(C)
    time("K4 720p D=128", lambda: sgm_horiz(Ct, p1, p2))
    del C, Ct
    out["frame_ms"]["flagship SGM-8 720p"] = cs._wall_ms(
        lambda: eng.frame_program(*pair), reps=10)
    out["device_ms_a_frame"]["flagship SGM-8 720p"] = cs._device_busy(
        lambda: eng.frame_program(*pair))[0]
    return out


def _sweep(root: str) -> dict:
    cs, torch, frames = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
        HORIZ_RINGS,
        _fn,
        horiz_pass_plan,
        sgm_horiz_pass,
    )

    P, I = _build.P, _build.I
    lib, fn = _fn("rtdm_sgm_horiz_pass", [P, I, P, P, I, I, I, I, I, I, I, I, I, P])
    out = {"card": cs._card(), "root": root, "plans": {}, "ms_b2b": {}}
    sh, sw, sd = cs.STRETCH
    for (w, h, d), what in (((sw, sh, sd), "1080p D=256"),
                            ((cs.W, cs.H, cs.D), "720p D=128")):
        _, _, C, p1, p2 = frames(w, h, d)
        H, W1, D = C.shape
        hf = sgm_horiz_pass(C, p1, p2)
        for rev, part, case in ((False, None, "L->R"), (True, hf, "R->L + partial")):
            ref = sgm_horiz_pass(C, p1, p2, rev, part)
            key = f"K9a {what} {case}"
            out["plans"][key] = horiz_pass_plan(
                D, 2, part is not None, H,
                torch.cuda.get_device_properties(0).multi_processor_count)._asdict()
            res = {}
            for ring in HORIZ_RINGS:
                for rows in (1, 2, 4):
                    got = torch.empty_like(C)

                    def call():
                        err = fn(C.data_ptr(), 2,
                                 None if part is None else part.data_ptr(),
                                 got.data_ptr(), H, W1, D, 0, int(rev), p1, p2,
                                 ring, rows, _build.stream_of(C))
                        _build.check(lib, err, key)

                    call()
                    torch.cuda.synchronize()
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{key} ring {ring} rows {rows}: "
                                             f"differs from the wrapper")
                    res[f"ring {ring} rows {rows}"] = min(
                        tt.b2b_ms(torch, call) for _ in range(3))
            out["ms_b2b"][key] = res
        del C, hf
        torch.cuda.empty_cache()
    return out


#: (name, [(file, old, new), ...]): the ablated copies of the scan
ABLATIONS = [
    ("as is", []),
    ("no stores but the last pixel's", [(
        "sgm_hdw.cu", "    vb_put_lane<T, K>(out, vec_out, ok, L);",
        "    if (s == W1 - 1) vb_put_lane<T, K>(out, vec_out, ok, L);")]),
    ("no copies", [("sgm_hdw.cu", "      fetch(s + RING - 1, f_off, f_slot);\n", ""),
                   ("sgm_hdw.cu", "      fetch(f, f_off, f_slot);\n", "")]),
    ("no copies, no stores", [
        ("sgm_hdw.cu", "      fetch(s + RING - 1, f_off, f_slot);\n", ""),
        ("sgm_hdw.cu", "      fetch(f, f_off, f_slot);\n", ""),
        ("sgm_hdw.cu", "    vb_put_lane<T, K>(out, vec_out, ok, L);",
         "    if (s == W1 - 1) vb_put_lane<T, K>(out, vec_out, ok, L);")]),
    ("no wait on the copies", [
        ("sgm_hdw.cu", "      cp_async_wait<RING - 1>();\n", "")]),
    ("no warp min reduction", [
        ("sgm_path.cuh", "const int minLp = __reduce_min_sync(SGM_FULL, mn);",
         "const int minLp = mn;")]),
]


def _ablate(root: str) -> dict:
    cs, torch = tt.setup(root)
    import numpy as np

    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import horiz_pass_plan

    P, I = _build.P, _build.I
    libs = tt.build_ablations("sgm_hdw", [subs for _, subs in ABLATIONS],
                              "rtdm_sgm_horiz_pass", [P, I, P, P] + [I] * 9 + [P])
    rng = np.random.default_rng(0)
    out = {"card": cs._card(), "root": root, "ms_b2b": {}}
    sh, sw, sd = cs.STRETCH
    for H, W1, D, what in ((sh, sw - sd, sd, "1080p D=256"),
                           (cs.H, cs.W - cs.D, cs.D, "720p D=128")):
        C = torch.from_numpy(rng.integers(0, 2300, (H, W1, D), dtype=np.int16)).cuda()
        O = torch.empty_like(C)
        plan = horiz_pass_plan(D, 2, False, H,
                               torch.cuda.get_device_properties(0).multi_processor_count)
        res = {}
        for (name, _), (lib, fn) in zip(ABLATIONS, libs):
            def call():
                err = fn(C.data_ptr(), 2, None, O.data_ptr(), H, W1, D, 0, 0, 600,
                         2400, plan.ring, plan.rows, _build.stream_of(C))
                _build.check(lib, err, name)
            res[name] = min(tt.b2b_ms(torch, call) for _ in range(3))
        out["ms_b2b"][f"K9a {what} L->R, ring {plan.ring} rows {plan.rows}"] = res
        del C, O
    return out


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {
        "--child": _child, "--sweep-child": _sweep, "--ablate-child": _ablate}))
