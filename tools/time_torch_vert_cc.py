#!/usr/bin/env python3
"""Time the port's vertical SGM kernels and K2 in one or more checkouts on
one card, each checkout in its own process, in the order given.

    python3 tools/time_torch_vert_cc.py ROOT [ROOT ...]

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that drift of
the card over the call shows). A process imports the package of its ROOT
only, builds that checkout's kernels into its own `build/`, and times, with
chip_smoke.py's CUDA-event median of 51 launches, on chip_smoke.py's
rectified synthetic frames:

- K2 on the 1280x720 frame mask (four 8-connected fields), as
  `connected_components_bbox` calls it;
- K3 (`sgm_cost_volume`, min_disparity 0) at 1280x720 D=128 and at the
  1920x1080 D=256 stretch point;
- K5 (`sgm_vert_wta`) on the 1280x720 D=128 volume and its horizontal sum;
- K9c (`sgm_vert_pass`, top-down + the horizontal partial) and K9d
  (`sgm_final_wta`: bottom-up on K9c's sum, the 8-path finish; top-down on
  the horizontal sum, MODE_SGBM's finish) at 1280x720 D=128 and at the
  1920x1080 D=256 stretch point, and K11 (int32, bottom-up + partial) at
  the stretch point.

It prints one JSON line a process: the card's name and power limit, the
checkout, and the milliseconds of each case (`ms`), and beside them the
time a call of 20 issued back to back between two events (`ms_b2b`): there
the host's work before each launch overlaps the previous kernel, so that
figure is device time alone.
"""

from __future__ import annotations

import sys

import torch_timing as tt


def _child(root: str) -> dict:
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.cc import connected_components_bbox
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import sgm_cost_volume
    from rt_depth_map_tpu_torch.ops.cuda.sgm_hdw import (
        sgm_final_wta,
        sgm_horiz_pass,
        sgm_vert_pass,
    )
    from rt_depth_map_tpu_torch.ops.cuda.sgm_horiz import sgm_horiz
    from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import sgm_vert_wta
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear

    dev = torch.device("cuda")
    out = {"card": cs._card(), "root": root, "ms": {}, "ms_b2b": {}}

    def time(name, fn):
        """chip_smoke's median of fn, and fn issued 20 times back to back."""
        out["ms"][name] = cs._time_ms(fn, reps=51)
        out["ms_b2b"][name] = tt.b2b_ms(torch, fn)

    def frames(w, h, d):
        eng = cs._engine("sgm", w, h, d=d)
        lnp, rnp, _, _ = cs._source(w, h).render(0)
        left = torch.from_numpy(lnp).to(dev)
        right = torch.from_numpy(rnp).to(dev)
        st = eng.state
        lr = remap_bilinear(rgb_to_gray(left), st.left, plain=True)
        rr = remap_bilinear(rgb_to_gray(right), st.right, plain=True)
        m = st.matcher
        pc = m.pre_filter_cap
        lpl, rpl = sg.plane_stack(lr, pc), sg.plane_stack(rr, pc)
        dt = sg.volume_dtype(cs.BS, pc)
        time(f"K3 {w}x{h} D={d}", lambda: sgm_cost_volume(lpl, rpl, d, cs.BS, dt))
        C = sgm_cost_volume(lpl, rpl, d, cs.BS, dt)[0]
        return eng, left, right, C, m.p1, max(m.p2, m.p1 + 1), m.uniqueness_ratio

    eng, left, right, C, p1, p2, ur = frames(cs.W, cs.H, cs.D)
    mask = eng.frame_program(left, right, plain=True)["mask"] != 0
    time("K2 720p frame mask", lambda: connected_components_bbox(mask, 8))
    Sh = sg.swap_pixel_axes(sgm_horiz(sg.swap_pixel_axes(C), p1, p2))
    time("K5 720p D=128", lambda: sgm_vert_wta(C, Sh, p1, p2, ur))
    del Sh, eng

    def chained(C, what):
        hf = sgm_horiz_pass(C, p1, p2)
        h2 = sgm_horiz_pass(C, p1, p2, True, hf)
        time(f"K9c {what} top-down + partial",
             lambda: sgm_vert_pass(C, p1, p2, partial=h2))
        Sa = sgm_vert_pass(C, p1, p2, partial=h2)
        time(f"K9d {what} bottom-up",
             lambda: sgm_final_wta(C, Sa, p1, p2, ur, True))
        time(f"K9d {what} top-down (MODE_SGBM)",
             lambda: sgm_final_wta(C, h2, p1, p2, ur, False))
        return h2

    chained(C, "720p D=128")
    del C
    h, w, d = cs.STRETCH
    _, _, _, C, p1, p2, ur = frames(w, h, d)
    h2 = chained(C, "1080p D=256")
    Ci, hi = C.to(torch.int32), h2.to(torch.int32)
    del C, h2
    time("K11 1080p D=256 int32 bottom-up + partial",
         lambda: sgm_vert_pass(Ci, p1, p2, True, hi))
    return out


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": _child}))
