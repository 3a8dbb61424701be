#!/usr/bin/env python3
"""Time the WLS post filter's smoother kernel (`tridiag_smooth`,
`csrc/wls.cu`) and the post-filter frame programs in one or more checkouts
on one card, each checkout in its own process, in the order given.

    python3 tools/time_torch_wls.py ROOT [ROOT ...]
    python3 tools/time_torch_wls.py --ablate ROOT

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` with
the post filter and `chip_smoke.py`. A process imports the package of its
ROOT only and builds that checkout's kernels into its own `build/`. For
each of three synthetic 1280x720 scenes (chip_smoke.py's blurred texture
"default", the unblurred texture "fine", the eight overlapping objects
"occlusion"; seed 11) it takes the WLS inputs of the rectified frame (the
SGM-8 D=128 matchers' left and right disparities, the confidence floored as
the smoother floors it, the left view as the guide) and reports the share
of the row sweeps' weights c = lambda * w below 2^-100 (the steps whose
stored cp the kernel divides on its scaled path) and the share of 16-step
chunks holding a weight below 2^-60 (the chunks the smoother's first range
check computed twice); the same for the default scene's inputs under the
"fine" scene's left view as the camera gives it (unrectified: its
unblurred texture puts a weight below 2^-60 in most chunks). It times, 20
calls back to back between two CUDA events (`ms_b2b`) and torch.profiler's
device time a call (`device_ms`):

- one sweep along the rows (the wrapper transposes its planes) and one
  along the columns at the first sweep's lambda;
- `fast_global_smoother` (six sweeps) and `wls_filter`;
- the SGM-8 and BM-128 frame programs with the post filter on: host time
  (median of 10 through a synchronise) and device time a frame;

and, on the default scene, one scanline alone (a 1280-pixel row and a
720-pixel column as one thread's chain): the latency floor of a sweep.
It prints one JSON line a process: the card's name and power limit, the
checkout, and the numbers.

`--ablate` builds copies of the checkout's `csrc/wls.cu` into
`build/sweep/wls/`, each with one part taken out or one constant changed
(the chain's divides as __fdiv_rn or __fdividef, the scaled path, the first
range check, the range check or its form with branches, the scratch stores,
the back substitution, the weight's expf, the chunks of steps loaded ahead,
the threads a block), and times each copy's row sweep on each scene and
under the unrectified "fine" guide, and one 1280-pixel scanline, beside the
source as it stands. An ablated copy's
outputs are wrong by design; only its time is read. One JSON line.
"""

from __future__ import annotations

import ctypes
import sys

import torch_timing as tt

_STORES = ("        cp[i0 + (size_t)k * M] = (tiny >> k) & 1u ? den : cpv;\n"
           "        dp[i0 + (size_t)k * M] = dpv;\n")
_BACK = ("        u = __fmaf_rn(-bc.cp[k], u, bc.dp[k]);\n"
         "        out[i0 + (size_t)k * M] = u;\n")
_EXP = "expf(__fmul_rn(-(float)abs(cur.g[k + 1] - cur.g[k]), rcp_sigma))"
_DIVS = ("        cpv = wls_quot(cc[k], den, r2);\n"
         "        dpv = wls_quot(num, den, r2);\n")
_SCALED = "      if (ok && tiny) {\n"
_PIVOT = ("        cp[i0 + (size_t)k * M] = (tiny >> k) & 1u ? den : cpv;\n"
          "        dp[i0 + (size_t)k * M] = dpv;\n"
          "        if ((tiny >> k) & 1u) out[i0 + (size_t)k * M] = cc[k];\n",
          "        cp[i0 + (size_t)k * M] = cpv;\n"
          "        dp[i0 + (size_t)k * M] = dpv;\n")
_CHECK = "        ok = ok & wls_den_ok(den) & wls_num_ok(num);\n"
_TINY = "      tiny |= (unsigned)((cc[k] != 0.0f) & (fabsf(cc[k]) < 0x1p-100f)) << k;\n"
#: (name, [(old, new), ...]): the copies of csrc/wls.cu that --ablate times
ABLATIONS = [
    ("as is", []),
    ("IEEE divides (__fdiv_rn) in the chain",
     [(_DIVS, "        cpv = __fdiv_rn(cc[k], den);\n        dpv = __fdiv_rn(num, den);\n"),
      (_SCALED, "      if (false) {\n"), _PIVOT]),
    ("fast divides (__fdividef)",
     [(_DIVS, "        cpv = __fdividef(cc[k], den);\n        dpv = __fdividef(num, den);\n"),
      (_SCALED, "      if (false) {\n"), _PIVOT]),
    ("no scaled path", [(_SCALED, "      if (false) {\n"), _PIVOT]),
    ("scaled path inlined", [("__device__ __noinline__ float wls_store_tiny",
                              "__device__ __forceinline__ float wls_store_tiny")]),
    ("first range check (a chunk with |c| below 2^-60 computed twice)",
     [(_TINY, "      ok = ok & ((cc[k] == 0.0f) | (fabsf(cc[k]) >= 0x1p-60f));\n")]),
    ("no range check", [(_CHECK, "")]),
    ("range check with branches (&&)",
     [(_CHECK, "        ok = ok && wls_den_ok(den) && wls_num_ok(num);\n")]),
    ("no scratch stores", [(_STORES, "        if (cpv == 1234.5f) cp[i0] = dpv;\n")]),
    ("no back substitution", [(_BACK, "        u += bc.dp[k];\n"),
                              ("    bc = bn;\n  }\n",
                               "    bc = bn;\n  }\n  out[m] = u;\n")]),
    ("no expf", [(_EXP, "__fmul_rn((float)abs(cur.g[k + 1] - cur.g[k]), rcp_sigma)")]),
    ("chunk of 8 steps", [("#define WLS_CHUNK 16 ", "#define WLS_CHUNK 8 ")]),
    ("chunk of 32 steps", [("#define WLS_CHUNK 16 ", "#define WLS_CHUNK 32 ")]),
    ("back chunk of 16 steps", [("#define WLS_BACK 32 ", "#define WLS_BACK 16 ")]),
    ("64 threads a block", [("#define WLS_THREADS 32\n", "#define WLS_THREADS 64\n")]),
]
SCENES = ("default", "fine", "occlusion")


def _inputs(cs, torch, scene: str):
    """(x, floored weight, guide, left disparity, right disparity, matcher
    config, left and right camera images) of `scene`'s rectified 720p
    frame."""
    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops import wls as wls_ops
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda.remap import rectify_pair

    W, H = cs.W, cs.H
    eng = cs._engine("sgm", W, H)
    left, right, _, _ = cs._source(W, H, scene=scene).render(0)
    left = torch.from_numpy(left).to("cuda")
    right = torch.from_numpy(right).to("cuda")
    st = eng.state
    lrect, _, rrect = rectify_pair(rgb_to_gray(left), left, rgb_to_gray(right),
                                   st.left, st.right)
    m = st.matcher
    dl = sg.stereo_sgbm(lrect, rrect, m)
    dr = sg.stereo_sgbm(rrect, lrect, wls_ops.right_matcher_config(m))
    x, w, _ = wls_ops.smoother_inputs(dl, dr, m)
    cf = torch.clamp(w, min=wls_ops.CONF_FLOOR)
    return x, cf, lrect, dl, dr, m, left, right


def _raw_fine(cs, torch):
    """The "fine" scene's left view as the camera gives it, gray: an
    unblurred texture that rectification has not smoothed."""
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray

    left = cs._source(cs.W, cs.H, scene="fine").render(0)[0]
    return rgb_to_gray(torch.from_numpy(left).to("cuda"))


def _weights(torch, guide, lam) -> dict:
    """The row sweeps' weight shares of one guide: c below 2^-100 (not 0),
    and the 16-step chunks holding a c below 2^-60 (not 0)."""
    from rt_depth_map_tpu_torch.ops.cuda.wls import rcp

    g = guide.t().to(torch.float32)  # a row sweep's scanlines are columns here
    c = lam * torch.exp(-(g[1:] - g[:-1]).abs() * rcp(1.5))
    tiny = (c > 0) & (c < 2.0 ** -100)
    low = (c > 0) & (c < 2.0 ** -60)
    n = low.shape[0] // 16 * 16
    chunks = low[:n].reshape(n // 16, 16, -1).any(dim=1)
    return {"weights below 2^-100": float(tiny.float().mean()),
            "16-step chunks with a weight below 2^-60": float(chunks.float().mean())}


def _timed(torch, call) -> dict:
    return dict(device_ms=tt.device_profile(torch, call, frames=20)[0],
                ms_b2b=min(tt.b2b_ms(torch, call) for _ in range(3)))


def _child(root: str) -> dict:
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops import wls as wls_ops
    from rt_depth_map_tpu_torch.ops.cuda.wls import tridiag_smooth

    lam = wls_ops.sweep_lambdas()[0]
    out = {"card": cs._card(), "root": root}
    engines = {kind: cs._engine(kind, cs.W, cs.H, post_filter=True)
               for kind in ("sgm", "bm")}
    for scene in SCENES:
        x, cf, g, dl, dr, m, left, right = _inputs(cs, torch, scene)
        res = _weights(torch, g, lam)
        res["rows"] = _timed(torch, lambda: tridiag_smooth(x, cf, g, lam, 1.5, 1))
        res["columns"] = _timed(torch, lambda: tridiag_smooth(x, cf, g, lam, 1.5, 0))
        if scene == "default":
            for n, t_ in ((cs.W, True), (cs.H, False)):
                line = [(a.t() if t_ else a)[:, :1].contiguous() for a in (x, cf, g)]
                res[f"one scanline of {n}"] = _timed(
                    torch, lambda line=line: tridiag_smooth(*line, lam, 1.5, 0))
        res["fast_global_smoother"] = _timed(
            torch, lambda: wls_ops.fast_global_smoother(x, g, cf))
        res["wls_filter"] = _timed(torch, lambda: wls_ops.wls_filter(dl, dr, g, m))
        for kind, eng in engines.items():
            call = lambda eng=eng: eng.frame_program(left, right)  # noqa: E731
            res[f"{kind} + WLS frame"] = dict(
                frame_ms=cs._wall_ms(call, reps=10),
                device_ms=tt.device_profile(torch, call)[0])
        out[scene] = res
        if scene == "default":
            raw = _raw_fine(cs, torch)
            res = _weights(torch, raw, lam)
            res["rows"] = _timed(torch, lambda: tridiag_smooth(x, cf, raw, lam, 1.5, 1))
            out["default, unrectified fine guide"] = res
    return out


def _ablate(root: str) -> dict:
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops import wls as wls_ops
    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda.wls import rcp

    lam = wls_ops.sweep_lambdas()[0]
    P, I, F = _build.P, _build.I, ctypes.c_float
    libs = tt.build_ablations(
        "wls", [[("wls.cu", old, new) for old, new in subs] for _, subs in ABLATIONS],
        "rtdm_wls_tridiag_cols", [P, P, P, I, I, F, F, P, P, P, P])
    planes = {}
    for scene in SCENES:
        x, cf, g = _inputs(cs, torch, scene)[:3]
        planes[f"row sweep 1280x720, {scene}"] = [a.t().contiguous() for a in (x, cf, g)]
        if scene == "default":
            planes["one scanline of 1280"] = [a.t()[:, :1].contiguous() for a in (x, cf, g)]
            planes["row sweep 1280x720, default, unrectified fine guide"] = [
                a.t().contiguous() for a in (x, cf, _raw_fine(cs, torch))]
    res = {}
    for (name, _), (lib, fn) in zip(ABLATIONS, libs):
        row = {}
        for what, (xs, cs_, gs) in planes.items():
            N, M = xs.shape
            bufs = [torch.empty_like(xs) for _ in range(3)]

            def call(lib=lib, fn=fn, xs=xs, cs_=cs_, gs=gs, N=N, M=M, bufs=bufs):
                err = fn(xs.data_ptr(), cs_.data_ptr(), gs.data_ptr(), N, M, lam,
                         rcp(1.5), *[b.data_ptr() for b in bufs],
                         _build.stream_of(xs))
                _build.check(lib, err, name)

            row[what] = min(tt.b2b_ms(torch, call) for _ in range(3))
        res[name] = row
    return {"card": cs._card(), "root": root, "ms_b2b": res}


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": _child, "--ablate-child": _ablate}))
