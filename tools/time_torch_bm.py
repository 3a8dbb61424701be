#!/usr/bin/env python3
"""Time the StereoBM cost + winner-take-all kernel (K8, `bm_cost_wta`) and
the BM frame program in one or more checkouts on one card, each checkout in
its own process, in the order given.

    python3 tools/time_torch_bm.py ROOT [ROOT ...]
    python3 tools/time_torch_bm.py --sweep ROOT
    python3 tools/time_torch_bm.py --ablate ROOT

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that drift of
the card over the call shows). A process imports the package of its ROOT
only, builds that checkout's kernels into its own `build/`, and times K8 on
chip_smoke.py's rectified synthetic frames through the BM engine's
rectification, prefiltered with pre_filter_cap 31, block size 13:

- 1280x720 at D=128 (the BM path's call) and D=192 (the reference's
  default number of disparities), 1920x1080 at D=256, each with
  chip_smoke.py's CUDA-event median of 51 calls (`ms`) and the time a call
  of 20 issued back to back between two events (`ms_b2b`: the host's work
  before each launch overlaps the previous kernel, so that figure is
  device time alone);
- the BM frame program at 1280x720, D=128: its host time (median of 10
  through a synchronise) and its device time a frame (torch.profiler,
  chip_smoke.py `_device_busy`).

It prints one JSON line a process: the card's name and power limit, the
checkout, and the numbers.

`--sweep` times the three K8 calls of one checkout, and 1920x1080 at
D=288 and 384, at launch plans other than `bm_plan`'s (warps a block, rows a
block), calling the library's entry point directly, each plan's outputs
checked equal to the wrapper's; one JSON line.

`--ablate` builds copies of the checkout's `csrc/bm_kernel.cu` into
`build/sweep/bm_kernel/`, each with one part taken out (the output stores, the
vertical update, the row copies, the winner), and times the 1280x720 D=128
call of each at the wrapper's plan beside the source as it stands. The
outputs of an ablated copy are wrong by design; only its time is read. It
also times copies with other compile-time constants (pixel runs a warp
slides side by side, columns a thread loads before it stores). One JSON
line.
"""

from __future__ import annotations

import sys

import torch_timing as tt

BS = 13
#: (W, H, D, name) of the timed K8 calls
CALLS = ((1280, 720, 128, "720p D=128"), (1280, 720, 192, "720p D=192"),
         (1920, 1080, 256, "1080p D=256"))
#: --sweep's calls: also 1080p at D=288 and 384 (12 d a lane), which a
#: checkout before D > 256 was taken refuses
SWEEP_CALLS = CALLS + ((1920, 1080, 288, "1080p D=288"), (1920, 1080, 384, "1080p D=384"))
#: (warps, rows) a block tried by --sweep beside the plan's own
SWEEP = ((2, 24), (2, 40), (2, 48), (2, 56), (2, 64), (4, 32), (4, 48), (1, 32),
         (1, 48), (3, 24), (3, 48))


def _setup(root: str):
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.prefilter import xsobel_prefilter
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear

    dev = torch.device("cuda")

    def frames(w, h):
        """A BM engine, its first frame pair on the card, and the
        prefiltered rectified gray planes."""
        eng = cs._engine("bm", w, h)
        lnp, rnp, _, _ = cs._source(w, h).render(0)
        left = torch.from_numpy(lnp).to(dev)
        right = torch.from_numpy(rnp).to(dev)
        st = eng.state
        cap = st.matcher.pre_filter_cap
        lp = xsobel_prefilter(remap_bilinear(rgb_to_gray(left), st.left, plain=True), cap)
        rp = xsobel_prefilter(remap_bilinear(rgb_to_gray(right), st.right, plain=True), cap)
        return eng, (left, right), lp, rp

    return cs, torch, frames


def _plan(torch, h, w, d):
    from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_plan

    return bm_plan(h, w, d, BS, torch.cuda.get_device_properties(
        0).shared_memory_per_multiprocessor)


def _child(root: str) -> dict:
    cs, torch, frames = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_cost_wta

    out = {"card": cs._card(), "root": root, "ms": {}, "ms_b2b": {},
           "device_ms_a_frame": {}, "frame_ms": {}}
    for w, h, d, what in CALLS:
        eng, pair, lp, rp = frames(w, h)
        name = f"K8 {what}"
        out["ms"][name] = cs._time_ms(lambda: bm_cost_wta(lp, rp, d, BS), reps=51)
        out["ms_b2b"][name] = tt.b2b_ms(torch, lambda: bm_cost_wta(lp, rp, d, BS))
        if what == "720p D=128":
            out["frame_ms"]["BM 720p"] = cs._wall_ms(
                lambda: eng.frame_program(*pair), reps=10)
            out["device_ms_a_frame"]["BM 720p"] = cs._device_busy(
                lambda: eng.frame_program(*pair))[0]
        del eng, lp, rp
        torch.cuda.empty_cache()
    return out


def _caller(torch, lib, fn, lp, rp, d, warps, ty, tx, what):
    """One call of the library's entry point at `warps` warps and `ty` rows
    a block, tiles of `tx` columns, and its five outputs."""
    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import bm_smem

    H, W = lp.shape
    outs = [torch.empty((H, W), dtype=torch.int32, device=lp.device) for _ in range(5)]
    smem = bm_smem(tx, d, BS)

    def call():
        err = fn(lp.data_ptr(), rp.data_ptr(), H, W, d, BS, 0,
                 *[o.data_ptr() for o in outs], warps, ty, smem, _build.stream_of(lp))
        _build.check(lib, err, what)

    return call, outs


def _sweep(root: str) -> dict:
    cs, torch, frames = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda.bm_kernel import PIXELS_PER_WARP, _fn, bm_cost_wta

    lib, fn = _fn()
    out = {"card": cs._card(), "root": root, "plans": {}, "ms_b2b": {}}
    for w, h, d, what in SWEEP_CALLS:
        _, _, lp, rp = frames(w, h)
        key = f"K8 {what}"
        ref = bm_cost_wta(lp, rp, d, BS)
        plan = _plan(torch, h, w, d)
        out["plans"][key] = plan._asdict()
        res = {}
        for warps, ty in ((plan.warps, plan.ty),) + SWEEP:
            call, outs = _caller(torch, lib, fn, lp, rp, d, warps, ty,
                                 PIXELS_PER_WARP * warps, key)
            call()
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(outs, ref)):
                raise AssertionError(f"{key} warps {warps} rows {ty}: differs "
                                     f"from the wrapper")
            res[f"warps {warps} rows {ty}"] = min(tt.b2b_ms(torch, call) for _ in range(3))
        out["ms_b2b"][key] = res
        del lp, rp, ref
        torch.cuda.empty_cache()
    return out


#: the winner of one pixel after its lane's min key, and what takes its place
#: in an ablated copy: the min folded into the kept outputs, so that the keys
#: and costs stay live (the reductions, the shuffles and the selects go)
_WINNER = "  const int k1 = __reduce_min_sync(BM_FULL, kmin);\n"
_NO_WINNER = "  if (kmin == -7) keep.bd = lane;\n  return;\n" + _WINNER
#: the vertical update of one row, and its ablated form (V stays 0)
_VERTICAL = "    if ((has_new || has_old) && d16 < D) {"
_NO_VERTICAL = "    if ((has_new || has_old) && d16 < D && H < 0) {"
#: (name, [(old, new), ...][, f]): the ablated copies of csrc/bm_kernel.cu
#: (f: f times the plan's warps a block, for a copy with other pixels a warp)
ABLATIONS = [
    ("as is", []),
    ("no stores", [("    if (lane < n_pix) {", "    if (lane < n_pix && keep.bd == -7) {")]),
    ("no vertical update", [(_VERTICAL, _NO_VERTICAL)]),
    ("no row copies", [("    if (si + 1 < NR) stage(r + 1, true, aLn, aRn);",
                        "    if (si + 1 < NR) stage(r + 1, false, aLn, aRn);")]),
    ("no winner", [(_WINNER, _NO_WINNER)]),
    ("no winner, no vertical update", [
        (_WINNER, _NO_WINNER),
        (_VERTICAL, _NO_VERTICAL)]),
    ("vertical: no V loads or stores", [
        ("      v[u][0] = vp[0];\n      v[u][1] = vp[1];",
         "      v[u][0] = V8{{(uint32_t)cc[u], 1u, 2u, 3u}};\n"
         "      v[u][1] = V8{{4u, 5u, 6u, (uint32_t)cu}};"),
        ("      if (c + u * cstep < s.CW) {",
         "      if (c + u * cstep < s.CW && v[u][0].v[0] == 0x7531u) {")]),
    ("vertical: no ring loads", [
        ("      rn[u] = bm_load(Ln, Rn, cc[u], rq_n + cc[u]);",
         "      rn[u] = BmRow{(uint32_t)cc[u], {(uint32_t)rq_n, 3u, 5u, 7u, 9u}, 0x0123u};"),
        ("      ro[u] = bm_load(Lo, Ro, cc[u], rq_o + cc[u]);",
         "      ro[u] = BmRow{(uint32_t)rq_o, {(uint32_t)cc[u], 2u, 4u, 6u, 8u}, 0x1234u};")]),
    ("no block barriers", [("    __syncthreads();\n", "")]),
    ("vertical: no byte arithmetic", [
        ("      bm_absdiff16(rn[u], m[u], pn);\n      bm_absdiff16(ro[u], m[u], po);",
         "#pragma unroll\n      for (int k = 0; k < 8; ++k)\n"
         "        pn[k] = rn[u].w[k % 5] ^ rn[u].l ^ m[u][k % 4], po[k] = ro[u].w[k % 5] + ro[u].sel;")]),
    ("vertical: xor in place of __vabsdiffu4", [
        ("    const uint32_t a = __vabsdiffu4(l4, r) & m[j];",
         "    const uint32_t a = (l4 ^ r) & m[j];")]),
    ("vertical: masks and shifts in place of the widening __byte_perm", [
        ("    p[2 * j] = __byte_perm(a, 0, 0x4140);\n    p[2 * j + 1] = __byte_perm(a, 0, 0x4342);",
         "    p[2 * j] = a & 0x00ff00ffu;\n    p[2 * j + 1] = (a >> 8) & 0x00ff00ffu;")]),
    ("winner: no min_outside", [
        ("    if ((unsigned)(e[k] - best) > 2u) kout = min(kout, key[k]);",
         "    kout = min(kout, 0);"),
        ("  const int ko = __reduce_min_sync(BM_FULL, kout);",
         "  const int ko = kout;")]),
    ("winner: no c_m1, c_p1", [
        ("  sm = __shfl_sync(BM_FULL, sm, ((unsigned)(best - 1) / K) & 31);\n"
         "  sp = __shfl_sync(BM_FULL, sp, ((unsigned)(best + 1) / K) & 31);", "")]),
    ("winner: first reduction only", [
        ("  int kout = BM_BIGKEY;\n",
         "  keep.bd = lane == p ? best : keep.bd;\n"
         "  keep.k1 = lane == p ? k1 : keep.k1;\n  return;\n  int kout = BM_BIGKEY;\n")]),
    # not ablations: the same kernel with other compile-time constants, at
    # the plan's rows and tile width (f times its warps)
    ("variant: 16 pixels a warp", [("#define BM_PW 32 ", "#define BM_PW 16 ")], 2),
    ("variant: batches of 1 column", [("#define BM_BATCH 2 ", "#define BM_BATCH 1 ")]),
    ("variant: batches of 4 columns", [("#define BM_BATCH 2 ", "#define BM_BATCH 4 ")]),
]


def _ablate(root: str) -> dict:
    cs, torch, frames = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda import _build

    P, I = _build.P, _build.I
    libs = tt.build_ablations(
        "bm_kernel", [[("bm_kernel.cu", old, new) for old, new in subs]
                      for _, subs, *_ in ABLATIONS],
        "rtdm_bm_cost_wta", [P, P, I, I, I, I, I, P, P, P, P, P, I, I, I, P])
    w, h, d, what = CALLS[0]
    _, _, lp, rp = frames(w, h)
    plan = _plan(torch, h, w, d)
    res = {}
    for (name, _, *more), (lib, fn) in zip(ABLATIONS, libs):
        # a copy with other pixels a warp takes f times the warps, so that
        # its tile is the plan's
        warps = int(plan.warps * (more[0] if more else 1))
        call, _ = _caller(torch, lib, fn, lp, rp, d, warps, plan.ty, plan.tx, name)
        res[name] = min(tt.b2b_ms(torch, call) for _ in range(3))
    return {"card": cs._card(), "root": root,
            "ms_b2b": {f"K8 {what}, warps {plan.warps} rows {plan.ty}": res}}


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {
        "--child": _child, "--sweep-child": _sweep, "--ablate-child": _ablate}))
