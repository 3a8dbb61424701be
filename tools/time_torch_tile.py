#!/usr/bin/env python3
"""Time the exact width tiling's kernels (`sgm_tile_scan` and
`sgm_tile_final`, `csrc/sgm_tile.cu`) in one or more checkouts on one card,
each checkout in its own process, in the order given.

    python3 tools/time_torch_tile.py ROOT [ROOT ...]
    python3 tools/time_torch_tile.py --ablate ROOT

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that drift of
the card over the call shows). A process imports the package of its ROOT
only, builds that checkout's kernels into its own `build/`, and times, on
chip_smoke.py's rectified synthetic 1280x720 frame (D=128, int16 volume),
at the 720p tile of 2 ranks (tile 0: 720 x 576 x 128, 90-row blocks), as
chip_smoke.py phase 3 builds it:

- a steady wavefront step: the six cross-tile directions of 8 paths on
  their blocks (k = 4 from the left, 3 from the right), random carries,
  and a step whose directions lie on four blocks (k = 2, 1);
- the tile's last launch, `sgm_tile_final` (the vertical pair and the
  winner-take-all; also the top-down path alone, 5 and 4 paths);
- a rank's frame: every launch of tile 0's wavefront (K + n - 1 steps) and
  `sgm_tile_final`, at n = 1, 2 and 4 tiles (the carries random, no
  exchange), with its launches and its device ms and operations
  (torch.profiler), and the cross-tile steps alone.

It prints one JSON line a process: the card's name and power limit, the
checkout, the median of 15 calls (`ms`, CUDA events) and a call of 20
issued back to back between two events (`ms_b2b`: there the host's work
before each launch overlaps the previous kernel, so that figure is device
time alone).

`--ablate` builds copies of ROOT's `csrc/sgm_tile.cu` into
`build/sweep/sgm_tile/` and times each (20 calls back to back, the least
of 3) on the wavefront step, its 2 horizontal and its 4 diagonal jobs
alone, the step on four blocks, and a rank's cross-tile steps at n = 1, 2
and 4. The ablations take out a part of the scan: the atomic adds into S
become plain stores, or plain read-modify-writes, or go with the staging
in shared memory that feeds them (no adds at all), or the ring's waits
go. Their outputs are wrong by design; only their time
is read. The variants change a choice and stay right (their S, outboxes
and prevs are checked against the plain jobs): each lane adds its own
elements of L (no staging in shared memory), the staged adds made a step
later (the next recurrence between the staged reads and the adds), staged
adds on the diagonal jobs only, the register path at every D, the jobs'
lines in the order given (not the horizontal ones first).
"""

from __future__ import annotations

import sys

import torch_timing as tt

TILES = 2


def _setup(root: str):
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops import sgbm as sg
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray
    from rt_depth_map_tpu_torch.ops.cuda.sgm_cost import sgm_cost_volume
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear

    dev = torch.device("cuda")
    eng = cs._engine("sgm", cs.W, cs.H)
    lnp, rnp, _, _ = cs._source(cs.W, cs.H).render(0)
    st = eng.state
    lr = remap_bilinear(rgb_to_gray(torch.from_numpy(lnp).to(dev)), st.left, plain=True)
    rr = remap_bilinear(rgb_to_gray(torch.from_numpy(rnp).to(dev)), st.right, plain=True)
    m = st.matcher
    pc = m.pre_filter_cap
    C, _, W1 = sgm_cost_volume(sg.plane_stack(lr, pc), sg.plane_stack(rr, pc), cs.D,
                               cs.BS, sg.volume_dtype(cs.BS, pc))
    return cs, torch, C, W1, m.p1, max(m.p2, m.p1 + 1), m.uniqueness_ratio


def _strips(torch, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def strip(rows, d):
        return torch.randint(-500, 6000, (rows, d), generator=g,
                             dtype=torch.int32).to(dev)
    return strip


def _step_jobs(torch, Ct, strip, kf=4, kb=3):
    """chip_smoke.py phase 3's wavefront step on tile 0 of 2 (k = kf from
    the left, kb from the right: the steady step at 4, 3)."""
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import ScanJob
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import _default_row_block, cross_dirs

    H, wloc, D = Ct.shape
    rb = _default_row_block(H, TILES)
    jobs = []
    for dy, dx in cross_dirs(8):
        k = kf if dx == 1 else kb
        start = H - (k + 1) * rb if dy == -1 else k * rb
        jobs.append(ScanJob(dy, dx, start, rb, strip(rb + 1, D), strip(rb + 1, D),
                            strip(wloc, D)))
    return jobs


def _frame_steps(torch, Ct, n, strip):
    """The job lists of tile 0's wavefront on n tiles (exact_sgbm.py's
    schedule; random carries, no exchange)."""
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import ScanJob
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import _default_row_block, cross_dirs

    H, wloc, D = Ct.shape
    rb = _default_row_block(H, n)
    K = H // rb
    steps = []
    for t in range(K + n - 1):
        jobs = []
        for dy, dx in cross_dirs(8):
            k = t - (0 if dx == 1 else n - 1)
            if not 0 <= k < K:
                continue
            start = H - (k + 1) * rb if dy == -1 else k * rb
            jobs.append(ScanJob(dy, dx, start, rb, strip(rb + 1, D), strip(rb + 1, D),
                                strip(wloc, D)))
        if jobs:
            steps.append(jobs)
    return steps


def _child(root: str) -> dict:
    cs, torch, C, W1, p1, p2, ur = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import sgm_tile_final, sgm_tile_scan

    dev = C.device
    out = {"card": cs._card(), "root": root, "ms": {}, "ms_b2b": {}, "frame": {}}

    def time(name, fn):
        out["ms"][name] = cs._time_ms(fn)
        out["ms_b2b"][name] = tt.b2b_ms(torch, fn)

    strip = _strips(torch, dev, 3)
    Ct = C[:, : W1 // TILES].contiguous()
    S = torch.zeros(Ct.shape, dtype=torch.int32, device=dev)
    jobs = _step_jobs(torch, Ct, strip)
    time("wavefront step, 6 directions", lambda: sgm_tile_scan(Ct, S, jobs, p1, p2))
    apart = _step_jobs(torch, Ct, strip, 2, 1)
    time("a step on four blocks", lambda: sgm_tile_scan(Ct, S, apart, p1, p2))
    time("vertical pair + winner-take-all (sgm_tile_final)",
         lambda: sgm_tile_final(Ct, S, p1, p2, ur, ((1, 0), (-1, 0))))
    time("top-down path + winner-take-all (sgm_tile_final)",
         lambda: sgm_tile_final(Ct, S, p1, p2, ur, ((1, 0),)))
    del S
    for n in (1, 2, 4):
        Cn = C[:, : W1 // n].contiguous()
        steps = _frame_steps(torch, Cn, n, strip)
        Sn = torch.zeros(Cn.shape, dtype=torch.int32, device=dev)

        def cross(Cn=Cn, Sn=Sn, steps=steps):
            for js in steps:
                sgm_tile_scan(Cn, Sn, js, p1, p2)

        def frame(Cn=Cn, Sn=Sn, cross=cross):
            cross()
            return sgm_tile_final(Cn, Sn, p1, p2, ur, ((1, 0), (-1, 0)))

        name = f"a rank's scans + winner-take-all, {n} tile(s)"
        time(name, frame)
        time(f"a rank's cross-tile steps, {n} tile(s)", cross)
        dev_ms, ops = tt.device_profile(torch, frame)
        out["frame"][name] = {"launches": len(steps) + 1, "device_ms": dev_ms,
                              "device_ops": ops}
        del Sn, Cn
        torch.cuda.empty_cache()
    return out


#: the atomic add of a staged element, and what the ablations put there
_ADD = "    if (oq[k]) atomicAdd(Sp + 32 * k + lane, st[32 * k + lane]);"
_RING_WAIT = "      cp_async_wait<TS_RING - 1>();\n"
_ASYNC = "      if (D * sizeof(CT) % 16 == 0 && (uintptr_t)C % 16 == 0) {"
_ORDER = "      if ((desc[4 * i] == 0) != (horiz == 1)) continue;"
#: a step's staged adds, and the alternatives the variants take: each lane
#: adds its own elements (no staging); the staged L added a step later,
#: from two buffers a warp by step parity (the next recurrence between the
#: staged reads and the adds), the last one after the line
_STAGED = """    vb_put_lane<int32_t, K>(stage + d0, vec, ok, L);
    __syncwarp();  // the staged L is in the buffer for every lane
    ts_red<K>(S + pix, stage, lane, oq);
    __syncwarp();  // and read by every lane before the next step stages"""
_DIRECT = """#pragma unroll
    for (int k = 0; k < K; ++k)
      if (ok[k]) atomicAdd(S + pix + d0 + k, L[k]);"""
_STEP_HEAD = "    int L[K];\n    ts_step<K>(whole, c, carry, ok, d0, D, p1, p2, L);\n"
_LATER = [
    ("  auto step = [&](const int (&c)[K]) {\n",
     """  long long staged = -1;
  int parity = 0;
  auto later = [&]() {
    __syncwarp();
    if (staged >= 0) ts_red<K>(S + staged, stage + (parity ^ 1) * D, lane, oq);
  };
  auto step = [&](const int (&c)[K]) {
"""),
    (_STEP_HEAD + _STAGED, """    int L[K];
    __syncwarp();
    int v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = oq[k] ? stage[(parity ^ 1) * D + 32 * k + lane] : 0;
    ts_step<K>(whole, c, carry, ok, d0, D, p1, p2, L);
    if (staged >= 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (oq[k]) atomicAdd(S + staged + 32 * k + lane, v[k]);
    }
    vb_put_lane<int32_t, K>(stage + parity * D + d0, vec, ok, L);
    staged = pix;
    parity ^= 1;"""),
    ("(size_t)w * D;\n", "(size_t)w * 2 * D;\n"),
    ("ts_smem + (size_t)TS_WARPS * D * 4 +", "ts_smem + (size_t)TS_WARPS * 2 * D * 4 +"),
    ("const size_t stage = (size_t)TS_WARPS * D * 4;", "const size_t stage = (size_t)TS_WARPS * 2 * D * 4;"),
    ("        step(c);\n      }\n    }\n  }\n}\n", "        step(c);\n      }\n    }\n  }\n  later();\n}\n"),
]
#: (name, right, [(old, new), ...]): copies of the scan kernel; `right`:
#: its outputs are the kernel's (checked), else wrong by design
ABLATIONS = [
    ("as is", True, []),
    ("plain stores in place of the atomic adds", False,
     [(_ADD, "    if (oq[k]) Sp[32 * k + lane] = st[32 * k + lane];")]),
    ("plain read-modify-writes in place of the atomic adds", False,
     [(_ADD, "    if (oq[k]) Sp[32 * k + lane] += st[32 * k + lane];")]),
    ("no adds into S at all (nor staging)", False, [(_STAGED, "")]),
    ("no ring waits", False, [(_RING_WAIT, "")]),
    ("variant: each lane adds its own elements (no staging)", True, [(_STAGED, _DIRECT)]),
    ("variant: staged adds a step later", True, _LATER),
    ("variant: staged adds on the diagonal jobs only", True,
     [(_STAGED, "    if (dy == 0) {\n" + _DIRECT + "\n    } else {\n" + _STAGED
       + "\n    }")]),
    ("variant: the register path", True, [(_ASYNC, _ASYNC.replace("if (", "if (false && "))]),
    ("variant: the jobs' lines in the order given", True,
     [(_ORDER, "      if (horiz == 0) continue;")]),
]


def _ablate(root: str) -> dict:
    cs, torch, C, W1, p1, p2, ur = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda import sgm_tile as tile_mod

    dev = C.device
    Ct = C[:, : W1 // TILES].contiguous()
    strip = _strips(torch, dev, 3)
    jobs = _step_jobs(torch, Ct, strip)
    cases = {"wavefront step, 6 directions": (Ct, [jobs]),
             "its 2 horizontal jobs": (Ct, [[j for j in jobs if j.dy == 0]]),
             "its 4 diagonal jobs": (Ct, [[j for j in jobs if j.dy != 0]]),
             "a step on four blocks": (Ct, [_step_jobs(torch, Ct, strip, 2, 1)])}
    for n in (1, 2, 4):
        Cn = C[:, : W1 // n].contiguous()
        cases[f"a rank's cross-tile steps, {n} tile(s)"] = (
            Cn, _frame_steps(torch, Cn, n, strip))
    S = {id(Cv): torch.zeros(Cv.shape, dtype=torch.int32, device=dev)
         for Cv, _ in cases.values()}
    libs = tt.build_ablations(
        "sgm_tile", [[("sgm_tile.cu", old, new) for old, new in subs]
                     for _, _, subs in ABLATIONS],
        "rtdm_sgm_tile_scan", tile_mod.SCAN_ARGTYPES)
    res = {}
    for (name, right, _), (lib, fn) in zip(ABLATIONS, libs):
        def scan(Cv, js, Sv, fn=fn, lib=lib):
            results, err = tile_mod.launch_scan(fn, Cv, Sv, js, p1, p2)
            if err:
                raise RuntimeError(lib.rtdm_error_string(err).decode())
            return results

        res[name] = {case: min(tt.b2b_ms(torch, lambda Cv=Cv, steps=steps: [
            scan(Cv, js, S[id(Cv)]) for js in steps]) for _ in range(3))
            for case, (Cv, steps) in cases.items()}
        if right:  # S, the outboxes and the prevs against the plain jobs
            S0, S1 = torch.zeros_like(S[id(Ct)]), torch.zeros_like(S[id(Ct)])
            got = scan(Ct, jobs, S0)
            ref = tile_mod.sgm_tile_scan_plain(Ct, S1, jobs, p1, p2)
            res[name]["equals the plain jobs"] = bool(torch.equal(S0, S1) and all(
                (g is None and r is None) or torch.equal(g, r)
                for gr, rr in zip(got, ref) for g, r in zip(gr, rr)))
    return {"card": cs._card(), "root": root,
            "ms_b2b": {"720p tile of 2 (720 x 576 x 128, int16 C)": res}}


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": _child, "--ablate-child": _ablate}))
