#!/usr/bin/env python3
"""Time the exact width tiling's scan kernel (`sgm_tile_scan`,
`csrc/sgm_tile.cu`) and the winner-take-all after it in one or more
checkouts on one card, each checkout in its own process, in the order given.

    python3 tools/time_torch_tile.py ROOT [ROOT ...]
    python3 tools/time_torch_tile.py --ablate ROOT
    python3 tools/time_torch_tile.py --clock ROOT

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
- the tile's two vertical paths: the checkout's `sgm_tile_final` (the
  vertical pair and the winner-take-all in one launch; also the top-down
  path alone, 5 and 4 paths) where it has one, else `sgm_tile_scan` over
  the two vertical jobs;
- the torch winner-take-all (`wta_uniq_subpix`) on that tile's S, which a
  checkout without `sgm_tile_final` runs after the scans;
- a rank's frame: every launch of tile 0's wavefront (K + n - 1 steps) and
  its winner-take-all, at n = 1, 2 and 4 tiles (the carries random, no
  exchange), with its launches and its device ms and operations
  (torch.profiler).

It prints one JSON line a process: the card's name and power limit, the
checkout, the median of 15 calls (`ms`, CUDA events) and a call of 20
issued back to back between two events (`ms_b2b`: there the host's work
before each launch overlaps the previous kernel, so that figure is device
time alone).

`--ablate` builds copies of ROOT's `csrc/sgm_tile.cu` into
`build/sweep/sgm_tile/` with parts of the scan taken out and times them on
the wavefront step, its horizontal and its diagonal jobs alone (the
redesign's also on a step on four blocks), and the vertical pair (the
redesign's with the winner-take-all). The copies of the kernel that adds
into S with atomics (the first design) lose the atomic adds (a plain
read-modify-write, wrong where jobs meet), the load of the next pixel's
costs (costs made from registers), or both; one more copy keeps the
atomics and feeds each warp's costs from a cp.async ring in shared memory,
8 pixels ahead, as the redesign does (right at this shape: its S is
checked against the plain jobs). Each is timed as 20 calls back to back,
also on a rank's cross-tile steps at n = 1, 2 and 4 (which the
redesign's process times too). The copies of the redesigned kernel lose
the stores of S, the ring's waits, the wait on the group of rows before,
the step barriers, the winner-take-all, or a walk's horizontal or
diagonal recurrence (L = Lp + C); variants walk groups of 8 rows, load
the carry words 2 or 4 steps ahead, or take the register path. They are
timed by their device time a call (torch.profiler), which the host's work
for a call does not hide. Apart from the ring copy, the outputs of an
ablated copy are wrong by design; only its time is read.

`--clock` builds copies of the redesign with clock64 probes in a walk's
step and prints the cycles a step of one warp by part (to the top of a
step, the costs read, the horizontal recurrence, the diagonal part and
the store of S, the edge stores, the carry words and the barrier), on the
steady step's horizontal walk and its (0, +1) + (+1, +1) walk; the probes
add some tens of cycles each.
"""

from __future__ import annotations

import ctypes
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


def _frame_steps(torch, Ct, n, strip, vertical=True):
    """The job lists of tile 0's wavefront on n tiles (exact_sgbm.py's
    schedule; random carries, no exchange), with the vertical jobs in the
    first step for a checkout without `sgm_tile_final` unless `vertical` is
    false."""
    from rt_depth_map_tpu_torch.ops.cuda import sgm_tile as tile_mod
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import ScanJob
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import (
        _default_row_block,
        cross_dirs,
        local_dirs,
    )

    H, wloc, D = Ct.shape
    rb = _default_row_block(H, n)
    K = H // rb
    fused = hasattr(tile_mod, "sgm_tile_final")
    steps = []
    for t in range(K + n - 1):
        jobs = ([ScanJob(dy, dx, 0, H) for dy, dx in local_dirs(8)]
                if t == 0 and vertical and not fused else [])
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
    from rt_depth_map_tpu_torch.ops.cuda import sgm_tile as tile_mod
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import ScanJob, sgm_tile_scan
    from rt_depth_map_tpu_torch.ops.cuda.sgm_vert_wta import wta_uniq_subpix
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import local_dirs

    dev = C.device
    out = {"card": cs._card(), "root": root, "ms": {}, "ms_b2b": {}, "frame": {}}
    fused = getattr(tile_mod, "sgm_tile_final", None)

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
    if fused is not None:
        time("vertical pair + winner-take-all (sgm_tile_final)",
             lambda: fused(Ct, S, p1, p2, ur, ((1, 0), (-1, 0))))
        time("top-down path + winner-take-all (sgm_tile_final)",
             lambda: fused(Ct, S, p1, p2, ur, ((1, 0),)))
    else:
        local = [ScanJob(dy, dx, 0, Ct.shape[0]) for dy, dx in local_dirs(8)]
        time("vertical pair", lambda: sgm_tile_scan(Ct, S, local, p1, p2))
    time("torch winner-take-all (wta_uniq_subpix)", lambda: wta_uniq_subpix(S, ur))
    del S
    for n in (1, 2, 4):
        Cn = C[:, : W1 // n].contiguous()
        steps = _frame_steps(torch, Cn, n, strip)
        Sn = torch.zeros(Cn.shape, dtype=torch.int32, device=dev)

        def frame(Cn=Cn, Sn=Sn, steps=steps):
            for js in steps:
                sgm_tile_scan(Cn, Sn, js, p1, p2)
            if fused is not None:
                return fused(Cn, Sn, p1, p2, ur, ((1, 0), (-1, 0)))
            return wta_uniq_subpix(Sn, ur)

        name = f"a rank's scans + winner-take-all, {n} tile(s)"
        time(name, frame)
        cross = _frame_steps(torch, Cn, n, strip, vertical=False)
        time(f"a rank's cross-tile steps, {n} tile(s)",
             lambda Cn=Cn, Sn=Sn, cross=cross: [sgm_tile_scan(Cn, Sn, js, p1, p2)
                                                for js in cross])
        dev_ms, ops = tt.device_profile(torch, frame)
        out["frame"][name] = {"launches": len(steps) + (fused is not None),
                              "device_ms": dev_ms, "device_ops": ops}
        del Sn, Cn
        torch.cuda.empty_cache()
    return out


#: the atomic add of the first design, and its plain read-modify-write
_ATOMIC = "      if (ok[k]) atomicAdd(S + pix * D + d0 + k, L[k]);"
_PLAIN_ADD = "      if (ok[k]) S[pix * D + d0 + k] += L[k];"
#: its load of the next pixel's costs, and costs made from registers
_LOOKAHEAD = "    if (s + 1 < steps) st_cost<CT, K>(C, (long long)yn * W + xn, lane, D, cn);"
_NO_LOOKAHEAD = ("    if (s + 1 < steps)\n#pragma unroll\n      for (int k = 0; k < K; ++k)"
                 " cn[k] = c[k] ^ (s & 7);")
#: its loop head, and the same with each warp's next pixels' costs copied
#: ahead into a ring in shared memory with cp.async (at least 8 ahead): the
#: first design fed as the redesign is, its atomics kept; right where a
#: pixel's costs are whole 16-byte pieces (D = 128 at int16)
_FIRST_LOOP = """  int c[K], cn[K] = {}, L[K];
  st_cost<CT, K>(C, (long long)y * W + x, lane, D, c);
  for (int s = 0; s < steps; ++s) {
    const int yn = y + dy, xn = x + dx;
    if (s + 1 < steps) st_cost<CT, K>(C, (long long)yn * W + xn, lane, D, cn);
"""
_FIRST_RING = """  constexpr int RING_N = 8, SLOT = 256 * sizeof(CT);
  __shared__ __align__(16) char ring_[ST_WARPS][RING_N][SLOT];
  char* ring = &ring_[threadIdx.x / 32][0][0];
  const int pieces = D * (int)sizeof(CT) / 16, ya = y, xa = x;
  int nf = 0;
  auto fetch = [&]() {
    if (nf < steps) {
      const char* src = reinterpret_cast<const char*>(
          C + ((long long)(ya + nf * dy) * W + (xa + nf * dx)) * D);
      char* dst = ring + (nf & (RING_N - 1)) * SLOT;
      for (int t = lane; t < pieces; t += 32) cp_async16(dst + 16 * t, src + 16 * t);
    }
    cp_async_commit();
    ++nf;
  };
  for (int f = 0; f + 1 < RING_N; ++f) fetch();
  int c[K], cn[K] = {}, L[K];
  for (int s = 0; s < steps; ++s) {
    const int yn = y + dy, xn = x + dx;
    __syncwarp();
    fetch();
    cp_async_wait<RING_N - 1>();
    __syncwarp();
    const CT* r = reinterpret_cast<const CT*>(ring + (s & (RING_N - 1)) * SLOT);
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = ok[k] ? (int)r[d0 + k] : 0;
"""
_INCLUDE = '#include "sgm_path.cuh"\n'
#: the name of the ring copy, which is also checked against the plain scan
FIRST_RING = "a cp.async ring for C (atomics kept)"
#: (name, [(old, new), ...]): ablated copies of the first design
FIRST_ABLATIONS = [
    ("as is", []),
    ("no atomics (plain read-modify-write)", [(_ATOMIC, _PLAIN_ADD)]),
    ("no look-ahead load (costs from registers)", [(_LOOKAHEAD, _NO_LOOKAHEAD)]),
    ("no atomics, no look-ahead load", [(_ATOMIC, _PLAIN_ADD), (_LOOKAHEAD, _NO_LOOKAHEAD)]),
    ("no adds into S at all", [(_ATOMIC, "      if (ok[k] && L[k] == -77777) S[0] = 1;")]),
    (FIRST_RING, [(_INCLUDE, _INCLUDE + '#include "async_copy.cuh"\n'),
                  (_FIRST_LOOP, _FIRST_RING)]),
]


def _first_caller(torch, fn, lib, Ct, S, jobs, p1, p2):
    """A call of a copy of the first design's entry, as its wrapper makes it."""
    H, W, D = Ct.shape
    desc = (ctypes.c_int * (4 * len(jobs)))()
    ptrs = (ctypes.c_void_p * (5 * len(jobs)))()
    keep = []
    for i, j in enumerate(jobs):
        out = torch.empty((j.rows + 1, D), dtype=torch.int32, device=Ct.device)
        prev = torch.empty((W, D), dtype=torch.int32, device=Ct.device)
        keep += [out, prev]

        def p(t):
            return None if t is None else t.data_ptr()
        desc[4 * i: 4 * i + 4] = [j.dy, j.dx, j.row0, j.rows]
        ptrs[5 * i: 5 * i + 5] = [p(j.inbox), p(j.outbox),
                                  out.data_ptr() if j.dx else None, p(j.prev),
                                  prev.data_ptr() if j.dx and j.dy else None]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(Ct.data_ptr(), Ct.element_size(), S.data_ptr(), H, W, D, p1, p2,
                 desc, ptrs, len(jobs), stream)
        if err:
            raise RuntimeError(lib.rtdm_error_string(err).decode())
    call.keep = keep
    return call


#: the redesign's store of S, ring wait, wait on the group of rows before,
#: carry-copy distance and winner-take-all, and what takes their place
_S_STORE = "        vb_put_lane<int32_t, K>(Srow + xo + d0, vec_s, ok, tot);"
_RING_WAIT = "        cp_async_wait<RING - 1>();\n        __syncwarp();  // the step's pieces came"
_GROUP_WAIT = "          if (!fresh) {"
_STEP_BAR = "    if (has_d) __syncthreads();  // the group's carries of step s are out"
_AHEAD = "#define TS_AHEAD 1"
_WTA = "      sgm_wta<K>(tot, ok, d0, D, lane, wta, (long long)row(s) * W + x);"
_H_STEP = "        ts_step<K>(whole, c, Ph, ok, d0, D, p1, p2, Lh);"
_DEPTH = "  static constexpr int depth = K <= 4 ? 8 : 4;"
_ASYNC = "      const bool async = ts_async<CT>(C, S, D) && (uintptr_t)scratch % 16 == 0;"
_D_STEP = "        ts_step<K>(whole, c, Pd, ok, d0, D, p1, p2, Ld);"
#: (name, [(old, new), ...]): ablated copies of the redesign
ABLATIONS = [
    ("as is", []),
    ("no stores of S (walks)", [(_S_STORE, _S_STORE.replace(
        "vb_put_lane", "if (tot[0] == -77777) vb_put_lane"))]),
    ("no ring waits (walks)", [(_RING_WAIT, _RING_WAIT.replace(
        "        cp_async_wait<RING - 1>();\n", ""))]),
    ("no wait on the group before", [(_GROUP_WAIT, "          if (fresh && !fresh) {")]),
    ("no step barriers", [(_STEP_BAR, "")]),
    ("no winner-take-all (final)", [(_WTA, "      if (lane == 0) wta.best[row(s) * W + x] "
                                            "= tot[0];")]),
    ("no horizontal recurrence", [(_H_STEP, "#pragma unroll\n        for (int k = 0; k < K; ++k) "
                                             "Lh[k] = Ph[k] + c[k];")]),
    ("no diagonal recurrence", [(_D_STEP, "#pragma unroll\n        for (int k = 0; k < K; ++k) "
                                           "Ld[k] = Pd[k] + c[k];")]),
    # not ablations: the same kernel with groups of 8 rows (a block of 8
    # warps; the launch's plan and scratch, sized for 4, cover it), with the
    # carry words loaded 2 or 4 steps ahead, and on the register path
    ("variant: groups of 8 rows", [("#define TS_G 4", "#define TS_G 8")]),
    ("variant: carry words loaded 2 steps ahead", [(_AHEAD, "#define TS_AHEAD 2")]),
    ("variant: carry words loaded 4 steps ahead", [(_AHEAD, "#define TS_AHEAD 4")]),
    ("variant: the register path", [(_ASYNC, _ASYNC.replace("= ts_async", "= false && ts_async"))]),
]


def _ablate(root: str) -> dict:
    cs, torch, C, W1, p1, p2, ur = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import ScanJob
    from rt_depth_map_tpu_torch.parallel.exact_sgbm import local_dirs

    dev = C.device
    Ct = C[:, : W1 // TILES].contiguous()
    strip = _strips(torch, dev, 3)
    jobs = _step_jobs(torch, Ct, strip)
    local = [ScanJob(dy, dx, 0, Ct.shape[0]) for dy, dx in local_dirs(8)]
    cases = {"wavefront step, 6 directions": jobs,
             "its 2 horizontal jobs": [j for j in jobs if j.dy == 0],
             "its 4 diagonal jobs": [j for j in jobs if j.dy != 0],
             "vertical pair": local}
    S = torch.zeros(Ct.shape, dtype=torch.int32, device=dev)
    res = {}
    source = (_build.CSRC_DIR / "sgm_tile.cu").read_text()
    if _ATOMIC in source:
        from rt_depth_map_tpu_torch.ops.cuda.sgm_tile import sgm_tile_scan_plain

        P, I = _build.P, _build.I
        libs = tt.build_ablations(
            "sgm_tile", [[("sgm_tile.cu", old, new) for old, new in subs]
                         for _, subs in FIRST_ABLATIONS],
            "rtdm_sgm_tile_scan", [P, I, P, I, I, I, I, I, P, P, I, P])
        # a rank's cross-tile steps (tile 0, no vertical jobs), n = 1, 2, 4
        frames = {}
        for n in (1, 2, 4):
            Cn = C[:, : W1 // n].contiguous()
            frames[f"a rank's cross-tile steps, {n} tile(s)"] = (
                Cn, torch.zeros(Cn.shape, dtype=torch.int32, device=dev),
                _frame_steps(torch, Cn, n, strip, vertical=False))
        for (name, _), (lib, fn) in zip(FIRST_ABLATIONS, libs):
            res[name] = {case: min(tt.b2b_ms(torch, _first_caller(
                torch, fn, lib, Ct, S, js, p1, p2)) for _ in range(3))
                for case, js in cases.items()}
            for case, (Cn, Sn, steps) in frames.items():
                calls = [_first_caller(torch, fn, lib, Cn, Sn, js, p1, p2) for js in steps]
                res[name][case] = min(tt.b2b_ms(torch, lambda calls=calls: [
                    c() for c in calls]) for _ in range(3))
            if name == FIRST_RING:  # the ring copy is right: S against the plain jobs
                S0, S1 = torch.zeros_like(S), torch.zeros_like(S)
                _first_caller(torch, fn, lib, Ct, S0, jobs, p1, p2)()
                sgm_tile_scan_plain(Ct, S1, jobs, p1, p2)
                res[name]["S equals the plain jobs'"] = bool(torch.equal(S0, S1))
    else:
        from rt_depth_map_tpu_torch.ops.cuda import sgm_tile as tile_mod

        libs = tt.build_ablations(
            "sgm_tile", [[("sgm_tile.cu", old, new) for old, new in subs]
                         for _, subs in ABLATIONS],
            "rtdm_sgm_tile_scan", tile_mod.SCAN_ARGTYPES)
        apart = _step_jobs(torch, Ct, strip, 2, 1)
        cases = {k: v for k, v in cases.items() if k != "vertical pair"}
        cases["a step on four blocks"] = apart
        for (name, _), (lib, fn) in zip(ABLATIONS, libs):
            ffn = lib.rtdm_sgm_tile_final
            ffn.argtypes, ffn.restype = tile_mod.FINAL_ARGTYPES, _build.I

            def scan(js, fn=fn, lib=lib):
                err = tile_mod.launch_scan(fn, Ct, S, js, p1, p2)[1]
                if err:
                    raise RuntimeError(lib.rtdm_error_string(err).decode())

            def final(ffn=ffn, lib=lib):
                err = tile_mod.launch_final(ffn, Ct, S, p1, p2, ur, ((1, 0), (-1, 0)))[1]
                if err:
                    raise RuntimeError(lib.rtdm_error_string(err).decode())
            res[name] = {case: tt.device_profile(torch, lambda js=js: scan(js))[0]
                         for case, js in cases.items()}
            res[name]["vertical pair + winner-take-all"] = tt.device_profile(torch, final)[0]
    return {"card": cs._card(), "root": root,
            "ms_b2b": {"720p tile of 2 (720 x 576 x 128, int16 C)": res}}


#: the clock64 probes of `--clock`: lane 0 of warp 0 of one block adds the
#: cycles since its last probe to slot k, at the top of a step (k = 0),
#: after its costs are read (1), after its horizontal recurrence (2), after
#: its diagonal part and its store of S (3), after its edge stores (4) and
#: after its carry words' load and the step barrier (5)
_PROBE = ("    if (lane == 0 && i == 0 && blockIdx.x == PROBE_BLOCK && s > 8) {"
          " const long long t_ = clock64(); acc_[%d] += t_ - tl_; tl_ = t_; }\n")
_CLOCK_SUBS = [
    ("  int rslot = 0;      // the ring slot of step s\n",
     "  long long acc_[6] = {0, 0, 0, 0, 0, 0}; long long tl_ = clock64();\n"
     "  int rslot = 0;      // the ring slot of step s\n"),
    ("    if (s >= W) return false;\n", "    if (s >= W) return false;\n" + _PROBE % 0),
    ("        rslot = rslot + slot == ring_bytes ? 0 : rslot + slot;\n",
     "        rslot = rslot + slot == ring_bytes ? 0 : rslot + slot;\n" + _PROBE % 1),
    ("      if (has_d) {\n        // the diagonal carry",
     _PROBE % 2 + "      if (has_d) {\n        // the diagonal carry"),
    ("      if (s == W - 1) {  // the edge column toward the next tile\n",
     _PROBE % 3 + "      if (s == W - 1) {  // the edge column toward the next tile\n"),
    ("    load_words(s + TS_AHEAD, words);\n", _PROBE % 4 + "    load_words(s + TS_AHEAD, words);\n"),
    ("    return true;\n", _PROBE % 5 + "    return true;\n"),
    ("  if (ASYNC && live) cp_async_wait<0>();\n}\n\n// One warp's walk",
     "  if (ASYNC && live) cp_async_wait<0>();\n"
     "  if (lane == 0 && i == 0 && blockIdx.x == PROBE_BLOCK)\n"
     "    for (int q = 0; q < 6; ++q) S[q] = (int)(acc_[q] / 16);\n}\n\n// One warp's walk"),
]


def _clock(root: str) -> dict:
    """Cycles a step of one walk's warp by part (clock64 probes in a copy of
    the redesign), on the steady step's horizontal walk and its top-down
    (0, +1) + (+1, +1) walk (a middle group, whose first row reads the
    group before it, and the first group, which reads prev)."""
    cs, torch, C, W1, p1, p2, ur = _setup(root)
    from rt_depth_map_tpu_torch.ops.cuda import sgm_tile as tile_mod

    Ct = C[:, : W1 // TILES].contiguous()
    jobs = _step_jobs(torch, Ct, _strips(torch, C.device, 3))
    cases = {"(0, +1) alone, group 0": ([jobs[0]], 0),
             "(0, +1) + (+1, +1), group 5": (jobs[:2], 5),
             "(0, +1) + (+1, +1), group 0": (jobs[:2], 0)}
    parts = ["to the top of a step", "costs read", "horizontal recurrence",
             "diagonal part + store of S", "edge stores", "carry words + barrier"]
    out = {"card": cs._card(), "root": root, "parts": parts}
    for name, (js, blk) in cases.items():
        subs = [("sgm_tile.cu", a.replace("PROBE_BLOCK", str(blk)),
                 b.replace("PROBE_BLOCK", str(blk))) for a, b in _CLOCK_SUBS]
        (lib, fn), = tt.build_ablations("sgm_tile", [subs], "rtdm_sgm_tile_scan",
                                        tile_mod.SCAN_ARGTYPES)
        S = torch.zeros(Ct.shape, dtype=torch.int32, device=C.device)
        for _ in range(3):
            S.zero_()
            err = tile_mod.launch_scan(fn, Ct, S, js, p1, p2)[1]
            if err:
                raise RuntimeError(lib.rtdm_error_string(err).decode())
            torch.cuda.synchronize()
        steps = Ct.shape[1] - 9
        out[name] = [round(v * 16 / steps, 1) for v in S.view(-1)[:6].cpu().tolist()]
    return out


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": _child, "--ablate-child": _ablate,
                                         "--clock-child": _clock}))
