#!/usr/bin/env python3
"""Time the frame programs' rectify stage (K1) in one or more checkouts on
one card, each checkout in its own process, in the order given.

    python3 tools/time_torch_remap.py ROOT [ROOT ...]
    python3 tools/time_torch_remap.py --ablate ROOT

Each ROOT is the root of a checkout holding `rt_depth_map_tpu_torch/` and
`chip_smoke.py` (for example the parent commit unpacked with `git archive`
beside this one, given as parent, change, change, parent, so that drift of
the card over the call shows). A process imports the package of its ROOT
only, builds that checkout's kernels into its own `build/`, and times the
rectify stage of `Engine.frame_program` on chip_smoke.py's first synthetic
frame pair through its engine's rectification, at 1280x720 and 1920x1080:
what the checkout's frame program runs between its "gray x2" and HSV
stages. Where the checkout has `rectify_pair`, that is one call (one
launch); before it, a `torch.cat` of the left gray and RGB planes, K1 on
that 4-channel stack, a `.contiguous()` copy of its gray channel and K1 on
the right gray (four launches). For each: the time a stage of 20 issued
back to back between two CUDA events (`ms_b2b`: the host's work for a
stage, which outlasts its kernels here), and chip_smoke.py's CUDA-event
median of 51 single stages (`ms`). Then the device operations (kernels, copies,
fills) and device time a frame of each path's frame program (torch.profiler)
on the same frame: SGM-8 1280x720, BM-128 1280x720, SGM-8 1920x1080 D=256
and cv2 MODE_SGBM 1280x720. One JSON line a process: the card's name and
power limit, the checkout, the numbers.

`--ablate` builds copies of the checkout's `csrc/remap.cu` into
`build/sweep/remap/`, each with a part taken out (the taps, the table loads,
the stores) or another design choice (the RGB taps from aligned 32-bit words
and `__byte_perm`, other block sizes), and times the 1280x720 pair of each
through the library's entry point beside the source as it stands, 20 calls
back to back (the entry point's host work is shorter than the kernel, so
this is device time). The
outputs of a copy with a part taken out are wrong by design; only its time
is read. The word-tap variant is checked equal to the wrapper. One JSON
line.
"""

from __future__ import annotations

import sys

import torch_timing as tt

#: (W, H) of the timed stages
SIZES = ((1280, 720), (1920, 1080))
#: (name, chip_smoke._engine arguments) of the profiled frame programs
PATHS = (("SGM-8 720p", ("sgm", 1280, 720)), ("BM-128 720p", ("bm", 1280, 720)),
         ("SGM-8 1080p D=256", ("sgm", 1920, 1080, 0, 256)),
         ("MODE_SGBM 720p", ("sgm", 1280, 720, 0, 128, 5)))


def _setup(root: str, w: int, h: int):
    """(chip_smoke, torch, the stage's inputs (left gray, left RGB, right
    gray), the engine's state) at w x h."""
    cs, torch = tt.setup(root)
    from rt_depth_map_tpu_torch.ops.color import rgb_to_gray

    eng = cs._engine("sgm", w, h)
    lnp, rnp, _, _ = cs._source(w, h).render(0)
    left = torch.from_numpy(lnp).to("cuda")
    right = torch.from_numpy(rnp).to("cuda")
    return cs, torch, (rgb_to_gray(left), left, rgb_to_gray(right)), eng.state


def _stage(torch, planes, st):
    """The checkout's rectify stage as its frame program runs it."""
    from rt_depth_map_tpu_torch.ops.cuda import remap as k1

    lg, left, rg = planes
    if hasattr(k1, "rectify_pair"):
        return lambda: k1.rectify_pair(lg, left, rg, st.left, st.right)
    from rt_depth_map_tpu_torch.ops.remap import remap_bilinear

    def stage():
        lrect4 = remap_bilinear(torch.cat([lg[..., None], left], dim=-1), st.left)
        return lrect4[..., 0].contiguous(), lrect4[..., 1:], remap_bilinear(rg, st.right)

    return stage


def _child(root: str) -> dict:
    out = {"root": root, "ms_b2b": {}, "ms": {}, "device_ops_a_frame": {},
           "device_ms_a_frame": {}}
    for w, h in SIZES:
        cs, torch, planes, st = _setup(root, w, h)
        stage = _stage(torch, planes, st)
        name = f"rectify stage {w}x{h}"
        out["ms_b2b"][name] = min(tt.b2b_ms(torch, stage) for _ in range(3))
        out["ms"][name] = cs._time_ms(stage, reps=51)
        out["card"] = cs._card()
    for name, args in PATHS:
        eng = cs._engine(*args)
        w, h = args[1:3]
        lnp, rnp, _, _ = cs._source(w, h).render(0)
        pair = (torch.from_numpy(lnp).to("cuda"), torch.from_numpy(rnp).to("cuda"))
        dev_ms, ops = tt.device_profile(torch, lambda: eng.frame_program(*pair))
        out["device_ms_a_frame"][name] = dev_ms
        out["device_ops_a_frame"][name] = ops
        del eng
    return out


#: the sample of one channel, and its ablated form: the weights alone (no
#: tap loads)
_SAMPLE = '''  const int acc = __ldg(src + t.o00 * C + c) * t.w00 +
                  __ldg(src + t.o01 * C + c) * t.w01 +
                  __ldg(src + t.o10 * C + c) * t.w10 +
                  __ldg(src + t.o11 * C + c) * t.w11;'''
_NO_TAPS = '''  const int acc = (t.o00 + c) * t.w00 + t.o01 * t.w01 + t.o10 * t.w10 +
                  t.o11 * t.w11;'''
#: a quad's samples, and the variant that takes each pixel's 3-channel taps
#: from aligned 32-bit words where both columns lie in the image
_QUAD = '''#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int b = k * C + c;  // byte of the quad's 4 * C
      w[b / 4] |= rm_sample<C>(src, t[k], c) << (8 * (b % 4));
    }'''
_QUAD_WORDS = '''#pragma unroll
  for (int k = 0; k < 4; ++k) {
    uint32_t px[C];
    if (C == 3 && t[k].o01 == t[k].o00 + 1) {
      // the 6 bytes of a row's two taps from the aligned words that hold them
      uint32_t r[2][6];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const uint8_t* p = src + 3 * (row ? t[k].o10 : t[k].o00);
        const uint32_t* a = (const uint32_t*)((uintptr_t)p & ~(uintptr_t)3);
        const unsigned sh = 8 * ((uintptr_t)p & 3);
        const uint32_t w0 = __ldg(a), w1 = __ldg(a + 1), w2 = __ldg(a + 2);
        const unsigned long long v =
            (((unsigned long long)w1 << 32 | w0) >> sh) |
            (sh ? (unsigned long long)w2 << (64 - sh) : 0ull);
#pragma unroll
        for (int j = 0; j < 6; ++j) r[row][j] = (uint32_t)(v >> (8 * j)) & 255;
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        px[c] = (uint32_t)((r[0][c % 6] * t[k].w00 + r[0][(3 + c) % 6] * t[k].w01 +
                            r[1][c % 6] * t[k].w10 + r[1][(3 + c) % 6] * t[k].w11 +
                            512) >> 10);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) px[c] = rm_sample<C>(src, t[k], c);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int b = k * C + c;
      w[b / 4] |= px[c] << (8 * (b % 4));
    }
  }'''
#: (name, [(old, new), ...], compare): the ablated copies of csrc/remap.cu
#: (compare: the copy's outputs must equal the wrapper's)
ABLATIONS = [
    ("as is", [], True),
    ("no taps", [(_SAMPLE, _NO_TAPS)], False),
    ("no stores", [("  uint8_t* dst = pl.dst + ((BATCH ? dst_off : 0) + p0) * C;\n",
                    "  if (w[0] != 0x7f3e1d2cu) return;\n"
                    "  uint8_t* dst = pl.dst + ((BATCH ? dst_off : 0) + p0) * C;\n")],
     False),
    ("no table loads", [
        ("    const uint4 q0 = __ldg((const uint4*)(v.table + p0));\n"
         "    const uint4 q1 = __ldg((const uint4*)(v.table + p0 + 2));",
         "    const uint4 q0 = make_uint4(p0 & 0x3ff, 0x421, (p0 + 1) & 0x3ff, 0x463);\n"
         "    const uint4 q1 = make_uint4((p0 + 2) & 0x3ff, 0x4a5, (p0 + 3) & 0x3ff, 0x4e7);")],
     False),
    ("variant: RGB taps from aligned words", [(_QUAD, _QUAD_WORDS)], True),
    ("variant: 128 threads a block", [("#define RM_THREADS 256", "#define RM_THREADS 128")],
     True),
    ("variant: 512 threads a block", [("#define RM_THREADS 256", "#define RM_THREADS 512")],
     True),
]


def _ablate(root: str) -> dict:
    cs, torch, planes, st = _setup(root, *SIZES[0])
    from rt_depth_map_tpu_torch.ops.cuda import _build
    from rt_depth_map_tpu_torch.ops.cuda.remap import rectify_pair

    P, I = _build.P, _build.I
    libs = tt.build_ablations(
        "remap", [[("remap.cu", old, new) for old, new in subs]
                  for _, subs, _ in ABLATIONS],
        "rtdm_rectify_pair", [P, P, I, I, I, P, P, P, P, P, P, P])
    ref = rectify_pair(*planes, st.left, st.right)
    H, W = planes[0].shape
    res = {}
    for (name, _, compare), (lib, fn) in zip(ABLATIONS, libs):
        outs = [torch.empty_like(r) for r in ref]

        def call(lib=lib, fn=fn, outs=outs, name=name):
            err = fn(st.left.packed.data_ptr(), st.right.packed.data_ptr(),
                     st.left.packed.numel(), H, W,
                     *[p.data_ptr() for p in planes], *[o.data_ptr() for o in outs],
                     _build.stream_of(planes[0]))
            _build.check(lib, err, name)

        call()
        torch.cuda.synchronize()
        if compare and not all(torch.equal(o, r) for o, r in zip(outs, ref)):
            raise AssertionError(f"{name}: differs from the wrapper")
        res[name] = min(tt.b2b_ms(torch, call) for _ in range(3))
    return {"card": cs._card(), "root": root,
            "ms_b2b": {f"K1 rectify_pair {W}x{H}": res}}


if __name__ == "__main__":
    sys.exit(tt.main(__file__, __doc__, {"--child": _child, "--ablate-child": _ablate}))
