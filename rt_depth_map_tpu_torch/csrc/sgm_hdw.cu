// K9a-K9d and K11: the chained SGM passes, one direction set per call.
//
// Replaces the single-direction Pallas passes of the TPU's chained SGM route
// (rt_depth_map_tpu/ops/sgbm.py stereo_sgbm when the fused bidirectional
// kernels are off: num_paths 4 and 5, and 8 paths at H % 16 != 0):
//
//   rtdm_sgm_horiz_pass  one horizontal direction (0,+1) or (0,-1), plus an
//                        optional partial: ops/pallas/sgm_hdw.py
//                        sgm_horiz_pass_dh (K9a, x-major (W1, D, H) on the
//                        TPU) and sgm_horiz_pass_hdw (K9b, (W1, H, D)). The
//                        port's volumes keep D contiguous, so both are the
//                        x-major (W1, H, D) form here; the row-major
//                        (H, W1, D) form is the same scan with other strides.
//   rtdm_sgm_vert_pass   the three directions (dy,0), (dy,+1), (dy,-1) with
//                        dy = +1 (top-down) or -1 (bottom-up), plus an
//                        optional partial: sgm_hdw.py sgm_down_pass_hdw (K9c,
//                        top-down) and ops/pallas/sgm_scan.py
//                        sgm_aggregate_vertical (K11, either sense).
//   rtdm_sgm_final_wta   the same three directions added to a partial, then
//                        winner-take-all, uniqueness and subpixel: sgm_hdw.py
//                        sgm_final_wta_hdw (K9d, either sense).
//
// The horizontal pass is the warp-per-row scan of sgm_path.cuh: W1
// dependent steps with only H warps in flight bound it. The two vertical
// entry points are one cooperative launch each of the row-synchronous scan
// of sgm_vert.cuh, K5's kernel: all three directions of a sense in one walk
// over the rows, reading C and the partial once and writing the sum once
// (6 bytes an element at int16), or doing the winner-take-all from
// registers (4 bytes an element). As on the TPU, the outputs of the first
// two entry points take C's element type: with int16 C they hold at most
// five directions' sums, which fit int16 (the wrapper checks the bound on
// P1 and P2; volume_dtype bounds C). The final pass never stores a sum:
// each pixel's total of the partial and the three directions stays in
// int32 registers for the WTA.

#include "sgm_vert.cuh"

// C, partial, out: (H, W1, D), or (W1, H, D) when x_major, all int16
// (c_bytes 2) or all int32 (c_bytes 4); partial may be null. out = L of the
// direction (0, reverse ? -1 : +1), plus partial. Requires D <= 256.
extern "C" int rtdm_sgm_horiz_pass(const void* C, int c_bytes,
                                   const void* partial, void* out, int H,
                                   int W1, int D, int x_major, int reverse,
                                   int p1, int p2, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int dx = reverse ? -1 : 1;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    const CT* Cv = (const CT*)C;
    CT* O = (CT*)out;
    if (partial == nullptr)
      return sgm_launch<SGM_WRITE>(Cv, (const CT*)nullptr, O, H, W1, D,
                                   x_major != 0, p1, p2, dx, s);
    return sgm_launch<SGM_ADD>(Cv, (const CT*)partial, O, H, W1, D,
                               x_major != 0, p1, p2, dx, s);
  });
}

// C, partial, out: (H, W1, D), all int16 (c_bytes 2) or all int32; partial
// may be null. out = partial + L(dy,0) + L(dy,+1) + L(dy,-1), dy = reverse ?
// -1 : +1. warps, m: the band plan (ops/cuda/sgm_vert_wta.py vert_plan);
// edge: ceil(W1 / (warps * m)) * 4 * D zeroed 64-bit words. Requires
// D <= 256. One cooperative launch.
extern "C" int rtdm_sgm_vert_pass(const void* C, int c_bytes,
                                  const void* partial, void* out, void* edge,
                                  int H, int W1, int D, int warps, int m,
                                  int reverse, int p1, int p2, void* stream) {
  const SgmWtaOut none = {nullptr, nullptr, nullptr, nullptr, 0};
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vb_launch<CT, CT, CT, false>(
        (const CT*)C, (const CT*)partial, (CT*)out, H, W1, D, warps, m,
        reverse, 1u, p1, p2, (vb_word*)edge, none, (cudaStream_t)stream);
  });
}

// C, partial: (H, W1, D), both int16 (c_bytes 2) or both int32; best,
// minS, dval, uniq: (H, W1) int32: the winner-take-all of
// S = partial + L(dy,0) + L(dy,+1) + L(dy,-1), dy = reverse ? -1 : +1.
// warps, m, edge: as for rtdm_sgm_vert_pass. Requires D <= 256. One
// cooperative launch.
extern "C" int rtdm_sgm_final_wta(const void* C, int c_bytes,
                                  const void* partial, void* edge, int H,
                                  int W1, int D, int warps, int m, int reverse,
                                  int p1, int p2, int uniqueness_ratio,
                                  void* best, void* minS, void* dval,
                                  void* uniq, void* stream) {
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vb_launch<CT, CT, CT, true>(
        (const CT*)C, (const CT*)partial, (CT*)nullptr, H, W1, D, warps, m,
        reverse, 1u, p1, p2, (vb_word*)edge, out, (cudaStream_t)stream);
  });
}

// Blocks of the vertical pass (wta 0) or the final pass (wta 1) resident
// at once on the current device, for a band of `warps` warps of m columns;
// into *blocks.
extern "C" int rtdm_sgm_vert_resident(int c_bytes, int wta, int D, int warps,
                                      int m, int* blocks) {
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return wta ? vb_resident<CT, CT, CT, true>(D, warps, m, blocks)
               : vb_resident<CT, CT, CT, false>(D, warps, m, blocks);
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
