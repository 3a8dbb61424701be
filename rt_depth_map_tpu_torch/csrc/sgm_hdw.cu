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
// Every launch is the scan of sgm_path.cuh: one warp per scanline, D over
// the lanes, all arithmetic in int32 registers. As on the TPU, the outputs
// of the first two entry points take C's element type: with int16 C they
// hold at most five directions' sums, which fit int16 (the wrapper checks
// the bound on P1 and P2; volume_dtype bounds C). The final pass adds its
// first two directions into an int32 scratch volume (a partial of five
// directions plus two more need not fit int16) and its last launch never
// writes S: each warp holds its pixel's full sum in registers for the WTA.
//
// What bounds them on the H100: device memory bytes for the vertical sets
// (each launch reads C and the running sum and writes the sum: 6 bytes per
// element at int16, ~2.7 GB per direction at 1920x1080, D = 256), and the
// serial chain of each row for a horizontal pass (W1 dependent steps with
// only H warps in flight). The prefetch ring of sgm_path.cuh keeps the
// loads of the next pixels in flight while the chain runs.

#include "sgm_path.cuh"

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
                                   x_major != 0, p1, p2, 0, dx, SGM_NO_WTA, s);
    return sgm_launch<SGM_ADD>(Cv, (const CT*)partial, O, H, W1, D,
                               x_major != 0, p1, p2, 0, dx, SGM_NO_WTA, s);
  });
}

// C, partial, out: (H, W1, D), all int16 (c_bytes 2) or all int32; partial
// may be null. out = partial + L(dy,0) + L(dy,+1) + L(dy,-1), dy = reverse ?
// -1 : +1: the first launch reads the partial (or writes), the next two add
// in place. Requires D <= 256.
extern "C" int rtdm_sgm_vert_pass(const void* C, int c_bytes,
                                  const void* partial, void* out, int H,
                                  int W1, int D, int reverse, int p1, int p2,
                                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int dy = reverse ? -1 : 1;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    const CT* Cv = (const CT*)C;
    CT* O = (CT*)out;
    cudaError_t err =
        partial == nullptr
            ? sgm_launch<SGM_WRITE>(Cv, (const CT*)nullptr, O, H, W1, D, false,
                                    p1, p2, dy, 0, SGM_NO_WTA, s)
            : sgm_launch<SGM_ADD>(Cv, (const CT*)partial, O, H, W1, D, false,
                                  p1, p2, dy, 0, SGM_NO_WTA, s);
    for (int dx = 1; dx >= -1 && err == cudaSuccess; dx -= 2)
      err = sgm_launch<SGM_ADD>(Cv, (const CT*)O, O, H, W1, D, false, p1, p2,
                                dy, dx, SGM_NO_WTA, s);
    return err;
  });
}

// C, partial: (H, W1, D), both int16 (c_bytes 2) or both int32; scratch:
// (H, W1, D) int32; best, minS, dval, uniq: (H, W1) int32. The total
// S = partial + L(dy,0) + L(dy,+1) + L(dy,-1), dy = reverse ? -1 : +1:
// (dy,0) and (dy,+1) go into the scratch, and the (dy,-1) launch does the
// winner-take-all on the complete sum. Requires D <= 256.
extern "C" int rtdm_sgm_final_wta(const void* C, int c_bytes,
                                  const void* partial, void* scratch, int H,
                                  int W1, int D, int reverse, int p1, int p2,
                                  int uniqueness_ratio, void* best, void* minS,
                                  void* dval, void* uniq, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int dy = reverse ? -1 : 1;
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  int32_t* S = (int32_t*)scratch;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    const CT* Cv = (const CT*)C;
    cudaError_t err = sgm_launch<SGM_ADD>(Cv, (const CT*)partial, S, H, W1, D,
                                          false, p1, p2, dy, 0, SGM_NO_WTA, s);
    if (err != cudaSuccess) return err;
    err = sgm_launch<SGM_ADD>(Cv, (const int32_t*)S, S, H, W1, D, false, p1,
                              p2, dy, 1, SGM_NO_WTA, s);
    if (err != cudaSuccess) return err;
    return sgm_launch<SGM_WTA>(Cv, (const int32_t*)S, (int32_t*)nullptr, H, W1,
                               D, false, p1, p2, dy, -1, out, s);
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
