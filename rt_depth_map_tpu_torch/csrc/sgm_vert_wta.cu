// K5: the six vertical and diagonal SGM paths, then winner-take-all.
//
// Replaces rt_depth_map_tpu/ops/pallas/sgm_bidir.py sgm_vert_bidir_wta_hdw:
// from the cost volume C and the horizontal sum Sh, the total
// S = Sh + sum of L over the directions (+1,0), (+1,+1), (+1,-1), (-1,0),
// (-1,+1), (-1,-1), and per pixel (best, minS, dval, uniq), each (H, W1)
// int32 (the contract of rt_depth_map_tpu/ops/sgbm.py wta_uniq_subpix).
//
// The TPU kernel keeps row-wide (D, W1) carries in VMEM and sweeps down and
// up in one launch. On the H100 each direction is a set of independent
// scanlines (columns, or diagonals entering from the top or bottom row or a
// side column), one warp each (sgm_path.cuh). Six launches in sequence add
// into one int32 S: the first reads Sh and writes S, the next four add in
// place, and the last never writes S: each of its warps holds a pixel's
// complete D-vector of S in registers and does the winner-take-all, the
// uniqueness test and the subpixel step with warp reductions.
//
// What bounds it on the H100: device memory bytes. Each launch reads C
// (2 bytes per element at int16) and reads and writes S (8 bytes), ~1 GB per
// direction at 1280x720, D = 128; the serial chain per scanline (H steps)
// is hidden by the 1152-1871 warps of a launch and the prefetch ring.

#include "sgm_path.cuh"

// C: (H, W1, D) int16 (c_bytes 2) or int32 (c_bytes 4); Sh: (H, W1, D)
// int32; S: (H, W1, D) int32 scratch; best, minS, dval, uniq: (H, W1)
// int32. Requires D <= 256.
extern "C" int rtdm_sgm_vert_wta(const void* C, int c_bytes, const void* Sh,
                                 void* S, int H, int W1, int D, int p1, int p2,
                                 int uniqueness_ratio, void* best, void* minS,
                                 void* dval, void* uniq, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const SgmWtaOut none = {nullptr, nullptr, nullptr, nullptr, 0};
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  int32_t* Sv = (int32_t*)S;
  static const int dirs[5][2] = {{1, 0}, {1, 1}, {1, -1}, {-1, 0}, {-1, 1}};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 5 && err == cudaSuccess; ++i) {
    const int32_t* src = i == 0 ? (const int32_t*)Sh : Sv;
    err = sgm_launch<SGM_ADD>(C, c_bytes, src, Sv, H, W1, D, false, p1, p2,
                              dirs[i][0], dirs[i][1], none, s);
  }
  if (err != cudaSuccess) return (int)err;
  err = sgm_launch<SGM_WTA>(C, c_bytes, Sv, nullptr, H, W1, D, false, p1, p2,
                            -1, -1, out, s);
  return (int)err;
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
