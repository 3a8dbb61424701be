// K4: the two horizontal SGM paths, Sh = L(0,+1) + L(0,-1).
//
// Replaces rt_depth_map_tpu/ops/pallas/sgm_bidir.py sgm_horiz_bidir_dh. As
// on the TPU, the horizontal stage works on the x-major volume that K12
// (vol_transpose.cu) writes from the cost volume, and its output goes back
// through K12 to the row-major layout of K5. The port's x-major layout is
// (W1, H, D), D contiguous: a warp walks one row, D spread over its lanes
// (sgm_path.cuh), so the minimum over D and the d +- 1 neighbours are warp
// shuffles and every step reads one contiguous D-vector; the warps of a
// block walk neighbouring rows, so at each x their D-vectors lie side by
// side. Two launches: left-to-right writes Sh, right-to-left adds into it.
//
// What bounds it on the H100: the serial chain of each row (W1 dependent
// steps, each a warp reduction and two shuffles) with only H warps in
// flight, and device memory bytes (C read twice, Sh written, read and
// written again: 2 * 2 + 3 * 4 bytes per element at int16 C, ~1.9 GB at
// 1280x720, D = 128). The prefetch ring of sgm_path.cuh keeps the loads of
// the next columns in flight while the chain runs.

#include "sgm_path.cuh"

// Ct: (W1, H, D) int16 (c_bytes 2) or int32 (c_bytes 4); Sh: (W1, H, D)
// int32, fully written. Requires D <= 256.
extern "C" int rtdm_sgm_horiz(const void* Ct, int c_bytes, void* Sh, int H,
                              int W1, int D, int p1, int p2, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const SgmWtaOut none = {nullptr, nullptr, nullptr, nullptr, 0};
  int32_t* S = (int32_t*)Sh;
  cudaError_t err = sgm_launch<SGM_WRITE>(Ct, c_bytes, nullptr, S, H, W1, D,
                                          true, p1, p2, 0, 1, none, s);
  if (err != cudaSuccess) return (int)err;
  err = sgm_launch<SGM_ADD>(Ct, c_bytes, S, S, H, W1, D, true, p1, p2, 0, -1,
                            none, s);
  return (int)err;
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
