// K5: the six vertical and diagonal SGM paths, then winner-take-all, in two
// row-synchronous launches of the vertical scan of sgm_vert.cuh.
//
// Replaces rt_depth_map_tpu/ops/pallas/sgm_bidir.py sgm_vert_bidir_wta_hdw:
// from the cost volume C and the horizontal sum Sh, the total
// S = Sh + sum of L over the directions (+1,0), (+1,+1), (+1,-1), (-1,0),
// (-1,+1), (-1,-1), and per pixel (best, minS, dval, uniq), each (H, W1)
// int32 (the contract of rt_depth_map_tpu/ops/sgbm.py wta_uniq_subpix).
// Like the TPU kernel, which keeps row-wide carries of three directions on
// chip, each launch walks the rows once and carries all three directions
// of its sense at once:
//
// - Launch 1 (down): (+1,-1), (+1,0), (+1,+1), rows top to bottom. It reads
//   C and Sh once and writes S = Sh + the three L once (int32).
// - Launch 2 (up): (-1,-1), (-1,0), (-1,+1), rows bottom to top. It reads C
//   and S once; each pixel's total S + the three L is complete in
//   registers, where the winner-take-all, the uniqueness test and the
//   subpixel step run. Only the four (H, W1) outputs are stored.
//
// 16 bytes per volume element (1.7 GB at 1280x720, D = 128, 0.51 ms at
// 3.35 TB/s); the serial chain of 2 x H row steps bounds it. The bands, the
// carries between them and the loads ahead are those of sgm_vert.cuh.
//
// The batched entry (rtdm_sgm_vert_wta_batch) runs B frames' columns in the
// same pair of launches, the TPU's lane-stacked form of this kernel: the
// serial chain stays 2 x H row steps while the columns a step grow B-fold.

#include "sgm_vert.cuh"

// C: (H, W1, D) int16 (c_bytes 2) or int32 (c_bytes 4); Sh: (H, W1, D)
// int32; S: (H, W1, D) int32 scratch; warps, m: a band's warps and each
// warp's columns (ops/cuda/sgm_vert_wta.py vert_plan); edge:
// ceil(W1 / (warps * m)) * 4 * D zeroed 64-bit words; best, minS, dval,
// uniq: (H, W1) int32. Requires D <= 256. Two cooperative launches on
// `stream`: row step s is tagged s + 1 in the first and H + s + 1 in the
// second.
extern "C" int rtdm_sgm_vert_wta(const void* C, int c_bytes, const void* Sh,
                                 void* S, void* edge, int H, int W1, int D,
                                 int warps, int m, int p1, int p2,
                                 int uniqueness_ratio, void* best, void* minS,
                                 void* dval, void* uniq, void* stream) {
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  const SgmWtaOut none = {nullptr, nullptr, nullptr, nullptr, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    cudaError_t err = vb_launch<CT, int32_t, int32_t, false>(
        (const CT*)C, (const int32_t*)Sh, (int32_t*)S, H, W1, D, warps, m, 0,
        1u, p1, p2, (vb_word*)edge, none, s);
    if (err != cudaSuccess) return err;
    return vb_launch<CT, int32_t, int32_t, true>(
        (const CT*)C, (const int32_t*)S, (int32_t*)nullptr, H, W1, D, warps,
        m, 1, (unsigned)H + 1u, p1, p2, (vb_word*)edge, out, s);
  });
}

// Blocks of both of K5's launches resident at once on the current device
// (the smaller count), for a band of `warps` warps of m columns; into
// *blocks.
extern "C" int rtdm_sgm_vert_wta_resident(int c_bytes, int D, int warps,
                                          int m, int* blocks) {
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    int down = 0, up = 0;
    cudaError_t err =
        vb_resident<CT, int32_t, int32_t, false>(D, warps, m, &down);
    if (err != cudaSuccess) return err;
    err = vb_resident<CT, int32_t, int32_t, true>(D, warps, m, &up);
    *blocks = down < up ? down : up;
    return err;
  });
}

// The batched entry: F frames of (H, W1, D) in one pair of cooperative
// launches, each frame owning its own `bands` bands of `warps` warps (m
// columns each), so that no diagonal carry crosses from a frame's edge
// column into its neighbour's (the TPU kernel's `seg` = W1 lanes a frame,
// rt_depth_map_tpu/ops/pallas/sgm_bidir.py:382-390). C: (F, H, W1, D) int16
// or int32; Sh and S: (F, H, W1, D) int32; edge: F * bands * 4 * D zeroed
// 64-bit words; best, minS, dval, uniq: (F, H, W1) int32. Frame f equals
// rtdm_sgm_vert_wta on frame f's slices.
extern "C" int rtdm_sgm_vert_wta_batch(const void* C, int c_bytes,
                                       const void* Sh, void* S, void* edge,
                                       int F, int H, int W1, int D, int warps,
                                       int m, int p1, int p2,
                                       int uniqueness_ratio, void* best,
                                       void* minS, void* dval, void* uniq,
                                       void* stream) {
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  const SgmWtaOut none = {nullptr, nullptr, nullptr, nullptr, 0};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    cudaError_t err = vb_launch<CT, int32_t, int32_t, false, true>(
        (const CT*)C, (const int32_t*)Sh, (int32_t*)S, H, W1, D, warps, m, 0,
        1u, p1, p2, (vb_word*)edge, none, s, F);
    if (err != cudaSuccess) return err;
    return vb_launch<CT, int32_t, int32_t, true, true>(
        (const CT*)C, (const int32_t*)S, (int32_t*)nullptr, H, W1, D, warps,
        m, 1, (unsigned)H + 1u, p1, p2, (vb_word*)edge, out, s, F);
  });
}

// Blocks of both of the batched entry's launches resident at once (the
// smaller count), for a band of `warps` warps of m columns; into *blocks.
extern "C" int rtdm_sgm_vert_wta_batch_resident(int c_bytes, int D, int warps,
                                                int m, int* blocks) {
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    int down = 0, up = 0;
    cudaError_t err =
        vb_resident<CT, int32_t, int32_t, false, true>(D, warps, m, &down);
    if (err != cudaSuccess) return err;
    err = vb_resident<CT, int32_t, int32_t, true, true>(D, warps, m, &up);
    *blocks = down < up ? down : up;
    return err;
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
