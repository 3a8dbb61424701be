// The SGM step and winner-take-all shared by the port's scans: the
// horizontal scans of K4 (sgm_horiz.cu) and of the chained passes K9a/K9b
// (sgm_hdw.cu, which also takes the whole-lane form sgm_step_whole) share
// the step (sgm_step); the row-synchronous vertical kernel (sgm_vert.cuh:
// K5, K9c, K9d, K11) shares the step and the winner-take-all (sgm_wta). The recurrence is that of
// rt_depth_map_tpu/ops/sgbm.py _sgm_step / _aggregate_dir:
//
//   L(p, d) = C(p, d) + min(Lp(d), Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2)
//             - (minLp + P2)
//
// where Lp is the previous pixel's L along the path (all zero before the
// first pixel of a scanline, including scanlines that enter from a side
// column), minLp its minimum over d, and Lp(-1) = Lp(D) = MAX_COST. L, the
// running sums and minS can be negative; every value is held in int32 in
// registers, whatever the element types of the volumes in memory. Lane l
// of a warp holds d = l * K + k for k < K.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SGM_MAX_COST 32767
#define SGM_BIG 0x3fffffff
#define SGM_FULL 0xffffffffu

struct SgmWtaOut {
  int32_t* best;
  int32_t* minS;
  int32_t* dval;
  int32_t* uniq;
  int uniqueness_ratio;
};

// One recurrence step of a warp: L(p, :) from the pixel's cost c and the
// predecessor's Lp (lane l holds d = d0 + k = l * K + k; ok[k]: d < D).
template <int K>
__device__ __forceinline__ void sgm_step(const int (&c)[K], const int (&Lp)[K],
                                         const bool (&ok)[K], int d0, int D,
                                         int p1, int p2, int (&L)[K]) {
  int mn = SGM_BIG;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (ok[k]) mn = min(mn, Lp[k]);
  const int minLp = __reduce_min_sync(SGM_FULL, mn);
  const int from_left = __shfl_up_sync(SGM_FULL, Lp[K - 1], 1);
  const int from_right = __shfl_down_sync(SGM_FULL, Lp[0], 1);
  const int delta = minLp + p2;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    int lm = k > 0 ? Lp[k - 1] : from_left;
    if (d == 0) lm = SGM_MAX_COST;
    int lq = k < K - 1 ? Lp[k + 1] : from_right;
    if (d + 1 >= D) lq = SGM_MAX_COST;
    const int m = min(min(Lp[k], delta), min(lm, lq) + p1);
    L[k] = c[k] + m - delta;
  }
}

// sgm_step where D % K == 0, so that every lane is whole or empty: the
// edges d = 0 and d = D - 1 fall on a lane's first and last element, so
// three selects a lane replace the compares of every element, and the step
// runs on Hopper's DPX minima (min(a + b, c) and a three-way min in one
// instruction each). m = min(Lp(d), delta, Lp(d-1) + P1, Lp(d+1) + P1) as
// in sgm_step, so both give the same L bit for bit. Empty lanes' values are
// never read.
template <int K>
__device__ __forceinline__ void sgm_step_whole(const int (&c)[K],
                                               const int (&Lp)[K], int d0,
                                               int D, int p1, int p2,
                                               int (&L)[K]) {
  int mn = Lp[0];
#pragma unroll
  for (int k = 1; k < K; k += 2)
    mn = k + 1 < K ? __vimin3_s32(mn, Lp[k], Lp[min(k + 1, K - 1)])
                   : min(mn, Lp[k]);
  if (d0 >= D) mn = SGM_BIG;
  const int minLp = __reduce_min_sync(SGM_FULL, mn);
  int from_left = __shfl_up_sync(SGM_FULL, Lp[K - 1], 1);
  int from_right = __shfl_down_sync(SGM_FULL, Lp[0], 1);
  if (d0 == 0) from_left = SGM_MAX_COST;
  if (d0 + K >= D) from_right = SGM_MAX_COST;
  const int delta = minLp + p2;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int lm = k > 0 ? Lp[k - 1] : from_left;
    const int lq = k < K - 1 ? Lp[k + 1] : from_right;
    const int m = min(__viaddmin_s32(lm, p1, Lp[k]),
                      __viaddmin_s32(lq, p1, delta));
    L[k] = c[k] + m - delta;
  }
}

// Winner-take-all over a pixel's total S (tot, laid out as in sgm_step):
// ties to the smallest d, uniqueness over |d - best| > 1, parabolic
// subpixel truncated toward zero; lane 0 writes the four outputs at pix.
template <int K>
__device__ __forceinline__ void sgm_wta(const int (&tot)[K],
                                        const bool (&ok)[K], int d0, int D,
                                        int lane, const SgmWtaOut& wta,
                                        long long pix) {
  int smin = SGM_BIG;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (ok[k]) smin = min(smin, tot[k]);
  const int minS = __reduce_min_sync(SGM_FULL, smin);
  int bcand = SGM_BIG;
#pragma unroll
  for (int k = K - 1; k >= 0; --k)
    if (ok[k] && tot[k] == minS) bcand = d0 + k;
  const int best = __reduce_min_sync(SGM_FULL, bcand);
  bool bad = false;
  int smv = SGM_BIG, spv = SGM_BIG;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = d0 + k;
    if (!ok[k]) continue;
    if (abs(d - best) > 1 &&
        tot[k] * (100 - wta.uniqueness_ratio) < minS * 100)
      bad = true;
    if (d == best - 1) smv = tot[k];
    if (d == best + 1) spv = tot[k];
  }
  const unsigned any_bad = __ballot_sync(SGM_FULL, bad);
  int sm = __reduce_min_sync(SGM_FULL, smv);
  int sp = __reduce_min_sync(SGM_FULL, spv);
  if (lane == 0) {
    const bool has_nb = best > 0 && best < D - 1;
    if (best == 0) sm = minS;
    if (best == D - 1) sp = minS;
    const int denom2 = max(sm + sp - 2 * minS, 1);
    const int num = (sm - sp) * 16 + denom2;
    const int q = abs(num) / (2 * denom2);
    const int sub = num > 0 ? q : (num < 0 ? -q : 0);
    wta.best[pix] = best;
    wta.minS[pix] = minS;
    wta.dval[pix] = has_nb ? best * 16 + sub : best * 16;
    wta.uniq[pix] = any_bad != 0u;
  }
}

// f(CT{}) with CT the cost volume's element type: int16 (c_bytes 2) or int32.
template <typename F>
static cudaError_t sgm_by_ctype(int c_bytes, F f) {
  if (c_bytes == 2) return f(int16_t{});
  return f(int32_t{});
}

