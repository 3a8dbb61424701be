// The SGM step and winner-take-all shared by the port's scans, and the
// horizontal scan of the chained passes K9a/K9b (sgm_hdw.cu). K4
// (sgm_horiz.cu) shares the step (sgm_step); the row-synchronous vertical
// kernel (sgm_vert.cuh: K5, K9c, K9d, K11) shares the step and the
// winner-take-all (sgm_wta). The recurrence is that of
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
//
// The horizontal scan (sgm_path_kernel): a warp per row, D spread over the
// 32 lanes (the design of arXiv 1610.04121); a pixel (y, x) follows
// (y, x - dx). Each step reads C(p, :) and the running sum S(p, :) as D
// contiguous elements (one coalesced transaction per warp). The volumes
// hold each pixel's D-vector contiguously; pixel (y, x) starts at element
// y * sy + x * sx: sy = W1 * D, sx = D for the row-major (H, W1, D)
// layout, sy = D, sx = H * D for the x-major (W1, H, D) layout.
//
// Modes (what a step does with L):
//   SGM_WRITE   S_out(p) = L                   (first direction)
//   SGM_ADD     S_out(p) = S_in(p) + L         (S_in may equal S_out)
// C, S_in and S_out each have their own element type (CT, SI, SO: int16 or
// int32); a sum is stored in SO by truncation, so the caller guarantees
// that it fits.
//
// The loads of the next SGM_PF pixels are issued before the current
// pixel's step. That does not keep them in flight as meant: the compiler
// moves the loaded values between registers, and a move waits for its
// load (the vertical kernel and K4 use rings of cp.async copies instead).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SGM_MAX_COST 32767
#define SGM_BIG 0x3fffffff
#define SGM_FULL 0xffffffffu
#define SGM_PF 4

enum { SGM_WRITE = 0, SGM_ADD = 1 };

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

template <typename CT, typename SI, typename SO, int K, int MODE>
__global__ void __launch_bounds__(128)
sgm_path_kernel(const CT* __restrict__ C, const SI* S_in, SO* S_out,
                int H, int W1, int D, long long sy, long long sx, int p1,
                int p2, int dx) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (y >= H) return;
  const int len = W1;
  const long long step = dx * sx;  // elements per pixel step
  const long long base = y * sy + (dx > 0 ? 0 : (long long)(W1 - 1) * sx) +
                         lane * K;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;

  // prefetch ring: C and S_in of the next SGM_PF pixels
  int cr[SGM_PF][K], sr[SGM_PF][K];
#pragma unroll
  for (int j = 0; j < SGM_PF; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cr[j][k] = 0;
      sr[j][k] = 0;
      if (j < len && ok[k]) {
        const long long o = base + j * step + k;
        cr[j][k] = (int)__ldg(C + o);
        if (MODE != SGM_WRITE) sr[j][k] = (int)S_in[o];
      }
    }
  }

  int Lp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) Lp[k] = 0;

  for (int s0 = 0; s0 < len; s0 += SGM_PF) {
#pragma unroll
    for (int j = 0; j < SGM_PF; ++j) {
      const int s = s0 + j;
      if (s < len) {
        int c[K], sv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          c[k] = cr[j][k];
          sv[k] = sr[j][k];
        }
        // refill this ring slot with pixel s + SGM_PF
        if (s + SGM_PF < len) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (ok[k]) {
              const long long o = base + (long long)(s + SGM_PF) * step + k;
              cr[j][k] = (int)__ldg(C + o);
              if (MODE != SGM_WRITE) sr[j][k] = (int)S_in[o];
            }
          }
        }

        int L[K];
        sgm_step<K>(c, Lp, ok, d0, D, p1, p2, L);
#pragma unroll
        for (int k = 0; k < K; ++k) Lp[k] = L[k];

        const long long o = base + (long long)s * step;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (ok[k])
            S_out[o + k] = (SO)((MODE == SGM_ADD ? sv[k] : 0) + L[k]);
      }
    }
  }
}

// Launch one horizontal direction dx over every row; K = disparities per
// lane (D <= 32 * K). x_major: the volumes are (W1, H, D) instead of
// (H, W1, D).
template <int MODE, typename CT, typename SI, typename SO>
static cudaError_t sgm_launch(const CT* C, const SI* S_in, SO* S_out, int H,
                              int W1, int D, bool x_major, int p1, int p2,
                              int dx, cudaStream_t stream) {
  const long long sy = x_major ? D : (long long)W1 * D;
  const long long sx = x_major ? (long long)H * D : D;
  const int warps = 4;
  const dim3 grid((H + warps - 1) / warps);
  const dim3 block(32 * warps);
  if (D <= 32)
    sgm_path_kernel<CT, SI, SO, 1, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dx);
  else if (D <= 64)
    sgm_path_kernel<CT, SI, SO, 2, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dx);
  else if (D <= 128)
    sgm_path_kernel<CT, SI, SO, 4, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dx);
  else
    sgm_path_kernel<CT, SI, SO, 8, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dx);
  return cudaGetLastError();
}

// f(CT{}) with CT the cost volume's element type: int16 (c_bytes 2) or int32.
template <typename F>
static cudaError_t sgm_by_ctype(int c_bytes, F f) {
  if (c_bytes == 2) return f(int16_t{});
  return f(int32_t{});
}

