// One SGM path direction over a D-contiguous cost volume: a warp per
// scanline, D spread over the 32 lanes (the design of arXiv 1610.04121).
//
// Shared by sgm_horiz.cu (K4), sgm_vert_wta.cu (K5) and sgm_hdw.cu (K9a-K9d,
// K11). The recurrence is that of rt_depth_map_tpu/ops/sgbm.py _sgm_step /
// _aggregate_dir:
//
//   L(p, d) = C(p, d) + min(Lp(d), Lp(d-1) + P1, Lp(d+1) + P1, minLp + P2)
//             - (minLp + P2)
//
// where Lp is the previous pixel's L along the path (all zero before the
// first pixel of a scanline, including scanlines that enter from a side
// column), minLp its minimum over d, and Lp(-1) = Lp(D) = MAX_COST. L, the
// running sums and minS can be negative; every value is held in int32 in
// registers, whatever the element types of the volumes in memory.
//
// A pixel (y, x) follows (y - dy, x - dx) on the path of direction
// (dy, dx). A scanline starts at each pixel whose predecessor lies outside
// the image: one per row for a horizontal direction, one per column for a
// vertical one, and W1 + H - 1 for a diagonal one (the top or bottom row,
// then the side column). Lane l holds d = l * K + k for k < K; a warp moves
// one pixel per step, so each step reads C(p, :) and the running sum S(p, :)
// as D contiguous elements (one coalesced transaction per warp).
//
// The volumes hold each pixel's D-vector contiguously; pixel (y, x) starts
// at element y * sy + x * sx: sy = W1 * D, sx = D for the row-major
// (H, W1, D) layout, sy = D, sx = H * D for the x-major (W1, H, D) layout.
//
// Modes (what a step does with L):
//   SGM_WRITE   S_out(p) = L                   (first direction)
//   SGM_ADD     S_out(p) = S_in(p) + L         (S_in may equal S_out)
//   SGM_WTA     S = S_in(p) + L is the pixel's total; the warp writes the
//               winner-take-all outputs best, minS, dval and uniq
//               (rt_depth_map_tpu/ops/sgbm.py wta_uniq_subpix)
// C, S_in and S_out each have their own element type (CT, SI, SO: int16 or
// int32); a sum is stored in SO by truncation, so the caller guarantees
// that it fits.
//
// The loads of the next SGM_PF pixels are issued before the current
// pixel's step, so a warp keeps several rows of memory requests in flight
// while its dependent chain (a warp min, two shuffles) runs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SGM_MAX_COST 32767
#define SGM_BIG 0x3fffffff
#define SGM_FULL 0xffffffffu
#define SGM_PF 4

enum { SGM_WRITE = 0, SGM_ADD = 1, SGM_WTA = 2 };

struct SgmWtaOut {
  int32_t* best;
  int32_t* minS;
  int32_t* dval;
  int32_t* uniq;
  int uniqueness_ratio;
};

// Start pixel and length of scanline `line` of direction (dy, dx).
__device__ __forceinline__ void sgm_scanline(int line, int H, int W1, int dy,
                                             int dx, int* y0, int* x0,
                                             int* len) {
  if (dy == 0) {  // one scanline per row
    *y0 = line;
    *x0 = dx > 0 ? 0 : W1 - 1;
    *len = W1;
    return;
  }
  const int ytop = dy > 0 ? 0 : H - 1;
  if (dx == 0) {  // one scanline per column
    *y0 = ytop;
    *x0 = line;
    *len = H;
    return;
  }
  int y, x;
  if (line < W1) {  // enters from the first row of the scan
    y = ytop;
    x = line;
  } else {  // enters from the side column the diagonal leaves behind
    const int k = line - W1 + 1;
    y = dy > 0 ? k : H - 1 - k;
    x = dx > 0 ? 0 : W1 - 1;
  }
  const int rows = dy > 0 ? H - y : y + 1;
  const int cols = dx > 0 ? W1 - x : x + 1;
  *y0 = y;
  *x0 = x;
  *len = rows < cols ? rows : cols;
}

__host__ __device__ inline int sgm_num_lines(int H, int W1, int dy, int dx) {
  if (dy == 0) return H;
  if (dx == 0) return W1;
  return W1 + H - 1;
}

template <typename CT, typename SI, typename SO, int K, int MODE>
__global__ void __launch_bounds__(128)
sgm_path_kernel(const CT* __restrict__ C, const SI* S_in, SO* S_out,
                int H, int W1, int D, long long sy, long long sx, int p1,
                int p2, int dy, int dx, SgmWtaOut wta) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (line >= sgm_num_lines(H, W1, dy, dx)) return;
  int y0, x0, len;
  sgm_scanline(line, H, W1, dy, dx, &y0, &x0, &len);

  const long long step = dy * sy + dx * sx;  // elements per pixel step
  const long long base = y0 * sy + x0 * sx + lane * K;
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

        // the recurrence step
        int mn = SGM_BIG;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (ok[k]) mn = min(mn, Lp[k]);
        const int minLp = __reduce_min_sync(SGM_FULL, mn);
        const int from_left = __shfl_up_sync(SGM_FULL, Lp[K - 1], 1);
        const int from_right = __shfl_down_sync(SGM_FULL, Lp[0], 1);
        const int delta = minLp + p2;
        int L[K];
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
#pragma unroll
        for (int k = 0; k < K; ++k) Lp[k] = L[k];

        const long long o = base + (long long)s * step;
        if (MODE == SGM_WRITE || MODE == SGM_ADD) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (ok[k])
              S_out[o + k] = (SO)((MODE == SGM_ADD ? sv[k] : 0) + L[k]);
        } else {
          // winner-take-all over the pixel's total S = S_in + L: ties to
          // the smallest d, uniqueness over |d - best| > 1, parabolic
          // subpixel truncated toward zero
          int tot[K];
          int smin = SGM_BIG;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            tot[k] = sv[k] + L[k];
            if (ok[k]) smin = min(smin, tot[k]);
          }
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
            const long long pix = (long long)(y0 + s * dy) * W1 + x0 + s * dx;
            wta.best[pix] = best;
            wta.minS[pix] = minS;
            wta.dval[pix] = has_nb ? best * 16 + sub : best * 16;
            wta.uniq[pix] = any_bad != 0u;
          }
        }
      }
    }
  }
}

// Launch one direction; K = disparities per lane (D <= 32 * K).
template <typename CT, typename SI, typename SO, int MODE>
static cudaError_t sgm_launch_k(const CT* C, const SI* S_in, SO* S_out, int H,
                                int W1, int D, long long sy, long long sx,
                                int p1, int p2, int dy, int dx, SgmWtaOut wta,
                                cudaStream_t stream) {
  const int lines = sgm_num_lines(H, W1, dy, dx);
  const int warps = 4;
  const dim3 grid((lines + warps - 1) / warps);
  const dim3 block(32 * warps);
  if (D <= 32)
    sgm_path_kernel<CT, SI, SO, 1, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dy, dx, wta);
  else if (D <= 64)
    sgm_path_kernel<CT, SI, SO, 2, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dy, dx, wta);
  else if (D <= 128)
    sgm_path_kernel<CT, SI, SO, 4, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dy, dx, wta);
  else
    sgm_path_kernel<CT, SI, SO, 8, MODE><<<grid, block, 0, stream>>>(
        C, S_in, S_out, H, W1, D, sy, sx, p1, p2, dy, dx, wta);
  return cudaGetLastError();
}

// x_major: the volumes are (W1, H, D) instead of (H, W1, D).
template <int MODE, typename CT, typename SI, typename SO>
static cudaError_t sgm_launch(const CT* C, const SI* S_in, SO* S_out, int H,
                              int W1, int D, bool x_major, int p1, int p2,
                              int dy, int dx, SgmWtaOut wta,
                              cudaStream_t stream) {
  const long long sy = x_major ? D : (long long)W1 * D;
  const long long sx = x_major ? (long long)H * D : D;
  return sgm_launch_k<CT, SI, SO, MODE>(C, S_in, S_out, H, W1, D, sy, sx, p1,
                                        p2, dy, dx, wta, stream);
}

// f(CT{}) with CT the cost volume's element type: int16 (c_bytes 2) or int32.
template <typename F>
static cudaError_t sgm_by_ctype(int c_bytes, F f) {
  if (c_bytes == 2) return f(int16_t{});
  return f(int32_t{});
}

static const SgmWtaOut SGM_NO_WTA = {nullptr, nullptr, nullptr, nullptr, 0};
