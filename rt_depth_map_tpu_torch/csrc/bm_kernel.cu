// StereoBM block-matching cost with a streaming winner-take-all.
//
// Replaces rt_depth_map_tpu/ops/pallas/bm_kernel.py bm_cost_wta. For every
// pixel and every disparity d in [0, D) the cost is the bs x bs sum of
// |L(y', x') - R(y', x' - d)| over the window centred on (y, x), with the
// window sums zero-padded at the image border and |L - R| taken as 0 where
// x' - d < 0 (the XLA formulation of rt_depth_map_tpu/ops/bm.py
// _cost_volume, on every pixel). The (D, H, W) volume is never written: each
// thread keeps its pixel's winner state in registers while it walks d.
//
// Outputs, each (H, W) int32:
//   best_d       argmin over d, ties to the LARGEST d (packed key
//                cost * 256 + (D - 1 - d), as bm_kernel.py:16-18)
//   best_cost    cost at best_d
//   c_m1, c_p1   cost at best_d - 1 / best_d + 1 (0 where that d is outside
//                [0, D))
//   min_outside  min cost over d with |d - best_d| > 1 (2^28 if none),
//                exact: the four smallest keys always hold it
//
// Design: a block owns TX = 128 output columns (one thread each) of a stripe
// of TY rows. Shared memory holds, per d, the vertical window sums V[d][c]
// over the TX + bs - 1 halo columns (uint16: at most bs * 255), and a ring of
// the last bs + 1 staged rows of both images. Moving down one row adds the
// new row's |L - R| and subtracts the row that left the window; then each
// thread sums bs neighbouring V[d] entries per d and updates its winner.
//
// What bounds it on the H100: shared-memory bandwidth. Per output pixel and
// d it reads bs V entries plus ~(1 + (TY + bs - 1) / TY) V updates, about
// 2 * bs shared accesses; there is no reuse of the horizontal sums across
// neighbouring columns and no tensor-core formulation yet. Device memory is
// read once per stripe (plus halo). A later PR can slide the horizontal
// window per thread and widen the stripes.

#include <cuda_runtime.h>
#include <stdint.h>

#define BM_TX 128
#define BM_TY 16
#define BM_BIGKEY 0x7fffffff

__global__ void __launch_bounds__(BM_TX)
bm_cost_wta_kernel(const uint8_t* __restrict__ lp,
                   const uint8_t* __restrict__ rp, int H, int W, int D,
                   int bs, int32_t* __restrict__ best_d_out,
                   int32_t* __restrict__ best_c_out,
                   int32_t* __restrict__ cm1_out,
                   int32_t* __restrict__ cp1_out,
                   int32_t* __restrict__ mout_out) {
  extern __shared__ uint16_t V[];  // [D][CW]
  const int w2 = bs / 2;
  const int CW = BM_TX + 2 * w2;  // halo columns
  const int RW = CW + D - 1;      // right-image columns a row needs
  const int RING = bs + 1;
  uint8_t* Ls = (uint8_t*)(V + D * CW);  // [RING][CW]
  uint8_t* Rs = Ls + RING * CW;          // [RING][RW]

  const int t = threadIdx.x;
  const int x0 = blockIdx.x * BM_TX;
  const int y0 = blockIdx.y * BM_TY;
  const int y_end = min(y0 + BM_TY, H);
  const int gx0 = x0 - w2;        // image column of halo column 0
  const int r0 = y0 - w2;         // first staged row

  for (int i = t; i < D * CW; i += BM_TX) V[i] = 0;

  for (int r = r0; r < y_end + w2; ++r) {
    // stage row r (zeros outside the image) into its ring slot
    const int slot = (r - r0) % RING;
    uint8_t* Lr = Ls + slot * CW;
    uint8_t* Rr = Rs + slot * RW;
    const bool row_in = r >= 0 && r < H;
    for (int c = t; c < CW; c += BM_TX) {
      const int gx = gx0 + c;
      Lr[c] = (row_in && gx >= 0 && gx < W) ? lp[(size_t)r * W + gx] : 0;
    }
    for (int c = t; c < RW; c += BM_TX) {
      const int gx = gx0 - (D - 1) + c;
      Rr[c] = (row_in && gx >= 0 && gx < W) ? rp[(size_t)r * W + gx] : 0;
    }
    __syncthreads();

    // V[d][c] += ad(r) - ad(r - bs)
    const bool has_old = r - bs >= r0;
    const int old_slot = (r - bs - r0 + RING) % RING;
    const uint8_t* Lo = Ls + old_slot * CW;
    const uint8_t* Ro = Rs + old_slot * RW;
    int d = 0, c = t;
    while (c >= CW) { c -= CW; ++d; }
    for (; d < D;) {
      const int gx = gx0 + c;
      const bool ok = gx < W && gx - d >= 0;
      int a = 0;
      if (ok) {
        const int ri = c - d + D - 1;
        a = abs((int)Lr[c] - (int)Rr[ri]);
        if (has_old) a -= abs((int)Lo[c] - (int)Ro[ri]);
      }
      const int i = d * CW + c;
      V[i] = (uint16_t)((int)V[i] + a);
      c += BM_TX;
      while (c >= CW) { c -= CW; ++d; }
    }
    __syncthreads();

    const int y = r - w2;
    const int x = x0 + t;
    if (y >= y0 && x < W) {
      int k1 = BM_BIGKEY, k2 = BM_BIGKEY, k3 = BM_BIGKEY, k4 = BM_BIGKEY;
      int cm1 = 0, cp1 = 0, prev = 0, bd = 0;
      for (int dd = 0; dd < D; ++dd) {
        const uint16_t* v = V + dd * CW + t;  // halo columns x - w2 .. x + w2
        int cd = 0;
        for (int k = 0; k < bs; ++k) cd += v[k];
        const int key = cd * 256 + (D - 1 - dd);
        if (key < k1) {
          cm1 = prev;
          cp1 = 0;
          bd = dd;
        } else if (dd == bd + 1) {
          cp1 = cd;
        }
        // four smallest keys, sorted
        const int n1 = min(k1, key), r1 = max(k1, key);
        const int n2 = min(k2, r1), r2 = max(k2, r1);
        const int n3 = min(k3, r2), r3 = max(k3, r2);
        k4 = min(k4, r3);
        k1 = n1;
        k2 = n2;
        k3 = n3;
        prev = cd;
      }
      int mo = 1 << 28;
      const int ks[3] = {k2, k3, k4};
      for (int j = 0; j < 3; ++j) {
        if (ks[j] != BM_BIGKEY) {
          const int dj = D - 1 - (ks[j] & 255);
          if (abs(dj - bd) > 1) mo = min(mo, ks[j] >> 8);
        }
      }
      const size_t o = (size_t)y * W + x;
      best_d_out[o] = bd;
      best_c_out[o] = k1 >> 8;
      cm1_out[o] = cm1;
      cp1_out[o] = cp1;
      mout_out[o] = mo;
    }
  }
}

static size_t bm_smem(int D, int bs) {
  const int w2 = bs / 2;
  const size_t CW = BM_TX + 2 * w2;
  return (size_t)D * CW * sizeof(uint16_t) + (size_t)(bs + 1) * CW +
         (size_t)(bs + 1) * (CW + D - 1);
}

// lp, rp: (H, W) uint8 prefiltered planes; outputs (H, W) int32 each.
// Requires 1 <= D <= 256 and odd bs <= 255.
extern "C" int rtdm_bm_cost_wta(const void* lp, const void* rp, int H, int W,
                                int D, int bs, void* best_d, void* best_c,
                                void* c_m1, void* c_p1, void* min_out,
                                void* stream) {
  const size_t smem = bm_smem(D, bs);
  cudaError_t err = cudaFuncSetAttribute(
      bm_cost_wta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + BM_TX - 1) / BM_TX, (H + BM_TY - 1) / BM_TY);
  bm_cost_wta_kernel<<<grid, BM_TX, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)lp, (const uint8_t*)rp, H, W, D, bs, (int32_t*)best_d,
      (int32_t*)best_c, (int32_t*)c_m1, (int32_t*)c_p1, (int32_t*)min_out);
  return (int)cudaGetLastError();
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
