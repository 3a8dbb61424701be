// K3: SGBM matching cost, Birchfield-Tomasi on the preprocessed planes plus
// a block_size x block_size window sum, into the (H, W1, D) cost volume.
//
// Replaces rt_depth_map_tpu/ops/pallas/sgm_cost.py sgm_cost_volume_pallas,
// whose contract is rt_depth_map_tpu/ops/sgbm.py sgbm_cost_volume:
//
//   pix(y, x, d) = BT(sobel planes) + (BT(raw planes) >> 2), 0 where x - d
//                  leaves the image
//   C(y, j, d)   = sum over |dy|, |dx| <= bs/2 of
//                  pix(clamp(y + dy, 0, H-1), minX1 + clamp(j + dx, 0, W1-1), d)
//
// i.e. the window replicates at the edges of the cropped range
// [minX1, minX1 + W1), not at the image's. Each image arrives as an (H, W, 8)
// uint8 plane stack prepared by the wrapper: the clipped x-Sobel response,
// its half-pixel min and max, the raw image, its half-pixel min and max, and
// two zero bytes, so a pixel's planes are one 8-byte load.
//
// Design: a block owns SC_TX output columns of a stripe of SC_R rows, one
// thread per d. For each input row of the stripe (clamped rows y0-2 ..
// y0+R+1) the block stages the left planes of the SC_TX + bs - 1 (clamped)
// window columns and the right planes they meet at x - d in shared memory;
// each thread computes pix for its d along the row, keeps the horizontal
// window sum of each output column, and updates a running vertical sum from
// a ring of the last bs horizontal sums (int16 in shared memory, owned by the
// thread). Once bs rows are in, each new row finishes one output row.
//
// What bounds it on the H100: integer operations. Per output element it
// computes (SC_TX + bs - 1) / SC_TX * (SC_R + bs - 1) / SC_R pixel costs of
// ~30 integer operations each; device memory sees the 2 * 8 * H * W plane
// bytes (times the halo) and one write of the volume (212 MB at 1280x720,
// D = 128, int16).

#include <cuda_runtime.h>
#include <stdint.h>

#define SC_TX 16
#define SC_R 32

__device__ __forceinline__ int sc_byte(uint2 v, int i) {
  return (int)((i < 4 ? v.x >> (8 * i) : v.y >> (8 * (i - 4))) & 0xffu);
}

// BT cost of left planes (u, u0, u1) against right planes (v, v0, v1)
__device__ __forceinline__ int sc_bt(int u, int u0, int u1, int v, int v0,
                                     int v1) {
  const int c0 = max(0, max(u - v1, v0 - u));
  const int c1 = max(0, max(v - u1, u0 - v));
  return min(c0, c1);
}

template <typename CT, int BS>
__global__ void sgm_cost_kernel(const uint2* __restrict__ lpl,
                                const uint2* __restrict__ rpl, int H, int W,
                                int D, int minX1, int W1,
                                CT* __restrict__ out) {
  constexpr int W2 = BS / 2;
  constexpr int NE = SC_TX + 2 * W2;  // window columns of the tile
  extern __shared__ uint2 smem[];
  const int NR = NE + D - 1;          // right columns they meet
  uint2* Ls = smem;                   // [NE]
  uint2* Rs = Ls + NE;                // [NR]
  int16_t* ring = (int16_t*)(Rs + NR);  // [BS][SC_TX][D]

  const int d = threadIdx.x;  // blockDim.x == D
  const int j0 = blockIdx.x * SC_TX;
  const int y0 = blockIdx.y * SC_R;
  const int y_end = min(y0 + SC_R, H);
  const int n_in = (y_end - y0) + 2 * W2;  // input rows of the stripe
  // image column of window column 0 (clamped to the cropped range)
  const int xe0 = minX1 + min(max(j0 - W2, 0), W1 - 1);
  const int rlo = xe0 - (D - 1);  // image column of right column 0

  int vs[SC_TX];
#pragma unroll
  for (int j = 0; j < SC_TX; ++j) vs[j] = 0;

  for (int r = 0; r < n_in; ++r) {
    const int y = min(max(y0 - W2 + r, 0), H - 1);
    const uint2* lrow = lpl + (size_t)y * W;
    const uint2* rrow = rpl + (size_t)y * W;
    for (int e = threadIdx.x; e < NE; e += blockDim.x)
      Ls[e] = lrow[minX1 + min(max(j0 - W2 + e, 0), W1 - 1)];
    for (int c = threadIdx.x; c < NR; c += blockDim.x) {
      const int x = rlo + c;
      Rs[c] = (x >= 0 && x < W) ? rrow[x] : make_uint2(0u, 0u);
    }
    __syncthreads();

    // pix along the row for this thread's d
    int pix[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int xl = minX1 + min(max(j0 - W2 + e, 0), W1 - 1);
      const int xr = xl - d;
      int p = 0;
      if (xr >= 0 && xr < W) {
        const uint2 lv = Ls[e];
        const uint2 rv = Rs[xr - rlo];
        p = sc_bt(sc_byte(lv, 0), sc_byte(lv, 1), sc_byte(lv, 2),
                  sc_byte(rv, 0), sc_byte(rv, 1), sc_byte(rv, 2)) +
            (sc_bt(sc_byte(lv, 3), sc_byte(lv, 4), sc_byte(lv, 5),
                   sc_byte(rv, 3), sc_byte(rv, 4), sc_byte(rv, 5)) >> 2);
      }
      pix[e] = p;
    }
    // horizontal window sums; the ring slot of this row replaces the one
    // that left the vertical window
    int16_t* ring_row = ring + (size_t)(r % BS) * SC_TX * D + d;
    const bool full = r >= BS;
    int hsum = 0;
#pragma unroll
    for (int e = 0; e < BS - 1; ++e) hsum += pix[e];
#pragma unroll
    for (int j = 0; j < SC_TX; ++j) {
      hsum += pix[j + BS - 1];
      int16_t* rp = ring_row + (size_t)j * D;
      const int old = full ? (int)*rp : 0;
      *rp = (int16_t)hsum;
      vs[j] += hsum - old;
      hsum -= pix[j];
    }

    if (r >= 2 * W2) {
      const int yo = y0 + r - 2 * W2;  // output row this input row completes
#pragma unroll
      for (int j = 0; j < SC_TX; ++j) {
        if (j0 + j < W1)
          out[((size_t)yo * W1 + j0 + j) * D + d] = (CT)vs[j];
      }
    }
    __syncthreads();
  }
}

static size_t sc_smem(int D, int bs) {
  const int NE = SC_TX + 2 * (bs / 2);
  return (size_t)(NE + NE + D - 1) * sizeof(uint2) +
         (size_t)bs * SC_TX * D * sizeof(int16_t);
}

template <typename CT, int BS>
static cudaError_t sc_launch_bs(const void* lpl, const void* rpl, int H, int W,
                                int D, int minX1, int W1, void* out,
                                cudaStream_t stream) {
  const size_t smem = sc_smem(D, BS);
  cudaError_t err = cudaFuncSetAttribute(
      sgm_cost_kernel<CT, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W1 + SC_TX - 1) / SC_TX, (H + SC_R - 1) / SC_R);
  sgm_cost_kernel<CT, BS><<<grid, D, smem, stream>>>(
      (const uint2*)lpl, (const uint2*)rpl, H, W, D, minX1, W1, (CT*)out);
  return cudaGetLastError();
}

template <typename CT>
static cudaError_t sc_launch(const void* lpl, const void* rpl, int H, int W,
                             int D, int bs, int minX1, int W1, void* out,
                             cudaStream_t stream) {
  switch (bs) {
    case 1: return sc_launch_bs<CT, 1>(lpl, rpl, H, W, D, minX1, W1, out, stream);
    case 3: return sc_launch_bs<CT, 3>(lpl, rpl, H, W, D, minX1, W1, out, stream);
    case 5: return sc_launch_bs<CT, 5>(lpl, rpl, H, W, D, minX1, W1, out, stream);
    case 7: return sc_launch_bs<CT, 7>(lpl, rpl, H, W, D, minX1, W1, out, stream);
    case 9: return sc_launch_bs<CT, 9>(lpl, rpl, H, W, D, minX1, W1, out, stream);
    case 11: return sc_launch_bs<CT, 11>(lpl, rpl, H, W, D, minX1, W1, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

// lpl, rpl: (H, W, 8) uint8 plane stacks; out: (H, W1, D) int16 (out_bytes
// 2) or int32 (out_bytes 4). Requires 1 <= D <= 1024 and odd bs <= 11.
extern "C" int rtdm_sgm_cost(const void* lpl, const void* rpl, int H, int W,
                             int D, int bs, int minX1, int W1, int out_bytes,
                             void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (out_bytes == 2)
    return (int)sc_launch<int16_t>(lpl, rpl, H, W, D, bs, minX1, W1, out, s);
  return (int)sc_launch<int32_t>(lpl, rpl, H, W, D, bs, minX1, W1, out, s);
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
