// K3: SGBM matching cost, Birchfield-Tomasi on the preprocessed planes plus
// a block_size x block_size window sum, into the (H, W1, D) cost volume.
//
// Replaces rt_depth_map_tpu/ops/pallas/sgm_cost.py:283
// sgm_cost_volume_pallas, whose contract is rt_depth_map_tpu/ops/sgbm.py
// sgbm_cost_volume at any min_disparity minD:
//
//   pix(y, x, d) = BT(sobel planes) + (BT(raw planes) >> 2) of left column
//                  x against right column x - minD - d, 0 where that
//                  column leaves the image
//   C(y, j, d)   = sum over |dy|, |dx| <= bs/2 of
//                  pix(clamp(y + dy, 0, H-1), minX1 + clamp(j + dx, 0, W1-1), d)
//
// for the output columns j in [x_begin, x_begin + Wout) of [0, W1): the whole
// range (x_begin 0, Wout W1), or one tile's columns of it (the exact width
// tiling of rt_depth_map_tpu/parallel/exact_sgbm.py:74, whose tiles keep the
// replicate border of the whole range),
//
// i.e. the window replicates at the edges of the cropped range
// [minX1, minX1 + W1), not at the image's; minX1 = max(minD + D, 0) and
// W1 = W + min(minD, 0) - minX1 keep every right column of that range
// inside the image, so minD is only an offset of the right columns. Each image arrives as an (H, W, 8)
// uint8 plane stack prepared by the wrapper: the clipped x-Sobel response,
// its half-pixel min and max, the raw image, its half-pixel min and max, and
// two zero bytes, so a pixel's planes are one 8-byte load.
//
// What bounds it on the H100: integer operations, not bytes. The volume
// write (212 MB at 1280x720, D = 128, int16) takes 0.063 ms at 3.35 TB/s;
// the function needs ~21 integer operations an element, 0.15 ms at 64 int32
// lanes per SM per clock (132 SMs, 1.755 GHz). The first design spent ~80:
// it computed each pixel cost 1.4 times, unpacked 12 plane bytes and
// clamped a column index for every (column, d), and loaded each row
// synchronously between two barriers.
//
// Design: a block owns SC_TX = 16 output columns of a stripe of SC_R = 64
// rows and SC_ND = 128 disparities (grid.z splits larger D), one thread per
// d; each pixel cost is computed (16 + bs - 1) / 16 * (64 + bs - 1) / 64
// times an output (1.33 at bs 5). 32 columns compute fewer (1.19) but hold
// twice the registers a thread and were no faster (tools/sweep_sgm_tiles.py).
// Per input row of the stripe:
//
// - The row's plane bytes (the tile's left window columns and the right
//   columns they meet at x - d) are copied with cp.async into one of two
//   raw buffers, a row ahead of the arithmetic; one barrier a row.
// - The block converts each column once into three packed words, the
//   sobel plane in the low 16 bits and the raw plane in the high ones, each
//   with a bias of 256 folded in where it is subtracted from, so that one
//   32-bit subtraction gives both planes' differences, positive, without a
//   borrow across the halves. Left columns are written per window column
//   (the edge clamp is resolved here, once per tile and row).
// - A thread computes its d's pixel cost of each window column from one
//   16-byte load of each side: four subtractions, two three-way maxima and
//   a minimum on both halves at once (Hopper's 16x2 min/max), and the
//   quarter-weighted sum, ~10 operations. A pixel cost carries +320 (the
//   two halves' biases), which the output removes as 320 * bs^2 once.
// - The horizontal window sums slide along the row; a ring of the last bs
//   rows' horizontal sums (int16 in shared memory, owned by the thread)
//   keeps the vertical running sums in registers. Once bs rows are in, each
//   new row finishes one output row: coalesced stores along d.
//
// A right column outside the image holds planes (0, 0, 255) against which
// every BT cost is 0, so the "0 where x - d leaves the image" rule costs
// nothing in the inner loop.

#include <stdint.h>

#include "async_copy.cuh"

#define SC_TX 16   // output columns a block
#define SC_R 64    // output rows a block
#define SC_ND 128  // disparities a block
#define SC_BIAS 0x01000100u  // 256 in each 16-bit half
#define SC_PIX_BIAS 320      // 256 + (256 >> 2): what a pixel cost carries

// Launches of sgm_cost_kernel made by this library, read through ctypes.
extern "C" int rtdm_sgm_cost_kernel_launches = 0;

__device__ __forceinline__ unsigned sc_min2(unsigned a, unsigned b) {
  unsigned r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// A column's planes, packed as (p, p1 - bias, p0 + bias), each word
// sobel | raw << 16: p the pixel's planes, p1 their half-pixel max, p0
// their half-pixel min.
__device__ __forceinline__ uint4 sc_pack(uint2 v) {
  const unsigned p = __byte_perm(v.x, v.y, 0x7360);   // bytes 0, 3
  const unsigned p0 = __byte_perm(v.x, v.y, 0x7461);  // bytes 1, 4
  const unsigned p1 = __byte_perm(v.x, v.y, 0x7562);  // bytes 2, 5
  return make_uint4(p, p1 - SC_BIAS, p0 + SC_BIAS, 0u);
}

// A right column outside the image: planes (v, v0, v1) = (0, 0, 255).
__device__ __forceinline__ uint4 sc_none() {
  return make_uint4(0u, 0x00ff00ffu - SC_BIAS, SC_BIAS, 0u);
}

// BT(sobel) + (BT(raw) >> 2) + SC_PIX_BIAS of left column l, right column r:
// c0 = max(0, u - v1, v0 - u), c1 = max(0, v - u1, u0 - v), each + 256 in
// both halves, whose values stay in [1, 511].
__device__ __forceinline__ int sc_cost(uint4 l, uint4 r) {
  const unsigned c0 = __vimax3_u16x2(l.x - r.y, r.z - l.x, SC_BIAS);
  const unsigned c1 = __vimax3_u16x2(r.x - l.y, l.z - r.x, SC_BIAS);
  const unsigned bt = sc_min2(c0, c1);
  return (int)(bt & 0xffffu) + (int)(bt >> 18);
}

// The pixel costs of a thread's d along the tile's window columns. Rc is
// the right buffer offset by the thread's d; CLAMP: the window leaves
// [0, W1) and column e meets right column clamp(jw0 + e, 0, W1 - 1) - jl0.
template <int NE, bool CLAMP>
__device__ __forceinline__ void sc_row_costs(const uint4* Lc, const uint4* Rc,
                                             int jw0, int W1, int jl0,
                                             int (&pix)[NE]) {
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int li = CLAMP ? min(max(jw0 + e, 0), W1 - 1) - jl0 : e;
    pix[e] = sc_cost(Lc[e], Rc[li]);
  }
}

template <int BS>
struct ScShape {
  static constexpr int W2 = BS / 2;
  static constexpr int NE = SC_TX + 2 * W2;     // window columns of a tile
  static constexpr int NP = 2 * NE + SC_ND - 1;  // left + right columns
  // packed [2][NP] uint4, raw [2][NP] uint2, ring [BS][SC_TX][SC_ND] int16
  static constexpr size_t smem =
      2 * NP * (sizeof(uint4) + sizeof(uint2)) + BS * SC_TX * SC_ND * 2;
};

// BATCH: blockIdx.y runs over the stripes of every frame
// (rtdm_sgm_cost_batch); without it the kernel is the single-frame one,
// instruction for instruction.
template <typename CT, int BS, bool BATCH>
__global__ void __launch_bounds__(SC_ND)
sgm_cost_kernel(const uint2* __restrict__ lpl, const uint2* __restrict__ rpl,
                int H, int W, int D, int minD, int minX1, int W1,
                int x_begin, int Wout, CT* __restrict__ out) {
  constexpr int W2 = ScShape<BS>::W2;
  constexpr int NE = ScShape<BS>::NE;
  constexpr int NP = ScShape<BS>::NP;
  extern __shared__ __align__(16) unsigned char sc_smem[];
  uint4* pk = reinterpret_cast<uint4*>(sc_smem);
  uint2* raw = reinterpret_cast<uint2*>(pk + 2 * NP);
  int16_t* ring = reinterpret_cast<int16_t*>(raw + 2 * NP);

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int dlo = blockIdx.z * SC_ND;
  const int dhi = min(dlo + SC_ND, D);
  const int d = dlo + tid;
  const bool active = d < dhi;
  const int j0 = x_begin + blockIdx.x * SC_TX;
  const int jw0 = j0 - W2;                   // window column 0, unclamped
  const int jl0 = max(jw0, 0);               // first left column held
  const int nl = min(j0 + SC_TX + W2, W1) - jl0;
  const int j_end = x_begin + Wout;          // the window's end
  const int lx0 = minX1 + jl0;               // its image column
  const int xr0 = lx0 - minD - (dhi - 1);    // image column of right column 0
  const int nr = nl + (dhi - dlo) - 1;
  const bool clamp = jw0 < 0 || j0 + SC_TX + W2 > W1;
  int y0 = blockIdx.y * SC_R;
  if constexpr (BATCH) {
    // blockIdx.y: frame f's stripe; every row index below stays inside the
    // frame, whose planes and volume the pointers move to
    const int stripes = (H + SC_R - 1) / SC_R;
    const int f = blockIdx.y / stripes;
    y0 = (blockIdx.y - f * stripes) * SC_R;
    lpl += (size_t)f * H * W;
    rpl += (size_t)f * H * W;
    out += (size_t)f * H * Wout * D;
  }
  const int n_in = (min(y0 + SC_R, H) - y0) + 2 * W2;  // input rows

  // input row r's plane bytes into raw buffer b: left columns at [0, nl),
  // right columns inside the image at NE + c
  auto fetch = [&](int r, int b) {
    const int y = min(max(y0 - W2 + r, 0), H - 1);
    const uint2* lrow = lpl + (size_t)y * W + lx0;
    const uint2* rrow = rpl + (size_t)y * W;
    uint2* dst = raw + b * NP;
    for (int c = tid; c < nl; c += nthr) cp_async8(dst + c, lrow + c);
    for (int c = tid; c < nr; c += nthr)
      if (xr0 + c >= 0) cp_async8(dst + NE + c, rrow + xr0 + c);
    cp_async_commit();
  };
  // raw buffer b into packed buffer b: left per window column, right per
  // column
  auto convert = [&](int b) {
    const uint2* src = raw + b * NP;
    uint4* dst = pk + b * NP;
    for (int e = tid; e < NE; e += nthr)
      dst[e] = sc_pack(src[min(max(jw0 + e, 0), W1 - 1) - jl0]);
    for (int c = tid; c < nr; c += nthr)
      dst[NE + c] = xr0 + c >= 0 ? sc_pack(src[NE + c]) : sc_none();
  };

  int vs[SC_TX];  // vertical running sums of the output columns
#pragma unroll
  for (int j = 0; j < SC_TX; ++j) vs[j] = 0;

  fetch(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  convert(0);
  if (n_in > 1) fetch(1, 1);

  for (int r = 0; r < n_in; ++r) {
    // row r + 1's bytes are in and row r is packed; every thread is done
    // with row r - 1's buffers
    cp_async_wait<0>();
    __syncthreads();
    if (r + 2 < n_in) fetch(r + 2, r & 1);
    if (r + 1 < n_in) convert((r + 1) & 1);
    if (!active) continue;

    const uint4* Lc = pk + (r & 1) * NP;
    const uint4* Rc = Lc + NE + (dhi - 1 - d);
    int pix[NE];
    if (clamp)
      sc_row_costs<NE, true>(Lc, Rc, jw0, W1, jl0, pix);
    else
      sc_row_costs<NE, false>(Lc, Rc, jw0, W1, jl0, pix);

    // horizontal window sums; the ring slot of this row replaces the one
    // that left the vertical window
    int16_t* slot = ring + (r % BS) * SC_TX * SC_ND + tid;
    const bool full = r >= BS;
    int h = 0;
#pragma unroll
    for (int e = 0; e < BS - 1; ++e) h += pix[e];
#pragma unroll
    for (int j = 0; j < SC_TX; ++j) {
      h += pix[j + BS - 1];
      const int old = full ? (int)slot[j * SC_ND] : 0;
      slot[j * SC_ND] = (int16_t)h;
      vs[j] += h - old;
      h -= pix[j];
    }

    if (r >= 2 * W2) {
      const int yo = y0 + r - 2 * W2;  // the output row this row completes
      CT* o = out + ((size_t)yo * Wout + (j0 - x_begin)) * D + d;
#pragma unroll
      for (int j = 0; j < SC_TX; ++j)
        if (j0 + j < j_end) o[(size_t)j * D] = (CT)(vs[j] - SC_PIX_BIAS * BS * BS);
    }
  }
}

template <typename CT, int BS>
static cudaError_t sc_launch_bs(const void* lpl, const void* rpl, int B, int H,
                                int W, int D, int minD, int minX1, int W1,
                                int x_begin, int Wout, void* out,
                                cudaStream_t stream) {
  const size_t smem = ScShape<BS>::smem;
  const void* kernel = B > 1 ? (const void*)sgm_cost_kernel<CT, BS, true>
                             : (const void*)sgm_cost_kernel<CT, BS, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wout + SC_TX - 1) / SC_TX, B * ((H + SC_R - 1) / SC_R),
                  (D + SC_ND - 1) / SC_ND);
  const dim3 block(D < SC_ND ? D : SC_ND);
  if (B > 1)
    sgm_cost_kernel<CT, BS, true><<<grid, block, smem, stream>>>(
        (const uint2*)lpl, (const uint2*)rpl, H, W, D, minD, minX1, W1,
        x_begin, Wout, (CT*)out);
  else
    sgm_cost_kernel<CT, BS, false><<<grid, block, smem, stream>>>(
        (const uint2*)lpl, (const uint2*)rpl, H, W, D, minD, minX1, W1,
        x_begin, Wout, (CT*)out);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++rtdm_sgm_cost_kernel_launches;
  return err;
}

template <typename CT>
static cudaError_t sc_launch(const void* lpl, const void* rpl, int B, int H,
                             int W, int D, int bs, int minD, int minX1, int W1,
                             int x_begin, int Wout, void* out,
                             cudaStream_t stream) {
#define SC_ARGS lpl, rpl, B, H, W, D, minD, minX1, W1, x_begin, Wout, out, stream
  switch (bs) {
    case 1: return sc_launch_bs<CT, 1>(SC_ARGS);
    case 3: return sc_launch_bs<CT, 3>(SC_ARGS);
    case 5: return sc_launch_bs<CT, 5>(SC_ARGS);
    case 7: return sc_launch_bs<CT, 7>(SC_ARGS);
    case 9: return sc_launch_bs<CT, 9>(SC_ARGS);
    case 11: return sc_launch_bs<CT, 11>(SC_ARGS);
#undef SC_ARGS
    default: return cudaErrorInvalidValue;
  }
}

// lpl, rpl: (B, H, W, 8) uint8 plane stacks (bytes 6 and 7 zero); out:
// (B, H, Wout, D) int16 (out_bytes 2) or int32 (out_bytes 4): for each frame,
// the columns [x_begin, x_begin + Wout) of the volume over the image columns
// [minX1, minX1 + W1) at min_disparity minD. One launch for all B frames
// (blockIdx.y runs over the frames' stripes). Requires B >= 1,
// 1 <= D <= 1024, odd bs <= 11, minX1 = max(minD + D, 0),
// W1 = W + min(minD, 0) - minX1 >= 1 and 0 <= x_begin < x_begin + Wout <= W1.
extern "C" int rtdm_sgm_cost_batch(const void* lpl, const void* rpl, int B,
                                   int H, int W, int D, int bs, int minD,
                                   int minX1, int W1, int x_begin, int Wout,
                                   int out_bytes, void* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || B * ((H + SC_R - 1) / SC_R) > 65535 ||
      minX1 != (minD + D > 0 ? minD + D : 0) ||
      W1 != W + (minD < 0 ? minD : 0) - minX1 || W1 < 1 || x_begin < 0 ||
      Wout < 1 || x_begin + Wout > W1)
    return (int)cudaErrorInvalidValue;
  if (out_bytes == 2)
    return (int)sc_launch<int16_t>(lpl, rpl, B, H, W, D, bs, minD, minX1, W1,
                                   x_begin, Wout, out, s);
  return (int)sc_launch<int32_t>(lpl, rpl, B, H, W, D, bs, minD, minX1, W1,
                                 x_begin, Wout, out, s);
}

// One frame: rtdm_sgm_cost_batch at B = 1.
extern "C" int rtdm_sgm_cost(const void* lpl, const void* rpl, int H, int W,
                             int D, int bs, int minD, int minX1, int W1,
                             int x_begin, int Wout, int out_bytes, void* out,
                             void* stream) {
  return rtdm_sgm_cost_batch(lpl, rpl, 1, H, W, D, bs, minD, minX1, W1,
                             x_begin, Wout, out_bytes, out, stream);
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
