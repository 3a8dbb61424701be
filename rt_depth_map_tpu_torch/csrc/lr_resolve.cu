// K6: left-right consistency resolution, per row: winner search, then
// read-back; and the SGBM and BM left-right checks built on it, each one
// launch.
//
// Replaces rt_depth_map_tpu/ops/pallas/lr_resolve.py lr_resolve_pallas:
//
//   winner:    best[x2] = min over dd in [w_lo, w_lo + n_w) of key[x2 + dd]
//                         where d_match[x2 + dd] == dd (w_lo = 0 in the
//                         TPU kernel's contract; the checks start it at
//                         min_disparity)
//   disp2[x2]  = (best & (Dpow - 1)) + c0, or `invalid` without a candidate
//   read-back: out_j[x] = disp2[x - rm_j[x]] when rm_j[x] is in
//              [r_lo, r_lo + n_r) and x - rm_j[x] is in [0, W); else invalid
//
// The winner step is a scatter: every pixel x with dd = d_match[x] in range
// and x - dd in [0, W) does atomicMin(best[x - dd], key[x]) on its row, kept
// in shared memory.
// Min does not depend on order, so the result is deterministic and
// bit-exact with the shift-reduce of the TPU kernel. The TPU kernel's D-long
// loop of lane rolls is gone: each pixel does O(1) work.
//
// lr_rows is that resolve for a block of rows, shared by three entry points
// that differ only in what a pixel reads and writes (its Src):
// - rtdm_lr_resolve, the general one: d_match, key and one or two read-back
//   planes, int32, as lr_resolve_pallas takes them;
// - rtdm_lr_check_sgbm, the inline SGBM check (rt_depth_map_tpu/ops/sgbm.py
//   _lr_check_sgbm): it reads the x16 disparity and the matcher's best (a
//   disparity index; best + minD the disparity) and minS, builds the packed
//   minS * 256 + best key on the fly, reads back at the floor and the
//   ceiling of the disparity, and writes the checked int16 disparity
//   (invalid only where both read-backs disagree);
// - rtdm_lr_check_bm, cv::validateDisparity (rt_depth_map_tpu/ops/bm.py
//   _lr_check): the x16 disparity and the winner's cost, key
//   cost * 8192 + d + 2048, one read-back at the rounded disparity.
// Both checks take min_disparity minD: their windows start at minD and
// their invalid value is (minD - 1) * 16. The BM key wraps where d + 2048
// leaves [0, 8192) (minD < -127 or minD + D > 383) exactly as the
// reference's int32 key and its floor-mod decode do: & 8191 is that mod.
//
// A thread keeps PX pixels of its row in registers from the loads to the
// read-back (PX 1, 2, 4 or 8, a template parameter the host picks from the
// width): the loads are issued before the row's initialisation barrier, and
// the decode is folded into the read-back, so a row costs two block
// barriers. A block holds `rows` rows (blockDim.y) of blockDim.x threads.
//
// What bounds it on the H100. Its bytes: the fused checks read the int16
// disparity and the matcher's int32 planes once (SGBM: best, and minS only
// where the key is needed; BM: the cost only where the match lies in the
// image) and write the int16 result, about 2 + 4 + 4 + 2 B a pixel for
// SGBM (0.0068 ms at 1920x1080 D=256), 2 + 4 + 2 for BM. The SGBM launch
// takes about twice that. Timed copies (tools/time_torch_lr_speckle.py
// --ablate) put the rest in the read-backs, the dependent shared-memory
// reads after the second barrier (nearly a third of the launch); the
// barriers and the atomics cost nothing measurable, and 4 pixels a thread
// beat 8 by a third at that width (more warps in flight an SM).

#include <cuda_runtime.h>
#include <stdint.h>

#define LR_BIGKEY 0x7fffffff
#define LR_SENT (-0x7fffffff - 1)

struct LrParams {
  int H, W, w_lo, n_w, r_lo, n_r, dmask, c0, invalid;
};

// The decoded winner of column x - r of the row, or invalid.
__device__ __forceinline__ int lr_read(const int* row, int x, int r,
                                       const LrParams& p) {
  const int xs = x - r;
  if (r < p.r_lo || r >= p.r_lo + p.n_r || xs < 0 || xs >= p.W) return p.invalid;
  const int b = row[xs];
  return b != LR_BIGKEY ? (b & p.dmask) + p.c0 : p.invalid;
}

// The key of a candidate, wrapping as int32 does: a * m + b.
__device__ __forceinline__ int lr_pack(int a, unsigned m, int b) {
  return (int)((unsigned)a * m + (unsigned)b);
}

template <int PX, class Src>
__global__ void __launch_bounds__(1024) lr_rows(Src src, LrParams p) {
  extern __shared__ int rows[];  // [blockDim.y][W]: the row's best keys
  const int y = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = y < p.H;
  int* row = rows + threadIdx.y * p.W;
  typename Src::Px px[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int x = threadIdx.x + k * blockDim.x;
    if (live && x < p.W) px[k] = src.load(y, x, p);
  }
  for (int x = threadIdx.x; x < p.W; x += blockDim.x) row[x] = LR_BIGKEY;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int x = threadIdx.x + k * blockDim.x;
    if (live && x < p.W) {
      const int dd = px[k].dd, key = px[k].key;
      if (key != LR_BIGKEY && dd >= p.w_lo && dd < p.w_lo + p.n_w &&
          x - dd >= 0 && x - dd < p.W)
        atomicMin(&row[x - dd], key);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int x = threadIdx.x + k * blockDim.x;
    if (live && x < p.W) src.finish(px[k], y, x, row, p);
  }
}

// d_match, key: (H, W) int32; rm[0..n_rb): (H, W) int32; out: (n_rb, H, W).
struct GeneralSrc {
  const int32_t* __restrict__ d_match;
  const int32_t* __restrict__ key;
  const int32_t* __restrict__ rm0;
  const int32_t* __restrict__ rm1;
  int n_rb;
  int32_t* __restrict__ out;
  struct Px {
    int dd, key, r0, r1;
  };
  __device__ Px load(int y, int x, const LrParams& p) const {
    const size_t i = (size_t)y * p.W + x;
    return {d_match[i], key[i], rm0[i], n_rb > 1 ? rm1[i] : 0};
  }
  __device__ void finish(const Px& v, int y, int x, const int* row,
                         const LrParams& p) const {
    const size_t i = (size_t)y * p.W + x;
    out[i] = lr_read(row, x, v.r0, p);
    if (n_rb > 1) out[(size_t)p.H * p.W + i] = lr_read(row, x, v.r1, p);
  }
};

// disp: (H, W) int16 x16; best, minS: (H, width1) int32 over the columns
// [minX1, minX1 + width1); out: (H, W) int16.
struct SgbmSrc {
  const int16_t* __restrict__ disp;
  const int32_t* __restrict__ best;
  const int32_t* __restrict__ minS;
  int minX1, width1, min_disp, max_diff;
  int16_t* __restrict__ out;
  struct Px {
    int d16, dd, key;
    bool cols;  // x in [minX1, minX1 + width1)
  };
  __device__ Px load(int y, int x, const LrParams& p) const {
    const int j = x - minX1;
    Px v{disp[(size_t)y * p.W + x], LR_SENT, LR_BIGKEY, j >= 0 && j < width1};
    if (v.cols) {
      const size_t i = (size_t)y * width1 + j;
      const int b = best[i];
      v.dd = b + min_disp;
      const int x2 = x - v.dd;
      if (v.d16 != p.invalid && x2 >= 0 && x2 < p.W) v.key = lr_pack(minS[i], 256u, b);
    }
    return v;
  }
  __device__ void finish(const Px& v, int y, int x, const int* row,
                         const LrParams& p) const {
    int o = v.d16;
    if (v.cols && v.d16 != p.invalid) {
      const int d_lo = v.d16 >> 4, d_hi = (v.d16 + 15) >> 4;
      const int a = lr_read(row, x, d_lo, p), b = lr_read(row, x, d_hi, p);
      if (a >= min_disp && abs(a - d_lo) > max_diff && b >= min_disp &&
          abs(b - d_hi) > max_diff)
        o = p.invalid;
    }
    out[(size_t)y * p.W + x] = (int16_t)o;
  }
};

// disp: (H, W) int16 x16; cost: (H, W) int32; out: (H, W) int16.
struct BmSrc {
  const int16_t* __restrict__ disp;
  const int32_t* __restrict__ cost;
  int max_diff16;
  int16_t* __restrict__ out;
  struct Px {
    int d32, dd, key;
    bool in;  // valid, and its match x - round(d) lies in the image
  };
  __device__ Px load(int y, int x, const LrParams& p) const {
    const size_t i = (size_t)y * p.W + x;
    Px v{disp[i], 0, LR_BIGKEY, false};
    v.dd = (v.d32 + 8) >> 4;
    v.in = v.d32 != p.invalid && x - v.dd >= 0 && x - v.dd < p.W;
    if (v.in) v.key = lr_pack(cost[i], 8192u, v.d32 + 2048);
    return v;
  }
  __device__ void finish(const Px& v, int y, int x, const int* row,
                         const LrParams& p) const {
    int o = v.d32;
    if (v.in && abs(lr_read(row, x, v.dd, p) - v.d32) > max_diff16)
      o = p.invalid;
    out[(size_t)y * p.W + x] = (int16_t)o;
  }
};

// A launch over rows of W pixels: tx threads a row (whole warps of PX
// pixels each at most) and `rows` rows (ops/cuda/lr_resolve.py lr_plan).
template <int PX, class Src>
static int lr_launch_px(const Src& src, const LrParams& p, int rows, void* stream) {
  const int tx = ((p.W + PX - 1) / PX + 31) / 32 * 32;
  if (rows < 1 || tx * rows > 1024) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)rows * p.W * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lr_rows<PX, Src>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lr_rows<PX, Src><<<(p.H + rows - 1) / rows, dim3(tx, rows), smem,
                     (cudaStream_t)stream>>>(src, p);
  return (int)cudaGetLastError();
}

template <class Src>
static int lr_launch(const Src& src, const LrParams& p, int px, int rows,
                     void* stream) {
  if (p.H <= 0 || p.W <= 0) return (int)cudaSuccess;
  switch (px) {
    case 1: return lr_launch_px<1>(src, p, rows, stream);
    case 2: return lr_launch_px<2>(src, p, rows, stream);
    case 4: return lr_launch_px<4>(src, p, rows, stream);
    case 8: return lr_launch_px<8>(src, p, rows, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int rtdm_lr_resolve(const void* d_match, const void* key,
                               const void* rm0, const void* rm1, int n_rb,
                               int H, int W, int w_lo, int n_w, int r_lo,
                               int n_r, int Dpow, int c0, int invalid, int px,
                               int rows, void* out, void* stream) {
  if (n_rb < 1 || n_rb > 2) return (int)cudaErrorInvalidValue;
  const GeneralSrc src{(const int32_t*)d_match, (const int32_t*)key,
                       (const int32_t*)rm0, (const int32_t*)rm1, n_rb,
                       (int32_t*)out};
  return lr_launch(src,
                   LrParams{H, W, w_lo, n_w, r_lo, n_r, Dpow - 1, c0, invalid},
                   px, rows, stream);
}

// The SGBM check at min_disparity minD: invalid (minD - 1) * 16, c0 minD,
// Dpow 256, the winner over [minD, minD + D), read-backs over
// [minD - 1, minD + D + 1).
extern "C" int rtdm_lr_check_sgbm(const void* disp, const void* best,
                                  const void* minS, int H, int W, int minX1,
                                  int width1, int num_disp, int min_disp,
                                  int max_diff, int px, int rows, void* out,
                                  void* stream) {
  const SgbmSrc src{(const int16_t*)disp, (const int32_t*)best,
                    (const int32_t*)minS, minX1, width1, min_disp, max_diff,
                    (int16_t*)out};
  return lr_launch(src,
                   LrParams{H, W, min_disp, num_disp, min_disp - 1, num_disp + 2,
                            255, min_disp, (min_disp - 1) * 16},
                   px, rows, stream);
}

// The BM check at min_disparity minD: invalid (minD - 1) * 16, key
// cost * 8192 + d + 2048 (c0 -2048), the winner and the read-back over
// [minD, minD + D + 1).
extern "C" int rtdm_lr_check_bm(const void* disp, const void* cost, int H,
                                int W, int num_disp, int min_disp,
                                int max_diff, int px, int rows, void* out,
                                void* stream) {
  const BmSrc src{(const int16_t*)disp, (const int32_t*)cost, max_diff * 16,
                  (int16_t*)out};
  return lr_launch(src,
                   LrParams{H, W, min_disp, num_disp + 1, min_disp, num_disp + 1,
                            8191, -2048, (min_disp - 1) * 16},
                   px, rows, stream);
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
