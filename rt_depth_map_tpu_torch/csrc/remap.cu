// Fixed-point bilinear remap of uint8 planes through packed map tables.
//
// Replaces rt_depth_map_tpu/ops/pallas/remap_plan.py remap_bilinear_planned
// (and the gather of ops/remap.py remap_bilinear, uint8 path). On the TPU the
// gather was slow, so the JAX package planned a static select network per
// map, and its engine stacked the left gray and RGB planes into one
// 4-channel image to fill the lanes. Hopper gathers well, so this is a
// gather with no stack: one launch samples every plane of both views, each
// plane from its own source into its own contiguous output.
//
// Semantics (bit-exact with the JAX uint8 path): 1/32-px fractions fx, fy,
// weights (32-fx)(32-fy), fx(32-fy), (32-fx)fy, fx*fy summing to 1024,
// rounded by (acc + 512) >> 10; taps outside the image read 0; pixels whose
// window lies fully outside the image (valid == 0) write 0.
//
// The table: one 8-byte word per output pixel (ops/remap.py pack_table),
// ix and iy as int16 in the low word (both 0 where valid == 0), fx | fy << 5
// | valid << 10 in the high word. The quantization stays on the host, so the
// card does integer arithmetic only.
//
// What bounds it on the H100: device memory bytes. For the rectify pair it
// reads each view's table once (8 B a pixel), the sources (1 + 3 + 1 B)
// and writes the outputs (1 + 3 + 1 B): 26 B a pixel. The design:
// - a thread owns 4 consecutive output pixels (outputs and tables are
//   contiguous, so the 4 may span a row end): its 4 table words come in
//   two 16-byte loads, and a plane of C channels leaves as C 32-bit
//   stores (one 16-byte store at C = 4); the last, partial quad stores
//   byte by byte;
// - taps are byte loads through the read-only path, at coordinates clamped
//   into the image whose weights are zeroed where the tap lies outside, so
//   no load leaves the image and no branch depends on the border: output
//   neighbours sample neighbouring source bytes, and L1 serves most taps;
// - blockIdx.y picks the view, so one launch covers both views' planes;
//   blockIdx.z picks the frame of a batch (rtdm_rectify_pair_batch: B
//   frames of both views, the same tables, each frame sampling only its own
//   source, so no frame's border taps reach another frame). The JAX
//   package's batched form row-stacks the B sources behind a zero guard
//   row and redirects fully outside windows to a sentinel
//   (rt_depth_map_tpu/pipeline/engine.py:312-352); a frame index needs
//   neither.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

#define RM_THREADS 256
#define RM_MAX_SIDE 32767  // ix and iy are int16 in the table

// Launches of remap_u8_kernel made by this library, read through ctypes.
extern "C" int rtdm_remap_kernel_launches = 0;

// One plane of a view: a (H, W, C) source and its (n, C) output.
struct RmPlane {
  const uint8_t* src;
  uint8_t* dst;
  int C;
};

// A view: its table and up to two planes sampled through it.
struct RmView {
  const uint2* table;
  RmPlane plane[2];
  int n_planes;
};

// One launch: up to two views over sources of H x W, n output pixels each,
// for each frame of a batch (frame f's planes f * H * W * C and f * n * C
// bytes after frame 0's).
struct RmArgs {
  RmView view[2];
  int H, W, n;
};

// A pixel's four taps: offsets (y * W + x) of its clamped window and the
// weights, 0 for a tap outside the image and for every tap of an invalid
// pixel.
struct RmTaps {
  int o00, o01, o10, o11;
  int w00, w01, w10, w11;
};

__device__ __forceinline__ RmTaps rm_taps(uint2 word, int H, int W) {
  const int x0 = (int16_t)(word.x & 0xffffu);
  const int y0 = (int16_t)(word.x >> 16);
  const int ax = word.y & 31, ay = (word.y >> 5) & 31;
  const bool valid = (word.y >> 10) & 1;
  // valid implies x0 in [-1, W-1] and y0 in [-1, H-1]
  const bool left = valid && x0 >= 0, right = valid && x0 + 1 < W;
  const bool top = y0 >= 0, bottom = y0 + 1 < H;
  const int xa = max(x0, 0), xb = min(x0 + 1, W - 1);
  const int ra = max(y0, 0) * W, rb = min(y0 + 1, H - 1) * W;
  RmTaps t;
  t.o00 = ra + xa;
  t.o01 = ra + xb;
  t.o10 = rb + xa;
  t.o11 = rb + xb;
  t.w00 = top && left ? (32 - ax) * (32 - ay) : 0;
  t.w01 = top && right ? ax * (32 - ay) : 0;
  t.w10 = bottom && left ? (32 - ax) * ay : 0;
  t.w11 = bottom && right ? ax * ay : 0;
  return t;
}

// Channel c of a C-channel source at the taps of t.
template <int C>
__device__ __forceinline__ uint32_t rm_sample(const uint8_t* src,
                                              const RmTaps& t, int c) {
  const int acc = __ldg(src + t.o00 * C + c) * t.w00 +
                  __ldg(src + t.o01 * C + c) * t.w01 +
                  __ldg(src + t.o10 * C + c) * t.w10 +
                  __ldg(src + t.o11 * C + c) * t.w11;
  return (uint32_t)((acc + 512) >> 10);
}

// The quad's m pixels (m = 4 but for the last quad) of one C-channel plane:
// C 32-bit words (4 pixels x C bytes) stored whole, or m * C bytes. BATCH:
// of the frame whose source and output start src_off and dst_off pixels
// after frame 0's, stored whole only where its output keeps the words'
// alignment (a later frame's does not where n * C is not a multiple of it).
template <int C, bool BATCH>
__device__ __forceinline__ void rm_plane(const RmPlane& pl, const RmTaps (&t)[4],
                                         int p0, int m, size_t src_off,
                                         size_t dst_off) {
  const uint8_t* src = BATCH ? pl.src + src_off * C : pl.src;
  uint32_t w[C];
#pragma unroll
  for (int j = 0; j < C; ++j) w[j] = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int b = k * C + c;  // byte of the quad's 4 * C
      w[b / 4] |= rm_sample<C>(src, t[k], c) << (8 * (b % 4));
    }
  uint8_t* dst = pl.dst + ((BATCH ? dst_off : 0) + p0) * C;
  constexpr uintptr_t align = C == 3 ? 4 : 4 * C;
  if (m == 4 && (!BATCH || ((uintptr_t)dst & (align - 1)) == 0)) {
    if constexpr (C == 3) {
#pragma unroll
      for (int j = 0; j < 3; ++j) ((uint32_t*)dst)[j] = w[j];
    } else {
      LaneVec<uint32_t, C> v;
#pragma unroll
      for (int j = 0; j < C; ++j) v.v[j] = w[j];
      *(LaneVec<uint32_t, C>*)dst = v;
    }
  } else {
#pragma unroll
    for (int b = 0; b < 4 * C; ++b)
      if (b < m * C) dst[b] = (uint8_t)(w[b / 4] >> (8 * (b % 4)));
  }
}

// BATCH: blockIdx.z is the frame (rtdm_rectify_pair_batch); without it the
// kernel is the single-frame one, instruction for instruction.
template <bool BATCH>
__global__ void __launch_bounds__(RM_THREADS) remap_u8_kernel(const RmArgs a) {
  const int p0 = 4 * (blockIdx.x * RM_THREADS + threadIdx.x);
  if (p0 >= a.n) return;
  // selects, not an index into the parameters (which would go through
  // local memory)
  const RmView v = blockIdx.y == 0 ? a.view[0] : a.view[1];
  const int m = min(4, a.n - p0);
  const size_t f = BATCH ? blockIdx.z : 0;  // the frame
  const size_t src_off = f * a.H * a.W, dst_off = f * a.n;
  uint2 word[4];
  if (m == 4) {
    const uint4 q0 = __ldg((const uint4*)(v.table + p0));
    const uint4 q1 = __ldg((const uint4*)(v.table + p0 + 2));
    word[0] = make_uint2(q0.x, q0.y);
    word[1] = make_uint2(q0.z, q0.w);
    word[2] = make_uint2(q1.x, q1.y);
    word[3] = make_uint2(q1.z, q1.w);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word[k] = k < m ? __ldg(v.table + p0 + k) : make_uint2(0, 0);
  }
  RmTaps t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) t[k] = rm_taps(word[k], a.H, a.W);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= v.n_planes) break;
    const RmPlane& pl = v.plane[i];
    switch (pl.C) {  // uniform over the block
      case 1: rm_plane<1, BATCH>(pl, t, p0, m, src_off, dst_off); break;
      case 2: rm_plane<2, BATCH>(pl, t, p0, m, src_off, dst_off); break;
      case 3: rm_plane<3, BATCH>(pl, t, p0, m, src_off, dst_off); break;
      default: rm_plane<4, BATCH>(pl, t, p0, m, src_off, dst_off); break;
    }
  }
}

static bool rm_aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

static int rm_launch(const RmArgs& a, int n_views, int frames, void* stream) {
  if (a.H < 1 || a.W < 1 || a.H > RM_MAX_SIDE || a.W > RM_MAX_SIDE || a.n < 0 ||
      frames < 1 || frames > 65535)
    return (int)cudaErrorInvalidValue;
  for (int v = 0; v < n_views; ++v) {
    if (!rm_aligned(a.view[v].table)) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < a.view[v].n_planes; ++i) {
      const RmPlane& pl = a.view[v].plane[i];
      if (pl.C < 1 || pl.C > 4 || !rm_aligned(pl.dst))
        return (int)cudaErrorInvalidValue;
    }
  }
  if (a.n > 0) {
    const int quads = (a.n + 3) / 4;
    const dim3 grid((quads + RM_THREADS - 1) / RM_THREADS, n_views, frames);
    if (frames > 1)
      remap_u8_kernel<true><<<grid, RM_THREADS, 0, (cudaStream_t)stream>>>(a);
    else
      remap_u8_kernel<false><<<grid, RM_THREADS, 0, (cudaStream_t)stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err == cudaSuccess) ++rtdm_remap_kernel_launches;
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// One image: img (H, W, C <= 4) uint8 through an (n) table of packed words
// into out (n, C). table and out 16-byte aligned; H, W <= 32767.
extern "C" int rtdm_remap_u8(const void* table, int n, const void* img, int H,
                             int W, int C, void* out, void* stream) {
  RmArgs a = {};
  a.H = H;
  a.W = W;
  a.n = n;
  a.view[0].table = (const uint2*)table;
  a.view[0].n_planes = 1;
  a.view[0].plane[0] = RmPlane{(const uint8_t*)img, (uint8_t*)out, C};
  return rm_launch(a, 1, 1, stream);
}

// Both views of B stereo pairs in one launch: each frame's left gray
// (H, W) and RGB (H, W, 3) through the left table into its lrect (n) and
// rgbr (n, 3), its right gray through the right table into its rrect (n);
// sources and outputs (B, ...) contiguous. Tables and frame 0's outputs
// 16-byte aligned; H, W <= 32767.
extern "C" int rtdm_rectify_pair_batch(const void* ltable, const void* rtable,
                                       int n, int B, int H, int W,
                                       const void* lgray, const void* lrgb,
                                       const void* rgray, void* lrect,
                                       void* rgbr, void* rrect, void* stream) {
  RmArgs a = {};
  a.H = H;
  a.W = W;
  a.n = n;
  a.view[0].table = (const uint2*)ltable;
  a.view[0].n_planes = 2;
  a.view[0].plane[0] = RmPlane{(const uint8_t*)lgray, (uint8_t*)lrect, 1};
  a.view[0].plane[1] = RmPlane{(const uint8_t*)lrgb, (uint8_t*)rgbr, 3};
  a.view[1].table = (const uint2*)rtable;
  a.view[1].n_planes = 1;
  a.view[1].plane[0] = RmPlane{(const uint8_t*)rgray, (uint8_t*)rrect, 1};
  return rm_launch(a, 2, B, stream);
}

// One stereo pair: rtdm_rectify_pair_batch at B = 1.
extern "C" int rtdm_rectify_pair(const void* ltable, const void* rtable, int n,
                                 int H, int W, const void* lgray,
                                 const void* lrgb, const void* rgray,
                                 void* lrect, void* rgbr, void* rrect,
                                 void* stream) {
  return rtdm_rectify_pair_batch(ltable, rtable, n, 1, H, W, lgray, lrgb,
                                 rgray, lrect, rgbr, rrect, stream);
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
