// K9a-K9d and K11: the chained SGM passes, one direction set per call.
//
// Replaces the single-direction Pallas passes of the TPU's chained SGM route
// (rt_depth_map_tpu/ops/sgbm.py stereo_sgbm when the fused bidirectional
// kernels are off: num_paths 4 and 5, and 8 paths at H % 16 != 0):
//
//   rtdm_sgm_horiz_pass  one horizontal direction (0,+1) or (0,-1), plus an
//                        optional partial: ops/pallas/sgm_hdw.py
//                        sgm_horiz_pass_dh (K9a, x-major (W1, D, H) on the
//                        TPU) and sgm_horiz_pass_hdw (K9b, (W1, H, D)). The
//                        port's volumes keep D contiguous, so both are the
//                        x-major (W1, H, D) form here; the row-major
//                        (H, W1, D) form is the same scan with other strides.
//   rtdm_sgm_vert_pass   the three directions (dy,0), (dy,+1), (dy,-1) with
//                        dy = +1 (top-down) or -1 (bottom-up), plus an
//                        optional partial: sgm_hdw.py sgm_down_pass_hdw (K9c,
//                        top-down) and ops/pallas/sgm_scan.py
//                        sgm_aggregate_vertical (K11, either sense).
//   rtdm_sgm_final_wta   the same three directions added to a partial, then
//                        winner-take-all, uniqueness and subpixel: sgm_hdw.py
//                        sgm_final_wta_hdw (K9d, either sense).
//
// The horizontal pass is a warp-per-row scan (below): one warp a row, D
// over its lanes, each warp fed from a ring of cp.async copies in shared
// memory. The two vertical
// entry points are one cooperative launch each of the row-synchronous scan
// of sgm_vert.cuh, K5's kernel: all three directions of a sense in one walk
// over the rows, reading C and the partial once and writing the sum once
// (6 bytes an element at int16), or doing the winner-take-all from
// registers (4 bytes an element). As on the TPU, the outputs of the first
// two entry points take C's element type: with int16 C they hold at most
// five directions' sums, which fit int16 (the wrapper checks the bound on
// P1 and P2; volume_dtype bounds C). The final pass never stores a sum:
// each pixel's total of the partial and the three directions stays in
// int32 registers for the WTA.

#include "sgm_vert.cuh"

// K9a/K9b, the horizontal pass. What bounds it on the H100: device memory
// bytes, and the step's integer instructions. It reads C (and the partial)
// once and writes the sum once: 4 bytes an element at int16 without a
// partial, 6 with one (0.55 and 0.82 ms at 1920x1080, D = 256, at 3.35
// TB/s). Each row is a chain of W1 dependent steps and only H warps walk
// them (~8 on each SM at 1080 rows), so every warp keeps its own bytes in
// flight, and each step must issue few integer instructions (64 int32
// lanes an SM: a warp instruction every two cycles on each scheduler).
// With the copies and stores taken out, the step alone takes 0.43 ms at
// 1920x1080, D = 256 on an H100 (tools/time_torch_horiz_pass.py --ablate).
//
// Design: one warp a row, D over its lanes (sgm_step), a block of `rows`
// warps that never wait on each other. Each warp fills a ring of `ring`
// slots in shared memory with cp.async, ring - 1 pixels ahead of its step,
// one commit group a step: a slot holds one pixel's C vector and, when a
// partial is added, its S_in vector. A copy moves one pixel's D contiguous
// elements, so the row-major and x-major layouts differ only in the
// strides. Each lane reads its K elements of a slot as one vector and
// stores its K sums as one vector. The plan (ring, rows) is a pure
// function of the shape and the SM count (ops/cuda/sgm_hdw.py
// horiz_pass_plan). Pixels whose D elements are not
// whole 16-byte pieces (D * sizeof(T) % 16 != 0, as D = 100 at int16), or
// volumes that do not start on 16 bytes, take the register path: ordinary
// loads at the step, correct, slower.

// CUDA launches of the horizontal pass made by this library (one a call)
extern "C" int rtdm_sgm_horiz_pass_kernel_launches = 0;

// Bytes of a warp's ring at most: deeper than any plan needs, and 16 slots
// of int32 pixels with a partial at D > 128 (32 KB) spill a register.
#define HP_RING_BYTES 16384

// Pixel (y, x) of C, S_in and S_out starts at element y * sy + x * sx; the
// warp visits x = 0 .. W1 - 1 (dx = 1) or W1 - 1 .. 0 (dx = -1). ADD:
// S_out = S_in + L, else S_out = L, truncated to T. ASYNC: the ring path.
// To keep the step's integer instructions few, every address advances by
// one pixel a step instead of being recomputed, each lane's 16-byte pieces
// of a pixel are fixed before the scan, and where D % K == 0 the step is
// sgm_step_whole.
template <typename T, int K, int RING, bool ADD, bool ASYNC>
__device__ __forceinline__ void hp_scan(const T* __restrict__ C,
                                        const T* S_in, T* S_out, int H,
                                        int W1, int D, long long sy,
                                        long long sx, int dx, int p1, int p2,
                                        T* smem) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int y = blockIdx.x * (blockDim.x >> 5) + w;
  if (y >= H) return;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;
  const bool whole = D % K == 0;  // every lane whole or empty
  const bool vec = whole && d0 + K <= D;
  const bool vec_out =
      vec && (uintptr_t)S_out % sizeof(LaneVec<T, K>) == 0;
  // elements to the first pixel visited, and from one pixel to the next
  const long long first = y * sy + (dx > 0 ? 0 : (long long)(W1 - 1) * sx);
  const long long next = dx > 0 ? sx : -sx;
  T* out = S_out + first + d0;
  const T* c_at = C + first + d0;  // the register path's loads
  const T* s_at = ADD ? S_in + first + d0 : nullptr;

  // The ring: RING slots of one pixel's C, then (ADD) its S_in. A lane
  // copies at most NP of a pixel's 16-byte pieces.
  constexpr int NP = ((ADD ? 2 : 1) * K * (int)sizeof(T) + 15) / 16;
  const int pieces = D * (int)sizeof(T) / 16;  // of one vector
  const int slot = (ADD ? 2 : 1) * D * (int)sizeof(T);  // bytes
  const int ring_bytes = RING * slot;
  char* ring = reinterpret_cast<char*>(smem) + (size_t)w * ring_bytes;
  const char* src[NP];  // piece j of the first pixel
  int dst[NP];          // its byte offset in a slot; -1: no piece
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int q = lane + 32 * j;
    const bool is_c = !ADD || q < pieces;
    dst[j] = q < (ADD ? 2 : 1) * pieces ? 16 * q : -1;
    src[j] = reinterpret_cast<const char*>((is_c ? C : S_in) + first) +
             16 * (is_c ? q : q - pieces);
  }
  const long long next_bytes = next * (long long)sizeof(T);
  // pixel f, next_bytes * f bytes from the first, into the slot at soff
  auto fetch = [&](int f, long long off, int soff) {
    if (f >= W1) return;
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (dst[j] >= 0) cp_async16(ring + soff + dst[j], src[j] + off);
  };
  long long f_off = 0;  // the next copy's pixel, f = s + RING - 1
  int f_slot = 0, r_slot = 0;  // its slot, and step s's
  if constexpr (ASYNC) {
    for (int f = 0; f + 1 < RING; ++f) {
      fetch(f, f_off, f_slot);
      cp_async_commit();
      f_off += next_bytes;
      f_slot += slot;
    }
  }

  int Lp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) Lp[k] = 0;
  for (int s = 0; s < W1; ++s) {
    int c[K], sv[K];
    if constexpr (ASYNC) {
      __syncwarp();  // every lane is done with the slot the next copy fills
      fetch(s + RING - 1, f_off, f_slot);
      cp_async_commit();
      cp_async_wait<RING - 1>();
      __syncwarp();  // the step's pieces came through every lane
      const T* r = reinterpret_cast<const T*>(ring + r_slot) + d0;
      vb_get_lane<T, K>(r, vec, ok, c);
      if constexpr (ADD) vb_get_lane<T, K>(r + D, vec, ok, sv);
      f_off += next_bytes;
      f_slot = f_slot + slot == ring_bytes ? 0 : f_slot + slot;
      r_slot = r_slot + slot == ring_bytes ? 0 : r_slot + slot;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] = ok[k] ? (int)__ldg(c_at + k) : 0;
        if constexpr (ADD) sv[k] = ok[k] ? (int)s_at[k] : 0;
      }
      c_at += next;
      if constexpr (ADD) s_at += next;
    }
    int L[K];
    if (whole)
      sgm_step_whole<K>(c, Lp, d0, D, p1, p2, L);
    else
      sgm_step<K>(c, Lp, ok, d0, D, p1, p2, L);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Lp[k] = L[k];
      if constexpr (ADD) L[k] += sv[k];
    }
    vb_put_lane<T, K>(out, vec_out, ok, L);
    out += next;
  }
}

// The ring path and the register path, kernels of their own so that
// ptxas reports each.
template <typename T, int K, int RING, bool ADD>
__global__ void __launch_bounds__(128)
hp_ring_kernel(const T* __restrict__ C, const T* S_in, T* S_out, int H,
               int W1, int D, long long sy, long long sx, int dx, int p1,
               int p2) {
  extern __shared__ __align__(32) unsigned char hp_smem[];
  hp_scan<T, K, RING, ADD, true>(C, S_in, S_out, H, W1, D, sy, sx, dx, p1,
                                 p2, reinterpret_cast<T*>(hp_smem));
}

template <typename T, int K, bool ADD>
__global__ void __launch_bounds__(128)
hp_reg_kernel(const T* __restrict__ C, const T* S_in, T* S_out, int H,
              int W1, int D, long long sy, long long sx, int dx, int p1,
              int p2) {
  hp_scan<T, K, 4, ADD, false>(C, S_in, S_out, H, W1, D, sy, sx, dx, p1, p2,
                               nullptr);
}

template <typename T, int K, bool ADD>
static cudaError_t hp_launch(const T* C, const T* S_in, T* S_out, int H,
                            int W1, int D, bool x_major, int dx, int p1,
                            int p2, int ring, int rows, cudaStream_t stream) {
  const size_t slot = (ADD ? 2 : 1) * D * sizeof(T);
  if (rows < 1 || rows > 4 || (ring != 4 && ring != 8 && ring != 16) ||
      ring * slot > HP_RING_BYTES)
    return cudaErrorInvalidValue;
  const long long sy = x_major ? D : (long long)W1 * D;
  const long long sx = x_major ? (long long)H * D : D;
  const bool async = D * sizeof(T) % 16 == 0 && (uintptr_t)C % 16 == 0 &&
                     (!ADD || (uintptr_t)S_in % 16 == 0);
  // 16 slots of this K's widest pixels would pass HP_RING_BYTES
  constexpr bool ring16 = 16 * (ADD ? 2 : 1) * 32 * K * sizeof(T) <= HP_RING_BYTES;
  const void* kernel = nullptr;
  if (!async)
    kernel = (const void*)hp_reg_kernel<T, K, ADD>;
  else if (ring == 4)
    kernel = (const void*)hp_ring_kernel<T, K, 4, ADD>;
  else if (ring == 8)
    kernel = (const void*)hp_ring_kernel<T, K, 8, ADD>;
  else if constexpr (ring16)
    kernel = (const void*)hp_ring_kernel<T, K, 16, ADD>;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const size_t smem = async ? rows * ring * slot : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&C,  (void*)&S_in, (void*)&S_out, (void*)&H,
                  (void*)&W1, (void*)&D,    (void*)&sy,    (void*)&sx,
                  (void*)&dx, (void*)&p1,   (void*)&p2};
  err = cudaLaunchKernel(kernel, dim3((H + rows - 1) / rows), dim3(32 * rows),
                         args, smem, stream);
  if (err == cudaSuccess) ++rtdm_sgm_horiz_pass_kernel_launches;
  return err;
}

// C, partial, out: (H, W1, D), or (W1, H, D) when x_major, all int16
// (c_bytes 2) or all int32 (c_bytes 4); partial may be null. out = L of the
// direction (0, reverse ? -1 : +1), plus partial. ring (4, 8 or 16 slots a
// warp, at most HP_RING_BYTES) and rows (1-4 warps a block): the plan of
// ops/cuda/sgm_hdw.py horiz_pass_plan. Requires D <= 256. One launch.
extern "C" int rtdm_sgm_horiz_pass(const void* C, int c_bytes,
                                   const void* partial, void* out, int H,
                                   int W1, int D, int x_major, int reverse,
                                   int p1, int p2, int ring, int rows,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int dx = reverse ? -1 : 1;
  const bool xm = x_major != 0;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using T = decltype(tag);
    const T* Cv = (const T*)C;
    const T* Sv = (const T*)partial;
    T* O = (T*)out;
    return vb_by_k(D, [&](auto k) {
      constexpr int K = decltype(k)::value;
      if (Sv == nullptr)
        return hp_launch<T, K, false>(Cv, Sv, O, H, W1, D, xm, dx, p1, p2,
                                      ring, rows, s);
      return hp_launch<T, K, true>(Cv, Sv, O, H, W1, D, xm, dx, p1, p2, ring,
                                   rows, s);
    });
  });
}

// C, partial, out: (H, W1, D), all int16 (c_bytes 2) or all int32; partial
// may be null. out = partial + L(dy,0) + L(dy,+1) + L(dy,-1), dy = reverse ?
// -1 : +1. warps, m: the band plan (ops/cuda/sgm_vert_wta.py vert_plan);
// edge: ceil(W1 / (warps * m)) * 4 * D zeroed 64-bit words. Requires
// D <= 256. One cooperative launch.
extern "C" int rtdm_sgm_vert_pass(const void* C, int c_bytes,
                                  const void* partial, void* out, void* edge,
                                  int H, int W1, int D, int warps, int m,
                                  int reverse, int p1, int p2, void* stream) {
  const SgmWtaOut none = {nullptr, nullptr, nullptr, nullptr, 0};
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vb_launch<CT, CT, CT, false>(
        (const CT*)C, (const CT*)partial, (CT*)out, H, W1, D, warps, m,
        reverse, 1u, p1, p2, (vb_word*)edge, none, (cudaStream_t)stream);
  });
}

// C, partial: (H, W1, D), both int16 (c_bytes 2) or both int32; best,
// minS, dval, uniq: (H, W1) int32: the winner-take-all of
// S = partial + L(dy,0) + L(dy,+1) + L(dy,-1), dy = reverse ? -1 : +1.
// warps, m, edge: as for rtdm_sgm_vert_pass. Requires D <= 256. One
// cooperative launch.
extern "C" int rtdm_sgm_final_wta(const void* C, int c_bytes,
                                  const void* partial, void* edge, int H,
                                  int W1, int D, int warps, int m, int reverse,
                                  int p1, int p2, int uniqueness_ratio,
                                  void* best, void* minS, void* dval,
                                  void* uniq, void* stream) {
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vb_launch<CT, CT, CT, true>(
        (const CT*)C, (const CT*)partial, (CT*)nullptr, H, W1, D, warps, m,
        reverse, 1u, p1, p2, (vb_word*)edge, out, (cudaStream_t)stream);
  });
}

// Blocks of the vertical pass (wta 0) or the final pass (wta 1) resident
// at once on the current device, for a band of `warps` warps of m columns;
// into *blocks.
extern "C" int rtdm_sgm_vert_resident(int c_bytes, int wta, int D, int warps,
                                      int m, int* blocks) {
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return wta ? vb_resident<CT, CT, CT, true>(D, warps, m, blocks)
               : vb_resident<CT, CT, CT, false>(D, warps, m, blocks);
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
