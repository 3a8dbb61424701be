// The port's one vertical SGM scan: the three directions (dy,-1), (dy,0),
// (dy,+1) of one sense in a single row-synchronous cooperative launch.
//
// It serves K5 (sgm_vert_wta.cu: two launches, down then up, for the six
// vertical and diagonal paths of the bidir route) and the chained passes
// K9c, K9d and K11 (sgm_hdw.cu: one launch each). A launch walks the rows
// once, in either sense (dy = +1 top to bottom, dy = -1 bottom to top),
// carries all three directions of its sense at once, and ends each pixel
// with one of two final steps:
//
// - WTA = false: S_out = S_in + L(dy,0) + L(dy,+1) + L(dy,-1), or the three
//   L alone when there is no S_in (S_in == nullptr). K5's first launch
//   (int32 S_in = Sh, int32 S_out), K9c (int16 or int32 partial and output,
//   C's type) and K11 (int32, either sense).
// - WTA = true: the pixel's total S_in + the three L is complete in
//   registers, where the winner-take-all, the uniqueness test and the
//   subpixel step run (sgm_wta); only the four (H, W1) outputs are stored.
//   K5's second launch (int32 S_in) and K9d (C's type).
//
// The element types of C (CT), S_in (SI) and S_out (SO) are int16 or int32;
// every value is int32 in registers and a sum is stored in SO by
// truncation, so the caller guarantees that it fits. The recurrence, and
// the zero carry at every scanline start (also a diagonal entering from a
// side column), are those of sgm_path.cuh (sgm_step).
//
// What bounds it on the H100: the serial chain of H row steps, not bytes.
// One scan per direction moved 18 (K9c at int16) to 56 (K5, six int32
// launches) bytes per volume element; this design reads C and S_in once
// and writes S_out once (6 bytes an element for K9c at int16, 4 for K9d).
//
// A block owns a band of contiguous columns, m columns a warp, D over the
// lanes (K = D / 32 per lane, as in sgm_path.cuh). The wrapper plans the
// bands (ops/cuda/sgm_vert_wta.py vert_plan) so that every band is
// resident at once: at most VB_MAX_WARPS warps a band, and more than one
// column a warp only where W1 needs more warps than the resident blocks
// hold (W1 > 16 x resident blocks: 3840x2160 at D = 128). Within a row
// step a warp steps its columns one after another, since within a row
// every column depends only on the previous row. A warp keeps the vertical
// carry of a one-column warp in registers; with m > 1 each owned column's
// vertical carry lives in shared memory beside its diagonal carries.
//
// A warp copies each of its pixels' C and S_in D-vectors ahead into a ring
// in shared memory with cp.async, whose copies complete without the warp
// (holding loaded values in registers across rows does not keep them in
// flight: the compiler moves them, and a move waits for its load); where a
// pixel's D elements are not whole 16-byte pieces it loads a few pixels
// ahead into registers instead. The ring follows the warp's own order of
// pixels (row step, then its columns), so it serves any m.
//
// The diagonal carries cross columns: after each pixel a warp leaves its
// (dy,+1) L for the column to the right and its (dy,-1) L for the column to
// the left in shared memory (double-buffered by row parity; one
// __syncthreads a row). At a band's edges they go through device memory
// instead, in slots (one per row parity) of 64-bit words that hold the
// value and a tag naming its row step: the neighbouring band's edge warp
// polls the words until every tag names the row it needs. A word is stored
// and loaded whole, so no fence or separate flag is needed (a fence would
// also wait for the warp's loads in flight). A carry from outside the image
// is zero. A row step thus costs each warp m dependent chains of three
// steps (warp minimum, shuffles), a barrier and, at a band's edge, one poll
// of device memory.
//
// Each band waits on both neighbours before it steps a row, so bands
// advance within a row of each other, and a slot is never overwritten
// before its reader has stepped past it: a band writes row s + 2 only after
// its neighbour published row s + 1, which it did after reading row s. The
// spin-wait needs every band resident at once: the launch is cooperative,
// which guarantees that or refuses the launch (then the wrapper raises). No
// thread block clusters are used.
//
// Row step s of a launch is tagged tag0 + s. A single-launch call passes
// tag0 = 1 with a freshly zeroed edge buffer; K5's second launch passes
// tag0 = H + 1, so it cannot take a word the first one left.
//
// BATCH (K5's batched entry only): the launch covers F frames of the same
// shape, (F, H, W1, D) volumes and (F, H, W1) outputs, one after another in
// memory. blockIdx.y is the frame and owns gridDim.x whole bands of it and
// their edge slots; a frame's first and last bands are image borders, so no
// carry crosses from one frame to the next (the TPU kernel's `seg`). With
// BATCH false the kernel is the single-frame one, instruction for
// instruction.

#pragma once

#include <type_traits>

#include "async_copy.cuh"
#include "sgm_path.cuh"

#define VB_MAX_WARPS 16

typedef unsigned long long vb_word;  // (row tag << 32) | (uint32) carry

// Launches of sgm_vert3_kernel made by this library (one a call of K9c,
// K9d and K11, two of K5), read by the tests through ctypes.
extern "C" int rtdm_sgm_vert_kernel_launches = 0;

__device__ __forceinline__ void vb_put(vb_word* p, unsigned tag, int v) {
  const vb_word w = ((vb_word)tag << 32) | (unsigned)v;
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ vb_word vb_get(const vb_word* p) {
  vb_word w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(p)
               : "memory");
  return w;
}

// A neighbouring band's carry of the row tagged `tag`: poll the lane's
// words until all of them hold that row.
template <int K>
__device__ __forceinline__ void vb_wait(const vb_word* src, unsigned tag,
                                        const bool (&ok)[K], int (&out)[K]) {
  bool ready;
  do {
    ready = true;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ok[k]) {
        const vb_word w = vb_get(src + k);
        ready &= (unsigned)(w >> 32) == tag;
        out[k] = (int)(unsigned)w;
      }
    }
  } while (!ready);
}

template <int K>
__device__ __forceinline__ void vb_publish(vb_word* dst, unsigned tag,
                                           const bool (&ok)[K],
                                           const int (&L)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (ok[k]) vb_put(dst + k, tag, L[k]);
}

// A lane's K elements at p (the lane's d0 within a D-vector) into int32
// registers, or from them, truncated to T. vec: the K elements are whole
// and aligned (D % K == 0 and all of them inside D), so they move as one
// vector: a warp's 32 lanes then touch contiguous words, where K scalar
// accesses K words apart each hit the same banks of shared memory K times
// over. Elements past D read as 0 and are not written.
template <typename T, int K>
__device__ __forceinline__ void vb_get_lane(const T* p, bool vec,
                                            const bool (&ok)[K],
                                            int (&out)[K]) {
  if (vec) {
    const LaneVec<T, K> v = *reinterpret_cast<const LaneVec<T, K>*>(p);
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = (int)v.v[k];
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = ok[k] ? (int)p[k] : 0;
  }
}

template <typename T, int K>
__device__ __forceinline__ void vb_put_lane(T* p, bool vec,
                                            const bool (&ok)[K],
                                            const int (&in)[K]) {
  if (vec) {
    LaneVec<T, K> v;
#pragma unroll
    for (int k = 0; k < K; ++k) v.v[k] = (T)in[k];
    *reinterpret_cast<LaneVec<T, K>*>(p) = v;
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (ok[k]) p[k] = (T)in[k];
  }
}

// Pixels of C and S_in a warp loads ahead of the pixel it steps: into
// registers (the register path), or into a ring in shared memory.
template <int K>
struct VbPrefetch {
  static constexpr int rows = K <= 4 ? 4 : 2;
  static constexpr int ring = K <= 4 ? 8 : 4;  // a power of 2
};

// Dynamic shared memory of a block: [2 parities][cols][2 dirs][D] int32
// diagonal carries, with m > 1 also [cols][D] int32 vertical carries, then
// with ASYNC [warps][ring][D] SI rows and [warps][ring][D] CT rows.
__host__ __device__ inline size_t vb_smem_bytes(int warps, int m, int D,
                                                int ring, bool async,
                                                int c_bytes, int s_bytes) {
  const size_t cols = (size_t)warps * m;
  const size_t carries = (4 + (m > 1 ? 1 : 0)) * cols * D * 4;
  return carries +
         (async ? (size_t)warps * ring * D * (c_bytes + s_bytes) : 0);
}

// m: columns a warp; up: dy = -1 (rows bottom to top), else dy = +1.
// edge: [bands][2 sides][2 parities][D] tagged words. Side 0 is a band's
// first column's (dy,-1) L (read by the band to its left), side 1 its last
// column's (dy,+1) L (read by the band to its right).
// ASYNC: a pixel's D elements of C and of S_in are whole 16-byte pieces,
// copied a ring of pixels ahead with cp.async (else the register path).
// MULTI: m > 1; a one-column warp (MULTI false) compiles to one pixel and
// one barrier a row step, with its vertical carry in registers.
template <typename CT, typename SI, typename SO, int K, bool WTA, bool ASYNC,
          bool MULTI, bool BATCH>
__global__ void __launch_bounds__(VB_MAX_WARPS * 32, 1)
sgm_vert3_kernel(const CT* __restrict__ C, const SI* __restrict__ S_in,
                 SO* __restrict__ S_out, int H, int W1, int D, int m_arg,
                 int up, unsigned tag0, int p1, int p2, vb_word* edge,
                 SgmWtaOut wta) {
  if constexpr (BATCH) {  // frame blockIdx.y's volumes, outputs and slots
    const size_t px = (size_t)blockIdx.y * H * W1;
    C += px * D;
    if (S_in != nullptr) S_in += px * D;
    if (S_out != nullptr) S_out += px * D;
    edge += (size_t)blockIdx.y * gridDim.x * 4 * D;
    if constexpr (WTA) {
      wta.best += px;
      wta.minS += px;
      wta.dval += px;
      wta.uniq += px;
    }
  }
  constexpr int PF = VbPrefetch<K>::rows;
  constexpr int RING = VbPrefetch<K>::ring;
  extern __shared__ int32_t vb_smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int m = MULTI ? m_arg : 1;  // columns a warp
  const int warps = blockDim.x >> 5;
  const int cols = warps * m;  // columns a band
  const int band = blockIdx.x, nbands = gridDim.x;
  const int col0 = band * cols + w * m;  // the warp's first column
  const bool has_in = S_in != nullptr;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;
  // whole, aligned vectors: every lane's K elements lie inside D
  const bool vec = D % K == 0 && d0 + K <= D;
  // shared memory moves a lane's K elements as a vector only at K = 8,
  // where K scalar accesses conflict 8 ways: on an H100 at 700 W that took
  // K9c at 1920x1080, D = 256 from 3.79 to 2.37 ms, while at K = 4 the
  // vectors cost more than the 4-way conflicts (K5 at 1280x720, D = 128:
  // 2.25 -> 2.59 ms; tools/time_torch_vert_cc.py)
  const bool vsm = K >= 8 && vec;
  auto slot = [&](int b, int side, int par) {
    return edge + ((size_t)(b * 2 + side) * 2 + par) * D + d0;
  };
  auto shared = [&](int par, int c, int dir) {
    return vb_smem + ((par * cols + c) * 2 + dir) * D + d0;
  };
  int32_t* lv_smem = vb_smem + 4 * cols * D;  // m > 1: vertical carries
  auto row_of = [&](int s) { return up ? H - 1 - s : s; };
  // the element offset of the warp's pixel (row step s, its column j)
  auto pix = [&](int s, int j) {
    return ((size_t)row_of(s) * W1 + col0 + j) * D;
  };

  char* ring_base = reinterpret_cast<char*>(
      vb_smem + (4 + (m > 1 ? 1 : 0)) * cols * D);
  SI* ring_s = reinterpret_cast<SI*>(ring_base) + (size_t)w * RING * D;
  CT* ring_c = reinterpret_cast<CT*>(ring_base + (size_t)warps * RING * D *
                                                     sizeof(SI)) +
               (size_t)w * RING * D;
  // the next pixel to load ahead: row step ls, the warp's column lj
  int ls = 0, lj = 0, lq = 0;
  auto advance = [&]() {
    ++lq;
    if (++lj == m) {
      lj = 0;
      ++ls;
    }
  };
  // ASYNC: the next pixel's rows into ring slot lq % RING, then one commit
  // group (also past the last pixel and for a column outside the image, so
  // that a step always waits for the same count)
  auto fetch = [&]() {
    if (ls < H && col0 + lj < W1) {
      const size_t o = pix(ls, lj);
      const int sl = lq & (RING - 1);
      const char* gc = reinterpret_cast<const char*>(C + o);
      char* sc = reinterpret_cast<char*>(ring_c + sl * D);
      for (int q = lane; q < D * (int)sizeof(CT) / 16; q += 32)
        cp_async16(sc + 16 * q, gc + 16 * q);
      if (has_in) {
        const char* gs = reinterpret_cast<const char*>(S_in + o);
        char* ss = reinterpret_cast<char*>(ring_s + sl * D);
        for (int q = lane; q < D * (int)sizeof(SI) / 16; q += 32)
          cp_async16(ss + 16 * q, gs + 16 * q);
      }
    }
    cp_async_commit();
    advance();
  };
  // the register path: the next pixel's C and S_in into a register slot
  auto load = [&](LaneVec<CT, K>& c, LaneVec<SI, K>& sv) {
    if (ls < H && col0 + lj < W1) {
      const size_t o = pix(ls, lj) + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (ok[k]) {
          c.v[k] = __ldg(C + o + k);
          sv.v[k] = has_in ? __ldg(S_in + o + k) : (SI)0;
        }
      }
    }
    advance();
  };

  LaneVec<CT, K> cr[PF];
  LaneVec<SI, K> sr[PF];
  if constexpr (ASYNC) {
    for (int r = 0; r + 1 < RING; ++r) fetch();
  } else {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cr[j].v[k] = 0;
        sr[j].v[k] = 0;
      }
      load(cr[j], sr[j]);
    }
  }
  int Lv1[K];  // the (dy, 0) carry of a one-column warp
#pragma unroll
  for (int k = 0; k < K; ++k) Lv1[k] = 0;

  const int steps = H * m;  // the warp's pixels, row step by row step
  int s = 0, j = 0;         // the pixel: row step s, the warp's column j
  for (int q0 = 0; q0 < steps; q0 += PF) {
#pragma unroll
    for (int jj = 0; jj < PF; ++jj) {
      if (q0 + jj >= steps) break;  // uniform over the block
      const int q = q0 + jj;
      const int c_idx = w * m + j;  // the column within the band
      const int x = col0 + j;
      int c[K], sv[K];
      if constexpr (ASYNC) {
        // pixel q + RING - 1 goes out; pixel q, RING - 1 groups older, is in
        fetch();
        cp_async_wait<RING - 1>();
        __syncwarp();  // the pixel's pieces came through every lane
        const int sl = q & (RING - 1);
        vb_get_lane<CT, K>(ring_c + sl * D + d0, vsm, ok, c);
        if (has_in) {
          vb_get_lane<SI, K>(ring_s + sl * D + d0, vsm, ok, sv);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) sv[k] = 0;
        }
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          c[k] = (int)cr[jj].v[k];
          sv[k] = (int)sr[jj].v[k];
        }
        load(cr[jj], sr[jj]);
      }
      if (x < W1) {
        const int y = row_of(s);
        const bool left_edge = c_idx == 0 && band > 0;
        const bool right_edge = c_idx == cols - 1 && band + 1 < nbands;
        // the diagonal carries of the previous row: (dy,+1) from column
        // x - 1, (dy,-1) from column x + 1; at a band's edge from the
        // neighbouring band, else from shared memory
        int Pr[K], Pl[K], Lv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) Pr[k] = Pl[k] = Lv[k] = 0;
        if (!MULTI) {
#pragma unroll
          for (int k = 0; k < K; ++k) Lv[k] = Lv1[k];
        } else if (s > 0) {
          vb_get_lane<int32_t, K>(lv_smem + (size_t)c_idx * D + d0, vsm, ok,
                                  Lv);
        }
        if (s > 0) {
          const int ppar = (s - 1) & 1;
          const unsigned ptag = tag0 + s - 1;
          if (left_edge)
            vb_wait<K>(slot(band - 1, 1, ppar), ptag, ok, Pr);
          else if (x > 0)
            vb_get_lane<int32_t, K>(shared(ppar, c_idx - 1, 0), vsm, ok, Pr);
          if (right_edge)
            vb_wait<K>(slot(band + 1, 0, ppar), ptag, ok, Pl);
          else if (x + 1 < W1)
            vb_get_lane<int32_t, K>(shared(ppar, c_idx + 1, 1), vsm, ok, Pl);
        }
        int Lr[K], Ll[K], L[K];
        sgm_step<K>(c, Pr, ok, d0, D, p1, p2, Lr);
        sgm_step<K>(c, Pl, ok, d0, D, p1, p2, Ll);
        sgm_step<K>(c, Lv, ok, d0, D, p1, p2, L);
        const int par = s & 1;
        // publish the band's edge carries before the rest of the pixel: the
        // neighbour waits on them (a one-column band's warp is both edges)
        if (right_edge) vb_publish<K>(slot(band, 1, par), tag0 + s, ok, Lr);
        if (left_edge) vb_publish<K>(slot(band, 0, par), tag0 + s, ok, Ll);
        vb_put_lane<int32_t, K>(shared(par, c_idx, 0), vsm, ok, Lr);
        vb_put_lane<int32_t, K>(shared(par, c_idx, 1), vsm, ok, Ll);
        if (MULTI)
          vb_put_lane<int32_t, K>(lv_smem + (size_t)c_idx * D + d0, vsm, ok, L);
        int tot[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!MULTI) Lv1[k] = L[k];
          tot[k] = sv[k] + L[k] + Lr[k] + Ll[k];
        }
        if constexpr (!WTA) {
          vb_put_lane<SO, K>(S_out + ((size_t)y * W1 + x) * D + d0, vec, ok,
                             tot);
        } else {
          sgm_wta<K>(tot, ok, d0, D, lane, wta, (long long)y * W1 + x);
        }
      }
      if (++j == m) {  // the row step is done: uniform over the block
        j = 0;
        ++s;
        __syncthreads();
      }
    }
  }
}

// Whether a launch takes the cp.async ring: the pixels' D-vectors of C and
// S_in are whole 16-byte pieces.
template <typename CT, typename SI>
inline bool vb_async(int D) {
  return D * sizeof(CT) % 16 == 0 && D * sizeof(SI) % 16 == 0;
}

template <typename CT, typename SI, typename SO, int K, bool WTA,
          bool BATCH = false>
static const void* vb_kernel(bool async, bool multi) {
  if (multi)
    return async
        ? (const void*)sgm_vert3_kernel<CT, SI, SO, K, WTA, true, true, BATCH>
        : (const void*)sgm_vert3_kernel<CT, SI, SO, K, WTA, false, true, BATCH>;
  return async
      ? (const void*)sgm_vert3_kernel<CT, SI, SO, K, WTA, true, false, BATCH>
      : (const void*)sgm_vert3_kernel<CT, SI, SO, K, WTA, false, false, BATCH>;
}

template <typename CT, typename SI, typename SO, int K, bool WTA>
static size_t vb_smem_of(int warps, int m, int D) {
  return vb_smem_bytes(warps, m, D, VbPrefetch<K>::ring,
                       vb_async<CT, SI>(D), sizeof(CT), sizeof(SI));
}

// One launch of ceil(W1 / (warps * m)) bands of `warps` warps; BATCH: that
// many bands for each of `frames` frames.
template <typename CT, typename SI, typename SO, int K, bool WTA, bool BATCH>
static cudaError_t vb_launch_k(const CT* C, const SI* S_in, SO* S_out, int H,
                               int W1, int D, int warps, int m, int up,
                               unsigned tag0, int p1, int p2, vb_word* edge,
                               SgmWtaOut wta, cudaStream_t stream,
                               int frames) {
  if (warps < 1 || warps > VB_MAX_WARPS || m < 1 || frames < 1 ||
      (!BATCH && frames != 1))
    return cudaErrorInvalidValue;
  const int bands = (W1 + warps * m - 1) / (warps * m);
  const void* kernel =
      vb_kernel<CT, SI, SO, K, WTA, BATCH>(vb_async<CT, SI>(D), m > 1);
  const size_t smem = vb_smem_of<CT, SI, SO, K, WTA>(warps, m, D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&C,  (void*)&S_in, (void*)&S_out, (void*)&H,
                  (void*)&W1, (void*)&D,    (void*)&m,     (void*)&up,
                  (void*)&tag0, (void*)&p1, (void*)&p2,    (void*)&edge,
                  (void*)&wta};
  err = cudaLaunchCooperativeKernel(kernel, dim3(bands, frames),
                                    dim3(warps * 32), args, smem, stream);
  if (err == cudaSuccess) ++rtdm_sgm_vert_kernel_launches;
  return err;
}

// Blocks of this kernel resident at once on the current device for a band
// of `warps` warps and m columns a warp (0 when it cannot launch at all).
template <typename CT, typename SI, typename SO, int K, bool WTA, bool BATCH>
static cudaError_t vb_resident_k(int D, int warps, int m, int* blocks) {
  *blocks = 0;
  const void* kernel =
      vb_kernel<CT, SI, SO, K, WTA, BATCH>(vb_async<CT, SI>(D), m > 1);
  const size_t smem = vb_smem_of<CT, SI, SO, K, WTA>(warps, m, D);
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      warps * 32, smem);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// f(std::integral_constant<int, K>) with K the disparities per lane
// (D <= 32 * K, D <= 256).
template <typename F>
static cudaError_t vb_by_k(int D, F f) {
  if (D <= 32) return f(std::integral_constant<int, 1>{});
  if (D <= 64) return f(std::integral_constant<int, 2>{});
  if (D <= 128) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

// BATCH: `frames` frames in one launch (K5's batched entry).
template <typename CT, typename SI, typename SO, bool WTA, bool BATCH = false>
static cudaError_t vb_launch(const CT* C, const SI* S_in, SO* S_out, int H,
                             int W1, int D, int warps, int m, int up,
                             unsigned tag0, int p1, int p2, vb_word* edge,
                             SgmWtaOut wta, cudaStream_t stream,
                             int frames = 1) {
  return vb_by_k(D, [&](auto k) {
    return vb_launch_k<CT, SI, SO, decltype(k)::value, WTA, BATCH>(
        C, S_in, S_out, H, W1, D, warps, m, up, tag0, p1, p2, edge, wta,
        stream, frames);
  });
}

template <typename CT, typename SI, typename SO, bool WTA, bool BATCH = false>
static cudaError_t vb_resident(int D, int warps, int m, int* blocks) {
  return vb_by_k(D, [&](auto k) {
    return vb_resident_k<CT, SI, SO, decltype(k)::value, WTA, BATCH>(
        D, warps, m, blocks);
  });
}
