// K5: the six vertical and diagonal SGM paths, then winner-take-all, in two
// row-synchronous launches.
//
// Replaces rt_depth_map_tpu/ops/pallas/sgm_bidir.py sgm_vert_bidir_wta_hdw:
// from the cost volume C and the horizontal sum Sh, the total
// S = Sh + sum of L over the directions (+1,0), (+1,+1), (+1,-1), (-1,0),
// (-1,+1), (-1,-1), and per pixel (best, minS, dval, uniq), each (H, W1)
// int32 (the contract of rt_depth_map_tpu/ops/sgbm.py wta_uniq_subpix). The
// recurrence, and the zero carry at every scanline start (also a diagonal
// entering from a side column), are those of sgm_path.cuh.
//
// What bounds it on the H100: the serial chain of H row steps, not bytes.
// A scan per direction (six launches adding into one int32 S) moved ~56
// bytes per volume element; this design moves 16 (1.7 GB at 1280x720,
// D = 128, 0.51 ms at 3.35 TB/s). Like the TPU kernel, which keeps
// row-wide carries of three directions on chip, each launch walks the rows
// once and carries all three directions of its sense at once:
//
// - Launch 1 (down): (+1,-1), (+1,0), (+1,+1), rows top to bottom. It reads
//   C and Sh once and writes S = Sh + the three L once (int32).
// - Launch 2 (up): (-1,-1), (-1,0), (-1,+1), rows bottom to top. It reads C
//   and S once; each pixel's total S + the three L is complete in
//   registers, where the winner-take-all, the uniqueness test and the
//   subpixel step run (sgm_wta). Only the four (H, W1) outputs are stored.
//
// A block owns a band of columns, a warp per column, D over the lanes
// (K = D / 32 per lane, as in sgm_path.cuh); the wrapper sizes the bands so
// that every SM holds one (at most VB_MAX_COLS columns: W1 = 1152 on 132
// SMs gives 128 bands of 9). A warp keeps its column's vertical carry in
// registers. It copies each pixel's C and S_in rows ahead into a ring in
// shared memory with cp.async, whose copies complete without the warp
// (holding loaded values in registers across rows does not keep them in
// flight: the compiler moves them, and a move waits for its load); where a
// pixel's D elements are not whole 16-byte pieces it loads a few rows ahead
// into registers instead. The diagonal carries cross
// columns: after each row a warp leaves its (dy,+1) L for its right
// neighbour and its (dy,-1) L for its left one in shared memory
// (double-buffered by row parity; one __syncthreads a row). At a band's
// edges they go through device memory instead, in slots (one per row
// parity) of 64-bit words that hold the value and a tag naming its row: the
// neighbouring band's edge warp polls the words until every tag names the
// row it needs. A word is stored and loaded whole, so no fence or separate
// flag is needed (a fence would also wait for the warp's loads in flight).
// A carry from outside the image is zero. A row step thus costs a warp's
// dependent chain of three steps (warp minimum, shuffles), a barrier and,
// at a band's edge, one poll of device memory.
//
// Each band waits on both neighbours before it steps a row, so bands
// advance within a row of each other, and a slot is never overwritten
// before its reader has stepped past it: a band writes row s + 2 only after
// its neighbour published row s + 1, which it did after reading row s. The
// spin-wait needs every band resident at once: the launch is cooperative,
// which guarantees that or refuses the launch (then the wrapper raises). No
// thread block clusters are used.

#include "async_copy.cuh"
#include "sgm_path.cuh"

#define VB_MAX_COLS 16

typedef unsigned long long vb_word;  // (row tag << 32) | (uint32) carry

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

// Rows of C and S_in a warp loads ahead of the row it steps: into
// registers (the register path), or into a ring in shared memory.
template <int K>
struct VbPrefetch {
  static constexpr int rows = K <= 4 ? 4 : 2;
  static constexpr int ring = K <= 4 ? 8 : 4;  // a power of 2
};

// UP = false: launch 1 (S_in = Sh, writes S_out = S). UP = true: launch 2
// (S_in = S, writes the WTA outputs). edge: [bands][2 sides][2 parities][D]
// tagged words, zero before launch 1. Side 0 is a band's first column's
// (dy,-1) L (read by the band to its left), side 1 its last column's
// (dy,+1) L (read by the band to its right). Row step s is tagged s + 1 in
// launch 1 and H + s + 1 in launch 2, so neither launch can take a word
// the other left.
// ASYNC: a pixel's D elements of C and of S_in are whole 16-byte pieces,
// copied a ring of rows ahead with cp.async (else the register path).
template <typename CT, int K, bool UP, bool ASYNC>
__global__ void __launch_bounds__(VB_MAX_COLS * 32, 1)
sgm_vert3_kernel(const CT* __restrict__ C, const int32_t* __restrict__ S_in,
                 int32_t* __restrict__ S_out, int H, int W1, int D, int p1,
                 int p2, vb_word* edge, SgmWtaOut wta) {
  constexpr int PF = VbPrefetch<K>::rows;
  constexpr int RING = VbPrefetch<K>::ring;
  // [2 parities][cols][2 dirs][D] carries; with ASYNC then [cols][RING][D]
  // int32 rows of S_in and [cols][RING][D] rows of C
  extern __shared__ int32_t vb_smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int cols = blockDim.x >> 5;
  const int band = blockIdx.x, nbands = gridDim.x;
  const int x = band * cols + w;
  const bool live = x < W1;
  const bool left_edge = w == 0 && band > 0;
  const bool right_edge = w == cols - 1 && band + 1 < nbands;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;
  // whole, aligned vectors: every lane's K elements lie inside D
  const bool vec = D % K == 0 && d0 + K <= D;
  auto slot = [&](int b, int side, int par) {
    return edge + ((size_t)(b * 2 + side) * 2 + par) * D + d0;
  };
  auto shared = [&](int par, int col, int dir) {
    return vb_smem + ((par * cols + col) * 2 + dir) * D + d0;
  };
  auto row_of = [&](int s) { return UP ? H - 1 - s : s; };
  // the register path: C and S_in of row step s into a ring slot
  auto load = [&](int s, LaneVec<CT, K>& c, LaneVec<int32_t, K>& sv) {
    const size_t o = ((size_t)row_of(s) * W1 + x) * D + d0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ok[k]) {
        c.v[k] = __ldg(C + o + k);
        sv.v[k] = __ldg(S_in + o + k);
      }
    }
  };
  const unsigned tag0 = UP ? H + 1 : 1;  // the tag of row step 0

  int32_t* ring_s = vb_smem + 4 * cols * D + (size_t)w * RING * D;
  CT* ring_c = reinterpret_cast<CT*>(vb_smem + 4 * cols * D +
                                     (size_t)cols * RING * D) +
               (size_t)w * RING * D;
  // the rows of step s into ring slot s % RING, then one commit group (also
  // past the last row, so that a step always waits for the same count)
  auto fetch = [&](int s) {
    if (s < H) {
      const size_t o = ((size_t)row_of(s) * W1 + x) * D;
      const int slot = s & (RING - 1);
      const char* gc = reinterpret_cast<const char*>(C + o);
      char* sc = reinterpret_cast<char*>(ring_c + slot * D);
      for (int q = lane; q < D * (int)sizeof(CT) / 16; q += 32)
        cp_async16(sc + 16 * q, gc + 16 * q);
      const char* gs = reinterpret_cast<const char*>(S_in + o);
      char* ss = reinterpret_cast<char*>(ring_s + slot * D);
      for (int q = lane; q < D / 4; q += 32) cp_async16(ss + 16 * q, gs + 16 * q);
    }
    cp_async_commit();
  };

  LaneVec<CT, K> cr[PF];
  LaneVec<int32_t, K> sr[PF];
  if constexpr (ASYNC) {
    if (live)
      for (int r = 0; r + 1 < RING; ++r) fetch(r);
  } else {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cr[j].v[k] = 0;
        sr[j].v[k] = 0;
      }
      if (live && j < H) load(j, cr[j], sr[j]);
    }
  }
  int Lv[K];  // the (dy, 0) carry
#pragma unroll
  for (int k = 0; k < K; ++k) Lv[k] = 0;

  for (int s0 = 0; s0 < H; s0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int s = s0 + j;
      if (s >= H) continue;  // uniform over the block
      if (live) {
        const int y = row_of(s);
        int c[K], sv[K];
        if constexpr (ASYNC) {
          // row s + RING - 1 goes out; row s, RING - 1 groups older, is in
          fetch(s + RING - 1);
          cp_async_wait<RING - 1>();
          __syncwarp();  // the row's pieces came through every lane
          const int slot = s & (RING - 1);
          const CT* rc = ring_c + slot * D + d0;
          const int32_t* rs = ring_s + slot * D + d0;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            c[k] = ok[k] ? (int)rc[k] : 0;
            sv[k] = ok[k] ? rs[k] : 0;
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            c[k] = (int)cr[j].v[k];
            sv[k] = sr[j].v[k];
          }
          if (s + PF < H) load(s + PF, cr[j], sr[j]);
        }
        // the diagonal carries of the previous row: (dy,+1) from column
        // x - 1, (dy,-1) from column x + 1; at a band's edge from the
        // neighbouring band, else from shared memory
        int Pr[K], Pl[K];
#pragma unroll
        for (int k = 0; k < K; ++k) Pr[k] = Pl[k] = 0;
        if (s > 0) {
          const int ppar = (s - 1) & 1;
          const unsigned ptag = tag0 + s - 1;
          if (left_edge) {
            vb_wait<K>(slot(band - 1, 1, ppar), ptag, ok, Pr);
          } else if (x > 0) {
            const int32_t* src = shared(ppar, w - 1, 0);
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (ok[k]) Pr[k] = src[k];
          }
          if (right_edge) {
            vb_wait<K>(slot(band + 1, 0, ppar), ptag, ok, Pl);
          } else if (x + 1 < W1) {
            const int32_t* src = shared(ppar, w + 1, 1);
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (ok[k]) Pl[k] = src[k];
          }
        }
        int Lr[K], Ll[K], L[K];
        sgm_step<K>(c, Pr, ok, d0, D, p1, p2, Lr);
        sgm_step<K>(c, Pl, ok, d0, D, p1, p2, Ll);
        sgm_step<K>(c, Lv, ok, d0, D, p1, p2, L);
        const int par = s & 1;
        // publish the band's edge carries before the rest of the row: the
        // neighbour waits on them (a one-column band's warp is both edges)
        if (right_edge) vb_publish<K>(slot(band, 1, par), tag0 + s, ok, Lr);
        if (left_edge) vb_publish<K>(slot(band, 0, par), tag0 + s, ok, Ll);
        int32_t* mr = shared(par, w, 0);
        int32_t* ml = shared(par, w, 1);
        int tot[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          Lv[k] = L[k];
          if (ok[k]) {
            mr[k] = Lr[k];
            ml[k] = Ll[k];
          }
          tot[k] = sv[k] + L[k] + Lr[k] + Ll[k];
        }
        if (!UP) {
          int32_t* out = S_out + ((size_t)y * W1 + x) * D + d0;
          if (vec) {
            LaneVec<int32_t, K> t;
#pragma unroll
            for (int k = 0; k < K; ++k) t.v[k] = tot[k];
            *reinterpret_cast<LaneVec<int32_t, K>*>(out) = t;
          } else {
#pragma unroll
            for (int k = 0; k < K; ++k)
              if (ok[k]) out[k] = tot[k];
          }
        } else {
          sgm_wta<K>(tot, ok, d0, D, lane, wta, (long long)y * W1 + x);
        }
      }
      __syncthreads();
    }
  }
}

template <typename CT, int K>
static cudaError_t vert_launch(const CT* C, const int32_t* Sh, int32_t* S,
                               int H, int W1, int D, int cols, int p1, int p2,
                               vb_word* edge, SgmWtaOut wta,
                               cudaStream_t stream) {
  if (cols < 1 || cols > VB_MAX_COLS) return cudaErrorInvalidValue;
  const int bands = (W1 + cols - 1) / cols;
  const bool async = D * sizeof(CT) % 16 == 0;
  const size_t smem =
      (size_t)2 * cols * 2 * D * sizeof(int32_t) +
      (async ? (size_t)cols * VbPrefetch<K>::ring * D * (4 + sizeof(CT)) : 0);
  for (int up = 0; up < 2; ++up) {
    const void* kernel =
        async ? (up ? (const void*)sgm_vert3_kernel<CT, K, true, true>
                    : (const void*)sgm_vert3_kernel<CT, K, false, true>)
              : (up ? (const void*)sgm_vert3_kernel<CT, K, true, false>
                    : (const void*)sgm_vert3_kernel<CT, K, false, false>);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int32_t* s_in = up ? S : Sh;
    void* args[] = {(void*)&C,  (void*)&s_in, (void*)&S,  (void*)&H,
                    (void*)&W1, (void*)&D,    (void*)&p1, (void*)&p2,
                    (void*)&edge, (void*)&wta};
    err = cudaLaunchCooperativeKernel(kernel, dim3(bands), dim3(cols * 32),
                                      args, smem, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename CT>
static cudaError_t vert_by_k(const CT* C, const int32_t* Sh, int32_t* S,
                             int H, int W1, int D, int cols, int p1, int p2,
                             vb_word* edge, SgmWtaOut wta, cudaStream_t s) {
  if (D <= 32)
    return vert_launch<CT, 1>(C, Sh, S, H, W1, D, cols, p1, p2, edge, wta, s);
  if (D <= 64)
    return vert_launch<CT, 2>(C, Sh, S, H, W1, D, cols, p1, p2, edge, wta, s);
  if (D <= 128)
    return vert_launch<CT, 4>(C, Sh, S, H, W1, D, cols, p1, p2, edge, wta, s);
  return vert_launch<CT, 8>(C, Sh, S, H, W1, D, cols, p1, p2, edge, wta, s);
}

// C: (H, W1, D) int16 (c_bytes 2) or int32 (c_bytes 4); Sh: (H, W1, D)
// int32; S: (H, W1, D) int32 scratch; cols: columns a band (1 to 16);
// edge: ceil(W1 / cols) * 4 * D zeroed 64-bit words; best, minS, dval, uniq:
// (H, W1) int32. Requires D <= 256. Two cooperative launches on `stream`.
extern "C" int rtdm_sgm_vert_wta(const void* C, int c_bytes, const void* Sh,
                                 void* S, void* edge, int H,
                                 int W1, int D, int cols, int p1, int p2,
                                 int uniqueness_ratio, void* best, void* minS,
                                 void* dval, void* uniq, void* stream) {
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vert_by_k<CT>((const CT*)C, (const int32_t*)Sh, (int32_t*)S, H,
                         W1, D, cols, p1, p2, (vb_word*)edge, out,
                         (cudaStream_t)stream);
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
