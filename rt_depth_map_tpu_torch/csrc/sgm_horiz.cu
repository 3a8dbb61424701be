// K4: the two horizontal SGM paths, Sh = L(0,+1) + L(0,-1), in one launch
// whose two chains meet in the middle.
//
// Replaces rt_depth_map_tpu/ops/pallas/sgm_bidir.py:243 sgm_horiz_bidir_dh
// (its kernel _horiz_bidir_kernel, sgm_bidir.py:83-221). As on the TPU, the
// horizontal stage works on the x-major volume that K12 (vol_transpose.cu)
// writes from the cost volume, and its output goes back through K12 to the
// row-major layout of K5. The port's x-major layout is (W1, H, D), D
// contiguous. The recurrence and its zero carry at the start of each row
// are those of sgm_path.cuh (sgm_step): a warp holds one row's D-vector,
// D over its lanes.
//
// What bounds it on the H100: device memory bytes. C is read once per
// direction (2 * 2 bytes an element at int16) and Sh written, read back and
// written again (12 bytes): 16 bytes an element, 1.70 GB at 1280x720,
// D = 128, 0.51 ms at 3.35 TB/s. The integer work (~8 operations an element
// and direction) is far below that. The first design scanned the row twice
// (left-to-right writing Sh, right-to-left adding into it) with one warp a
// row, 2 x W1 dependent steps each waiting on a load: H = 720 warps in
// flight could not keep the bytes moving.
//
// Design, as the TPU kernel's: both directions in one launch.
//
// - A block holds SH_ROWS neighbouring rows, two warps a row: the forward
//   chain visits x ascending, the backward chain x descending, at the same
//   time. With hb = floor(W1 / 2), each chain's first hb steps write its
//   own L into Sh. Then the block meets at one barrier (both chains of a
//   row take the same number of steps, so every warp arrives). In the
//   second half each chain reads back the other chain's L at its x, adds
//   its own and writes the sum. 2 x H warps walk ceil(W1 / 2) steps each
//   (1440 warps of 576 steps at 720p), not H warps of W1 steps twice.
//   SH_ROWS = 2 (360 blocks of 4 warps at 720p) spreads the warps over the
//   SMs more evenly than 4 or 8 (tools/sweep_sgm_tiles.py).
// - Odd W1: both chains reach the middle column m = hb on step hb. The
//   forward chain writes its L there before the barrier; the backward
//   chain keeps its L in registers and, after the barrier, adds the
//   forward one's and writes the sum. Neither chain reads m back in its
//   second half, which starts at step hb + 1.
// - Every load comes from a ring in shared memory that each warp fills with
//   cp.async, RING - 1 steps ahead of its step (completions counted per
//   warp in commit groups), so no step waits on device memory: values
//   loaded into registers do not stay in flight, the compiler moves them
//   and a move waits for its load. The first half needs only C; the second
//   half's read-back of Sh goes through the same ring, issued after the
//   barrier (the other warp's stores are then visible: cp.async is an
//   ordinary, generic-proxy access). At the barrier each warp drains its
//   copies; the Sh pieces of the RING - 1 steps already in flight are then
//   issued as groups of their own, so the count stays uniform.
// - Stores go from registers: a lane's K int32 as one vector, 512 bytes a
//   warp and step at D = 128.
// - A pixel's D elements of C or of Sh that are not whole 16-byte pieces
//   (D * sizeof(C) % 16 != 0 or D % 4 != 0, as D = 100 at int16, or a
//   volume that does not start on 16 bytes) take the register path
//   instead: ordinary loads at the step, correct, slower.

#include "async_copy.cuh"
#include "sgm_path.cuh"

#define SH_ROWS 2  // rows a block, two warps each

template <int K>
struct ShRing {
  static constexpr int depth = K <= 4 ? 8 : 4;  // a power of 2
};

// Ct: (W1, H, D); Sh: (W1, H, D) int32, fully written. ASYNC: the ring
// path (D * sizeof(CT) and D * 4 are whole 16-byte pieces).
template <typename CT, int K, bool ASYNC>
__global__ void __launch_bounds__(SH_ROWS * 64)
sgm_horiz_kernel(const CT* __restrict__ C, int32_t* Sh, int H, int W1, int D,
                 int p1, int p2) {
  constexpr int RING = ShRing<K>::depth;
  extern __shared__ __align__(16) int32_t sh_smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool back = w & 1;
  const int y = blockIdx.x * SH_ROWS + (w >> 1);
  const int hb = W1 / 2;
  const int sa = W1 - hb;  // first step of the second half
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;
  const bool vec = D % K == 0 && d0 + K <= D;
  // element offset of the pixel this chain visits on step s
  auto pix = [&](int s) {
    const int x = back ? W1 - 1 - s : s;
    return ((size_t)x * H + y) * D;
  };
  // [nw][RING][D] int32 rows of Sh, then [nw][RING][D] rows of C
  int32_t* ring_s = sh_smem + (size_t)w * RING * D;
  CT* ring_c = reinterpret_cast<CT*>(sh_smem + (size_t)nw * RING * D) +
               (size_t)w * RING * D;
  auto fetch_c = [&](int s) {
    if (s >= W1) return;
    const char* g = reinterpret_cast<const char*>(C + pix(s));
    char* r = reinterpret_cast<char*>(ring_c + (s & (RING - 1)) * D);
    for (int q = lane; q < D * (int)sizeof(CT) / 16; q += 32)
      cp_async16(r + 16 * q, g + 16 * q);
  };
  auto fetch_s = [&](int s) {
    if (s >= W1) return;
    const char* g = reinterpret_cast<const char*>(Sh + pix(s));
    char* r = reinterpret_cast<char*>(ring_s + (s & (RING - 1)) * D);
    for (int q = lane; q < D / 4; q += 32) cp_async16(r + 16 * q, g + 16 * q);
  };
  auto put = [&](int s, const int (&v)[K]) {
    int32_t* o = Sh + pix(s) + d0;
    if (vec) {
      LaneVec<int32_t, K> t;
#pragma unroll
      for (int k = 0; k < K; ++k) t.v[k] = v[k];
      *reinterpret_cast<LaneVec<int32_t, K>*>(o) = t;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (ok[k]) o[k] = v[k];
    }
  };

  int Lp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) Lp[k] = 0;
  // step s of the chain: L from C and Lp; ADD: the other chain's stored L
  // at this pixel is added; the result is stored unless it is the backward
  // chain's middle step
  auto step = [&](int s, bool add) {
    int c[K], sv[K];
    if constexpr (ASYNC) {
      __syncwarp();  // every lane is done with the slot the next copy fills
      fetch_c(s + RING - 1);
      if (add) fetch_s(s + RING - 1);
      cp_async_commit();
      cp_async_wait<RING - 1>();
      __syncwarp();  // the step's pieces came through every lane
      const int slot = s & (RING - 1);
      const CT* rc = ring_c + slot * D + d0;
      const int32_t* rs = ring_s + slot * D + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] = ok[k] ? (int)rc[k] : 0;
        sv[k] = add && ok[k] ? rs[k] : 0;
      }
    } else {
      const size_t o = pix(s) + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] = ok[k] ? (int)__ldg(C + o + k) : 0;
        sv[k] = add && ok[k] ? Sh[o + k] : 0;
      }
    }
    int L[K];
    sgm_step<K>(c, Lp, ok, d0, D, p1, p2, L);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Lp[k] = L[k];
      L[k] += sv[k];
    }
    if (!(back && s == hb && sa != hb)) put(s, L);
  };

  const bool live = y < H;
  if (live) {
    if constexpr (ASYNC) {
      for (int s = 0; s + 1 < RING; ++s) {
        fetch_c(s);
        cp_async_commit();
      }
    }
    for (int s = 0; s < sa; ++s) step(s, false);
    if constexpr (ASYNC) cp_async_wait<0>();
  }
  // every first-half L is in Sh
  __syncthreads();
  if (!live) return;
  if (back && sa != hb) {  // the middle column: add the forward chain's L
    int v[K];
    const size_t o = pix(hb) + d0;
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = Lp[k] + (ok[k] ? Sh[o + k] : 0);
    put(hb, v);
  }
  if constexpr (ASYNC) {
    // the read-back of the steps whose C is already in the ring
    for (int q = sa; q < sa + RING - 1; ++q) {
      fetch_s(q);
      cp_async_commit();
    }
  }
  for (int s = sa; s < W1; ++s) step(s, true);
}

// CUDA launches made by this library, for a check that a call makes one
extern "C" int rtdm_sgm_horiz_kernel_launches = 0;

template <typename CT, int K>
static cudaError_t horiz_launch(const CT* C, int32_t* Sh, int H, int W1,
                                int D, int p1, int p2, cudaStream_t stream) {
  const bool async = D * sizeof(CT) % 16 == 0 && D % 4 == 0 &&
                     (uintptr_t)C % 16 == 0 && (uintptr_t)Sh % 16 == 0;
  const int warps = 2 * SH_ROWS;
  const size_t smem =
      async ? (size_t)warps * ShRing<K>::depth * D * (4 + sizeof(CT)) : 0;
  const void* kernel = async ? (const void*)sgm_horiz_kernel<CT, K, true>
                             : (const void*)sgm_horiz_kernel<CT, K, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + SH_ROWS - 1) / SH_ROWS);
  ++rtdm_sgm_horiz_kernel_launches;
  if (async)
    sgm_horiz_kernel<CT, K, true><<<grid, warps * 32, smem, stream>>>(
        C, Sh, H, W1, D, p1, p2);
  else
    sgm_horiz_kernel<CT, K, false><<<grid, warps * 32, smem, stream>>>(
        C, Sh, H, W1, D, p1, p2);
  return cudaGetLastError();
}

// Ct: (W1, H, D) int16 (c_bytes 2) or int32 (c_bytes 4); Sh: (W1, H, D)
// int32, fully written. Requires D <= 256. One launch.
extern "C" int rtdm_sgm_horiz(const void* Ct, int c_bytes, void* Sh, int H,
                              int W1, int D, int p1, int p2, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* S = (int32_t*)Sh;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    const CT* C = (const CT*)Ct;
    if (D <= 32) return horiz_launch<CT, 1>(C, S, H, W1, D, p1, p2, s);
    if (D <= 64) return horiz_launch<CT, 2>(C, S, H, W1, D, p1, p2, s);
    if (D <= 128) return horiz_launch<CT, 4>(C, S, H, W1, D, p1, p2, s);
    return horiz_launch<CT, 8>(C, S, H, W1, D, p1, p2, s);
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
