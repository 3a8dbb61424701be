// Left-right consistency resolution: per-row winner search, then read-back.
//
// Replaces rt_depth_map_tpu/ops/pallas/lr_resolve.py lr_resolve_pallas:
//
//   winner:    best[x2] = min over dd in [0, n_w) of key[x2 + dd]
//                         where d_match[x2 + dd] == dd
//   disp2[x2]  = (best & (Dpow - 1)) + c0, or `invalid` without a candidate
//   read-back: out_j[x] = disp2[x - rm_j[x]] when rm_j[x] is in
//              [r_lo, r_lo + n_r) and x - rm_j[x] is in [0, W); else invalid
//
// One block per row. The winner step is a scatter: every pixel x with
// dd = d_match[x] in range does atomicMin(best[x - dd], key[x]) on a row
// kept in shared memory. Min does not depend on order, so the result is
// deterministic and bit-exact with the shift-reduce of the TPU kernel.
//
// What bounds it on the H100: device memory bytes (read d_match, key and the
// match planes once, write the read-backs once: ~15 MB at 1280x720 with one
// plane) plus shared-memory atomics, which contend only where many pixels
// share a target. The TPU kernel's D-long loop of lane rolls is gone: each
// pixel does O(1) work.

#include <cuda_runtime.h>
#include <stdint.h>

#define LR_BIGKEY 0x7fffffff

__global__ void lr_resolve_kernel(const int32_t* __restrict__ d_match,
                                  const int32_t* __restrict__ key,
                                  const int32_t* __restrict__ rms, int n_rb,
                                  int H, int W, int n_w, int r_lo, int n_r,
                                  int dmask, int c0, int invalid,
                                  int32_t* __restrict__ out) {
  extern __shared__ int32_t row[];  // [W]: best key, then disp2
  const size_t base = (size_t)blockIdx.x * W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) row[x] = LR_BIGKEY;
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int dd = d_match[base + x];
    if (dd >= 0 && dd < n_w && x - dd >= 0) atomicMin(&row[x - dd], key[base + x]);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int b = row[x];
    row[x] = b != LR_BIGKEY ? (b & dmask) + c0 : invalid;
  }
  __syncthreads();
  const size_t plane = (size_t)H * W;
  for (int j = 0; j < n_rb; ++j) {
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      const int dd = rms[j * plane + base + x];
      const int xs = x - dd;
      const bool ok = dd >= r_lo && dd < r_lo + n_r && xs >= 0 && xs < W;
      out[j * plane + base + x] = ok ? row[xs] : invalid;
    }
  }
}

// d_match, key: (H, W) int32; rms: (n_rb, H, W) int32; out: (n_rb, H, W).
extern "C" int rtdm_lr_resolve(const void* d_match, const void* key,
                               const void* rms, int n_rb, int H, int W,
                               int n_w, int r_lo, int n_r, int Dpow, int c0,
                               int invalid, void* out, void* stream) {
  if (H > 0) {
    lr_resolve_kernel<<<H, 256, (size_t)W * sizeof(int32_t),
                        (cudaStream_t)stream>>>(
        (const int32_t*)d_match, (const int32_t*)key, (const int32_t*)rms,
        n_rb, H, W, n_w, r_lo, n_r, Dpow - 1, c0, invalid, (int32_t*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
