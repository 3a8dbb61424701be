// K12: swap the outer axes of a volume, y[b, m, a, :] = x[a, m, b, :].
//
// Replaces rt_depth_map_tpu/ops/pallas/vol_transpose.py vol_transpose, the
// (A, D, B) -> (B, D, A) transpose with which the TPU's SGM stage turns the
// cost volume x-major for the horizontal paths and turns their sum back. The
// port's volumes keep D contiguous, so the SGM stage calls it as
// (H, 1, W1, D) -> (W1, 1, H, D): a unit of D elements moves as a whole.
//
// The unit (the trailing elements that move together) is copied in the
// widest chunks that divide it, up to 16 bytes. When a unit is several
// chunks (the SGM volumes: 256 or 512 bytes), a thread copies one chunk of
// an output row and both sides are contiguous within a unit, so the warps'
// reads and writes coalesce without staging. When a unit is one chunk (the
// TPU's own 3-D form, one element per unit), a block moves a 32 x 32 tile of
// (a, b) through shared memory so that reads run along b and writes along a.
//
// What bounds it on the H100: device memory bytes, the volume read once and
// written once (425 MB for the int16 cost volume at 1280x720, D = 128).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

template <typename T>
__global__ void vol_transpose_rows(const T* __restrict__ x, T* __restrict__ y,
                                   int A, int M, int B, int E) {
  const long long row_len = (long long)A * E;  // chunks per output row (b, m)
  const long long rows = (long long)B * M;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long b = r / M, m = r % M;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < row_len; i += (long long)gridDim.x * blockDim.x) {
      const long long a = i / E, e = i % E;
      y[r * row_len + i] = x[((a * M + m) * B + b) * E + e];
    }
  }
}

template <typename T>
__global__ void vol_transpose_tiles(const T* __restrict__ x, T* __restrict__ y,
                                    int A, int M, int B) {
  __shared__ T tile[32][33];
  const int b0 = blockIdx.x * 32;
  for (int m = blockIdx.z; m < M; m += gridDim.z) {
    for (int a0 = blockIdx.y * 32; a0 < A; a0 += gridDim.y * 32) {
      for (int j = threadIdx.y; j < 32; j += blockDim.y) {
        const int a = a0 + j, b = b0 + threadIdx.x;
        if (a < A && b < B)
          tile[j][threadIdx.x] = x[((long long)a * M + m) * B + b];
      }
      __syncthreads();
      for (int j = threadIdx.y; j < 32; j += blockDim.y) {
        const int b = b0 + j, a = a0 + threadIdx.x;
        if (a < A && b < B)
          y[((long long)b * M + m) * A + a] = tile[threadIdx.x][j];
      }
      __syncthreads();
    }
  }
}

template <typename T>
static void launch(const void* x, void* y, int A, int M, int B, int E,
                   cudaStream_t s) {
  const T* xs = (const T*)x;
  T* ys = (T*)y;
  if (E == 1) {
    const dim3 block(32, 8);
    const dim3 grid((B + 31) / 32, std::min((A + 31) / 32, 65535),
                    std::min(M, 65535));
    vol_transpose_tiles<T><<<grid, block, 0, s>>>(xs, ys, A, M, B);
  } else {
    const int threads = 256;
    const long long row_len = (long long)A * E;
    const long long bx = (row_len + threads - 1) / threads;
    const dim3 grid((unsigned)std::min(bx, 1024LL),
                    (unsigned)std::min((long long)B * M, 65535LL));
    vol_transpose_rows<T><<<grid, threads, 0, s>>>(xs, ys, A, M, B, E);
  }
}

// x: (A, M, B, unit) and y: (B, M, A, unit), unit_bytes bytes per unit; the
// buffers must not overlap.
extern "C" int rtdm_vol_transpose(const void* x, void* y, int A, int M, int B,
                                  long long unit_bytes, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if ((long long)A * M * B == 0 || unit_bytes == 0) return 0;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)y;
  int chunk = 16;
  while (chunk > 1 && (unit_bytes % chunk != 0 || align % chunk != 0))
    chunk >>= 1;
  const long long E = unit_bytes / chunk;
  if (E > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  switch (chunk) {
    case 16: launch<int4>(x, y, A, M, B, (int)E, s); break;
    case 8: launch<int2>(x, y, A, M, B, (int)E, s); break;
    case 4: launch<int32_t>(x, y, A, M, B, (int)E, s); break;
    case 2: launch<int16_t>(x, y, A, M, B, (int)E, s); break;
    default: launch<uint8_t>(x, y, A, M, B, (int)E, s); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
