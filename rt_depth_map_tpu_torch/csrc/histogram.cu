// K7 and K10: per-root counts of active pixels, A[r] = #{active p :
// labels[p] == r}, addressed at the root's linear index.
//
// Replaces rt_depth_map_tpu/ops/pallas/histogram.py label_histogram_banded
// (K7, whose contract only asks for counts that decide count <= max_size
// exactly) and label_histogram_pallas (K10, exact sizes). The TPU has no
// scatter unit, so both kernels build one-hot matrices and count on the MXU,
// K7 inside a row and column band around each root to cut the work. Hopper
// has atomics: one thread per pixel adds 1 to its root's counter. The counts
// are exact, which satisfies both contracts, so one kernel serves both
// entry points.
//
// Neighbouring pixels mostly share a root, so a warp first groups its lanes
// by label (__match_any_sync) and one lane per group adds the group's size:
// a run of a row costs one atomic instead of 32.
//
// What bounds it on the H100: device memory bytes (labels and the active
// mask read once, the counts zeroed and written: ~12.9 MB at 1280x720) and
// the atomics' serialisation on a large component's root.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void label_histogram_kernel(const int32_t* __restrict__ labels,
                                       const uint8_t* __restrict__ active,
                                       int n, int32_t* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < n && active[i];
  const int lab = on ? labels[i] : -1;
  const unsigned group = __match_any_sync(0xffffffffu, lab);
  const int leader = __ffs(group) - 1;
  if (on && (int)(threadIdx.x & 31) == leader)
    atomicAdd(&counts[lab], __popc(group));
}

// labels: (n,) int32 linear-index labels in [0, n) where active; active:
// (n,) bool; counts: (n,) int32, overwritten.
extern "C" int rtdm_label_histogram(const void* labels, const void* active,
                                    int n, void* counts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)n * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int threads = 256;
    label_histogram_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        (const int32_t*)labels, (const uint8_t*)active, n, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
