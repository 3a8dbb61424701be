// Asynchronous copies from device to shared memory (cp.async), in commit
// groups, and a lane's K elements moved as one vector: shared by the SGM
// kernels that feed their steps from rings in shared memory (K3, K4, K5).

#pragma once

#include <cuda_runtime.h>

// A lane's K elements, moved as one vector.
template <typename T, int K>
struct alignas(sizeof(T) * K) LaneVec {
  T v[K];
};

// 16 bytes, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

// 8 bytes (cp.async.cg takes only 16).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of the thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
