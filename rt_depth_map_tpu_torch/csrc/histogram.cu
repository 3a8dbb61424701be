// K7 and K10: per-root counts of active pixels, A[r] = #{active p :
// labels[p] == r}, addressed at the root's linear index; and the speckle
// filter's two elementwise steps around them.
//
// Replaces rt_depth_map_tpu/ops/pallas/histogram.py label_histogram_banded
// (K7, whose contract only asks for counts that decide count <= max_size
// exactly) and label_histogram_pallas (K10, exact sizes). The TPU has no
// scatter unit, so both kernels build one-hot matrices and count on the MXU,
// K7 inside a row and column band around each root to cut the work. Hopper
// has atomics, and the counts here are exact, which satisfies both
// contracts, so one counting kernel serves both entry points.
//
// Entry points:
// - rtdm_label_histogram: the counts (memset + count);
// - rtdm_speckle_decision: the decision field K2 broadcasts, in place over
//   the counts (memset + count + decide): at a root p (active and
//   labels[p] == p) counts[p] > max_size, 1 big and 0 small; BIG elsewhere.
//   It replaces the torch glue of ops/cc.py component_small around K7
//   (rt_depth_map_tpu/ops/cc.py:375-381);
// - rtdm_speckle_apply: filter_speckles' last step, out = (disp != new_val
//   && field == 0) ? new_val : disp on int16.
//
// The count. A block owns a tile of consecutive pixels (components are
// spatially coherent and labels are minimum linear indices, so a tile holds
// few distinct roots; the host's tile, 1024 pixels, one step of the block,
// timed faster than tiles of 1, 2 or 4 whole rows at 1280x720) and a thread
// 4 consecutive pixels a step, loaded as one 16-byte word of labels and one
// 32-bit word of the active bytes where the tensors are aligned. A thread
// merges its 4 pixels by label, a warp merges its threads' runs
// (__match_any_sync, then __reduce_add_sync over each group), and one lane a
// group adds the run to an open-addressed table in shared memory (atomicCAS
// insert, linear probe); a run that finds no slot within HIST_PROBES goes
// straight to a global atomicAdd. At the end the block flushes one global
// atomicAdd per distinct root it saw. So a frame that is one component costs
// one global atomic a block, not one a warp.
//
// What bounds it on the H100. Its bytes: the count and the decision read
// the labels (4 B a pixel) and the active bytes (1 B) and write the int32
// field (4 B), 9 B a pixel, 8.3 MB at 1280x720 (0.0025 ms at 3.35 TB/s);
// the memset and the decision's second pass over the labels add 9 B a pixel
// that the bound does not count. At that size the entry's three device
// operations take about 0.0018 (memset), 0.0041 (count) and 0.0022 ms
// (decision), so each one's start and drain, not its bytes, is most of its
// time. The shared table (128 slots, 2 probes) cuts the entry by a fifth on
// the speckle labels and a third on a frame that is one component, and
// costs nothing on a checkerboard of one-pixel components, where every
// pixel is a root (tools/time_torch_lr_speckle.py --ablate, PERF.md §6).

#include <cuda_runtime.h>
#include <stdint.h>

#define HIST_THREADS 256
#ifndef HIST_SLOTS_LOG2
#define HIST_SLOTS_LOG2 7
#endif
#define HIST_SLOTS (1 << HIST_SLOTS_LOG2)
#define HIST_PROBES 2
#define HIST_EMPTY (-1)
#define DECIDE_BIG (1 << 30)  // ops/cuda/cc_sweep.py BIG

// Add cnt to key's slot of the block's table, or to counts[key] where no
// slot within HIST_PROBES of its hash is free or holds it.
__device__ __forceinline__ void hist_add(int* keys, int* vals, int key, int cnt,
                                         int32_t* counts) {
  unsigned h = ((unsigned)key * 2654435761u) >> (32 - HIST_SLOTS_LOG2);
#pragma unroll 1
  for (int p = 0; p < HIST_PROBES; ++p) {
    int prev = ((volatile int*)keys)[h];
    if (prev == HIST_EMPTY) prev = atomicCAS(&keys[h], HIST_EMPTY, key);
    if (prev == HIST_EMPTY || prev == key) {
      atomicAdd(&vals[h], cnt);
      return;
    }
    h = (h + 1) & (HIST_SLOTS - 1);
  }
  atomicAdd(&counts[key], cnt);
}

// The 4 pixels from i: labels where active, HIST_EMPTY elsewhere and past n.
__device__ __forceinline__ void load_quad(const int32_t* __restrict__ labels,
                                          const uint8_t* __restrict__ active,
                                          int i, int n, bool vec, int lab[4]) {
  if (vec && i + 4 <= n) {
    const int4 l = __ldg((const int4*)(labels + i));
    const unsigned a = __ldg((const unsigned*)(active + i));
    lab[0] = (a & 0xffu) ? l.x : HIST_EMPTY;
    lab[1] = (a & 0xff00u) ? l.y : HIST_EMPTY;
    lab[2] = (a & 0xff0000u) ? l.z : HIST_EMPTY;
    lab[3] = (a & 0xff000000u) ? l.w : HIST_EMPTY;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      lab[k] = i + k < n && active[i + k] ? labels[i + k] : HIST_EMPTY;
  }
}

// counts[r] += #{active p in the block's tile : labels[p] == r}. tile is a
// multiple of 4 pixels; vec: labels on 16 bytes and active on 4.
__global__ void __launch_bounds__(HIST_THREADS)
label_count_kernel(const int32_t* __restrict__ labels,
                   const uint8_t* __restrict__ active, int n, int tile,
                   bool vec, int32_t* __restrict__ counts) {
  __shared__ int keys[HIST_SLOTS];
  __shared__ int vals[HIST_SLOTS];
  for (int s = threadIdx.x; s < HIST_SLOTS; s += HIST_THREADS) {
    keys[s] = HIST_EMPTY;
    vals[s] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int begin = blockIdx.x * tile;
  const int end = min(n, begin + tile);
  // every thread of the block takes every step, so the warp calls below
  // see all 32 lanes
  for (int step = begin; step < end; step += 4 * HIST_THREADS) {
    const int i = step + 4 * threadIdx.x;
    int lab[4];
    load_quad(labels, active, i, i < end ? end : i, vec, lab);
    unsigned left = 0;  // the quad's pixels not yet added
#pragma unroll
    for (int k = 0; k < 4; ++k) left |= (lab[k] != HIST_EMPTY) << k;
    // one round per distinct label of a quad: one, mostly
    while (__any_sync(0xffffffffu, left)) {
      int key = HIST_EMPTY, cnt = 0;
      if (left) {
        key = lab[__ffs(left) - 1];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if ((left >> k & 1) && lab[k] == key) {
            ++cnt;
            left &= ~(1u << k);
          }
      }
      const unsigned group = __match_any_sync(0xffffffffu, key);
      const int total = __reduce_add_sync(group, cnt);
      if (key != HIST_EMPTY && lane == __ffs(group) - 1)
        hist_add(keys, vals, key, total, counts);
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < HIST_SLOTS; s += HIST_THREADS)
    if (keys[s] != HIST_EMPTY) atomicAdd(&counts[keys[s]], vals[s]);
}

// In place over the counts: field[p] = counts[p] > max_size at a root,
// DECIDE_BIG elsewhere; 4 pixels a thread.
__global__ void speckle_decision_kernel(const int32_t* __restrict__ labels,
                                        const uint8_t* __restrict__ active,
                                        int n, int max_size, bool vec,
                                        int32_t* field) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  int lab[4];
  load_quad(labels, active, i, n, vec, lab);
  int out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = lab[k] == i + k ? (field[i + k] > max_size) : DECIDE_BIG;
  if (vec && i + 4 <= n) {
    *(int4*)(field + i) = make_int4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i + k < n) field[i + k] = out[k];
  }
}

// out = (disp != new_val && field == 0) ? new_val : disp; 4 pixels a thread.
__global__ void speckle_apply_kernel(const int16_t* __restrict__ disp,
                                     const int32_t* __restrict__ field, int n,
                                     int new_val, bool vec,
                                     int16_t* __restrict__ out) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  if (vec && i + 4 <= n) {
    const uint2 d = __ldg((const uint2*)(disp + i));
    const int4 f = __ldg((const int4*)(field + i));
    const int fk[4] = {f.x, f.y, f.z, f.w};
    unsigned w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned dw = h ? d.y : d.x;
      unsigned o = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int v = (int16_t)(dw >> (16 * k));
        const int r = v != new_val && fk[2 * h + k] == 0 ? new_val : v;
        o |= ((unsigned)r & 0xffffu) << (16 * k);
      }
      w[h] = o;
    }
    *(uint2*)(out + i) = make_uint2(w[0], w[1]);
  } else {
    for (int k = 0; k < 4 && i + k < n; ++k) {
      const int v = disp[i + k];
      out[i + k] = (int16_t)(v != new_val && field[i + k] == 0 ? new_val : v);
    }
  }
}

static bool aligned(const void* p, uintptr_t a) { return ((uintptr_t)p & (a - 1)) == 0; }

static cudaError_t count(const void* labels, const void* active, int n,
                         int tile, void* counts, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)n * sizeof(int32_t), s);
  if (err != cudaSuccess || n == 0) return err;
  if (tile <= 0 || tile % 4) return cudaErrorInvalidValue;
  const bool vec = aligned(labels, 16) && aligned(active, 4);
  label_count_kernel<<<(n + tile - 1) / tile, HIST_THREADS, 0, s>>>(
      (const int32_t*)labels, (const uint8_t*)active, n, tile, vec,
      (int32_t*)counts);
  return cudaGetLastError();
}

// labels: (n,) int32 linear-index labels in [0, n) where active; active:
// (n,) bool; tile: pixels a block, a multiple of 4; counts: (n,) int32,
// overwritten.
extern "C" int rtdm_label_histogram(const void* labels, const void* active,
                                    int n, int tile, void* counts,
                                    void* stream) {
  return (int)count(labels, active, n, tile, counts, (cudaStream_t)stream);
}

// As rtdm_label_histogram, then the decision in place: field (n,) int32.
extern "C" int rtdm_speckle_decision(const void* labels, const void* active,
                                     int n, int tile, int max_size,
                                     void* field, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = count(labels, active, n, tile, field, s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const bool vec = aligned(labels, 16) && aligned(active, 4) && aligned(field, 16);
  const int quads = (n + 3) / 4;
  speckle_decision_kernel<<<(quads + 255) / 256, 256, 0, s>>>(
      (const int32_t*)labels, (const uint8_t*)active, n, max_size, vec,
      (int32_t*)field);
  return (int)cudaGetLastError();
}

// disp: (n,) int16; field: (n,) int32; out: (n,) int16.
extern "C" int rtdm_speckle_apply(const void* disp, const void* field, int n,
                                  int new_val, void* out, void* stream) {
  if (n == 0) return 0;
  const bool vec = aligned(disp, 8) && aligned(field, 16) && aligned(out, 8);
  const int quads = (n + 3) / 4;
  speckle_apply_kernel<<<(quads + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int16_t*)disp, (const int32_t*)field, n, new_val, vec,
      (int16_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
