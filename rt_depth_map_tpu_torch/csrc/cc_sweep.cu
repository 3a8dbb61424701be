// Min-propagation of N int32 fields along allowed neighbour edges, to a fixed
// point or a round cap.
//
// Replaces rt_depth_map_tpu/ops/pallas/cc_sweep.py seg_min_propagate_pallas.
// The semantics are those of the XLA loop of rt_depth_map_tpu/ops/cc.py
// (connected_components_bbox / connected_components_scan), so that the result
// also matches under the round cap on a mask that does not converge:
//
//   sweep = [hop, 8-connectivity only] -> row run-min -> column run-min
//   trip  = two sweeps; stop when a trip changed nothing or rounds >= cap
//           (rounds count sweeps, two per trip)
//
// hop: every active pixel takes the min over itself and its neighbours across
// allowed edges, all read from the field before the hop (Jacobi, so it runs
// from one buffer into the other). Run-min: every pixel takes the min over its
// run of allowed edges along the row (column): a segmented Hillis-Steele scan
// forward and backward in shared memory, one block per line, exactly the
// doubling of ops/cc.py _seg_min_dir.
//
// Edges arrive packed, one byte per pixel: bit 0 (y,x)~(y,x+1), bit 1
// (y,x)~(y+1,x), bit 2 (y,x)~(y+1,x+1), bit 3 (y,x+1)~(y+1,x).
//
// What bounds it on the H100: launches and round trips, not bytes. A trip is
// 4-6 small launches over a 14.7 MB field set (4 fields at 1280x720), and the
// host reads one device flag per trip to decide whether to go on. The design
// keeps each launch a full pass over all fields (grid.y / grid.z = field) and
// reads the flag once per trip, as the XLA loop tests once per trip. Column
// lines are read with a stride of W (uncoalesced); a later PR can tile them.

#include <cuda_runtime.h>
#include <stdint.h>

#define RTDM_BIG (1 << 30)

__global__ void hop_kernel(const int32_t* __restrict__ src,
                           int32_t* __restrict__ dst,
                           const uint8_t* __restrict__ active,
                           const uint8_t* __restrict__ edges, int H, int W,
                           int* __restrict__ changed) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= W) return;
  const size_t plane = (size_t)blockIdx.z * H * W;
  const size_t p = (size_t)y * W + x;
  const int32_t* f = src + plane;
  const int32_t v = f[p];
  int32_t m = v;
  if (active[p]) {
    const uint8_t e = edges[p];
    // an allowed edge joins two active pixels, so a neighbour's value is its
    // field value (ops/cc.py hop_many reads it through where(active, f, BIG))
    if (e & 1) m = min(m, f[p + 1]);
    if (e & 2) m = min(m, f[p + W]);
    if (e & 4) m = min(m, f[p + W + 1]);
    if (x > 0) {
      const uint8_t el = edges[p - 1];
      if (el & 1) m = min(m, f[p - 1]);
      if (el & 8) m = min(m, f[p + W - 1]);  // (y,x)~(y+1,x-1)
    }
    if (y > 0) {
      const uint8_t eu = edges[p - W];
      if (eu & 2) m = min(m, f[p - W]);
      if (eu & 8) m = min(m, f[p - W + 1]);  // (y-1,x+1)~(y,x)
      if (x > 0 && (edges[p - W - 1] & 4)) m = min(m, f[p - W - 1]);
    }
  }
  dst[plane + p] = m;
  if (m < v) *changed = 1;
}

// One block per line (row or column) of one field, in place.
__global__ void run_min_kernel(int32_t* __restrict__ fields,
                               const uint8_t* __restrict__ edges, int H, int W,
                               int along_rows, int* __restrict__ changed) {
  extern __shared__ int32_t smem[];
  const int L = along_rows ? W : H;
  const size_t step = along_rows ? 1 : (size_t)W;
  const size_t base = along_rows ? (size_t)blockIdx.x * W : blockIdx.x;
  int32_t* f = fields + (size_t)blockIdx.y * H * W + base;
  const uint8_t* e = edges + base;
  const uint8_t bit = along_rows ? 1 : 2;

  int32_t* fm = smem;           // [2][L] forward running min
  int32_t* bm = fm + 2 * L;     // [2][L] backward running min
  uint8_t* fs = (uint8_t*)(bm + 2 * L);  // [2][L] forward segment flag
  uint8_t* bs = fs + 2 * L;              // [2][L] backward segment flag

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int32_t v = f[i * step];
    fm[i] = v;
    bm[i] = v;
    // a segment starts where the edge into the pixel, in scan direction, is
    // missing
    fs[i] = !(i > 0 && (e[(i - 1) * step] & bit));
    bs[i] = !(i + 1 < L && (e[i * step] & bit));
  }
  __syncthreads();
  int cur = 0;
  for (int d = 1; d < L; d *= 2) {
    const int nxt = cur ^ 1;
    const int32_t* fmc = fm + cur * L;
    const int32_t* bmc = bm + cur * L;
    const uint8_t* fsc = fs + cur * L;
    const uint8_t* bsc = bs + cur * L;
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      int32_t m = fmc[i];
      uint8_t s = fsc[i];
      if (i >= d) {
        if (!s) m = min(m, fmc[i - d]);
        s |= fsc[i - d];
      } else {
        s = 1;
      }
      fm[nxt * L + i] = m;
      fs[nxt * L + i] = s;

      m = bmc[i];
      s = bsc[i];
      if (i + d < L) {
        if (!s) m = min(m, bmc[i + d]);
        s |= bsc[i + d];
      } else {
        s = 1;
      }
      bm[nxt * L + i] = m;
      bs[nxt * L + i] = s;
    }
    __syncthreads();
    cur = nxt;
  }
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int32_t r = min(fm[cur * L + i], bm[cur * L + i]);
    if (r < f[i * step]) {
      f[i * step] = r;
      *changed = 1;
    }
  }
}

static size_t run_min_smem(int L) { return (size_t)L * (4 * 4 + 4); }

// fields: (N, H, W) int32, updated in place; scratch: same size. rounds_out
// receives the number of sweeps run.
extern "C" int rtdm_cc_propagate(void* fields, void* scratch,
                                 const void* active, const void* edges, int N,
                                 int H, int W, int diag, int max_rounds,
                                 void* changed_dev, void* rounds_out,
                                 void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int32_t* cur = (int32_t*)fields;
  int32_t* other = (int32_t*)scratch;
  int* changed_d = (int*)changed_dev;
  const size_t smem_rows = run_min_smem(W), smem_cols = run_min_smem(H);
  const size_t smem_max = smem_rows > smem_cols ? smem_rows : smem_cols;
  cudaError_t err = cudaFuncSetAttribute(
      run_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_max);
  if (err != cudaSuccess) return (int)err;
  const dim3 hop_grid((W + 127) / 128, H, N);
  int rounds = 0;
  int changed = 1;
  while (changed && rounds < max_rounds) {
    cudaMemsetAsync(changed_d, 0, sizeof(int), stream);
    for (int s = 0; s < 2; ++s) {
      if (diag) {
        hop_kernel<<<hop_grid, 128, 0, stream>>>(
            cur, other, (const uint8_t*)active, (const uint8_t*)edges, H, W,
            changed_d);
        int32_t* t = cur;
        cur = other;
        other = t;
      }
      run_min_kernel<<<dim3(H, N), 256, smem_rows, stream>>>(
          cur, (const uint8_t*)edges, H, W, 1, changed_d);
      run_min_kernel<<<dim3(W, N), 256, smem_cols, stream>>>(
          cur, (const uint8_t*)edges, H, W, 0, changed_d);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyAsync(&changed, changed_d, sizeof(int),
                          cudaMemcpyDeviceToHost, stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return (int)err;
    rounds += 2;
  }
  if (cur != (int32_t*)fields) {
    err = cudaMemcpyAsync(fields, cur, (size_t)N * H * W * sizeof(int32_t),
                          cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return (int)err;
  }
  *(int*)rounds_out = rounds;
  return (int)cudaGetLastError();
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
