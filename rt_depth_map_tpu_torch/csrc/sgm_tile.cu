// sgm_tile_scan: the SGM scans of one tile of the exact width tiling, one
// wavefront step of every direction in one launch.
//
// No Pallas kernel stands behind it: rt_depth_map_tpu/parallel/exact_sgbm.py
// runs these scans as lax.scans under XLA (_diag_core and _horiz_core,
// exact_sgbm.py:159-184, over a row block of the tile; the tile-local
// vertical paths through ops/sgbm.py _aggregate_dir). On the card a scan
// step a launch would be ~10^5 small launches a 720p frame; here one launch
// runs a wavefront step of all the tile's directions.
//
// The tile's cost volume C is (H, W, D) (its own W columns of the frame's
// W1, as K3 writes them, int16 or int32), and S (H, W, D) int32 the sum of
// the directions' L. A job is one direction (dy, dx), a pixel (y, x)
// following (y - dy, x - dx), over the rows [a, a + R) of the tile, scanned
// top-down for dy = +1 and bottom-up for dy = -1, with the recurrence of
// sgm_path.cuh (p2 raised to p1 + 1 by the caller). Within a job every
// direction is a set of independent lines: the rows for dy = 0, the columns
// for dx = 0, the diagonals otherwise. A line starts from a carry, the L
// of its first pixel's predecessor:
//
//   - outside the tile (the neighbour tile's edge column): the inbox, an
//     (R + 1, D) strip in global row order. For dy >= 0, m[i] holds the
//     neighbour's edge L at row a - 1 + i; for dy = -1, at row a + i. A
//     tile at the mesh's edge gets zeros (OpenCV's zero border).
//   - inside the tile, on the row before the block in scan order: prev,
//     the (W, D) L of that row (zeros at the first block).
//
// A job adds its L into S (atomically: the jobs of a launch may cover the
// same pixels) and writes, for dx != 0, the new outbox, the L of its edge
// column toward the next tile (x = W - 1 for dx = +1, 0 for dx = -1) in
// the inbox's format, whose one row from the block before (m[0] = old
// m[R] for dy >= 0, m[R] = old m[0] for dy = -1) it copies from the old
// outbox; and, for dy != 0 and a prev_out, the L of its last row in scan
// order. This is exact_sgbm.py's message layout and carry, in global
// column order (the reference flips a block into "core space" instead).
//
// Design, the simple one: one warp a line, D over its lanes (lane l holds
// d = l * K + k), the step of sgm_path.cuh, the next pixel's costs loaded
// before the current step. Lines of one job take consecutive warps, four
// warps a block. What bounds it: the chain of dependent steps along each
// line (W steps a row, up to R a diagonal, H a column) and the atomic adds
// into S; its bytes (C read once and S read and written once a direction)
// take far less. Making it fast is later work.

#include <type_traits>

#include "sgm_path.cuh"

#define ST_MAX_JOBS 8
#define ST_WARPS 4  // warps a block

struct StJob {
  int dy, dx;             // the direction
  int a, R;               // the block's rows [a, a + R)
  int lines, first;       // its lines and its first warp in the launch
  const int32_t* inbox;   // (R + 1, D), or null: zeros
  const int32_t* out_old; // (R + 1, D), or null: zeros
  int32_t* out_new;       // (R + 1, D), or null: not written
  const int32_t* prev;    // (W, D), or null: zeros
  int32_t* prev_out;      // (W, D), or null: not written
};

struct StJobs {
  StJob job[ST_MAX_JOBS];
  int njobs, warps;
};

template <int K>
__device__ __forceinline__ void st_load(const int32_t* p, int lane, int D,
                                        int (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    v[k] = (p != nullptr && d < D) ? p[d] : 0;
  }
}

template <typename CT, int K>
__device__ __forceinline__ void st_cost(const CT* C, long long pix, int lane,
                                        int D, int (&c)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    c[k] = d < D ? (int)C[pix * D + d] : 0;
  }
}

template <int K>
__device__ __forceinline__ void st_store(int32_t* p, int lane, int D,
                                         const int (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = lane * K + k;
    if (d < D) p[d] = v[k];
  }
}

template <typename CT, int K>
__global__ void __launch_bounds__(32 * ST_WARPS)
sgm_tile_kernel(const CT* __restrict__ C, int32_t* __restrict__ S, int W,
                int D, int p1, int p2, const StJobs jobs) {
  const int gw = blockIdx.x * ST_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (gw >= jobs.warps) return;
  int j = 0;
  while (j + 1 < jobs.njobs && gw >= jobs.job[j + 1].first) ++j;
  const StJob& J = jobs.job[j];
  const int l = gw - J.first;
  const int dy = J.dy, dx = J.dx, a = J.a, R = J.R;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;

  // the line's first pixel (y, x), its steps, and its carry
  int y, x, steps;
  int carry[K];
  if (dy == 0) {
    y = a + l;
    x = dx > 0 ? 0 : W - 1;
    steps = W;
    st_load<K>(J.inbox ? J.inbox + (size_t)(l + 1) * D : nullptr, lane, D,
               carry);
  } else {
    const int j0 = l < W ? 0 : l - W + 1;
    x = l < W ? l : (dx > 0 ? 0 : W - 1);
    y = (dy > 0 ? a : a + R - 1) + j0 * dy;
    steps = R - j0;
    if (dx > 0) steps = min(steps, W - x);
    if (dx < 0) steps = min(steps, x + 1);
    const int px = x - dx;
    if (j0 == 0 && px >= 0 && px < W)
      st_load<K>(J.prev ? J.prev + (size_t)px * D : nullptr, lane, D, carry);
    else
      st_load<K>(J.inbox ? J.inbox + (size_t)(y - a + (dy > 0 ? 0 : 1)) * D
                         : nullptr,
                 lane, D, carry);
  }
  // the block's row carried over into the new outbox
  if (l == 0 && J.out_new != nullptr && dx != 0) {
    const int from = dy >= 0 ? R : 0, to = dy >= 0 ? 0 : R;
    int v[K];
    st_load<K>(J.out_old ? J.out_old + (size_t)from * D : nullptr, lane, D, v);
    st_store<K>(J.out_new + (size_t)to * D, lane, D, v);
  }
  const int x_out = dx > 0 ? W - 1 : 0;
  const int y_last = dy > 0 ? a + R - 1 : a;

  int c[K], cn[K] = {}, L[K];
  st_cost<CT, K>(C, (long long)y * W + x, lane, D, c);
  for (int s = 0; s < steps; ++s) {
    const int yn = y + dy, xn = x + dx;
    if (s + 1 < steps) st_cost<CT, K>(C, (long long)yn * W + xn, lane, D, cn);
    sgm_step<K>(c, carry, ok, d0, D, p1, p2, L);
    const long long pix = (long long)y * W + x;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (ok[k]) atomicAdd(S + pix * D + d0 + k, L[k]);
    if (dx != 0 && x == x_out && J.out_new != nullptr)
      st_store<K>(J.out_new + (size_t)(y - a + (dy >= 0 ? 1 : 0)) * D, lane,
                  D, L);
    if (dy != 0 && y == y_last && J.prev_out != nullptr)
      st_store<K>(J.prev_out + (size_t)x * D, lane, D, L);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      carry[k] = L[k];
      c[k] = cn[k];
    }
    y = yn;
    x = xn;
  }
}

template <typename F>
static cudaError_t st_by_k(int D, F f) {
  if (D <= 32) return f(std::integral_constant<int, 1>{});
  if (D <= 64) return f(std::integral_constant<int, 2>{});
  if (D <= 128) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

// C: (H, W, D) int16 (c_bytes 2) or int32; S: (H, W, D) int32, added to.
// desc: njobs x (dy, dx, a, R); ptrs: njobs x (inbox, out_old, out_new,
// prev, prev_out), each (R + 1, D) or (W, D) int32 or null (see above).
// Requires 1 <= D <= 256, 1 <= njobs <= ST_MAX_JOBS, every block inside
// [0, H), dy and dx in {-1, 0, 1}, not both 0. One launch.
extern "C" int rtdm_sgm_tile_scan(const void* C, int c_bytes, void* S, int H,
                                  int W, int D, int p1, int p2,
                                  const int* desc, void* const* ptrs,
                                  int njobs, void* stream) {
  if (D < 1 || D > 256 || W < 1 || H < 1 || njobs < 1 ||
      njobs > ST_MAX_JOBS)
    return (int)cudaErrorInvalidValue;
  StJobs jobs;
  jobs.njobs = njobs;
  jobs.warps = 0;
  for (int i = 0; i < njobs; ++i) {
    StJob& J = jobs.job[i];
    J.dy = desc[4 * i];
    J.dx = desc[4 * i + 1];
    J.a = desc[4 * i + 2];
    J.R = desc[4 * i + 3];
    if (J.dy < -1 || J.dy > 1 || J.dx < -1 || J.dx > 1 ||
        (J.dy == 0 && J.dx == 0) || J.R < 1 || J.a < 0 || J.a + J.R > H)
      return (int)cudaErrorInvalidValue;
    J.inbox = (const int32_t*)ptrs[5 * i];
    J.out_old = (const int32_t*)ptrs[5 * i + 1];
    J.out_new = (int32_t*)ptrs[5 * i + 2];
    J.prev = (const int32_t*)ptrs[5 * i + 3];
    J.prev_out = (int32_t*)ptrs[5 * i + 4];
    J.lines = J.dy == 0 ? J.R : (J.dx == 0 ? W : W + J.R - 1);
    J.first = jobs.warps;
    jobs.warps += J.lines;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((jobs.warps + ST_WARPS - 1) / ST_WARPS);
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return st_by_k(D, [&](auto k) {
      sgm_tile_kernel<CT, decltype(k)::value><<<grid, 32 * ST_WARPS, 0, s>>>(
          (const CT*)C, (int32_t*)S, W, D, p1, p2, jobs);
      return cudaGetLastError();
    });
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
