// sgm_tile_scan and sgm_tile_final: the SGM scans of one tile of the exact
// width tiling. sgm_tile_scan runs one wavefront step of the tile's
// cross-tile directions in one launch; sgm_tile_final runs the tile's
// vertical paths and the winner-take-all in the tile's last launch.
//
// No Pallas kernel stands behind them: rt_depth_map_tpu/parallel/
// exact_sgbm.py runs these scans as lax.scans under XLA (_diag_core and
// _horiz_core, exact_sgbm.py:159-184, over a row block of the tile; the
// tile-local vertical paths through ops/sgbm.py _aggregate_dir, then
// wta_uniq_subpix, exact_sgbm.py:337-343). On the card a scan step a
// launch would be ~10^5 small launches a 720p frame.
//
// The tile's cost volume C is (H, W, D) (its own W columns of the frame's
// W1, as K3 writes them, int16 or int32), and S (H, W, D) int32 the sum of
// the directions' L. A job is one direction (dy, dx), a pixel (y, x)
// following (y - dy, x - dx), over the rows [a, a + R) of the tile, scanned
// top-down for dy = +1 and bottom-up for dy = -1, with the recurrence of
// sgm_path.cuh (p2 raised to p1 + 1 by the caller). Within a job every
// direction is a set of independent lines: the rows for dy = 0, the
// diagonals otherwise. A line starts from a carry, the L of its first
// pixel's predecessor:
//
//   - outside the tile (the neighbour tile's edge column): the inbox, an
//     (R + 1, D) strip in global row order. For dy >= 0, m[i] holds the
//     neighbour's edge L at row a - 1 + i; for dy = -1, at row a + i. A
//     tile at the mesh's edge gets zeros (OpenCV's zero border).
//   - inside the tile, on the row before the block in scan order: prev,
//     the (W, D) L of that row (zeros at the first block).
//
// A job adds its L into S and writes, for dx != 0, the new outbox, the L
// of its edge column toward the next tile (x = W - 1 for dx = +1, 0 for
// dx = -1) in the inbox's format, whose one row from the block before
// (m[0] = old m[R] for dy >= 0, m[R] = old m[0] for dy = -1) it copies
// from the old outbox; and, for dy != 0 and a prev_out, the L of its last
// row in scan order. This is exact_sgbm.py's message layout and carry, in
// global column order (the reference flips a block into "core space").
//
// Design of sgm_tile_scan: a warp a line, D over its lanes (lane l holds
// d = l * K + k), the step of sgm_path.cuh; the lines of a job take
// consecutive warps, TS_WARPS a block, the horizontal jobs' lines (W steps
// each, the longest) first. The jobs of a launch cover the same pixels
// (every direction of a step on one block at n = 1), so L goes into S by
// atomic adds whose result is unused: they compile to RED, the L2 does
// the add and the warp does not wait for it; integer adds give the same
// sum in any order, so S is exact. A step's L is staged in shared memory
// first and added by elements 32 k + lane, so that an add instruction
// covers 32 consecutive words. Each warp copies its line's next pixels'
// costs into a ring of TS_RING slots in shared memory with cp.async
// (async_copy.cuh), TS_RING - 1 pixels ahead of its step, as K4 and K9a
// do; where a pixel's costs are not whole 16-byte pieces or C does not
// start on 16 bytes (D = 100, 30 or 7 at int16), it loads TS_PF pixels
// ahead into registers instead. No block waits for another: an ordinary
// launch, which a CUDA graph can capture.
//
// What bounds a step on the H100: the chain of W dependent steps along each
// row, and the atomic adds, one a volume element and direction; its bytes
// (C read, S read and written once a row block) take less. Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (tools/time_torch_tile.py, PERF.md), at
// the 720p tile of 2 (720 x 576 x 128, int16 C): the steady step of six
// directions takes 0.28 ms (a design with one writer an element of S and
// no atomics took 0.55; the bytes 0.04). Its two horizontal jobs alone
// take 0.21 (chains of 576 steps) and its four diagonal ones 0.11. With
// each lane adding its own elements (an add instruction over 16 sectors of
// the L2, where staged it covers 4) the diagonals took 0.21 and the step
// 0.36; with plain stores in place of the adds the step takes 0.18.
//
// Design of sgm_tile_final: the tile's vertical paths (dx = 0) are
// independent columns. With both senses (8 paths) two warps a column walk
// down and up at once and meet in the middle row, as K4's chains meet in
// the middle column: each first half adds its L into S, one block barrier,
// then each second half ends its pixels' totals S + L in registers, where
// the winner-take-all of sgm_path.cuh (sgm_wta, K5's) writes (best, minS,
// dval, uniq). With the top-down sense alone (5 and 4 paths) a warp a
// column ends every pixel in the winner-take-all. Fed from cp.async rings
// of C and S as above, or on the register path; an ordinary launch.

#include "sgm_vert.cuh"

#define TS_MAX_JOBS 8
#define TS_WARPS 4  // warps a block of sgm_tile_scan
#define TS_RING 8   // slots of a warp's ring of costs (a power of 2)
#define TS_PF 4     // pixels the register path loads ahead
#define TF_COLS 4   // columns of a block of sgm_tile_final

struct TsJob {
  int dy, dx, a, R;
  int first;               // its first warp in the launch
  const int32_t* inbox;    // (R + 1, D), or null: zeros
  const int32_t* out_old;  // (R + 1, D), or null: zeros
  int32_t* out_new;        // (R + 1, D), or null: not written
  const int32_t* prev;     // (W, D), or null: zeros
  int32_t* prev_out;       // (W, D), or null: not written
};

struct TsJobs {
  TsJob job[TS_MAX_JOBS];
  int njobs, warps;
};

// Slots of a warp's ring in sgm_tile_final (a power of 2)
template <int K>
struct TsRing {
  static constexpr int depth = K <= 4 ? 8 : 4;
};

// A lane's K elements of an int32 row, or zeros for a null row.
template <int K>
__device__ __forceinline__ void ts_load(const int32_t* row, int d0,
                                        const bool (&ok)[K], int (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = (row != nullptr && ok[k]) ? row[d0 + k] : 0;
}

template <int K>
__device__ __forceinline__ void ts_store(int32_t* row, int d0,
                                         const bool (&ok)[K], const int (&v)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (ok[k]) row[d0 + k] = v[k];
}

template <int K>
__device__ __forceinline__ void ts_step(bool whole, const int (&c)[K],
                                        const int (&Lp)[K], const bool (&ok)[K],
                                        int d0, int D, int p1, int p2,
                                        int (&L)[K]) {
  if (whole)
    sgm_step_whole<K>(c, Lp, d0, D, p1, p2, L);
  else
    sgm_step<K>(c, Lp, ok, d0, D, p1, p2, L);
}

// A D-vector staged in shared memory (st) added into a pixel's D-vector
// of S (Sp): this lane's elements 32 k + lane (oq[k]: inside D), with
// atomic adds whose result is unused, which compile to RED.
template <int K>
__device__ __forceinline__ void ts_red(int32_t* Sp, const int32_t* st, int lane,
                                       const bool (&oq)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (oq[k]) atomicAdd(Sp + 32 * k + lane, st[32 * k + lane]);
}

// One warp a line of a job: gw is the warp's index in the launch. ASYNC:
// the costs come through the warp's cp.async ring (C's pixels are whole
// 16-byte pieces on 16 bytes), else TS_PF pixels ahead in registers.
template <typename CT, int K, bool ASYNC>
__global__ void __launch_bounds__(32 * TS_WARPS)
sgm_tile_scan_kernel(const CT* __restrict__ C, int32_t* __restrict__ S, int W,
                     int D, int p1, int p2, const TsJobs jobs) {
  extern __shared__ __align__(16) char ts_smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * TS_WARPS + w;
  if (gw >= jobs.warps) return;
  int j = 0;
  while (j + 1 < jobs.njobs && gw >= jobs.job[j + 1].first) ++j;
  const TsJob& J = jobs.job[j];
  const int l = gw - J.first;
  const int dy = J.dy, dx = J.dx, a = J.a, R = J.R;
  int32_t* const out_new = J.out_new;
  int32_t* const prev_out = dy != 0 ? J.prev_out : nullptr;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;
  const bool whole = D % K == 0;

  // the line's first pixel (y, x), its steps, and its carry's row
  int y, x, steps;
  const int32_t* from;
  if (dy == 0) {
    y = a + l;
    x = dx > 0 ? 0 : W - 1;
    steps = W;
    from = J.inbox ? J.inbox + (size_t)(l + 1) * D : nullptr;
  } else {
    const int j0 = l < W ? 0 : l - W + 1;  // its first row in scan order
    x = l < W ? l : (dx > 0 ? 0 : W - 1);
    y = (dy > 0 ? a : a + R - 1) + j0 * dy;
    steps = min(R - j0, dx > 0 ? W - x : x + 1);
    const int px = x - dx;
    if (j0 == 0 && px >= 0 && px < W)
      from = J.prev ? J.prev + (size_t)px * D : nullptr;
    else
      from = J.inbox ? J.inbox + (size_t)(y - a + (dy > 0 ? 0 : 1)) * D : nullptr;
  }
  int carry[K];
  ts_load<K>(from, d0, ok, carry);
  if (l == 0 && out_new != nullptr) {  // the outbox's row of the block before
    const int src = dy >= 0 ? R : 0, dst = dy >= 0 ? 0 : R;
    int v[K];
    ts_load<K>(J.out_old ? J.out_old + (size_t)src * D : nullptr, d0, ok, v);
    ts_store<K>(out_new + (size_t)dst * D, d0, ok, v);
  }
  // the edge column toward the next tile, the outbox row of row y
  // (y - a + o_row), and the block's last row in scan order
  const int x_out = dx > 0 ? W - 1 : 0, o_row = dy >= 0 ? 1 : 0;
  const int y_last = dy > 0 ? a + R - 1 : a;
  const long long stride = ((long long)dy * W + dx) * D;  // elements a step
  const long long pix0 = ((long long)y * W + x) * D;
  long long pix = pix0;
  // The adds into S go through shared memory: a step's L is staged there
  // by this lane's d0 and added into S by elements 32 k + lane, so that an
  // add instruction covers 32 consecutive words (4 sectors of the L2) where
  // the lanes' own elements would spread it over 16.
  const bool vec = whole && d0 + K <= D;
  int32_t* const stage = reinterpret_cast<int32_t*>(ts_smem) + (size_t)w * D;
  bool oq[K];
#pragma unroll
  for (int k = 0; k < K; ++k) oq[k] = 32 * k + lane < D;

  auto step = [&](const int (&c)[K]) {
    int L[K];
    ts_step<K>(whole, c, carry, ok, d0, D, p1, p2, L);
    vb_put_lane<int32_t, K>(stage + d0, vec, ok, L);
    __syncwarp();  // the staged L is in the buffer for every lane
    ts_red<K>(S + pix, stage, lane, oq);
    __syncwarp();  // and read by every lane before the next step stages
    if (x == x_out && out_new != nullptr)
      ts_store<K>(out_new + (size_t)(y - a + o_row) * D, d0, ok, L);
    if (y == y_last && prev_out != nullptr)
      ts_store<K>(prev_out + (size_t)x * D, d0, ok, L);
#pragma unroll
    for (int k = 0; k < K; ++k) carry[k] = L[k];
    y += dy;
    x += dx;
    pix += stride;
  };

  if constexpr (ASYNC) {
    // pieces of 16 bytes a lane copies at most, and this lane's
    constexpr int NC = (K * (int)sizeof(CT) + 15) / 16;
    const int cbytes = D * (int)sizeof(CT);
    bool pc[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) pc[t] = lane + 32 * t < cbytes / 16;
    char* const ring = ts_smem + (size_t)TS_WARPS * D * 4 +
                       (size_t)w * TS_RING * cbytes;
    // the next fetched step and its source, advanced a step at a time
    int nf = 0;
    const char* src = reinterpret_cast<const char*>(C + pix0) + 16 * lane;
    const long long sbytes = stride * (long long)sizeof(CT);
    // commit group nf: step nf's costs into its slot (also past the last
    // step, so that a step always waits for the same count)
    auto fetch = [&]() {
      if (nf < steps) {
        char* dst = ring + (nf & (TS_RING - 1)) * cbytes + 16 * lane;
#pragma unroll
        for (int t = 0; t < NC; ++t)
          if (pc[t]) cp_async16(dst + 512 * t, src + 512 * t);
      }
      cp_async_commit();
      ++nf;
      src += sbytes;
    };
    for (int f = 0; f + 1 < TS_RING; ++f) fetch();
    for (int s = 0; s < steps; ++s) {
      __syncwarp();  // every lane is done with the slot the next copy fills
      fetch();
      cp_async_wait<TS_RING - 1>();
      __syncwarp();  // the step's pieces came through every lane
      int c[K];
      vb_get_lane<CT, K>(
          reinterpret_cast<const CT*>(ring + (s & (TS_RING - 1)) * cbytes) + d0,
          vec, ok, c);
      step(c);
    }
    cp_async_wait<0>();
  } else {
    int cr[TS_PF][K];  // steps s0 + i's costs in cr[i]
    auto load = [&](int q, int (&v)[K]) {
      if (q < steps) {
        const CT* p = C + pix0 + q * stride + d0;
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = ok[k] ? (int)__ldg(p + k) : 0;
      }
    };
#pragma unroll
    for (int i = 0; i < TS_PF; ++i) load(i, cr[i]);
    for (int s0 = 0; s0 < steps; s0 += TS_PF) {
#pragma unroll
      for (int i = 0; i < TS_PF; ++i) {
        if (s0 + i >= steps) break;
        int c[K];
#pragma unroll
        for (int k = 0; k < K; ++k) c[k] = cr[i][k];
        load(s0 + i + TS_PF, cr[i]);
        step(c);
      }
    }
  }
}

// One warp's walk of column x over the rows [0, n) (down: 0, 1, ..; else
// from the bottom), from a zero carry. Steps s < wta_from add the L into
// S; steps from wta_from end in the winner-take-all of S + L. meet >= 0:
// the block meets at a barrier before step meet (after the last step when
// meet = n), and S of the steps from meet on is copied only after it;
// keep_mid: step meet - 1's L stays in registers and, after the barrier,
// ends in the winner-take-all of the S found there plus it.
template <typename CT, int K, bool ASYNC>
__device__ __forceinline__ void ts_column(const CT* __restrict__ C,
                                          int32_t* __restrict__ S, int W,
                                          int D, int p1, int p2, int x,
                                          bool live, int n, bool down, int meet,
                                          bool keep_mid, int wta_from,
                                          const SgmWtaOut& wta, char* ring) {
  constexpr int RING = TsRing<K>::depth;
  const int lane = threadIdx.x & 31;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;
  const bool whole = D % K == 0;
  const bool vec = whole && d0 + K <= D;
  const bool vec_s = vec && (uintptr_t)S % (4 * K) == 0;
  const int cbytes = D * (int)sizeof(CT), slot = cbytes + 4 * D;
  const int ring_bytes = RING * slot;
  auto row = [&](int s) { return down ? s : n - 1 - s; };
  auto pix = [&](int s) { return ((size_t)row(s) * W + x) * D; };
  constexpr int NC = (K * (int)sizeof(CT) + 15) / 16, NS = (K * 4 + 15) / 16;
  bool pc[NC], ps[NS];
#pragma unroll
  for (int t = 0; t < NC; ++t) pc[t] = lane + 32 * t < cbytes / 16;
#pragma unroll
  for (int t = 0; t < NS; ++t) ps[t] = lane + 32 * t < D / 4;
  // a step's offset (elements), and the fetch state: the next fetched step,
  // its pixel and ring slot, advanced a step at a time
  const long long ys = down ? (long long)W * D : -(long long)W * D;
  int nf = 0, fslot = 0;
  long long fo = live ? (long long)pix(0) : 0;
  auto fetch = [&](bool with_c, bool with_s) {
    if (nf < n) {
      char* dst = ring + fslot + 16 * lane;
      const char* c = reinterpret_cast<const char*>(C + fo) + 16 * lane;
      const char* sv = reinterpret_cast<const char*>(S + fo) + 16 * lane;
#pragma unroll
      for (int t = 0; t < NC; ++t)
        if (with_c && pc[t]) cp_async16(dst + 512 * t, c + 512 * t);
#pragma unroll
      for (int t = 0; t < NS; ++t)
        if (with_s && ps[t]) cp_async16(dst + cbytes + 512 * t, sv + 512 * t);
    }
    cp_async_commit();
    ++nf;
    fo += ys;
    fslot = fslot + slot == ring_bytes ? 0 : fslot + slot;
  };
  auto s_now = [&](int f, bool after) { return meet < 0 || f < meet || after; };

  int Lp[K], mid[K], cn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) Lp[k] = mid[k] = cn[k] = 0;
  if (live) {
    if constexpr (ASYNC) {
      for (int f = 0; f + 1 < RING; ++f) fetch(true, s_now(f, false));
    } else {
      const size_t o = pix(0) + d0;
#pragma unroll
      for (int k = 0; k < K; ++k) cn[k] = ok[k] ? (int)__ldg(C + o + k) : 0;
    }
  }
  int rslot = 0;                                // step s's ring slot
  long long o = live ? (long long)pix(0) : 0;  // and its pixel
  o += d0;
  for (int s = 0;; ++s) {
    if (s == meet) {
      if (ASYNC && live) cp_async_wait<0>();
      __syncthreads();
      if (keep_mid && live) {
        int v[K];
        ts_load<K>(S + pix(meet - 1), d0, ok, v);
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] += mid[k];
        sgm_wta<K>(v, ok, d0, D, lane, wta, (long long)row(meet - 1) * W + x);
      }
      if (ASYNC && live) {  // S of the steps whose C is in the ring already
        for (int q = meet; q < meet + RING - 1; ++q) {
          if (q < n) {
            char* dst = ring + (q & (RING - 1)) * slot + cbytes + 16 * lane;
            const char* sv = reinterpret_cast<const char*>(S + pix(q)) + 16 * lane;
#pragma unroll
            for (int t = 0; t < NS; ++t)
              if (ps[t]) cp_async16(dst + 512 * t, sv + 512 * t);
          }
          cp_async_commit();
        }
      }
    }
    if (s >= n) break;
    if (!live) continue;
    int c[K], sv[K];
    if constexpr (ASYNC) {
      __syncwarp();
      fetch(true, s_now(s + RING - 1, s >= meet && meet >= 0));
      cp_async_wait<RING - 1>();
      __syncwarp();
      const char* r = ring + rslot;
      vb_get_lane<CT, K>(reinterpret_cast<const CT*>(r) + d0, vec, ok, c);
      vb_get_lane<int32_t, K>(reinterpret_cast<const int32_t*>(r + cbytes) + d0,
                              vec, ok, sv);
      rslot = rslot + slot == ring_bytes ? 0 : rslot + slot;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] = cn[k];
        sv[k] = ok[k] ? S[o + k] : 0;
      }
      if (s + 1 < n) {
#pragma unroll
        for (int k = 0; k < K; ++k) cn[k] = ok[k] ? (int)__ldg(C + o + ys + k) : 0;
      }
    }
    int L[K], tot[K];
    ts_step<K>(whole, c, Lp, ok, d0, D, p1, p2, L);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      Lp[k] = L[k];
      tot[k] = sv[k] + L[k];
    }
    if (s >= wta_from) {
      sgm_wta<K>(tot, ok, d0, D, lane, wta, (long long)row(s) * W + x);
    } else if (keep_mid && s == meet - 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) mid[k] = L[k];
    } else {
      vb_put_lane<int32_t, K>(S + o, vec_s, ok, tot);
    }
    o += ys;
  }
  if (ASYNC && live) cp_async_wait<0>();
}

template <typename CT, int K, bool ASYNC>
__global__ void __launch_bounds__(64 * TF_COLS)
sgm_tile_final_kernel(const CT* __restrict__ C, int32_t* __restrict__ S,
                      int H, int W, int D, int p1, int p2, int two,
                      SgmWtaOut wta) {
  constexpr int RING = TsRing<K>::depth;
  extern __shared__ __align__(16) char tf_smem[];
  const int w = threadIdx.x >> 5;
  const int col = w % TF_COLS;
  const bool up = two && w >= TF_COLS;
  const int x = blockIdx.x * TF_COLS + col;
  const int hb = H / 2, sa = H - hb;
  char* ring = tf_smem + (size_t)w * RING * D * (sizeof(CT) + 4);
  ts_column<CT, K, ASYNC>(C, S, W, D, p1, p2, x, x < W, H, !up,
                          two ? sa : -1, up && sa != hb, two ? sa : 0, wta,
                          ring);
}

// Whether C's and S's D-vectors are whole 16-byte pieces (the ring path).
template <typename CT>
static bool ts_async(const void* C, const void* S, int D) {
  return D * sizeof(CT) % 16 == 0 && D % 4 == 0 && (uintptr_t)C % 16 == 0 &&
         (uintptr_t)S % 16 == 0;
}

// C: (H, W, D) int16 (c_bytes 2) or int32; S: (H, W, D) int32, added to.
// desc: njobs x (dy, dx, a, R); ptrs: njobs x (inbox, out_old, out_new,
// prev, prev_out), each (R + 1, D) or (W, D) int32 or null (see above).
// Requires 1 <= D <= 256, 1 <= njobs <= TS_MAX_JOBS, every block inside
// [0, H), dy in {-1, 0, 1} and dx in {-1, 1} (the vertical paths are
// sgm_tile_final's). One launch.
extern "C" int rtdm_sgm_tile_scan(const void* C, int c_bytes, void* S, int H,
                                  int W, int D, int p1, int p2,
                                  const int* desc, void* const* ptrs,
                                  int njobs, void* stream) {
  if (D < 1 || D > 256 || W < 1 || H < 1 || njobs < 1 ||
      njobs > TS_MAX_JOBS)
    return (int)cudaErrorInvalidValue;
  TsJobs jobs;
  jobs.njobs = njobs;
  jobs.warps = 0;
  // the horizontal jobs' lines first: W steps each, the longest
  int n = 0;
  for (int horiz = 1; horiz >= 0; --horiz) {
    for (int i = 0; i < njobs; ++i) {
      if ((desc[4 * i] == 0) != (horiz == 1)) continue;
      TsJob& J = jobs.job[n++];
      J.dy = desc[4 * i];
      J.dx = desc[4 * i + 1];
      J.a = desc[4 * i + 2];
      J.R = desc[4 * i + 3];
      if (J.dy < -1 || J.dy > 1 || (J.dx != -1 && J.dx != 1) || J.R < 1 ||
          J.a < 0 || J.a + J.R > H)
        return (int)cudaErrorInvalidValue;
      J.inbox = (const int32_t*)ptrs[5 * i];
      J.out_old = (const int32_t*)ptrs[5 * i + 1];
      J.out_new = (int32_t*)ptrs[5 * i + 2];
      J.prev = (const int32_t*)ptrs[5 * i + 3];
      J.prev_out = (int32_t*)ptrs[5 * i + 4];
      J.first = jobs.warps;
      jobs.warps += J.dy == 0 ? J.R : W + J.R - 1;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((jobs.warps + TS_WARPS - 1) / TS_WARPS);
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vb_by_k(D, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const CT* Cv = (const CT*)C;
      // each warp's staging buffer of D int32, then its ring
      const size_t stage = (size_t)TS_WARPS * D * 4;
      if (D * sizeof(CT) % 16 == 0 && (uintptr_t)C % 16 == 0) {
        const size_t smem = stage + (size_t)TS_WARPS * TS_RING * D * sizeof(CT);
        sgm_tile_scan_kernel<CT, K, true><<<grid, 32 * TS_WARPS, smem, st>>>(
            Cv, (int32_t*)S, W, D, p1, p2, jobs);
      } else {
        sgm_tile_scan_kernel<CT, K, false><<<grid, 32 * TS_WARPS, stage, st>>>(
            Cv, (int32_t*)S, W, D, p1, p2, jobs);
      }
      return cudaGetLastError();
    });
  });
}

// C: (H, W, D) int16 (c_bytes 2) or int32; S: (H, W, D) int32, the sum of
// the tile's other directions, used as scratch (its contents afterwards
// are unspecified); best, minS, dval, uniq: (H, W) int32: the
// winner-take-all of S + L(+1, 0) (+ L(-1, 0) when two). One launch.
extern "C" int rtdm_sgm_tile_final(const void* C, int c_bytes, void* S, int H,
                                   int W, int D, int p1, int p2, int two,
                                   int uniqueness_ratio, void* best,
                                   void* minS, void* dval, void* uniq,
                                   void* stream) {
  if (D < 1 || D > 256 || W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const SgmWtaOut out = {(int32_t*)best, (int32_t*)minS, (int32_t*)dval,
                         (int32_t*)uniq, uniqueness_ratio};
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vb_by_k(D, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const bool async = ts_async<CT>(C, S, D);
      const void* kernel = async ? (const void*)sgm_tile_final_kernel<CT, K, true>
                                 : (const void*)sgm_tile_final_kernel<CT, K, false>;
      const int warps = (two ? 2 : 1) * TF_COLS;
      const size_t smem =
          async ? (size_t)warps * TsRing<K>::depth * D * (sizeof(CT) + 4) : 0;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const CT* Cv = (const CT*)C;
      int32_t* Sv = (int32_t*)S;
      void* args[] = {(void*)&Cv, (void*)&Sv, (void*)&H,  (void*)&W,
                      (void*)&D,  (void*)&p1, (void*)&p2, (void*)&two,
                      (void*)&out};
      return cudaLaunchKernel(kernel, dim3((W + TF_COLS - 1) / TF_COLS),
                              dim3(32 * warps), args, smem, st);
    });
  });
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
