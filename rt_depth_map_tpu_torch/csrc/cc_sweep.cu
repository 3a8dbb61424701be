// K2: min-propagation of N int32 fields along allowed neighbour edges, to a
// fixed point or a sweep cap, in one persistent launch per call.
//
// Replaces rt_depth_map_tpu/ops/pallas/cc_sweep.py seg_min_propagate_pallas.
// The semantics are those of the XLA loop of rt_depth_map_tpu/ops/cc.py
// (connected_components_bbox / connected_components_scan), so that the result
// also matches under the sweep cap on a mask that does not converge:
//
//   sweep = [hop, 8-connectivity only] -> row run-min -> column run-min
//   trip  = two sweeps; stop when a trip changed nothing or rounds >= cap
//           (rounds count sweeps, two per trip)
//
// hop: every active pixel takes the min over itself and its neighbours across
// allowed edges, all read from the field before the hop (Jacobi). Run-min:
// every pixel takes the min over its run of allowed edges along the row
// (column). Under the cap the labels depend on this order, so it is kept.
//
// Edges arrive packed, one byte per pixel: bit 0 (y,x)~(y,x+1), bit 1
// (y,x)~(y+1,x), bit 2 (y,x)~(y+1,x+1), bit 3 (y,x+1)~(y+1,x).
//
// What bounds it on the H100: not bytes (four 1280x720 int32 fields are
// 14.7 MB; both buffers, 29.5 MB, stay in the 50 MB L2) but the serial
// structure: up to 8 trips of 4 dependent passes each. A loop on the host
// (launches per pass, a flag copied back and a stream synchronise per trip)
// left the device idle while the host relaunched. The design:
//
// - One cooperative launch per call, sized to the resident blocks. The trip
//   loop runs on the device, with a grid barrier (an arrival counter and a
//   generation word: no separate device compilation needed) after each
//   phase. The entry point never synchronises and never copies to the host;
//   the sweep count stays in a device word.
// - Two phases a sweep. Phase 1: a warp per row of a field hops the row from
//   buffer A (reading rows y-1..y+1 of A) into shared memory, runs the
//   row's segmented min-scans there and writes the row to buffer B. Phase 2:
//   a block per tile of 32 columns of a field loads the tile from B into
//   shared memory (each warp reads 128-byte rows: coalesced), runs the
//   column scans and writes the tile back to A. Both phases stage the edge
//   bits they scan beside the values, and load with several rows in flight.
// - Segmented min-scans in O(L) work: each lane (phase 1) or warp (phase 2)
//   takes a contiguous run; the runs' aggregates are scanned (warp shuffles,
//   or a pass of at most 15 steps over shared memory) and each run is fixed
//   up. A backward scan, then a forward scan over its result, leaves every
//   pixel the minimum of its run of allowed edges: three passes over a run,
//   since the backward fix-up also builds the forward aggregate.
// - Within a phase no thread reads what another thread of the phase writes,
//   so loads go through L1; the grid barrier's acquire orders them after
//   the previous phase's stores.
// - Only what can change is recomputed. Values only fall (A >= B >= the
//   next A), so a row of A changes in sweep k exactly where sweep k's row
//   phase or column phase lowers a pixel of it; both phases mark such rows
//   with k + 1 (in one of two arrays by sweep parity, so that no mark is
//   overwritten while the row phase reads the other). The row phase also
//   marks with k + 1 each 32-column tile of B whose values it changed.
//   Sweep k's row phase (k > 0) recomputes a row only if that row (or, with
//   the hop, a row next to it) was marked k, and its column phase
//   recomputes a tile only if it was marked k + 1; every other row of B and
//   tile of A already holds its value. Marks are sweep numbers, so they
//   never need a reset.
// - "Changed": a trip changed something exactly when one of its phases
//   lowered a pixel. Such a phase of trip t stores t into one device word.
//   After the trip's last barrier every block reads the word and stops when
//   it is below t. Only blocks that read t go on to store larger values, so
//   every block reads the same verdict, and the word never needs a reset.
//
// - Rows and columns of any length. A phase holds a whole row (column
//   tile) in shared memory where it fits: 16 rows of W + 32 int32 and W
//   edge bytes in phase 1, a 32 x H tile of int32 and edge bytes in phase
//   2 (W up to 2880 and H up to 1401 on the H100; the wrapper plans it,
//   ops/cuda/cc_sweep.py cc_chunks). A longer one is scanned in chunks of
//   wc columns (hc rows) staged from device memory, where L2 holds the
//   fields: a first pass from the last chunk back builds each chunk's
//   carry from the far side (the backward scan's value at the next
//   chunk's first pixel), then a pass from the first chunk runs the
//   chunk's backward and forward scans with the carry from each side, as
//   the whole row's scans would: the same segment minima after every
//   sweep, so the capped result does not change. The hop reads A, so a
//   chunk restages its pixels with the hop in both passes.

#include <cuda_runtime.h>
#include <stdint.h>

#define CC_BIG (1 << 30)
#define CC_THREADS 512
#define CC_WARPS (CC_THREADS / 32)
#define CC_FULL 0xffffffffu
#define CC_MAX_CHUNKS 32  // chunks of a row or column (one carry a lane)

struct CcArgs {
  int32_t* a;             // (N, H, W) fields: in, out, and each sweep's end
  int32_t* b;             // (N, H, W) scratch: each sweep's middle
  const uint8_t* active;  // (H, W)
  const uint8_t* edges;   // (H, W), packed as above
  int n, h, w, diag, max_rounds;
  int wc, hc;             // chunk width (phase 1) and height (phase 2)
  unsigned* bar;          // [0] arrivals, [1] generation
  unsigned* stamp;        // the last trip (1-based) that changed A
  int* rounds;            // sweeps run
  int* row_mark;          // (2, N, H): 1 + a sweep that changed the row of A,
                          // in [(sweep + 1) & 1]
  int* tile_mark;         // (N, tiles): 1 + the last sweep that changed the
                          // tile of B
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Barrier over the whole grid; the cooperative launch guarantees that every
// block is resident. The last block to arrive resets the counter and moves
// the generation on; the others wait for the generation to move.
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (ld_acquire(bar + 1) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// int32 words of a warp's row buffer in phase 1: W + 32 values, then W
// edge bytes
__host__ __device__ inline int cc_row_words(int W) {
  return W + 32 + (W + 3) / 4;
}

// Append x to a run's aggregate (f: the run holds a segment start; v: the
// min since the run's last start, or over the whole run if none).
__device__ __forceinline__ void seg_push(int& f, int& v, bool start, int x) {
  if (start) {
    f = 1;
    v = x;
  } else {
    v = min(v, x);
  }
}

// Exclusive segmented-min scan of the lanes' run aggregates, in lane order
// (UP) or reverse lane order: the carry into this lane's run. The first lane
// in scan order gets `init`, the carry from beyond the lanes' runs (CC_BIG
// at a row's end).
template <bool UP>
__device__ __forceinline__ int warp_seg_carry(int f, int v, int lane,
                                              int init) {
  if ((UP ? lane == 0 : lane == 31) && !f) v = min(v, init);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int fo = UP ? __shfl_up_sync(CC_FULL, f, o)
                      : __shfl_down_sync(CC_FULL, f, o);
    const int vo = UP ? __shfl_up_sync(CC_FULL, v, o)
                      : __shfl_down_sync(CC_FULL, v, o);
    if (UP ? lane >= o : lane + o < 32) {
      if (!f) v = min(v, vo);
      f |= fo;
    }
  }
  const int prev = UP ? __shfl_up_sync(CC_FULL, v, 1)
                      : __shfl_down_sync(CC_FULL, v, 1);
  return (UP ? lane == 0 : lane == 31) ? init : prev;
}

// The forward aggregate of a run walked backward: before the run's last
// start is reached, x joins the min (start: x is that start).
__device__ __forceinline__ void seg_pull(int& f, int& v, bool start, int x) {
  if (!f) {
    v = min(v, x);
    f = start;
  }
}

// Fix-up step of a run: the running min m (reset at a segment start) into
// ref; true if the pixel fell.
__device__ __forceinline__ bool seg_fix(int32_t& ref, bool start, int& m) {
  const int32_t s = ref;
  m = start ? s : min(m, s);
  ref = m;
  return m < s;
}

// Phase 1 of sweep k: B = row run-min of (hop of A). A warp per row, in
// chunks of up to p.wc pixels (one chunk where the row fits); lane l owns
// pixels [l * R, l * R + R) of the chunk, stored at j + l in the warp's
// buffer (a lane stride of R + 1 words, so the lanes' runs fall on distinct
// banks when R is even), beside the chunk's horizontal edge bits (one byte
// each). The coalesced loops walk the chunk in 32-pixel pieces (piece i is
// tile x0 / 32 + i) and carry x / R and x % R along, since a division by
// the runtime R in every iteration would cost more than the rest of the
// phase.
template <bool CHUNKED>
__device__ void row_phase(const CcArgs& p, int32_t* smem, int k,
                          unsigned trip) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.w, H = p.h, WC = CHUNKED ? p.wc : W;
  const int nchunks = CHUNKED ? (W + WC - 1) / WC : 1;
  const int tiles = (W + 31) >> 5;
  int32_t* buf = smem + warp * cc_row_words(WC);
  uint8_t* eh = (uint8_t*)(buf + WC + 32);
  const int nwarps = gridDim.x * CC_WARPS;
  for (int task = blockIdx.x * CC_WARPS + warp; task < p.n * H;
       task += nwarps) {
    const int y = task % H;
    if (k > 0) {  // recompute only rows whose inputs changed in sweep k - 1
      const int* rm = p.row_mark + (size_t)(k & 1) * p.n * H + task;
      bool need = rm[0] == k;  // task = n * H + y
      if (p.diag)
        need |= (y > 0 && rm[-1] == k) ||
                (y + 1 < H && rm[1] == k);
      if (!need) continue;
    }
    const int32_t* arow = p.a + (size_t)task * W;
    const uint8_t* e = p.edges + (size_t)y * W;
    const uint8_t* act = p.active + (size_t)y * W;
    bool fell = false;
    // the chunk [x0, x0 + wn) of the hop of A into the buffer (R: pixels a
    // lane)
    auto stage = [&](int x0, int wn, int R) {
      int xq = lane / R, xr = lane % R;  // xl / R, xl % R
#pragma unroll 4
      for (int xl = lane; xl < wn; xl += 32) {
        const int x = x0 + xl;
        const int32_t v = arow[x];
        const uint8_t ec = e[x];
        int32_t m = v;
        if (p.diag) {
          // every load's address comes from (x, y) alone, so all of them
          // are in flight at once; edges that leave the image are never
          // set, so a clamped neighbour is masked off
          const bool l = x > 0, u = y > 0;
          const int xl1 = l ? x - 1 : x, xr1 = x + 1 < W ? x + 1 : x;
          const int32_t* up = arow - (u ? W : 0);
          const int32_t* dn = arow + (y + 1 < H ? W : 0);
          const uint8_t el = l ? e[x - 1] : 0;
          const uint8_t eu = u ? e[x - W] : 0;
          const uint8_t eul = u && l ? e[x - W - 1] : 0;
          const int32_t nr = arow[xr1], nl = arow[xl1];
          const int32_t nd = dn[x], ndr = dn[xr1], ndl = dn[xl1];
          const int32_t nu = up[x], nur = up[xr1], nul = up[xl1];
          // an allowed edge joins two active pixels, so a neighbour's
          // value is its field value (ops/cc.py hop_many reads
          // where(active, f, BIG))
          if (act[x]) {
            if (ec & 1) m = min(m, nr);
            if (ec & 2) m = min(m, nd);
            if (ec & 4) m = min(m, ndr);
            if (el & 1) m = min(m, nl);
            if (el & 8) m = min(m, ndl);  // (y+1,x-1)
            if (eu & 2) m = min(m, nu);
            if (eu & 8) m = min(m, nur);  // (y-1,x+1)
            if (eul & 4) m = min(m, nul);
          }
          fell |= m < v;
        }
        buf[xl + xq] = m;
        eh[xl] = ec & 1;
        for (xr += 32; xr >= R; xr -= R) ++xq;
      }
      __syncwarp();
    };
    // a row of several chunks: from the last chunk back, the carry into
    // each chunk from its right (the backward scan's value at the next
    // chunk's first pixel), kept by lane c % 32 for chunk c
    int carry_r = CC_BIG, into = CC_BIG;
    for (int c = nchunks - 1; c > 0; --c) {
      const int x0 = c * WC, wn = min(WC, W - x0), R = (wn + 31) >> 5;
      const int lo = lane * R, hi = min(wn, lo + R);
      stage(x0, wn, R);
      int f = 0, v = CC_BIG;
      for (int j = hi - 1; j >= lo; --j) seg_push(f, v, !eh[j], buf[j + lane]);
      const int m = warp_seg_carry<false>(f, v, lane, into);
      into = __shfl_sync(CC_FULL, f ? v : min(v, m), 0);
      if (lane == (c - 1) % 32) carry_r = into;
      __syncwarp();  // the buffer is restaged
    }
    int carry_l = CC_BIG;  // the forward scan's value left of the chunk
    for (int c = 0; c < nchunks; ++c) {
      const int x0 = c * WC, wn = min(WC, W - x0), R = (wn + 31) >> 5;
      const int lo = lane * R, hi = min(wn, lo + R);
      const int from_r = __shfl_sync(CC_FULL, carry_r, c % 32);
      // a segment starts at the chunk's first pixel where the edge to its
      // left is missing
      const bool start0 = x0 == 0 || !(e[x0 - 1] & 1);
      stage(x0, wn, R);
      // backward: a segment starts where the edge to the right is missing;
      // the fix-up also builds the forward aggregate of its results, where
      // a segment starts where the edge to the left is missing
      int f = 0, v = CC_BIG;
      for (int j = hi - 1; j >= lo; --j) seg_push(f, v, !eh[j], buf[j + lane]);
      int m = warp_seg_carry<false>(f, v, lane,
                                    c + 1 < nchunks ? from_r : CC_BIG);
      f = 0;
      v = CC_BIG;
      for (int j = hi - 1; j >= lo; --j) {
        fell |= seg_fix(buf[j + lane], !eh[j], m);
        seg_pull(f, v, j == 0 ? start0 : !eh[j - 1], m);
      }
      m = warp_seg_carry<true>(f, v, lane, carry_l);
      for (int j = lo; j < hi; ++j)
        fell |= seg_fix(buf[j + lane], j == 0 ? start0 : !eh[j - 1], m);
      carry_l = __shfl_sync(CC_FULL, m, (wn - 1) / R);
      __syncwarp();
      int32_t* brow = p.b + (size_t)task * W + x0;
      int* tm = p.tile_mark + (size_t)(task / H) * tiles + x0 / 32;
      int xq = lane / R, xr = lane % R;
#pragma unroll 4
      for (int i = 0; i < R; ++i) {
        const int xl = i * 32 + lane;
        bool diff = false;
        if (xl < wn) {
          const int32_t out = buf[xl + xq];
          // sweep 0's column phase takes every tile, and B holds no row yet
          diff = k == 0 || out != brow[xl];
          brow[xl] = out;
        }
        if (__any_sync(CC_FULL, diff) && lane == 0) tm[i] = k + 1;
        for (xr += 32; xr >= R; xr -= R) ++xq;
      }
      __syncwarp();  // the buffer is refilled by the next chunk or task
    }
    if (__any_sync(CC_FULL, fell) && lane == 0) {
      p.row_mark[(size_t)((k + 1) & 1) * p.n * H + task] = k + 1;
      *(volatile unsigned*)p.stamp = trip;
    }
  }
}

// Phase 2 of sweep k: A = column run-min of B. A block per tile of 32
// columns of one field, in chunks of up to p.hc rows (one chunk where the
// column fits), held in shared memory as tile[y][lane] beside the vertical
// edge bits; warp w owns rows [w * Rc, w * Rc + Rc) of the chunk, lane c
// the column x0 + c. A column of several chunks first builds, from the
// last chunk back, the carry into each chunk from below (cbs[c][lane]).
template <bool CHUNKED>
__device__ void col_phase(const CcArgs& p, int32_t* smem, int k,
                          unsigned trip) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = p.w, H = p.h, HC = CHUNKED ? p.hc : H;
  const int nchunks = CHUNKED ? (H + HC - 1) / HC : 1;
  const int tiles = (W + 31) >> 5;
  int32_t* tile = smem;                     // [HC][32]
  int32_t* aggf = tile + (size_t)HC * 32;   // [CC_WARPS][32]
  int32_t* aggv = aggf + CC_WARPS * 32;     // [CC_WARPS][32]
  int32_t* cbs = aggv + CC_WARPS * 32;      // [CC_MAX_CHUNKS][32], chunked
  uint8_t* ev = (uint8_t*)(cbs + (nchunks > 1 ? CC_MAX_CHUNKS * 32 : 0));
  for (int task = blockIdx.x; task < p.n * tiles; task += gridDim.x) {
    // recompute only tiles of B that this sweep's row phase changed
    if (k > 0 && p.tile_mark[task] != k + 1) continue;
    const int x = (task % tiles) * 32 + lane;
    const bool in = x < W;
    const size_t plane = (size_t)(task / tiles) * H * W;
    // rows [y0, y0 + hn) of B into the tile
    auto stage = [&](int y0, int hn) {
#pragma unroll 16
      for (int y = warp; y < hn; y += CC_WARPS) {
        const size_t q = (size_t)(y0 + y) * W + x;
        tile[y * 32 + lane] = in ? p.b[plane + q] : CC_BIG;
        ev[y * 32 + lane] = in ? (__ldg(p.edges + q) >> 1) & 1 : 0;
      }
      __syncthreads();
    };
    // each warp's backward (bottom to top) aggregate: a segment starts
    // where the edge to the row below is missing
    auto push = [&](int lo, int hi) {
      int f = 0, v = CC_BIG;
      for (int y = hi - 1; y >= lo; --y)
        seg_push(f, v, !ev[y * 32 + lane], tile[y * 32 + lane]);
      aggf[warp * 32 + lane] = f;
      aggv[warp * 32 + lane] = v;
      __syncthreads();
    };
    for (int c = nchunks - 1; c > 0; --c) {
      const int y0 = c * HC, hn = min(HC, H - y0);
      const int Rc = (hn + CC_WARPS - 1) / CC_WARPS;
      const int lo = min(hn, warp * Rc), hi = min(hn, lo + Rc);
      stage(y0, hn);
      push(lo, hi);
      if (warp == 0) {
        int m = c + 1 < nchunks ? cbs[c * 32 + lane] : CC_BIG;
        for (int j = CC_WARPS - 1; j >= 0; --j) {
          const int jv = aggv[j * 32 + lane];
          m = aggf[j * 32 + lane] ? jv : min(m, jv);
        }
        cbs[(c - 1) * 32 + lane] = m;
      }
      __syncthreads();  // the tile is restaged
    }
    int* rm = p.row_mark + (size_t)((k + 1) & 1) * p.n * H +
              (size_t)(task / tiles) * H;
    bool changed = false;
    int carry_up = CC_BIG;  // the forward scan's value above the chunk
    for (int c = 0; c < nchunks; ++c) {
      const int y0 = c * HC, hn = min(HC, H - y0);
      const int Rc = (hn + CC_WARPS - 1) / CC_WARPS;
      const int lo = min(hn, warp * Rc), hi = min(hn, lo + Rc);
      // a segment starts at the chunk's first row where the edge to the row
      // above is missing
      const bool start0 =
          y0 == 0 || !in ||
          !((__ldg(p.edges + (size_t)(y0 - 1) * W + x) >> 1) & 1);
      stage(y0, hn);
      push(lo, hi);
      int m = c + 1 < nchunks ? cbs[c * 32 + lane] : CC_BIG;
      for (int j = CC_WARPS - 1; j > warp; --j) {
        const int jv = aggv[j * 32 + lane];
        m = aggf[j * 32 + lane] ? jv : min(m, jv);
      }
      __syncthreads();  // every warp has read the aggregates
      // the fix-up also builds the forward (top to bottom) aggregate of its
      // results: a segment starts where the edge to the row above is missing
      int f = 0, v = CC_BIG;
      for (int y = hi - 1; y >= lo; --y) {
        const bool fell = seg_fix(tile[y * 32 + lane], !ev[y * 32 + lane], m);
        seg_pull(f, v, y == 0 ? start0 : !ev[(y - 1) * 32 + lane], m);
        if (__any_sync(CC_FULL, fell) && lane == 0) {
          rm[y0 + y] = k + 1;
          changed = true;
        }
      }
      aggf[warp * 32 + lane] = f;
      aggv[warp * 32 + lane] = v;
      __syncthreads();
      m = carry_up;
      for (int j = 0; j < warp; ++j) {
        const int jv = aggv[j * 32 + lane];
        m = aggf[j * 32 + lane] ? jv : min(m, jv);
      }
      for (int y = lo; y < hi; ++y) {
        const bool fell = seg_fix(tile[y * 32 + lane],
                                  y == 0 ? start0 : !ev[(y - 1) * 32 + lane],
                                  m);
        if (__any_sync(CC_FULL, fell) && lane == 0) {
          rm[y0 + y] = k + 1;
          changed = true;
        }
      }
      __syncthreads();
      if (in) {
#pragma unroll 8
        for (int y = warp; y < hn; y += CC_WARPS)
          p.a[plane + (size_t)(y0 + y) * W + x] = tile[y * 32 + lane];
      }
      carry_up = tile[(hn - 1) * 32 + lane];
      __syncthreads();  // the tile is refilled by the next chunk or task
    }
    if (changed) *(volatile unsigned*)p.stamp = trip;
  }
}

// CHUNKED: a row or a column of the field is longer than a chunk (the
// shapes that fit compile to one chunk a row and a column, with no carries)
template <bool CHUNKED>
__global__ void __launch_bounds__(CC_THREADS, 1) cc_propagate_kernel(CcArgs p) {
  extern __shared__ int32_t smem[];
  int k = 0;  // sweeps run
  for (unsigned trip = 1; k < p.max_rounds; ++trip) {
    for (int s = 0; s < 2; ++s, ++k) {
      row_phase<CHUNKED>(p, smem, k, trip);
      grid_barrier(p.bar);
      col_phase<CHUNKED>(p, smem, k, trip);
      grid_barrier(p.bar);
    }
    if (ld_acquire(p.stamp) < trip) break;  // the trip changed nothing
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.rounds = k;
}

// A block's dynamic shared memory: the larger of the two phases' (the
// column phase keeps the chunk carries only when a column has several
// chunks; ops/cuda/cc_sweep.py cc_smem_bytes).
static size_t cc_smem(int H, int W, int hc, int wc) {
  const size_t rows = (size_t)CC_WARPS * cc_row_words(wc) * sizeof(int32_t);
  const size_t cols =
      ((size_t)hc * 32 + 2 * CC_WARPS * 32 + (hc < H ? CC_MAX_CHUNKS * 32 : 0)) *
          sizeof(int32_t) +
      (size_t)hc * 32;
  return rows > cols ? rows : cols;
}

// Shared memory a block may opt into on the current device, into *bytes.
extern "C" int rtdm_cc_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// fields: (N, H, W) int32, updated in place; scratch: same size. state:
// 4 + 2 * N * H + N * ceil(W / 32) zeroed words (grid barrier arrivals and
// generation, the change stamp, the sweep count, written at the end; the
// row and tile marks). wc, hc: the chunk width (W, or a multiple of 32)
// and height (H or less), at most CC_MAX_CHUNKS chunks each. One
// cooperative launch on `stream`; returns its error code (a chunk that
// needs more shared memory than a block may have, or a grid that cannot be
// resident, is refused).
extern "C" int rtdm_cc_propagate(void* fields, void* scratch,
                                 const void* active, const void* edges, int N,
                                 int H, int W, int diag, int max_rounds,
                                 int wc, int hc, void* state, void* stream) {
  if (wc < 1 || hc < 1 || (wc < W && wc % 32 != 0) ||
      (W + wc - 1) / wc > CC_MAX_CHUNKS || (H + hc - 1) / hc > CC_MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  wc = wc < W ? wc : W;
  hc = hc < H ? hc : H;
  const size_t smem = cc_smem(H, W, hc, wc);
  const void* kernel = wc < W || hc < H
                           ? (const void*)cc_propagate_kernel<true>
                           : (const void*)cc_propagate_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      CC_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  unsigned* st = (unsigned*)state;
  int* row_mark = (int*)(st + 4);
  CcArgs a = {(int32_t*)fields, (int32_t*)scratch, (const uint8_t*)active,
              (const uint8_t*)edges, N, H, W, diag, max_rounds,
              wc, hc, st, st + 2, (int*)(st + 3),
              row_mark, row_mark + (size_t)2 * N * H};
  void* args[] = {&a};
  // one block per SM: 16 warps a block cover the rows, and fewer blocks
  // make each grid barrier cheaper
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(sms), dim3(CC_THREADS),
                                          args, smem, (cudaStream_t)stream);
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
