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
// sgm_path.cuh (p2 raised to p1 + 1 by the caller). A line starts from a
// carry, the L of its first pixel's predecessor:
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
// What bounds a step on the H100: device memory bytes (C read, S read and
// written) and the chain of W dependent steps along each row. The first
// design (a warp a line, every job on its own, one atomic add into S a
// direction and element, the next pixel's costs loaded into registers a
// step ahead) took, on an NVIDIA H100 80GB HBM3 at 700 W as every time
// here, 0.50 ms for a 720p wavefront step at 12.7x its bound,
// set by the cost load on each row's chain and by the atomics on the
// diagonals (tools/time_torch_tile.py --ablate). This design's step takes
// ~0.9 us a column (0.53 ms at the tile of 2, whose bytes take 0.08): the
// pace of a walk's warps, each alone on its scheduler, with a barrier a
// step and the carries between groups; bytes do not set it (PERF.md). A
// copy of the first design fed from a cp.async ring, its atomics kept,
// took 0.38 ms (tools/time_torch_tile.py --ablate on its checkout): one
// writer makes a chain's warp read S through its ring and write it back,
// where an atomic add leaves the add to the L2 and does not wait.
//
// Design of sgm_tile_scan:
//
// - Walks. The jobs of a launch that scan the same rows in the same sense
//   share one walk and one read-modify-write of S: (0, +1) with (+1, +1),
//   (0, -1) with (+1, -1); a diagonal (-1, dx) walks alone. A walk is a warp
//   a row, D over its lanes, every row stepping its columns in lockstep
//   (x = 0 .. W - 1 for dx = +1), so that the diagonal carry of row y at
//   column x, the L of row y - dy at column x - dx, is what the row before
//   it left a step before; the horizontal carry stays in registers.
// - Groups. A block of TS_G = 4 warps walks a group of 4 rows: the
//   diagonal carry passes between them through shared memory
//   (double-buffered by step parity, one barrier a step; progress words in
//   shared memory that a row polls in place of the barrier were slower,
//   0.78 against 0.66 ms a 720p step). A group's first row takes it from
//   the group before it in scan order, whose last row publishes its L of
//   every column in device memory as 64-bit words that hold the value and
//   the launch's tag (epoch); the first row loads them TS_AHEAD steps
//   ahead and polls a word until its tag is this launch's. Nothing bounds
//   how far a group runs ahead of the next, so every group has a whole row
//   of slots. Small groups spread a launch's rows over the SMs, a few warps
//   each (groups of 8 rows, two a block, put 16 warps on each of 12-24 SMs
//   and took 1.06 ms a 720p step; a warp walking 3 rows took 2.16;
//   tools/time_torch_tile.py).
// - Units. Two walks on the same rows in opposite horizontal senses (at
//   n = 1 tiles, on the middle tile of an odd n, and where the top-down
//   block of one family meets the bottom-up block of the other) form a
//   pair, whose two walks meet in the middle column as K4's chains do
//   (sgm_horiz.cu): each walk's first half adds into S the columns the
//   other reaches last; the two blocks of a group meet (a meeting word
//   each); then each walk's second half adds into what the other left.
//   Walks that cover rows of other walks and could not be paired (two
//   walks of the same horizontal sense, as when all six directions lie on
//   one block) form units that wait until every earlier unit on their rows
//   has finished (a done word a block).
//   So each element of S has one writer at a time, and no atomics are
//   needed. The groups' carries, the meetings and the waits need every
//   block resident at once: the launch is cooperative, which guarantees
//   that or refuses it.
// - Loads. Each warp copies its row's C and S D-vectors ahead into a ring
//   in shared memory with cp.async (async_copy.cuh), as K4 and K9a do, so
//   no step waits on device memory; a pair's second half copies S only
//   after the middle barrier. Pixels whose D-vectors are not whole 16-byte
//   pieces (D = 100 at int16, for example) take the register path: the
//   next pixel's costs loaded a step ahead, S at the step.
// - No vertical job (dx = 0): those are sgm_tile_final's, and the entry
//   refuses them.
//
// Design of sgm_tile_final: the tile's vertical paths (dx = 0) are
// independent columns. With both senses (8 paths) two warps a column walk
// down and up at once and meet in the middle row, as K4's chains meet in
// the middle column: each first half adds its L into S, one block barrier,
// then each second half ends its pixels' totals S + L in registers, where
// the winner-take-all of sgm_path.cuh (sgm_wta, K5's) writes (best, minS,
// dval, uniq). With the top-down sense alone (5 and 4 paths) a warp a
// column ends every pixel in the winner-take-all. Fed from cp.async rings
// as above; no cooperative launch.

#include "sgm_vert.cuh"

#define TS_MAX_JOBS 8
#define TS_MAX_UNITS 8
#define TF_COLS 4  // columns of a block of sgm_tile_final

typedef unsigned long long ts_word;  // (epoch << 32) | (uint32) value

struct TsJob {
  int dy, dx, a, R;
  const int32_t* inbox;    // (R + 1, D), or null: zeros
  const int32_t* out_old;  // (R + 1, D), or null: zeros
  int32_t* out_new;        // (R + 1, D), or null: not written
  const int32_t* prev;     // (W, D), or null: zeros
  int32_t* prev_out;       // (W, D), or null: not written
};

// A walk: rows [a, a + R) of its unit in sense vs (+1 top-down), columns in
// sense dx; h and d: its horizontal and diagonal jobs (-1: none); buf: the
// first word of its groups' carry slots in the scratch.
struct TsWalk {
  int dx, vs, h, d;
  long long buf;
};

// One walk or a pair of walks over rows [a, a + R), ng groups of rows.
// Its blocks are [first, first + blocks); waits: a bit for each earlier
// unit to wait for.
struct TsUnit {
  int a, R, nwalks;
  unsigned waits;
  int ng, first, blocks;
  TsWalk walk[2];
};

struct TsPlan {
  TsJob job[TS_MAX_JOBS];
  TsUnit unit[TS_MAX_UNITS];
  int nunits;
};

// Rows of a group of a walk, a warp a row: a block is one group
#define TS_G 4

// Slots of a warp's ring (a power of 2)
template <int K>
struct TsRing {
  static constexpr int depth = K <= 4 ? 8 : 4;
};

// Steps ahead that a group's first row loads the carry words of the group
// before it (into registers, apart from the ring, so that the costs keep
// their ring's distance): a group lags the group before it by about this
// many steps, and the lags of a walk's groups add up (on an H100 at 700 W,
// a 720p step of the tile of 2 took 0.53 ms at 1 step ahead, 0.62 at 2 and
// 0.78 at 4; tools/time_torch_tile.py --ablate)
#define TS_AHEAD 1

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

// Dynamic shared memory of a block of TS_G warps: [2 parities][TS_G][D]
// int32 diagonal carries, then with the ring [TS_G][ring] slots of one
// pixel's C and S and (a walk's first row) its prev column.
__host__ __device__ inline size_t ts_smem_bytes(int D, int ring, bool async,
                                               int c_bytes) {
  return (size_t)2 * TS_G * D * 4 +
         (async ? (size_t)ring * TS_G * D * (c_bytes + 8) : 0);
}

// One group of a walk, a warp a row: block ub of a row unit. To keep a
// step's instructions few (a walk's pace), every offset advances by one
// column a step instead of being recomputed, and each lane's 16-byte
// pieces of a pixel are fixed before the walk, as in K9a (sgm_hdw.cu).
template <typename CT, int K, bool ASYNC>
__device__ __forceinline__ void ts_rows(const TsPlan& P, const TsUnit& U,
                                        int ub, const CT* __restrict__ C,
                                        int32_t* __restrict__ S, int W, int D,
                                        int p1, int p2, ts_word* scratch,
                                        int nblocks, unsigned epoch,
                                        char* smem) {
  constexpr int RING = TsRing<K>::depth;
  // pieces of 16 bytes a lane copies at most: C and S
  constexpr int NC = (K * (int)sizeof(CT) + 15) / 16, NS = (K * 4 + 15) / 16;
  const int lane = threadIdx.x & 31, i = threadIdx.x >> 5;
  const int ng = U.ng;
  const int wi = ub / ng, g = ub % ng;  // the block's walk and group
  const bool pair = U.nwalks == 2;
  const TsWalk Wk = U.walk[wi];
  const int dx = Wk.dx, a = U.a, R = U.R;
  const bool down = Wk.vs > 0;
  const bool has_h = Wk.h >= 0, has_d = Wk.d >= 0;
  const TsJob Jh = P.job[has_h ? Wk.h : 0];
  const TsJob Jd = P.job[has_d ? Wk.d : 0];
  const int y0 = a + g * TS_G;  // the group's rows [y0, y0 + nrows)
  const int nrows = min(TS_G, a + R - y0);
  const bool live = i < nrows;
  const int y = y0 + i;
  // the groups before and after this one in scan order
  const int pg = down ? g - 1 : g + 1, sg = down ? g + 1 : g - 1;
  const bool entry = live && has_d && pg >= 0 && pg < ng &&
                     i == (down ? 0 : nrows - 1);
  const bool leave = live && has_d && sg >= 0 && sg < ng &&
                     i == (down ? nrows - 1 : 0);
  const bool first_row = y == (down ? a : a + R - 1);
  const bool last_row = y == (down ? a + R - 1 : a);
  // the row before, within the group (clamped where none is read)
  const int ip = min(max(down ? i - 1 : i + 1, 0), TS_G - 1);
  const size_t WD = (size_t)W * D;
  const int d0 = lane * K;
  bool ok[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ok[k] = d0 + k < D;
  const bool whole = D % K == 0;
  const bool vec = whole && d0 + K <= D;
  const bool vec_s = vec && (uintptr_t)S % (4 * K) == 0;
  const int hb = W / 2, sa = W - hb;
  const bool keep_mid = pair && wi == 1 && sa != hb;  // odd W: the middle column

  // column offsets (elements): of step 0, and a step's
  const long long x0 = dx > 0 ? 0 : (long long)(W - 1) * D;
  const long long xs = (long long)dx * D;
  const CT* Crow = C + (size_t)y * WD;
  int32_t* Srow = S + (size_t)y * WD;
  const ts_word* bin = scratch + Wk.buf + (size_t)pg * WD + d0;
  ts_word* bout = scratch + Wk.buf + (size_t)g * WD + d0;
  const int cbytes = D * (int)sizeof(CT), slot = cbytes + 8 * D;
  const int ring_bytes = RING * slot;
  int32_t* cd = reinterpret_cast<int32_t*>(smem);
  char* ring = smem + (size_t)2 * TS_G * D * 4 + (size_t)i * ring_bytes;
  // the diagonal carries by step parity: this row's, and the row before's
  int32_t* cw0 = cd + (size_t)i * D + d0;
  int32_t* cw1 = cd + (size_t)(TS_G + i) * D + d0;
  const int32_t* cr0 = cd + (size_t)ip * D + d0;
  const int32_t* cr1 = cd + (size_t)(TS_G + ip) * D + d0;
  // this lane's pieces of a pixel
  bool pc[NC], ps[NS];
#pragma unroll
  for (int t = 0; t < NC; ++t) pc[t] = lane + 32 * t < cbytes / 16;
#pragma unroll
  for (int t = 0; t < NS; ++t) ps[t] = lane + 32 * t < D / 4;
  // the fetch state: the next fetched step, this lane's first piece of its
  // C and S, and its ring slot; a fetch advances each by a column
  int nf = 0, fslot = 0;
  const char* fc = reinterpret_cast<const char*>(Crow + x0) + 16 * lane;
  const char* fs = reinterpret_cast<const char*>(Srow + x0) + 16 * lane;
  const long long fcs = xs * (long long)sizeof(CT), fss = xs * 4;
  // the walk's first row reads its diagonal carry from prev at column
  // x(s - 1): copied with the step's costs, as a load at the step set the
  // pace of its group and so of the walk (a 720p step of the tile of 2 took
  // 0.62 ms with the load at the step, 0.53 copied; tools/time_torch_tile.py)
  const bool fetch_p = live && has_d && first_row && Jd.prev != nullptr;
  const char* fp = fetch_p ? reinterpret_cast<const char*>(Jd.prev + x0 - xs) + 16 * lane
                           : nullptr;
  char* const fdst = ring + 16 * lane;
  // commit group nf: step nf's C (with_c) and S (with_s) into its ring
  // slot (also past the last step, so that a step always waits for the
  // same count)
  auto fetch = [&](bool with_c, bool with_s) {
    if (nf < W) {
      char* dst = fdst + fslot;
#pragma unroll
      for (int t = 0; t < NC; ++t)
        if (with_c && pc[t]) cp_async16(dst + 512 * t, fc + 512 * t);
#pragma unroll
      for (int t = 0; t < NS; ++t)
        if (with_s && ps[t]) cp_async16(dst + cbytes + 512 * t, fs + 512 * t);
      if (fetch_p && with_c && nf >= 1) {
#pragma unroll
        for (int t = 0; t < NS; ++t)
          if (ps[t]) cp_async16(dst + cbytes + 4 * D + 512 * t, fp + 512 * t);
      }
    }
    cp_async_commit();
    ++nf;
    fc += fcs;
    fs += fss;
    if (fetch_p) fp += fss;
    fslot = fslot + slot == ring_bytes ? 0 : fslot + slot;
  };
  // whether step n's S may be copied now: a pair's second half reads what
  // the other walk wrote, so only after the walks meet
  auto s_now = [&](int n, bool after) { return !pair || n < sa || after; };
  // the entry row's carry words of step t (column x(t - 1)), loaded into
  // registers TS_AHEAD steps before the step reads them
  auto load_words = [&](int t, ts_word (&v)[K]) {
    if (entry && t >= 1 && t < W) {
      const ts_word* src = bin + x0 + (long long)(t - 1) * xs;
#pragma unroll
      for (int k = 0; k < K; ++k) v[k] = ok[k] ? vb_get(src + k) : 0ull;
    }
  };

  int Ph[K], Lh[K], Ld[K], mid[K], cn[K];
#pragma unroll
  for (int k = 0; k < K; ++k) Ph[k] = Lh[k] = Ld[k] = mid[k] = cn[k] = 0;
  ts_word bw[TS_AHEAD][K];  // the words of steps s, s + 1, ..: slot s % TS_AHEAD
#pragma unroll
  for (int j = 0; j < TS_AHEAD; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) bw[j][k] = 0ull;
    load_words(j, bw[j]);
  }
  if (live) {
    if (has_h)
      ts_load<K>(Jh.inbox ? Jh.inbox + (size_t)(y - a + 1) * D : nullptr, d0, ok, Ph);
    if (g == 0 && i == 0) {  // each outbox's row of the block before
      int v[K];
      if (has_h && Jh.out_new) {
        ts_load<K>(Jh.out_old ? Jh.out_old + (size_t)R * D : nullptr, d0, ok, v);
        ts_store<K>(Jh.out_new, d0, ok, v);
      }
      if (has_d && Jd.out_new) {
        const int from = down ? R : 0, to = down ? 0 : R;
        ts_load<K>(Jd.out_old ? Jd.out_old + (size_t)from * D : nullptr, d0, ok, v);
        ts_store<K>(Jd.out_new + (size_t)to * D, d0, ok, v);
      }
    }
    if constexpr (ASYNC) {
      for (int n = 0; n + 1 < RING; ++n) fetch(true, s_now(n, false));
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) cn[k] = ok[k] ? (int)__ldg(Crow + x0 + d0 + k) : 0;
    }
  }

  int rslot = 0;      // the ring slot of step s
  long long xo = x0;  // step s's column offset
  // step s (s % TS_AHEAD == j): false once the walk is done
  auto step = [&](int s, ts_word (&words)[K]) {
    if (pair && s == sa) {  // the walks meet: both blocks of the group
      if (ASYNC && live) cp_async_wait<0>();
      __syncthreads();
      if (threadIdx.x == 0) {
        const int me = blockIdx.x, mate = me + (wi == 0 ? ng : -ng);
        __threadfence();
        vb_put(scratch + nblocks + me, epoch, 0);
        while ((unsigned)(vb_get(scratch + nblocks + mate) >> 32) != epoch) {
        }
        __threadfence();
      }
      __syncthreads();
      if (keep_mid && live) {  // add the other walk's L at the middle column
        int32_t* p = Srow + (size_t)hb * D;
        int v[K];
        ts_load<K>(p, d0, ok, v);
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] += mid[k];
        ts_store<K>(p, d0, ok, v);
      }
      if (ASYNC && live) {  // S of the steps whose C is in the ring already
        for (int n = sa; n < sa + RING - 1; ++n) {
          if (n < W) {
            const long long qx = x0 + (long long)n * xs;
            char* dst = ring + (n & (RING - 1)) * slot + cbytes + 16 * lane;
            const char* sv = reinterpret_cast<const char*>(Srow + qx) + 16 * lane;
#pragma unroll
            for (int t = 0; t < NS; ++t)
              if (ps[t]) cp_async16(dst + 512 * t, sv + 512 * t);
          }
          cp_async_commit();
        }
      }
    }
    if (s >= W) return false;
    if (live) {
      int c[K], sv[K];
      if constexpr (ASYNC) {
        __syncwarp();  // every lane is done with the slot the next copy fills
        fetch(true, s_now(s + RING - 1, s >= sa));
        cp_async_wait<RING - 1>();
        __syncwarp();  // the step's pieces came through every lane
        const char* r = ring + rslot;
        vb_get_lane<CT, K>(reinterpret_cast<const CT*>(r) + d0, vec, ok, c);
        vb_get_lane<int32_t, K>(reinterpret_cast<const int32_t*>(r + cbytes) + d0,
                                vec, ok, sv);
        rslot = rslot + slot == ring_bytes ? 0 : rslot + slot;
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          c[k] = cn[k];
          sv[k] = ok[k] ? Srow[xo + d0 + k] : 0;
        }
        if (s + 1 < W) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            cn[k] = ok[k] ? (int)__ldg(Crow + xo + xs + d0 + k) : 0;
        }
      }
      int tot[K];
#pragma unroll
      for (int k = 0; k < K; ++k) tot[k] = sv[k];
      if (has_h) {
        ts_step<K>(whole, c, Ph, ok, d0, D, p1, p2, Lh);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          Ph[k] = Lh[k];
          tot[k] += Lh[k];
        }
      }
      if (has_d) {
        // the diagonal carry: L of row y - dy at column x - dx
        int Pd[K];
        if (s == 0) {
          ts_load<K>(Jd.inbox ? Jd.inbox + (size_t)(y - a + (down ? 0 : 1)) * D
                              : nullptr, d0, ok, Pd);
        } else if (first_row) {
          if (ASYNC && fetch_p) {
            vb_get_lane<int32_t, K>(reinterpret_cast<const int32_t*>(
                                        ring + ((s & (RING - 1)) * slot) + cbytes + 4 * D) + d0,
                                    vec, ok, Pd);
          } else {
            ts_load<K>(Jd.prev ? Jd.prev + (xo - xs) : nullptr, d0, ok, Pd);
          }
        } else if (entry) {
          // the loaded words, and the slow way where one is not this
          // launch's yet: poll it in device memory
          bool fresh = true;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            fresh &= !ok[k] || (unsigned)(words[k] >> 32) == epoch;
            Pd[k] = ok[k] ? (int)(unsigned)words[k] : 0;
          }
          if (!fresh) {
            const ts_word* gsrc = bin + (xo - xs);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              if (!ok[k]) continue;
              ts_word v = vb_get(gsrc + k);
              while ((unsigned)(v >> 32) != epoch) v = vb_get(gsrc + k);
              Pd[k] = (int)(unsigned)v;
            }
          }
        } else {
          vb_get_lane<int32_t, K>((s & 1) ? cr0 : cr1, vec, ok, Pd);
        }
        ts_step<K>(whole, c, Pd, ok, d0, D, p1, p2, Ld);
#pragma unroll
        for (int k = 0; k < K; ++k) tot[k] += Ld[k];
        vb_put_lane<int32_t, K>((s & 1) ? cw1 : cw0, vec, ok, Ld);
        if (leave) {
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (ok[k]) vb_put(bout + xo + k, epoch, Ld[k]);
        }
        if (last_row && Jd.prev_out) ts_store<K>(Jd.prev_out + xo, d0, ok, Ld);
      }
      if (keep_mid && s == hb) {
#pragma unroll
        for (int k = 0; k < K; ++k) mid[k] = tot[k] - sv[k];
      } else {
        vb_put_lane<int32_t, K>(Srow + xo + d0, vec_s, ok, tot);
      }
      if (s == W - 1) {  // the edge column toward the next tile
        if (has_h && Jh.out_new)
          ts_store<K>(Jh.out_new + (size_t)(y - a + 1) * D, d0, ok, Lh);
        if (has_d && Jd.out_new)
          ts_store<K>(Jd.out_new + (size_t)(y - a + (down ? 1 : 0)) * D, d0, ok, Ld);
      }
    }
    load_words(s + TS_AHEAD, words);
    xo += xs;
    if (has_d) __syncthreads();  // the group's carries of step s are out
    return true;
  };
  // the steps, TS_AHEAD at a time, so that each step's words stay in the
  // same registers from their load to their use
  for (int s0 = 0;; s0 += TS_AHEAD) {
    bool more = true;
#pragma unroll
    for (int j = 0; j < TS_AHEAD; ++j)
      if (more) more = step(s0 + j, bw[j]);
    if (!more) break;
  }
  if (ASYNC && live) cp_async_wait<0>();
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
__global__ void __launch_bounds__(32 * TS_G)
sgm_tile_kernel(const CT* __restrict__ C, int32_t* __restrict__ S, int W,
                int D, int p1, int p2, const TsPlan P, ts_word* scratch,
                unsigned epoch) {
  extern __shared__ __align__(16) char ts_smem[];
  int u = 0;
  while (u + 1 < P.nunits && (int)blockIdx.x >= P.unit[u + 1].first) ++u;
  const TsUnit& U = P.unit[u];
  const int ub = blockIdx.x - U.first;
  if (U.waits != 0u) {  // the earlier units on these rows finish first
    if (threadIdx.x == 0) {
      for (int v = 0; v < u; ++v) {
        if (!((U.waits >> v) & 1u)) continue;
        for (int b = P.unit[v].first; b < P.unit[v].first + P.unit[v].blocks; ++b)
          while ((unsigned)(vb_get(scratch + b) >> 32) != epoch) {
          }
      }
      __threadfence();
    }
    __syncthreads();
  }
  ts_rows<CT, K, ASYNC>(P, U, ub, C, S, W, D, p1, p2, scratch, gridDim.x,
                        epoch, ts_smem);
  __syncthreads();  // the block's adds into S are done
  if (threadIdx.x == 0) {
    __threadfence();
    vb_put(scratch + blockIdx.x, epoch, 0);
  }
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

// The blocks of each unit, TS_G warps a block: a block a group of rows of
// each walk; returns the total.
static int ts_layout(TsPlan& P) {
  int blocks = 0;
  for (int u = 0; u < P.nunits; ++u) {
    TsUnit& U = P.unit[u];
    U.ng = (U.R + TS_G - 1) / TS_G;
    U.blocks = U.nwalks * U.ng;
    U.first = blocks;
    blocks += U.blocks;
  }
  return blocks;
}

// C: (H, W, D) int16 (c_bytes 2) or int32; S: (H, W, D) int32, added to.
// jdesc: njobs x (dy, dx, a, R); jptrs: njobs x (inbox, out_old, out_new,
// prev, prev_out), each (R + 1, D) or (W, D) int32 or null (see above).
// No job has dx = 0. udesc: nunits x (a, R, nwalks, waits, then for each
// of two walks dx, vs, h, d); ubuf: nunits x 2 carry-slot offsets (words);
// the plan of ops/cuda/sgm_tile.py scan_plan. scratch: scratch_words 64-bit
// words, the first flag_words of them a done word and a meeting word a
// block, every word's tag below epoch. Requires 1 <= D <= 256,
// 1 <= njobs <= TS_MAX_JOBS, every block inside [0, H). One cooperative
// launch.
extern "C" int rtdm_sgm_tile_scan(const void* C, int c_bytes, void* S, int H,
                                  int W, int D, int p1, int p2,
                                  const int* jdesc, void* const* jptrs,
                                  int njobs, const int* udesc,
                                  const long long* ubuf, int nunits,
                                  void* scratch, long long scratch_words,
                                  long long flag_words, unsigned epoch,
                                  void* stream) {
  if (D < 1 || D > 256 || W < 1 || H < 1 || njobs < 1 ||
      njobs > TS_MAX_JOBS || nunits < 1 || nunits > TS_MAX_UNITS || epoch == 0)
    return (int)cudaErrorInvalidValue;
  TsPlan P;
  for (int i = 0; i < njobs; ++i) {
    TsJob& J = P.job[i];
    J.dy = jdesc[4 * i];
    J.dx = jdesc[4 * i + 1];
    J.a = jdesc[4 * i + 2];
    J.R = jdesc[4 * i + 3];
    if (J.dy < -1 || J.dy > 1 || (J.dx != -1 && J.dx != 1) || J.R < 1 ||
        J.a < 0 || J.a + J.R > H)
      return (int)cudaErrorInvalidValue;
    J.inbox = (const int32_t*)jptrs[5 * i];
    J.out_old = (const int32_t*)jptrs[5 * i + 1];
    J.out_new = (int32_t*)jptrs[5 * i + 2];
    J.prev = (const int32_t*)jptrs[5 * i + 3];
    J.prev_out = (int32_t*)jptrs[5 * i + 4];
  }
  P.nunits = nunits;
  for (int u = 0; u < nunits; ++u) {
    const int* q = udesc + 12 * u;
    TsUnit& U = P.unit[u];
    U.a = q[0];
    U.R = q[1];
    U.nwalks = q[2];
    U.waits = (unsigned)q[3];
    if (U.R < 1 || U.a < 0 || U.a + U.R > H || U.nwalks < 1 || U.nwalks > 2)
      return (int)cudaErrorInvalidValue;
    for (int k = 0; k < 2; ++k) {
      TsWalk& Wk = U.walk[k];
      Wk.dx = q[4 + 4 * k];
      Wk.vs = q[5 + 4 * k];
      Wk.h = q[6 + 4 * k];
      Wk.d = q[7 + 4 * k];
      Wk.buf = ubuf[2 * u + k];
      if (k < U.nwalks &&
          (Wk.h >= njobs || Wk.d >= njobs || (Wk.h < 0 && Wk.d < 0)))
        return (int)cudaErrorInvalidValue;
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)sgm_by_ctype(c_bytes, [&](auto tag) {
    using CT = decltype(tag);
    return vb_by_k(D, [&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const int blocks = ts_layout(P);
      if (2 * blocks > flag_words) return cudaErrorInvalidValue;
      for (int u = 0; u < nunits; ++u) {
        const TsUnit& U = P.unit[u];
        for (int k = 0; k < U.nwalks; ++k)
          if (U.walk[k].d >= 0 &&
              (U.walk[k].buf < flag_words ||
               U.walk[k].buf + (long long)U.ng * W * D > scratch_words))
            return cudaErrorInvalidValue;
      }
      const bool async = ts_async<CT>(C, S, D) && (uintptr_t)scratch % 16 == 0;
      const void* kernel = async ? (const void*)sgm_tile_kernel<CT, K, true>
                                 : (const void*)sgm_tile_kernel<CT, K, false>;
      const size_t smem = ts_smem_bytes(D, TsRing<K>::depth, async, sizeof(CT));
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      const CT* Cv = (const CT*)C;
      int32_t* Sv = (int32_t*)S;
      ts_word* scr = (ts_word*)scratch;
      void* args[] = {(void*)&Cv, (void*)&Sv, (void*)&W,   (void*)&D,
                      (void*)&p1, (void*)&p2, (void*)&P,   (void*)&scr,
                      (void*)&epoch};
      return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(32 * TS_G),
                                         args, smem, st);
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
