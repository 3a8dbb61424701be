// StereoBM block-matching cost with a winner-take-all, windows slid both ways.
//
// Replaces rt_depth_map_tpu/ops/pallas/bm_kernel.py bm_cost_wta. For every
// pixel and every disparity index d in [0, D), disparity dd = minD + d, the
// cost is the bs x bs sum of |L(y', x') - R(y', x' - dd)| over the window
// centred on (y, x), with the window sums zero-padded at the image border
// and |L - R| taken as 0 where x' - dd leaves [0, W) (the XLA formulation of
// rt_depth_map_tpu/ops/bm.py _cost_volume, on every pixel). At minD < 0 the
// right border x' - dd >= W falls inside the valid region: the term is 0
// there, not |L - 0|, so a shifted right plane under an unchanged kernel
// would not be exact; the vertical slide masks those d (bm_cut_low). minD
// reaches the kernel only in the instantiations for minD != 0 (OFS); at
// minD 0 it is the constant 0, so that code is the code without the offset.
// The (D, H, W) volume is never written.
//
// Outputs, each (H, W) int32:
//   best_d       argmin over d, ties to the LARGEST d (packed key
//                cost << B | (D - 1 - d), B = 8 bits as bm_kernel.py:16-18
//                for D <= 256, 9 for 256 < D <= 384)
//   best_cost    cost at best_d
//   c_m1, c_p1   cost at best_d - 1 / best_d + 1 (0 where that d is outside
//                [0, D))
//   min_outside  min cost over d with |d - best_d| > 1 (2^28 if none)
//
// Design (a block owns TX = BM_PW * warps output columns of a stripe of TY
// rows; the plan is ops/cuda/bm_kernel.py bm_plan):
// - Shared memory holds V[c][d], the vertical window sums of the block's
//   CW = TX + bs - 1 halo columns (uint16: at most bs * 255), D contiguous
//   per column and padded to DS = 32 * K entries, and a ring of bs + 1 rows
//   of L and R. Each ring row is whole 16-byte pieces aligned as in device
//   memory, filled one row ahead with cp.async; rows outside the image are
//   zeros, so they add nothing.
// - Vertical slide: moving down one row, a thread updates one column's run
//   of 16 consecutive d (the same run on every row), V += |L_new - R_new|
//   - |L_old - R_old|, with byte-SIMD absolute differences (4 d a word,
//   R's bytes reversed into d order by __byte_perm) widened into 16-bit
//   pairs and added with one 32-bit add a pair; two columns' loads are
//   issued before their stores.
// - Horizontal slide and winner: a warp owns BM_PW = 32 output pixels of
//   the row, one a lane, as two runs of 16 slid side by side (two
//   independent chains); its lanes hold K = D / 32 (rounded up to 1, 2, 4
//   or 8; 12 above D = 256, whose 24 runs of 16 d do not divide a block's
//   threads, so the threads past whole items idle in the vertical slide)
//   consecutive d and keep their K window costs in registers (two
//   16-bit costs a word where bs^2 * 255 < 2^16), cost(x + 1) = cost(x) +
//   V[x + 1 + w2] - V[x - w2], one 32-bit add a word. The winner is one
//   __reduce_min_sync of the packed keys, min_outside a second one over
//   the keys with |d - best_d| > 1 (exact), c_m1 and c_p1 two shuffles;
//   lane p keeps pixel p's keys and the warp stores 128 coalesced bytes
//   per output.
//
// What bounds it on the H100: integer instructions. Its floor is about 3.25
// 32-bit lane instructions a pixel and d at the card's SIMD widths (a byte
// difference 4 a lane, the 16-bit window updates 2 a lane, the min 1);
// device memory is read once per stripe (plus halo) and the outputs
// written once. Copies with parts taken out (tools/time_torch_bm.py
// --ablate) put the winner's second reduction, selects and shuffles at
// ~30% of its time and the vertical slide at ~30%, both integer
// instructions; neither V's loads and stores, the row copies nor the block
// barriers move it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"

#define BM_FULL 0xffffffffu
#define BM_BIGKEY 0x7fffffff
#define BM_NONE (1 << 28)
#define BM_BATCH 2  // vertical items a thread loads before it stores
#define BM_PW 32    // output pixels a warp (bm_plan PIXELS_PER_WARP)
#define BM_RUNS 2   // runs of pixels a warp slides side by side
#define BM_MAX_WARPS 8
#define BM_RPAD 32  // bytes before the R ring: a row's reads start up to 18 early

// Bits of the packed key's d field at K d a lane: D <= 256 below K = 12.
template <int K>
__host__ __device__ constexpr int bm_key_bits() {
  return K > 8 ? 9 : 8;
}

// Sizes of the shared-memory layout (bytes). ops/cuda/bm_kernel.py bm_smem
// reckons the same total for its plan; rtdm_bm_cost_wta refuses a plan
// whose size differs.
struct BmLayout {
  int CW, DS, LS, RS, ring;
  size_t v_bytes, total;
};

static inline __host__ __device__ BmLayout bm_layout(int TX, int D, int bs,
                                                     int K) {
  BmLayout s;
  s.CW = TX + bs - 1;
  s.DS = 32 * K;
  s.LS = 16 * ((s.CW + 15 + 15) / 16);
  s.RS = 16 * ((s.CW + D - 1 + 15 + 15) / 16) + 16;
  s.ring = bs + 1;
  s.v_bytes = (size_t)s.CW * s.DS * sizeof(uint16_t);
  s.total = s.v_bytes + (size_t)s.ring * (s.LS + s.RS) + BM_RPAD;
  return s;
}

// A 16-byte piece at g that straddles an end of [base, base + HW), byte
// by byte (zeros outside); rare, so kept out of line.
__device__ __noinline__ void bm_stage_edge(uint8_t* d, long long g,
                                           long long base, long long HW) {
  for (int b = 0; b < 16; ++b) {
    const long long gb = g + b;
    d[b] = (gb >= base && gb < base + HW) ? *(const uint8_t*)(uintptr_t)gb
                                          : (uint8_t)0;
  }
}

// Copy `n` bytes of image row r starting at column gx (any column, any
// row alignment) into dst, which holds whole 16-byte pieces aligned as in
// device memory; returns the offset in dst of column gx. Pieces inside
// [img, img + HW) go by cp.async, pieces that straddle its ends byte by
// byte; their values outside the row are never used.
__device__ __forceinline__ int bm_stage_row(uint8_t* dst, const uint8_t* img,
                                            long long HW, long long e0, int n,
                                            int t, int nt, bool issue) {
  const long long base = (long long)(uintptr_t)img;
  const long long ga = base + e0;
  const int a = (int)(ga & 15);
  if (issue) {
    const long long a0 = ga - a;
    const int pieces = (a + n + 15) / 16;
    for (int k = t; k < pieces; k += nt) {
      const long long g = a0 + 16LL * k;
      if (g >= base && g + 16 <= base + HW)
        cp_async16(dst + 16 * k, (const void*)(uintptr_t)g);
      else
        bm_stage_edge(dst + 16 * k, g, base, HW);
    }
  }
  return a;
}

// What one (column, run of 16 d) item reads of a ring row: the column's L
// byte and the five words that hold R(x - d16 - 15) .. R(x - d16), the
// first of them at offset q of the row.
struct BmRow {
  uint32_t l, w[5], sel;
};

__device__ __forceinline__ BmRow bm_load(const uint8_t* Lrow,
                                         const uint8_t* Rrow, int lc,
                                         int q) {
  BmRow g;
  g.l = Lrow[lc];
  const uint32_t* w = (const uint32_t*)(Rrow + (q & ~3));
#pragma unroll
  for (int i = 0; i < 5; ++i) g.w[i] = w[i];
  g.sel = 0x0123u + (uint32_t)(q & 3) * 0x1111u;
  return g;
}

// Byte masks of the d kept in a run of 16: group j (d16 + 4j .. + 3) keeps
// its bytes below n_keep (0 <= n_keep <= 16).
__device__ __forceinline__ void bm_keep_masks(int n_keep, uint32_t (&m)[4]) {
  const int s = 8 * n_keep;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    m[j] = __funnelshift_lc(0xffffffffu, 0u, (unsigned)max(s - 32 * j, 0));
}

// Clear the bytes below n_cut (n_cut > 0) from the masks: the d whose right
// column lies past the image's right edge (only at minD < 0).
__device__ __forceinline__ void bm_cut_low(int n_cut, uint32_t (&m)[4]) {
  uint32_t c[4];
  bm_keep_masks(min(n_cut, 16), c);
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] &= ~c[j];
}

// |L - R(x - d)| for d = d16 .. d16 + 15 as eight 16-bit pairs, the bytes
// outside the masks zeroed.
__device__ __forceinline__ void bm_absdiff16(const BmRow& g,
                                             const uint32_t (&m)[4],
                                             uint32_t (&p)[8]) {
  const uint32_t l4 = g.l * 0x01010101u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // d16 + 4j .. d16 + 4j + 3: bytes q + 15 - 4j .. q + 12 - 4j
    const uint32_t r = __byte_perm(g.w[3 - j], g.w[4 - j], g.sel);
    const uint32_t a = __vabsdiffu4(l4, r) & m[j];
    p[2 * j] = __byte_perm(a, 0, 0x4140);
    p[2 * j + 1] = __byte_perm(a, 0, 0x4342);
  }
}

// One row of the vertical slide for a thread's items: its run of 16 d at
// columns col0, col0 + cstep, ... of V (Vt = V + d16), BM_BATCH columns at
// a time, branch-free: every load of the batch before its stores, so that
// the loads' latencies overlap; a column past the halo re-reads the last
// one and stores nothing. rq_n / rq_o: the offset in the new / old R ring
// row of R(x - minD - d16 - 15) for halo column 0. Only d with
// 0 <= x' - minD - d < W, d < D and columns inside the image count; rows
// outside the image, and the rows before the stripe, are zeros in the ring
// and add nothing. OFS: minD != 0; at minD < 0 a right column can pass the
// image's right edge and a column left of the image can meet one inside it.
// Without OFS, minD is 0.
template <bool OFS>
__device__ __forceinline__ void bm_vertical(
    uint16_t* Vt, const BmLayout& s, int col0, int cstep, const uint8_t* Ln,
    const uint8_t* Rn, int rq_n, const uint8_t* Lo, const uint8_t* Ro,
    int rq_o, int gx0, int W, int D, int minD_, int d16) {
  const int minD = OFS ? minD_ : 0;
  typedef LaneVec<uint32_t, 4> V8;
  for (int c = col0; c < s.CW; c += BM_BATCH * cstep) {
    int cc[BM_BATCH];
    uint32_t m[BM_BATCH][4];
    V8 v[BM_BATCH][2];
    BmRow rn[BM_BATCH], ro[BM_BATCH];
#pragma unroll
    for (int u = 0; u < BM_BATCH; ++u) {
      const int cu = c + u * cstep, gx = gx0 + cu;
      const bool col_in = cu < s.CW && gx < W && (!OFS || gx >= 0);
      bm_keep_masks(col_in ? min(gx - minD, D - 1) - d16 + 1 : 0, m[u]);
      if (OFS) {
        // d below gx - minD - W + 1 meet a right column past the image
        const int n_cut = gx - minD - W + 1 - d16;
        if (col_in && n_cut > 0) bm_cut_low(n_cut, m[u]);
      }
      cc[u] = min(cu, s.CW - 1);
      const V8* vp = (const V8*)(Vt + (size_t)cc[u] * s.DS);
      v[u][0] = vp[0];
      v[u][1] = vp[1];
      rn[u] = bm_load(Ln, Rn, cc[u], rq_n + cc[u]);
      ro[u] = bm_load(Lo, Ro, cc[u], rq_o + cc[u]);
    }
#pragma unroll
    for (int u = 0; u < BM_BATCH; ++u) {
      // one 32-bit add a pair: each 16-bit result is a window sum in
      // [0, bs * 255], so no carry or borrow crosses the halves
      uint32_t pn[8], po[8];
      bm_absdiff16(rn[u], m[u], pn);
      bm_absdiff16(ro[u], m[u], po);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        v[u][k / 4].v[k % 4] = v[u][k / 4].v[k % 4] + pn[k] - po[k];
      if (c + u * cstep < s.CW) {
        V8* vp = (V8*)(Vt + (size_t)cc[u] * s.DS);
        vp[0] = v[u][0];
        vp[1] = v[u][1];
      }
    }
  }
}

// A lane's window costs at its K disparities: K int32, or with PACK (every
// cost below 2^16: bs^2 * 255 < 65536, and K >= 2) two 16-bit costs a word.
// A packed word's halves are updated by one 32-bit add: each half's result
// lies in [0, 65535], so no carry or borrow crosses between them.
template <int K, bool PACK>
struct BmCosts {
  static constexpr int N = PACK ? K / 2 : K;
  typedef LaneVec<uint32_t, N> Packed;
  typedef LaneVec<uint16_t, K> Wide;
  uint32_t c[N];

  // cost += V[col_in] - V[col_out] at K = 12: a lane's 24 bytes as three
  // 8-byte pieces (a vector's alignment must be a power of two)
  __device__ __forceinline__ void add12(const uint16_t* col_in,
                                        const uint16_t* col_out, int lane) {
    typedef typename std::conditional<PACK, uint32_t, uint16_t>::type E;
    constexpr int PE = 8 / sizeof(E);  // elements a piece
    typedef LaneVec<E, PE> Piece;
    const Piece* a = (const Piece*)col_in + 3 * lane;
    const Piece* b = (const Piece*)col_out + 3 * lane;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const Piece pa = a[i];
      const Piece pb = col_out ? b[i] : Piece{};
#pragma unroll
      for (int q = 0; q < PE; ++q)
        c[i * PE + q] = c[i * PE + q] + pa.v[q] - pb.v[q];
    }
  }

  // cost = the sum of V's columns col .. col + bs - 1
  __device__ __forceinline__ void prime(const uint16_t* col, int DS, int bs,
                                        int lane) {
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = 0;
    for (int i = 0; i < bs; ++i) add(col + i * DS, nullptr, lane);
  }

  // cost += V[col_in] - V[col_out] (col_out may be null)
  __device__ __forceinline__ void add(const uint16_t* col_in,
                                      const uint16_t* col_out, int lane) {
    if constexpr (K == 12) {
      add12(col_in, col_out, lane);
    } else if constexpr (PACK) {
      const Packed a = ((const Packed*)col_in)[lane];
      const Packed b = col_out ? ((const Packed*)col_out)[lane] : Packed{};
#pragma unroll
      for (int j = 0; j < N; ++j) c[j] = c[j] + a.v[j] - b.v[j];
    } else {
      const Wide a = ((const Wide*)col_in)[lane];
      const Wide b = col_out ? ((const Wide*)col_out)[lane] : Wide{};
#pragma unroll
      for (int j = 0; j < N; ++j) c[j] = c[j] + a.v[j] - b.v[j];
    }
  }

  // keys cost << B | koff (koff < 2^B, or BIG where d >= D and cost = 0)
  __device__ __forceinline__ void keys(const int (&koff)[K],
                                       int (&key)[K]) const {
    constexpr int B = bm_key_bits<K>();
    constexpr uint32_t M = 0xffffu << B;  // a 16-bit cost in the key
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (PACK) {
        key[2 * j] = (int)((c[j] << B) & M) | koff[2 * j];
        key[2 * j + 1] = (int)((c[j] >> (16 - B)) & M) | koff[2 * j + 1];
      } else {
        key[j] = (int)(c[j] << B) | koff[j];
      }
    }
  }
};

// Lane p of the warp keeps pixel p's winner and keys: best, its key, the
// keys at best -+ 1 and the least key outside them (decoded at the store).
struct BmPix {
  int bd, k1, km, kp, ko;
};

// The winner of one pixel from the lanes' keys (d0 = the lane's first d,
// e[k] = d0 + k + 1); lane p keeps its outputs.
template <int K>
__device__ __forceinline__ void bm_winner(const int (&key)[K],
                                          const int (&e)[K], int D, int lane,
                                          int p, BmPix& keep) {
  int kmin = key[0];
#pragma unroll
  for (int k = 1; k < K; ++k) kmin = min(kmin, key[k]);
  const int k1 = __reduce_min_sync(BM_FULL, kmin);
  const int best = D - 1 - (k1 & ((1 << bm_key_bits<K>()) - 1));
  int kout = BM_BIGKEY;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((unsigned)(e[k] - best) > 2u) kout = min(kout, key[k]);
  const int ko = __reduce_min_sync(BM_FULL, kout);
  // keys at best -+ 1 (e = best, best + 2) from the lanes that hold them;
  // a per-lane select (a warp-uniform index would go through local memory)
  int sm = 0, sp = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sm = e[k] == best ? key[k] : sm;
    sp = e[k] == best + 2 ? key[k] : sp;
  }
  sm = __shfl_sync(BM_FULL, sm, ((unsigned)(best - 1) / K) & 31);
  sp = __shfl_sync(BM_FULL, sp, ((unsigned)(best + 1) / K) & 31);
  const bool mine = lane == p;  // selects, not a branch
  keep.bd = mine ? best : keep.bd;
  keep.k1 = mine ? k1 : keep.k1;
  keep.km = mine ? sm : keep.km;
  keep.kp = mine ? sp : keep.kp;
  keep.ko = mine ? ko : keep.ko;
}

template <int K, bool PACK, bool OFS>
__global__ void __launch_bounds__(32 * BM_MAX_WARPS)
bm_cost_wta_kernel(const uint8_t* __restrict__ lp,
                   const uint8_t* __restrict__ rp, int H, int W, int D,
                   int minD_, int bs, int TY, int32_t* __restrict__ best_d_out,
                   int32_t* __restrict__ best_c_out,
                   int32_t* __restrict__ cm1_out,
                   int32_t* __restrict__ cp1_out,
                   int32_t* __restrict__ mout_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int nt = blockDim.x;
  const int TX = (nt / 32) * BM_PW;
  const BmLayout s = bm_layout(TX, D, bs, K);
  uint16_t* V = (uint16_t*)smem;                        // [CW][DS]
  uint8_t* Ls = smem + s.v_bytes;                       // [ring][LS]
  uint8_t* Rs = Ls + (size_t)s.ring * s.LS + BM_RPAD;  // [ring][RS]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int w2 = bs / 2;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int y_end = min(y0 + TY, H);
  const int gx0 = x0 - w2;           // image column of halo column 0
  const int r0 = y0 - w2;            // first staged row
  const int NR = y_end - y0 + bs - 1;
  const long long HW = (long long)H * W;
  const int minD = OFS ? minD_ : 0;

  // V and the ring start as zeros (s.total is a multiple of 16)
  for (int i = t; i < (int)(s.total / 16); i += nt)
    ((uint4*)smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // the ring slot of row r holds L from column gx0 and R from
  // gx0 - minD - (D - 1);
  // aL / aR: offset of those columns in the slot (row alignment varies)
  // a row outside the image is staged as zeros
  auto stage = [&](int r, bool issue, int& aL, int& aR) {
    const int slot = (r - r0) % s.ring;
    const bool in = r >= 0 && r < H;
    uint8_t* Lslot = Ls + (size_t)slot * s.LS;
    uint8_t* Rslot = Rs + (size_t)slot * s.RS;
    aL = bm_stage_row(Lslot, lp, HW, (long long)r * W + gx0, s.CW, t, nt,
                      issue && in);
    aR = bm_stage_row(Rslot, rp, HW, (long long)r * W + gx0 - minD - (D - 1),
                      s.CW + D - 1, t, nt, issue && in);
    if (issue && !in) {
      for (int i = t; i < s.LS / 16; i += nt)
        ((uint4*)Lslot)[i] = make_uint4(0, 0, 0, 0);
      for (int i = t; i < s.RS / 16; i += nt)
        ((uint4*)Rslot)[i] = make_uint4(0, 0, 0, 0);
    }
  };
  int aLn, aRn;
  stage(r0, true, aLn, aRn);
  cp_async_commit();

  // vertical items: this thread's run of 16 d (the same on every row) at
  // columns col0, col0 + cstep, ...; runs beyond D stay idle, and so do
  // the threads past whole items where RP does not divide nt (K = 12)
  constexpr int RP = 2 * K;  // runs of 16 d in DS
  const int col0 = t / RP, cstep = nt / RP;
  const int d16 =
      (RP & (RP - 1)) == 0 || t < cstep * RP ? (t % RP) * 16 : s.DS;
  uint16_t* Vt = V + d16;

  const int d0 = lane * K;
  const int i_first = warp * BM_PW;  // the warp's first output column
  const bool warp_out = x0 + i_first < W;
  const int n_pix = min(BM_PW, W - x0 - i_first);
  // the keys' low bytes D - 1 - d (BIG beyond D, where V stays 0), and
  // e[k] = d + 1 for the test |d - best| > 1
  int koff[K], e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    koff[k] = d0 + k < D ? D - 1 - d0 - k : BM_BIGKEY;
    e[k] = d0 + k + 1;
  }

  for (int si = 0; si < NR; ++si) {
    const int r = r0 + si;
    cp_async_wait<0>();
    __syncthreads();

    // V += ad(r) - ad(r - bs); rows outside the image (and before the
    // stripe) are zeros in the ring
    const bool has_new = r >= 0 && r < H;
    const bool has_old = si >= bs && r - bs >= 0 && r - bs < H;
    if ((has_new || has_old) && d16 < D) {
      int aLo, aRo;
      stage(r - bs, false, aLo, aRo);
      const int sn = si % s.ring, so = (si + s.ring - bs) % s.ring;
      const uint8_t* Ln = Ls + (size_t)sn * s.LS + aLn;
      const uint8_t* Rn = Rs + (size_t)sn * s.RS;
      const uint8_t* Lo = Ls + (size_t)so * s.LS + aLo;
      const uint8_t* Ro = Rs + (size_t)so * s.RS;
      const int rq_n = aRn + D - 16 - d16, rq_o = aRo + D - 16 - d16;
      bm_vertical<OFS>(Vt, s, col0, cstep, Ln, Rn, rq_n, Lo, Ro, rq_o, gx0, W,
                       D, minD, d16);
    }
    __syncthreads();

    // row r + 1 into the slot of row r - bs, in flight during the winners
    if (si + 1 < NR) stage(r + 1, true, aLn, aRn);
    cp_async_commit();

    const int y = y0 + si - (bs - 1);
    if (y < y0 || !warp_out) continue;
    // the warp's pixels: pixel i's window is V's columns i .. i + bs - 1
    const uint16_t* Vw = V + (size_t)i_first * s.DS;
    BmPix keep{0, 0, 0, 0, 0};
    // BM_RUNS runs of PR pixels side by side (independent chains); pixels
    // past the image's right edge are computed from V's zero columns and
    // not stored
    constexpr int PR = BM_PW / BM_RUNS;
    BmCosts<K, PACK> cr[BM_RUNS];
    int key[BM_RUNS][K];
#pragma unroll
    for (int j = 0; j < BM_RUNS; ++j) cr[j].prime(Vw + j * PR * s.DS, s.DS, bs, lane);
    for (int p = 0;;) {
#pragma unroll
      for (int j = 0; j < BM_RUNS; ++j) {
        cr[j].keys(koff, key[j]);
        bm_winner<K>(key[j], e, D, lane, j * PR + p, keep);
      }
      if (++p == PR) break;
#pragma unroll
      for (int j = 0; j < BM_RUNS; ++j)
        cr[j].add(Vw + (j * PR + p + bs - 1) * s.DS, Vw + (j * PR + p - 1) * s.DS,
                  lane);
    }
    if (lane < n_pix) {
      constexpr int B = bm_key_bits<K>();
      const size_t o = (size_t)y * W + x0 + i_first + lane;
      best_d_out[o] = keep.bd;
      best_c_out[o] = keep.k1 >> B;
      cm1_out[o] = keep.bd > 0 ? keep.km >> B : 0;
      cp1_out[o] = keep.bd < D - 1 ? keep.kp >> B : 0;
      mout_out[o] = keep.ko == BM_BIGKEY ? BM_NONE : keep.ko >> B;
    }
  }
}

template <int K, bool PACK, bool OFS>
static int bm_launch(const void* lp, const void* rp, int H, int W, int D,
                     int minD, int bs, int warps, int TY, int plan_smem,
                     void* best_d, void* best_c, void* c_m1, void* c_p1,
                     void* min_out, void* stream) {
  const int TX = BM_PW * warps;
  const size_t smem = bm_layout(TX, D, bs, K).total;
  if (smem != (size_t)plan_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bm_cost_wta_kernel<K, PACK, OFS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY);
  bm_cost_wta_kernel<K, PACK, OFS><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)lp, (const uint8_t*)rp, H, W, D, minD, bs, TY,
      (int32_t*)best_d, (int32_t*)best_c, (int32_t*)c_m1, (int32_t*)c_p1,
      (int32_t*)min_out);
  return (int)cudaGetLastError();
}

// The instantiation for k = ceil(D / 32), packed costs and minD != 0.
template <bool OFS>
static int bm_dispatch(int k, bool pack, const void* lp, const void* rp, int H,
                       int W, int D, int minD, int bs, int warps, int TY,
                       int smem, void* best_d, void* best_c, void* c_m1,
                       void* c_p1, void* min_out, void* stream) {
#define BM_ARGS lp, rp, H, W, D, minD, bs, warps, TY, smem, best_d, best_c, \
                c_m1, c_p1, min_out, stream
  if (k <= 1) return bm_launch<1, false, OFS>(BM_ARGS);
  if (k <= 2)
    return pack ? bm_launch<2, true, OFS>(BM_ARGS) : bm_launch<2, false, OFS>(BM_ARGS);
  if (k <= 4)
    return pack ? bm_launch<4, true, OFS>(BM_ARGS) : bm_launch<4, false, OFS>(BM_ARGS);
  if (k <= 8)
    return pack ? bm_launch<8, true, OFS>(BM_ARGS) : bm_launch<8, false, OFS>(BM_ARGS);
  return pack ? bm_launch<12, true, OFS>(BM_ARGS) : bm_launch<12, false, OFS>(BM_ARGS);
#undef BM_ARGS
}

// lp, rp: (H, W) uint8 prefiltered planes; outputs (H, W) int32 each, the
// disparity indices of min_disparity minD (any int).
// Requires 1 <= D <= 384, odd bs, bs^2 * 255 * 2^B < 2^31 (B = 8 bits for
// D <= 256, else 9: bs <= 127) and a plan from
// bm_plan: 1 <= warps <= BM_MAX_WARPS (BM_PW output columns each), TY >= 1
// rows a block, and smem the plan's shared-memory bytes a block, which must
// equal bm_layout's total.
extern "C" int rtdm_bm_cost_wta(const void* lp, const void* rp, int H, int W,
                                int D, int bs, int minD, void* best_d,
                                void* best_c, void* c_m1, void* c_p1,
                                void* min_out, int warps, int TY, int smem,
                                void* stream) {
  const long long key_max = (long long)bs * bs * 255 << (D > 256 ? 9 : 8);
  if (D < 1 || D > 384 || bs % 2 == 0 || key_max >= (1LL << 31) ||
      warps < 1 || warps > BM_MAX_WARPS || TY < 1)
    return (int)cudaErrorInvalidValue;
  const int k = (D + 31) / 32;
  const bool pack = bs * bs * 255 < 65536;
#define BM_ARGS lp, rp, H, W, D, minD, bs, warps, TY, smem, best_d, best_c, \
                c_m1, c_p1, min_out, stream
  if (minD != 0) return bm_dispatch<true>(k, pack, BM_ARGS);
  return bm_dispatch<false>(k, pack, BM_ARGS);
#undef BM_ARGS
}

extern "C" const char* rtdm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
