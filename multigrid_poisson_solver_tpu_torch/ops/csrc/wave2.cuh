// The row-streaming wavefront pass of the 2-D damped-Jacobi smoother
// (kernel 1's Jacobi modes, jacobi.cu): k <= 8 sweeps in one pass over
// device memory, with the cpu / clean / gpu error of the last iterate or of
// every iterate (the per-sweep mode), whole grid or one shard's block; and,
// with a stage of their own, kernel 1's rb-GS mode and the legs (below) and
// the trigger kernels' per-sweep passes (WaveRing: the ring trigger kernel
// 17, rdma_trigger.cu, and the whole grid as a ring of one shard,
// trigger_stream.cu).
//
// Work unit: a warp owns one column of the TILE_H x TILE_W error tiles (tile
// column tx: TILE_W owned columns) and a chunk of whole tile rows, and
// stages WV_COLS = TILE_W + 2·WV_PAD columns. Warps are independent: no
// block barrier. Three layouts of a row:
//  * loads: cp.async into per-warp rings in shared memory, WaveShape::D rows
//    ahead. At k <= 2 sweeps, where the pass moves bytes more than it
//    computes, in the 16-byte chunks that hold the row's staged columns (a
//    row of 8193 floats is not 16-byte aligned: a ring row keeps the row at
//    its address's offset within a chunk, and reads add it), lane x copying
//    chunks x and x + 32; else 4 bytes a copy, lane x copying staged
//    columns x + 32c (fewer registers and no offset to add, which the
//    many-level passes need more). Rows outside the grid or the input
//    window read 0; columns outside read 0, or with chunks whatever the
//    window holds before its first column (the previous row's last
//    floats), which reaches no owned cell: an interior cell reads only
//    cells of the grid, and the window covers the halo wherever the block
//    has a neighbour. u and f start 16-byte aligned (the entry points
//    refuse others), so the chunk that holds the first window row's first
//    column starts there and no copy reads outside the window (a chunk
//    past its last column copies only the floats up to it). 4-byte copies
//    for that one chunk instead raised the k <= 2 instances' registers by
//    up to half and cost them 12-40% (A/B on the H100);
//  * sweeps: lane x holds the five adjacent staged columns 5x + c, so a
//    point's side neighbours are the lane's own but for one column from
//    each adjacent lane (one shuffle each way a row);
//  * stores and error terms: a row goes through a per-warp row in shared
//    memory to the tile layout, lane x holding tile columns x + 32q, so
//    stores are coalesced and every error term reaches the thread that
//    legs.cuh's error_partial gives it.
//
// Wavefront ("2.5-D" blocking): at row step r the warp takes row r of u
// and f from the rings, and for s = 1..k in order computes level s (the
// iterate after s sweeps) at row r − s from level s − 1's rows r − s − 1,
// r − s (kept in registers from earlier steps) and r − s + 1 (just
// computed). Level s is exact on staged columns [s, WV_COLS − s), and a
// chunk starts H = k (+1 for a residual error) rows above its first owned
// row and ends H rows past its last, so every owned cell of level k (and
// its ring, for the residual) is exact. u and f are read once and the output
// written once a pass, times WV_COLS / TILE_W for the halo columns and 1 +
// 2H / chunk_rows for the halo rows. from_zero: level 0 is the closed form
// zero_coef·f on the interior (0 elsewhere) and u is not read.
//
// Arithmetic: jacobi_point, residual_point and nb_sum's order (common.cuh);
// frozen cells copy their value. So every iterate is bit for bit the plain
// twin's and the tile pipeline's.
//
// Error partials: bit for bit error_partial + block_sum (common.cuh) of the
// tile pipeline, which the trigger kernels keep: there,
// thread (x, y) of a block adds, from +0 and in this order, the cells of
// tile rows y, y + 8, y + 16, y + 24, in each row columns x, x + 32, x + 64,
// x + 96; then a butterfly (xor 16..1) over each warp, then the same over
// the eight warp sums, of which lanes 8..31 hold +0. Here lane x is thread
// x of every warp y: it keeps one accumulator per tile row mod 8 (in shared
// memory) and adds its four tile columns of a row in order. After a tile's
// last row the warp runs the eight butterflies, which pair the same lanes
// as before, and forms the final butterfly's sum, ((w0 + w4) + (w2 + w6)) +
// ((w1 + w5) + (w3 + w7)), its +0 terms dropped (an exact identity on sums
// from +0). The partial of tile t = ty·tiles_x + tx of level s goes to
// partials[(s − 1)·stride + t] (the fixed mode: partials[t]), for
// sum_partials_kernel.
//
// Kernel 1's rb-GS mode (rbgs.cu) and the multigrid legs (kernels 3 and 4,
// descend.cu and ascend.cu) are the same pass with a stage of their own,
// compiled in only for their instances (LEG; the Jacobi instances compile
// to the pass above):
//  * rb-GS (WV_RBGS): K = 2·steps half-levels, level s the update of the
//    colour (s − 1) & 1 (even first: (gi + gj) & 1 == 0, by global index, so
//    a shard of either origin parity) of level s − 1: ¼·(nb − h²f) on the
//    interior cells of that colour (stencils.redblack_gs_sweep's order),
//    every other cell copied. A cell of one colour reads only cells of the
//    other, so the half-level reads level s − 1's rows r − s − 1 .. r − s + 1
//    as a Jacobi level does. The colour is a per-lane bit mask flipped by the
//    row's parity, no branch. With an error (cpu / clean), level K + 1 forms
//    Δ = ¼·((nb − 4u) − h²f) of level K, the step an ω = 1 Jacobi sweep would
//    take (the TPU kernel's (h²/4)·r), added as |Δ| in the same order as a
//    residual. from_zero: level 0 is 0 (GS has no closed form) and u is not
//    read;
//  * descend (WV_DESCEND): after level K the pass forms r of level K one row
//    behind (the s = K + 1 iteration, which the cpu / clean error shares)
//    and d = −r on the interior, 0 elsewhere, keeping d's last two rows in
//    registers; on each row 2I + 1 (full weighting) the row combination
//    (¼·d[2I − 1] + ½·d[2I]) + ¼·d[2I + 1] on the staged columns, or on row
//    2I (sampling) d[2I] as is, goes through the per-warp row to a layout
//    where lane x forms coarse columns x and x + 32 of the strip's 64 (the
//    column combination in the same order, the twin's), stored coalesced
//    into fc, 0 on coarse boundary points. H = K + 1 (+ 1 row a side for
//    full weighting, a runtime flag: descend_halo's rows); a chunk starts
//    at an even global row, so coarse row I belongs to the chunk that owns
//    fine row 2I, and the strip's 64 coarse columns are its own;
//  * ascend (WV_ASCEND): level 0 at row r is u + prolong(c) on the interior
//    (frozen cells keep u): columns first, then rows, as ascend_tile and the
//    twin compute it. Coarse row I feeds fine rows 2I − 1 .. 2I + 1: it is
//    copied (4-byte cp.async, zero outside c's window, which need not be
//    16-byte aligned) into a per-warp ring of WV_CRING rows with fine row
//    2I − 1, and its column interpolation at the lane's five columns is
//    formed once, kept in registers for the next fine row.
//
// Storage type T (the last template argument; float but for the bf16 modes
// of kernels 1, 3 and 4, jacobi_bf16.cu, descend_bf16.cu, ascend_bf16.cu):
// the rings hold rows as stored, every other buffer and register is float,
// and a value converts where it leaves a ring and where it is stored. A bf16
// pass always copies 16-byte chunks (cp.async has no 2-byte copy): a chunk
// holds 8 values, so a row's staged columns start at one of 8 offsets in
// their chunk (n = 2^k + 1 puts successive rows at successive offsets), and
// a ring row holds WV_COLS / 8 + 1 = 21 chunks. The ascend leg's coarse rows
// take chunks too, from the chunk holding the strip's first coarse column,
// so the coarse correction must start 16-byte aligned as u and f do. The
// arithmetic rounds to bf16 where the twins' tensors do (common.cuh).
#pragma once

#include "common.cuh"

namespace mgk {

constexpr int WV_SLOTS = 5;              // staged columns a lane holds
constexpr int WV_PAD = 16;               // halo columns a side (>= MAX_HALO)
constexpr int WV_COLS = 32 * WV_SLOTS;   // staged columns of a warp
constexpr int WV_CHUNKS = WV_COLS / 4 + 1;   // 16-byte chunks holding them at any offset
constexpr int WV_ROW = 4 * WV_CHUNKS;        // floats of a ring row
constexpr int WV_START_ROWS = 16;       // a warp's start-up, in row steps
constexpr unsigned WV_FULL = 0xffffffffu;
static_assert(WV_COLS == TILE_W + 2 * WV_PAD, "a warp stages its tile column and the halo");

enum WaveErr { WV_NONE = 0, WV_GPU = 1, WV_RES = 2 };   // no error, Σ|Δu|, Σ|r| (cpu, clean)
enum WaveLegKind { WV_SMOOTH = 0, WV_DESCEND = 1, WV_ASCEND = 2, WV_RBGS = 3 };   // 1, 3, 4, 1

constexpr int WV_CRING = 4;    // coarse rows of the ascend leg's ring (a power of 2)
constexpr int WV_CROW = 96;    // floats of a coarse ring row (3 a lane)
static_assert(WV_COLS / 2 + 1 <= WV_CROW, "a ring row holds the coarse columns a strip reads");

// The legs' extra arguments: the descend leg's coarse right-hand side fc
// (laid out as the coarse points of the owned region) and restriction, the
// ascend leg's window of the coarse correction.
template <class T = float>
struct WaveLegT {
  T* fc;
  int full_weighting;
  WinT<T> c;
};
using WaveLeg = WaveLegT<float>;

// The ring trigger kernel's view of its shard (rdma_trigger.cu, RING): rows
// of u and f above and below the block come from the receive buffers (row
// gi at top + (gi − row0)·n above it, at bot + (gi − row0 − rows)·n below),
// the output's first and last post_rows rows also go into the neighbours'
// receive buffers (row le of the block at up + le·n and at down + (le −
// rows)·n; null: no neighbour), a pass runs `sweeps` <= K sweeps (the levels
// above copy the one below, so level K is iterate `sweeps`), and `unit` is
// the warp's strip and chunk.
struct WaveRing {
  const float* u_top;
  const float* u_bot;
  const float* f_top;
  const float* f_bot;
  float* up;
  float* down;
  int post_rows, sweeps, unit;
};

// The pass's compile-time shape: K sweeps after level 0, error kind E, and
// ALL: the error of every level (the per-sweep mode) or of level K alone;
// LEG: the smoother or a leg; RING: the ring trigger kernel's pass, whose
// copies all take 16-byte chunks (cp.async.cg, read through L2: the grids
// are rewritten between its passes by other SMs); AHEAD: the rows loaded
// ahead, 0 for the rule below; T: the grids' storage type.
template <int K, int E, bool ALL, int LEG = WV_SMOOTH, bool RING = false, int AHEAD = 0,
          class T = float>
struct WaveShape {
  static_assert(sizeof(T) == 4 || (LEG != WV_RBGS && !RING), "bf16: kernels 1, 3 and 4 only");
  // halo rows (and columns) read; the descend leg forms r of level K
  static constexpr int H = K + (E == WV_RES || LEG == WV_DESCEND ? 1 : 0);
  static constexpr int D = AHEAD ? AHEAD : (K <= 2 ? 4 : 2);   // rows loaded ahead
  static constexpr bool CHUNKS = K <= 2 || RING || sizeof(T) != 4;   // 16-byte copies
  static constexpr int EL = 16 / (int)sizeof(T);       // values of a 16-byte chunk
  static constexpr int LOG = sizeof(T) == 4 ? 2 : 1;   // log2 of a value's bytes
  static constexpr int CH = WV_COLS / EL + 1;          // chunks holding a row at any offset
  static constexpr int ROW = EL * CH;                  // values of a ring row (WV_ROW: float)
  // the ascend leg's coarse ring rows: WV_CROW floats by 4-byte copies, or
  // CCH chunks of bf16 values
  static constexpr int CCH = WV_CROW / EL + 1;
  static constexpr int CROW = sizeof(T) == 4 ? WV_CROW : EL * CCH;
  static constexpr int NF = H + 1 + D;                  // f ring: rows r − H .. r + D
  static constexpr int NU = D + 1;                      // u ring: rows r .. r + D
  static constexpr int NL = E == WV_NONE ? 0 : (ALL ? K : 1);   // accumulated levels
  static constexpr int WIN = H > 0 ? H : 1;             // level windows: levels 0 .. H − 1
  static constexpr int NC = LEG == WV_ASCEND ? WV_CRING : 0;   // coarse ring rows
  static_assert(sizeof(T) != 4 || ROW == WV_ROW, "a float ring row is WV_ROW floats");
  // the rings, the row exchange and the accumulators of one warp, in floats
  // (a bf16 ring row is 84 of them; every part is a multiple of 16 bytes)
  static constexpr int WARP_FLOATS = (NF + NU) * ROW * (int)sizeof(T) / 4 + WV_COLS +
                                     NL * 8 * 32 + NC * CROW * (int)sizeof(T) / 4;
  static constexpr int WARPS = WARP_FLOATS * 4 * 4 <= 48 * 1024 ? 4 : 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr size_t SMEM = (size_t)WARPS * WARP_FLOATS * sizeof(float);
};

// BYTES (4 or 16) global -> shared, asynchronously: the first src_size
// bytes from src, the rest 0. L2: through L2 only (16 bytes), for data other
// SMs wrote earlier in the same launch.
template <int BYTES, bool L2 = false, class P = float>
static __device__ __forceinline__ void wave_copy(P* dst, const P* src, int src_size) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (L2)
    asm volatile("cp.async.cg.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(src_size));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(src_size));
}

// m ? a : b for a mask m of all ones or all zeros, as bit operations: a
// select that never becomes a branch (a per-lane ternary did, and took a
// third of the pass), its mask computed once.
static __device__ __forceinline__ float wave_pick(unsigned m, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & m) | (__float_as_uint(b) & ~m));
}

static __device__ __forceinline__ unsigned wave_mask(bool p) {
  return p ? 0xffffffffu : 0u;
}

static __device__ __forceinline__ void wave_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
static __device__ __forceinline__ void wave_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The pass of one warp (see the header). g_ is the owned region, u and f its
// windows extended by ext_r rows and ext_c columns a side; chunk_rows is a
// multiple of TILE_H. Launched with WaveShape::THREADS threads a block and
// WaveShape::SMEM bytes of dynamic shared memory. `leg`: the legs'
// arguments (unused by kernel 1); `ring`: the ring trigger kernel's (RING:
// u and f are the shard's own rows x n block, ext_r its halo rows, ext_c 0).
template <bool SHARD, int K, int E, bool ALL, int LEG = WV_SMOOTH, bool RING = false,
          int AHEAD = 0, class T = float>
static __device__ __forceinline__ void wave2_pass(
    const T* __restrict__ u, const T* __restrict__ f, T* __restrict__ out,
    float* __restrict__ partials, const Geo& g_, int ext_r, int ext_c, int chunk_rows,
    int stride, int from_zero, int even_only, float h2, float omega, float inv_h2,
    float zero_coef, const WaveLegT<T>& leg = WaveLegT<T>{}, const WaveRing& ring = WaveRing{}) {
  using S = WaveShape<K, E, ALL, LEG, RING, AHEAD, T>;
  extern __shared__ float wv_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Geo g = region<SHARD>(g_);
  const int n = g.n;
  const int tx_n = tiles_x(g);
  const int chunks = (g.rows + chunk_rows - 1) / chunk_rows;
  const int w_id = RING ? ring.unit : blockIdx.x * S::WARPS + warp;
  if (w_id >= tx_n * chunks) return;
  const int tx = w_id % tx_n, ch = w_id / tx_n;
  const int a = ch * chunk_rows, b = min(a + chunk_rows, g.rows);

  T* const ring_f = reinterpret_cast<T*>(wv_smem + warp * S::WARP_FLOATS);   // [NF][ROW]
  T* const ring_u = ring_f + S::NF * S::ROW;                // [NU][ROW]
  float* const xrow = reinterpret_cast<float*>(ring_u + S::NU * S::ROW);   // between layouts
  float* const acc = xrow + WV_COLS;                        // [NL][8][32]
  T* const ring_c = reinterpret_cast<T*>(acc + S::NL * 8 * 32);   // ascend: [NC][CROW]
  const int lc = WV_SLOTS * lane;                           // the lane's first column

  // the input windows (u's and f's share their geometry), cut to the grid
  const WinT<T> wf = region<SHARD>(f, g, ext_r, ext_c);
  const int r_lo = max(0, wf.r0), r_hi = min(n, wf.r0 + wf.rows);
  const int c_lo = max(0, wf.c0), c_hi = min(n, wf.c0 + wf.cols);
  const int gc0 = g.col0 + tx * TILE_W - WV_PAD;   // global column of staged column 0
  const int gt0 = gc0 + WV_PAD + lane;             // thread lane's tile column 0, global
  const Span sp = owned_interior(g);
  unsigned own_m = 0;
  unsigned int_m[WV_SLOTS], err_m[TILE_W / 32];   // select masks
  unsigned even_m[WV_SLOTS];   // rb-GS: the computed column is even
#pragma unroll
  for (int c = 0; c < WV_SLOTS; ++c) {
    const int gj = gc0 + lc + c;          // computed column
    int_m[c] = wave_mask(gj >= 1 && gj <= n - 2);
    even_m[c] = wave_mask((gj & 1) == 0);
  }
#pragma unroll
  for (int q = 0; q < TILE_W / 32; ++q) {
    const int gj = gt0 + 32 * q;          // tile column lane + 32q
    const bool own = gj < g.col0 + g.cols;
    own_m |= (own ? 1u : 0u) << q;
    err_m[q] = wave_mask(own && gj >= sp.j_lo && gj <= sp.j_hi);
  }
  // staged column 0 of window row gi lies at value offset (q + gi·cols) &
  // (EL − 1) of a 16-byte chunk, q for u's and f's base addresses
  const unsigned cols = (unsigned)wf.cols;
  const unsigned q0 = (unsigned)(gc0 - wf.c0) - (unsigned)wf.r0 * cols;
  const unsigned qf = (unsigned)(reinterpret_cast<uintptr_t>(f) >> S::LOG) + q0;
  const unsigned qu = (unsigned)(reinterpret_cast<uintptr_t>(u) >> S::LOG) + q0;
  const int par = gt0 & 1;                         // parity of the lane's tile columns
#pragma unroll
  for (int i = 0; i < S::NL * 8; ++i) acc[i * 32 + lane] = 0.0f;

  // RING: global row gi's column 0 in the shard's block or, beyond it, in
  // its receive buffers (the pointer of a row outside the window is never
  // read)
  auto ring_row = [&](auto own, const float* top, const float* bot, int gi) {
    const int le = gi - g.row0;
    return le < 0 ? top + (ptrdiff_t)le * n
                  : (le < g.rows ? own + (ptrdiff_t)le * n : bot + (ptrdiff_t)(le - g.rows) * n);
  };
  // window row gi of src into ring row dst. Chunks: from the one that holds
  // staged column 0, lane copying chunks lane and lane + 32, a chunk reading
  // up to the window's last column of the row (none outside its rows).
  // Else: lane copying staged columns lane + 32c of the window. RING: the
  // row from ring_row, its offset within a chunk from its address.
  auto fetch_row = [&](const T* __restrict__ src, unsigned q, int gi, T* dst,
                       const float* top, const float* bot) {
    const bool rin = gi >= r_lo && gi < r_hi;
    if constexpr (S::CHUNKS) {
      const T* at = nullptr;
      int m;
      if constexpr (RING) {
        at = ring_row(src, top, bot, gi) + gc0;
        m = (int)((reinterpret_cast<uintptr_t>(at) >> S::LOG) & (S::EL - 1));
      } else {
        m = (int)((q + (unsigned)gi * cols) & (S::EL - 1));
      }
      const T* const row0 =
          RING ? at - m : src + (ptrdiff_t)(gi - wf.r0) * wf.cols + (gc0 - wf.c0) - m;
      auto chunk = [&](int k) {
        const int cs = gc0 - m + S::EL * k;   // global column of the chunk's first value
        const int bytes =
            rin && cs + S::EL > c_lo && cs < c_hi ? (int)sizeof(T) * min(S::EL, c_hi - cs) : 0;
        wave_copy<16, RING>(dst + S::EL * k, bytes ? row0 + S::EL * k : src, bytes);
      };
      if (S::CH >= 32 || lane < S::CH) chunk(lane);
      if (lane < S::CH - 32) chunk(lane + 32);
    } else {
      const T* const row = src + (ptrdiff_t)(gi - wf.r0) * wf.cols + (gc0 - wf.c0) + lane;
#pragma unroll
      for (int c = 0; c < WV_SLOTS; ++c) {
        const int gl = gc0 + lane + 32 * c;
        const bool ok = rin && gl >= c_lo && gl < c_hi;
        wave_copy<4>(dst + lane + 32 * c, ok ? row + 32 * c : src, ok ? 4 : 0);
      }
    }
  };
  // ascend: coarse row I of c's window (its columns from gc0 / 2, the first
  // the staged columns read; 0 outside the window and the m x m grid) into
  // its ring slot, lane copying columns lane + 32t; bf16: lane copying chunk
  // lane from the one that holds column j0 (at value offset coffset(I) of
  // it), as fetch_row does
  const WinT<T>& cwin = leg.c;
  const int j0 = gc0 >> 1;
  auto coffset = [&](int I) {
    return (int)((reinterpret_cast<uintptr_t>(cwin.p + (ptrdiff_t)(I - cwin.r0) * cwin.cols +
                                              (j0 - cwin.c0)) >> S::LOG) & (S::EL - 1));
  };
  auto fetch_coarse = [&](int I) {
    const int m = (n + 1) / 2;
    const bool rin = I >= max(0, cwin.r0) && I < min(m, cwin.r0 + cwin.rows);
    const int j_lo = max(0, cwin.c0), j_hi = min(m, cwin.c0 + cwin.cols);
    if constexpr (sizeof(T) == 4) {
      const T* const row = cwin.p + (ptrdiff_t)(I - cwin.r0) * cwin.cols + (j0 - cwin.c0) + lane;
      T* const dst = ring_c + (I & (WV_CRING - 1)) * S::CROW + lane;
#pragma unroll
      for (int t = 0; t < WV_CROW / 32; ++t) {
        const int gj = j0 + lane + 32 * t;
        const bool ok = rin && gj >= j_lo && gj < j_hi;
        wave_copy<4>(dst + 32 * t, ok ? row + 32 * t : cwin.p, ok ? 4 : 0);
      }
    } else {
      const int cs = j0 - coffset(I) + S::EL * lane;   // coarse column of the chunk's first
      const int bytes =
          rin && cs + S::EL > j_lo && cs < j_hi ? (int)sizeof(T) * min(S::EL, j_hi - cs) : 0;
      const T* const src = cwin.p + (ptrdiff_t)(I - cwin.r0) * cwin.cols + (cs - cwin.c0);
      T* const dst = ring_c + (I & (WV_CRING - 1)) * S::CROW + S::EL * lane;
      if (lane < S::CCH) wave_copy<16>(dst, bytes ? src : cwin.p, bytes);
    }
  };
  // row gi of f (and u) into ring slots fs (us); ascend: with coarse row
  // (gi + 1) / 2 for odd gi, the first fine row that reads it
  auto fetch = [&](int gi, int fs, int us) {
    fetch_row(f, qf, gi, ring_f + fs * S::ROW, ring.f_top, ring.f_bot);
    if (!from_zero) fetch_row(u, qu, gi, ring_u + us * S::ROW, ring.u_top, ring.u_bot);
    if constexpr (LEG == WV_ASCEND) {
      if (gi & 1) fetch_coarse((gi + 1) >> 1);
    }
    wave_commit();
  };
  // ascend: coarse row I interpolated to this lane's fine columns gc0 + lc
  // + c (the prolongation's column pass of legs.cuh's ascend_tile): column gj
  // reads coarse column gj >> 1 at ring column (lc + c) >> 1, and an odd gj
  // the next one too; gc0 is even, so gj is odd where lane + c is
  auto wide_row = [&](int I, float (&w)[WV_SLOTS]) {
    const T* cr = ring_c + (I & (WV_CRING - 1)) * S::CROW + (lc >> 1);
    if constexpr (sizeof(T) != 4) cr += coffset(I);
    float cc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cc[k] = to_f(cr[k]);
    const unsigned odd = wave_mask(lane & 1);
    auto half = [](float a, float b) { return half_sum<T>(a, b); };
#pragma unroll
    for (int c = 0; c < WV_SLOTS; ++c) {
      if (c % 2 == 0)   // even lanes: gj even; odd lanes: gj odd
        w[c] = wave_pick(odd, half(cc[c / 2], cc[c / 2 + 1]), cc[c / 2]);
      else              // even lanes: gj odd; odd lanes: gj even
        w[c] = wave_pick(odd, cc[(c + 1) / 2], half(cc[(c - 1) / 2], cc[(c + 1) / 2]));
    }
  };
  // the float offset within its chunk at which window row gi starts in a
  // ring row (0 without chunks), and this lane's columns of f's ring row
  // `slot` holding row gi
  auto shift = [&](unsigned q, const T* own, const float* top, const float* bot, int gi) {
    if constexpr (RING)
      return (int)((reinterpret_cast<uintptr_t>(ring_row(own, top, bot, gi) + gc0) >> S::LOG) &
                   (S::EL - 1));
    return S::CHUNKS ? (int)((q + (unsigned)gi * cols) & (S::EL - 1)) : 0;
  };
  auto at_f = [&](int slot, int gi) {
    return ring_f + slot * S::ROW + shift(qf, f, ring.f_top, ring.f_bot, gi) + lc;
  };

  // row v (this lane's columns lc + c) into the tile layout: thread lane's
  // tile columns lane + 32q
  auto exchange = [&](const float (&v)[WV_SLOTS], float (&t)[TILE_W / 32]) {
    __syncwarp();
#pragma unroll
    for (int c = 0; c < WV_SLOTS; ++c) xrow[lc + c] = v[c];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < TILE_W / 32; ++q) t[q] = xrow[WV_PAD + lane + 32 * q];
  };

  const int ga = g.row0 + a, gb = g.row0 + b;
  // the descend leg's extra halo row a side (full weighting); 0 otherwise
  const int xh = LEG == WV_DESCEND ? leg.full_weighting : 0;

  // the owned cells of global row gi of the last level; RING: an edge row
  // also into the neighbours' receive buffers
  auto store = [&](int gi, const float (&v)[WV_SLOTS]) {
    if (gi < ga || gi >= gb) return;
    float t[TILE_W / 32];
    exchange(v, t);
    const int le = gi - g.row0;
    T* const row = out + (ptrdiff_t)le * g.cols + (gt0 - g.col0);
#pragma unroll
    for (int q = 0; q < TILE_W / 32; ++q)
      if ((own_m >> q) & 1) row[32 * q] = from_f<T>(t[q]);
    if constexpr (RING) {
      float* const rows[2] = {
          ring.up && le < ring.post_rows ? ring.up + (ptrdiff_t)le * n + gt0 : nullptr,
          ring.down && le >= g.rows - ring.post_rows
              ? ring.down + (ptrdiff_t)(le - g.rows) * n + gt0 : nullptr};
      for (float* p : rows) {
        if (p == nullptr) continue;
#pragma unroll
        for (int q = 0; q < TILE_W / 32; ++q)
          if ((own_m >> q) & 1) p[32 * q] = t[q];
      }
    }
  };

  // error_partial's terms of global row gi (|v| on the owned interior cells,
  // the even color for cpu) into accumulated level lv's accumulator of tile
  // row gi mod 8; after the tile's last row, block_sum's order over the
  // accumulators into row lv of the partials
  auto add = [&](int lv, int gi, const float (&v)[WV_SLOTS]) {
    const int le = gi - g.row0;
    if (le < a || le >= b) return;
    float t[TILE_W / 32];
    exchange(v, t);
    const unsigned row_m =
        wave_mask(gi >= sp.i_lo && gi <= sp.i_hi && !(even_only && ((gi + par) & 1)));
    float* const p = acc + (lv * 8 + (le & 7)) * 32 + lane;
    float sum = *p;
#pragma unroll
    for (int q = 0; q < TILE_W / 32; ++q)   // a masked cell adds +0
      sum = __fadd_rn(sum, wave_pick(row_m & err_m[q], fabsf(t[q]), 0.0f));
    *p = sum;
    if ((le & (TILE_H - 1)) != TILE_H - 1 && le != b - 1) return;
    float w[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      float* const q = acc + (lv * 8 + y) * 32 + lane;
      float x = *q;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(WV_FULL, x, o));
      w[y] = x;
      *q = 0.0f;
    }
    const float total = __fadd_rn(__fadd_rn(__fadd_rn(w[0], w[4]), __fadd_rn(w[2], w[6])),
                                  __fadd_rn(__fadd_rn(w[1], w[5]), __fadd_rn(w[3], w[7])));
    if (lane == 0) partials[(size_t)lv * stride + (le >> 5) * tx_n + tx] = total;
  };

  // descend: d's rows gi − 2 (dm2) and gi − 1 (dm1) before residual row gi
  float dm2[WV_SLOTS], dm1[WV_SLOTS];
  // descend: d = −r of level K at row gi (r at the interior cells, frozen
  // rows 0); the coarse row whose restriction it completes into fc
  auto restrict_row = [&](int gi, bool ri, const float (&res)[WV_SLOTS]) {
    const int fw = leg.full_weighting;
    const unsigned rim = wave_mask(ri);
    float d[WV_SLOTS];
#pragma unroll
    for (int c = 0; c < WV_SLOTS; ++c) d[c] = wave_pick(rim & int_m[c], -res[c], 0.0f);
    const int I = gi >> 1;   // full weighting: row 2I + 1; sampling: row 2I
    if ((gi & 1) == fw && 2 * I >= ga && 2 * I < gb) {
      auto comb = [](float x, float y, float z) { return fw_comb<T>(x, y, z); };
      __syncwarp();
#pragma unroll
      for (int c = 0; c < WV_SLOTS; ++c) xrow[lc + c] = fw ? comb(dm2[c], dm1[c], d[c]) : d[c];
      __syncwarp();
      const int m = (n + 1) / 2, ccols = (g.cols + 1) / 2;
      const unsigned row_in = wave_mask(I >= 1 && I <= m - 2);
      T* const row = leg.fc + (ptrdiff_t)(I - (g.row0 >> 1)) * ccols;
#pragma unroll
      for (int q = 0; q < 2; ++q) {   // coarse columns lane + 32q of the strip's 64
        const int j = WV_PAD + 2 * lane + 64 * q;   // the staged column of fine 2J
        const float v = fw ? comb(xrow[j - 1], xrow[j], xrow[j + 1]) : xrow[j];
        const int lJ = tx * (TILE_W / 2) + lane + 32 * q, J = (g.col0 >> 1) + lJ;
        if (lJ < ccols)
          row[lJ] = from_f<T>(wave_pick(row_in & wave_mask(J >= 1 && J <= m - 2), v, 0.0f));
      }
    }
#pragma unroll
    for (int c = 0; c < WV_SLOTS; ++c) {
      dm2[c] = dm1[c];
      dm1[c] = d[c];
    }
  };

  const int r_first = ga - S::H - xh, r_end = gb + S::H + xh;
  if constexpr (LEG == WV_ASCEND) fetch_coarse(r_first >> 1);   // the first row's
#pragma unroll
  for (int d = 0; d < S::D; ++d) fetch(r_first + d, d, d);

  // level j's rows r − j − 2 (nw) and r − j − 1 (cw) at the start of step r
  float nw[S::WIN][WV_SLOTS], cw[S::WIN][WV_SLOTS];
#pragma unroll
  for (int j = 0; j < S::WIN; ++j)
#pragma unroll
    for (int c = 0; c < WV_SLOTS; ++c) nw[j][c] = cw[j][c] = 0.0f;
  // ascend: coarse row r >> 1 interpolated to the lane's columns at step r
  float wc[WV_SLOTS];
#pragma unroll
  for (int c = 0; c < WV_SLOTS; ++c) wc[c] = dm2[c] = dm1[c] = 0.0f;

  int fs = 0, us = 0;   // ring slots of row r
  for (int r = r_first; r < r_end; ++r) {
    wave_wait<S::D - 1>();   // this lane's copies of row r have landed
    __syncwarp();            // and every lane's; every lane is done with step r − 1
    {
      int fd = fs + S::D, ud = us + S::D;
      if (fd >= S::NF) fd -= S::NF;
      if (ud >= S::NU) ud -= S::NU;
      fetch(r + S::D, fd, ud);
    }

    // level 0 at row r
    float cur[WV_SLOTS];
    const T* const fr = at_f(fs, r);
    if (from_zero) {
      const unsigned ri = wave_mask(r >= 1 && r <= n - 2);
#pragma unroll
      for (int c = 0; c < WV_SLOTS; ++c)
        cur[c] = LEG == WV_RBGS
                     ? 0.0f
                     : wave_pick(ri & int_m[c], rnd<T>(__fmul_rn(zero_coef, to_f(fr[c]))), 0.0f);
    } else {
#pragma unroll
      for (int c = 0; c < WV_SLOTS; ++c)
        cur[c] = to_f(ring_u[us * S::ROW + shift(qu, u, ring.u_top, ring.u_bot, r) + lc + c]);
      if constexpr (LEG == WV_ASCEND) {
        // + prolong(c) on the interior: coarse row r >> 1 (interpolated at
        // step r − 1, or now at the chunk's first row), and for odd r the
        // halves of it and of row (r >> 1) + 1
        if (r == r_first) wide_row(r >> 1, wc);
        float p[WV_SLOTS];
        if (r & 1) {
          float wn[WV_SLOTS];
          wide_row((r >> 1) + 1, wn);
#pragma unroll
          for (int c = 0; c < WV_SLOTS; ++c) {
            p[c] = half_sum<T>(wc[c], wn[c]);
            wc[c] = wn[c];
          }
        } else {
#pragma unroll
          for (int c = 0; c < WV_SLOTS; ++c) p[c] = wc[c];
        }
        const unsigned ri = wave_mask(r >= 1 && r <= n - 2);
#pragma unroll
        for (int c = 0; c < WV_SLOTS; ++c)
          cur[c] = wave_pick(ri & int_m[c], rnd<T>(__fadd_rn(cur[c], p[c])), cur[c]);
      }
    }
    if (K == 0) {
      store(r, cur);
      if (E == WV_GPU) add(0, r, cur);   // Δ from the zero iterate
    }

    // iteration s reads level s − 1's rows r − s − 1, r − s, r − s + 1 (cur):
    // level s at row r − s for s <= K, level s − 1's residual at row r − s
#pragma unroll
    for (int s = 1; s <= S::H; ++s) {
      const int gi = r - s;
      const bool ri = gi >= 1 && gi <= n - 2;
      int sl = fs - s;
      if (sl < 0) sl += S::NF;
      const T* const fl = at_f(sl, gi);
      const float (&uc)[WV_SLOTS] = cw[s - 1];
      // the side neighbours: the lane's own columns, and one column of each
      // adjacent lane (staged columns −1 and WV_COLS read a lane's own)
      const float left = __shfl_up_sync(WV_FULL, uc[WV_SLOTS - 1], 1);
      const float right = __shfl_down_sync(WV_FULL, uc[0], 1);
      const bool res_here =
          (E == WV_RES || LEG == WV_DESCEND) && (ALL ? s >= 2 : s - 1 == K);
      // rb-GS: half-level s updates the cells whose column has the parity
      // of gi + s − 1, i.e. (gi + gj) & 1 == (s − 1) & 1
      const unsigned flip = wave_mask((gi + s - 1) & 1);
      float nxt[WV_SLOTS], res[WV_SLOTS];
#pragma unroll
      for (int c = 0; c < WV_SLOTS; ++c) {
        const float we = c > 0 ? uc[c - 1] : left;
        const float ea = c < WV_SLOTS - 1 ? uc[c + 1] : right;
        const float nb = nb_add<T>(nw[s - 1][c], cur[c], we, ea);
        const float fc = to_f(fl[c]);
        if constexpr (LEG == WV_RBGS) {
          if (s <= K)
            nxt[c] = wave_pick(int_m[c] & (even_m[c] ^ flip),
                               __fmul_rn(0.25f, __fsub_rn(nb, __fmul_rn(h2, fc))), uc[c]);
          if (res_here)
            res[c] = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(nb, __fmul_rn(4.0f, uc[c])),
                                                __fmul_rn(h2, fc)));
        } else {
          if (s <= K)
            nxt[c] = wave_pick(int_m[c], jacobi_point<T>(nb, uc[c], fc, h2, omega), uc[c]);
          if (res_here) res[c] = residual_point<T>(nb, uc[c], fc, inv_h2);
        }
      }
      // a frozen row (uniform across the warp); RING: a level above the
      // pass's sweeps copies the one below
      if (s <= K && (!ri || (RING && s > ring.sweeps))) {
#pragma unroll
        for (int c = 0; c < WV_SLOTS; ++c) nxt[c] = uc[c];
      }
      if (E == WV_RES && res_here) add(ALL ? s - 2 : 0, gi, res);
      if constexpr (LEG == WV_DESCEND) {
        if (res_here) restrict_row(gi, ri, res);
      }
      if (E == WV_GPU && s <= K && (ALL || s == K)) {
        float d[WV_SLOTS];
#pragma unroll
        for (int c = 0; c < WV_SLOTS; ++c) d[c] = rnd<T>(__fsub_rn(nxt[c], uc[c]));
        add(ALL ? s - 1 : 0, gi, d);
      }
#pragma unroll
      for (int c = 0; c < WV_SLOTS; ++c) {
        nw[s - 1][c] = cw[s - 1][c];
        cw[s - 1][c] = cur[c];
        if (s <= K) cur[c] = nxt[c];
      }
      if (s == K) store(gi, cur);
    }
    if (++fs == S::NF) fs = 0;
    if (++us == S::NU) us = 0;
  }
  wave_wait<0>();
}

// Warps of `kernel` the card keeps resident at `threads` a block and `smem`
// bytes of dynamic shared memory.
template <class F>
static int wave2_resident_warps(F kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, blocks = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  return max(1, blocks) * (threads / 32) * max(1, sms);
}

// Owned rows of a chunk for g: the multiple of TILE_H that finishes first
// when `resident` warps run at once and a warp's time grows with the rows it
// sweeps, its own and the 2·halo it shares, after a start-up worth
// WV_START_ROWS (its first rows' load latency): waves × (rows + 2·halo +
// WV_START_ROWS). Of equal times the most rows (the fewest halo reads).
static inline int wave2_chunk_rows(const Geo& g, int resident, int halo) {
  const long strips = tiles_x(g);
  int best = TILE_H;
  long best_cost = -1;
  for (int rows = TILE_H; rows < g.rows + TILE_H; rows += TILE_H) {
    const long warps = strips * ((g.rows + rows - 1) / rows);
    const long cost = (warps + resident - 1) / resident * (rows + 2 * halo + WV_START_ROWS);
    if (best_cost < 0 || cost <= best_cost) {
      best = rows;
      best_cost = cost;
    }
  }
  return best;
}

// Owned rows a chunk for every launch of the wavefront (kernels 1, 3 and
// 4), a multiple of TILE_H; 0: the occupancy rule's. Set by
// mg_wave2_force_rows (jacobi.cu, which defines it).
extern int wave2_forced_rows;
// The legs' route for every launch: 0 the size rule (legs_take_wave), 1 the
// tile kernel, 2 the wavefront. Set by mg_legs_force_route (jacobi.cu).
extern int legs_forced_route;

// The size rule of kernels 3 and 4 (descend.cu, ascend.cu and their bf16
// modes): a launch on an owned region of rows x cols cells takes the
// wavefront from min_cells cells, else the tile kernel; or the forced
// route. The fp32 legs' crossover is 1.5 M cells (3 · 2^19: between 1025²'s
// 1.05 M and a 512 x 4097 shard's 2.1 M; measured in descend.cu's and
// ascend.cu's headers); the bf16 legs pass their own (descend_bf16.cu,
// ascend_bf16.cu).
static inline bool legs_take_wave(long rows, long cols, long min_cells = 3L << 19) {
  if (legs_forced_route) return legs_forced_route == 2;
  return rows * cols >= min_cells;
}

static inline int wave2_rows(const Geo& g, int resident, int halo) {
  return wave2_forced_rows ? wave2_forced_rows : wave2_chunk_rows(g, resident, halo);
}

// Blocks of `warps_per_block` warps for a warp per strip and chunk.
static inline dim3 wave_grid(const Geo& g, int rows, int warps_per_block) {
  const long warps = (long)tiles_x(g) * ((g.rows + rows - 1) / rows);
  return dim3((unsigned)((warps + warps_per_block - 1) / warps_per_block));
}

// The wavefront's 16-byte copies read from u's and f's 16-byte chunks: both
// must start on one (u may be null from zero).
static inline bool misaligned(const void* u, const void* f) {
  return ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(f)) & 15) != 0;
}

// Whether a block's geometry is out of range: an entry point refuses it.
static inline bool bad_geo(int n, int row0, int col0, int rows, int cols, int ext_r, int ext_c) {
  return n < 3 || rows < 1 || cols < 1 || row0 < 0 || col0 < 0 || row0 + rows > n ||
         col0 + cols > n || ext_r < 0 || ext_c < 0;
}

}  // namespace mgk
