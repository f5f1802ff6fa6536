// The column pass of the port's 3-D smoothers and trigger loops: one
// damped-Jacobi sweep of the 7-point stencil over a level (or a z-shard's
// planes) and the smoothing error of an iterate, with each thread streaming
// one (y, x) column down z. It is the pass of kernel 10 (jacobi3.cu: its
// fixed-sweep and per_sweep modes, one launch a sweep), of the whole-loop
// trigger kernel (trigger3.cu: one pass a sweep between grid barriers), of
// the streamed one (trigger3_stream.cu: passes of B sweeps) and of the ring
// trigger kernel (rdma_trigger3.cu: one pass a sweep per z-shard, its halo
// planes read from and posted to receive buffers through a plane source of
// its own in place of Col3Io below), the sweeps of the 3-D legs
// (descend3.cu, ascend3.cu, whose residual and prolongation passes are
// their own; the residual pass streams its columns through col3_stream) and
// of the ring smoother and ring legs (rdma_jacobi3.cu, rdma_descend3.cu,
// rdma_ascend3.cu, through rdma3.cuh); the residual (residual3.cu) streams
// its columns through col3_stream too.
//
// Why not the tile pipeline of legs3.cuh: a fused k-sweep trapezoid there
// runs one 512-thread block an SM with a barrier after every stage of every
// plane and its index arithmetic at runtime, and at 513³ its 7-sweep pass
// took 5× as long as 7 of these passes (PERF.md). Here a sweep is one pass
// over memory with no barrier inside: a thread keeps planes z − 1, z, z + 1
// of its column in registers, loads the in-plane neighbours and f directly
// (through the L1 in a one-launch kernel, where neighbouring threads' loads
// hit the same lines; through L2 in a persistent one, after a grid barrier),
// and keeps the loads of the next COL3_AHEAD planes in flight.
//
// The error rides on the sweep's own stencil read: the neighbour sum that
// makes u_{s+1} from u_s is also the one of r(u_s) = (1/h²)(Σnb − 6u) − f, so
// a pass gives the clean error of the iterate it reads (ERR_CLEAN) or the gpu
// error Σ|u_{s+1} − u_s| of the one it writes (ERR_GPU), and the clean error
// of a loop's last iterate takes one more pass that writes nothing.
//
// The contract with every other launch of a trigger loop (legs3.cuh): the
// error of an iterate is summed in float64, per block of the error plan
// (ops.kernels3.err_plan3: a ty x tx column tile over a z chunk of cz planes),
// thread v of its 512 taking tile cell v (v < ty·tx) down the chunk in z
// order, then block_sum3's fixed tree over the 512 sums; the block partials
// in fixed_sum3's order. Here a tile is split over COL3_QUARTERS blocks of
// COL3_THREADS threads (so that a 65³ level fills the SMs): block q of a
// tile runs the tile's threads q·COL3_THREADS + tid, so each of its warps
// is one of block_sum3's warps and takes that warp's shuffle tree; the
// warps' sums go to the workspace, and the last of the tile's blocks to
// arrive (a counter per tile, never reset within a call) adds them in
// block_sum3's second tree. A partial is thus the one-sweep launch's bit for
// bit, and the trigger loops stop on the same sweep whichever launch
// measured an error. Arithmetic is legs3.cuh's, in the twins' order.
#pragma once

#include "legs3.cuh"

namespace mgk3 {

constexpr int COL3_THREADS = 128;
constexpr int COL3_WARPS = COL3_THREADS / 32;
constexpr int COL3_QUARTERS = THREADS3 / COL3_THREADS;  // blocks per error tile
constexpr int WARPS3 = THREADS3 / 32;                   // block_sum3's warps

// A call's column passes: the planes of a level, or of a z-shard whose
// inputs are its owned planes [z0, z0 + nz) extended by ext planes per side
// (zero beyond the grid); iterates are laid out as the inputs (global plane
// z at z − z0 + ext). The whole grid is z0 = 0, nz = n, ext = 0. A
// persistent kernel reads these fields from its parameters; what changes
// from pass to pass is in Col3Pass.
struct Col3 {
  const float* f;
  double* wsum;       // WARPS3 warp sums per tile
  unsigned* arrivals; // blocks of each tile done, modulo COL3_QUARTERS
  int n, z0, nz, ext;
  int ty, tx, cz;     // the error plan over the owned planes
  float h2, w, inv_h2;
};

// One pass.
struct Col3Pass {
  const float* src;   // the iterate read; nullptr: u ≡ 0 (the closed-form first sweep)
  float* dst;         // the iterate written (planes [plo, phi)), or nullptr
  float* own;         // also the owned planes of the iterate written, or nullptr
  double* partials;   // the pass's row of error partials (one per tile), or nullptr
  int err;            // ERR_NONE, ERR_CLEAN (of src) or ERR_GPU (dst − src)
  int plo, phi;       // the planes written, global
};

static __host__ __device__ __forceinline__ int col3_gx(const Col3& C) {
  return (C.n + C.tx - 1) / C.tx;
}
static __host__ __device__ __forceinline__ int col3_gy(const Col3& C) {
  return (C.n + C.ty - 1) / C.ty;
}
// error tiles (partials a row), and blocks of a pass
static __host__ __device__ __forceinline__ int col3_tiles(const Col3& C) {
  return col3_gx(C) * col3_gy(C) * ((C.nz + C.cz - 1) / C.cz);
}
static __host__ __device__ __forceinline__ int col3_units(const Col3& C) {
  return col3_tiles(C) * COL3_QUARTERS;
}

template <bool COHERENT>
static __device__ __forceinline__ float col3_ld(const float* p) {
  return COHERENT ? __ldcg(p) : __ldg(p);
}

// The loads one plane of a column needs: u, and in an interior column its
// four in-plane neighbours and f.
struct Col3Plane {
  float c, ym, yp, xm, xp, f;
};

// u and f point at the column's cell of the plane.
template <bool COHERENT>
static __device__ __forceinline__ void col3_load(Col3Plane& p, const float* __restrict__ u,
                                                 const float* __restrict__ f, int n, bool cin) {
  p.c = col3_ld<COHERENT>(u);
  if (cin) {
    p.ym = col3_ld<COHERENT>(u - n);
    p.yp = col3_ld<COHERENT>(u + n);
    p.xm = col3_ld<COHERENT>(u - 1);
    p.xp = col3_ld<COHERENT>(u + 1);
    p.f = col3_ld<COHERENT>(f);
  }
}

// Where a walk reads the planes of u and f and writes the iterate it makes:
// volumes laid out as the inputs (plane z at z · n² from global plane 0 of
// the inputs' layout), the written iterate into dst (or nullptr) and its
// owned planes into own (or nullptr) (kernels 10, 15 and 16). The ring
// kernel's source (rdma_trigger3.cu) takes planes beyond its shard's block
// from receive buffers and also writes its boundary planes into its
// neighbours' ones. A plane's source is chosen per plane, the same in every
// thread.
struct Col3Io {
  const float* u;
  const float* f;
  float* dst;
  float* own;
  __device__ __forceinline__ const float* up(int z, size_t pl) const { return u + z * pl; }
  __device__ __forceinline__ const float* fp(int z, size_t pl) const { return f + z * pl; }
  __device__ __forceinline__ bool writes() const { return dst != nullptr || own != nullptr; }
  __device__ __forceinline__ void put(const Col3& C, int z, size_t pl, size_t col,
                                      float v) const {
    if (dst != nullptr) dst[z * pl + col] = v;
    if (own != nullptr && z >= C.z0 && z < C.z0 + C.nz) own[(z - C.z0) * pl + col] = v;
  }
};

// Planes whose loads a column keeps in flight: a ring of COL3_AHEAD + 1
// planes in registers, its slots fixed at compile time by unrolling the walk
// by the ring's length (a ring rotated by moves would wait for each load at
// the move, one plane after its issue). Deeper rings measured slower
// (PERF.md).
constexpr int COL3_AHEAD = 3;
constexpr int COL3_RING = COL3_AHEAD + 1;

// (Σnb − 6u) of a plane's loads p between the column's u at z − 1 (cm) and
// z + 1 (cp): ((((z− + z+) + y−) + y+) + x−) + x+, then − 6u.
static __device__ __forceinline__ float col3_lap(const Col3Plane& p, float cm, float cp) {
  const float nb =
      __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(cm, cp), p.ym), p.yp), p.xm), p.xp);
  return __fsub_rn(nb, __fmul_rn(6.0f, p.c));
}

// Stream column col of the source's iterate down the planes [zs, ze),
// calling at(z, p, cm, cp) for each plane: p its loads (col3_load; the
// neighbours and f only in an interior column, cin), cm and cp the column's
// u at z − 1 and z + 1 (cm 0 before plane 0; cp is read for interior planes
// only, and plane ze is loaded for it where ze < n).
template <bool COHERENT, class Io, class At>
static __device__ __forceinline__ void col3_stream(const Io& io, int n, size_t pl, size_t col,
                                                   bool cin, int zs, int ze, At&& at) {
  // slot r holds plane zs + t for t ≡ r (mod COL3_RING); plane p is loaded
  // while p <= ze (plane ze is the last one's z + 1) and p < n
  Col3Plane ring[COL3_RING];
  float cm = cin && zs >= 1 ? col3_ld<COHERENT>(io.up(zs - 1, pl) + col) : 0.0f;
#pragma unroll
  for (int r = 0; r < COL3_AHEAD; ++r)
    if (zs + r <= ze && zs + r < n)
      col3_load<COHERENT>(ring[r], io.up(zs + r, pl) + col, io.fp(zs + r, pl) + col, n, cin);
  for (int t0 = 0; t0 < ze - zs; t0 += COL3_RING) {
#pragma unroll
    for (int r = 0; r < COL3_RING; ++r) {
      const int z = zs + t0 + r;
      if (z >= ze) break;
      const int za = z + COL3_AHEAD;  // into the slot plane z − 1 has left
      if (za <= ze && za < n)
        col3_load<COHERENT>(ring[(r + COL3_AHEAD) % COL3_RING], io.up(za, pl) + col,
                            io.fp(za, pl) + col, n, cin);
      at(z, ring[r], cm, ring[(r + 1) % COL3_RING].c);
      cm = ring[r].c;
    }
  }
}

// Column (y, x) over the planes [zs, ze): the sweep into the source's
// written iterate and this thread's error sum over the chunk's planes
// [e0, e1). Face columns and planes are frozen and carry no error. The
// arithmetic is legs3.cuh's: (Σnb − 6u) as ((((z− + z+) + y−) + y+) + x−) +
// x+, then − 6u; the sweep u + (ω/6)·((Σnb − 6u) − h²f); the residual
// (1/h²)(Σnb − 6u) − f. ZERO: u ≡ 0 is not read, and the sweep is the closed
// form (ω/6)·(−h²f) (legs3.cuh's store_plane), pointwise, so it is exact on
// every plane it writes, halo planes included; its gpu error is |u_1 − 0|.
template <bool COHERENT, bool ZERO = false, class Io = Col3Io>
static __device__ __forceinline__ double col3_walk(const Col3& C, int err, const Io& io, int y,
                                                   int x, int zs, int ze, int e0, int e1) {
  const int n = C.n;
  const size_t pl = (size_t)n * n, col = (size_t)y * n + x;
  const bool cin = inner(y, n) && inner(x, n);
  double acc = 0.0;
  if constexpr (ZERO) {
#pragma unroll 4
    for (int z = zs; z < ze; ++z) {
      float v = 0.0f;
      if (cin && inner(z, n)) {
        v = __fmul_rn(C.w, -__fmul_rn(C.h2, col3_ld<COHERENT>(io.fp(z, pl) + col)));
        if (err == ERR_GPU && z >= e0 && z < e1) acc += (double)fabsf(v);
      }
      if (io.writes()) io.put(C, z, pl, col, v);
    }
    return acc;
  }
  auto at = [&](int z, const Col3Plane& p, float cm, float cp) {
    float v = p.c;
    if (cin && inner(z, n)) {
      const float lap = col3_lap(p, cm, cp);
      v = __fadd_rn(p.c, __fmul_rn(C.w, __fsub_rn(lap, __fmul_rn(C.h2, p.f))));
      if (z >= e0 && z < e1) {
        if (err == ERR_CLEAN)
          acc += (double)fabsf(__fsub_rn(__fmul_rn(C.inv_h2, lap), p.f));
        else if (err == ERR_GPU)
          acc += (double)fabsf(__fsub_rn(v, p.c));
      }
    }
    if (io.writes()) io.put(C, z, pl, col, v);
  };
  col3_stream<COHERENT>(io, n, pl, col, cin, zs, ze, at);
  return acc;
}

// Add this thread's error sum into the tile's partial (see the header).
static __device__ __forceinline__ void col3_finish(const Col3& C, double* partials, int tile,
                                                   int q, double acc) {
  __shared__ bool last;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  double* const ws = C.wsum + (size_t)tile * WARPS3;
  if (lane == 0) ws[q * COL3_WARPS + wp] = acc;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(C.arrivals + tile, 1u) % COL3_QUARTERS == COL3_QUARTERS - 1;
  __syncthreads();
  if (last && wp == 0) {
    double t = lane < WARPS3 ? __ldcg(ws + lane) : 0.0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) partials[tile] = t;
  }
}

// Block `unit` of a pass (tile unit / COL3_QUARTERS, its part unit %
// COL3_QUARTERS): its columns over its chunk, and for a shard the first and
// the last chunk's blocks also over the halo planes the pass writes; the
// planes come from and go to the source io.
template <bool COHERENT, bool SHARD, bool ZERO = false, class Io = Col3Io>
static __device__ __forceinline__ void col3_unit_io(const Col3& C, const Col3Pass& P, int unit,
                                                    const Io& io) {
  const int n = C.n, gx = col3_gx(C), gy = col3_gy(C);
  const int tile = unit / COL3_QUARTERS, q = unit - tile * COL3_QUARTERS;
  const int bx = tile % gx, by = (tile / gx) % gy, bz = tile / (gx * gy);
  const int zlo = SHARD ? C.z0 : 0, zhi = SHARD ? C.z0 + C.nz : n;
  const int e0 = zlo + bz * C.cz, e1 = min(e0 + C.cz, zhi);
  const int zs = SHARD && e0 == zlo ? P.plo : e0, ze = SHARD && e1 == zhi ? P.phi : e1;
  const int v = q * COL3_THREADS + threadIdx.x;  // the tile's thread (block_sum3's numbering)
  double acc = 0.0;
  if (v < C.ty * C.tx) {
    const int i = v / C.tx;
    const int y = by * C.ty + i, x = bx * C.tx + (v - i * C.tx);
    if (y < n && x < n) acc = col3_walk<COHERENT, ZERO>(C, P.err, io, y, x, zs, ze, e0, e1);
  }
  if (P.partials != nullptr) col3_finish(C, P.partials, tile, q, acc);
}

// The same on the call's volumes (Col3Io from the pass's pointers; ZERO:
// the closed-form first sweep, P.src unread).
template <bool COHERENT, bool SHARD, bool ZERO = false>
static __device__ __forceinline__ void col3_unit(const Col3& C, const Col3Pass& P, int unit) {
  const int n = C.n;
  // the inputs' global plane 0 (a shard's windows start at z0 − ext)
  const ptrdiff_t base = SHARD ? -(ptrdiff_t)(C.z0 - C.ext) * n * n : 0;
  const Col3Io io{ZERO ? nullptr : P.src + base, C.f + base,
                  P.dst != nullptr ? P.dst + base : nullptr, P.own};
  col3_unit_io<COHERENT, SHARD, ZERO>(C, P, unit, io);
}

// fixed_sum3 (thread-strided over THREADS3 threads, then block_sum3's tree)
// on a block of COL3_THREADS threads: every block of a persistent loop takes
// the same stop decision from the same value, returned in every thread.
static __device__ double col3_fixed_sum(const double* partials, int count) {
  __shared__ double ws[WARPS3];
  __shared__ double total;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < COL3_QUARTERS; ++r) {
    double v = 0.0;
    for (int i = r * COL3_THREADS + threadIdx.x; i < count; i += THREADS3)
      v += __ldcg(partials + i);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) ws[r * COL3_WARPS + wp] = v;
  }
  __syncthreads();
  if (wp == 0) {
    double t = lane < WARPS3 ? ws[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const double t = total;
  __syncthreads();  // every thread has read total before a later call rewrites it
  return t;
}

// Which iterates a call's passes measure: every one (row s − 1 for iterate
// s), the last (one row), or, lagged, the one the last sweep reads (one row:
// the clean error of iterate k − 1 from the stencil read that makes iterate
// k, for a trigger loop that takes the clean error one sweep behind; the
// gpu error stays iterate k's).
enum Col3Rows { ROWS_EVERY = 0, ROWS_LAST = 1, ROWS_LAGGED = 2 };

// Pass j of k sweeps from src (iterate 0; nullptr: u ≡ 0, and pass 0 is the
// closed-form sweep) to dst (iterate k) with the errors `kind` names, in
// rows of one partial per tile; rows nullptr: no error. One pass a sweep,
// the iterates alternating between dst and mid so that the last lands in
// dst, or with own only in own's owned planes, then with the clean error of
// iterate k one pass that reads it (from dst) and writes nothing. A pass
// takes the clean error of the iterate it reads and the gpu error of the
// one it writes. Sweep s writes the owned planes and the k + clean + tail −
// s more per side that the later passes read, tail being the stencil reads
// of iterate k that the caller's own passes make after these (the descend
// leg's −r and its restriction; iterate k then lands in dst as well). Sets P
// for pass j and returns false past the last pass. col3_scratch says which
// of dst and mid a call uses.
static __host__ __device__ __forceinline__ bool col3_schedule(const Col3& C, Col3Pass& P, int j,
                                                              int k, int mode,
                                                              const float* src, float* dst,
                                                              float* mid, float* own,
                                                              double* rows, int tiles,
                                                              int kind = ROWS_EVERY,
                                                              int tail = 0) {
  const int clean = rows != nullptr && mode == ERR_CLEAN && kind != ROWS_LAGGED;
  if (j >= k + clean) return false;
  auto it = [&](int s) -> float* { return (k - s) % 2 == 0 ? dst : mid; };  // iterate s >= 1
  P.src = j == 0 ? src : it(j);
  P.dst = j < k - 1 || (j == k - 1 && (own == nullptr || clean || tail)) ? it(j + 1) : nullptr;
  P.own = j == k - 1 ? own : nullptr;
  // clean: the error of iterate j; gpu: of iterate j + 1
  const int row = kind == ROWS_EVERY ? j - clean : (j == k + clean - 1 ? 0 : -1);
  P.err = rows != nullptr && row >= 0 ? mode : ERR_NONE;
  P.partials = P.err != ERR_NONE ? rows + (size_t)row * tiles : nullptr;
  const int more = k + clean + tail - j - 1;
  const int lo = C.z0 - more, hi = C.z0 + C.nz + more;
  P.plo = lo > 0 ? lo : 0;
  P.phi = hi < C.n ? hi : C.n;
  return true;
}

// Whether col3_schedule's k sweeps write into dst and into mid: mid holds
// iterates k − 1, k − 3, ..., dst iterates k − 2, k − 4, ... and k itself
// unless it goes only to own (own given, and no pass reads it after the
// sweeps: `reread` false).
static inline void col3_scratch(int k, bool own, bool reread, bool* dst, bool* mid) {
  *mid = k >= 2;
  *dst = k >= 3 || !own || reread;
}

// The geometry checks of a call's column passes: the plan's tile has at
// most THREADS3 cells (one a thread of block_sum3's numbering), and the
// inputs hold the `stages` planes per side that the owned planes depend on,
// or reach the grid's faces.
static inline bool col3_ok(const Col3& C, int stages) {
  if (C.n < 3 || C.ty < 1 || C.tx < 1 || C.cz < 1 || C.ty * C.tx > THREADS3) return false;
  const int lo = C.z0 - stages > 0 ? C.z0 - stages : 0;
  const int hi = C.z0 + C.nz + stages < C.n ? C.z0 + C.nz + stages : C.n;
  return C.nz >= 1 && C.z0 >= 0 && C.z0 + C.nz <= C.n && C.ext >= 0 && C.z0 - C.ext <= lo &&
         C.z0 + C.nz + C.ext >= hi;
}

// The call's fields (checked by col3_ok for `stages` stencil reads): the
// planes, f, the plan and the constants, and the workspace at `work`
// (ops.kernels3.col3_work doubles: WARPS3 warp sums per tile, then the
// tiles' arrival counters, which are zeroed here, on the stream before the
// launches that use them). A call that measures no error may pass no
// workspace (errors false).
static inline cudaError_t col3_setup(Col3& C, int stages, const float* f, double* work, int n,
                                     int z0, int nz, int ext, int ty, int tx, int cz, float h2,
                                     float w, float inv_h2, cudaStream_t stream,
                                     bool errors = true) {
  C = Col3{f, nullptr, nullptr, n, z0, nz, ext, ty, tx, cz, h2, w, inv_h2};
  if (f == nullptr || !col3_ok(C, stages)) return cudaErrorInvalidValue;
  if (!errors) return cudaSuccess;
  if (work == nullptr) return cudaErrorInvalidValue;
  const int tiles = col3_tiles(C);
  C.wsum = work;
  C.arrivals = reinterpret_cast<unsigned*>(work + (size_t)tiles * WARPS3);
  return cudaMemsetAsync(C.arrivals, 0, sizeof(unsigned) * tiles, stream);
}

// One column pass a launch: block b is the pass's unit b. ZERO: the
// closed-form first sweep from u ≡ 0.
template <bool SHARD, bool ZERO>
static __global__ void __launch_bounds__(COL3_THREADS) col3_pass_kernel(Col3 C, Col3Pass P) {
  col3_unit<false, SHARD, ZERO>(C, P, blockIdx.x);
}

// steps sweeps of u (nullptr: from zero) on the owned planes [z0, z0 + nz)
// of a level (inputs extended by ext planes per side) into it[0] (or, given
// `own`, into its owned planes there; it[0] then holds earlier iterates or
// nothing), it[1] a scratch volume shaped as u (col3_scratch says which the
// call needs), with the errors (ERR_NONE, ERR_CLEAN or ERR_GPU) that `kind`
// names (Col3Rows; rows of one double per tile of the plan): col3_schedule's
// passes, one launch each (kernel 10's fixed and per-sweep modes, and the
// sweeps of the legs, whose own passes read iterate k on `tail` more planes
// a side). Returns the tile count in *tiles.
static inline cudaError_t col3_passes(bool shard, const float* u, const float* f,
                                      float* const it[2], float* own, double* partials,
                                      double* work, int n, int z0, int nz, int ext, int steps,
                                      int err_mode, int kind, int ty, int tx, int cz, float h2,
                                      float w, float inv_h2, int* tiles, cudaStream_t stream,
                                      int tail = 0) {
  const bool errors = err_mode != ERR_NONE;
  const bool clean = err_mode == ERR_CLEAN && kind != ROWS_LAGGED;  // a read-only pass last
  const int stages = steps - (u == nullptr) + clean + tail;
  bool need_dst, need_mid;
  col3_scratch(steps, own != nullptr, clean || tail > 0, &need_dst, &need_mid);
  if ((errors && err_mode != ERR_CLEAN && err_mode != ERR_GPU) || steps < 1 ||
      steps > MAX_STEPS3 || stages > MAX_STEPS3 || tail < 0 || (errors && partials == nullptr) ||
      (need_dst && it[0] == nullptr) || (need_mid && it[1] == nullptr))
    return cudaErrorInvalidValue;
  Col3 C;
  cudaError_t e = col3_setup(C, stages, f, work, n, z0, nz, ext, ty, tx, cz, h2, w, inv_h2,
                             stream, errors);
  if (e != cudaSuccess) return e;
  *tiles = col3_tiles(C);
  Col3Pass P;
  for (int j = 0; col3_schedule(C, P, j, steps, err_mode, u, it[0], it[1], own,
                                errors ? partials : nullptr, *tiles, kind, tail);
       ++j) {
    const bool zero = P.src == nullptr;
    if (shard && zero)
      col3_pass_kernel<true, true><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, P);
    else if (shard)
      col3_pass_kernel<true, false><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, P);
    else if (zero)
      col3_pass_kernel<false, true><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, P);
    else
      col3_pass_kernel<false, false><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, P);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace mgk3
