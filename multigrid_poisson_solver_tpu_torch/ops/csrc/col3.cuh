// The column pass of the port's 3-D kernels: one damped-Jacobi sweep of the
// 7-point stencil over a level (or a z-shard's planes), the smoothing error
// of an iterate and the residual, with each thread streaming one (y, x)
// column down z. It is the pass of kernel 10 (jacobi3.cu: every mode, one
// launch a sweep; emit_residual adds a residual pass), of the whole-loop
// trigger kernel (trigger3.cu: one pass a sweep between grid barriers), of
// the streamed one (trigger3_stream.cu: passes of B sweeps) and of the ring
// trigger kernel (rdma_trigger3.cu: one pass a sweep per z-shard, its halo
// planes read from and posted to receive buffers through a plane source of
// its own in place of Col3Io below), the sweeps of the 3-D legs
// (descend3.cu, ascend3.cu, whose residual and prolongation passes are
// their own; the residual pass streams its columns through col3_stream) and
// of the ring smoother and ring legs (rdma_jacobi3.cu, rdma_descend3.cu,
// rdma_ascend3.cu, through rdma3.cuh); the residual (residual3.cu) and
// kernel 10's emit_residual mode run col3_residual_unit below. No 3-D
// kernel runs a tile pipeline any more.
//
// Why not a fused tile pipeline: the port's first 3-D kernels fused k sweeps
// into one 2.5-D trapezoid (a tile staged in shared memory with a halo of k,
// one 512-thread block an SM, a barrier after every stage of every plane);
// at 513³ its 7-sweep pass took 5× as long as 7 of these passes, and every
// kernel moved off it (PERF.md). Here a sweep is one pass over memory with
// no barrier inside: a thread keeps planes z − 1, z, z + 1 of its column in
// registers, loads the in-plane neighbours and f directly (through the L1
// in a one-launch kernel, where neighbouring threads' loads hit the same
// lines; through L2 in a persistent one, after a grid barrier), and keeps
// the loads of the next COL3_AHEAD planes in flight.
//
// The error rides on the sweep's own stencil read: the neighbour sum that
// makes u_{s+1} from u_s is also the one of r(u_s) = (1/h²)(Σnb − 6u) − f, so
// a pass gives the clean error of the iterate it reads (ERR_CLEAN) or the gpu
// error Σ|u_{s+1} − u_s| of the one it writes (ERR_GPU), and the clean error
// of a loop's last iterate takes one more pass that writes nothing (or the
// residual pass, which reads the same stencil).
//
// Arithmetic uses the round-to-nearest intrinsics in the plain twins'
// operation order (ops/kernels3.py), so a kernel reproduces its twin bit for
// bit. The error is summed in float64 and rounded to fp32 once, after the
// scale (the twins: torch.sum(·, dtype=float64)), so its value hardly
// depends on the summation order: a trigger loop's stop sweep is the same on
// the kernels, on the twins and on the plain path, where fp32 sums in two
// orders can flip a near-threshold slope after a thousand sweeps.
//
// The contract between the launches of a trigger loop: the error of an
// iterate is summed in float64, per tile of the error plan
// (ops.kernels3.err_plan3: a ty x tx column tile over a z chunk of cz
// planes), thread v of the tile's 512 (THREADS3) taking tile cell v
// (v < ty·tx) down the chunk in z order, then block_sum3's fixed tree over
// the 512 sums; the tile partials in fixed_sum3's order, by a second kernel
// (no atomics in the sum). A tile is split over COL3_QUARTERS blocks of
// COL3_THREADS threads (so that a 65³ level fills the SMs): block q of a
// tile runs the tile's threads q·COL3_THREADS + tid, so each of its warps
// is one of block_sum3's warps and takes that warp's shuffle tree; the
// warps' sums go to the workspace, and the last of the tile's blocks to
// arrive (a counter per tile, never reset within a call) adds them in
// block_sum3's second tree. A partial thus depends on the plan alone, and
// the trigger loops stop on the same sweep whichever launch measured an
// error.
#pragma once

#include "common.cuh"

namespace mgk3 {

using namespace mgk;

constexpr int MAX_STEPS3 = 8;   // sweeps a call (and stencil reads a window holds)
constexpr int MAX_HALO3 = 8;    // halo planes a ring window holds (rdma3.cuh)
// block_sum3's block: 16 warps, one thread per cell of a 512-cell error tile
constexpr int BLOCK3_Y = 16;
constexpr int THREADS3 = BLOCK_X * BLOCK3_Y;

static __device__ __forceinline__ bool inner(int v, int n) { return v >= 1 && v <= n - 2; }

// Fixed-order float64 sum over a (BLOCK_X, BLOCK3_Y) block (xor-shuffle tree
// per warp, then one warp over the per-warp sums); the result is valid in
// thread (0, 0).
static __device__ double block_sum3(double v) {
  __shared__ double warp_sums[BLOCK3_Y];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x == 0) warp_sums[threadIdx.y] = v;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.y == 0) {
    total = threadIdx.x < BLOCK3_Y ? warp_sums[threadIdx.x] : 0.0;
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  return total;
}

// Σ partials[0..count) in a fixed order (thread-strided, then block_sum3),
// valid in thread (0, 0): the second pass of a one-launch error and every
// block of a persistent trigger loop sum alike.
static __device__ double fixed_sum3(const double* partials, int count) {
  double v = 0.0;
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < count; i += THREADS3)
    v += __ldcg(partials + i);
  return block_sum3(v);
}

// The metric from the sum of a row of partials: Σ·scale rounded to fp32 once.
static __device__ __forceinline__ float scaled_error3(double total, double scale) {
  return __double2float_rn(__dmul_rn(total, scale));
}

// Second pass of a one-launch error reduction: block b sums row b of the
// partials (`count` per row) into out[b].
static __global__ void __launch_bounds__(THREADS3)
sum_partials3_kernel(const double* __restrict__ partials, int count, double scale,
                     float* __restrict__ out) {
  const double total = fixed_sum3(partials + (size_t)blockIdx.x * count, count);
  if (threadIdx.x == 0 && threadIdx.y == 0) out[blockIdx.x] = scaled_error3(total, scale);
}

// The same pass for a shard: the raw float64 sums, unscaled, for the caller
// to add over the shards in shard order and scale once.
static __global__ void __launch_bounds__(THREADS3)
sum_partials3_raw_kernel(const double* __restrict__ partials, int count,
                         double* __restrict__ out) {
  const double total = fixed_sum3(partials + (size_t)blockIdx.x * count, count);
  if (threadIdx.x == 0 && threadIdx.y == 0) out[blockIdx.x] = total;
}

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

// FOLD: the closed-form first sweep from u ≡ 0, u_1 = (ω/6)·(−h²f) on the
// interior and 0 on the faces, formed from f at the loads of the sweep that
// reads it (pointwise, so the same float as the closed-form pass writes):
// the constants and which in-plane neighbours of an interior column lie on
// the interior.
struct Col3Fold {
  float w, h2;
  bool ym, yp, xm, xp;
};

static __device__ __forceinline__ float col3_u1(const Col3Fold& fd, float f) {
  return __fmul_rn(fd.w, -__fmul_rn(fd.h2, f));
}

// col3_load of u_1 from f (pointing at the column's cell of the plane; zin:
// the plane is on the interior).
template <bool COHERENT>
static __device__ __forceinline__ void col3_load_fold(Col3Plane& p, const float* __restrict__ f,
                                                      int n, bool cin, bool zin,
                                                      const Col3Fold& fd) {
  p.c = 0.0f;
  if (cin) {
    p.f = col3_ld<COHERENT>(f);
    p.c = zin ? col3_u1(fd, p.f) : 0.0f;
    p.ym = zin && fd.ym ? col3_u1(fd, col3_ld<COHERENT>(f - n)) : 0.0f;
    p.yp = zin && fd.yp ? col3_u1(fd, col3_ld<COHERENT>(f + n)) : 0.0f;
    p.xm = zin && fd.xm ? col3_u1(fd, col3_ld<COHERENT>(f - 1)) : 0.0f;
    p.xp = zin && fd.xp ? col3_u1(fd, col3_ld<COHERENT>(f + 1)) : 0.0f;
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
template <bool COHERENT, bool FOLD = false, class Io, class At>
static __device__ __forceinline__ void col3_stream(const Io& io, int n, size_t pl, size_t col,
                                                   bool cin, int zs, int ze, At&& at,
                                                   const Col3Fold& fd = Col3Fold{}) {
  // slot r holds plane zs + t for t ≡ r (mod COL3_RING); plane p is loaded
  // while p <= ze (plane ze is the last one's z + 1) and p < n; FOLD: the
  // planes of u_1 from f's
  Col3Plane ring[COL3_RING];
  float cm;
  if constexpr (FOLD)
    cm = cin && zs >= 1 && inner(zs - 1, n)
             ? col3_u1(fd, col3_ld<COHERENT>(io.fp(zs - 1, pl) + col))
             : 0.0f;
  else
    cm = cin && zs >= 1 ? col3_ld<COHERENT>(io.up(zs - 1, pl) + col) : 0.0f;
#pragma unroll
  for (int r = 0; r < COL3_AHEAD; ++r)
    if (zs + r <= ze && zs + r < n) {
      if constexpr (FOLD)
        col3_load_fold<COHERENT>(ring[r], io.fp(zs + r, pl) + col, n, cin, inner(zs + r, n),
                                 fd);
      else
        col3_load<COHERENT>(ring[r], io.up(zs + r, pl) + col, io.fp(zs + r, pl) + col, n, cin);
    }
  for (int t0 = 0; t0 < ze - zs; t0 += COL3_RING) {
#pragma unroll
    for (int r = 0; r < COL3_RING; ++r) {
      const int z = zs + t0 + r;
      if (z >= ze) break;
      const int za = z + COL3_AHEAD;  // into the slot plane z − 1 has left
      if (za <= ze && za < n) {
        if constexpr (FOLD)
          col3_load_fold<COHERENT>(ring[(r + COL3_AHEAD) % COL3_RING], io.fp(za, pl) + col, n,
                                   cin, inner(za, n), fd);
        else
          col3_load<COHERENT>(ring[(r + COL3_AHEAD) % COL3_RING], io.up(za, pl) + col,
                              io.fp(za, pl) + col, n, cin);
      }
      at(z, ring[r], cm, ring[(r + 1) % COL3_RING].c);
      cm = ring[r].c;
    }
  }
}

// Column (y, x) over the planes [zs, ze): the sweep into the source's
// written iterate and this thread's error sum over the chunk's planes
// [e0, e1). Face columns and planes are frozen and carry no error. The
// arithmetic is the twins': (Σnb − 6u) as ((((z− + z+) + y−) + y+) + x−) +
// x+, then − 6u; the sweep u + (ω/6)·((Σnb − 6u) − h²f); the residual
// (1/h²)(Σnb − 6u) − f. ZERO: u ≡ 0 is not read, and the sweep is the closed
// form (ω/6)·(−h²f), pointwise, so it is exact on every plane it writes,
// halo planes included; its gpu error is |u_1 − 0|. FOLD: the sweep from
// u_1 (that closed form) without its pass, u_1 formed at the loads from f.
template <bool COHERENT, bool ZERO = false, bool FOLD = false, class Io = Col3Io>
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
  if constexpr (FOLD)
    col3_stream<COHERENT, true>(io, n, pl, col, cin, zs, ze, at,
                                Col3Fold{C.w, C.h2, inner(y - 1, n), inner(y + 1, n),
                                         inner(x - 1, n), inner(x + 1, n)});
  else
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
template <bool COHERENT, bool SHARD, bool ZERO = false, bool FOLD = false, class Io = Col3Io>
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
    if (y < n && x < n)
      acc = col3_walk<COHERENT, ZERO, FOLD>(C, P.err, io, y, x, zs, ze, e0, e1);
  }
  if (P.partials != nullptr) col3_finish(C, P.partials, tile, q, acc);
}

// The same on the call's volumes (Col3Io from the pass's pointers; ZERO:
// the closed-form first sweep, FOLD: the sweep from it, P.src unread).
template <bool COHERENT, bool SHARD, bool ZERO = false, bool FOLD = false>
static __device__ __forceinline__ void col3_unit(const Col3& C, const Col3Pass& P, int unit) {
  const int n = C.n;
  // the inputs' global plane 0 (a shard's windows start at z0 − ext)
  const ptrdiff_t base = SHARD ? -(ptrdiff_t)(C.z0 - C.ext) * n * n : 0;
  const Col3Io io{ZERO || FOLD ? nullptr : P.src + base, C.f + base,
                  P.dst != nullptr ? P.dst + base : nullptr, P.own};
  col3_unit_io<COHERENT, SHARD, ZERO, FOLD>(C, P, unit, io);
}

// Unit `unit` of a residual pass (col3_unit_io's numbering of C's tiles):
// the tile's columns over its z chunk [e0, e1) of the owned planes, r =
// (1/h²)(Σnb − 6u) − f of the iterate u (laid out as the inputs, read on the
// chunk's planes and one a side) into r's owned planes (plane z at
// (z − z0) · n²), negated when negate; +0 on the faces. ERR: the clean error
// of u as well, each column's |r| added in z order into the tile's partial
// (col3_finish), the partial of col3_walk's read-only clean pass bit for
// bit; every thread of the block then reaches col3_finish's barriers.
template <bool ERR>
static __device__ __forceinline__ void col3_residual_unit(const Col3& C,
                                                          const float* __restrict__ u,
                                                          float* __restrict__ r, int negate,
                                                          double* partials, int unit) {
  const int n = C.n, gx = col3_gx(C), gy = col3_gy(C);
  const int tile = unit / COL3_QUARTERS, q = unit - tile * COL3_QUARTERS;
  const int bx = tile % gx, by = (tile / gx) % gy, bz = tile / (gx * gy);
  const int e0 = C.z0 + bz * C.cz, e1 = min(e0 + C.cz, C.z0 + C.nz);
  const int v = q * COL3_THREADS + threadIdx.x;  // the tile's thread (block_sum3's numbering)
  double acc = 0.0;
  if (v < C.ty * C.tx) {
    const int i = v / C.tx;
    const int y = by * C.ty + i, x = bx * C.tx + (v - i * C.tx);
    if (y < n && x < n) {
      const size_t pl = (size_t)n * n, col = (size_t)y * n + x;
      float* const out = r + col - (ptrdiff_t)C.z0 * (ptrdiff_t)pl;  // plane z at z · pl
      if (!(inner(y, n) && inner(x, n))) {
        for (int z = e0; z < e1; ++z) out[z * pl] = 0.0f;
      } else {
        const ptrdiff_t base = -(ptrdiff_t)(C.z0 - C.ext) * (ptrdiff_t)pl;  // the inputs' plane 0
        const Col3Io io{u + base, C.f + base, nullptr, nullptr};
        col3_stream<false>(io, n, pl, col, true, e0, e1,
                           [&](int z, const Col3Plane& p, float cm, float cp) {
                             float d = 0.0f;
                             if (inner(z, n)) {
                               d = __fsub_rn(__fmul_rn(C.inv_h2, col3_lap(p, cm, cp)), p.f);
                               if (ERR) acc += (double)fabsf(d);
                               if (negate) d = -d;
                             }
                             out[z * pl] = d;
                           });
      }
    }
  }
  if constexpr (ERR) col3_finish(C, partials, tile, q, acc);
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

// How col3_passes launches a pass: col3_pass_kernel. A caller whose passes
// should show in a profile under a name of their own (kernel 10's
// emit_residual mode) gives a launcher of the same shape for a kernel with
// the same body; with FOLD it also has launch_fold<SHARD>, the sweep from
// the closed form formed at its loads (col3_unit<..., FOLD>).
struct Col3Launch {
  template <bool SHARD, bool ZERO>
  static void launch(const Col3& C, const Col3Pass& P, cudaStream_t stream) {
    col3_pass_kernel<SHARD, ZERO><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, P);
  }
};

// steps sweeps of u (nullptr: from zero) on the owned planes [z0, z0 + nz)
// of a level (inputs extended by ext planes per side) into it[0] (or, given
// `own`, into its owned planes there; it[0] then holds earlier iterates or
// nothing), it[1] a scratch volume shaped as u (col3_scratch says which the
// call needs), with the errors (ERR_NONE, ERR_CLEAN or ERR_GPU) that `kind`
// names (Col3Rows; rows of one double per tile of the plan): col3_schedule's
// passes, one launch each through L (kernel 10's fixed, per-sweep and
// emit_residual modes, and the sweeps of the legs, whose own passes read
// iterate k on `tail` more planes a side). FOLD, from zero with two sweeps
// or more: no closed-form pass; the next sweep forms it at its loads (so
// iterate 1 is never stored). Returns the tile count in *tiles.
template <class L = Col3Launch, bool FOLD = false>
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
  const bool fold = FOLD && u == nullptr && steps >= 2;
  Col3Pass P;
  for (int j = fold ? 1 : 0; col3_schedule(C, P, j, steps, err_mode, u, it[0], it[1], own,
                                           errors ? partials : nullptr, *tiles, kind, tail);
       ++j) {
    if constexpr (FOLD) {
      if (fold && j == 1) {  // P.src (iterate 1) is not read
        if (shard)
          L::template launch_fold<true>(C, P, stream);
        else
          L::template launch_fold<false>(C, P, stream);
        if ((e = cudaGetLastError()) != cudaSuccess) return e;
        continue;
      }
    }
    const bool zero = P.src == nullptr;
    if (shard && zero)
      L::template launch<true, true>(C, P, stream);
    else if (shard)
      L::template launch<true, false>(C, P, stream);
    else if (zero)
      L::template launch<false, true>(C, P, stream);
    else
      L::template launch<false, false>(C, P, stream);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace mgk3
