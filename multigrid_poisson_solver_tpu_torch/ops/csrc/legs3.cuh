// The tile pipeline of kernel 10's emit_residual mode (jacobi3.cu; the other
// 3-D kernels run the column pass of col3.cuh, which takes this file's
// constants, block_sum3 and fixed_sum3): 2.5-D temporal blocking of the
// 7-point stencil.
//
// Grids are contiguous n x n x n fp32 volumes indexed [z][y][x]. A block owns
// a TY x TX column tile of (y, x) over CZ planes of z (one z chunk) and stages
// it with a halo of H cells in y and x and H planes in z. It marches down z:
// at step t it stores plane t (the starting iterate and f, whose loads were
// issued into registers at step t − 1) in shared memory, then stage s = 1..S
// produces plane t − s of level s from planes t − s − 1 .. t − s + 1 of level
// s − 1. Each level keeps a ring of three planes in shared memory, f a ring of
// S + 1. Stage s works on the staged plane shrunk by s cells per side and on
// the planes at least s from the staged range's ends, so after S stages the
// owned cells are exact with no exchange between blocks: the TPU kernels'
// trapezoidal bricks, with z streamed instead of held. Cells and planes outside
// the grid load as 0; they and the Dirichlet faces are frozen.
//
// Stages: SWEEP (one damped-Jacobi sweep), EXTRA (one more stencil read of
// the final iterate: its −r, which the descend leg restricts, and its clean
// error) and RESID (the residual (1/h²)(Σnb − 6u) − f, optionally negated).
// The residual is the direct stencil, the plain path's own arithmetic (the
// TPU kernels take it from the step Δ of a further sweep as 6Δ/(ωh²)), so a
// cycle on the kernels reproduces the plain cycle's iterates. The clean error
// of an iterate is Σ|r| over the owned interior cells, r in the same
// arithmetic, taken by the stage that reads the iterate (EXTRA).
//
// Arithmetic uses the round-to-nearest intrinsics in the plain twins'
// operation order (ops/kernels3.py), so a kernel reproduces its twin bit for
// bit. The error is summed in float64 and rounded to fp32 once, after the
// scale (the twins: torch.sum(·, dtype=float64)), so its value hardly
// depends on the summation order: a trigger loop's stop sweep is the same on
// the kernels, on the twins and on the plain path, where fp32 sums in two
// orders can flip a near-threshold slope after a thousand sweeps. The
// partials are summed per block, then by a second one-block kernel in a fixed
// order (no atomics). A block's partial depends only on the tile plan (ty,
// tx, cz), not on the pipeline: each thread sums the owned cells idx ≡ tid
// (mod THREADS3) of a plane, the planes in z order, whichever stage produced
// them. So every launch of a trigger loop, which all use one plan
// (ops.kernels3.err_plan3, the deepest per-sweep pass's), reports the error
// of an iterate bit for bit alike: a one-sweep launch here, and the column
// pass of col3.cuh (kernel 10's per_sweep mode and the persistent trigger
// loops trigger3.cu and trigger3_stream.cu), which sums the same cells in
// the same order.
//
// The pipeline is a template on how it reads the grids: the persistent
// kernels read, after a grid barrier, iterates other blocks wrote in the
// same launch, so they load through __ldcg (L2 only); the one-launch
// kernels through the read-only cache.
//
// Shard mode (SHARD = true; pallas3d.py's *_shard_call, reached through
// parallel/pallas_shard3.py): a launch owns the planes [z0, z0 + nz) of a
// z-sharded level, and its inputs are those planes extended by ext planes
// of the ring neighbours per side (zero beyond the grid). Blocks tile the
// owned planes; every mask is by global z, so the Dirichlet faces and the
// closed-form first sweep from zero are exact at the cut planes; only owned
// planes are written, and error partials count owned planes only. With ext
// at least the pipeline's halo, the trapezoid argument that makes a block's
// z cut exact makes the shard cut exact too: owned planes are the unsharded
// launch's bit for bit. The whole grid (z0 = 0, nz = n, ext = 0) launches
// the SHARD = false instantiation, in which the shard geometry folds to
// compile-time constants, with the single-device kernels' arguments. EMIT_R
// (kernel 10's emit_residual mode) stores both the final iterate and its
// residual, the RESID stage after the sweeps.
#pragma once

#include "common.cuh"

namespace mgk3 {

using namespace mgk;

constexpr int MAX_STEPS3 = 8;
constexpr int MAX_HALO3 = 8;
// dynamic shared memory a block may take (227 KB), less the static block_sum3
constexpr size_t SMEM_MAX3 = 232448 - 1024;
// A block is 16 warps: shared memory allows one block of the larger
// pipelines per SM, and its warps hide the latency of the plane loads.
constexpr int BLOCK3_Y = 16;
constexpr int THREADS3 = BLOCK_X * BLOCK3_Y;
// staged cells of a plane each thread holds in registers between the load
// and the store to shared memory (plane <= PREF3 * THREADS3)
constexpr int PREF3 = 6;

enum StageKind { SWEEP = 0, EXTRA = 1, RESID = 2 };
enum RestrictMode { R_NONE = 0, R_SAMPLING = 1, R_FW = 2 };

struct Leg3 {
  const float* u;   // starting iterate; nullptr: from zero, the closed form from f
  const float* f;
  const float* c;   // ascend: the m^3 coarse correction added on the interior
  float* out;       // the stored level: the final iterate, or the residual
  float* r;         // EMIT_R: the residual of the final iterate (out holds the iterate)
  float* fc;        // descend: the m^3 restricted −r
  double* partials; // one error partial per block, or nullptr
  int n;
  int sweeps;       // SWEEP stages
  int last;         // -1, or EXTRA / RESID: one more stage after the sweeps
  int err_mode;     // ERR_NONE, ERR_CLEAN (needs the EXTRA stage) or ERR_GPU
  int restrict_mode;
  int negate;       // RESID: store −r
  int ty, tx, cz, halo;
  float h2, w, inv_h2;  // h², ω/6, 1/h²
};

// The planes a launch owns, [z0, z0 + nz): u and f hold planes [z0 − ext,
// z0 + nz + ext) (local plane 0 is global z0 − ext), c the coarse planes
// [cz0, cz0 + cnz); out and r hold the owned planes, fc the coarse planes
// from z0 / 2 on. Only the shard kernels take it: with these five fields in
// Leg3 (136 bytes against 104), the whole-grid kernels took a 48-byte stack
// frame instead of 16 and ran 14-22% slower (PERF.md §6).
struct Planes3 {
  int z0, nz, ext, cz0, cnz;
};

static __host__ __device__ __forceinline__ int leg3_stages(const Leg3& L) {
  return L.sweeps + (L.last >= 0 ? 1 : 0);
}

// f and S + 1 rings of three planes, f's ring S + 1 planes deep.
static inline size_t leg3_smem(int stages, int halo, int ty, int tx) {
  return (size_t)4 * (stages + 1) * sizeof(float) * (ty + 2 * halo) * (tx + 2 * halo);
}

// A block's column tile and z chunk: (x, y) tile, z chunk.
struct Blk {
  int x, y, z;
};

static __host__ __device__ __forceinline__ int leg3_gx(const Leg3& L) {
  return (L.n + L.tx - 1) / L.tx;
}
static __host__ __device__ __forceinline__ int leg3_gy(const Leg3& L) {
  return (L.n + L.ty - 1) / L.ty;
}
// z chunks over the whole grid, or over nz planes of it
static __host__ __device__ __forceinline__ int leg3_gz(const Leg3& L, int nz) {
  return (nz + L.cz - 1) / L.cz;
}
static __host__ __device__ __forceinline__ int leg3_gz(const Leg3& L) { return leg3_gz(L, L.n); }
static __host__ __device__ __forceinline__ int leg3_blocks(const Leg3& L, int nz) {
  return leg3_gx(L) * leg3_gy(L) * leg3_gz(L, nz);
}
static __host__ __device__ __forceinline__ int leg3_blocks(const Leg3& L) {
  return leg3_blocks(L, L.n);
}

// Block t of the row-major (z, y, x) numbering the partials use.
static __device__ __forceinline__ Blk leg3_blk(const Leg3& L, int t) {
  const int gx = leg3_gx(L), gy = leg3_gy(L);
  return Blk{t % gx, (t / gx) % gy, t / (gx * gy)};
}

static __device__ __forceinline__ size_t gidx3(int n, int z, int y, int x) {
  return ((size_t)z * n + y) * n + x;
}

static __device__ __forceinline__ bool inner(int v, int n) { return v >= 1 && v <= n - 2; }

// The 2:1 trilinear prolongation of the m^3 coarse grid at fine (z, y, x):
// along z, then y, then x, odd points ½·(a + b) (models.poisson3d.prolong3).
// c holds the coarse planes from c0 on.
static __device__ __forceinline__ float pro_z(const float* c, int m, int c0, int z, int I,
                                              int J) {
  const int Z = (z >> 1) - c0;
  const float a = __ldg(c + ((size_t)Z * m + I) * m + J);
  if (!(z & 1)) return a;
  return __fmul_rn(0.5f, __fadd_rn(a, __ldg(c + ((size_t)(Z + 1) * m + I) * m + J)));
}

static __device__ __forceinline__ float pro_zy(const float* c, int m, int c0, int z, int y,
                                               int J) {
  const float a = pro_z(c, m, c0, z, y >> 1, J);
  if (!(y & 1)) return a;
  return __fmul_rn(0.5f, __fadd_rn(a, pro_z(c, m, c0, z, (y >> 1) + 1, J)));
}

static __device__ __forceinline__ float prolong_at(const float* c, int m, int c0, int z, int y,
                                                   int x) {
  const float a = pro_zy(c, m, c0, z, y, x >> 1);
  if (!(x & 1)) return a;
  return __fmul_rn(0.5f, __fadd_rn(a, pro_zy(c, m, c0, z, y, (x >> 1) + 1)));
}

// (Σnb − 6u): ((((z− + z+) + y−) + y+) + x−) + x+, then − 6u.
static __device__ __forceinline__ float lap_sum(const float* a, const float* am,
                                                const float* ap, int k, int cols) {
  const float nb = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(am[k], ap[k]),
                                                           a[k - cols]), a[k + cols]),
                                       a[k - 1]), a[k + 1]);
  return __fsub_rn(nb, __fmul_rn(6.0f, a[k]));
}

// The step a sweep takes at cell k from level a: (ω/6)·((Σnb − 6u) − h²f).
static __device__ __forceinline__ float delta_at(const Leg3& L, const float* a, const float* am,
                                                 const float* ap, const float* fp, int k,
                                                 int cols) {
  return __fmul_rn(L.w, __fsub_rn(lap_sum(a, am, ap, k, cols), __fmul_rn(L.h2, fp[k])));
}

// One stage over the staged plane p shrunk by s cells per side. The EXTRA
// stage writes a plane only for the descend leg (its −r), and then adds the
// owned interior cells' |r| to *err when it is given (the descend leg's error
// is no part of a trigger loop, so the order of its sum need not be
// err_plane's); every other error is taken by err_plane.
static __device__ void run_stage(const Leg3& L, int kind, int s, int p, const float* a,
                                 const float* am, const float* ap, const float* fp, float* o,
                                 int rows, int cols, int gr0, int gc0, double* err) {
  if (kind == EXTRA && L.restrict_mode == R_NONE) return;
  const int n = L.n, H = L.halo;
  const int cw = cols - 2 * s, total = (rows - 2 * s) * cw;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const bool zin = inner(p, n);
  int i = s + tid / cw, j = s + tid % cw;
  const int di = THREADS3 / cw, dj = THREADS3 % cw;
  for (int idx = tid; idx < total; idx += THREADS3) {
    const int k = i * cols + j;
    const int gi = gr0 + i, gj = gc0 + j;
    const bool in = zin && inner(gi, n) && inner(gj, n);
    float v;
    if (kind == SWEEP) {
      v = a[k];
      if (in) {
        const float incr = __fsub_rn(lap_sum(a, am, ap, k, cols), __fmul_rn(L.h2, fp[k]));
        v = __fadd_rn(v, __fmul_rn(L.w, incr));
      }
    } else if (kind == EXTRA) {  // −r of the final iterate
      v = 0.0f;
      if (in) {
        v = -__fsub_rn(__fmul_rn(L.inv_h2, lap_sum(a, am, ap, k, cols)), fp[k]);
        if (err != nullptr && i >= H && i < H + L.ty && j >= H && j < H + L.tx)
          *err += (double)fabsf(v);
      }
    } else {  // RESID
      v = 0.0f;
      if (in) {
        v = __fsub_rn(__fmul_rn(L.inv_h2, lap_sum(a, am, ap, k, cols)), fp[k]);
        if (L.negate) v = -v;
      }
    }
    o[k] = v;
    j += dj;
    i += di;
    if (j >= s + cw) {
      j -= cw;
      ++i;
    }
  }
}

// This thread's share of the error of the iterate held in level a, over the
// owned interior cells of plane p (cells idx ≡ tid, in order): Σ|r| (clean;
// r = (1/h²)(Σnb − 6u) − f, the plain path's residual) or Σ|u' − u| of the
// sweep from a (gpu; u' = u + Δ as the SWEEP stage forms it).
static __device__ double err_plane(const Leg3& L, int p, const float* a, const float* am,
                                   const float* ap, const float* fp, int cols, int gr0,
                                   int gc0) {
  const int n = L.n, H = L.halo;
  double e = 0.0;
  if (!inner(p, n)) return e;
  for (int idx = threadIdx.y * BLOCK_X + threadIdx.x; idx < L.ty * L.tx; idx += THREADS3) {
    const int i = H + idx / L.tx, j = H + idx % L.tx;
    if (!inner(gr0 + i, n) || !inner(gc0 + j, n)) continue;
    const int k = i * cols + j;
    float v;
    if (L.err_mode == ERR_GPU)
      v = __fsub_rn(__fadd_rn(a[k], delta_at(L, a, am, ap, fp, k, cols)), a[k]);
    else
      v = __fsub_rn(__fmul_rn(L.inv_h2, lap_sum(a, am, ap, k, cols)), fp[k]);
    e += (double)fabsf(v);
  }
  return e;
}

// A grid value: through L2 only in a persistent kernel, else the read-only cache.
template <bool COHERENT>
static __device__ __forceinline__ float load_grid(const float* p) {
  return COHERENT ? __ldcg(p) : __ldg(p);
}

// Coarse plane K of the descend leg from the −r planes 2K − 1 .. 2K + 1 (the
// ring of the EXTRA stage): full weighting along z, then y, then x, or the
// even fine point; 0 on the coarse boundary. Covers block b's coarse tile;
// fc holds the coarse planes from fc0 on.
static __device__ void restrict_plane(const Leg3& L, const Blk& b, int K, int fc0,
                                      const float* rm, const float* r0, const float* rp,
                                      int cols) {
  const int n = L.n, m = (n + 1) / 2, H = L.halo;
  const int cty = L.ty / 2, ctx = L.tx / 2;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  for (int idx = tid; idx < cty * ctx; idx += THREADS3) {
    const int ci = idx / ctx, cj = idx - ci * ctx;
    const int I = b.y * cty + ci, J = b.x * ctx + cj;
    if (I >= m || J >= m) continue;
    float v = 0.0f;
    if (inner(K, m) && inner(I, m) && inner(J, m)) {
      const int k = (H + 2 * ci) * cols + H + 2 * cj;
      if (L.restrict_mode == R_FW) {
        float sy[3];
        for (int dx = -1; dx <= 1; ++dx) {
          float sz[3];
          for (int dy = -1; dy <= 1; ++dy) {
            const int kk = k + dy * cols + dx;
            sz[dy + 1] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, rm[kk]), __fmul_rn(0.5f, r0[kk])),
                                   __fmul_rn(0.25f, rp[kk]));
          }
          sy[dx + 1] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, sz[0]), __fmul_rn(0.5f, sz[1])),
                                 __fmul_rn(0.25f, sz[2]));
        }
        v = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, sy[0]), __fmul_rn(0.5f, sy[1])),
                      __fmul_rn(0.25f, sy[2]));
      } else {
        v = r0[k];
      }
    }
    L.fc[gidx3(m, K - fc0, I, J)] = v;
  }
}

// Fixed-order float64 sum over the block (xor-shuffle tree per warp, then one
// warp over the per-warp sums); the result is valid in thread (0, 0).
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

// Issue the device-memory loads of staged plane t (u and f; 0 outside the
// grid) into registers. They are consumed by store_plane one pipeline step
// later, so their latency overlaps the stages in between.
template <bool COHERENT, bool SHARD>
static __device__ __forceinline__ void fetch_plane(const Leg3& L, const Planes3& P, int t,
                                                   int cols, int plane, int gr0, int gc0,
                                                   float (&ru)[PREF3], float (&rf)[PREF3]) {
  const int n = L.n;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const int in0 = SHARD ? P.z0 - P.ext : 0;  // global plane of the inputs' plane 0
  const bool zin =
      t >= 0 && t < n && (!SHARD || (t >= in0 && t < P.z0 + P.nz + P.ext));
#pragma unroll
  for (int q = 0; q < PREF3; ++q) {
    const int idx = tid + q * THREADS3;
    const int i = idx / cols, j = idx - i * cols;
    const int gi = gr0 + i, gj = gc0 + j;
    float fv = 0.0f, uv = 0.0f;
    if (idx < plane && zin && gi >= 0 && gi < n && gj >= 0 && gj < n) {
      const size_t g = gidx3(n, t - in0, gi, gj);
      fv = load_grid<COHERENT>(L.f + g);
      if (L.u != nullptr) uv = load_grid<COHERENT>(L.u + g);
    }
    ru[q] = uv;
    rf[q] = fv;
  }
}

// The starting iterate and f of staged plane t into shared memory: u (plus
// the prolonged coarse correction on the interior, for the ascend leg), or
// from u ≡ 0 the closed-form first sweep (ω/6)·(−h²f) on the interior.
template <bool SHARD>
static __device__ __forceinline__ void store_plane(const Leg3& L, const Planes3& P, int t,
                                                   int cols, int plane, int gr0, int gc0,
                                                   const float (&ru)[PREF3],
                                                   const float (&rf)[PREF3], float* u0,
                                                   float* fp) {
  const int n = L.n, m = (n + 1) / 2;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
#pragma unroll
  for (int q = 0; q < PREF3; ++q) {
    const int idx = tid + q * THREADS3;
    if (idx >= plane) break;
    const int i = idx / cols, j = idx - i * cols;
    const int gi = gr0 + i, gj = gc0 + j;
    float uv = ru[q];
    if (inner(t, n) && inner(gi, n) && inner(gj, n)) {
      if (L.u == nullptr)
        uv = __fmul_rn(L.w, -__fmul_rn(L.h2, rf[q]));
      else if (L.c != nullptr)
        uv = __fadd_rn(uv, prolong_at(L.c, m, SHARD ? P.cz0 : 0, t, gi, gj));
    }
    u0[idx] = uv;
    fp[idx] = rf[q];
  }
}

// The whole leg of block b (of leg3_blocks(L), or of leg3_blocks(L, P.nz)
// with SHARD); the error partial goes to L.partials[the block's number]
// (the clean error from the EXTRA stage, the gpu one from the stored
// level); COHERENT: a persistent kernel; SHARD: the launch owns P's planes, not
// the whole grid (P is not read otherwise); EMIT_R: the final iterate to out
// and the RESID stage's residual to r.
template <bool COHERENT, bool SHARD = false, bool EMIT_R = false>
static __device__ void run_leg3_at(float* smem, const Leg3& L, const Planes3& P, const Blk& b) {
  const int n = L.n, H = L.halo;
  const int rows = L.ty + 2 * H, cols = L.tx + 2 * H, plane = rows * cols;
  const int gr0 = b.y * L.ty - H, gc0 = b.x * L.tx - H;
  const int zlo = SHARD ? P.z0 : 0, zhi = SHARD ? P.z0 + P.nz : n;  // the launch's planes
  const int z0 = zlo + b.z * L.cz, zo_end = min(z0 + L.cz, zhi);    // owned planes
  const int zs = z0 - H, ze = (SHARD ? zo_end : z0 + L.cz) + H;      // staged planes
  const int S = leg3_stages(L);
  const int stored = L.last == RESID && !EMIT_R ? S : L.sweeps;     // level written to out
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  float* const fring = smem + (size_t)3 * (S + 1) * plane;
  auto ring = [&](int level, int p) -> float* {
    return smem + (size_t)(level * 3 + (p - zs) % 3) * plane;
  };
  auto fpl = [&](int p) -> float* { return fring + (size_t)((p - zs) % (S + 1)) * plane; };
  double acc = 0.0;
  const bool gpu_stored = L.partials != nullptr && L.err_mode == ERR_GPU;
  float ru[PREF3], rf[PREF3];  // plane t's loads, in flight during step t − 1
  __syncthreads();             // the block's previous leg is done with smem
  fetch_plane<COHERENT, SHARD>(L, P, zs, cols, plane, gr0, gc0, ru, rf);

  for (int t = zs; t < ze + S; ++t) {
    // stage plane t; its ring slots last held planes the previous step
    // finished with
    if (t < ze)
      store_plane<SHARD>(L, P, t, cols, plane, gr0, gc0, ru, rf, ring(0, t), fpl(t));
    __syncthreads();
    if (t + 1 < ze)
      fetch_plane<COHERENT, SHARD>(L, P, t + 1, cols, plane, gr0, gc0, ru, rf);
    for (int s = 1; s <= S; ++s) {
      const int p = t - s;
      if (p >= zs + s && p < ze - s) {
        const int kind = s <= L.sweeps ? SWEEP : L.last;
        const float *a = ring(s - 1, p), *am = ring(s - 1, p - 1), *ap = ring(s - 1, p + 1);
        const bool own_err = L.partials != nullptr && L.err_mode == ERR_CLEAN && s == S &&
                             p >= z0 && p < zo_end;
        const bool in_stage = own_err && kind == EXTRA && L.restrict_mode != R_NONE;
        double e = 0.0;
        run_stage(L, kind, s, p, a, am, ap, fpl(p), ring(s, p), rows, cols, gr0, gc0,
                  in_stage ? &e : nullptr);
        if (own_err) {
          if (!in_stage) e = err_plane(L, p, a, am, ap, fpl(p), cols, gr0, gc0);
          acc += e;
        }
      }
      __syncthreads();
    }
    // the owned cells of the stored level's plane q (and the gpu error)
    const int q = t - stored;
    if (q >= z0 && q < zo_end) {
      const float* src = ring(stored, q);
      const float* prev = stored >= 1 ? ring(stored - 1, q) : nullptr;
      double e = 0.0;
      for (int idx = tid; idx < L.ty * L.tx; idx += THREADS3) {
        const int i = H + idx / L.tx, j = H + idx % L.tx;
        const int gi = gr0 + i, gj = gc0 + j;
        if (gi >= n || gj >= n) continue;
        const int k = i * cols + j;
        L.out[gidx3(n, q - zlo, gi, gj)] = src[k];
        if (gpu_stored && inner(q, n) && inner(gi, n) && inner(gj, n))
          e += (double)fabsf(prev ? __fsub_rn(src[k], prev[k]) : src[k]);
      }
      acc += e;
    }
    // EMIT_R: the owned cells of the residual's plane
    const int qr = t - S;
    if (EMIT_R && qr >= z0 && qr < zo_end) {
      const float* src = ring(S, qr);
      for (int idx = tid; idx < L.ty * L.tx; idx += THREADS3) {
        const int i = H + idx / L.tx, j = H + idx % L.tx;
        const int gi = gr0 + i, gj = gc0 + j;
        if (gi >= n || gj >= n) continue;
        L.r[gidx3(n, qr - zlo, gi, gj)] = src[i * cols + j];
      }
    }
    // a coarse plane once its fine planes 2K − 1 .. 2K + 1 are in the ring
    if (L.restrict_mode != R_NONE) {
      const int p = t - S;
      const int K = L.restrict_mode == R_FW ? (p - 1) >> 1 : p >> 1;
      const bool ready = L.restrict_mode == R_FW ? (p & 1) : !(p & 1);
      if (ready && 2 * K >= z0 && 2 * K < zo_end)
        restrict_plane(L, b, K, zlo >> 1, ring(S, 2 * K - 1), ring(S, 2 * K), ring(S, 2 * K + 1),
                       cols);
    }
    __syncthreads();
  }
  if (L.partials != nullptr) {
    const double total = block_sum3(acc);
    if (tid == 0) L.partials[(b.z * leg3_gy(L) + b.y) * leg3_gx(L) + b.x] = total;
  }
}

// The leg of the block of a one-launch grid (launch_leg3).
template <bool SHARD = false, bool EMIT_R = false>
static __device__ __forceinline__ void run_leg3(float* smem, const Leg3& L, const Planes3& P) {
  run_leg3_at<false, SHARD, EMIT_R>(smem, L, P,
                                          Blk{(int)blockIdx.x, (int)blockIdx.y, (int)blockIdx.z});
}

// Whether a launch owns the whole grid through unextended inputs (the
// SHARD = false instantiation).
static inline bool leg3_is_whole(const Leg3& L, const Planes3& P) {
  return P.z0 == 0 && P.nz == L.n && P.ext == 0 &&
         (L.c == nullptr || (P.cz0 == 0 && P.cnz == (L.n + 1) / 2));
}

// The geometry checks of every launch of the pipeline, over the planes P:
// cudaSuccess or cudaErrorInvalidValue.
static inline cudaError_t check_leg3(const Leg3& L, const Planes3& P) {
  const int S = leg3_stages(L);
  if (L.n < 3 || L.ty < 2 || L.tx < 2 || L.cz < 2 || ((L.ty | L.tx | L.cz) & 1) ||
      L.halo < S || L.halo > MAX_HALO3 || S > MAX_STEPS3 + 1 ||
      (L.ty + 2 * L.halo) * (L.tx + 2 * L.halo) > PREF3 * THREADS3 ||
      leg3_smem(S, L.halo, L.ty, L.tx) > SMEM_MAX3)
    return cudaErrorInvalidValue;
  // the planes: owned ones inside the grid, inputs holding every plane the
  // owned ones depend on (halo planes each side, or up to the grid's faces)
  const int lo = P.z0 - L.halo > 0 ? P.z0 - L.halo : 0;
  const int hi = P.z0 + P.nz + L.halo < L.n ? P.z0 + P.nz + L.halo : L.n;
  if (P.nz < 1 || P.z0 < 0 || P.z0 + P.nz > L.n || P.ext < 0 || P.z0 - P.ext > lo ||
      P.z0 + P.nz + P.ext < hi)
    return cudaErrorInvalidValue;
  // the coarse planes the staged interior planes [flo, fhi] prolong from
  if (L.c != nullptr) {
    const int flo = lo > 1 ? lo : 1, fhi = hi - 1 < L.n - 2 ? hi - 1 : L.n - 2;
    if (flo <= fhi && (P.cz0 > (flo >> 1) || P.cz0 + P.cnz <= ((fhi + 1) >> 1)))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// Launch the leg over its blocks: `whole` (the SHARD = false instantiation,
// with the single-device kernels' argument list) when it owns the whole grid
// through unextended inputs, else `shard` over the planes P; the geometry is
// validated here.
static inline cudaError_t launch_leg3(void (*whole)(Leg3), void (*shard)(Leg3, Planes3),
                                      const Leg3& L, const Planes3& P, cudaStream_t stream) {
  cudaError_t e = check_leg3(L, P);
  if (e != cudaSuccess) return e;
  const bool is_whole = leg3_is_whole(L, P);
  const size_t smem = leg3_smem(leg3_stages(L), L.halo, L.ty, L.tx);
  e = is_whole ? cudaFuncSetAttribute(whole, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem)
               : cudaFuncSetAttribute(shard, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(leg3_gx(L), leg3_gy(L), leg3_gz(L, P.nz)), block(BLOCK_X, BLOCK3_Y);
  if (is_whole)
    whole<<<grid, block, smem, stream>>>(L);
  else
    shard<<<grid, block, smem, stream>>>(L, P);
  return cudaGetLastError();
}

}  // namespace mgk3
