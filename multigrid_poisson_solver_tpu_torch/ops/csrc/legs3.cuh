// The tile pipeline of the port's 3-D stencil kernels (jacobi3.cu, descend3.cu,
// ascend3.cu, residual3.cu): 2.5-D temporal blocking of the 7-point stencil.
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
// Stages: SWEEP (one damped-Jacobi sweep), DELTA (read by the final iterate:
// the step Δ = (ω/6)·((Σnb − 6u) − h²f) a further sweep would take, whose
// Σ|Δ| over the owned interior cells is the clean error up to the factor
// 6/(ωh²), the TPU kernels' extra-sweep identity; and −r, which the descend
// leg restricts) and RESID (the residual (1/h²)(Σnb − 6u) − f, optionally
// negated). −r is the direct stencil, the plain path's own arithmetic, so a
// cycle on the kernels reproduces the plain cycle's iterates.
//
// Arithmetic uses the round-to-nearest intrinsics in the plain twins'
// operation order (ops/kernels3.py), so a kernel reproduces its twin bit for
// bit; the error partials are summed per block, then by a second one-block
// kernel in a fixed order (no atomics).
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

enum StageKind { SWEEP = 0, DELTA = 1, RESID = 2 };
enum RestrictMode { R_NONE = 0, R_SAMPLING = 1, R_FW = 2 };

struct Leg3 {
  const float* u;   // starting iterate; nullptr: from zero, the closed form from f
  const float* f;
  const float* c;   // ascend: the m^3 coarse correction added on the interior
  float* out;       // the stored level: the final iterate, or the residual
  float* fc;        // descend: the m^3 restricted −r
  float* partials;  // one error partial per block, or nullptr
  int n;
  int sweeps;       // SWEEP stages
  int last;         // -1, or DELTA / RESID: one more stage after the sweeps
  int err_mode;     // ERR_NONE, ERR_CLEAN (needs the DELTA stage) or ERR_GPU
  int restrict_mode;
  int negate;       // RESID: store −r
  int ty, tx, cz, halo;
  float h2, w, inv_h2;  // h², ω/6, 1/h²
};

static __host__ __device__ __forceinline__ int leg3_stages(const Leg3& L) {
  return L.sweeps + (L.last >= 0 ? 1 : 0);
}

// f and S + 1 rings of three planes, f's ring S + 1 planes deep.
static inline size_t leg3_smem(int stages, int halo, int ty, int tx) {
  return (size_t)4 * (stages + 1) * sizeof(float) * (ty + 2 * halo) * (tx + 2 * halo);
}

static __device__ __forceinline__ size_t gidx3(int n, int z, int y, int x) {
  return ((size_t)z * n + y) * n + x;
}

static __device__ __forceinline__ bool inner(int v, int n) { return v >= 1 && v <= n - 2; }

// The 2:1 trilinear prolongation of the m^3 coarse grid c at fine (z, y, x):
// along z, then y, then x, odd points ½·(a + b) (models.poisson3d.prolong3).
static __device__ __forceinline__ float pro_z(const float* c, int m, int z, int I, int J) {
  const int Z = z >> 1;
  const float a = __ldg(c + ((size_t)Z * m + I) * m + J);
  if (!(z & 1)) return a;
  return __fmul_rn(0.5f, __fadd_rn(a, __ldg(c + ((size_t)(Z + 1) * m + I) * m + J)));
}

static __device__ __forceinline__ float pro_zy(const float* c, int m, int z, int y, int J) {
  const float a = pro_z(c, m, z, y >> 1, J);
  if (!(y & 1)) return a;
  return __fmul_rn(0.5f, __fadd_rn(a, pro_z(c, m, z, (y >> 1) + 1, J)));
}

static __device__ __forceinline__ float prolong_at(const float* c, int m, int z, int y, int x) {
  const float a = pro_zy(c, m, z, y, x >> 1);
  if (!(x & 1)) return a;
  return __fmul_rn(0.5f, __fadd_rn(a, pro_zy(c, m, z, y, (x >> 1) + 1)));
}

// (Σnb − 6u): ((((z− + z+) + y−) + y+) + x−) + x+, then − 6u.
static __device__ __forceinline__ float lap_sum(const float* a, const float* am,
                                                const float* ap, int k, int cols) {
  const float nb = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(am[k], ap[k]),
                                                           a[k - cols]), a[k + cols]),
                                       a[k - 1]), a[k + 1]);
  return __fsub_rn(nb, __fmul_rn(6.0f, a[k]));
}

// One stage over the staged plane p shrunk by s cells per side.
static __device__ void run_stage(const Leg3& L, int kind, int s, int p, const float* a,
                                 const float* am, const float* ap, const float* fp, float* o,
                                 int rows, int cols, int gr0, int gc0, bool zown, float& acc) {
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
    } else if (kind == DELTA) {
      v = 0.0f;
      if (in) {
        const float lap = lap_sum(a, am, ap, k, cols);
        if (L.err_mode == ERR_CLEAN && zown && i >= H && i < H + L.ty && j >= H &&
            j < H + L.tx)
          acc += fabsf(__fmul_rn(L.w, __fsub_rn(lap, __fmul_rn(L.h2, fp[k]))));
        if (L.restrict_mode != R_NONE) v = -__fsub_rn(__fmul_rn(L.inv_h2, lap), fp[k]);
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

// Coarse plane K of the descend leg from the −r planes 2K − 1 .. 2K + 1 (the
// ring of the DELTA stage): full weighting along z, then y, then x, or the
// even fine point; 0 on the coarse boundary. Covers the block's coarse tile.
static __device__ void restrict_plane(const Leg3& L, int K, const float* rm, const float* r0,
                                      const float* rp, int cols) {
  const int n = L.n, m = (n + 1) / 2, H = L.halo;
  const int cty = L.ty / 2, ctx = L.tx / 2;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  for (int idx = tid; idx < cty * ctx; idx += THREADS3) {
    const int ci = idx / ctx, cj = idx - ci * ctx;
    const int I = blockIdx.y * cty + ci, J = blockIdx.x * ctx + cj;
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
    L.fc[gidx3(m, K, I, J)] = v;
  }
}

// Fixed-order sum over the block (xor-shuffle tree per warp, then one warp
// over the per-warp sums); the result is valid in thread (0, 0).
static __device__ float block_sum3(float v) {
  __shared__ float warp_sums[BLOCK3_Y];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x == 0) warp_sums[threadIdx.y] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.y == 0) {
    total = threadIdx.x < BLOCK3_Y ? warp_sums[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  return total;
}

// Issue the device-memory loads of staged plane t (u and f; 0 outside the
// grid) into registers. They are consumed by store_plane one pipeline step
// later, so their latency overlaps the stages in between.
static __device__ __forceinline__ void fetch_plane(const Leg3& L, int t, int cols, int plane,
                                                   int gr0, int gc0, float (&ru)[PREF3],
                                                   float (&rf)[PREF3]) {
  const int n = L.n;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  const bool zin = t >= 0 && t < n;
#pragma unroll
  for (int q = 0; q < PREF3; ++q) {
    const int idx = tid + q * THREADS3;
    const int i = idx / cols, j = idx - i * cols;
    const int gi = gr0 + i, gj = gc0 + j;
    float fv = 0.0f, uv = 0.0f;
    if (idx < plane && zin && gi >= 0 && gi < n && gj >= 0 && gj < n) {
      const size_t g = gidx3(n, t, gi, gj);
      fv = __ldg(L.f + g);
      if (L.u != nullptr) uv = __ldg(L.u + g);
    }
    ru[q] = uv;
    rf[q] = fv;
  }
}

// The starting iterate and f of staged plane t into shared memory: u (plus
// the prolonged coarse correction on the interior, for the ascend leg), or
// from u ≡ 0 the closed-form first sweep (ω/6)·(−h²f) on the interior.
static __device__ __forceinline__ void store_plane(const Leg3& L, int t, int cols, int plane,
                                                   int gr0, int gc0, const float (&ru)[PREF3],
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
        uv = __fadd_rn(uv, prolong_at(L.c, m, t, gi, gj));
    }
    u0[idx] = uv;
    fp[idx] = rf[q];
  }
}

// The whole leg of block (blockIdx.x, blockIdx.y, blockIdx.z).
static __device__ void run_leg3(float* smem, const Leg3& L) {
  const int n = L.n, H = L.halo, m = (n + 1) / 2;
  const int rows = L.ty + 2 * H, cols = L.tx + 2 * H, plane = rows * cols;
  const int gr0 = blockIdx.y * L.ty - H, gc0 = blockIdx.x * L.tx - H;
  const int z0 = blockIdx.z * L.cz, zo_end = min(z0 + L.cz, n);  // owned planes
  const int zs = z0 - H, ze = z0 + L.cz + H;                      // staged planes
  const int S = leg3_stages(L);
  const int stored = L.last == RESID ? S : L.sweeps;              // level written to out
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  float* const fring = smem + (size_t)3 * (S + 1) * plane;
  auto ring = [&](int level, int p) -> float* {
    return smem + (size_t)(level * 3 + (p - zs) % 3) * plane;
  };
  auto fpl = [&](int p) -> float* { return fring + (size_t)((p - zs) % (S + 1)) * plane; };
  float acc = 0.0f;
  float ru[PREF3], rf[PREF3];  // plane t's loads, in flight during step t − 1
  fetch_plane(L, zs, cols, plane, gr0, gc0, ru, rf);

  for (int t = zs; t < ze + S; ++t) {
    // stage plane t; its ring slots last held planes the previous step
    // finished with
    if (t < ze) store_plane(L, t, cols, plane, gr0, gc0, ru, rf, ring(0, t), fpl(t));
    __syncthreads();
    if (t + 1 < ze) fetch_plane(L, t + 1, cols, plane, gr0, gc0, ru, rf);
    for (int s = 1; s <= S; ++s) {
      const int p = t - s;
      if (p >= zs + s && p < ze - s) {
        const int kind = s <= L.sweeps ? SWEEP : L.last;
        run_stage(L, kind, s, p, ring(s - 1, p), ring(s - 1, p - 1), ring(s - 1, p + 1), fpl(p),
                  ring(s, p), rows, cols, gr0, gc0, p >= z0 && p < zo_end, acc);
      }
      __syncthreads();
    }
    // the owned cells of the stored level's plane q (and the gpu error)
    const int q = t - stored;
    if (q >= z0 && q < zo_end) {
      const float* src = ring(stored, q);
      const float* prev = stored >= 1 ? ring(stored - 1, q) : nullptr;
      for (int idx = tid; idx < L.ty * L.tx; idx += THREADS3) {
        const int i = H + idx / L.tx, j = H + idx % L.tx;
        const int gi = gr0 + i, gj = gc0 + j;
        if (gi >= n || gj >= n) continue;
        const int k = i * cols + j;
        L.out[gidx3(n, q, gi, gj)] = src[k];
        if (L.err_mode == ERR_GPU && inner(q, n) && inner(gi, n) && inner(gj, n))
          acc += fabsf(prev ? __fsub_rn(src[k], prev[k]) : src[k]);
      }
    }
    // a coarse plane once its fine planes 2K − 1 .. 2K + 1 are in the ring
    if (L.restrict_mode != R_NONE) {
      const int p = t - S;
      const int K = L.restrict_mode == R_FW ? (p - 1) >> 1 : p >> 1;
      const bool ready = L.restrict_mode == R_FW ? (p & 1) : !(p & 1);
      if (ready && 2 * K >= z0 && 2 * K < zo_end)
        restrict_plane(L, K, ring(S, 2 * K - 1), ring(S, 2 * K), ring(S, 2 * K + 1), cols);
    }
    __syncthreads();
  }
  if (L.partials != nullptr) {
    const float total = block_sum3(acc);
    if (tid == 0)
      L.partials[(size_t)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = total;
  }
}

// Launch `kernel` over the leg's blocks; the geometry is validated here.
static inline cudaError_t launch_leg3(void (*kernel)(Leg3), const Leg3& L, cudaStream_t stream) {
  const int S = leg3_stages(L);
  if (L.n < 3 || L.ty < 2 || L.tx < 2 || L.cz < 2 || ((L.ty | L.tx | L.cz) & 1) ||
      L.halo < S || L.halo > MAX_HALO3 || S > MAX_STEPS3 + 1 ||
      (L.ty + 2 * L.halo) * (L.tx + 2 * L.halo) > PREF3 * THREADS3)
    return cudaErrorInvalidValue;
  const size_t smem = leg3_smem(S, L.halo, L.ty, L.tx);
  if (smem > SMEM_MAX3) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((L.n + L.tx - 1) / L.tx, (L.n + L.ty - 1) / L.ty, (L.n + L.cz - 1) / L.cz);
  kernel<<<grid, dim3(BLOCK_X, BLOCK3_Y), smem, stream>>>(L);
  return cudaGetLastError();
}

static inline int leg3_blocks(const Leg3& L) {
  return ((L.n + L.tx - 1) / L.tx) * ((L.n + L.ty - 1) / L.ty) * ((L.n + L.cz - 1) / L.cz);
}

// Sum the block partials in a fixed order and scale them into err_out[0].
static inline cudaError_t finish_error3(const Leg3& L, float scale, float* err_out,
                                        cudaStream_t stream) {
  if (L.partials == nullptr) return cudaSuccess;
  return launch_error_sum(L.partials, leg3_blocks(L), scale, err_out, stream);
}

}  // namespace mgk3
