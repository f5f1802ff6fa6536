// Fused multi-sweep damped-Jacobi smoother for the 7-point stencil, with an
// optional fused smoothing error, of the final iterate or of every iterate.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _fused_jacobi3_kernel (its plain, from_zero, clean, gpu and per_sweep
// modes), reached through fused_jacobi3_padded and fused_jacobi3_errs_padded.
//
// Bound: device-memory bandwidth. One unfused fp32 sweep reads u and f and
// writes u, 12 B per point; k <= 8 sweeps in one pass move the same 12 B for
// all k. Design: 2.5-D temporal blocking (legs3.cuh). A block owns a column
// tile of (y, x) over a chunk of z planes, stages it with a halo of k (+1 for
// the clean error's extra stencil read) and streams z through rings of three planes
// per sweep level in shared memory, so only the owned cells go back to device
// memory. The cost is redundant work on the halo rings, which the largest
// tile that fits shared memory keeps small. from_zero: the starting iterate is
// the closed-form first sweep (ω/6)·(−h²f) and u is never read. The clean
// error is Σ|r|/n³ with r the plain path's residual (the TPU kernel takes it
// from the step Δ of one more sweep as 6Δ/(ωh²)); the gpu error
// Σ|u_k − u_{k−1}|·6/h²/n³. Per-block partials are summed in float64 by a
// second kernel in a fixed order.
//
// per_sweep (the trigger loop's batched passes, mg3_jacobi_errs): the error
// of every iterate u_1..u_k in the same pass, k <= 7 (clean) or 8 (gpu). The
// clean error of u_s is taken by the stage that reads u_s (sweep s + 1; the
// EXTRA stage for u_k), the gpu error of u_s by sweep s, which forms u_s and
// has u_{s−1} at hand. Each stage adds its owned cells to its own
// row of partials (k rows of one double per block), in the order every error
// launch of the same tile plan uses, so row s − 1 sums to what a launch of s
// sweeps reports. Bound: the same 12 B per point as k unfused sweeps' one;
// at 513³, 7 sweeps, 3 grids of 540 MB in 0.48 ms at 3.35 TB/s.
//
// Shard mode (pallas3d.py, _fused_jacobi3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_fused_jacobi3, _err, _errs and
// sharded_smooth_residual3): every mode above on one z-shard's planes of a
// sharded level (legs3.cuh, SHARD), the inputs the owned planes extended by
// the ring neighbours' planes; a shard's errors come back as raw float64
// sums over its owned planes, for the caller to add in shard order and scale
// once. The emit_residual mode (mg3_jacobi_residual_shard: k <= 7 effective
// sweeps, then the optionally negated residual of the last iterate, both
// stored from one pass; on the whole grid, fused_jacobi3_residual_padded)
// saves the separate residual pass's re-read of u and f: 16 B per point for
// both outputs against 24 B as two passes.
#include "legs3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) jacobi3_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3(smem, L, Planes3{});
}

static __global__ void __launch_bounds__(THREADS3)
jacobi3_shard_kernel(Leg3 L, Planes3 P) {
  extern __shared__ float smem[];
  run_leg3<1, true>(smem, L, P);
}

static __global__ void __launch_bounds__(THREADS3) jacobi3_errs_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3<MAX_STEPS3>(smem, L, Planes3{});
}

static __global__ void __launch_bounds__(THREADS3)
jacobi3_errs_shard_kernel(Leg3 L, Planes3 P) {
  extern __shared__ float smem[];
  run_leg3<MAX_STEPS3, true>(smem, L, P);
}

static __global__ void __launch_bounds__(THREADS3) jacobi3_residual_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3<1, false, true>(smem, L, Planes3{});
}

static __global__ void __launch_bounds__(THREADS3)
jacobi3_residual_shard_kernel(Leg3 L, Planes3 P) {
  extern __shared__ float smem[];
  run_leg3<1, true, true>(smem, L, P);
}

// The sweeps' leg: steps sweeps of u (unread when from_zero) into out, with
// an ERR_NONE, ERR_CLEAN (effective sweeps <= 7) or ERR_GPU error.
static bool jacobi3_leg(Leg3& L, const float* u, const float* f, float* out, double* partials,
                        int steps, int from_zero, int err_mode, int ty, int tx, int cz, float h2,
                        float w, float inv_h2) {
  if (steps < 1 || steps > MAX_STEPS3 ||
      (err_mode != ERR_NONE && err_mode != ERR_CLEAN && err_mode != ERR_GPU))
    return false;
  L.u = from_zero ? nullptr : u;
  L.f = f;
  L.out = out;
  L.partials = err_mode == ERR_NONE ? nullptr : partials;
  L.sweeps = steps - (from_zero ? 1 : 0);
  L.last = err_mode == ERR_CLEAN ? EXTRA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = leg3_stages(L);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  return true;
}

// The per-sweep leg: steps sweeps of u into out with the error of every
// iterate (ERR_CLEAN: steps <= 7; ERR_GPU: steps <= 8).
static bool jacobi3_errs_leg(Leg3& L, const float* u, const float* f, float* out,
                             double* partials, int steps, int err_mode, int ty, int tx, int cz,
                             float h2, float w, float inv_h2) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || steps < 1 ||
      steps > (err_mode == ERR_CLEAN ? MAX_STEPS3 - 1 : MAX_STEPS3) || partials == nullptr)
    return false;
  L.u = u;
  L.f = f;
  L.out = out;
  L.partials = partials;
  L.per_sweep = 1;
  L.sweeps = steps;
  L.last = err_mode == ERR_CLEAN ? EXTRA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = leg3_stages(L);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  return true;
}

// steps <= 8 sweeps of u (unread when from_zero) into out. err_mode ERR_NONE,
// ERR_CLEAN (effective sweeps <= 7) or ERR_GPU; with an error, partials holds
// one double per block and err_out[0] receives the metric times err_scale.
extern "C" int mg3_jacobi(const float* u, const float* f, float* out, double* partials,
                          float* err_out, int n, int steps, int from_zero, int err_mode, int ty,
                          int tx, int cz, float h2, float w, float inv_h2, double err_scale,
                          void* stream) {
  Leg3 L{};
  L.n = n;
  if (!jacobi3_leg(L, u, f, out, partials, steps, from_zero, err_mode, ty, tx, cz, h2, w,
                   inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      launch_leg3(jacobi3_kernel, jacobi3_shard_kernel, L, planes3_whole(n), s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_error3(L, err_scale, err_out, s);
}

// The same on the owned planes [z0, z0 + nz) of a z-sharded n^3 level: u and
// f are those planes extended by ext planes per side (ext >= the pass's halo
// wherever a neighbour lies), out the owned planes; with an error, raw_out[0]
// receives the shard's raw sum over its owned planes (partials one double per
// block of the shard).
extern "C" int mg3_jacobi_shard(const float* u, const float* f, float* out, double* partials,
                                double* raw_out, int n, int z0, int nz, int ext, int steps,
                                int from_zero, int err_mode, int ty, int tx, int cz, float h2,
                                float w, float inv_h2, void* stream) {
  Leg3 L{};
  L.n = n;
  const Planes3 P{z0, nz, ext, 0, 0};
  if (!jacobi3_leg(L, u, f, out, partials, steps, from_zero, err_mode, ty, tx, cz, h2, w,
                   inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = launch_leg3(jacobi3_kernel, jacobi3_shard_kernel, L, P, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_raw3(L, P, raw_out, s);
}

// steps <= 8 sweeps of u into out with the error of every iterate: partials
// holds steps rows of one double per block, errs[s − 1] receives the metric of
// iterate s times err_scale. err_mode ERR_CLEAN (steps <= 7) or ERR_GPU.
extern "C" int mg3_jacobi_errs(const float* u, const float* f, float* out, double* partials,
                               float* errs, int n, int steps, int err_mode, int ty, int tx,
                               int cz, float h2, float w, float inv_h2, double err_scale,
                               void* stream) {
  Leg3 L{};
  L.n = n;
  if (!jacobi3_errs_leg(L, u, f, out, partials, steps, err_mode, ty, tx, cz, h2, w, inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = launch_leg3(jacobi3_errs_kernel, jacobi3_errs_shard_kernel, L,
                                    planes3_whole(n), s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_error3(L, err_scale, errs, s);
}

// The same on a shard's planes (geometry as mg3_jacobi_shard): raws[s − 1]
// receives the shard's raw sum for iterate s.
extern "C" int mg3_jacobi_errs_shard(const float* u, const float* f, float* out,
                                     double* partials, double* raws, int n, int z0, int nz,
                                     int ext, int steps, int err_mode, int ty, int tx, int cz,
                                     float h2, float w, float inv_h2, void* stream) {
  Leg3 L{};
  L.n = n;
  const Planes3 P{z0, nz, ext, 0, 0};
  if (!jacobi3_errs_leg(L, u, f, out, partials, steps, err_mode, ty, tx, cz, h2, w, inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      launch_leg3(jacobi3_errs_kernel, jacobi3_errs_shard_kernel, L, P, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_raw3(L, P, raws, s);
}

// emit_residual: steps sweeps of u (unread when from_zero; at most 7 after
// the closed-form one) into out and the residual of the result (negated when
// negate) into r, in one pass, on the owned planes [z0, z0 + nz) (geometry as
// mg3_jacobi_shard; the whole grid is z0 = 0, nz = n, ext = 0).
extern "C" int mg3_jacobi_residual_shard(const float* u, const float* f, float* out, float* r,
                                         int n, int z0, int nz, int ext, int steps,
                                         int from_zero, int negate, int ty, int tx, int cz,
                                         float h2, float w, float inv_h2, void* stream) {
  const int sweeps = steps - (from_zero ? 1 : 0);
  if (steps < 1 || sweeps > MAX_STEPS3 - 1 || r == nullptr) return (int)cudaErrorInvalidValue;
  Leg3 L{};
  L.n = n;
  const Planes3 P{z0, nz, ext, 0, 0};
  L.u = from_zero ? nullptr : u;
  L.f = f;
  L.out = out;
  L.r = r;
  L.sweeps = sweeps;
  L.last = RESID;
  L.err_mode = ERR_NONE;
  L.restrict_mode = R_NONE;
  L.negate = negate;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = leg3_stages(L);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  return (int)launch_leg3(jacobi3_residual_kernel, jacobi3_residual_shard_kernel, L, P,
                          (cudaStream_t)stream);
}
