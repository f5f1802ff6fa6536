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
#include "legs3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) jacobi3_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3(smem, L);
}

static __global__ void __launch_bounds__(THREADS3) jacobi3_errs_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3<MAX_STEPS3>(smem, L);
}

// steps <= 8 sweeps of u (unread when from_zero) into out. err_mode ERR_NONE,
// ERR_CLEAN (effective sweeps <= 7) or ERR_GPU; with an error, partials holds
// one double per block and err_out[0] receives the metric times err_scale.
extern "C" int mg3_jacobi(const float* u, const float* f, float* out, double* partials,
                          float* err_out, int n, int steps, int from_zero, int err_mode, int ty,
                          int tx, int cz, float h2, float w, float inv_h2, double err_scale,
                          void* stream) {
  if (steps < 1 || steps > MAX_STEPS3) return (int)cudaErrorInvalidValue;
  Leg3 L{};
  L.u = from_zero ? nullptr : u;
  L.f = f;
  L.out = out;
  L.partials = err_mode == ERR_NONE ? nullptr : partials;
  L.n = n;
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
  if (err_mode != ERR_NONE && err_mode != ERR_CLEAN && err_mode != ERR_GPU)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = launch_leg3(jacobi3_kernel, L, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_error3(L, err_scale, err_out, s);
}

// steps <= 8 sweeps of u into out with the error of every iterate: partials
// holds steps rows of one double per block, errs[s − 1] receives the metric of
// iterate s times err_scale. err_mode ERR_CLEAN (steps <= 7) or ERR_GPU.
extern "C" int mg3_jacobi_errs(const float* u, const float* f, float* out, double* partials,
                               float* errs, int n, int steps, int err_mode, int ty, int tx,
                               int cz, float h2, float w, float inv_h2, double err_scale,
                               void* stream) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || steps < 1 ||
      steps > (err_mode == ERR_CLEAN ? MAX_STEPS3 - 1 : MAX_STEPS3) || partials == nullptr)
    return (int)cudaErrorInvalidValue;
  Leg3 L{};
  L.u = u;
  L.f = f;
  L.out = out;
  L.partials = partials;
  L.per_sweep = 1;
  L.n = n;
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
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = launch_leg3(jacobi3_errs_kernel, L, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_error3(L, err_scale, errs, s);
}
