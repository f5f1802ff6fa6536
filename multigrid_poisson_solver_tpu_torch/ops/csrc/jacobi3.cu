// Fused multi-sweep damped-Jacobi smoother for the 7-point stencil, with an
// optional fused smoothing error.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _fused_jacobi3_kernel (its plain, from_zero, clean and gpu modes), reached
// through fused_jacobi3_padded.
//
// Bound: device-memory bandwidth. One unfused fp32 sweep reads u and f and
// writes u, 12 B per point; k <= 8 sweeps in one pass move the same 12 B for
// all k. Design: 2.5-D temporal blocking (legs3.cuh). A block owns a column
// tile of (y, x) over a chunk of z planes, stages it with a halo of k (+1 for
// the clean error's extra Δ stage) and streams z through rings of three planes
// per sweep level in shared memory, so only the owned cells go back to device
// memory. The cost is redundant work on the halo rings, which the largest
// tile that fits shared memory keeps small. from_zero: the starting iterate is
// the closed-form first sweep (ω/6)·(−h²f) and u is never read. The clean
// error is Σ|Δ|·6/(ωh²)/n³, Δ the step of one more sweep (the TPU kernel's
// identity r = 6Δ/(ωh²)); the gpu error Σ|u_k − u_{k−1}|·6/h²/n³. Per-block
// partials are summed by a second kernel in a fixed order.
#include "legs3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) jacobi3_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3(smem, L);
}

// steps <= 8 sweeps of u (unread when from_zero) into out. err_mode ERR_NONE,
// ERR_CLEAN (effective sweeps <= 7) or ERR_GPU; with an error, partials holds
// one float per block and err_out[0] receives the metric times err_scale.
extern "C" int mg3_jacobi(const float* u, const float* f, float* out, float* partials,
                          float* err_out, int n, int steps, int from_zero, int err_mode, int ty,
                          int tx, int cz, float h2, float w, float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS3) return (int)cudaErrorInvalidValue;
  Leg3 L{};
  L.u = from_zero ? nullptr : u;
  L.f = f;
  L.out = out;
  L.partials = err_mode == ERR_NONE ? nullptr : partials;
  L.n = n;
  L.sweeps = steps - (from_zero ? 1 : 0);
  L.last = err_mode == ERR_CLEAN ? DELTA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = leg3_stages(L);
  L.h2 = h2;
  L.w = w;
  if (err_mode != ERR_NONE && err_mode != ERR_CLEAN && err_mode != ERR_GPU)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = launch_leg3(jacobi3_kernel, L, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_error3(L, err_scale, err_out, s);
}
