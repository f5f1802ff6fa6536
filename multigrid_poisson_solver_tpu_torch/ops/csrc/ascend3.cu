// The whole 3-D ascend leg in one kernel: the trilinear prolongation of the
// coarse correction, its add on the interior and k post-sweeps, with the
// clean smoothing error optionally fused in.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _fused_ascend3_kernel, reached through fused_ascend3_padded, together with
// the lane expansion it leaves to XLA (ops/padded3.py, prolong3_lanes_p).
//
// Bound: device-memory bandwidth. Fused, the leg reads u, f and the coarse
// grid (an eighth of the points) once and writes u once: 12.5 B per fine
// point, against a prolongation pass, an add pass and 12 B per sweep as
// separate passes. Design: the 2.5-D pipeline of legs3.cuh; the starting
// iterate of each staged plane is u plus the prolonged correction, formed
// from the coarse grid directly (even points copy, odd ones average two,
// four or eight coarse values, along z, then y, then x), so the fine
// correction never exists in device memory. The halo is k (+1 for the clean
// error's extra stencil read).
//
// Shard mode (pallas3d.py, _fused_ascend3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_fused_ascend3): the leg on one
// z-shard's planes (legs3.cuh, SHARD) with an even global origin, reading a
// window of the coarse correction's planes around the shard's coarse points
// (the TPU kernel reads a lane-expanded window; here the prolongation is
// formed in the kernel on all three axes); the error, when asked for, comes
// back as the shard's raw float64 sum over its owned planes.
#include "legs3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) ascend3_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3(smem, L, Planes3{});
}

static __global__ void __launch_bounds__(THREADS3)
ascend3_shard_kernel(Leg3 L, Planes3 P) {
  extern __shared__ float smem[];
  run_leg3<true>(smem, L, P);
}

static bool ascend3_leg(Leg3& L, const float* u, const float* f, const float* c, float* out,
                        double* partials, int steps, int err_mode, int ty, int tx, int cz,
                        float h2, float w, float inv_h2) {
  if (steps < 1 || steps > MAX_STEPS3 || L.n % 2 == 0 ||
      (err_mode != ERR_NONE && err_mode != ERR_CLEAN))
    return false;
  L.u = u;
  L.f = f;
  L.c = c;
  L.out = out;
  L.partials = err_mode == ERR_NONE ? nullptr : partials;
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

// u plus the prolonged m^3 correction c on the interior of the n^3 level
// (n = 2m − 1), then steps <= 8 sweeps into out. err_mode ERR_NONE or
// ERR_CLEAN (steps <= 7; partials one double per block, err_out[0] the metric
// times err_scale).
extern "C" int mg3_ascend(const float* u, const float* f, const float* c, float* out,
                          double* partials, float* err_out, int n, int steps, int err_mode,
                          int ty, int tx, int cz, float h2, float w, float inv_h2,
                          double err_scale, void* stream) {
  Leg3 L{};
  L.n = n;
  if (!ascend3_leg(L, u, f, c, out, partials, steps, err_mode, ty, tx, cz, h2, w, inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      launch_leg3(ascend3_kernel, ascend3_shard_kernel, L, planes3_whole(n), s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_error3(L, err_scale, err_out, s);
}

// The same on the owned planes [z0, z0 + nz) of a z-sharded level, z0 even:
// u and f those planes extended by ext planes per side, c the coarse planes
// [cz0, cz0 + cnz) (m^2 each; every plane the staged interior interpolates
// from), out the owned planes; with ERR_CLEAN, raw_out[0] receives the
// shard's raw Σ|r| over its owned planes.
extern "C" int mg3_ascend_shard(const float* u, const float* f, const float* c, float* out,
                                double* partials, double* raw_out, int n, int z0, int nz,
                                int ext, int cz0, int cnz, int steps, int err_mode, int ty,
                                int tx, int cz, float h2, float w, float inv_h2, void* stream) {
  Leg3 L{};
  L.n = n;
  const Planes3 P{z0, nz, ext, cz0, cnz};
  if (z0 % 2 || !ascend3_leg(L, u, f, c, out, partials, steps, err_mode, ty, tx, cz, h2, w, inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = launch_leg3(ascend3_kernel, ascend3_shard_kernel, L, P, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_raw3(L, P, raw_out, s);
}
