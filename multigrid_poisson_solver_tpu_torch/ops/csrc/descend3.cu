// The whole 3-D descend leg in one kernel: k damped-Jacobi sweeps, the
// residual of the final iterate and its 2:1 restriction (full weighting or
// sampling) written straight into the coarse right-hand side, with the clean
// smoothing error fused in.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _fused_descend3_kernel, reached through fused_descend3_padded, together
// with the lane decimation it leaves to XLA (ops/padded3.py,
// restrict3_lanes_p).
//
// Bound: device-memory bandwidth. Fused, the leg reads u and f once, writes
// u once and writes the coarse grid (an eighth of the points): 12.5 B per
// fine point for the whole leg, against 12 B per sweep plus 12 for the
// residual and more for the restriction as separate passes. Design: the
// 2.5-D pipeline of legs3.cuh with one stage more than the sweeps, which
// reads the final iterate's neighbors once for both the clean error (Σ|r|)
// and −r, which lands in that stage's ring of three planes; each coarse
// plane K is formed from fine planes 2K − 1 .. 2K + 1 as soon as they are
// there. r is the direct stencil (the TPU kernel takes it from the step Δ of
// a further sweep as 6Δ/(ωh²)): that way a cycle on the kernels keeps the
// plain cycle's iterates, where the Δ form drifted 1.04e-5·max|u| from them
// in four 513³ cycles. Tiles, chunks and their
// origins are even, so a block's fine
// tile is exactly a tile of coarse points and no exchange is needed. The
// halo is k + 1 (+1 for full weighting). Coarse boundary points are 0.
//
// Shard mode (pallas3d.py, _fused_descend3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_fused_descend3): the leg on one
// z-shard's planes (legs3.cuh, SHARD) with an even global origin, so the
// shard's coarse planes start at z0 / 2 and a fine plane's parity is its
// global one; each shard writes its own slab of the coarse right-hand side,
// all three axes restricted in the kernel, and its error as a raw float64
// sum over its owned planes.
#include "legs3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) descend3_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3(smem, L, Planes3{});
}

static __global__ void __launch_bounds__(THREADS3)
descend3_shard_kernel(Leg3 L, Planes3 P) {
  extern __shared__ float smem[];
  run_leg3<true>(smem, L, P);
}

static bool descend3_leg(Leg3& L, const float* u, const float* f, float* out, float* fc,
                         double* partials, int steps, int from_zero, int full_weighting,
                         int want_err, int ty, int tx, int cz, float h2, float w, float inv_h2) {
  const int sweeps = steps - (from_zero ? 1 : 0);
  if (steps < 1 || sweeps > (full_weighting ? 6 : 7) || L.n % 2 == 0) return false;
  L.u = from_zero ? nullptr : u;
  L.f = f;
  L.out = out;
  L.fc = fc;
  L.partials = want_err ? partials : nullptr;
  L.sweeps = sweeps;
  L.last = EXTRA;
  L.err_mode = want_err ? ERR_CLEAN : ERR_NONE;
  L.restrict_mode = full_weighting ? R_FW : R_SAMPLING;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = leg3_stages(L) + (full_weighting ? 1 : 0);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  return true;
}

// steps sweeps of the n^3 level (n = 2m − 1; u unread when from_zero) into
// out, the restricted −r into the m^3 fc. want_err: the clean error, with
// partials holding one double per block, into err_out[0] (times err_scale).
extern "C" int mg3_descend(const float* u, const float* f, float* out, float* fc,
                           double* partials, float* err_out, int n, int steps, int from_zero,
                           int full_weighting, int want_err, int ty, int tx, int cz, float h2,
                           float w, float inv_h2, double err_scale, void* stream) {
  Leg3 L{};
  L.n = n;
  if (!descend3_leg(L, u, f, out, fc, partials, steps, from_zero, full_weighting, want_err, ty,
                    tx, cz, h2, w, inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      launch_leg3(descend3_kernel, descend3_shard_kernel, L, planes3_whole(n), s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_error3(L, err_scale, err_out, s);
}

// The same on the owned planes [z0, z0 + nz) of a z-sharded level, z0 even:
// u and f those planes extended by ext planes per side, out the owned planes,
// fc the coarse planes [z0 / 2, (z0 + nz + 1) / 2) (m^2 each); with want_err,
// raw_out[0] receives the shard's raw Σ|r| over its owned planes.
extern "C" int mg3_descend_shard(const float* u, const float* f, float* out, float* fc,
                                 double* partials, double* raw_out, int n, int z0, int nz,
                                 int ext, int steps, int from_zero, int full_weighting,
                                 int want_err, int ty, int tx, int cz, float h2, float w,
                                 float inv_h2, void* stream) {
  Leg3 L{};
  L.n = n;
  const Planes3 P{z0, nz, ext, 0, 0};
  if (z0 % 2 || !descend3_leg(L, u, f, out, fc, partials, steps, from_zero, full_weighting,
                              want_err, ty, tx, cz, h2, w, inv_h2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = launch_leg3(descend3_kernel, descend3_shard_kernel, L, P, s);
  if (e != cudaSuccess) return (int)e;
  return (int)finish_raw3(L, P, raw_out, s);
}
