// 7-point residual r = (Σnb − 6u)/h² − f on the interior, 0 elsewhere,
// optionally negated.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py, _residual3_kernel,
// reached through residual3_pallas.
//
// Bound: device-memory bandwidth, one pass that reads u and f and writes r
// (12 B per point). Design: the 2.5-D pipeline of legs3.cuh with a single
// residual stage and a halo of one cell: each block streams its column tile
// down z through a ring of three u planes in shared memory, so each u value
// is read from device memory about once (plus the one-cell halo).
#include "legs3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) residual3_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3(smem, L);
}

extern "C" int mg3_residual(const float* u, const float* f, float* r, int n, int negate, int ty,
                            int tx, int cz, float inv_h2, void* stream) {
  Leg3 L{};
  L.u = u;
  L.f = f;
  L.out = r;
  L.n = n;
  L.sweeps = 0;
  L.last = RESID;
  L.err_mode = ERR_NONE;
  L.restrict_mode = R_NONE;
  L.negate = negate;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = 1;
  L.inv_h2 = inv_h2;
  return (int)launch_leg3(residual3_kernel, L, (cudaStream_t)stream);
}
