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
//
// Shard mode (pallas3d.py, _residual3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_residual3_pallas): the residual of one
// z-shard's planes from its planes extended by one neighbour plane per side
// (legs3.cuh, SHARD).
#include "legs3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) residual3_kernel(Leg3 L) {
  extern __shared__ float smem[];
  run_leg3(smem, L, Planes3{});
}

static __global__ void __launch_bounds__(THREADS3)
residual3_shard_kernel(Leg3 L, Planes3 P) {
  extern __shared__ float smem[];
  run_leg3<true>(smem, L, P);
}

// The residual of the owned planes [z0, z0 + nz) of an n^3 level into r (the
// owned planes); u and f hold them extended by ext >= 1 planes per side (the
// whole grid: z0 = 0, nz = n, ext = 0).
extern "C" int mg3_residual_shard(const float* u, const float* f, float* r, int n, int z0, int nz,
                                  int ext, int negate, int ty, int tx, int cz, float inv_h2,
                                  void* stream) {
  Leg3 L{};
  L.n = n;
  const Planes3 P{z0, nz, ext, 0, 0};
  L.u = u;
  L.f = f;
  L.out = r;
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
  return (int)launch_leg3(residual3_kernel, residual3_shard_kernel, L, P,
                          (cudaStream_t)stream);
}

extern "C" int mg3_residual(const float* u, const float* f, float* r, int n, int negate, int ty,
                            int tx, int cz, float inv_h2, void* stream) {
  return mg3_residual_shard(u, f, r, n, 0, n, 0, negate, ty, tx, cz, inv_h2, stream);
}
