// 7-point residual r = (Σnb − 6u)/h² − f on the interior, 0 elsewhere,
// optionally negated.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py, _residual3_kernel,
// reached through residual3_pallas.
//
// Bound: device-memory bandwidth, one pass that reads u and f and writes r
// (12 B per point, what a torch.add of two volumes moves). Design: one
// column pass of col3.cuh: a thread streams one (y, x) column of its tile's
// z chunk down z with planes z − 1, z, z + 1 of u in registers and the next
// COL3_AHEAD planes' loads in flight, reads f once and writes r, so each u
// value is read from device memory about once and the in-plane neighbours
// come through L1. The port's first version, a 2.5-D tile pipeline (one
// 512-thread block an SM, a barrier a plane), took 2.12 ms at 513³ on an
// H100 (PERF.md). The arithmetic is the twin's (residual3_torch):
// ((((z− + z+) + y−) + y+) + x−) + x+, − 6u, × h⁻², − f, with the
// round-to-nearest intrinsics, so r is the twin's bit for bit; face cells
// are +0. The body (col3_residual_unit) is also kernel 10's emit_residual
// pass (jacobi3.cu), which adds the clean error.
//
// Shard mode (pallas3d.py, _residual3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_residual3_pallas): the residual of one
// z-shard's owned planes from its planes extended by ext >= 1 neighbour
// planes per side; the whole grid is the shard mode with z0 = 0, nz = n,
// ext = 0.
#include "col3.cuh"

using namespace mgk3;

// Unit blockIdx.x of the pass (col3_residual_unit, col3.cuh): the tile's
// columns over its z chunk of the owned planes, r into the owned planes. u
// and C.f are the inputs, planes [z0 − ext, z0 + nz + ext).
static __global__ void __launch_bounds__(COL3_THREADS)
    residual3_kernel(Col3 C, const float* __restrict__ u, float* __restrict__ r, int negate) {
  col3_residual_unit<false>(C, u, r, negate, nullptr, blockIdx.x);
}

// The residual of the owned planes [z0, z0 + nz) of an n^3 level into r (the
// owned planes); u and f hold them extended by ext >= 1 planes per side
// wherever a neighbour lies (the whole grid: z0 = 0, nz = n, ext = 0).
// (ty, tx, cz): the column pass's tile plan (ops.kernels3.err_plan3; at most
// THREADS3 cells a tile).
extern "C" int mg3_residual_shard(const float* u, const float* f, float* r, int n, int z0, int nz,
                                  int ext, int negate, int ty, int tx, int cz, float inv_h2,
                                  void* stream) {
  Col3 C;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = col3_setup(C, 1, f, nullptr, n, z0, nz, ext, ty, tx, cz, 0.0f, 0.0f, inv_h2,
                             st, false);
  if (e != cudaSuccess || u == nullptr || r == nullptr)
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  residual3_kernel<<<col3_units(C), COL3_THREADS, 0, st>>>(C, u, r, negate);
  return (int)cudaGetLastError();
}

extern "C" int mg3_residual(const float* u, const float* f, float* r, int n, int negate, int ty,
                            int tx, int cz, float inv_h2, void* stream) {
  return mg3_residual_shard(u, f, r, n, 0, n, 0, negate, ty, tx, cz, inv_h2, stream);
}
