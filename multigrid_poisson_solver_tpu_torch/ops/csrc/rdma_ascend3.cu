// The whole 3-D ascend leg over every z-shard of a sharded level in one
// kernel: the trilinear prolongation of the coarse correction, its add on
// the interior and k post-sweeps, with the clean smoothing error optionally
// fused in, the fine and coarse plane halos exchanged inside the kernel.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma3.py,
// _rdma_ascend3_kernel, reached through parallel/pallas_shard3.py's
// rdma_fused_ascend3 (the sharded ascend legs with halo="rdma").
//
// Bound: device-memory bandwidth, as ascend3.cu: 12.5 B per fine point for
// the whole leg, plus the halo planes. The exchange path
// (sharded_fused_ascend3) copies every shard's windows of u, f and the
// coarse correction first; here they move inside the launch, the coarse
// correction as a third channel of receive buffers. Design: the ring pass
// of rdma3.cuh around the pipeline of ascend3.cu in ring mode: the starting
// iterate of every staged plane, halo planes included, is u plus the
// correction prolonged from the coarse planes of the shard's own block or of
// its coarse receive buffers. Owned planes and the shard's raw Σ|r| are
// mg3_ascend_shard's with the same tile plan, bit for bit.
#include "rdma3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) rdma_ascend3_kernel(RingLeg3Args a) {
  extern __shared__ float smem[];
  ring_leg3<true>(a, smem);
}

// Each shard's block u_ptrs[s] (planes z0s[s]..z0s[s + 1] of the n^3 level,
// n = 2m − 1, every z0s[s] even) plus the correction prolonged from the m^3
// coarse level, whose planes [z0 / 2, (z1 + 1) / 2) shard s holds at
// c_ptrs[s], then steps <= 8 sweeps into out_ptrs[s]. err_mode ERR_NONE or
// ERR_CLEAN (steps <= 7; raw[s] the shard's raw Σ|r|).
extern "C" int mg3_rdma_ascend(const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* c_ptrs,
                               const unsigned long long* out_ptrs, const int* z0s,
                               const int* czs, int shards, int n, int steps, int err_mode,
                               int ty, int tx, double* partials, double* raw,
                               const unsigned long long* ws, unsigned long long tag, float h2,
                               float w, float inv_h2, void* stream) {
  if (steps < 1 || steps > MAX_STEPS3 || n % 2 == 0 ||
      (err_mode != ERR_NONE && err_mode != ERR_CLEAN) ||
      (err_mode != ERR_NONE && (partials == nullptr || raw == nullptr)))
    return (int)cudaErrorInvalidValue;
  RingLeg3Args a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  for (int s = 0; s < shards; ++s)
    if (z0s[s] % 2) return (int)cudaErrorInvalidValue;
  Leg3& L = a.L;  // the kernel sets each shard's pointers; a non-null L.c means prolong
  L.n = n;
  L.u = (const float*)u_ptrs[0];
  L.c = (const float*)c_ptrs[0];
  L.partials = err_mode == ERR_NONE ? nullptr : partials;
  L.sweeps = steps;
  L.last = err_mode == ERR_CLEAN ? EXTRA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.halo = leg3_stages(L);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  for (int s = 0; s < shards; ++s) {
    a.u[s] = (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.c[s] = (const float*)c_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
  }
  a.raw = raw;
  a.tag = tag;
  return (int)launch_ring_leg3(rdma_ascend3_kernel, a, czs, L.partials, (cudaStream_t)stream);
}
