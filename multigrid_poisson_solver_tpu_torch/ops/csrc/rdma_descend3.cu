// The whole 3-D descend leg over every z-shard of a sharded level in one
// kernel: k damped-Jacobi sweeps, the residual of the final iterate and its
// 2:1 restriction (full weighting or sampling) into each shard's slab of the
// coarse right-hand side, with the clean smoothing error, the plane halos
// exchanged inside the kernel.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma3.py,
// _rdma_descend3_kernel, reached through parallel/pallas_shard3.py's
// rdma_fused_descend3 (the sharded descend legs with halo="rdma").
//
// Bound: device-memory bandwidth, as descend3.cu: 12.5 B per fine point for
// the whole leg, plus the halo planes. The exchange path
// (sharded_fused_descend3) copies every shard's windows of u and f first,
// another read and write of both volumes; here the k_nb + 2 (full
// weighting) or k_nb + 1 halo planes move inside the launch. Design: the
// ring pass of rdma3.cuh (post the input planes the neighbours' windows
// take, run the tiles that stage no other shard's plane, wait, run the
// others) around the pipeline of descend3.cu in ring mode: each shard's
// origin is even, so a fine plane's parity is its global one and the shard
// writes its own coarse planes from z0 / 2 on, all three axes restricted in
// the kernel. Owned planes, the coarse slab and the shard's raw Σ|r| are
// mg3_descend_shard's with the same tile plan, bit for bit.
#include "rdma3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) rdma_descend3_kernel(RingLeg3Args a) {
  extern __shared__ float smem[];
  ring_leg3<false>(a, smem);
}

// steps sweeps of each shard's block u_ptrs[s] (planes z0s[s]..z0s[s + 1] of
// the n^3 level, n = 2m − 1, every z0s[s] even; u unread when from_zero)
// into out_ptrs[s], the restricted −r into fc_ptrs[s] (the shard's coarse
// planes [z0 / 2, (z1 + 1) / 2) of m^2); want_err: the clean error, raw[s]
// the shard's raw Σ|r| (partials one double per tile of every shard).
extern "C" int mg3_rdma_descend(const unsigned long long* u_ptrs,
                                const unsigned long long* f_ptrs,
                                const unsigned long long* out_ptrs,
                                const unsigned long long* fc_ptrs, const int* z0s,
                                const int* czs, int shards, int n, int steps, int from_zero,
                                int full_weighting, int want_err, int ty, int tx,
                                double* partials, double* raw, const unsigned long long* ws,
                                unsigned long long tag, float h2, float w, float inv_h2,
                                void* stream) {
  const int sweeps = steps - (from_zero ? 1 : 0);
  if (steps < 1 || sweeps > (full_weighting ? 6 : 7) || n % 2 == 0 ||
      (want_err && (partials == nullptr || raw == nullptr)))
    return (int)cudaErrorInvalidValue;
  RingLeg3Args a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  for (int s = 0; s < shards; ++s)
    if (z0s[s] % 2) return (int)cudaErrorInvalidValue;
  Leg3& L = a.L;  // the kernel sets each shard's pointers; a null L.u means from zero
  L.n = n;
  L.u = from_zero ? nullptr : (const float*)u_ptrs[0];
  L.partials = want_err ? partials : nullptr;
  L.sweeps = sweeps;
  L.last = EXTRA;
  L.err_mode = want_err ? ERR_CLEAN : ERR_NONE;
  L.restrict_mode = full_weighting ? R_FW : R_SAMPLING;
  L.ty = ty;
  L.tx = tx;
  L.halo = leg3_stages(L) + (full_weighting ? 1 : 0);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  for (int s = 0; s < shards; ++s) {
    a.u[s] = from_zero ? nullptr : (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.fc[s] = (float*)fc_ptrs[s];
  }
  a.raw = raw;
  a.tag = tag;
  return (int)launch_ring_leg3(rdma_descend3_kernel, a, czs, L.partials, (cudaStream_t)stream);
}
