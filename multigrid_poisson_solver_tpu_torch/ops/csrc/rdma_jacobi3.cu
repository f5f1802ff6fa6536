// One fused pass of k <= 8 damped-Jacobi sweeps of the 7-point stencil over
// every z-shard of a sharded level, the plane halos exchanged inside the
// kernel, with an optional fused smoothing error (clean or gpu) of the final
// iterate.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma3.py,
// _rdma_jacobi3_kernel, reached through parallel/pallas_shard3.py's
// rdma_fused_jacobi3 and rdma_fused_jacobi3_err (the engine's sharded
// smoothing passes with halo="rdma").
//
// Bound: device-memory bandwidth, as jacobi3.cu: a pass reads u and f and
// writes u, 12 B per point, plus the halo planes. The exchange path
// (sharded_fused_jacobi3) first copies every shard's halo-extended windows of
// u and f, another read and write of both volumes and a launch per shard,
// serialised in front of the sweeps; here the halo planes move inside the
// one launch. Design: one persistent cooperative launch spans the ring, each
// shard on its own slice of blocks (rdma3.cuh). A shard's blocks first post
// the planes of u and f (f only from zero: the closed-form first sweep never
// reads u) that the neighbours' windows take into their receive buffers and
// release a tag on their flags; then they walk the shard's tiles with the
// pipeline of jacobi3.cu in ring mode (legs3.cuh), the tiles that stage no
// other shard's plane first, the others after the neighbours' tags. Every
// shard uses the tile plan of its shard-mode launch, so its owned planes and
// its raw float64 error sum are mg3_jacobi_shard's, bit for bit; the caller
// adds the raw sums in shard order and scales them once.
#include "rdma3.cuh"

using namespace mgk3;

static __global__ void __launch_bounds__(THREADS3) rdma_jacobi3_kernel(RingLeg3Args a) {
  extern __shared__ float smem[];
  ring_leg3(a, smem);
}

// steps <= 8 sweeps (the first the closed form from u ≡ 0 with from_zero) of
// each shard's block u_ptrs[s] (planes z0s[s]..z0s[s + 1] of the n^3 level)
// into out_ptrs[s]; err_mode ERR_NONE, ERR_CLEAN (effective sweeps <= 7) or
// ERR_GPU, with partials one double per tile of every shard and raw[s] the
// shard's raw error sum. (ty, tx) and czs[s]: each shard's tile plan. ws is
// the ring workspace of ops/rdma3.py; tag is above every tag it has seen.
extern "C" int mg3_rdma_jacobi(const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* out_ptrs, const int* z0s,
                               const int* czs, int shards, int n, int steps, int from_zero,
                               int err_mode, int ty, int tx, double* partials, double* raw,
                               const unsigned long long* ws, unsigned long long tag, float h2,
                               float w, float inv_h2, void* stream) {
  if (steps < 1 || steps > MAX_STEPS3 ||
      (err_mode != ERR_NONE && err_mode != ERR_CLEAN && err_mode != ERR_GPU) ||
      (err_mode != ERR_NONE && (partials == nullptr || raw == nullptr)))
    return (int)cudaErrorInvalidValue;
  RingLeg3Args a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  Leg3& L = a.L;  // the kernel sets each shard's pointers; a null L.u means from zero
  L.n = n;
  L.u = from_zero ? nullptr : (const float*)u_ptrs[0];
  L.sweeps = steps - (from_zero ? 1 : 0);
  L.last = err_mode == ERR_CLEAN ? EXTRA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.halo = leg3_stages(L);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  L.partials = err_mode == ERR_NONE ? nullptr : partials;
  for (int s = 0; s < shards; ++s) {
    a.u[s] = from_zero ? nullptr : (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
  }
  a.raw = raw;
  a.tag = tag;
  return (int)launch_ring_leg3(rdma_jacobi3_kernel, a, czs, L.partials, (cudaStream_t)stream);
}
