// The whole 3-D descend leg over every z-shard of a sharded level: k
// damped-Jacobi sweeps, the residual of the final iterate and its 2:1
// restriction (full weighting or sampling) into each shard's slab of the
// coarse right-hand side, with the clean smoothing error, the plane halos
// moving only through the ring's receive buffers.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma3.py,
// _rdma_descend3_kernel, reached through parallel/pallas_shard3.py's
// rdma_fused_descend3 (the sharded descend legs with halo="rdma").
//
// Bound: device-memory bandwidth, as descend3.cu: 12.5 B per fine point for
// the whole leg, plus the halo planes. The exchange path
// (sharded_fused_descend3) copies every shard's windows of u and f first,
// another read and write of both volumes; here only the k_nb + 2 (full
// weighting) or k_nb + 1 halo planes a side move. Design: the ring leg of
// rdma3.cuh (post once, then shard-local column passes, a launch each over
// every shard) with the passes of descend3.cu's shard mode: col3_schedule's
// k sweeps with iterate k exact on 1 + (full weighting) more planes a side,
// the residual pass (−r, its clean error, the restriction's z step into s)
// and the y and x steps into the shard's coarse planes from z0 / 2 on (each
// shard's origin is even, so a fine plane's parity is its global one).
// Owned planes, the coarse slab and the shard's raw Σ|r| are
// mg3_descend_shard's with the same tile plan, bit for bit.
#include "rdma3.cuh"

using namespace mgk3;

// The residual pass on shard blockIdx.y (unit blockIdx.x): −r of iterate k
// (in the window wa), its clean error's tile partials, the restriction's z
// step into the shard's s.
template <bool FW>
static __global__ void __launch_bounds__(COL3_THREADS) ring_residual3_kernel(RingCol3 a) {
  const int s = blockIdx.y, unit = blockIdx.x;
  const Col3& C = a.C[s];
  if (unit >= col3_units(C)) return;
  // f through the ring source in every unit: a second instance for the
  // units within the block (f from the block alone, as the sweeps take)
  // raised the pass to 89 registers and from 0.92 to 1.07 ms at 513³ on 8
  // z-shards of an H100
  descend3_residual_unit<FW>(C,
                             col3_src(Flat3{ring_window(a, a.wa[s], s)}, ring_f3(a, s), nullptr,
                                      nullptr),
                             a.s[s], a.partials != nullptr ? a.partials + a.part0[s] : nullptr,
                             unit);
}

// The restriction's y and x steps on shard blockIdx.z: a thread per coarse
// point (32 x 4 a block, blockIdx.y the shard's coarse plane).
template <bool FW>
static __global__ void __launch_bounds__(COL3_THREADS) ring_restrict3_kernel(RingCol3 a) {
  const int s = blockIdx.z, n = a.W.n, m = (n + 1) / 2, K0 = a.W.z0[s] / 2;
  const int gx = (m + 31) / 32, k = blockIdx.y;
  if (k >= (a.W.z0[s + 1] + 1) / 2 - K0) return;
  const int I = (blockIdx.x / gx) * 4 + (threadIdx.x >> 5);
  const int J = (blockIdx.x % gx) * 32 + (threadIdx.x & 31);
  descend3_restrict_at<FW>(a.s[s], a.fc[s], n, K0, k, I, J);
}

// steps sweeps of each shard's block u_ptrs[s] (planes z0s[s]..z0s[s + 1] of
// the n^3 level, n = 2m − 1, every z0s[s] even; u unread when from_zero)
// into out_ptrs[s], the restricted −r into fc_ptrs[s] (the shard's coarse
// planes [z0 / 2, (z1 + 1) / 2) of m^2); want_err: the clean error, raw[s]
// the shard's raw Σ|r| (partials one double per tile of every shard, work
// the column pass's workspace for all of them, ops.kernels3.col3_work of the
// total). wa_ptrs[s] and wb_ptrs[s] are scratch windows of the shard's
// planes and k_nb + 1 + full_weighting more a side (k_nb the
// neighbour-reading sweeps; wb unread for one sweep), s_ptrs[s] the z steps
// of its coarse planes (n^2 floats each). (ty, tx) and czs[s]: each shard's
// tile plan (err_plan3 of its depth). ws is the ring workspace of
// ops/rdma3.py; tag is above every tag it has seen.
extern "C" int mg3_rdma_descend(const unsigned long long* u_ptrs,
                                const unsigned long long* f_ptrs,
                                const unsigned long long* out_ptrs,
                                const unsigned long long* fc_ptrs,
                                const unsigned long long* wa_ptrs,
                                const unsigned long long* wb_ptrs,
                                const unsigned long long* s_ptrs, const int* z0s,
                                const int* czs, int shards, int n, int steps, int from_zero,
                                int full_weighting, int want_err, int ty, int tx,
                                double* partials, double* work, double* raw,
                                const unsigned long long* ws, unsigned long long tag, float h2,
                                float w, float inv_h2, void* stream) {
  const int fw = full_weighting ? 1 : 0, sweeps = steps - (from_zero ? 1 : 0);
  if (steps < 1 || sweeps > (fw ? 6 : 7) || n % 2 == 0 ||
      (want_err && (partials == nullptr || raw == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  RingCol3 a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  if (!ring_even3(a.W)) return (int)cudaErrorInvalidValue;
  int units = 0;
  // the window: the stencil reads the owned planes depend on
  if ((e = ring_col3_setup(a, f_ptrs, czs, sweeps + 1 + fw, ty, tx, work, want_err, h2, w,
                           inv_h2, &units, st)) != cudaSuccess)
    return (int)e;
  const int m = (n + 1) / 2;
  int coarse = 0;
  for (int s = 0; s < shards; ++s) {
    a.u[s] = from_zero ? nullptr : (const float*)u_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.wa[s] = (float*)wa_ptrs[s];
    a.wb[s] = (float*)wb_ptrs[s];
    a.s[s] = (float*)s_ptrs[s];
    a.fc[s] = (float*)fc_ptrs[s];
    if (a.out[s] == nullptr || a.wa[s] == nullptr || (steps >= 2 && a.wb[s] == nullptr) ||
        a.s[s] == nullptr || a.fc[s] == nullptr || (!from_zero && a.u[s] == nullptr))
      return (int)cudaErrorInvalidValue;
    const int planes = (z0s[s + 1] + 1) / 2 - z0s[s] / 2;
    coarse = planes > coarse ? planes : coarse;
  }
  a.partials = want_err ? partials : nullptr;
  a.tag = tag;
  a.steps = steps;
  a.mode = ERR_NONE;
  a.tail = 1 + fw;  // iterate k on the owned planes and 1 + fw more a side, in wa
  a.fw = fw;
  if ((e = ring_post3(a, false, st)) != cudaSuccess ||
      (e = ring_sweeps3(a, true, steps, units, st)) != cudaSuccess)
    return (int)e;
  const dim3 grid(units, shards), rgrid(((m + 31) / 32) * ((m + 3) / 4), coarse, shards);
  if (fw) {
    ring_residual3_kernel<true><<<grid, COL3_THREADS, 0, st>>>(a);
    ring_restrict3_kernel<true><<<rgrid, COL3_THREADS, 0, st>>>(a);
  } else {
    ring_residual3_kernel<false><<<grid, COL3_THREADS, 0, st>>>(a);
    ring_restrict3_kernel<false><<<rgrid, COL3_THREADS, 0, st>>>(a);
  }
  if ((e = cudaGetLastError()) != cudaSuccess || !want_err) return (int)e;
  return (int)ring_raw3(a, raw, st);
}
