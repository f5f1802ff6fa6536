// k <= 8 damped-Jacobi sweeps of the 7-point stencil over every z-shard of
// a sharded level, the plane halos moving only through the ring's receive
// buffers, with an optional smoothing error (clean or gpu) of the final
// iterate.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma3.py,
// _rdma_jacobi3_kernel, reached through parallel/pallas_shard3.py's
// rdma_fused_jacobi3 and rdma_fused_jacobi3_err (the engine's sharded
// smoothing passes with halo="rdma").
//
// Bound: device-memory bandwidth, as jacobi3.cu: a sweep reads u and f and
// writes u, 12 B per point, plus the halo planes. The exchange path
// (sharded_fused_jacobi3) first copies every shard's halo-extended windows of
// u and f, another read and write of both volumes and a launch per shard;
// here only the k − from_zero + clean halo planes a side move. Design: the
// ring leg of rdma3.cuh (post once, then shard-local column passes, a launch
// each over every shard) with the passes of kernel 10's shard mode
// (jacobi3.cu's mg3_jacobi_shard): col3_schedule's k sweeps (from zero the
// first the closed form, on every window plane a later sweep reads), the
// iterates alternating between two scratch windows of the shard's planes and
// the depth a side, the last one into the owned planes, and with the clean
// error one more pass that only reads iterate k. Every shard takes the tile
// plan of its shard-mode launch (err_plan3 of its depth), so its owned
// planes and its raw float64 error sum are mg3_jacobi_shard's, bit for bit;
// the caller adds the raw sums in shard order and scales them once.
#include "rdma3.cuh"

using namespace mgk3;

// steps <= 8 sweeps (the first the closed form from u ≡ 0 with from_zero) of
// each shard's block u_ptrs[s] (planes z0s[s]..z0s[s + 1] of the n^3 level;
// unread with from_zero) into out_ptrs[s]; err_mode ERR_NONE, ERR_CLEAN
// (effective sweeps <= 7) or ERR_GPU, with partials one double per tile of
// every shard, work the column pass's workspace for all of them
// (ops.kernels3.col3_work of the total) and raw[s] the shard's raw error
// sum. wa_ptrs[s] and wb_ptrs[s] are scratch windows of the shard's planes
// and depth = steps − from_zero + clean more a side (col3_scratch: wa for
// three sweeps or more or the clean error, wb for two or more; else
// unread). (ty, tx) and czs[s]: each shard's tile plan (err_plan3 of its
// depth). ws is the ring workspace of ops/rdma3.py; tag is above every tag
// it has seen.
extern "C" int mg3_rdma_jacobi(const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* out_ptrs,
                               const unsigned long long* wa_ptrs,
                               const unsigned long long* wb_ptrs, const int* z0s,
                               const int* czs, int shards, int n, int steps, int from_zero,
                               int err_mode, int ty, int tx, double* partials, double* work,
                               double* raw, const unsigned long long* ws,
                               unsigned long long tag, float h2, float w, float inv_h2,
                               void* stream) {
  const int clean = err_mode == ERR_CLEAN ? 1 : 0, errors = err_mode != ERR_NONE;
  const int depth = steps - (from_zero ? 1 : 0) + clean;  // the planes a side the sweeps read
  if (steps < 1 || steps > MAX_STEPS3 || depth > MAX_STEPS3 ||
      (errors && err_mode != ERR_CLEAN && err_mode != ERR_GPU) ||
      (errors && (partials == nullptr || raw == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  RingCol3 a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  int units = 0;
  if ((e = ring_col3_setup(a, f_ptrs, czs, depth, ty, tx, work, errors, h2, w, inv_h2, &units,
                           st)) != cudaSuccess)
    return (int)e;
  bool need_wa, need_wb;
  col3_scratch(steps, true, clean, &need_wa, &need_wb);
  for (int s = 0; s < shards; ++s) {
    a.u[s] = from_zero ? nullptr : (const float*)u_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.wa[s] = (float*)wa_ptrs[s];
    a.wb[s] = (float*)wb_ptrs[s];
    if (a.out[s] == nullptr || (need_wa && a.wa[s] == nullptr) ||
        (need_wb && a.wb[s] == nullptr) || (!from_zero && a.u[s] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  a.partials = errors ? partials : nullptr;
  a.tag = tag;
  a.steps = steps;
  a.mode = err_mode;
  a.tail = 0;
  // one closed-form sweep without the error's read takes no halo plane: no post
  if ((depth > 0 && (e = ring_post3(a, false, st)) != cudaSuccess) ||
      (e = ring_sweeps3(a, true, steps + clean, units, st)) != cudaSuccess || !errors)
    return (int)e;
  return (int)ring_raw3(a, raw, st);
}
