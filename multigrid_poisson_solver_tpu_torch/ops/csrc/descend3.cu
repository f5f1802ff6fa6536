// The whole 3-D descend leg: k damped-Jacobi sweeps, the residual of the
// final iterate and its 2:1 restriction (full weighting or sampling) into
// the coarse right-hand side, with the clean smoothing error.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _fused_descend3_kernel, reached through fused_descend3_padded, together
// with the lane decimation it leaves to XLA (ops/padded3.py,
// restrict3_lanes_p).
//
// Bound: device-memory bandwidth. Fused, the leg reads u and f once, writes
// u once and writes the coarse grid (an eighth of the points): 12.5 B per
// fine point. Design: not fused (PERF.md: the port's first, fused trapezoid
// ran one 512-thread block an SM with a barrier after every stage and plane, and
// lost to column passes on the same sweeps at every size measured). A call
// is k + 2 launches of column passes (col3.cuh), each thread streaming one
// (y, x) column down z:
//   1. the k sweeps of col3_schedule, as kernel 10's fixed modes run them
//      (from_zero: the first a closed form over f), the iterates alternating
//      between out and a scratch volume so that iterate k lands in out, on
//      the owned planes and the 1 + (full weighting) more a side that the
//      next pass reads;
//   2. the residual pass: −r of iterate k from one stencil read, its clean
//      error summed in the error plan's order (the partial of kernel 10's
//      read-only pass), and the restriction's z step in the registers of the
//      column: s_K = (¼·d(2K − 1) + ½·d(2K)) + ¼·d(2K + 1) (or d(2K) for
//      sampling) stored per coarse plane K, n² floats each, so neither −r
//      nor the fine iterate is read again: 8 B read and 2 B written a point;
//   3. the restriction's y and x steps, a thread per coarse point reading
//      s_K at fine (2I + dy, 2J + dx), 0 on the coarse faces.
// Each z chunk of the plan walks one plane beyond it a side (full
// weighting), so its coarse planes need nothing from another block. The
// arithmetic is the twins' (ops/kernels3.py), in their operation
// order; r is the direct stencil (the TPU kernel takes it from the step Δ
// of a further sweep as 6Δ/(ωh²)), which keeps a cycle on the kernels on the
// plain cycle's iterates. Coarse boundary points are 0.
//
// Shard mode (pallas3d.py, _fused_descend3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_fused_descend3): the same passes on
// one z-shard's planes with an even global origin, so the shard's coarse
// planes start at z0 / 2 and a fine plane's parity is its global one; the
// sweeps write k + 1 + (full weighting) − s planes a side beyond the owned
// ones into two scratch windows (the halo the caller exchanged), the
// residual pass reads one plane beyond the owned ones and writes the
// shard's coarse planes [z0 / 2, (z0 + nz + 1) / 2), and the error comes
// back as a raw float64 sum over the owned planes.
#include "col3_legs.cuh"

using namespace mgk3;

// The residual pass over iterate k (u, laid out as the inputs): block b is
// unit b of descend3_residual_unit.
template <bool FW>
static __global__ void __launch_bounds__(COL3_THREADS)
descend3_residual_kernel(Col3 C, const float* u, float* s, double* partials) {
  const ptrdiff_t base = -(ptrdiff_t)(C.z0 - C.ext) * C.n * C.n;  // the inputs' global plane 0
  descend3_residual_unit<FW>(C, Col3Io{u + base, C.f + base, nullptr, nullptr}, s, partials,
                             blockIdx.x);
}

// The restriction's y and x steps: a thread per coarse point (32 x 8 a
// block, blockIdx.z the coarse plane).
template <bool FW>
static __global__ void __launch_bounds__(256)
descend3_restrict_kernel(const float* __restrict__ s, float* __restrict__ fc, int n, int K0) {
  descend3_restrict_at<FW>(s, fc, n, K0, blockIdx.z, blockIdx.y * 8 + threadIdx.y,
                           blockIdx.x * 32 + threadIdx.x);
}

// The leg on the owned planes [z0, z0 + nz) (z0 even): col3_schedule's
// sweeps of u (nullptr: from zero) into it[0] (and the owned planes into
// `own` when given), then the residual pass into s (the shard's coarse
// planes from z0 / 2 on, n² floats each) with the clean error's partials
// (partials nullptr: none), then the restriction into fc. Returns the
// error plan's tile count in *tiles.
static cudaError_t descend3_passes(bool shard, const float* u, const float* f,
                                   float* const it[2], float* own, float* s, float* fc,
                                   double* partials, double* work, int n, int z0, int nz, int ext,
                                   int steps, int full_weighting, int ty, int tx, int cz,
                                   float h2, float w, float inv_h2, int* tiles,
                                   cudaStream_t stream) {
  const int fw = full_weighting ? 1 : 0;
  const int sweeps = steps - (u == nullptr);
  if (steps < 1 || sweeps > (fw ? 6 : 7) || n % 2 == 0 || z0 % 2 || s == nullptr ||
      fc == nullptr || (partials != nullptr && work == nullptr))
    return cudaErrorInvalidValue;
  // iterate k on the owned planes and 1 + fw more a side, in it[0]
  cudaError_t e = col3_passes(shard, u, f, it, own, nullptr, nullptr, n, z0, nz, ext, steps,
                              ERR_NONE, ROWS_LAST, ty, tx, cz, h2, w, inv_h2, tiles, stream,
                              1 + fw);
  if (e != cudaSuccess) return e;
  Col3 C;
  if ((e = col3_setup(C, 1 + fw, f, work, n, z0, nz, ext, ty, tx, cz, h2, w, inv_h2, stream,
                      partials != nullptr)) != cudaSuccess)
    return e;
  *tiles = col3_tiles(C);
  if (fw)
    descend3_residual_kernel<true><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, it[0], s,
                                                                                partials);
  else
    descend3_residual_kernel<false><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, it[0], s,
                                                                                 partials);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int m = (n + 1) / 2, K0 = z0 / 2, nk = (z0 + nz + 1) / 2 - K0;
  const dim3 grid((m + 31) / 32, (m + 7) / 8, nk), block(32, 8);
  if (fw)
    descend3_restrict_kernel<true><<<grid, block, 0, stream>>>(s, fc, n, K0);
  else
    descend3_restrict_kernel<false><<<grid, block, 0, stream>>>(s, fc, n, K0);
  return cudaGetLastError();
}

// steps sweeps of the n^3 level (n = 2m − 1; u unread when from_zero) into
// out, the restricted −r into the m^3 fc. mid is an n^3 scratch volume
// (unused for one sweep), s one of m planes of n² floats (the restriction's
// z step). want_err: the clean error, with partials one double per tile of
// the plan (ty, tx, cz; at most THREADS3 cells a tile) and work the column
// pass's workspace (ops.kernels3.col3_work of the tile count), into
// err_out[0] (times err_scale).
extern "C" int mg3_descend(const float* u, const float* f, float* out, float* mid, float* s,
                           float* fc, double* partials, double* work, float* err_out, int n,
                           int steps, int from_zero, int full_weighting, int want_err, int ty,
                           int tx, int cz, float h2, float w, float inv_h2, double err_scale,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float* const it[2] = {out, mid};
  int tiles = 0;
  if (want_err && partials == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      descend3_passes(false, from_zero ? nullptr : u, f, it, nullptr, s, fc,
                      want_err ? partials : nullptr, work, n, 0, n, 0, steps, full_weighting, ty,
                      tx, cz, h2, w, inv_h2, &tiles, st);
  if (e != cudaSuccess || !want_err) return (int)e;
  sum_partials3_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, st>>>(partials, tiles, err_scale,
                                                              err_out);
  return (int)cudaGetLastError();
}

// The same on the owned planes [z0, z0 + nz) of a z-sharded level, z0 even:
// u and f those planes extended by ext >= k + 1 + full_weighting planes per
// side (k the neighbour-reading sweeps) wherever a neighbour lies, out the
// owned planes, wa and wb scratch windows shaped as u (wb unused for one
// sweep), s the (z0 + nz + 1) / 2 − z0 / 2 coarse planes' z steps (n² floats
// each), fc those coarse planes [z0 / 2, (z0 + nz + 1) / 2) (m² each); with
// want_err, raw_out[0] receives the shard's raw Σ|r| over its owned planes
// (partials one double per tile of the shard's plan).
extern "C" int mg3_descend_shard(const float* u, const float* f, float* out, float* wa,
                                 float* wb, float* s, float* fc, double* partials, double* work,
                                 double* raw_out, int n, int z0, int nz, int ext, int steps,
                                 int from_zero, int full_weighting, int want_err, int ty, int tx,
                                 int cz, float h2, float w, float inv_h2, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float* const it[2] = {wa, wb};
  int tiles = 0;
  if (want_err && partials == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      descend3_passes(true, from_zero ? nullptr : u, f, it, out, s, fc,
                      want_err ? partials : nullptr, work, n, z0, nz, ext, steps, full_weighting,
                      ty, tx, cz, h2, w, inv_h2, &tiles, st);
  if (e != cudaSuccess || !want_err) return (int)e;
  sum_partials3_raw_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, st>>>(partials, tiles, raw_out);
  return (int)cudaGetLastError();
}
