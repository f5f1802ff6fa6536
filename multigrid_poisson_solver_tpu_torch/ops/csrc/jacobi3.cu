// Multi-sweep damped-Jacobi smoother for the 7-point stencil, with an
// optional smoothing error, of the final iterate or of every iterate.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _fused_jacobi3_kernel (its plain, from_zero, clean, gpu, per_sweep and
// emit_residual modes), reached through fused_jacobi3_padded,
// fused_jacobi3_errs_padded and fused_jacobi3_residual_padded.
//
// Bound: device-memory bandwidth. One unfused fp32 sweep reads u and f and
// writes u, 12 B per point; the TPU kernel fuses k <= 8 sweeps into one pass
// that moves the same 12 B for all k. Design: not fused. k sweeps are k
// column passes of col3.cuh, one launch each (a thread streams one (y, x)
// column down z with no barrier inside the pass), the iterates alternating
// between out and a scratch volume so that u_k lands in out. The port's
// first version, a fused trapezoid (a 2.5-D tile pipeline with a barrier
// after every stage and plane, one 512-thread block an SM), took 5.48 ms
// for 3 sweeps and the clean error at 513³, where a column pass takes 0.72
// ms a sweep (PERF.md).
// from_zero: the first pass reads only f and writes the closed form
// (ω/6)·(−h²f) (u is never read), on every plane a later pass reads. The
// clean error of u_k is Σ|r|/n³, r the plain path's residual, from one more
// pass that reads u_k and writes nothing; the gpu error Σ|u_k −
// u_{k−1}|·6/h²/n³ from the pass that makes u_k. Errors are summed in
// float64 per tile of the tile plan (ops.kernels3.err_plan3 by default, the
// trigger loops' plan) in block_sum3's order, then by a second kernel in a
// fixed order, so an error launch's partials are those of every other
// launch with that plan, bit for bit (col3.cuh).
//
// per_sweep (the trigger loop's batched passes, mg3_jacobi_errs): the same
// passes with the error of every iterate u_1..u_k of k <= 7 (clean) or 8
// (gpu) sweeps, each into its own row of partials (k rows of one double per
// tile of err_plan3), so row s − 1 sums to what a launch of s sweeps
// reports. The 7-sweep clean pass at 513³ moves 7 · 1.62 GB + 1.08 GB, 3.7
// ms at 3.35 TB/s.
//
// emit_residual (fused_jacobi3_residual_padded, mg3_jacobi_residual: k <= 7
// effective sweeps, then the optionally negated residual of the last
// iterate, with its clean error on request, as JAX's err_mode="clean"):
// the k sweeps' passes with the last one writing iterate k on one plane
// more a side (col3_schedule's tail 1), then one residual pass
// (col3_residual_unit, residual3.cu's body) that reads it and writes r,
// adding |r| into the error plan's partials, so its raw sum is the clean
// pass's bit for bit. From zero the closed-form pass is folded into the
// next sweep, which forms u_1 = (ω/6)·(−h²f) from f at its loads
// (col3_passes' FOLD; pointwise, so bit for bit the stored closed form).
// Fused, the mode moves 12 B a point (f in, u and r out); these passes move
// 32 B a point from zero with 3 sweeps on the whole grid (8 for the folded
// sweep, 12 for the last, 12 for the residual) and 36 on a shard (the last
// sweep also writes the owned planes). Its passes launch kernels of their
// own names (jacobi3_residual_sweep_kernel, jacobi3_residual_kernel), so a
// profile tells them from kernel 10's other modes and from kernel 13.
//
// Shard mode (pallas3d.py, _fused_jacobi3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_fused_jacobi3, _err, _errs and
// sharded_smooth_residual3): every mode above on one z-shard's planes of a
// sharded level, the inputs the owned planes extended by the ring
// neighbours' planes; sweep s writes the owned planes and the k + clean +
// tail − s more per side that the later passes read, the iterates
// alternating between two scratch windows; a shard's errors come back as
// raw float64 sums over its owned planes, for the caller to add in shard
// order and scale once. The whole grid keeps the SHARD = false passes.
#include "col3.cuh"

using namespace mgk3;

// steps <= 8 sweeps of u (unread when from_zero) into out. err_mode ERR_NONE,
// ERR_CLEAN (effective sweeps <= 7) or ERR_GPU; with an error, partials
// holds one double per tile of the plan (ty, tx, cz; at most THREADS3 cells
// a tile), and err_out[0] receives the metric times err_scale. mid is an
// n^3 scratch volume (unused for one sweep), work the column pass's
// workspace (ops.kernels3.col3_work of the tile count; unused without an
// error).
extern "C" int mg3_jacobi(const float* u, const float* f, float* out, float* mid,
                          double* partials, double* work, float* err_out, int n, int steps,
                          int from_zero, int err_mode, int ty, int tx, int cz, float h2, float w,
                          float inv_h2, double err_scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {out, mid};
  int tiles = 0;
  const cudaError_t e =
      col3_passes(false, from_zero ? nullptr : u, f, it, nullptr, partials, work, n, 0, n, 0,
                  steps, err_mode, ROWS_LAST, ty, tx, cz, h2, w, inv_h2, &tiles, s);
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  sum_partials3_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, err_scale, err_out);
  return (int)cudaGetLastError();
}

// The same on the owned planes [z0, z0 + nz) of a z-sharded n^3 level: u and
// f are those planes extended by ext planes per side (ext >= the pass's halo
// wherever a neighbour lies), out the owned planes, wa and wb scratch
// windows shaped as u (col3_scratch: wa for three sweeps or more or the
// clean error's read, wb for two or more); with an error, raw_out[0]
// receives the shard's raw sum over its owned planes (partials one double
// per tile of the shard). lagged: the clean error is that of the iterate
// the last sweep reads, from that sweep's stencil read (ROWS_LAGGED).
extern "C" int mg3_jacobi_shard(const float* u, const float* f, float* out, float* wa, float* wb,
                                double* partials, double* work, double* raw_out, int n, int z0,
                                int nz, int ext, int steps, int from_zero, int err_mode,
                                int lagged, int ty, int tx, int cz, float h2, float w,
                                float inv_h2, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {wa, wb};
  int tiles = 0;
  const cudaError_t e = col3_passes(true, from_zero ? nullptr : u, f, it, out, partials, work,
                                    n, z0, nz, ext, steps, err_mode,
                                    lagged ? ROWS_LAGGED : ROWS_LAST, ty, tx, cz, h2, w, inv_h2,
                                    &tiles, s);
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  sum_partials3_raw_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, raw_out);
  return (int)cudaGetLastError();
}

// steps <= 8 sweeps of u into out with the error of every iterate: partials
// holds steps rows of one double per tile, errs[s − 1] receives the metric of
// iterate s times err_scale. err_mode ERR_CLEAN (steps <= 7) or ERR_GPU. mid
// is an n^3 scratch volume (unused for one sweep), work the column pass's
// workspace (ops.kernels3.col3_work of the plan's tile count).
extern "C" int mg3_jacobi_errs(const float* u, const float* f, float* out, float* mid,
                               double* partials, double* work, float* errs, int n, int steps,
                               int err_mode, int ty, int tx, int cz, float h2, float w,
                               float inv_h2, double err_scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {out, mid};
  int tiles = 0;
  if (err_mode != ERR_CLEAN && err_mode != ERR_GPU) return (int)cudaErrorInvalidValue;
  const cudaError_t e = col3_passes(false, u, f, it, nullptr, partials, work, n, 0, n, 0, steps,
                                    err_mode, ROWS_EVERY, ty, tx, cz, h2, w, inv_h2, &tiles, s);
  if (e != cudaSuccess) return (int)e;
  sum_partials3_kernel<<<steps, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, err_scale, errs);
  return (int)cudaGetLastError();
}

// The same on a shard's planes (geometry as mg3_jacobi_shard): raws[s − 1]
// receives the shard's raw sum for iterate s. wa and wb are scratch windows
// shaped as u (as mg3_jacobi_shard's); out receives the owned planes.
extern "C" int mg3_jacobi_errs_shard(const float* u, const float* f, float* out, float* wa,
                                     float* wb, double* partials, double* work, double* raws,
                                     int n, int z0, int nz, int ext, int steps, int err_mode,
                                     int ty, int tx, int cz, float h2, float w, float inv_h2,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {wa, wb};
  int tiles = 0;
  if (err_mode != ERR_CLEAN && err_mode != ERR_GPU) return (int)cudaErrorInvalidValue;
  const cudaError_t e = col3_passes(true, u, f, it, out, partials, work, n, z0, nz, ext, steps,
                                    err_mode, ROWS_EVERY, ty, tx, cz, h2, w, inv_h2, &tiles, s);
  if (e != cudaSuccess) return (int)e;
  sum_partials3_raw_kernel<<<steps, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, raws);
  return (int)cudaGetLastError();
}

// emit_residual's passes: the sweeps under their own name (col3_pass_kernel's
// body; FOLD: from zero, the first is the sweep from the closed form, formed
// at its loads), and the residual pass (residual3.cu's body; ERR: the clean
// error's partials).
template <bool SHARD, bool ZERO, bool FOLD>
static __global__ void __launch_bounds__(COL3_THREADS)
jacobi3_residual_sweep_kernel(Col3 C, Col3Pass P) {
  col3_unit<false, SHARD, ZERO, FOLD>(C, P, blockIdx.x);
}

template <bool ERR>
static __global__ void __launch_bounds__(COL3_THREADS)
jacobi3_residual_kernel(Col3 C, const float* __restrict__ u, float* __restrict__ r, int negate,
                        double* partials) {
  col3_residual_unit<ERR>(C, u, r, negate, partials, blockIdx.x);
}

struct ResidualSweeps {
  template <bool SHARD, bool ZERO>
  static void launch(const Col3& C, const Col3Pass& P, cudaStream_t stream) {
    jacobi3_residual_sweep_kernel<SHARD, ZERO, false>
        <<<col3_units(C), COL3_THREADS, 0, stream>>>(C, P);
  }
  template <bool SHARD>
  static void launch_fold(const Col3& C, const Col3Pass& P, cudaStream_t stream) {
    jacobi3_residual_sweep_kernel<SHARD, false, true>
        <<<col3_units(C), COL3_THREADS, 0, stream>>>(C, P);
  }
};

// steps sweeps of u (nullptr: from zero; at most 7 after the closed-form
// one) on the owned planes [z0, z0 + nz) into it[0] (and the owned planes
// into `own` when given), iterate k on one plane more a side, then its
// residual (negated when negate) into r's owned planes, with the clean
// error's partials when partials is given. Returns the plan's tile count in
// *tiles.
static cudaError_t jacobi3_residual_passes(bool shard, const float* u, const float* f,
                                           float* const it[2], float* own, float* r,
                                           double* partials, double* work, int n, int z0,
                                           int nz, int ext, int steps, int negate, int ty,
                                           int tx, int cz, float h2, float w, float inv_h2,
                                           int* tiles, cudaStream_t stream) {
  const int sweeps = steps - (u == nullptr);
  if (steps < 1 || sweeps > MAX_STEPS3 - 1 || r == nullptr ||
      (partials != nullptr && work == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = col3_passes<ResidualSweeps, true>(shard, u, f, it, own, nullptr, nullptr, n, z0,
                                                    nz, ext, steps, ERR_NONE, ROWS_LAST, ty, tx,
                                                    cz, h2, w, inv_h2, tiles, stream, 1);
  if (e != cudaSuccess) return e;
  Col3 C;
  if ((e = col3_setup(C, 1, f, work, n, z0, nz, ext, ty, tx, cz, h2, w, inv_h2, stream,
                      partials != nullptr)) != cudaSuccess)
    return e;
  *tiles = col3_tiles(C);
  if (partials != nullptr)
    jacobi3_residual_kernel<true><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, it[0], r, negate,
                                                                              partials);
  else
    jacobi3_residual_kernel<false><<<col3_units(C), COL3_THREADS, 0, stream>>>(C, it[0], r,
                                                                               negate, nullptr);
  return cudaGetLastError();
}

// emit_residual on the n^3 grid: steps sweeps of u (unread when from_zero)
// into out and the residual of the result (negated when negate) into r. mid
// is an n^3 scratch volume (unused for one sweep). want_err: the clean error
// of the result, Σ|r| as a raw float64 sum into raw_out[0] (partials one
// double per tile of the plan (ty, tx, cz; at most THREADS3 cells a tile),
// work the column pass's workspace, ops.kernels3.col3_work of the tile
// count).
extern "C" int mg3_jacobi_residual(const float* u, const float* f, float* out, float* mid,
                                   float* r, double* partials, double* work, double* raw_out,
                                   int n, int steps, int from_zero, int negate, int want_err,
                                   int ty, int tx, int cz, float h2, float w, float inv_h2,
                                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {out, mid};
  int tiles = 0;
  if (want_err && (partials == nullptr || raw_out == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      jacobi3_residual_passes(false, from_zero ? nullptr : u, f, it, nullptr, r,
                              want_err ? partials : nullptr, work, n, 0, n, 0, steps, negate, ty,
                              tx, cz, h2, w, inv_h2, &tiles, s);
  if (e != cudaSuccess || !want_err) return (int)e;
  sum_partials3_raw_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, raw_out);
  return (int)cudaGetLastError();
}

// The same on the owned planes [z0, z0 + nz) of a z-sharded n^3 level: u and
// f those planes extended by ext >= k + 1 planes per side (k the
// neighbour-reading sweeps) wherever a neighbour lies, out and r the owned
// planes, wa and wb scratch windows shaped as u (wb unused for one sweep);
// with want_err, raw_out[0] receives the shard's raw Σ|r| over its owned
// planes (partials one double per tile of the shard's plan).
extern "C" int mg3_jacobi_residual_shard(const float* u, const float* f, float* out, float* wa,
                                         float* wb, float* r, double* partials, double* work,
                                         double* raw_out, int n, int z0, int nz, int ext,
                                         int steps, int from_zero, int negate, int want_err,
                                         int ty, int tx, int cz, float h2, float w, float inv_h2,
                                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {wa, wb};
  int tiles = 0;
  if (want_err && (partials == nullptr || raw_out == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      jacobi3_residual_passes(true, from_zero ? nullptr : u, f, it, out, r,
                              want_err ? partials : nullptr, work, n, z0, nz, ext, steps, negate,
                              ty, tx, cz, h2, w, inv_h2, &tiles, s);
  if (e != cudaSuccess || !want_err) return (int)e;
  sum_partials3_raw_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, raw_out);
  return (int)cudaGetLastError();
}
