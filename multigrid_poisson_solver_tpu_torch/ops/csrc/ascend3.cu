// The whole 3-D ascend leg: the trilinear prolongation of the coarse
// correction, its add on the interior and k post-sweeps, with the clean
// smoothing error optionally.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _fused_ascend3_kernel, reached through fused_ascend3_padded, together with
// the lane expansion it leaves to XLA (ops/padded3.py, prolong3_lanes_p).
//
// Bound: device-memory bandwidth. Fused, the leg reads u, f and the coarse
// grid (an eighth of the points) once and writes u once: 12.5 B per fine
// point. Design: not fused (PERF.md: the port's first, fused trapezoid ran one
// 512-thread block an SM with a barrier after every stage and plane, and
// lost to column passes on the same sweeps at every size measured). A call
// is one prolongation pass and the k (+1) column passes of col3.cuh:
//   1. u0 = u plus the prolonged correction on the interior (even points
//      copy, odd ones average two, four or eight coarse values, along z,
//      then y, then x, as models.poisson3d.prolong3, the coarse values held
//      in registers), u elsewhere, a thread per (y, x) column over PRO3_CHUNK
//      planes: 4.5 B read and 4 B written a point, into the scratch volume
//      the first sweep does not write;
//   2. col3_schedule's k sweeps from u0, as kernel 10's fixed modes run
//      them, iterate k landing in out, and with the clean error one more
//      pass that only reads it (the partials of kernel 10's read-only pass).
//
// Shard mode (pallas3d.py, _fused_ascend3_shard_call, reached through
// parallel/pallas_shard3.py's sharded_fused_ascend3): the same passes on
// one z-shard's planes with an even global origin, reading a window of the
// coarse correction's planes around the shard's coarse points (the TPU
// kernel reads a lane-expanded window; here the prolongation is formed on
// all three axes); the prolongation applies on every window plane a sweep
// reads (k + clean a side beyond the owned ones), halo planes included; the
// error, when asked for, comes back as the shard's raw float64 sum over its
// owned planes.
#include "col3_legs.cuh"

using namespace mgk3;

// u0 = u + prolong(c) on the interior, u elsewhere (ascend3_prolong_col):
// column (y, x) of a 32 x 8 tile over the planes [plo + PRO3_CHUNK ·
// blockIdx.z, ...) ∩ [plo, phi) of a level whose windows start at global
// plane zb; c holds the coarse planes from cz0 on.
static __global__ void __launch_bounds__(256)
ascend3_prolong_kernel(const float* __restrict__ u, const float* __restrict__ c,
                       float* __restrict__ u0, int n, int zb, int plo, int phi, int cz0) {
  const int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 8 + threadIdx.y;
  if (x >= n || y >= n) return;
  const int zs = plo + PRO3_CHUNK * blockIdx.z, ze = min(zs + PRO3_CHUNK, phi);
  const size_t pl = (size_t)n * n, mp = (size_t)((n + 1) / 2) * ((n + 1) / 2);
  ascend3_prolong_col(flat3(u, zb, pl), flat3(c, cz0, mp), u0 - (ptrdiff_t)zb * (ptrdiff_t)pl,
                      n, y, x, zs, ze);
}

// The leg on the owned planes [z0, z0 + nz) (z0 even; u and f extended by
// ext planes per side, c the coarse planes [cz0, cz0 + cnz)): the
// prolongation into one of it[0], it[1] (both shaped as u), then
// col3_schedule's sweeps into it[0] (or, given `own`, into its owned
// planes) with the error err_mode names. Returns the tile count in *tiles.
static cudaError_t ascend3_passes(bool shard, const float* u, const float* f, const float* c,
                                  int cz0, int cnz, float* const it[2], float* own,
                                  double* partials, double* work, int n, int z0, int nz, int ext,
                                  int steps, int err_mode, int ty, int tx, int cz, float h2,
                                  float w, float inv_h2, int* tiles, cudaStream_t stream) {
  if (steps < 1 || steps > MAX_STEPS3 || n % 2 == 0 || z0 % 2 || u == nullptr || c == nullptr ||
      it[0] == nullptr || it[1] == nullptr || (err_mode != ERR_NONE && err_mode != ERR_CLEAN))
    return cudaErrorInvalidValue;
  // the planes the sweeps read: k + clean a side, within the window
  const int halo = steps + (err_mode == ERR_CLEAN);
  Col3 C;
  cudaError_t e = col3_setup(C, halo, f, nullptr, n, z0, nz, ext, ty, tx, cz, h2, w, inv_h2,
                             stream, false);
  if (e != cudaSuccess) return e;
  const int plo = z0 - halo > 0 ? z0 - halo : 0, phi = z0 + nz + halo < n ? z0 + nz + halo : n;
  // the coarse planes its interior planes [flo, fhi] prolong from
  const int flo = plo > 1 ? plo : 1, fhi = phi - 1 < n - 2 ? phi - 1 : n - 2;
  if (flo <= fhi && (cz0 > (flo >> 1) || cz0 + cnz <= ((fhi + 1) >> 1)))
    return cudaErrorInvalidValue;
  // iterate 1 goes to it[0] when k − 1 is even (col3_schedule), so u0 to the other
  float* const u0 = (steps - 1) % 2 == 0 ? it[1] : it[0];
  const dim3 grid((n + 31) / 32, (n + 7) / 8, (phi - plo + PRO3_CHUNK - 1) / PRO3_CHUNK);
  ascend3_prolong_kernel<<<grid, dim3(32, 8), 0, stream>>>(u, c, u0, n, z0 - ext, plo, phi, cz0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return col3_passes(shard, u0, f, it, own, partials, work, n, z0, nz, ext, steps, err_mode,
                     ROWS_LAST, ty, tx, cz, h2, w, inv_h2, tiles, stream);
}

// u plus the prolonged m^3 correction c on the interior of the n^3 level
// (n = 2m − 1), then steps <= 8 sweeps into out; mid is an n^3 scratch
// volume. err_mode ERR_NONE or ERR_CLEAN (steps <= 7; partials one double
// per tile of the plan (ty, tx, cz; at most THREADS3 cells a tile), work the
// column pass's workspace (ops.kernels3.col3_work of the tile count),
// err_out[0] the metric times err_scale).
extern "C" int mg3_ascend(const float* u, const float* f, const float* c, float* out, float* mid,
                          double* partials, double* work, float* err_out, int n, int steps,
                          int err_mode, int ty, int tx, int cz, float h2, float w, float inv_h2,
                          double err_scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {out, mid};
  int tiles = 0;
  const cudaError_t e = ascend3_passes(false, u, f, c, 0, (n + 1) / 2, it, nullptr, partials,
                                       work, n, 0, n, 0, steps, err_mode, ty, tx, cz, h2, w,
                                       inv_h2, &tiles, s);
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  sum_partials3_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, err_scale, err_out);
  return (int)cudaGetLastError();
}

// The same on the owned planes [z0, z0 + nz) of a z-sharded level, z0 even:
// u and f those planes extended by ext >= steps + clean planes per side
// wherever a neighbour lies, c the coarse planes [cz0, cz0 + cnz) (m^2 each;
// every plane the prolonged window planes interpolate from), out the owned
// planes, wa and wb scratch windows shaped as u; with ERR_CLEAN, raw_out[0]
// receives the shard's raw Σ|r| over its owned planes (partials one double
// per tile of the shard's plan).
extern "C" int mg3_ascend_shard(const float* u, const float* f, const float* c, float* out,
                                float* wa, float* wb, double* partials, double* work,
                                double* raw_out, int n, int z0, int nz, int ext, int cz0, int cnz,
                                int steps, int err_mode, int ty, int tx, int cz, float h2,
                                float w, float inv_h2, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  float* const it[2] = {wa, wb};
  int tiles = 0;
  const cudaError_t e = ascend3_passes(true, u, f, c, cz0, cnz, it, out, partials, work, n, z0,
                                       nz, ext, steps, err_mode, ty, tx, cz, h2, w, inv_h2,
                                       &tiles, s);
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  sum_partials3_raw_kernel<<<1, dim3(BLOCK_X, BLOCK3_Y), 0, s>>>(partials, tiles, raw_out);
  return (int)cudaGetLastError();
}
