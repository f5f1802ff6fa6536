// Fused multi-sweep damped-Jacobi smoother with an optional fused
// smoothing-error reduction.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _fused_jacobi_kernel (Jacobi modes: plain sweeps, the cpu / clean / gpu
// fused error, from_zero), reached through fused_jacobi_padded and
// fused_jacobi_err_padded.
//
// Bound: device-memory bandwidth. One unfused fp32 sweep reads u and f and
// writes u, 12 B per point: 3.35 TB/s / 12 B = 279 GDoF/s on the H100 SXM
// data sheet. Design: temporal blocking. A block stages its 32 x 128 tile of
// u and f with a halo of k (+1 for a residual-based error) in shared memory,
// runs all k <= 8 sweeps there on two ping-pong buffers, each sweep on a
// region one cell smaller per side, and writes only its owned cells: one
// pass over device memory per k sweeps instead of k. The cost is redundant
// halo work, (32 + 2H)(128 + 2H) staged cells per 4096 owned ones.
// from_zero (the iterate is known to be 0): sweep 1 is the closed form
// -(ω/4)h²f on the interior and u is never read. The error partials go to a
// per-block buffer that a second one-block kernel sums in a fixed order,
// so the metric is deterministic and needs no atomics. The tile's work is
// jacobi_tile in legs.cuh.
//
// Two more modes of the same TPU kernel live here:
//  * per_sweep (fused_jacobi_errs_padded, the batched trigger loop): k <= 8
//    sweeps in one pass with the error of every iterate. The tile keeps one
//    partial per sweep (jacobi_errs_tile); a second pass sums each row of
//    partials in the fixed order, so errs[s − 1] is bit for bit the error a
//    launch of s sweeps reports. Bound as above: 12 B per point per pass.
//  * rb-GS (fused_rbgs_padded, fused_rbgs_err_padded): k <= 4 red-black
//    Gauss-Seidel sweeps per pass, each two parity-masked half-updates done in
//    place in shared memory, so a sweep consumes two halo cells; the cpu or
//    clean error is Σ|Δ| of one ω = 1 Jacobi step from the final iterate (the
//    TPU kernel's identity Δ = (h²/4)·r). Bound: 12 B per point per pass, the
//    same memory traffic as the Jacobi mode for half the sweeps per pass.
//
// Shard mode (pallas_kernels.py, _fused_jacobi_shard_call, reached through
// parallel/pallas_shard.py): every mode above on one shard's block of a
// sharded level. The inputs are the block extended by ext_r halo rows and
// ext_c halo columns per side, which the caller gathered from the ring
// neighbours; (row0, col0) is the block's global origin. Tiles are laid over
// the block, masks use global indices, only owned cells are written, and
// the error partials count owned cells only: a shard's output is the
// unsharded kernel's on its cells, bit for bit. The error comes back as the
// shard's raw partial (err_scale 1), for the caller to add over the shards
// in shard order and scale. Origin (0, 0) with no extension is the
// single-device kernel: mg_jacobi is mg_jacobi_shard on the whole grid, and
// that case launches the SHARD = false instantiation (common.cuh, region),
// in which the shard geometry folds away.
#include "legs.cuh"

using namespace mgk;

template <bool SHARD>
static __global__ void __launch_bounds__(THREADS)
jacobi_kernel(const float* __restrict__ u, const float* __restrict__ f, float* __restrict__ out,
              float* __restrict__ partials, Geo g_, int ext_r, int ext_c, int n_sweeps, int halo,
              int from_zero, int err_mode, float h2, float omega, float inv_h2,
              float zero_coef) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const Geo g = region<SHARD>(g_);
  jacobi_tile(smem, region<SHARD>(u, g, ext_r, ext_c), region<SHARD>(f, g, ext_r, ext_c), out,
              partials ? partials + t : nullptr, blockIdx.x, blockIdx.y, g, n_sweeps, halo,
              from_zero, err_mode, h2, omega, inv_h2, zero_coef);
}

extern "C" int mg_num_tiles(int n) {
  return num_tiles(n);
}

// Tiles of a rows x cols block (the partial count of a shard-mode launch).
extern "C" int mg_num_tiles_block(int rows, int cols) {
  return num_tiles(Geo(0, 0, 0, rows, cols));
}

extern "C" const char* mg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

static bool bad_geo(int n, int row0, int col0, int rows, int cols, int ext_r, int ext_c) {
  return n < 3 || rows < 1 || cols < 1 || row0 < 0 || col0 < 0 || row0 + rows > n ||
         col0 + cols > n || ext_r < 0 || ext_c < 0;
}

// steps <= MAX_STEPS sweeps of the block u (ignored when from_zero) into
// out, the owned rows x cols block at global (row0, col0); u and f are the
// block extended by ext_r rows and ext_c columns per side (the halo must
// cover the sweeps: ext >= steps, + 1 with a cpu / clean error). With
// err_mode != ERR_NONE, partials holds mg_num_tiles_block(rows, cols)
// floats and err_out[0] receives their sum times err_scale.
extern "C" int mg_jacobi_shard(const float* u, const float* f, float* out, float* partials,
                               float* err_out, int n, int row0, int col0, int rows, int cols,
                               int ext_r, int ext_c, int steps, int from_zero, int err_mode,
                               float h2, float omega, float inv_h2, float zero_coef,
                               float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || bad_geo(n, row0, col0, rows, cols, ext_r, ext_c))
    return (int)cudaErrorInvalidValue;
  const Geo g(n, row0, col0, rows, cols);
  const int n_sweeps = steps - (from_zero ? 1 : 0);
  const int halo = jacobi_halo(n_sweeps, err_mode);
  const auto kernel = whole_grid(g, ext_r, ext_c) ? jacobi_kernel<false> : jacobi_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile_smem_bytes(MAX_HALO));
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
      u, f, out, partials, g, ext_r, ext_c, n_sweeps, halo, from_zero, err_mode, h2, omega,
      inv_h2, zero_coef);
  e = cudaGetLastError();
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, err_out, s);
}

// steps <= MAX_STEPS sweeps of u (ignored when from_zero) into out. With
// err_mode != ERR_NONE, partials holds mg_num_tiles(n) floats and err_out[0]
// receives the scaled metric.
extern "C" int mg_jacobi(const float* u, const float* f, float* out, float* partials,
                         float* err_out, int n, int steps, int from_zero, int err_mode,
                         float h2, float omega, float inv_h2, float zero_coef,
                         float err_scale, void* stream) {
  return mg_jacobi_shard(u, f, out, partials, err_out, n, 0, 0, n, n, 0, 0, steps, from_zero,
                         err_mode, h2, omega, inv_h2, zero_coef, err_scale, stream);
}

template <bool SHARD>
static __global__ void __launch_bounds__(THREADS)
jacobi_errs_kernel(const float* __restrict__ u, const float* __restrict__ f,
                   float* __restrict__ out, float* __restrict__ partials, Geo g_, int ext_r,
                   int ext_c, int n_sweeps, int halo, int err_mode, float h2, float omega,
                   float inv_h2) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const Geo g = region<SHARD>(g_);
  jacobi_errs_tile(smem, region<SHARD>(u, g, ext_r, ext_c), region<SHARD>(f, g, ext_r, ext_c),
                   out, partials + t,
                   gridDim.x * gridDim.y, blockIdx.x, blockIdx.y, g, n_sweeps, halo, err_mode,
                   h2, omega, inv_h2);
}

// steps sweeps of the block u into out with the error of every iterate in
// errs_out[0..steps) (each row of partials summed times err_scale); partials
// holds steps * mg_num_tiles_block(rows, cols) floats. Geometry as
// mg_jacobi_shard.
extern "C" int mg_jacobi_errs_shard(const float* u, const float* f, float* out, float* partials,
                                    float* errs_out, int n, int row0, int col0, int rows,
                                    int cols, int ext_r, int ext_c, int steps, int err_mode,
                                    float h2, float omega, float inv_h2, float err_scale,
                                    void* stream) {
  const int halo = jacobi_halo(steps, err_mode);
  if (steps < 1 || steps > MAX_STEPS || halo > MAX_HALO || err_mode == ERR_NONE ||
      bad_geo(n, row0, col0, rows, cols, ext_r, ext_c))
    return (int)cudaErrorInvalidValue;
  const Geo g(n, row0, col0, rows, cols);
  const auto kernel =
      whole_grid(g, ext_r, ext_c) ? jacobi_errs_kernel<false> : jacobi_errs_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile_smem_bytes(MAX_HALO));
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
      u, f, out, partials, g, ext_r, ext_c, steps, halo, err_mode, h2, omega, inv_h2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, errs_out, s, steps);
}

// steps sweeps of u into out with the scaled error of every iterate in
// errs_out[0..steps); partials holds steps * mg_num_tiles(n) floats.
extern "C" int mg_jacobi_errs(const float* u, const float* f, float* out, float* partials,
                              float* errs_out, int n, int steps, int err_mode, float h2,
                              float omega, float inv_h2, float err_scale, void* stream) {
  return mg_jacobi_errs_shard(u, f, out, partials, errs_out, n, 0, 0, n, n, 0, 0, steps,
                              err_mode, h2, omega, inv_h2, err_scale, stream);
}

template <bool SHARD>
static __global__ void __launch_bounds__(THREADS)
rbgs_kernel(const float* __restrict__ u, const float* __restrict__ f, float* __restrict__ out,
            float* __restrict__ partials, Geo g_, int ext_r, int ext_c, int n_sweeps, int halo,
            int from_zero, int err_mode, float h2) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const Geo g = region<SHARD>(g_);
  rbgs_tile(smem, region<SHARD>(u, g, ext_r, ext_c), region<SHARD>(f, g, ext_r, ext_c), out,
            partials ? partials + t : nullptr, blockIdx.x, blockIdx.y, g, n_sweeps, halo,
            from_zero, err_mode, h2);
}

// steps <= 4 rb-GS sweeps of the block u (not read when from_zero) into out;
// err_mode ERR_NONE, ERR_CPU or ERR_CLEAN (then steps <= 3, partials holds
// mg_num_tiles_block(rows, cols) floats and err_out[0] receives their sum
// times err_scale). Geometry as mg_jacobi_shard; parity is global.
extern "C" int mg_rbgs_shard(const float* u, const float* f, float* out, float* partials,
                             float* err_out, int n, int row0, int col0, int rows, int cols,
                             int ext_r, int ext_c, int steps, int from_zero, int err_mode,
                             float h2, float err_scale, void* stream) {
  const int halo = rbgs_halo(steps, err_mode);
  if (steps < 1 || halo > MAX_STEPS || err_mode == ERR_GPU ||
      bad_geo(n, row0, col0, rows, cols, ext_r, ext_c))
    return (int)cudaErrorInvalidValue;
  const Geo g(n, row0, col0, rows, cols);
  const auto kernel = whole_grid(g, ext_r, ext_c) ? rbgs_kernel<false> : rbgs_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)rbgs_smem_bytes(MAX_STEPS));
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), rbgs_smem_bytes(halo), s>>>(
      u, f, out, partials, g, ext_r, ext_c, steps, halo, from_zero, err_mode, h2);
  e = cudaGetLastError();
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, err_out, s);
}

// steps <= 4 rb-GS sweeps of u (not read when from_zero) into out; err_mode
// ERR_NONE, ERR_CPU or ERR_CLEAN (then steps <= 3, partials holds
// mg_num_tiles(n) floats and err_out[0] receives the scaled metric).
extern "C" int mg_rbgs(const float* u, const float* f, float* out, float* partials,
                       float* err_out, int n, int steps, int from_zero, int err_mode, float h2,
                       float err_scale, void* stream) {
  return mg_rbgs_shard(u, f, out, partials, err_out, n, 0, 0, n, n, 0, 0, steps, from_zero,
                       err_mode, h2, err_scale, stream);
}
