// The whole multigrid descend leg in one kernel: k damped-Jacobi sweeps, the
// residual of the final iterate, and its 2:1 restriction (sampling or full
// weighting) written straight into the coarse right-hand side, plus an
// optional fused smoothing error on the finest level.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _fused_descend_kernel, reached through fused_descend_padded, together with
// the lane decimation it leaves to XLA (ops/padded.py, restrict_lanes_p).
//
// Bound: device-memory bandwidth. Done as separate passes the leg moves
// 12 B per point per sweep, then 12 for the residual and 4 + 1 for the
// restriction; fused it reads u and f once, writes u once and writes the
// coarse grid (a quarter of the points): about 13 B per fine point for the
// whole leg. Design: blocks own 32 x 128 fine tiles at even origins, which
// is exactly a 16 x 64 tile of coarse points, so the restriction needs no
// exchange between blocks. The tile is staged with a halo of k + 1 (the
// residual reads the final iterate's neighbors) + 1 for full weighting; the
// sweeps run as in jacobi.cu; the negated residual lands in the spare
// ping-pong buffer and each coarse point is formed from it in the plain
// twin's order. Coarse boundary points are written as 0. The tile's work is
// descend_tile in legs.cuh.
//
// Shard mode (_fused_descend_shard_call, reached through
// parallel/pallas_shard.py's sharded_fused_descend): the leg on one shard's
// block, extended by the ring neighbours' halo rows (and columns), at an even
// global origin. The block's coarse points (rows from row0 / 2, (rows + 1) / 2
// of them; the same for columns) go to fc, which is laid out as that coarse
// block; the error is the shard's raw partial over its owned cells.
#include "legs.cuh"

using namespace mgk;

template <bool SHARD>
static __global__ void __launch_bounds__(THREADS)
descend_kernel(const float* __restrict__ u, const float* __restrict__ f, float* __restrict__ out,
               float* __restrict__ fc, float* __restrict__ partials, Geo g_, int ext_r,
               int ext_c, int n_sweeps, int halo, int from_zero, int full_weighting,
               int err_mode, float h2, float omega, float inv_h2, float zero_coef) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const Geo g = region<SHARD>(g_);
  descend_tile(smem, region<SHARD>(u, g, ext_r, ext_c), region<SHARD>(f, g, ext_r, ext_c), out,
               fc,
               partials ? partials + t : nullptr, blockIdx.x, blockIdx.y, g, n_sweeps, halo,
               from_zero, full_weighting, err_mode, h2, omega, inv_h2, zero_coef);
}

// steps <= MAX_STEPS sweeps of the rows x cols block at global (row0, col0)
// (both even) of the n x n level (n = 2m − 1) into out, the restricted
// negated residual of its coarse points into fc ((rows + 1) / 2 x
// (cols + 1) / 2). u and f are the block extended by ext_r rows and ext_c
// columns per side (ext >= steps + 1, + 1 for full weighting). Error
// arguments as mg_jacobi_shard.
extern "C" int mg_descend_shard(const float* u, const float* f, float* out, float* fc,
                                float* partials, float* err_out, int n, int row0, int col0,
                                int rows, int cols, int ext_r, int ext_c, int steps,
                                int from_zero, int full_weighting, int err_mode, float h2,
                                float omega, float inv_h2, float zero_coef, float err_scale,
                                void* stream) {
  if (steps < 1 || steps > MAX_STEPS || n < 3 || n % 2 == 0 || rows < 1 || cols < 1 ||
      row0 < 0 || col0 < 0 || row0 % 2 || col0 % 2 || row0 + rows > n || col0 + cols > n ||
      ext_r < 0 || ext_c < 0)
    return (int)cudaErrorInvalidValue;
  const Geo g(n, row0, col0, rows, cols);
  const int n_sweeps = steps - (from_zero ? 1 : 0);
  const int halo = descend_halo(n_sweeps, full_weighting);
  const auto kernel =
      whole_grid(g, ext_r, ext_c) ? descend_kernel<false> : descend_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile_smem_bytes(MAX_HALO));
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
      u, f, out, fc, partials, g, ext_r, ext_c, n_sweeps, halo, from_zero, full_weighting,
      err_mode, h2, omega, inv_h2, zero_coef);
  e = cudaGetLastError();
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, err_out, s);
}

// steps <= MAX_STEPS sweeps of the n x n level (n = 2m − 1) into out, the
// restricted negated residual into the m x m fc. Error arguments as mg_jacobi.
extern "C" int mg_descend(const float* u, const float* f, float* out, float* fc,
                          float* partials, float* err_out, int n, int steps, int from_zero,
                          int full_weighting, int err_mode, float h2, float omega,
                          float inv_h2, float zero_coef, float err_scale, void* stream) {
  return mg_descend_shard(u, f, out, fc, partials, err_out, n, 0, 0, n, n, 0, 0, steps,
                          from_zero, full_weighting, err_mode, h2, omega, inv_h2, zero_coef,
                          err_scale, stream);
}
