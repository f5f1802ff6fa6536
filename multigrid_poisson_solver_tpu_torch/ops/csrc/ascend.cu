// The whole multigrid ascend leg in one kernel: 2:1 bilinear prolongation of
// the coarse correction, its interior-only add, and k post-smoothing sweeps,
// plus an optional fused smoothing error on the finest level.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _fused_ascend_kernel, reached through fused_ascend_padded, together with
// the lane expansion it leaves to XLA (ops/padded.py, prolong_lanes_p).
//
// Bound: device-memory bandwidth. Separate passes would write and re-read a
// fine-sized correction and then pay 12 B per point per sweep; fused, the leg
// reads u, f and the quarter-size coarse grid once and writes u once: about
// 13 B per fine point. Design: each block stages its 32 x 128 fine tile of u
// and f with a halo of k (+1 for the residual-based error), adds the
// prolonged correction to every staged interior cell, reading the coarse
// values it needs straight from the coarse (m, m) array (they are exact, so
// the halo carries no staleness from the add), then sweeps as jacobi.cu.
// Prolongation order: columns first (even: c, odd: ½a + ½b), then rows, as
// ops.transfers.prolong and the TPU kernel's row interleave compute it. The
// tile's work is ascend_tile in legs.cuh.
//
// Shard mode (_fused_ascend_shard_call, reached through
// parallel/pallas_shard.py's sharded_fused_ascend): the leg on one shard's
// block, extended by the ring neighbours' halo rows (and columns), at an even
// global origin, with a window of the coarse correction around the block's
// coarse points (its own coarse halo); the error is the shard's raw partial
// over its owned cells.
#include "legs.cuh"

using namespace mgk;

template <bool SHARD>
static __global__ void __launch_bounds__(THREADS)
ascend_kernel(const float* __restrict__ u, const float* __restrict__ f,
              const float* __restrict__ c, float* __restrict__ out, float* __restrict__ partials,
              Geo g_, int ext_r, int ext_c, int cr0, int cc0, int crows, int ccols, int steps,
              int halo, int err_mode, float h2, float omega, float inv_h2) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const Geo g = region<SHARD>(g_);
  const Win cw = SHARD ? Win{c, cr0, cc0, crows, ccols} : window(c, Geo((g.n + 1) / 2));
  ascend_tile(smem, region<SHARD>(u, g, ext_r, ext_c), region<SHARD>(f, g, ext_r, ext_c), cw,
              out, partials ? partials + t : nullptr,
              blockIdx.x, blockIdx.y, g, steps, halo, err_mode, h2, omega, inv_h2);
}

// Whether coarse indices [c0, c0 + cnt) hold every coarse index the interior
// fine indices in [lo, hi) interpolate from: i >> 1, and (i >> 1) + 1 for
// odd i.
static bool covers(int c0, int cnt, int lo, int hi, int n) {
  const int i_lo = lo > 1 ? lo : 1, i_hi = hi - 1 < n - 2 ? hi - 1 : n - 2;
  return i_lo > i_hi || (c0 <= (i_lo >> 1) && c0 + cnt > ((i_hi + 1) >> 1));
}

// The rows x cols block at global (row0, col0) (both even) of the level
// n = 2m − 1: out = k sweeps of (u + prolong(c)). u and f are the block
// extended by ext_r rows and ext_c columns per side (ext >= steps, + 1 with a
// cpu / clean error); c is the crows x ccols window of the m x m coarse
// correction at global (cr0, cc0), covering the coarse rows and columns the
// extended block's interior cells interpolate from (checked; zero where it
// leaves the coarse grid).
// Error arguments as mg_jacobi_shard.
extern "C" int mg_ascend_shard(const float* u, const float* f, const float* c, float* out,
                               float* partials, float* err_out, int n, int row0, int col0,
                               int rows, int cols, int ext_r, int ext_c, int cr0, int cc0,
                               int crows, int ccols, int steps, int err_mode, float h2,
                               float omega, float inv_h2, float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || n < 3 || n % 2 == 0 || rows < 1 || cols < 1 ||
      row0 < 0 || col0 < 0 || row0 % 2 || col0 % 2 || row0 + rows > n || col0 + cols > n ||
      ext_r < 0 || ext_c < 0 || crows < 1 || ccols < 1)
    return (int)cudaErrorInvalidValue;
  const Geo g(n, row0, col0, rows, cols);
  if (!covers(cr0, crows, row0 - ext_r, row0 + rows + ext_r, n) ||
      !covers(cc0, ccols, col0 - ext_c, col0 + cols + ext_c, n))
    return (int)cudaErrorInvalidValue;
  const int halo = jacobi_halo(steps, err_mode);
  const int m = (n + 1) / 2;
  // the whole grid reads the whole coarse grid
  const bool whole = whole_grid(g, ext_r, ext_c) && cr0 == 0 && cc0 == 0 && crows == m &&
                     ccols == m;
  const auto kernel = whole ? ascend_kernel<false> : ascend_kernel<true>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile_smem_bytes(MAX_HALO));
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
      u, f, c, out, partials, g, ext_r, ext_c, cr0, cc0, crows, ccols, steps, halo, err_mode, h2,
      omega, inv_h2);
  e = cudaGetLastError();
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, err_out, s);
}

// Fine level n = 2m − 1: out = k sweeps of (u + prolong(c)) with c the m x m
// coarse correction. Error arguments as mg_jacobi.
extern "C" int mg_ascend(const float* u, const float* f, const float* c, float* out,
                         float* partials, float* err_out, int n, int steps, int err_mode,
                         float h2, float omega, float inv_h2, float err_scale, void* stream) {
  const int m = (n + 1) / 2;
  return mg_ascend_shard(u, f, c, out, partials, err_out, n, 0, 0, n, n, 0, 0, 0, 0, m, m, steps,
                         err_mode, h2, omega, inv_h2, err_scale, stream);
}
