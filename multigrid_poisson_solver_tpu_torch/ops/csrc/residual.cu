// 5-point residual r = (Σnb − 4u)/h² − f on the interior, 0 elsewhere,
// optionally negated.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _residual_kernel, reached through residual_pallas.
//
// Bound: device-memory bandwidth, one pass that reads u and f and writes r
// (12 B per point). Design: each block stages its 32 x 128 tile of u with a
// one-cell halo in shared memory, so every u value is read from device memory
// about once (1.08x for the halo); f and r are streamed once, coalesced.
//
// Shard mode (_residual_shard_call, reached through parallel/pallas_shard.py's
// sharded_residual_pallas): the residual of one shard's block, u and f
// extended by the ring neighbours' halo rows (and columns); masks by global
// index; r laid out as the block.
#include "common.cuh"

using namespace mgk;

template <bool SHARD>
static __global__ void __launch_bounds__(THREADS)
residual_kernel(const float* __restrict__ u_, const float* __restrict__ f_,
                float* __restrict__ r, Geo g_, int ext_r, int ext_c, float inv_h2, int negate) {
  extern __shared__ float smem[];
  const Geo g = region<SHARD>(g_);
  const Win u = region<SHARD>(u_, g, ext_r, ext_c), f = region<SHARD>(f_, g, ext_r, ext_c);
  const int n = g.n;
  const Tile t = make_tile(g, 1, blockIdx.x, blockIdx.y);
  load_tile(smem, u, n, t);
  __syncthreads();
  for (int i = 1 + threadIdx.y; i < 1 + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = 1 + threadIdx.x; j < 1 + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (!owned(g, gi, gj)) continue;
      float v = 0.0f;
      if (interior(gi, gj, n)) {
        v = residual_point(nb_sum(smem, t.cols, i, j), smem[i * t.cols + j],
                           f.p[(ptrdiff_t)(gi - f.r0) * f.cols + (gj - f.c0)], inv_h2);
        if (negate) v = -v;
      }
      r[out_at(g, gi, gj)] = v;
    }
  }
}

// The residual of the rows x cols block at global (row0, col0) into r (laid
// out as the block); u and f are the block extended by ext_r rows and ext_c
// columns per side (ext >= 1 where the block has a neighbour).
extern "C" int mg_residual_shard(const float* u, const float* f, float* r, int n, int row0,
                                 int col0, int rows, int cols, int ext_r, int ext_c,
                                 float inv_h2, int negate, void* stream) {
  if (n < 3 || rows < 1 || cols < 1 || row0 < 0 || col0 < 0 || row0 + rows > n ||
      col0 + cols > n || ext_r < 0 || ext_c < 0)
    return (int)cudaErrorInvalidValue;
  const Geo g(n, row0, col0, rows, cols);
  const size_t smem = tile_floats(1) * sizeof(float);
  const auto kernel =
      whole_grid(g, ext_r, ext_c) ? residual_kernel<false> : residual_kernel<true>;
  kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      u, f, r, g, ext_r, ext_c, inv_h2, negate);
  return (int)cudaGetLastError();
}

extern "C" int mg_residual(const float* u, const float* f, float* r, int n, float inv_h2,
                           int negate, void* stream) {
  return mg_residual_shard(u, f, r, n, 0, 0, n, n, 0, 0, inv_h2, negate, stream);
}
