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
#include "common.cuh"

using namespace mgk;

static __global__ void __launch_bounds__(THREADS)
residual_kernel(const float* __restrict__ u, const float* __restrict__ f,
                float* __restrict__ r, int n, float inv_h2, int negate) {
  extern __shared__ float smem[];
  const Tile t = make_tile(1, blockIdx.x, blockIdx.y);
  load_tile(smem, u, n, t);
  __syncthreads();
  for (int i = 1 + threadIdx.y; i < 1 + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = 1 + threadIdx.x; j < 1 + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (!in_grid(gi, gj, n)) continue;
      const size_t g = (size_t)gi * n + gj;
      float v = 0.0f;
      if (interior(gi, gj, n)) {
        v = residual_point(nb_sum(smem, t.cols, i, j), smem[i * t.cols + j], f[g], inv_h2);
        if (negate) v = -v;
      }
      r[g] = v;
    }
  }
}

extern "C" int mg_residual(const float* u, const float* f, float* r, int n, float inv_h2,
                           int negate, void* stream) {
  if (n < 3) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_floats(1) * sizeof(float);
  residual_kernel<<<tile_grid(n), dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      u, f, r, n, inv_h2, negate);
  return (int)cudaGetLastError();
}
