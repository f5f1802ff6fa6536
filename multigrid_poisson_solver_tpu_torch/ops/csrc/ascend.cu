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
#include "legs.cuh"

using namespace mgk;

static __global__ void __launch_bounds__(THREADS)
ascend_kernel(const float* __restrict__ u, const float* __restrict__ f,
              const float* __restrict__ c, float* __restrict__ out,
              float* __restrict__ partials, int n, int steps, int halo, int err_mode,
              float h2, float omega, float inv_h2) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  ascend_tile(smem, u, f, c, out, partials ? partials + t : nullptr, blockIdx.x, blockIdx.y, n,
              steps, halo, err_mode, h2, omega, inv_h2);
}

// Fine level n = 2m − 1: out = k sweeps of (u + prolong(c)) with c the m x m
// coarse correction. Error arguments as mg_jacobi.
extern "C" int mg_ascend(const float* u, const float* f, const float* c, float* out,
                         float* partials, float* err_out, int n, int steps, int err_mode,
                         float h2, float omega, float inv_h2, float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || n < 3 || n % 2 == 0) return (int)cudaErrorInvalidValue;
  const int halo = jacobi_halo(steps, err_mode);
  cudaError_t e = cudaFuncSetAttribute(ascend_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)tile_smem_bytes(MAX_HALO));
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  ascend_kernel<<<tile_grid(n), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
      u, f, c, out, partials, n, steps, halo, err_mode, h2, omega, inv_h2);
  e = cudaGetLastError();
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(n), err_scale, err_out, s);
}
