// Kernel 2's bf16 mode: the 5-point residual r = (Σnb − 4u)/h² − f of a
// bfloat16 state on the whole grid, 0 on the boundary, optionally negated
// (bf16.cuh: what it replaces and its contract).
//
// Design: residual.cu's one-launch tile kernel with the storage type bf16:
// a block stages its 32 x 128 tile of u with a one-cell halo in shared
// memory as float (each value read from device memory about once); f and r
// are streamed. Bound: device-memory bandwidth, 6 B a point.
#include "bf16.cuh"
#include "legs.cuh"

using namespace mgk;

static __global__ void __launch_bounds__(THREADS)
residual_bf16_kernel(const bf16* __restrict__ u, const bf16* __restrict__ f,
                     bf16* __restrict__ r, int n, float inv_h2, int negate) {
  extern __shared__ float smem[];
  const Geo g(n);
  const Tile t = make_tile(g, 1, blockIdx.x, blockIdx.y);
  load_tile(smem, window(u, g), n, t);
  __syncthreads();
  for (int i = 1 + threadIdx.y; i < 1 + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = 1 + threadIdx.x; j < 1 + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (gi >= n || gj >= n) continue;
      float v = 0.0f;
      if (interior(gi, gj, n)) {
        v = residual_point<bf16>(nb_sum<bf16>(smem, t.cols, i, j), smem[i * t.cols + j],
                                 to_f(f[(ptrdiff_t)gi * n + gj]), inv_h2);
        if (negate) v = -v;
      }
      r[(ptrdiff_t)gi * n + gj] = from_f<bf16>(v);
    }
  }
}

// The residual of the n x n bf16 grid u into r (negated with negate != 0).
extern "C" int mg_residual_bf16(const bf16* u, const bf16* f, bf16* r, int n, float inv_h2,
                                int negate, void* stream) {
  if (n < 3) return (int)cudaErrorInvalidValue;
  const Geo g(n);
  residual_bf16_kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_floats(1) * sizeof(float),
                         (cudaStream_t)stream>>>(u, f, r, n, inv_h2, negate);
  return (int)cudaGetLastError();
}
