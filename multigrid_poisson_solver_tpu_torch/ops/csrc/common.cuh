// Shared pieces of the port's 2-D stencil kernels: the tile geometry, the
// halo tile loader, the frozen-cell mask, the point updates, the fixed-order
// reductions and the launcher of the persistent (grid-synchronized) kernels.
//
// Every tile is a TILE_H x TILE_W window of an n x n fp32 grid (row-major,
// contiguous), staged in shared memory with a halo of `halo` cells per side.
// Tiles are numbered row-major, t = ty * tiles_x(n) + tx. Cells outside
// [0, n)^2 load as 0; they and the Dirichlet boundary are frozen. A
// multi-sweep tile runs sweep s (1-based) on the staged region shrunk by s
// cells per side, ping-ponging two buffers: after k sweeps the region shrunk
// by k is exact, so a halo of k (+1 for each later stencil read of the final
// iterate) makes every owned cell exact. This is the GPU form of the TPU
// kernels' trapezoidal strips.
//
// Arithmetic uses the round-to-nearest intrinsics (__fadd_rn, __fmul_rn, ...)
// in the plain PyTorch twins' operation order. They are never contracted into
// FMAs, so a kernel can reproduce its twin bit for bit on the same card.
//
// Grid reads go through __ldcg (cached in L2 only). The persistent kernels
// read, after a grid-wide barrier, what other blocks wrote earlier in the
// same launch; an L1 or read-only-cache line from an earlier read could be
// stale, an L2 line cannot.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mgk {

constexpr int TILE_H = 32;    // owned rows per tile (even: 2:1 legs tile by it)
constexpr int TILE_W = 128;   // owned columns per tile (even)
constexpr int BLOCK_X = 32;   // one warp per thread row
constexpr int BLOCK_Y = 8;
constexpr int THREADS = BLOCK_X * BLOCK_Y;
constexpr int MAX_STEPS = 8;
constexpr int MAX_HALO = MAX_STEPS + 2;  // sweeps + residual read + full weighting

enum ErrMode { ERR_NONE = 0, ERR_CPU = 1, ERR_CLEAN = 2, ERR_GPU = 3 };

struct Tile {
  int gr0, gc0;    // global (row, col) of staged cell (0, 0)
  int rows, cols;  // staged extent; also the shared-memory row stride
};

static __host__ __device__ __forceinline__ int tiles_x(int n) {
  return (n + TILE_W - 1) / TILE_W;
}

static __host__ __device__ __forceinline__ int num_tiles(int n) {
  return tiles_x(n) * ((n + TILE_H - 1) / TILE_H);
}

static __device__ __forceinline__ Tile make_tile(int halo, int tx, int ty) {
  Tile t;
  t.gr0 = ty * TILE_H - halo;
  t.gc0 = tx * TILE_W - halo;
  t.rows = TILE_H + 2 * halo;
  t.cols = TILE_W + 2 * halo;
  return t;
}

static inline size_t tile_floats(int halo) {
  return (size_t)(TILE_H + 2 * halo) * (TILE_W + 2 * halo);
}

// Shared memory of a tile with f and two ping-pong buffers.
static inline size_t tile_smem_bytes(int halo) {
  return 3 * tile_floats(halo) * sizeof(float);
}

static inline dim3 tile_grid(int n) {
  return dim3(tiles_x(n), (n + TILE_H - 1) / TILE_H);
}

static __device__ __forceinline__ bool interior(int gi, int gj, int n) {
  return gi >= 1 && gi <= n - 2 && gj >= 1 && gj <= n - 2;
}

static __device__ __forceinline__ bool in_grid(int gi, int gj, int n) {
  return gi >= 0 && gi < n && gj >= 0 && gj < n;
}

// Stage g's window into s; cells outside the grid read as 0.
static __device__ void load_tile(float* s, const float* g, int n, const Tile& t) {
  for (int i = threadIdx.y; i < t.rows; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = threadIdx.x; j < t.cols; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      s[i * t.cols + j] = in_grid(gi, gj, n) ? __ldcg(g + (size_t)gi * n + gj) : 0.0f;
    }
  }
}

// ((N + S) + W) + E: the oracle's neighbor-sum order.
static __device__ __forceinline__ float nb_sum(const float* s, int ld, int i, int j) {
  const int k = i * ld + j;
  return __fadd_rn(__fadd_rn(__fadd_rn(s[k - ld], s[k + ld]), s[k - 1]), s[k + 1]);
}

// u + ω·(¼·((nb − 4u) − h²f))  (stencils.jacobi_sweep)
static __device__ __forceinline__ float jacobi_point(float nb, float uc, float fc,
                                                     float h2, float omega) {
  const float t = __fsub_rn(__fsub_rn(nb, __fmul_rn(4.0f, uc)), __fmul_rn(h2, fc));
  return __fadd_rn(uc, __fmul_rn(omega, __fmul_rn(0.25f, t)));
}

// (1/h²)·(nb − 4u) − f  (stencils.residual)
static __device__ __forceinline__ float residual_point(float nb, float uc, float fc,
                                                       float inv_h2) {
  return __fsub_rn(__fmul_rn(inv_h2, __fsub_rn(nb, __fmul_rn(4.0f, uc))), fc);
}

// One Jacobi sweep src -> dst over the staged region shrunk by `lo` >= 1;
// frozen cells are copied.
static __device__ void sweep(const float* src, float* dst, const float* sf,
                             const Tile& t, int lo, int n, float h2, float omega) {
  for (int i = lo + threadIdx.y; i < t.rows - lo; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = lo + threadIdx.x; j < t.cols - lo; j += BLOCK_X) {
      const int k = i * t.cols + j;
      const float uc = src[k];
      dst[k] = interior(gi, t.gc0 + j, n)
                   ? jacobi_point(nb_sum(src, t.cols, i, j), uc, sf[k], h2, omega)
                   : uc;
    }
  }
}

// Sweeps 1..n_sweeps starting from bufs[0]; returns the buffer index holding
// the final iterate. Ends with a barrier.
static __device__ int run_sweeps(float* bufs[2], const float* sf, const Tile& t,
                                 int n_sweeps, int n, float h2, float omega) {
  for (int s = 1; s <= n_sweeps; ++s) {
    sweep(bufs[(s - 1) & 1], bufs[s & 1], sf, t, s, n, h2, omega);
    __syncthreads();
  }
  return n_sweeps & 1;
}

// Write the owned window of the staged buffer back to the n x n grid g.
static __device__ void store_owned(float* __restrict__ g, const float* s, int n,
                                   const Tile& t, int halo) {
  for (int i = halo + threadIdx.y; i < halo + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = halo + threadIdx.x; j < halo + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (in_grid(gi, gj, n)) g[(size_t)gi * n + gj] = s[i * t.cols + j];
    }
  }
}

// Fixed-order sum over the block (xor-shuffle tree per warp, then one warp
// over the per-warp sums); the result is valid in thread (0, 0).
static __device__ float block_sum(float v) {
  __shared__ float warp_sums[BLOCK_Y];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x == 0) warp_sums[threadIdx.y] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.y == 0) {
    total = threadIdx.x < BLOCK_Y ? warp_sums[threadIdx.x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  return total;
}

// The fused smoothing-error partial of one tile over its owned interior
// cells: Σ|r(fin)| (ERR_CPU: even color only, the reference's color bug;
// ERR_CLEAN: all cells) or Σ|fin − prev| (ERR_GPU; prev == nullptr means
// the zero iterate). Needs fin exact on the owned window plus one ring for
// the residual modes. Written to *partial without atomics.
static __device__ void error_partial(float* __restrict__ partial, const float* fin,
                                     const float* prev, const float* sf, const Tile& t,
                                     int halo, int n, int err_mode, float inv_h2) {
  float acc = 0.0f;
  for (int i = halo + threadIdx.y; i < halo + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = halo + threadIdx.x; j < halo + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (!interior(gi, gj, n)) continue;
      if (err_mode == ERR_CPU && ((gi + gj) & 1)) continue;
      const int k = i * t.cols + j;
      if (err_mode == ERR_GPU) {
        acc += fabsf(__fsub_rn(fin[k], prev ? prev[k] : 0.0f));
      } else {
        acc += fabsf(residual_point(nb_sum(fin, t.cols, i, j), fin[k], sf[k], inv_h2));
      }
    }
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) *partial = total;
}

// Σ partials[0..count) in a fixed order (thread-strided, then block_sum);
// valid in thread (0, 0). Every block that calls it gets the same value.
static __device__ float fixed_sum(const float* partials, int count) {
  float v = 0.0f;
  for (int i = threadIdx.y * BLOCK_X + threadIdx.x; i < count; i += THREADS)
    v += __ldcg(partials + i);
  return block_sum(v);
}

// Second pass of a one-launch error reduction: block b sums row b of the
// per-tile partials (`count` floats per row) and applies the metric's scale
// into out[b]. Deterministic.
static __global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partials, int count, float scale,
                    float* __restrict__ out) {
  const float total = fixed_sum(partials + (size_t)blockIdx.x * count, count);
  if (threadIdx.x == 0 && threadIdx.y == 0) out[blockIdx.x] = __fmul_rn(total, scale);
}

static inline cudaError_t launch_error_sum(const float* partials, int count, float scale,
                                           float* out, cudaStream_t stream, int rows = 1) {
  sum_partials_kernel<<<rows, dim3(BLOCK_X, BLOCK_Y), 0, stream>>>(partials, count, scale,
                                                                   out);
  return cudaGetLastError();
}

// Launch a persistent kernel: as many blocks of `block` threads as can be
// resident at once (the occupancy at `smem` bytes of dynamic shared memory,
// at most `tiles`), each walking tiles t = blockIdx.x, + gridDim.x, ..., with
// cooperative_groups grid barriers between phases. A cooperative launch
// fails instead of hanging when the blocks cannot all be resident.
template <typename Args>
static cudaError_t launch_persistent(void (*kernel)(Args), const Args& args, size_t smem,
                                     int tiles, cudaStream_t stream,
                                     dim3 block = dim3(BLOCK_X, BLOCK_Y)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const int threads = (int)(block.x * block.y * block.z);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = per_sm * sms < tiles ? per_sm * sms : tiles;
  void* params[] = {const_cast<Args*>(&args)};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), block, params, smem,
                                  stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mgk
