// Shared pieces of the port's 2-D stencil kernels: the tile geometry, the
// halo tile loader, the frozen-cell mask, the point updates, the fixed-order
// reductions and the launcher of the persistent (grid-synchronized) kernels.
//
// A launch owns a region of an n x n fp32 grid (Geo): the whole grid on one
// device, or one shard's block of rows (and columns) under a sharding policy,
// with its global origin. Inputs are windows of the grid in device memory
// (Win: row-major, contiguous, with a global origin); a shard's window is its
// block extended by the halo rows (and columns) its ring neighbours sent.
// Every tile is a TILE_H x TILE_W window of the owned region, staged in
// shared memory with a halo of `halo` cells per side. Tiles are numbered
// row-major, t = ty * tiles_x(g) + tx. Cells outside [0, n)^2 or outside the
// input window load as 0; cells outside the grid and the Dirichlet boundary
// are frozen, by global index, so a shard masks exactly what the whole grid
// does. Error partials count owned cells only. A
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
// Storage type T: grids in device memory are float, or __nv_bfloat16 for the
// bf16 modes of kernels 1-4 (the *_bf16.cu sources). Shared memory and
// registers stay float either way: a bf16 value converts at its global load
// and store, and arithmetic is the same __f*_rn sequence, each result that
// the twin materialises as a tensor rounded to bf16 (rnd<T>). PyTorch computes
// an op on bf16 tensors in float, a Python scalar as a float, and rounds the
// result to bf16, so the twins run on bf16 tensors round after every op. The
// native bf16 intrinsics (__hadd, __hfma2) round once where the twin rounds
// twice (f32, then bf16), and are not used. For T = float every rnd<T> is the
// identity and the code is the fp32 kernels' own.
//
// Grid reads go through __ldcg (cached in L2 only). The persistent kernels
// read, after a grid-wide barrier, what other blocks wrote earlier in the
// same launch; an L1 or read-only-cache line from an earlier read could be
// stale, an L2 line cannot.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace mgk {

constexpr int TILE_H = 32;    // owned rows per tile (even: 2:1 legs tile by it)
constexpr int TILE_W = 128;   // owned columns per tile (even)
constexpr int BLOCK_X = 32;   // one warp per thread row
constexpr int BLOCK_Y = 8;
constexpr int THREADS = BLOCK_X * BLOCK_Y;
constexpr int MAX_STEPS = 8;
constexpr int MAX_HALO = MAX_STEPS + 2;  // sweeps + residual read + full weighting

enum ErrMode { ERR_NONE = 0, ERR_CPU = 1, ERR_CLEAN = 2, ERR_GPU = 3 };

// A stored value as float, a float as the storage type T (round to nearest
// even), and a float rounded to T's precision (the identity for float).
static __device__ __forceinline__ float to_f(float x) { return x; }
static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <class T>
static __device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __float2bfloat16_rn(x);
}

template <class T>
static __device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same<T, float>::value)
    return x;
  else
    return __bfloat162float(__float2bfloat16_rn(x));
}

struct Tile {
  int gr0, gc0;    // global (row, col) of staged cell (0, 0)
  int rows, cols;  // staged extent; also the shared-memory row stride
};

// The region a launch owns: rows [row0, row0 + rows) x columns [col0, col0 +
// cols) of the n x n grid. Outputs are laid out as that region (row-major,
// `cols` per row). An int converts to the whole grid.
struct Geo {
  int n, row0, col0, rows, cols;
  __host__ __device__ Geo(int n_) : n(n_), row0(0), col0(0), rows(n_), cols(n_) {}
  __host__ __device__ Geo(int n_, int r0, int c0, int r, int c)
      : n(n_), row0(r0), col0(c0), rows(r), cols(c) {}
};

// A window of the grid in device memory: global cell (gi, gj) at
// p[(gi − r0) · cols + (gj − c0)] for r0 <= gi < r0 + rows, c0 <= gj < c0 + cols.
template <class T = float>
struct WinT {
  const T* p;
  int r0, c0, rows, cols;
};
using Win = WinT<float>;

// The owned region's window extended by er rows and ec columns per side.
template <class T>
static __host__ __device__ __forceinline__ WinT<T> window(const T* p, const Geo& g, int er = 0,
                                                          int ec = 0) {
  WinT<T> w = {p, g.row0 - er, g.col0 - ec, g.rows + 2 * er, g.cols + 2 * ec};
  return w;
}

// Whether a launch owns the whole grid through unextended windows: the
// single-device launch. Its kernels are instantiated with SHARD = false and
// rebuild their region and windows from n and the base pointers (region<>),
// so origins, extents and window offsets are compile-time zeros and n, and
// the shard arithmetic folds away. The kernels take their grids as
// __restrict__ pointers and build the windows inside, so every access keeps
// the no-alias promise (a pointer read out of a Win kernel argument would
// not).
static inline bool whole_grid(const Geo& g, int ext_r, int ext_c) {
  return g.row0 == 0 && g.col0 == 0 && g.rows == g.n && g.cols == g.n && ext_r == 0 &&
         ext_c == 0;
}

template <bool SHARD>
static __device__ __forceinline__ Geo region(const Geo& g) {
  return SHARD ? g : Geo(g.n);
}

// p's window of region<SHARD>'s g, extended by er rows and ec columns per
// side (the whole grid, unextended, for SHARD = false).
template <bool SHARD, class T>
static __device__ __forceinline__ WinT<T> region(const T* p, const Geo& g, int er, int ec) {
  return SHARD ? window(p, g, er, ec) : window(p, g);
}

static __host__ __device__ __forceinline__ int tiles_x(const Geo& g) {
  return (g.cols + TILE_W - 1) / TILE_W;
}

static __host__ __device__ __forceinline__ int tiles_y(const Geo& g) {
  return (g.rows + TILE_H - 1) / TILE_H;
}

static __host__ __device__ __forceinline__ int num_tiles(const Geo& g) {
  return tiles_x(g) * tiles_y(g);
}

static __device__ __forceinline__ Tile make_tile(const Geo& g, int halo, int tx, int ty) {
  Tile t;
  t.gr0 = g.row0 + ty * TILE_H - halo;
  t.gc0 = g.col0 + tx * TILE_W - halo;
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

static inline dim3 tile_grid(const Geo& g) {
  return dim3(tiles_x(g), tiles_y(g));
}

static __device__ __forceinline__ bool interior(int gi, int gj, int n) {
  return gi >= 1 && gi <= n - 2 && gj >= 1 && gj <= n - 2;
}

// One global row of a source: p[gj] holds cell (gi, gj) for c_lo <= gj < c_hi
// (an empty range where the source has no cell of the row in the grid).
template <class T = float>
struct RowRefT {
  const T* p;
  int c_lo, c_hi;
};
using RowRef = RowRefT<float>;

template <class T>
static __device__ __forceinline__ RowRefT<T> row_of(const WinT<T>& w, int gi, int n) {
  RowRefT<T> r = {w.p, 0, 0};
  if (gi >= max(0, w.r0) && gi < min(n, w.r0 + w.rows)) {
    r.p = w.p + (ptrdiff_t)(gi - w.r0) * w.cols - w.c0;
    r.c_lo = max(0, w.c0);
    r.c_hi = min(n, w.c0 + w.cols);
  }
  return r;
}

// Stage src's window into s; cells outside the grid or the window read as 0.
// S is a Win, or a source with a row_of() of its own (rdma.cuh). The row is
// looked up once a row, so a cell costs what it did on the whole grid.
template <class S>
static __device__ void load_tile(float* s, const S& src, int n, const Tile& t) {
  for (int i = threadIdx.y; i < t.rows; i += BLOCK_Y) {
    const auto r = row_of(src, t.gr0 + i, n);
    for (int j = threadIdx.x; j < t.cols; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      s[i * t.cols + j] = gj >= r.c_lo && gj < r.c_hi ? to_f(__ldcg(r.p + gj)) : 0.0f;
    }
  }
}

// ((N + S) + W) + E: the oracle's neighbor-sum order (each add rounded to T).
template <class T = float>
static __device__ __forceinline__ float nb_add(float n, float s, float w, float e) {
  return rnd<T>(__fadd_rn(rnd<T>(__fadd_rn(rnd<T>(__fadd_rn(n, s)), w)), e));
}

template <class T = float>
static __device__ __forceinline__ float nb_sum(const float* s, int ld, int i, int j) {
  const int k = i * ld + j;
  return nb_add<T>(s[k - ld], s[k + ld], s[k - 1], s[k + 1]);
}

// u + ω·(¼·((nb − 4u) − h²f))  (stencils.jacobi_sweep; T: each product,
// difference and sum rounded as the twin's tensors are)
template <class T = float>
static __device__ __forceinline__ float jacobi_point(float nb, float uc, float fc,
                                                     float h2, float omega) {
  const float t = rnd<T>(__fsub_rn(rnd<T>(__fsub_rn(nb, rnd<T>(__fmul_rn(4.0f, uc)))),
                                   rnd<T>(__fmul_rn(h2, fc))));
  return rnd<T>(__fadd_rn(uc, rnd<T>(__fmul_rn(omega, rnd<T>(__fmul_rn(0.25f, t))))));
}

// (1/h²)·(nb − 4u) − f  (stencils.residual)
template <class T = float>
static __device__ __forceinline__ float residual_point(float nb, float uc, float fc,
                                                       float inv_h2) {
  return rnd<T>(__fsub_rn(
      rnd<T>(__fmul_rn(inv_h2, rnd<T>(__fsub_rn(nb, rnd<T>(__fmul_rn(4.0f, uc)))))), fc));
}

// The full weighting's combination (¼·a + ½·b) + ¼·c, and the prolongation's
// ½·a + ½·b, in the twins' order (ops.transfers), each step rounded to T.
template <class T = float>
static __device__ __forceinline__ float fw_comb(float a, float b, float c) {
  return rnd<T>(__fadd_rn(rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(0.25f, a)), rnd<T>(__fmul_rn(0.5f, b)))),
                          rnd<T>(__fmul_rn(0.25f, c))));
}

template <class T = float>
static __device__ __forceinline__ float half_sum(float a, float b) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(0.5f, a)), rnd<T>(__fmul_rn(0.5f, b))));
}

// One Jacobi sweep src -> dst over the staged region shrunk by `lo` >= 1;
// frozen cells are copied.
template <class T = float>
static __device__ void sweep(const float* src, float* dst, const float* sf,
                             const Tile& t, int lo, int n, float h2, float omega) {
  for (int i = lo + threadIdx.y; i < t.rows - lo; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = lo + threadIdx.x; j < t.cols - lo; j += BLOCK_X) {
      const int k = i * t.cols + j;
      const float uc = src[k];
      dst[k] = interior(gi, t.gc0 + j, n)
                   ? jacobi_point<T>(nb_sum<T>(src, t.cols, i, j), uc, sf[k], h2, omega)
                   : uc;
    }
  }
}

// Sweeps 1..n_sweeps starting from bufs[0]; returns the buffer index holding
// the final iterate. Ends with a barrier.
template <class T = float>
static __device__ int run_sweeps(float* bufs[2], const float* sf, const Tile& t,
                                 int n_sweeps, int n, float h2, float omega) {
  for (int s = 1; s <= n_sweeps; ++s) {
    sweep<T>(bufs[(s - 1) & 1], bufs[s & 1], sf, t, s, n, h2, omega);
    __syncthreads();
  }
  return n_sweeps & 1;
}

// Whether global cell (gi, gj) lies in g's region. Loops test it per cell:
// a per-row skip kept the compiler from unrolling them as it unrolls the
// whole-grid kernels (the residual ran 12% slower).
static __device__ __forceinline__ bool owned(const Geo& g, int gi, int gj) {
  return gi >= g.row0 && gi < g.row0 + g.rows && gj >= g.col0 && gj < g.col0 + g.cols;
}

// Offset of owned cell (gi, gj) in an output laid out as g's region.
static __device__ __forceinline__ ptrdiff_t out_at(const Geo& g, int gi, int gj) {
  return (ptrdiff_t)(gi - g.row0) * g.cols + (gj - g.col0);
}

// Write the owned cells of the staged buffer's tile window to out, laid out
// as g's region.
template <class T>
static __device__ void store_owned(T* __restrict__ out, const float* s, const Geo& g,
                                   const Tile& t, int halo) {
  for (int i = halo + threadIdx.y; i < halo + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = halo + threadIdx.x; j < halo + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (owned(g, gi, gj)) out[out_at(g, gi, gj)] = from_f<T>(s[i * t.cols + j]);
    }
  }
}

// The owned interior cells of g's region: rows [i_lo, i_hi], columns
// [j_lo, j_hi] (the cells an error partial counts).
struct Span {
  int i_lo, i_hi, j_lo, j_hi;
};

static __device__ __forceinline__ Span owned_interior(const Geo& g) {
  Span sp = {max(1, g.row0), min(g.n - 2, g.row0 + g.rows - 1), max(1, g.col0),
             min(g.n - 2, g.col0 + g.cols - 1)};
  return sp;
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
// the residual modes. Written to *partial without atomics. T: the terms are
// the rounded r or Δu of the twin; the partial is a float sum.
template <class T = float>
static __device__ void error_partial(float* __restrict__ partial, const float* fin,
                                     const float* prev, const float* sf, const Tile& t,
                                     int halo, const Geo& g, int err_mode, float inv_h2) {
  const Span sp = owned_interior(g);
  float acc = 0.0f;
  for (int i = halo + threadIdx.y; i < halo + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = halo + threadIdx.x; j < halo + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (gi < sp.i_lo || gi > sp.i_hi || gj < sp.j_lo || gj > sp.j_hi) continue;
      if (err_mode == ERR_CPU && ((gi + gj) & 1)) continue;
      const int k = i * t.cols + j;
      if (err_mode == ERR_GPU) {
        acc += fabsf(rnd<T>(__fsub_rn(fin[k], prev ? prev[k] : 0.0f)));
      } else {
        acc += fabsf(residual_point<T>(nb_sum<T>(fin, t.cols, i, j), fin[k], sf[k], inv_h2));
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

// --- the 2-D trigger loops' rule and sum (trigger.cu's cluster kernel,
// trigger_wave.cuh's wavefront passes, rdma_trigger.cu's ring) -------------

// block_sum over 256 thread values v[0..count) (+0 from count on), played
// by one warp: lane x adds v[32y + x], thread (x, y)'s value, for each warp
// y with block_sum's butterfly, lane y keeps warp y's sum, then the
// butterfly over lanes 0..7 (the others +0). Every lane gets the total:
// fixed_sum's for count <= THREADS, and its second step for any count.
static __device__ __forceinline__ float warp_block_sum(const float* v, int count) {
  const int lane = threadIdx.x & 31;
  float w[BLOCK_Y];
#pragma unroll
  for (int y = 0; y < BLOCK_Y; ++y)
    w[y] = y * BLOCK_X + lane < count ? v[y * BLOCK_X + lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int y = 0; y < BLOCK_Y; ++y) w[y] += __shfl_xor_sync(0xffffffffu, w[y], o);
  float total = 0.0f;
#pragma unroll
  for (int y = 0; y < BLOCK_Y; ++y)
    if (lane == y) total = w[y];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  return total;
}

// The reference's stop rule (solver.trigger_loop) on the error e of the
// loop's sweep i + 1 (i from 0): the loop goes on while the slope |e − err|
// stays above the trigger (the test starts at sweep 2) and fewer than
// max_sweeps sweeps have run. Moves the last error err and the last two
// slopes d1 (this sweep's) and d0 on.
static __device__ __forceinline__ bool trigger_goes_on(int i, float e, float trigger,
                                                       int max_sweeps, float& err, float& d1,
                                                       float& d0) {
  const float d = fabsf(__fsub_rn(e, err));
  const bool above = i == 0 || d > trigger;
  d0 = d1;
  d1 = d;
  err = e;
  return above && i + 1 < max_sweeps;
}

// The sweeps of a temporal-blocking trigger loop's pass after k sweeps, at
// most B: a loop stops where the slope d_k = |err_k − err_{k−1}| first falls
// to the trigger, and a pass that runs past the stop is redone, so a pass
// runs about as far as the stop is likely to be: the 2 sweeps the slope test
// needs, then 1, then as many as the decay of the last two slopes d1 (sweep
// k) and d0 (sweep k − 1), taken as geometric, needs to reach the trigger.
// The engine's trigger nodes stop after 2-5 sweeps; a loop whose slopes do
// not fall (trigger 0) runs passes of B. Every block computes it from the
// same errors: the same lengths.
static __device__ int next_sweeps(int k, float d1, float d0, float trigger, int B) {
  if (k == 0) return min(2, B);
  if (k < 3) return 1;
  const float rho = d1 / d0;
  if (!(trigger > 0.0f && d1 > trigger && rho > 0.0f && rho < 1.0f)) return B;
  const float m = ceilf(logf(trigger / d1) / logf(rho));
  return m < 1.0f ? 1 : (m > (float)B ? B : (int)m);
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
