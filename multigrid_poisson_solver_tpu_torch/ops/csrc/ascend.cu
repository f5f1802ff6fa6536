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
// 13 B per fine point.
//
// Design: wave2.cuh's row-streaming wavefront (kernel 1's pass) with the
// ascend stage (WV_ASCEND): level 0 at row r is u + prolong(c) on the
// interior, the coarse rows r >> 1 and (r >> 1) + 1 arriving by 4-byte
// cp.async (the coarse window is not 16-byte aligned in general) into a
// per-warp ring of four rows with fine row 2I − 1, each row's column
// interpolation at the lane's columns formed once and kept for the next
// fine row. Prolongation order: columns first (even: c, odd: ½a + ½b), then
// rows, as ops.transfers.prolong and the TPU kernel's row interleave compute
// it. Then k sweeps with the error of the last, as kernel 1. Instances: k =
// 1..8 × no / gpu / residual error × whole grid / shard = 48.
//
// Small levels take the tile kernel instead (ascend_tile in legs.cuh: a
// block per 32 x 128 tile of u and f staged with a halo of k (+1 for the
// residual-based error), the prolonged correction added to every staged
// interior cell from the coarse array, the sweeps in shared memory), which
// the chain kernel 7 runs too. The size rule (legs_take_wave, wave2.cuh) is decided
// by the owned region's size alone; both routes are bit for bit the plain
// twin's, and a launch that fails on its route is never retried on the
// other. Measured with examples/torch_kernel_ab.py on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md):
// the wavefront wins from 2049² whole grid (tile → wave: 8193² 1.31 → 0.51
// ms, 4097² 0.35-0.36 → 0.15, 2049² 0.104 → 0.059-0.068) and on 512-row
// shards of 4097² (8 shards, device µs a pass of 8 launches: 529 → 273;
// 1024 rows of 8193²: 1483 → 590); the tile kernel wins at 1025² (29.8 µs
// against 34.5) and 257² (23.0 against 34.1) and on 256-row shards of 1025²
// and below (186 against 259); at 256-row shards of 2049² the two tie (260-265
// against 263). Hence the rule: the wavefront from 1.5 M owned cells (3 ·
// 2^19: between 1025²'s 1.05 M and a 512 x 4097 shard's 2.1 M).
//
// Shard mode (_fused_ascend_shard_call, reached through
// parallel/pallas_shard.py's sharded_fused_ascend): the leg on one shard's
// block, extended by the ring neighbours' halo rows (and columns), at an even
// global origin, with a window of the coarse correction around the block's
// coarse points (its own coarse halo); the error is the shard's raw partial
// over its owned cells.
#include "legs.cuh"
#include "wave2.cuh"

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

// The leg on the wavefront: level 0 is u + prolong(c) on the interior, then
// K sweeps with error kind E of the last. c is the crows x ccols window of
// the coarse correction at global (cr0, cc0) (the whole m x m grid for
// SHARD = false).
template <bool SHARD, int K, int E>
static __global__ void __launch_bounds__(WaveShape<K, E, false, WV_ASCEND>::THREADS)
ascend_wave_kernel(const float* __restrict__ u, const float* __restrict__ f,
                   const float* __restrict__ c, float* __restrict__ out,
                   float* __restrict__ partials, Geo g, int ext_r, int ext_c, int cr0, int cc0,
                   int crows, int ccols, int chunk_rows, int even_only, float h2, float omega,
                   float inv_h2) {
  const Win cw = SHARD ? Win{c, cr0, cc0, crows, ccols} : window(c, Geo((g.n + 1) / 2));
  wave2_pass<SHARD, K, E, false, WV_ASCEND>(u, f, out, partials, g, ext_r, ext_c, chunk_rows, 0,
                                            0, even_only, h2, omega, inv_h2, 0.0f,
                                            WaveLeg{nullptr, 0, cw});
}

// One wavefront launch of the leg as the host sees it.
struct AscendCall {
  const float* u;
  const float* f;
  const float* c;
  float* out;
  float* partials;
  Geo g;
  int ext_r, ext_c, cr0, cc0, crows, ccols, even_only;
  float h2, omega, inv_h2;
  cudaStream_t stream;
};

template <bool SHARD, int K, int E>
static cudaError_t launch_wave(const AscendCall& a) {
  using S = WaveShape<K, E, false, WV_ASCEND>;
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  const auto kernel = ascend_wave_kernel<SHARD, K, E>;
  static const int resident = wave2_resident_warps(kernel, S::THREADS, S::SMEM);
  const int rows = wave2_rows(a.g, resident, S::H);
  kernel<<<wave_grid(a.g, rows, S::WARPS), S::THREADS, S::SMEM, a.stream>>>(
      a.u, a.f, a.c, a.out, a.partials, a.g, a.ext_r, a.ext_c, a.cr0, a.cc0, a.crows, a.ccols,
      rows, a.even_only, a.h2, a.omega, a.inv_h2);
  return cudaGetLastError();
}

// The instance of k = 1..MAX_STEPS sweeps (a runtime count).
template <bool SHARD, int E, int K = 1>
static cudaError_t launch_wave_k(int k, const AscendCall& a) {
  if constexpr (K > MAX_STEPS) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K) return launch_wave<SHARD, K, E>(a);
    return launch_wave_k<SHARD, E, K + 1>(k, a);
  }
}

template <bool SHARD>
static cudaError_t launch_ascend_wave(int k, int err_mode, const AscendCall& a) {
  switch (err_mode) {
    case ERR_NONE: return launch_wave_k<SHARD, WV_NONE>(k, a);
    case ERR_GPU: return launch_wave_k<SHARD, WV_GPU>(k, a);
    default: return launch_wave_k<SHARD, WV_RES>(k, a);
  }
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
// leaves the coarse grid). u and f start 16-byte aligned (else
// cudaErrorMisalignedAddress); c need not. Error arguments as
// mg_jacobi_shard.
extern "C" int mg_ascend_shard(const float* u, const float* f, const float* c, float* out,
                               float* partials, float* err_out, int n, int row0, int col0,
                               int rows, int cols, int ext_r, int ext_c, int cr0, int cc0,
                               int crows, int ccols, int steps, int err_mode, float h2,
                               float omega, float inv_h2, float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || n < 3 || n % 2 == 0 || rows < 1 || cols < 1 ||
      row0 < 0 || col0 < 0 || row0 % 2 || col0 % 2 || row0 + rows > n || col0 + cols > n ||
      ext_r < 0 || ext_c < 0 || crows < 1 || ccols < 1 || err_mode < ERR_NONE ||
      err_mode > ERR_GPU)
    return (int)cudaErrorInvalidValue;
  if (misaligned(u, f)) return (int)cudaErrorMisalignedAddress;
  const Geo g(n, row0, col0, rows, cols);
  if (!covers(cr0, crows, row0 - ext_r, row0 + rows + ext_r, n) ||
      !covers(cc0, ccols, col0 - ext_c, col0 + cols + ext_c, n))
    return (int)cudaErrorInvalidValue;
  const int m = (n + 1) / 2;
  // the whole grid reads the whole coarse grid
  const bool whole = whole_grid(g, ext_r, ext_c) && cr0 == 0 && cc0 == 0 && crows == m &&
                     ccols == m;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (legs_take_wave(g.rows, g.cols)) {
    const AscendCall a = {u, f, c, out, partials, g, ext_r, ext_c, cr0, cc0, crows, ccols,
                          err_mode == ERR_CPU ? 1 : 0, h2, omega, inv_h2, s};
    e = whole ? launch_ascend_wave<false>(steps, err_mode, a)
              : launch_ascend_wave<true>(steps, err_mode, a);
  } else {
    const int halo = jacobi_halo(steps, err_mode);
    const auto kernel = whole ? ascend_kernel<false> : ascend_kernel<true>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tile_smem_bytes(MAX_HALO));
    if (e != cudaSuccess) return (int)e;
    kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
        u, f, c, out, partials, g, ext_r, ext_c, cr0, cc0, crows, ccols, steps, halo, err_mode,
        h2, omega, inv_h2);
    e = cudaGetLastError();
  }
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
