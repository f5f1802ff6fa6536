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
// whole leg.
//
// Design: wave2.cuh's row-streaming wavefront (kernel 1's pass) with the
// descend stage (WV_DESCEND): a warp streams one 128-column tile strip down
// a chunk of tile rows at an even origin, forms −r of level k one row
// behind the last sweep (the cpu / clean error's residual is the same row)
// and, from d's last three rows in registers, each coarse row of the strip's
// 64 coarse columns, stored coalesced. Halo rows: k + 1, + 1 for full
// weighting (a runtime flag). The error partials are legs.cuh's tile order.
// Instances: k = 0..8 sweeps in the pass (from_zero's closed form is level
// 0) × no / gpu / residual error × whole grid / shard = 54.
//
// Small levels take the tile kernel instead (descend_tile in legs.cuh: a
// block per 32 x 128 tile staged with a halo of k + 1 (+ 1), the sweeps in
// shared memory, the restriction from the spare buffer), which the chain
// kernel 6 runs too: a warp's 32 + 2H serial row steps lose to a tile's
// eight warps where the level has too few strips and chunks to fill the
// card. The size rule (legs_take_wave, wave2.cuh) is decided by the owned region's
// size alone; both routes are bit for bit the plain twin's, so no result
// depends on it, and a launch that fails on its route is never retried on
// the other. Measured with examples/torch_kernel_ab.py on an NVIDIA H100
// 80GB HBM3 at 700 W (PERF.md):
// the wavefront wins from 2049² whole grid (tile → wave: 8193² 1.12-1.14 →
// 0.52 ms, 4097² 0.30 → 0.15, 2049² 0.094 → 0.060-0.080) and on 512-row
// shards of 4097² (8 shards, device µs a pass of 8 launches: 445 → 302;
// 1024 rows of 8193²: 1260 → 643); the tile kernel wins at 1025² (26.6 µs
// against 35.2) and 257² (19.2 against 34.9) and on 256-row shards of 2049²
// and below (218 against 291; 160 against 287 at 1025²). Hence the rule:
// the wavefront from 1.5 M owned cells (3 · 2^19: between 1025²'s 1.05 M and
// a 512 x 4097 shard's 2.1 M).
//
// Shard mode (_fused_descend_shard_call, reached through
// parallel/pallas_shard.py's sharded_fused_descend): the leg on one shard's
// block, extended by the ring neighbours' halo rows (and columns), at an even
// global origin. The block's coarse points (rows from row0 / 2, (rows + 1) / 2
// of them; the same for columns) go to fc, which is laid out as that coarse
// block; the error is the shard's raw partial over its owned cells.
#include "legs.cuh"
#include "wave2.cuh"

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

// The leg on the wavefront: K sweeps after level 0 (the input, or from_zero
// the closed form), error kind E of level K.
template <bool SHARD, int K, int E>
static __global__ void __launch_bounds__(WaveShape<K, E, false, WV_DESCEND>::THREADS)
descend_wave_kernel(const float* __restrict__ u, const float* __restrict__ f,
                    float* __restrict__ out, float* __restrict__ fc,
                    float* __restrict__ partials, Geo g, int ext_r, int ext_c, int chunk_rows,
                    int from_zero, int full_weighting, int even_only, float h2, float omega,
                    float inv_h2, float zero_coef) {
  wave2_pass<SHARD, K, E, false, WV_DESCEND>(u, f, out, partials, g, ext_r, ext_c, chunk_rows,
                                             0, from_zero, even_only, h2, omega, inv_h2,
                                             zero_coef, WaveLeg{fc, full_weighting, Win{}});
}

// One wavefront launch of the leg as the host sees it.
struct DescendCall {
  const float* u;
  const float* f;
  float* out;
  float* fc;
  float* partials;
  Geo g;
  int ext_r, ext_c, from_zero, full_weighting, even_only;
  float h2, omega, inv_h2, zero_coef;
  cudaStream_t stream;
};

template <bool SHARD, int K, int E>
static cudaError_t launch_wave(const DescendCall& c) {
  using S = WaveShape<K, E, false, WV_DESCEND>;
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  const auto kernel = descend_wave_kernel<SHARD, K, E>;
  static const int resident = wave2_resident_warps(kernel, S::THREADS, S::SMEM);
  const int rows = wave2_rows(c.g, resident, S::H + c.full_weighting);
  kernel<<<wave_grid(c.g, rows, S::WARPS), S::THREADS, S::SMEM, c.stream>>>(
      c.u, c.f, c.out, c.fc, c.partials, c.g, c.ext_r, c.ext_c, rows, c.from_zero,
      c.full_weighting, c.even_only, c.h2, c.omega, c.inv_h2, c.zero_coef);
  return cudaGetLastError();
}

// The instance of k = 0..MAX_STEPS sweeps (a runtime count).
template <bool SHARD, int E, int K = 0>
static cudaError_t launch_wave_k(int k, const DescendCall& c) {
  if constexpr (K > MAX_STEPS) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K) return launch_wave<SHARD, K, E>(c);
    return launch_wave_k<SHARD, E, K + 1>(k, c);
  }
}

template <bool SHARD>
static cudaError_t launch_descend_wave(int k, int err_mode, const DescendCall& c) {
  switch (err_mode) {
    case ERR_NONE: return launch_wave_k<SHARD, WV_NONE>(k, c);
    case ERR_GPU: return launch_wave_k<SHARD, WV_GPU>(k, c);
    default: return launch_wave_k<SHARD, WV_RES>(k, c);
  }
}

// steps <= MAX_STEPS sweeps of the rows x cols block at global (row0, col0)
// (both even) of the n x n level (n = 2m − 1) into out, the restricted
// negated residual of its coarse points into fc ((rows + 1) / 2 x
// (cols + 1) / 2). u and f are the block extended by ext_r rows and ext_c
// columns per side (ext >= steps + 1, + 1 for full weighting), each starting
// 16-byte aligned (else cudaErrorMisalignedAddress; u may be null from
// zero). Error arguments as mg_jacobi_shard.
extern "C" int mg_descend_shard(const float* u, const float* f, float* out, float* fc,
                                float* partials, float* err_out, int n, int row0, int col0,
                                int rows, int cols, int ext_r, int ext_c, int steps,
                                int from_zero, int full_weighting, int err_mode, float h2,
                                float omega, float inv_h2, float zero_coef, float err_scale,
                                void* stream) {
  if (steps < 1 || steps > MAX_STEPS || n < 3 || n % 2 == 0 || rows < 1 || cols < 1 ||
      row0 < 0 || col0 < 0 || row0 % 2 || col0 % 2 || row0 + rows > n || col0 + cols > n ||
      ext_r < 0 || ext_c < 0 || err_mode < ERR_NONE || err_mode > ERR_GPU)
    return (int)cudaErrorInvalidValue;
  if (misaligned(from_zero ? nullptr : u, f)) return (int)cudaErrorMisalignedAddress;
  const Geo g(n, row0, col0, rows, cols);
  const int n_sweeps = steps - (from_zero ? 1 : 0);
  const bool whole = whole_grid(g, ext_r, ext_c);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (legs_take_wave(g.rows, g.cols)) {
    const DescendCall c = {u, f, out, fc, partials, g, ext_r, ext_c, from_zero ? 1 : 0,
                           full_weighting ? 1 : 0, err_mode == ERR_CPU ? 1 : 0, h2, omega,
                           inv_h2, zero_coef, s};
    e = whole ? launch_descend_wave<false>(n_sweeps, err_mode, c)
              : launch_descend_wave<true>(n_sweeps, err_mode, c);
  } else {
    const int halo = descend_halo(n_sweeps, full_weighting);
    const auto kernel = whole ? descend_kernel<false> : descend_kernel<true>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tile_smem_bytes(MAX_HALO));
    if (e != cudaSuccess) return (int)e;
    kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
        u, f, out, fc, partials, g, ext_r, ext_c, n_sweeps, halo, from_zero, full_weighting,
        err_mode, h2, omega, inv_h2, zero_coef);
    e = cudaGetLastError();
  }
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
