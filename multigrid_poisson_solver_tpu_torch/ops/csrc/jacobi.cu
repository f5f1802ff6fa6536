// Kernel 1, the fused damped-Jacobi smoother: k <= 8 sweeps a pass over
// device memory with an optional fused smoothing error (its rb-GS mode is
// rbgs.cu).
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _fused_jacobi_kernel (:161): the Jacobi modes (plain sweeps, the cpu /
// clean / gpu fused error, from_zero), reached through fused_jacobi_padded
// and fused_jacobi_err_padded; the per_sweep mode (fused_jacobi_errs_padded,
// the batched trigger loop: the error of every iterate); and the shard mode
// of each (_fused_jacobi_shard_call, :500, reached through
// parallel/pallas_shard.py).
//
// Bound: device-memory bandwidth for few sweeps, fp32 instructions for
// many. One unfused sweep reads u and f and writes u, 12 B a point: 3.35
// TB/s / 12 B = 279 GDoF/s on the H100 SXM data sheet. Fused, a pass of k
// sweeps moves those 12 B once, and at k = 8 the ~10 instructions of a
// point update make it operation-bound.
//
// The Jacobi modes run wave2.cuh's row-streaming wavefront: a warp streams
// the rows of one 128-column tile strip (plus 16 halo columns a side) down a
// chunk of tile rows, holds the last two rows of every level in registers
// and advances all k levels one row a step, so u and f are read once a pass
// and no tile is staged in shared memory. The per_sweep mode is the same
// pass with the error of every level; a second one-block-a-row kernel sums
// each row of per-tile partials in the fixed order (sum_partials_kernel),
// so errs[s − 1] is bit for bit the error a launch of s sweeps reports, and
// the partials are formed in legs.cuh's tile order, so the trigger kernels
// (trigger.cu, trigger_stream.cu, rdma_trigger.cu) report the same errors
// as loops of these launches. No atomics: every metric is
// deterministic.
//
// Shard mode: every mode above on one shard's block of a sharded level.
// The inputs are the block extended by ext_r halo rows and ext_c halo
// columns per side, which the caller gathered from the ring neighbours;
// (row0, col0) is the block's global origin. Tiles and strips are laid over
// the block, masks use global indices, only owned cells are written, and
// the error partials count owned cells only: a shard's output is the
// unsharded kernel's on its cells, bit for bit. The error comes back as the
// shard's raw partial (err_scale 1), for the caller to add over the shards
// in shard order and scale. Origin (0, 0) with no extension is the
// single-device kernel: mg_jacobi is mg_jacobi_shard on the whole grid, and
// that case launches the SHARD = false instantiation (common.cuh, region),
// in which the shard geometry folds away.
#include "wave2.cuh"

using namespace mgk;

// K sweeps after level 0 (the input, or from_zero the closed form) with
// error kind E of the last iterate.
template <bool SHARD, int K, int E>
static __global__ void __launch_bounds__(WaveShape<K, E, false>::THREADS)
jacobi_kernel(const float* __restrict__ u, const float* __restrict__ f, float* __restrict__ out,
              float* __restrict__ partials, Geo g, int ext_r, int ext_c, int chunk_rows,
              int from_zero, int even_only, float h2, float omega, float inv_h2,
              float zero_coef) {
  wave2_pass<SHARD, K, E, false>(u, f, out, partials, g, ext_r, ext_c, chunk_rows, 0,
                                 from_zero, even_only, h2, omega, inv_h2, zero_coef);
}

// K sweeps with error kind E of every iterate: `stride` partials a level.
template <bool SHARD, int K, int E>
static __global__ void __launch_bounds__(WaveShape<K, E, true>::THREADS)
jacobi_errs_kernel(const float* __restrict__ u, const float* __restrict__ f,
                   float* __restrict__ out, float* __restrict__ partials, Geo g, int ext_r,
                   int ext_c, int chunk_rows, int stride, int even_only, float h2, float omega,
                   float inv_h2) {
  wave2_pass<SHARD, K, E, true>(u, f, out, partials, g, ext_r, ext_c, chunk_rows, stride, 0,
                                even_only, h2, omega, inv_h2, 0.0f);
}

// One Jacobi-mode launch as the host sees it.
struct JacobiCall {
  const float* u;
  const float* f;
  float* out;
  float* partials;
  Geo g;
  int ext_r, ext_c, from_zero, even_only;
  float h2, omega, inv_h2, zero_coef;
  cudaStream_t stream;
};

// The wavefront's forced chunk rows and the legs' forced route (declared in
// wave2.cuh, read by kernels 1, 3 and 4; set by the entry points below).
namespace mgk {
int wave2_forced_rows = 0;
int legs_forced_route = 0;
}  // namespace mgk

template <bool SHARD, int K, int E, bool ALL>
static cudaError_t launch_wave(const JacobiCall& c) {
  using S = WaveShape<K, E, ALL>;
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  if constexpr (ALL) {
    const auto kernel = jacobi_errs_kernel<SHARD, K, E>;
    static const int resident = wave2_resident_warps(kernel, S::THREADS, S::SMEM);
    const int rows = wave2_rows(c.g, resident, S::H);
    kernel<<<wave_grid(c.g, rows, S::WARPS), S::THREADS, S::SMEM, c.stream>>>(
        c.u, c.f, c.out, c.partials, c.g, c.ext_r, c.ext_c, rows, num_tiles(c.g), c.even_only,
        c.h2, c.omega, c.inv_h2);
  } else {
    const auto kernel = jacobi_kernel<SHARD, K, E>;
    static const int resident = wave2_resident_warps(kernel, S::THREADS, S::SMEM);
    const int rows = wave2_rows(c.g, resident, S::H);
    kernel<<<wave_grid(c.g, rows, S::WARPS), S::THREADS, S::SMEM, c.stream>>>(
        c.u, c.f, c.out, c.partials, c.g, c.ext_r, c.ext_c, rows, c.from_zero, c.even_only,
        c.h2, c.omega, c.inv_h2, c.zero_coef);
  }
  return cudaGetLastError();
}

// The instance of k sweeps (k a runtime count, 0..MAX_STEPS; the per-sweep
// mode 1..MAX_STEPS, and 1..MAX_STEPS − 1 with a residual error, whose
// halo is a row more).
template <bool SHARD, int E, bool ALL, int K = (ALL ? 1 : 0)>
static cudaError_t launch_wave_k(int k, const JacobiCall& c) {
  if constexpr (K > MAX_STEPS - (ALL && E == WV_RES ? 1 : 0)) {
    return cudaErrorInvalidValue;
  } else {
    if (k == K) return launch_wave<SHARD, K, E, ALL>(c);
    return launch_wave_k<SHARD, E, ALL, K + 1>(k, c);
  }
}

template <bool ALL>
static cudaError_t launch_jacobi(int k, int err_mode, const JacobiCall& c) {
  const bool whole = whole_grid(c.g, c.ext_r, c.ext_c);
  switch (err_mode) {
    case ERR_NONE:
      if constexpr (ALL) return cudaErrorInvalidValue;
      else return whole ? launch_wave_k<false, WV_NONE, ALL>(k, c)
                        : launch_wave_k<true, WV_NONE, ALL>(k, c);
    case ERR_GPU:
      return whole ? launch_wave_k<false, WV_GPU, ALL>(k, c)
                   : launch_wave_k<true, WV_GPU, ALL>(k, c);
    default:
      return whole ? launch_wave_k<false, WV_RES, ALL>(k, c)
                   : launch_wave_k<true, WV_RES, ALL>(k, c);
  }
}

extern "C" int mg_num_tiles(int n) {
  return num_tiles(n);
}

// Tiles of a rows x cols block (the partial count of a shard-mode launch).
extern "C" int mg_num_tiles_block(int rows, int cols) {
  return num_tiles(Geo(0, 0, 0, rows, cols));
}

// Chunks of `rows` owned rows (a multiple of 32) for every later launch of
// the wavefront (kernel 1's Jacobi modes, the legs of kernels 3 and 4), or
// the occupancy rule's again with 0: the card's checks take small grids
// through chunks of several tile rows, which the rule gives only large ones.
extern "C" int mg_wave2_force_rows(int rows) {
  if (rows < 0 || rows % TILE_H != 0) return (int)cudaErrorInvalidValue;
  wave2_forced_rows = rows;
  return 0;
}

// The route of every later launch of the legs (kernels 3 and 4): 1 the tile
// kernel, 2 the wavefront, 0 each leg's size rule again. Both routes are
// bit for bit the plain twins': the card's checks and timings take both.
extern "C" int mg_legs_force_route(int route) {
  if (route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  legs_forced_route = route;
  return 0;
}

extern "C" const char* mg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// steps <= MAX_STEPS sweeps of the block u (ignored when from_zero) into
// out, the owned rows x cols block at global (row0, col0); u and f are the
// block extended by ext_r rows and ext_c columns per side (the halo must
// cover the sweeps: ext >= steps, + 1 with a cpu / clean error), each
// starting 16-byte aligned (else cudaErrorMisalignedAddress). With
// err_mode != ERR_NONE, partials holds mg_num_tiles_block(rows, cols)
// floats and err_out[0] receives their sum times err_scale.
extern "C" int mg_jacobi_shard(const float* u, const float* f, float* out, float* partials,
                               float* err_out, int n, int row0, int col0, int rows, int cols,
                               int ext_r, int ext_c, int steps, int from_zero, int err_mode,
                               float h2, float omega, float inv_h2, float zero_coef,
                               float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || err_mode < ERR_NONE || err_mode > ERR_GPU ||
      bad_geo(n, row0, col0, rows, cols, ext_r, ext_c))
    return (int)cudaErrorInvalidValue;
  if (misaligned(from_zero ? nullptr : u, f)) return (int)cudaErrorMisalignedAddress;
  const Geo g(n, row0, col0, rows, cols);
  const cudaStream_t s = (cudaStream_t)stream;
  const JacobiCall c = {u, f, out, partials, g, ext_r, ext_c, from_zero ? 1 : 0,
                        err_mode == ERR_CPU ? 1 : 0, h2, omega, inv_h2, zero_coef, s};
  const cudaError_t e = launch_jacobi<false>(steps - (from_zero ? 1 : 0), err_mode, c);
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, err_out, s);
}

// steps <= MAX_STEPS sweeps of u (ignored when from_zero) into out. With
// err_mode != ERR_NONE, partials holds mg_num_tiles(n) floats and err_out[0]
// receives the scaled metric.
extern "C" int mg_jacobi(const float* u, const float* f, float* out, float* partials,
                         float* err_out, int n, int steps, int from_zero, int err_mode,
                         float h2, float omega, float inv_h2, float zero_coef,
                         float err_scale, void* stream) {
  return mg_jacobi_shard(u, f, out, partials, err_out, n, 0, 0, n, n, 0, 0, steps, from_zero,
                         err_mode, h2, omega, inv_h2, zero_coef, err_scale, stream);
}

// steps sweeps of the block u into out with the error of every iterate in
// errs_out[0..steps) (each row of partials summed times err_scale); partials
// holds steps * mg_num_tiles_block(rows, cols) floats; steps <= MAX_STEPS
// with the gpu error, MAX_STEPS − 1 with cpu or clean (errs_sweep_cap in
// ops/kernels.py). Geometry and alignment as mg_jacobi_shard.
extern "C" int mg_jacobi_errs_shard(const float* u, const float* f, float* out, float* partials,
                                    float* errs_out, int n, int row0, int col0, int rows,
                                    int cols, int ext_r, int ext_c, int steps, int err_mode,
                                    float h2, float omega, float inv_h2, float err_scale,
                                    void* stream) {
  if (steps < 1 || steps > MAX_STEPS - (err_mode == ERR_GPU ? 0 : 1) || err_mode < ERR_CPU ||
      err_mode > ERR_GPU || bad_geo(n, row0, col0, rows, cols, ext_r, ext_c))
    return (int)cudaErrorInvalidValue;
  if (misaligned(u, f)) return (int)cudaErrorMisalignedAddress;
  const Geo g(n, row0, col0, rows, cols);
  const cudaStream_t s = (cudaStream_t)stream;
  const JacobiCall c = {u, f, out, partials, g, ext_r, ext_c, 0, err_mode == ERR_CPU ? 1 : 0,
                        h2, omega, inv_h2, 0.0f, s};
  const cudaError_t e = launch_jacobi<true>(steps, err_mode, c);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, errs_out, s, steps);
}

// steps sweeps of u into out with the scaled error of every iterate in
// errs_out[0..steps); partials holds steps * mg_num_tiles(n) floats.
extern "C" int mg_jacobi_errs(const float* u, const float* f, float* out, float* partials,
                              float* errs_out, int n, int steps, int err_mode, float h2,
                              float omega, float inv_h2, float err_scale, void* stream) {
  return mg_jacobi_errs_shard(u, f, out, partials, errs_out, n, 0, 0, n, n, 0, 0, steps,
                              err_mode, h2, omega, inv_h2, err_scale, stream);
}
