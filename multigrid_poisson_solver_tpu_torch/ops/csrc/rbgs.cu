// Kernel 1's rb-GS mode: k <= 4 red-black Gauss-Seidel sweeps a pass over
// device memory (even colour first), with the cpu or clean smoothing error
// fused into the pass (then k <= 3), whole grid or one shard's block.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _fused_jacobi_kernel (:161) with smoother="rbgs", reached through
// fused_rbgs_padded and fused_rbgs_err_padded, and its shard mode
// (_fused_jacobi_shard_call, :500, through parallel/pallas_shard.py).
//
// Bound: device-memory bandwidth. A pass reads u and f and writes u once,
// 12 B a point, the traffic of kernel 1's Jacobi mode for half the sweeps
// (a sweep spends two halo rows).
//
// Design: wave2.cuh's row-streaming wavefront with the rb-GS stage
// (WV_RBGS): each sweep is two half-levels of the register pipeline, so k
// sweeps are the 2k levels of a Jacobi pass of 2k sweeps, the colour a bit
// mask, and the error is one more level (Δ = ¼·((nb − 4u) − h²f) of the
// final iterate, the step an ω = 1 Jacobi sweep would take: the TPU
// kernel's (h²/4)·r), added into error partials in legs.cuh's tile order
// and summed by sum_partials_kernel. A warp streams a 128-column strip down
// a chunk of tile rows (the chunk rule and forced chunks are kernel 1's).
// Every iterate is the plain twin's bit for bit (stencils.redblack_gs_sweep
// applied in place: a cell of one colour reads only the other colour).
//
// Shard mode as kernel 1's (jacobi.cu): the block's windows extended by
// ext_r rows and ext_c columns a side, parity and masks by global index, the
// raw partial over owned cells; the whole grid launches the SHARD = false
// instance.
#include "wave2.cuh"

using namespace mgk;

// STEPS rb-GS sweeps (2·STEPS half-levels) with error kind E (WV_NONE or
// WV_RES: Σ|Δ|) of the final iterate.
template <bool SHARD, int STEPS, int E>
static __global__ void __launch_bounds__(WaveShape<2 * STEPS, E, false, WV_RBGS>::THREADS)
rbgs_kernel(const float* __restrict__ u, const float* __restrict__ f, float* __restrict__ out,
            float* __restrict__ partials, Geo g, int ext_r, int ext_c, int chunk_rows,
            int from_zero, int even_only, float h2) {
  wave2_pass<SHARD, 2 * STEPS, E, false, WV_RBGS>(u, f, out, partials, g, ext_r, ext_c,
                                                  chunk_rows, 0, from_zero, even_only, h2,
                                                  0.0f, 0.0f, 0.0f);
}

// One rb-GS launch as the host sees it.
struct RbgsCall {
  const float* u;
  const float* f;
  float* out;
  float* partials;
  Geo g;
  int ext_r, ext_c, from_zero, even_only;
  float h2;
  cudaStream_t stream;
};

template <bool SHARD, int STEPS, int E>
static cudaError_t launch_rbgs(const RbgsCall& c) {
  using S = WaveShape<2 * STEPS, E, false, WV_RBGS>;
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  const auto kernel = rbgs_kernel<SHARD, STEPS, E>;
  static const int resident = wave2_resident_warps(kernel, S::THREADS, S::SMEM);
  const int rows = wave2_rows(c.g, resident, S::H);
  kernel<<<wave_grid(c.g, rows, S::WARPS), S::THREADS, S::SMEM, c.stream>>>(
      c.u, c.f, c.out, c.partials, c.g, c.ext_r, c.ext_c, rows, c.from_zero, c.even_only,
      c.h2);
  return cudaGetLastError();
}

// The instance of `steps` sweeps: 1..4, 1..3 with the error (its Δ level
// makes the halo 2·steps + 1 <= MAX_STEPS).
template <bool SHARD, int E, int STEPS = 1>
static cudaError_t launch_rbgs_k(int steps, const RbgsCall& c) {
  if constexpr (2 * STEPS + (E == WV_RES ? 1 : 0) > MAX_STEPS) {
    return cudaErrorInvalidValue;
  } else {
    if (steps == STEPS) return launch_rbgs<SHARD, STEPS, E>(c);
    return launch_rbgs_k<SHARD, E, STEPS + 1>(steps, c);
  }
}

// steps <= 4 rb-GS sweeps of the block u (not read when from_zero) into out;
// err_mode ERR_NONE, ERR_CPU or ERR_CLEAN (then steps <= 3, partials holds
// mg_num_tiles_block(rows, cols) floats and err_out[0] receives their sum
// times err_scale). Geometry as mg_jacobi_shard (the halo must cover 2·steps
// rows and columns, + 1 with an error); u and f start 16-byte aligned (else
// cudaErrorMisalignedAddress); parity is global.
extern "C" int mg_rbgs_shard(const float* u, const float* f, float* out, float* partials,
                             float* err_out, int n, int row0, int col0, int rows, int cols,
                             int ext_r, int ext_c, int steps, int from_zero, int err_mode,
                             float h2, float err_scale, void* stream) {
  const bool err = err_mode != ERR_NONE;
  if (steps < 1 || 2 * steps + (err ? 1 : 0) > MAX_STEPS || err_mode < ERR_NONE ||
      err_mode >= ERR_GPU || bad_geo(n, row0, col0, rows, cols, ext_r, ext_c))
    return (int)cudaErrorInvalidValue;
  if (misaligned(from_zero ? nullptr : u, f)) return (int)cudaErrorMisalignedAddress;
  const Geo g(n, row0, col0, rows, cols);
  const cudaStream_t s = (cudaStream_t)stream;
  const RbgsCall c = {u, f, out, partials, g, ext_r, ext_c, from_zero ? 1 : 0,
                      err_mode == ERR_CPU ? 1 : 0, h2, s};
  cudaError_t e;
  if (whole_grid(g, ext_r, ext_c))
    e = err ? launch_rbgs_k<false, WV_RES>(steps, c) : launch_rbgs_k<false, WV_NONE>(steps, c);
  else
    e = err ? launch_rbgs_k<true, WV_RES>(steps, c) : launch_rbgs_k<true, WV_NONE>(steps, c);
  if (e != cudaSuccess || !err) return (int)e;
  return (int)launch_error_sum(partials, num_tiles(g), err_scale, err_out, s);
}

// steps <= 4 rb-GS sweeps of u (not read when from_zero) into out; err_mode
// ERR_NONE, ERR_CPU or ERR_CLEAN (then steps <= 3, partials holds
// mg_num_tiles(n) floats and err_out[0] receives the scaled metric).
extern "C" int mg_rbgs(const float* u, const float* f, float* out, float* partials,
                       float* err_out, int n, int steps, int from_zero, int err_mode, float h2,
                       float err_scale, void* stream) {
  return mg_rbgs_shard(u, f, out, partials, err_out, n, 0, 0, n, n, 0, 0, steps, from_zero,
                       err_mode, h2, err_scale, stream);
}
