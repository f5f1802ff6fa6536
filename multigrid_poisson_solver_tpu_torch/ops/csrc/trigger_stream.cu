// The reference's whole error-triggered smoothing loop in one kernel, for
// levels too large for trigger.cu's sweep-at-a-time loop to stay in L2: one
// damped-Jacobi sweep at a time while |err_k − err_{k−1}| > trigger, up to
// max_sweeps, with the cpu / clean / gpu smoothing-error metric.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _trigger_stream_kernel, reached through fused_trigger_stream (levels up to
// 4097² on the TPU).
//
// Bound: device-memory bandwidth. Swept one at a time, a sweep reads u and f
// and writes u, 12 B per point: 0.060 ms at 4097² at 3.35 TB/s. At 4097² a
// grid is 67 MB, above the 50 MB L2, so the TPU's plan (u resident on chip,
// f streamed, wavefronts committed in place) has no counterpart here.
// Design: temporal blocking with an exact replay. One persistent cooperative
// launch runs passes of `batch` sweeps; a pass is the per-sweep-error tile
// code (jacobi_errs_tile, legs.cuh), so it reads and writes the grids once for
// `batch` sweeps and leaves one error partial per iterate. After a grid
// barrier every block sums each row of partials in the one-launch
// reduction's fixed order and replays the stop rule sweep by sweep, so all
// blocks take the same decision. If the loop stops inside the pass, at sweep
// s < batch, the blocks redo the pass from its input with s sweeps (the
// input is still intact: passes ping-pong between two grids). The iterates,
// the stop sweep and the reported error are therefore those of the
// sweep-at-a-time loop, bit for bit, at 1/batch of its memory traffic plus
// the replay. The partials of consecutive passes alternate between two
// halves of their buffer, as in trigger.cu.
#include "legs.cuh"

using namespace mgk;

struct StreamArgs {
  const float* u;       // starting iterate (read only)
  const float* f;
  float* out;           // final iterate
  float* tmp;           // ping-pong partner of out
  float* partials;      // 2 * batch * num_tiles(n) floats
  float* err_out;       // the final iterate's error
  int* sweeps_out;      // sweeps run
  int n, halo, err_mode, batch, max_sweeps;
  float h2, omega, inv_h2, err_scale, trigger;
};

static __global__ void __launch_bounds__(THREADS) trigger_stream_kernel(StreamArgs a) {
  extern __shared__ float smem[];
  __shared__ float err_now;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int tx = tiles_x(a.n), count = num_tiles(a.n);
  const float* src = a.u;
  float* dst = a.out;
  float err = 0.0f;
  int k = 0;
  for (int pass = 0;; ++pass) {
    const int kb = min(a.batch, a.max_sweeps - k);  // >= 1: k < max_sweeps here
    float* part = a.partials + (size_t)(pass & 1) * a.batch * count;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      jacobi_errs_tile(smem, window(src, a.n), window(a.f, a.n), dst, part + t, count, t % tx,
                       t / tx, a.n, kb, a.halo, a.err_mode, a.h2, a.omega, a.inv_h2);
    grid.sync();  // dst and the partials complete
    int stop = 0;
    for (int s = 1; s <= kb && !stop; ++s) {
      const float total = fixed_sum(part + (size_t)(s - 1) * count, count);
      if (threadIdx.x == 0 && threadIdx.y == 0) err_now = __fmul_rn(total, a.err_scale);
      __syncthreads();
      const float e = err_now;
      __syncthreads();  // every thread has read err_now before it is rewritten
      // the slope test starts at sweep 2 (solver.trigger_loop)
      const bool above = k + s == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
      err = e;
      if (!(above && k + s < a.max_sweeps)) stop = s;
    }
    if (stop) {
      k += stop;
      if (stop < kb) {  // the loop ends inside this pass: redo it with stop sweeps
        for (int t = blockIdx.x; t < count; t += gridDim.x)
          jacobi_tile(smem, window(src, a.n), window(a.f, a.n), dst, nullptr, t % tx, t / tx,
                      a.n, stop, stop, 0, ERR_NONE, a.h2, a.omega, a.inv_h2, 0.0f);
        grid.sync();
      }
      break;
    }
    k += kb;
    src = dst;
    dst = dst == a.out ? a.tmp : a.out;
  }
  if (dst != a.out) {  // the final iterate is in tmp
    const size_t cells = (size_t)a.n * a.n;
    for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.y * BLOCK_X + threadIdx.x;
         i < cells; i += (size_t)gridDim.x * THREADS)
      a.out[i] = __ldcg(dst + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on u (not written) into out, batch sweeps per pass
// (batch <= 8, and <= 7 for the cpu / clean metrics); tmp is an n x n
// scratch grid, partials 2 * batch * mg_num_tiles(n) floats; err_mode as
// mg_jacobi (not ERR_NONE).
extern "C" int mg_trigger_stream(const float* u, const float* f, float* out, float* tmp,
                                 float* partials, float* err_out, int* sweeps_out, int n,
                                 int err_mode, int batch, float h2, float omega, float inv_h2,
                                 float err_scale, float trigger, int max_sweeps, void* stream) {
  const int halo = jacobi_halo(batch, err_mode);
  if (n < 3 || err_mode == ERR_NONE || max_sweeps < 1 || batch < 1 || batch > MAX_STEPS ||
      halo > MAX_HALO)
    return (int)cudaErrorInvalidValue;
  StreamArgs a = {};
  a.u = u;
  a.f = f;
  a.out = out;
  a.tmp = tmp;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.n = n;
  a.halo = halo;
  a.err_mode = err_mode;
  a.batch = batch;
  a.max_sweeps = max_sweeps;
  a.h2 = h2;
  a.omega = omega;
  a.inv_h2 = inv_h2;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)launch_persistent(trigger_stream_kernel, a, tile_smem_bytes(halo), num_tiles(n),
                                (cudaStream_t)stream);
}
