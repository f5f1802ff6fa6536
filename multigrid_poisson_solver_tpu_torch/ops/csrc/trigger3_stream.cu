// The reference's whole error-triggered smoothing loop on a 3-D level too
// large for trigger3.cu's sweep-at-a-time loop to stay in L2: one
// damped-Jacobi sweep of the 7-point stencil at a time while
// |err_k − err_{k−1}| > trigger, up to max_sweeps, with the clean or gpu
// smoothing-error metric.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _trigger3_stream_kernel, reached through fused_trigger3_stream (JAX runs it
// where trigger3_stream_fits: the 257³ class).
//
// Bound: device-memory bandwidth. Swept one at a time, a sweep reads u and f
// and writes u, 12 B per point: 0.061 ms a sweep at 257³ at 3.35 TB/s. One
// 257³ grid is 67.9 MB, above the 50 MB L2, so the TPU's plan (u resident on
// chip, f streamed in plane blocks) has no counterpart here. Design, as
// trigger_stream.cu in 2-D: temporal blocking with an exact replay. One
// persistent cooperative launch runs passes of `batch` sweeps; a pass is the
// per-sweep-error leg of jacobi3.cu (run_leg3_at with per_sweep), so it moves
// the 12 B per point once for `batch` sweeps and leaves one row of error
// partials per iterate, in the order of the one-sweep error launches with the
// same tile plan. After a grid barrier every block sums each row in the
// one-launch reduction's fixed order (fixed_sum3) and replays the stop rule
// sweep by sweep, so all blocks take the same decision. If the loop stops
// inside the pass, at sweep s < batch, the blocks redo the pass from its
// input with s sweeps and no error (the input is still intact: passes
// ping-pong between two grids). The iterates, the stop sweep and the
// reported error are therefore those of the sweep-at-a-time loop of one-sweep
// launches, bit for bit, at 1/batch of its memory traffic plus the replay.
// The partials of consecutive passes alternate between two halves of their
// buffer. The pass's deep halo (batch + 1 planes and cells) costs redundant
// halo work and a smaller tile (one block per SM); the bound above counts
// none of it.
#include "legs3.cuh"

using namespace mgk3;

struct Stream3Args {
  Leg3 L;             // the per-sweep pass (u, out, partials and sweeps set per pass)
  const float* u;     // starting iterate (read only)
  float* out;         // final iterate
  float* tmp;         // ping-pong partner of out
  double* partials;   // 2 * batch * leg3_blocks(L) float64 partials
  float* err_out;     // the final iterate's error
  int* sweeps_out;    // sweeps run
  int batch, max_sweeps;
  double err_scale;   // Σ|r| (or Σ|Δu|) to the metric
  float trigger;
};

static __global__ void __launch_bounds__(THREADS3) trigger3_stream_kernel(Stream3Args a) {
  extern __shared__ float smem[];
  __shared__ float err_now;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  Leg3 L = a.L;
  const int count = leg3_blocks(L);
  const float* src = a.u;
  float* dst = a.out;
  float err = 0.0f;
  int k = 0;
  for (int pass = 0;; ++pass) {
    const int kb = min(a.batch, a.max_sweeps - k);  // >= 1: k < max_sweeps here
    L.u = src;
    L.out = dst;
    L.sweeps = kb;
    L.partials = a.partials + (size_t)(pass & 1) * a.batch * count;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      run_leg3_at<MAX_STEPS3, true>(smem, L, Planes3{}, leg3_blk(L, t));
    grid.sync();  // dst and the partials complete
    int stop = 0;
    for (int s = 1; s <= kb && !stop; ++s) {
      const double total = fixed_sum3(L.partials + (size_t)(s - 1) * count, count);
      if (threadIdx.x == 0 && threadIdx.y == 0) err_now = scaled_error3(total, a.err_scale);
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
        Leg3 R = L;
        R.sweeps = stop;
        R.last = -1;
        R.err_mode = ERR_NONE;
        R.per_sweep = 0;
        R.partials = nullptr;
        for (int t = blockIdx.x; t < count; t += gridDim.x)
          run_leg3_at<1, true>(smem, R, Planes3{}, leg3_blk(R, t));
        grid.sync();
      }
      break;
    }
    k += kb;
    src = dst;
    dst = dst == a.out ? a.tmp : a.out;
  }
  if (dst != a.out) {  // the final iterate is in tmp
    const size_t cells = (size_t)L.n * L.n * L.n;
    for (size_t i = (size_t)blockIdx.x * THREADS3 + threadIdx.y * BLOCK_X + threadIdx.x;
         i < cells; i += (size_t)gridDim.x * THREADS3)
      a.out[i] = __ldcg(dst + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on the n^3 level u (not written) into out, batch sweeps a
// pass (batch <= 7 with ERR_CLEAN, <= 8 with ERR_GPU); tmp is an n^3 scratch
// volume, partials 2 * batch * (the plan's block count) doubles; (ty, tx, cz)
// the tile plan of the one-sweep error launches it reproduces.
extern "C" int mg3_trigger_stream(const float* u, const float* f, float* out, float* tmp,
                                  double* partials, float* err_out, int* sweeps_out, int n,
                                  int err_mode, int batch, int ty, int tx, int cz, float h2,
                                  float w, float inv_h2, double err_scale, float trigger,
                                  int max_sweeps, void* stream) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || max_sweeps < 1 || batch < 1 ||
      batch > (err_mode == ERR_CLEAN ? MAX_STEPS3 - 1 : MAX_STEPS3))
    return (int)cudaErrorInvalidValue;
  Stream3Args a{};
  Leg3& L = a.L;
  L.f = f;
  L.partials = partials;
  L.per_sweep = 1;
  L.n = n;
  L.sweeps = batch;
  L.last = err_mode == ERR_CLEAN ? EXTRA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = leg3_stages(L);  // the deepest pass's; shorter passes fit inside it
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  const cudaError_t e = check_leg3(L, planes3_whole(n));
  if (e != cudaSuccess) return (int)e;
  a.u = u;
  a.out = out;
  a.tmp = tmp;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.batch = batch;
  a.max_sweeps = max_sweeps;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)launch_persistent(trigger3_stream_kernel, a,
                                leg3_smem(leg3_stages(L), L.halo, ty, tx), leg3_blocks(L),
                                (cudaStream_t)stream, dim3(BLOCK_X, BLOCK3_Y));
}
