// The reference's whole error-triggered smoothing loop on a 3-D level in one
// kernel: one damped-Jacobi sweep of the 7-point stencil at a time while
// |err_k − err_{k−1}| > trigger, up to max_sweeps, with the clean or gpu
// smoothing-error metric.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _trigger3_vmem_kernel, reached through fused_trigger3_vmem (JAX runs it
// where trigger3_fits: up to about 170³).
//
// Bound: on the TPU the volume stays in VMEM for the whole loop. Here one
// sweep of a 129³ level (2.15 M points) is (11 + 12) fp32 operations a point,
// 0.7 µs at 67 TFLOP/s, and its two iterates and f (25.8 MB) stay in the
// 50 MB L2, so the cost that counts is the per-sweep round trip of a loop
// driven from the host (a launch and a read of the error for the stop test,
// tens of µs). Design: one persistent cooperative launch runs the loop on
// the card, as trigger.cu does in 2-D. Per sweep its blocks walk the tiles
// of the one-sweep error launch (run_leg3_at, legs3.cuh: one sweep and the
// clean error's extra stage, or one sweep and the gpu error; the tile plan
// the wrapper passes is the one every error launch of the trigger loops
// uses), meet at a grid barrier, and then every block sums the partials in
// the one-launch reduction's fixed order (fixed_sum3), so all blocks reach
// the same error and stop decision without another barrier. u ping-pongs
// between out and tmp (the final iterate is copied into out when it lands in
// tmp); the partials alternate between two halves of their buffer, so a
// sweep never overwrites partials another block may still be summing. The
// iterates, the stop sweep and the reported error are those of the loop of
// one-sweep launches of jacobi3.cu with that plan, bit for bit. The grid
// barrier, not the sweep, sets the pace at these sizes. Above ~170³ the
// three volumes pass the L2 and the kernel gets slower, not wrong.
#include "legs3.cuh"

using namespace mgk3;

struct Trigger3Args {
  Leg3 L;             // the one-sweep error leg (u, out and partials set per sweep)
  const float* u;     // starting iterate (read only)
  float* out;         // final iterate
  float* tmp;         // ping-pong partner of out
  double* partials;   // 2 * leg3_blocks(L) float64 partials
  float* err_out;     // the final iterate's error
  int* sweeps_out;    // sweeps run
  int max_sweeps;
  double err_scale;   // Σ|r| (or Σ|Δu|) to the metric
  float trigger;
};

static __global__ void __launch_bounds__(THREADS3) trigger3_kernel(Trigger3Args a) {
  extern __shared__ float smem[];
  __shared__ float err_now;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  Leg3 L = a.L;
  const int count = leg3_blocks(L);
  const float* src = a.u;
  float* dst = a.out;
  float err = 0.0f;
  int k = 0;
  for (;;) {
    L.u = src;
    L.out = dst;
    L.partials = a.partials + (k & 1) * count;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      run_leg3_at<1, true>(smem, L, Planes3{}, leg3_blk(L, t));
    grid.sync();  // dst and the partials complete
    const double total = fixed_sum3(L.partials, count);
    if (threadIdx.x == 0 && threadIdx.y == 0) err_now = scaled_error3(total, a.err_scale);
    __syncthreads();
    const float e = err_now;
    ++k;
    // the slope test starts at sweep 2 (solver.trigger_loop)
    const bool above = k == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
    err = e;
    src = dst;
    dst = dst == a.out ? a.tmp : a.out;
    if (!(above && k < a.max_sweeps)) break;
  }
  if (src != a.out) {  // the final iterate is in tmp
    const size_t cells = (size_t)L.n * L.n * L.n;
    for (size_t i = (size_t)blockIdx.x * THREADS3 + threadIdx.y * BLOCK_X + threadIdx.x;
         i < cells; i += (size_t)gridDim.x * THREADS3)
      a.out[i] = __ldcg(src + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on the n^3 level u (not written) into out; tmp is an n^3
// scratch volume, partials 2 * (the plan's block count) doubles; err_mode
// ERR_CLEAN or ERR_GPU; (ty, tx, cz) the tile plan of the one-sweep error
// launches it reproduces.
extern "C" int mg3_trigger(const float* u, const float* f, float* out, float* tmp,
                           double* partials, float* err_out, int* sweeps_out, int n, int err_mode,
                           int ty, int tx, int cz, float h2, float w, float inv_h2,
                           double err_scale, float trigger, int max_sweeps, void* stream) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || max_sweeps < 1)
    return (int)cudaErrorInvalidValue;
  Trigger3Args a{};
  Leg3& L = a.L;
  L.f = f;
  L.partials = partials;  // non-null: the leg measures its error
  L.n = n;
  L.sweeps = 1;
  L.last = err_mode == ERR_CLEAN ? EXTRA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.cz = cz;
  L.halo = leg3_stages(L);
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
  a.max_sweeps = max_sweeps;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)launch_persistent(trigger3_kernel, a, leg3_smem(leg3_stages(L), L.halo, ty, tx),
                                leg3_blocks(L), (cudaStream_t)stream,
                                dim3(BLOCK_X, BLOCK3_Y));
}
