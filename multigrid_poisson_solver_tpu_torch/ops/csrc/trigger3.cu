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
// the card, as trigger.cu does in 2-D, one column pass (col3.cuh) a sweep:
// its blocks, four to a tile of the trigger loops' error plan, stream the
// columns of the level through L2 with no barrier inside the pass, meet at
// a grid barrier, and every block then sums the tiles' partials in the
// one-launch reduction's fixed order, so all reach the same error and stop
// decision without another barrier. With the clean metric the error of u_k
// comes from the pass that makes u_{k+1} (the same stencil read), so the
// stop test on u_k follows that pass; u_k is still intact in the ping-pong
// partner, and a loop that reaches max_sweeps ends with one pass that only
// reads. u ping-pongs between out and tmp (the final iterate is copied into
// out when it lands in tmp); the partials alternate between two halves of
// their buffer, so a pass never overwrites partials another block may still
// be summing. The iterates, the stop sweep and the reported error are those
// of the loop of one-sweep launches of jacobi3.cu with that plan, bit for
// bit. Above ~170³ the three volumes pass the L2 and the kernel gets
// slower, not wrong.
#include "col3.cuh"

using namespace mgk3;

struct Trigger3Args {
  Col3 C;             // the level, the plan and the workspace
  const float* u;     // starting iterate (read only)
  float* out;         // final iterate
  float* tmp;         // ping-pong partner of out
  double* partials;   // 2 * col3_tiles(C) float64 partials
  float* err_out;     // the final iterate's error
  int* sweeps_out;    // sweeps run
  int err_mode, max_sweeps;
  double err_scale;   // Σ|r| (or Σ|Δu|) to the metric
  float trigger;
};

static __global__ void __launch_bounds__(COL3_THREADS, 6) trigger3_kernel(Trigger3Args a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const Col3& C = a.C;
  const int count = col3_tiles(C), units = col3_units(C), clean = a.err_mode == ERR_CLEAN;
  // iterate k >= 1 lives in out for odd k, in tmp for even k
  auto buf = [&](int k) -> float* { return (k & 1) ? a.out : a.tmp; };
  float err = 0.0f;
  int k = 0;
  for (int j = 0;; ++j) {
    // pass j makes iterate j + 1 from iterate j (none after the last with the
    // clean error) and measures iterate k: j (clean, from j = 1) or j + 1 (gpu)
    k = clean ? j : j + 1;
    double* const part = a.partials + (k & 1) * count;
    const Col3Pass P{j == 0 ? a.u : buf(j), clean && j == a.max_sweeps ? nullptr : buf(j + 1),
                     nullptr, k >= 1 ? part : nullptr, k >= 1 ? a.err_mode : ERR_NONE, 0, C.n};
    for (int t = blockIdx.x; t < units; t += gridDim.x) col3_unit<true, false>(C, P, t);
    grid.sync();  // the iterate and the partials complete
    if (k < 1) continue;
    const float e = scaled_error3(col3_fixed_sum(part, count), a.err_scale);
    // the slope test starts at sweep 2 (solver.trigger_loop)
    const bool above = k == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
    err = e;
    if (!(above && k < a.max_sweeps)) break;
  }
  if (buf(k) != a.out) {  // the final iterate is in tmp
    const size_t cells = (size_t)C.n * C.n * C.n;
    for (size_t i = (size_t)blockIdx.x * COL3_THREADS + threadIdx.x; i < cells;
         i += (size_t)gridDim.x * COL3_THREADS)
      a.out[i] = __ldcg(a.tmp + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on the n^3 level u (not written) into out; tmp is an n^3
// scratch volume, partials 2 * (the plan's tile count) doubles, work the
// column pass's workspace (ops.kernels3.col3_work); err_mode ERR_CLEAN or
// ERR_GPU; (ty, tx, cz) the tile plan of the one-sweep error launches it
// reproduces.
extern "C" int mg3_trigger(const float* u, const float* f, float* out, float* tmp,
                           double* partials, double* work, float* err_out, int* sweeps_out,
                           int n, int err_mode, int ty, int tx, int cz, float h2, float w,
                           float inv_h2, double err_scale, float trigger, int max_sweeps,
                           void* stream) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || max_sweeps < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Trigger3Args a{};
  const cudaError_t e = col3_setup(a.C, 1, f, work, n, 0, n, 0, ty, tx, cz, h2, w, inv_h2, s);
  if (e != cudaSuccess) return (int)e;
  a.u = u;
  a.out = out;
  a.tmp = tmp;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.err_mode = err_mode;
  a.max_sweeps = max_sweeps;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)launch_persistent(trigger3_kernel, a, 0, col3_units(a.C), s, dim3(COL3_THREADS));
}
