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
// trigger_stream.cu in 2-D: passes with an exact replay. One persistent
// cooperative launch runs passes of `batch` sweeps; a pass is the per-sweep
// mode of jacobi3.cu (col3.cuh's column pass once a sweep, a grid barrier
// after each, and for the clean error one more pass that only reads), which
// leaves one row of error partials per iterate, in the order of the
// one-sweep error launches with the same tile plan. After the pass every
// block sums each row in the one-launch reduction's fixed order and replays
// the stop rule sweep by sweep, so all blocks take the same decision. If the
// loop stops inside the pass, at sweep s < batch, the blocks redo the pass
// from its input with s sweeps and no error (the input is still intact:
// passes ping-pong between two grids, and a pass's own iterates alternate
// between its output and a third). The iterates, the stop sweep and the
// reported error are therefore those of the sweep-at-a-time loop of
// one-sweep launches, bit for bit. The partials of consecutive passes
// alternate between two halves of their buffer. Each sweep moves its 12 B
// a point: the port's first, fused trapezoid moved them once a pass, but
// its pipeline ran 5× longer a sweep (PERF.md).
#include "col3.cuh"

using namespace mgk3;

struct Stream3Args {
  Col3 C;             // the level, the plan and the workspace
  const float* u;     // starting iterate (read only)
  float* out;         // final iterate
  float* tmp;         // ping-pong partner of out
  float* mid;         // a pass's other iterates
  double* partials;   // 2 * batch * col3_tiles(C) float64 partials
  float* err_out;     // the final iterate's error
  int* sweeps_out;    // sweeps run
  int err_mode, batch, max_sweeps;
  double err_scale;   // Σ|r| (or Σ|Δu|) to the metric
  float trigger;
};

static __global__ void __launch_bounds__(COL3_THREADS, 6)
trigger3_stream_kernel(Stream3Args a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const Col3& C = a.C;
  const int count = col3_tiles(C), units = col3_units(C);
  // kb sweeps from src into dst (a pass's other iterates in mid); with rows,
  // the error of iterate s into row s − 1 (col3_schedule)
  auto sweeps = [&](const float* src, float* dst, int kb, double* rows) {
    Col3Pass P;
    for (int j = 0; col3_schedule(C, P, j, kb, a.err_mode, src, dst, a.mid, nullptr, rows, count);
         ++j) {
      for (int t = blockIdx.x; t < units; t += gridDim.x) col3_unit<true, false>(C, P, t);
      grid.sync();  // the iterate and its row complete
    }
  };
  const float* src = a.u;
  float* dst = a.out;
  float err = 0.0f;
  int k = 0;
  for (int pass = 0;; ++pass) {
    const int kb = min(a.batch, a.max_sweeps - k);  // >= 1: k < max_sweeps here
    double* const rows = a.partials + (size_t)(pass & 1) * a.batch * count;
    sweeps(src, dst, kb, rows);
    int stop = 0;
    for (int s = 1; s <= kb && !stop; ++s) {
      const float e = scaled_error3(col3_fixed_sum(rows + (size_t)(s - 1) * count, count),
                                    a.err_scale);
      // the slope test starts at sweep 2 (solver.trigger_loop)
      const bool above = k + s == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
      err = e;
      if (!(above && k + s < a.max_sweeps)) stop = s;
    }
    if (stop) {
      k += stop;
      if (stop < kb) sweeps(src, dst, stop, nullptr);  // the loop ends inside this pass
      break;
    }
    k += kb;
    src = dst;
    dst = dst == a.out ? a.tmp : a.out;
  }
  if (dst != a.out) {  // the final iterate is in tmp
    const size_t cells = (size_t)C.n * C.n * C.n;
    for (size_t i = (size_t)blockIdx.x * COL3_THREADS + threadIdx.x; i < cells;
         i += (size_t)gridDim.x * COL3_THREADS)
      a.out[i] = __ldcg(dst + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on the n^3 level u (not written) into out, batch sweeps a
// pass (batch <= 7 with ERR_CLEAN, <= 8 with ERR_GPU); tmp and mid are n^3
// scratch volumes, partials 2 * batch * (the plan's tile count) doubles, work
// the column pass's workspace (ops.kernels3.col3_work); (ty, tx, cz) the tile
// plan of the one-sweep error launches it reproduces.
extern "C" int mg3_trigger_stream(const float* u, const float* f, float* out, float* tmp,
                                  float* mid, double* partials, double* work, float* err_out,
                                  int* sweeps_out, int n, int err_mode, int batch, int ty,
                                  int tx, int cz, float h2, float w, float inv_h2,
                                  double err_scale, float trigger, int max_sweeps,
                                  void* stream) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || max_sweeps < 1 || batch < 1 ||
      batch > (err_mode == ERR_CLEAN ? MAX_STEPS3 - 1 : MAX_STEPS3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Stream3Args a{};
  const cudaError_t e = col3_setup(a.C, 1, f, work, n, 0, n, 0, ty, tx, cz, h2, w, inv_h2, s);
  if (e != cudaSuccess) return (int)e;
  a.u = u;
  a.out = out;
  a.tmp = tmp;
  a.mid = mid;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.err_mode = err_mode;
  a.batch = batch;
  a.max_sweeps = max_sweeps;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)launch_persistent(trigger3_stream_kernel, a, 0, col3_units(a.C), s,
                                dim3(COL3_THREADS));
}
