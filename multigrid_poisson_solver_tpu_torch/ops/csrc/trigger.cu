// The reference's whole error-triggered smoothing loop in one kernel: one
// damped-Jacobi sweep at a time while |err_k − err_{k−1}| > trigger, up to
// max_sweeps, with the cpu / clean / gpu smoothing-error metric.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _trigger_vmem_kernel, reached through fused_trigger_vmem.
//
// Bound: the host round trip per sweep. Driven from the host, every sweep is
// a launch plus a read of the error back to the host for the stop test,
// tens of microseconds, while a sweep of a 256² level takes the card about
// one. Design: one persistent cooperative launch runs the loop on the card.
// Per sweep its blocks walk the tiles with the smoother's tile code
// (jacobi_tile, legs.cuh: one sweep plus the tile's error partial, exactly
// as jacobi.cu with steps = 1), meet at a grid barrier, and then every block
// sums the partials in the one-launch reduction's fixed order, so all blocks
// reach the same error and the same stop decision without another barrier.
// The iterate ping-pongs between out and tmp (the final one is copied into
// out when it lands in tmp); the partials alternate between two halves of
// their buffer, so a sweep never overwrites partials another block may still
// be summing. The iterates, the stop point and the reported error are those
// of the per-sweep launches of jacobi.cu, bit for bit.
#include "legs.cuh"

using namespace mgk;

struct TriggerArgs {
  const float* u;       // starting iterate (read only)
  const float* f;
  float* out;           // final iterate
  float* tmp;           // ping-pong partner of out
  float* partials;      // 2 * num_tiles(n) floats
  float* err_out;       // the final iterate's error
  int* sweeps_out;      // sweeps run
  int n, halo, err_mode, max_sweeps;
  float h2, omega, inv_h2, err_scale, trigger;
};

static __global__ void __launch_bounds__(THREADS) trigger_kernel(TriggerArgs a) {
  extern __shared__ float smem[];
  __shared__ float err_now;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int tx = tiles_x(a.n), count = num_tiles(a.n);
  const float* src = a.u;
  float* dst = a.out;
  float err = 0.0f;
  int k = 0;
  for (;;) {
    float* part = a.partials + (k & 1) * count;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      jacobi_tile(smem, window(src, a.n), window(a.f, a.n), dst, part + t, t % tx, t / tx, a.n,
                  1, a.halo, 0, a.err_mode, a.h2, a.omega, a.inv_h2, 0.0f);
    grid.sync();  // dst and the partials complete
    const float total = fixed_sum(part, count);
    if (threadIdx.x == 0 && threadIdx.y == 0) err_now = __fmul_rn(total, a.err_scale);
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
    const size_t cells = (size_t)a.n * a.n;
    for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.y * BLOCK_X + threadIdx.x;
         i < cells; i += (size_t)gridDim.x * THREADS)
      a.out[i] = __ldcg(src + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on u (not written) into out; tmp is an n x n scratch grid,
// partials 2 * mg_num_tiles(n) floats; err_mode as mg_jacobi (not ERR_NONE).
extern "C" int mg_trigger(const float* u, const float* f, float* out, float* tmp,
                          float* partials, float* err_out, int* sweeps_out, int n,
                          int err_mode, float h2, float omega, float inv_h2, float err_scale,
                          float trigger, int max_sweeps, void* stream) {
  if (n < 3 || err_mode == ERR_NONE || max_sweeps < 1) return (int)cudaErrorInvalidValue;
  TriggerArgs a = {};
  a.u = u;
  a.f = f;
  a.out = out;
  a.tmp = tmp;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.n = n;
  a.halo = jacobi_halo(1, err_mode);
  a.err_mode = err_mode;
  a.max_sweeps = max_sweeps;
  a.h2 = h2;
  a.omega = omega;
  a.inv_h2 = inv_h2;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)launch_persistent(trigger_kernel, a, tile_smem_bytes(a.halo), num_tiles(n),
                                (cudaStream_t)stream);
}
