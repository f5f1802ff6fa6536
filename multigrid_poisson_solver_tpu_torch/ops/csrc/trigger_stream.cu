// The reference's whole error-triggered smoothing loop in one kernel, for
// levels too large for trigger.cu's sweep-at-a-time loop to stay in L2: one
// damped-Jacobi sweep at a time while |err_k − err_{k−1}| > trigger, up to
// max_sweeps, with the cpu / clean / gpu smoothing-error metric.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _trigger_stream_kernel, reached through fused_trigger_stream (the engine's
// trigger nodes of 2176 < n <= 4097, trigger_stream_fits).
//
// Bound and design: trigger_wave.cuh's wavefront passes with an exact replay
// (kernel 8's levels above its cluster run the same loop, trigger.cu), in a
// kernel of this entry point's own name.
#include "trigger_wave.cuh"

using namespace mgk;

namespace mgk {
int trigger_forced_batch = 0;
}  // namespace mgk

template <int E>
static __global__ void __launch_bounds__(TrigShape<TRIG_BATCH, E>::THREADS,
                                         TRIG_WARPS_PER_SM / TrigShape<TRIG_BATCH, E>::WARPS)
trigger_stream_wave_kernel(WaveTriggerArgs a) {
  trigger_wave_loop<E>(a);
}

// The passes of every later wavefront trigger launch (kernels 8 and 9): 0
// next_sweeps' lengths, 1..TRIG_BATCH that many sweeps each (checks reach
// stops inside long passes with it; the results do not depend on it).
extern "C" int mg_trigger_force_batch(int batch) {
  if (batch < 0 || batch > TRIG_BATCH) return (int)cudaErrorInvalidValue;
  trigger_forced_batch = batch;
  return 0;
}

// The trigger loop on u (not written) into out, passes of at most
// min(batch, 7) sweeps (batch 1..8); tmp is an n x n scratch grid; u, f, out
// and tmp start 16-byte aligned (else cudaErrorMisalignedAddress); partials
// holds 2 * 7 * mg_num_tiles(n) floats; err_mode as mg_jacobi (not
// ERR_NONE).
extern "C" int mg_trigger_stream(const float* u, const float* f, float* out, float* tmp,
                                 float* partials, float* err_out, int* sweeps_out, int n,
                                 int err_mode, int batch, float h2, float omega, float inv_h2,
                                 float err_scale, float trigger, int max_sweeps, void* stream) {
  WaveTriggerArgs a;
  const cudaError_t e = trigger_wave_args(u, f, out, tmp, partials, err_out, sweeps_out, n,
                                          err_mode, batch, h2, omega, inv_h2, err_scale,
                                          trigger, max_sweeps, a);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(err_mode == ERR_GPU
                   ? launch_wave_trigger<WV_GPU>(trigger_stream_wave_kernel<WV_GPU>, a, s)
                   : launch_wave_trigger<WV_RES>(trigger_stream_wave_kernel<WV_RES>, a, s));
}
