// The reference's error-triggered smoothing loop as temporal blocking
// with an exact replay, over the whole grid: the wavefront passes that the
// two 2-D whole-loop trigger kernels run (kernel 8's levels from 1.5 M
// cells, trigger.cu; all of kernel 9's, trigger_stream.cu).
// Each entry point instantiates trigger_wave_loop in a kernel of its own
// name, so a profile tells the two apart.
//
// Bound: device-memory bandwidth and the fp32 instruction rate. Swept one
// at a time, a sweep reads u and f and writes u, 12 B a point: 0.060 ms at
// 4097² at 3.35 TB/s; a grid of 4097² (67 MB) does not stay in the 50 MB L2.
//
// Design: as the ring trigger kernel 17 (rdma_trigger.cu) runs the loop over
// the shards of a ring, here over the whole grid. One persistent
// cooperative launch runs passes of the wavefront's per-sweep pass
// (wave2.cuh, the RING stage: every copy a 16-byte cp.async.cg through L2,
// since other SMs rewrite the grids between passes, and a runtime count of
// sweeps on a pass's levels; the whole grid is a one-shard ring with no
// neighbours, so no receive buffer is read and nothing is posted). A pass
// reads and writes the grids once for its sweeps and leaves each sweep's
// tile partials in legs.cuh's tile order. A pass runs about as far as the
// stop is likely to be (next_sweeps, common.cuh: 2 sweeps, 1, then what the
// slopes' geometric decay predicts, at most TRIG_BATCH), on 1- and 2-level
// instances for the short passes: a pass costs its rows whatever its
// sweeps. After a pass the blocks meet at a grid barrier, every block sums
// each sweep's row of partials in sum_partials_kernel's order and replays
// the stop rule sweep by sweep, so every block takes the same decisions (a
// last block that sums and posts the decision, as kernel 17 meets, measured
// no faster at 4097²: PERF.md). If the loop stops at
// sweep s of a pass before its last, the blocks redo the pass from its input
// (intact in the ping-pong partner) with s sweeps. k fused sweeps equal k
// one-sweep launches and a pass's row s − 1 of partials is what an s-sweep
// launch of kernel 1 sums, so the iterate, the stop sweep and the error are
// those of the loop of kernel 1's one-sweep launches, bit for bit, whatever
// the passes' lengths.
#pragma once

#include "wave2.cuh"

namespace mgk {

// The most sweeps a pass runs, for every metric: at 8, the gpu metric's
// cap, the ring kernel's pass spills at 12 warps an SM (rdma_trigger.cu).
constexpr int TRIG_BATCH = 7;
// Warps an SM keeps resident: the passes are latency-bound, as kernel 17's.
constexpr int TRIG_WARPS_PER_SM = 12;

template <int K, int E>
using TrigShape = WaveShape<K, E, true, WV_SMOOTH, true>;

// Every later launch's passes, 0: next_sweeps' lengths; B: B sweeps each.
// Set by mg_trigger_force_batch (trigger_stream.cu, which defines it).
extern int trigger_forced_batch;

struct WaveTriggerArgs {
  const float* u;       // starting iterate (read only)
  const float* f;
  float* out;           // final iterate
  float* tmp;           // ping-pong partner of out
  float* partials;      // 2 halves of TRIG_BATCH rows of tile partials
  float* err_out;       // the final iterate's error
  int* sweeps_out;      // sweeps run
  int n, even_only, max_sweeps;
  int batch;            // the longest pass (or, fixed, every pass)
  int fixed;            // passes of `batch` sweeps (else next_sweeps' lengths)
  int chunk_rows[3], units[3];   // the 1-, 2- and TRIG_BATCH-level passes
  float h2, omega, inv_h2, err_scale, trigger;
};

// One pass of `sweeps` <= K sweeps, src into dst, over the units (strip and
// chunk) of this block's warps, on the K levels of the wavefront; instance
// i's chunks (0, 1, 2: the 1-, 2- and TRIG_BATCH-level passes).
template <int K, int E>
static __device__ __forceinline__ void trig_pass(const WaveTriggerArgs& a, int i, int sweeps,
                                                 float* part, const float* src, float* dst) {
  constexpr int WARPS = TrigShape<TRIG_BATCH, E>::WARPS;
  const Geo g(a.n, 0, 0, a.n, a.n);
  WaveRing ring = {};
  ring.u_top = ring.u_bot = src;   // rows beyond the grid are never read
  ring.f_top = ring.f_bot = a.f;
  ring.sweeps = sweeps;
  for (int w = blockIdx.x * WARPS + (threadIdx.x >> 5); w < a.units[i];
       w += gridDim.x * WARPS) {
    ring.unit = w;
    __syncwarp();   // every lane is done with the previous unit's rings
    wave2_pass<true, K, E, true, WV_SMOOTH, true>(src, a.f, dst, part, g, TrigShape<K, E>::H, 0,
                                                  a.chunk_rows[i], num_tiles(g), 0, a.even_only,
                                                  a.h2, a.omega, a.inv_h2, 0.0f, WaveLeg{}, ring);
  }
}

// The raw sum of each of the kb rows of partials (count each) in
// sum_partials_kernel's order, on a block of T threads: thread t plays the
// fixed sum's threads t + T·c (each adding its partials from +0), which go
// to v (kb x THREADS floats); then warp w takes rows w, w + T/32, ... with
// warp_block_sum. raw[j] in shared memory.
template <int T>
static __device__ void pass_sums(const float* part, int kb, int count, float* v, float* raw) {
  constexpr int C = THREADS / T;
  static_assert(THREADS % T == 0 && T % 32 == 0, "a block plays the 256 threads");
  float acc[TRIG_BATCH][C];
#pragma unroll
  for (int j = 0; j < TRIG_BATCH; ++j)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;
  for (int i0 = 0; i0 < count; i0 += THREADS) {
#pragma unroll
    for (int j = 0; j < TRIG_BATCH; ++j) {
      if (j >= kb) break;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = i0 + (int)threadIdx.x + T * c;
        if (i < count) acc[j][c] += __ldcg(part + (size_t)j * count + i);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < TRIG_BATCH; ++j) {
    if (j >= kb) break;
#pragma unroll
    for (int c = 0; c < C; ++c) v[j * THREADS + threadIdx.x + T * c] = acc[j][c];
  }
  __syncthreads();
  for (int j = threadIdx.x >> 5; j < kb; j += T / 32) {
    const float total = warp_block_sum(v + j * THREADS, THREADS);
    if ((threadIdx.x & 31) == 0) raw[j] = total;
  }
  __syncthreads();
}

// The loop, the body of each entry point's kernel: launched with
// TrigShape<TRIG_BATCH, E>::THREADS threads a block, ::SMEM bytes of dynamic
// shared memory, at most TRIG_WARPS_PER_SM warps an SM (launch bounds), as
// a cooperative grid (launch_wave_trigger).
template <int E>
static __device__ __forceinline__ void trigger_wave_loop(const WaveTriggerArgs& a) {
  using S = TrigShape<TRIG_BATCH, E>;
  extern __shared__ float scratch[];   // the passes' rings; between passes the sums
  __shared__ float raw[TRIG_BATCH];
  __shared__ float err_now;
  __shared__ int stop_now, len_now;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int count = num_tiles(Geo(a.n));
  const bool lead = threadIdx.x == 0;
  // a pass of `sweeps`: on 1 or 2 levels for next_sweeps' short passes,
  // else on TRIG_BATCH
  auto pass = [&](const float* src, float* dst, int sweeps, float* part) {
    static_assert(TrigShape<2, E>::WARP_FLOATS <= S::WARP_FLOATS, "the short passes fit");
    if (!a.fixed && sweeps == 1)
      trig_pass<1, E>(a, 0, 1, part, src, dst);
    else if (!a.fixed && sweeps == 2)
      trig_pass<2, E>(a, 1, 2, part, src, dst);
    else
      trig_pass<TRIG_BATCH, E>(a, 2, sweeps, part, src, dst);
  };

  const float* src = a.u;
  float* dst = a.out;
  float err = 0.0f, d1 = 0.0f, d0 = 0.0f;   // the last error and slopes (lead)
  int k = 0, len = a.fixed ? a.batch : next_sweeps(0, d1, d0, a.trigger, a.batch);
  for (int p = 0;; ++p) {
    const int kb = min(len, a.max_sweeps - k);   // >= 1: k < max_sweeps here
    // consecutive passes alternate halves: a block still summing pass p's
    // partials is not overwritten by another's pass p + 1 (or redo)
    float* const part = a.partials + (size_t)(p & 1) * TRIG_BATCH * count;
    pass(src, dst, kb, part);
    grid.sync();   // dst and the partials complete
    // each sweep's error, and the stop rule replayed sweep by sweep
    pass_sums<S::THREADS>(part, kb, count, scratch, raw);
    if (lead) {
      int stop = 0;
      for (int j = 0; j < kb && !stop; ++j)
        if (!trigger_goes_on(k + j, __fmul_rn(raw[j], a.err_scale), a.trigger, a.max_sweeps,
                             err, d1, d0))
          stop = j + 1;
      err_now = err;
      stop_now = stop;
      len_now = a.fixed ? a.batch : next_sweeps(k + kb, d1, d0, a.trigger, a.batch);
    }
    __syncthreads();
    err = err_now;
    const int stop = stop_now;
    len = len_now;
    __syncthreads();   // every thread has read them before they are rewritten
    if (stop) {
      k += stop;
      if (stop < kb) {   // the loop ends inside this pass: redo it with stop sweeps
        pass(src, dst, stop, a.partials + (size_t)((p + 1) & 1) * TRIG_BATCH * count);
        grid.sync();
      }
      break;
    }
    k += kb;
    src = dst;
    dst = dst == a.out ? a.tmp : a.out;
  }
  if (dst != a.out) {   // the final iterate is in tmp
    // 16-byte copies, four in flight a thread (out and tmp start 16-byte
    // aligned), then the last n² mod 4 floats
    const size_t cells = (size_t)a.n * a.n, quads = cells / 4;
    const float4* __restrict__ from = reinterpret_cast<const float4*>(dst);
    float4* __restrict__ to = reinterpret_cast<float4*>(a.out);
    const size_t stride = (size_t)gridDim.x * S::THREADS;
    for (size_t i = (size_t)blockIdx.x * S::THREADS + threadIdx.x; i < quads; i += 4 * stride) {
      float4 v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (i + b * stride < quads) v[b] = __ldcg(from + i + b * stride);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (i + b * stride < quads) to[i + b * stride] = v[b];
    }
    if (blockIdx.x == 0 && threadIdx.x < cells % 4)
      a.out[4 * quads + threadIdx.x] = __ldcg(dst + 4 * quads + threadIdx.x);
  }
  if (blockIdx.x == 0 && lead) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The args of the loop on u (not written) into out, tmp its scratch grid,
// passes of at most min(batch, TRIG_BATCH) sweeps; partials as
// mg_trigger_stream takes them. Refuses what the loop does not take.
static inline cudaError_t trigger_wave_args(const float* u, const float* f, float* out,
                                            float* tmp, float* partials, float* err_out,
                                            int* sweeps_out, int n, int err_mode, int batch,
                                            float h2, float omega, float inv_h2,
                                            float err_scale, float trigger, int max_sweeps,
                                            WaveTriggerArgs& a) {
  if (n < 3 || err_mode <= ERR_NONE || err_mode > ERR_GPU || max_sweeps < 1 || batch < 1 ||
      batch > MAX_STEPS)
    return cudaErrorInvalidValue;
  if (misaligned(u, f) || misaligned(out, tmp)) return cudaErrorMisalignedAddress;
  a = {};
  a.u = u;
  a.f = f;
  a.out = out;
  a.tmp = tmp;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.n = n;
  a.even_only = err_mode == ERR_CPU ? 1 : 0;
  a.max_sweeps = max_sweeps;
  a.fixed = trigger_forced_batch ? 1 : 0;
  a.batch = trigger_forced_batch ? trigger_forced_batch
                                 : (batch < TRIG_BATCH ? batch : TRIG_BATCH);
  a.h2 = h2;
  a.omega = omega;
  a.inv_h2 = inv_h2;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return cudaSuccess;
}

// Launch `kernel` (a __global__ running trigger_wave_loop<E>) on a
// filled-in args: each instance's chunks for the warps the launch keeps
// resident, as many blocks as can be resident (at most one a warp's unit).
template <int E>
static cudaError_t launch_wave_trigger(void (*kernel)(WaveTriggerArgs), WaveTriggerArgs& a,
                                       cudaStream_t stream) {
  using S = TrigShape<TRIG_BATCH, E>;
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  static_assert(TRIG_BATCH * THREADS <= S::WARPS * S::WARP_FLOATS, "the sums fit the rings");
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::THREADS,
                                                         S::SMEM)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  // each instance's chunks for the warps the launch keeps resident
  const Geo g(a.n);
  const int resident = per_sm * sms * S::WARPS;
  const int halos[3] = {TrigShape<1, E>::H, TrigShape<2, E>::H, S::H};
  int units = 0;
  for (int i = 0; i < 3; ++i) {
    a.chunk_rows[i] = wave2_rows(g, resident, halos[i]);
    a.units[i] = tiles_x(g) * ((a.n + a.chunk_rows[i] - 1) / a.chunk_rows[i]);
    units = a.units[i] > units ? a.units[i] : units;
  }
  const int want = (units + S::WARPS - 1) / S::WARPS;
  const int blocks = per_sm * sms < want ? per_sm * sms : want;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(S::THREADS), params,
                                  S::SMEM, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mgk
