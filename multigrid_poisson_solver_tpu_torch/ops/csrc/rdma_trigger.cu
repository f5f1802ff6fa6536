// The reference's whole error-triggered smoothing loop over every shard of a
// row-sharded level in one kernel: one damped-Jacobi sweep at a time while
// |err_k − err_{k−1}| > trigger, up to max_sweeps, with the cpu / clean / gpu
// smoothing-error metric summed over the ring.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma.py,
// _rdma_trigger_kernel, reached through parallel/pallas_shard.py's
// rdma_fused_trigger (the engine's sharded trigger levels with halo="rdma").
//
// Bound: device-memory bandwidth and the exchange. Driven from the host, a
// sweep is an exchange of halo rows, one launch per shard and a read of the
// error back to the host, tens of microseconds, while a sweep of one shard
// of a 2049² level takes the card a few; swept one at a time, each sweep
// reads u and f and writes u (12 B a point).
//
// Design: one persistent cooperative launch runs the loop for the whole
// ring, each shard on its own slice of blocks (rdma.cuh, ring.cuh); shards
// meet only through their own buffers and flags. The loop runs passes of
// <= B sweeps, temporal blocking with an exact replay as trigger_stream.cu
// does on the whole grid: a pass is kernel 1's per-sweep shard pass
// (wave2.cuh, wave2_pass<true, B, E, true>, mg_jacobi_errs_shard's body,
// its levels above the pass's sweeps copies) over the shard's block, its
// warps walking the (strip, chunk) units, so a pass reads and writes the
// grids once for its sweeps and leaves each sweep's tile partials in
// legs.cuh's tile order. A pass runs about as far as the stop is likely to
// be (next_sweeps, common.cuh: 2 sweeps, 1, then what the slopes' decay
// predicts): the engine's trigger nodes stop after a few sweeps, and a pass
// that runs past the stop costs a redo. Rows beyond the block come from the
// receive buffers (WaveRing): the pass's input's H = B (+1 for cpu / clean)
// edge rows, which the neighbours' warps wrote there when they stored them
// in the pass before (f's once, before the loop, with u_0's). The slots
// alternate by pass parity, so a redo still reads them. The last block of a
// shard to finish a pass sums each sweep's row of tile partials in
// sum_partials_kernel's order, posts the pass's raw partials to every
// shard's error slots and releases one tag on each shard's flag for it. Every block
// waits for all shards, adds each sweep's partials in shard order, scales,
// and replays the stop rule sweep by sweep (the slope test from sweep 2,
// then max_sweeps), so every block of every shard takes the same decisions;
// the all-to-all is also the barrier between passes. If the loop stops at
// sweep s of a pass before its last, the blocks redo the pass from its
// input (intact in the ping-pong partner) with s sweeps and no errors, and
// meet once more before the copy of the final iterate to out. k fused
// sweeps equal k one-sweep launches and errs[s − 1] is the error an s-sweep
// launch reports, so the iterates, the stop sweep and the error are those of
// the loop of one-sweep shard-mode launches whose partials are added in
// shard order (parallel/kernel_shard.py), bit for bit, whatever the passes'
// lengths.
#include <algorithm>

#include "rdma.cuh"

using namespace mgk;

struct RingTriggerArgs {
  const float* u[MAX_SHARDS];  // starting iterate, shard blocks rows x n (read only)
  const float* f[MAX_SHARDS];
  float* out[MAX_SHARDS];      // final iterate
  float* tmp[MAX_SHARDS];      // ping-pong partner of out
  float* partials;             // B rows of tile partials a shard, shard s's from B · part0[s]
  float* halo;                 // receive buffers (rdma.cuh)
  float* err;                  // [receiver][parity][sender][MAX_STEPS] raw partials
  unsigned long long* flags;   // [receiver][sender]
  unsigned int* count;         // [2][shard]: arrivals at the first post, then at each pass
  float* err_out;              // the final iterate's error
  int* sweeps_out;             // sweeps run
  int row0[MAX_SHARDS + 1];    // shard s owns rows [row0[s], row0[s + 1])
  int part0[MAX_SHARDS + 1];
  int chunk_rows[MAX_SHARDS];  // the wavefront's chunk of each shard
  int shards, n, even_only, max_sweeps, blocks_per_shard;
  int fixed;                   // passes of B sweeps (else next_sweeps' lengths)
  unsigned long long tag0;     // tag of the first post; pass p posts tag0 + p + 1
  float h2, omega, inv_h2, err_scale, trigger;
};

// Σ p[0..count) in sum_partials_kernel's order on a block of T threads
// (T divides THREADS): fixed_sum's 256 thread sums (thread t adds t, t +
// 256, ... from +0), each played by thread t mod T, then block_sum's
// butterflies over each warp's 32 and over the 8 warp sums in lanes 0..7
// (the others +0). Valid in thread 0; `sh` holds THREADS floats.
template <int T>
static __device__ float ring_fixed_sum(const float* p, int count, float* sh) {
  for (int v = threadIdx.x; v < THREADS; v += T) {
    float x = 0.0f;
    for (int i = v; i < count; i += THREADS) x += __ldcg(p + i);
    sh[v] = x;
  }
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int y = 0; y < BLOCK_Y; ++y) {
      float x = sh[y * BLOCK_X + lane];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == y) total = x;
    }
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  __syncthreads();  // sh is read before it is rewritten
  return total;
}

template <int B, int E>
using RingShape = WaveShape<B, E, true, WV_SMOOTH, true>;

// B, the most sweeps a pass runs: 7 for every metric (at 8, the gpu
// metric's cap, its pass spills at RING_WARPS_PER_SM: 0.0688 against 0.0598
// ms a sweep at 4097² on 8 shards, on an H100), its passes' lengths from
// next_sweeps; or for every later launch passes of 1..MAX_STEPS (capped by
// the metric's and the shards' limits) as mg_rdma_force_batch set it.
constexpr int RING_BATCH = 7;

template <int B, int E>
static __global__ void __launch_bounds__(RingShape<B, E>::THREADS,
                                         RING_WARPS_PER_SM / RingShape<B, E>::WARPS)
rdma_trigger_kernel(RingTriggerArgs a) {
  using S = RingShape<B, E>;
  __shared__ float sh[THREADS];
  __shared__ float err_now;
  __shared__ int stop_now, len_now;
  const int nb = a.blocks_per_shard, s = blockIdx.x / nb, lb = blockIdx.x % nb;
  const int P = a.shards, n = a.n;
  const int row0 = a.row0[s], rows = a.row0[s + 1] - row0, chunk_rows = a.chunk_rows[s];
  const Geo g(n, row0, 0, rows, n);
  const int count = num_tiles(g);
  const int units = tiles_x(g) * ((rows + chunk_rows - 1) / chunk_rows);
  float* const part = a.partials + (size_t)B * a.part0[s];
  const bool lead = threadIdx.x == 0;

  // f's and u_0's edge rows to the neighbours (u_0's in the parity 0 slots,
  // pass 0's); the first post has a count of its own: a block that arrives
  // here and runs on to the end of pass 0 must not be counted in this round
  post_edges<S::THREADS>(a.halo, a.f[s], s, P, 0, 1, rows, S::H, n, lb, nb);
  post_edges<S::THREADS>(a.halo, a.u[s], s, P, 0, 0, rows, S::H, n, lb, nb);
  if (arrive_last(a.count + s, nb) && lead) {
    if (s > 0) release_tag(a.flags + (size_t)(s - 1) * P + s, a.tag0);
    if (s + 1 < P) release_tag(a.flags + (size_t)(s + 1) * P + s, a.tag0);
  }
  if (lead) {
    if (s > 0) spin_until(a.flags + (size_t)s * P + (s - 1), a.tag0);
    if (s + 1 < P) spin_until(a.flags + (size_t)s * P + (s + 1), a.tag0);
  }
  __syncthreads();

  WaveRing ring = {};
  ring.f_top = recv_buf(a.halo, s, 0, 0, 1, n) + (size_t)RING_HALO * n;
  ring.f_bot = recv_buf(a.halo, s, 0, 1, 1, n);
  // a pass of `sweeps`: on the B levels, or, for the 1 or 2 sweeps of
  // next_sweeps' short passes, on 1 or 2 (a pass on B levels costs about as
  // much for any sweeps: 0.38 ms for 2 at 4097² on 8 shards, on an H100);
  // its units in wave2_pass's order: every block has waited for both
  // neighbours' first post above, and the passes meet between them
  const auto in_order = [](int w) { return w; };
  auto pass = [&](const float* src, float* dst, int sweeps) {
    ring.sweeps = sweeps;
    if constexpr (B == RING_BATCH) {
      static_assert(RingShape<2, E>::WARP_FLOATS <= S::WARP_FLOATS, "the short passes fit");
      if (!a.fixed && sweeps <= 2) {
        if (sweeps == 1)
          ring_pass<1, E, true>(a, ring, in_order, s, g, S::H, S::WARPS, units, chunk_rows,
                                count, part, src, dst, 0, 0.0f);
        else
          ring_pass<2, E, true>(a, ring, in_order, s, g, S::H, S::WARPS, units, chunk_rows,
                                count, part, src, dst, 0, 0.0f);
        return;
      }
    }
    ring_pass<B, E, true>(a, ring, in_order, s, g, S::H, S::WARPS, units, chunk_rows, count,
                          part, src, dst, 0, 0.0f);
  };

  const float* src = a.u[s];
  float* dst = a.out[s];
  float err = 0.0f, d1 = 0.0f, d0 = 0.0f;   // the last error and slopes (lead)
  int k = 0, len = a.fixed ? B : next_sweeps(0, d1, d0, a.trigger, B);   // the pass's sweeps
  for (int p = 0;; ++p) {
    const int kb = min(len, a.max_sweeps - k);   // >= 1: k < max_sweeps here
    const int par = p & 1;
    ring.u_top = recv_buf(a.halo, s, par, 0, 0, n) + (size_t)RING_HALO * n;
    ring.u_bot = recv_buf(a.halo, s, par, 1, 0, n);
    ring.up = s > 0 ? recv_buf(a.halo, s - 1, par ^ 1, 1, 0, n) : nullptr;
    ring.down = s + 1 < P ? recv_buf(a.halo, s + 1, par ^ 1, 0, 0, n) + (size_t)RING_HALO * n
                          : nullptr;
    ring.post_rows = S::H;
    pass(src, dst, kb);
    // the pass's iterates, edge rows and partials are complete once every
    // block of the shard has arrived; the last one sums and posts. A block
    // arrives at pass p + 1 only after this pass's all-to-all, so one count
    // serves every pass.
    const unsigned long long tag = a.tag0 + p + 1;
    if (arrive_last(a.count + P + s, nb)) {
      for (int j = 0; j < kb; ++j) {
        const float raw = ring_fixed_sum<S::THREADS>(part + (size_t)j * count, count, sh);
        if (lead)
          for (int d = 0; d < P; ++d)
            a.err[(((size_t)d * 2 + par) * P + s) * MAX_STEPS + j] = raw;
      }
      if (lead)
        for (int d = 0; d < P; ++d) release_tag(a.flags + (size_t)d * P + s, tag);
    }
    // every shard's partials of each sweep, added in shard order, and the
    // stop rule replayed sweep by sweep
    if (lead) {
      for (int d = 0; d < P; ++d) spin_until(a.flags + (size_t)s * P + d, tag);
      int stop = 0;
      for (int j = 0; j < kb && !stop; ++j) {
        float total = 0.0f;
        for (int d = 0; d < P; ++d) {
          const float q = __ldcg(a.err + (((size_t)s * 2 + par) * P + d) * MAX_STEPS + j);
          total = d == 0 ? q : __fadd_rn(total, q);
        }
        const float e = __fmul_rn(total, a.err_scale);
        // the slope test starts at sweep 2 (solver.trigger_loop)
        const float d = fabsf(__fsub_rn(e, err));
        const bool above = k + j == 0 || d > a.trigger;
        d0 = d1;
        d1 = d;
        err = e;
        if (!(above && k + j + 1 < a.max_sweeps)) stop = j + 1;
      }
      err_now = err;
      stop_now = stop;
      len_now = a.fixed ? B : next_sweeps(k + kb, d1, d0, a.trigger, B);
    }
    __syncthreads();
    err = err_now;
    const int stop = stop_now;
    len = len_now;
    __syncthreads();   // every thread has read them before they are rewritten
    if (stop) {
      k += stop;
      if (stop < kb) {   // the loop ends inside this pass: redo it with stop sweeps
        ring.post_rows = 0;
        pass(src, dst, stop);
        if (dst != a.out[s]) {   // the shard's blocks meet before the copy below
          if (arrive_last(a.count + P + s, nb) && lead)
            release_tag(a.flags + (size_t)s * P + s, tag + 1);
          wait_tag(a.flags + (size_t)s * P + s, tag + 1);
        }
      }
      break;
    }
    k += kb;
    src = dst;
    dst = dst == a.out[s] ? a.tmp[s] : a.out[s];
  }
  if (dst != a.out[s]) copy_rows<S::THREADS>(a.out[s], dst, rows, n, lb, nb);   // in tmp
  if (blockIdx.x == 0 && lead) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The passes' sweeps of every later launch, 0: RING_BATCH and next_sweeps.
static int forced_batch = 0;

extern "C" int mg_rdma_force_batch(int batch) {
  if (batch < 0 || batch > MAX_STEPS) return (int)cudaErrorInvalidValue;
  forced_batch = batch;
  return 0;
}

template <int B, int E>
static cudaError_t launch_trigger(RingTriggerArgs& a, const int* row0s, cudaStream_t stream) {
  return launch_ring_wave<RingShape<B, E>>(rdma_trigger_kernel<B, E>, a, row0s, stream);
}

template <int E, int B = 1>
static cudaError_t launch_trigger_b(int batch, RingTriggerArgs& a, const int* row0s,
                                    cudaStream_t stream) {
  if constexpr (B + (E == WV_RES ? 1 : 0) > MAX_STEPS) {
    return cudaErrorInvalidValue;
  } else {
    if (batch == B) return launch_trigger<B, E>(a, row0s, stream);
    return launch_trigger_b<E, B + 1>(batch, a, row0s, stream);
  }
}

// The trigger loop on the shard blocks u_ptrs[s] (rows row0s[s]..row0s[s + 1]
// of the n x n level, each at least 2 rows; not written) into out_ptrs[s],
// with tmp_ptrs[s] scratch blocks of the same shapes; u, f, out and tmp
// blocks start 16-byte aligned (else cudaErrorMisalignedAddress); partials
// holds MAX_STEPS times the sum over shards of mg_num_tiles_block(rows, n)
// floats; err_mode as mg_jacobi (not ERR_NONE); err_scale the metric's
// scale. halo, err, flags and count (2 * shards) are the ring workspace of
// `shards` shards (ops/rdma.py); tags tag0 .. tag0 + max_sweeps + 1 are
// above every tag the workspace has seen. A pass runs at most RING_BATCH
// sweeps, fewer where a shard has fewer rows than its halo (or exactly
// mg_rdma_force_batch's, at most 7 for cpu / clean).
extern "C" int mg_rdma_trigger(const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* out_ptrs,
                               const unsigned long long* tmp_ptrs, const int* row0s, int shards,
                               int n, float* partials, float* halo, float* err,
                               unsigned long long* flags, unsigned int* count, float* err_out,
                               int* sweeps_out, int err_mode, float h2, float omega,
                               float inv_h2, float err_scale, float trigger, int max_sweeps,
                               unsigned long long tag0, void* stream) {
  if (shards < 1 || shards > MAX_SHARDS || n < 3 || err_mode <= ERR_NONE ||
      err_mode > ERR_GPU || max_sweeps < 1 || row0s[0] != 0 || row0s[shards] != n)
    return (int)cudaErrorInvalidValue;
  const int res = err_mode == ERR_GPU ? 0 : 1;   // the residual's halo row
  int batch = forced_batch ? forced_batch : RING_BATCH;
  batch = std::min(batch, std::min(MAX_STEPS - res, max_sweeps));
  RingTriggerArgs a = {};
  int total = 0;
  for (int s = 0; s < shards; ++s) {
    const int rows = row0s[s + 1] - row0s[s];
    if (rows < 1 + res) return (int)cudaErrorInvalidValue;
    batch = std::min(batch, rows - res);   // a pass's halo rows come from one neighbour
    a.u[s] = (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.tmp[s] = (float*)tmp_ptrs[s];
    if (misaligned(a.u[s], a.f[s]) || misaligned(a.out[s], a.tmp[s]))
      return (int)cudaErrorMisalignedAddress;
    a.row0[s] = row0s[s];
    a.part0[s] = total;
    total += num_tiles(Geo(n, row0s[s], 0, rows, n));
  }
  a.row0[shards] = n;
  a.part0[shards] = total;
  a.partials = partials;
  a.halo = halo;
  a.err = err;
  a.flags = flags;
  a.count = count;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.shards = shards;
  a.n = n;
  a.even_only = err_mode == ERR_CPU ? 1 : 0;
  a.fixed = forced_batch ? 1 : 0;
  a.max_sweeps = max_sweeps;
  a.tag0 = tag0;
  a.h2 = h2;
  a.omega = omega;
  a.inv_h2 = inv_h2;
  a.err_scale = err_scale;
  a.trigger = trigger;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(res ? launch_trigger_b<WV_RES>(batch, a, row0s, st)
                   : launch_trigger_b<WV_GPU>(batch, a, row0s, st));
}
