// The reference's whole error-triggered smoothing loop over every shard of a
// row-sharded level in one kernel: one damped-Jacobi sweep at a time while
// |err_k − err_{k−1}| > trigger, up to max_sweeps, with the cpu / clean / gpu
// smoothing-error metric summed over the ring.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma.py,
// _rdma_trigger_kernel, reached through parallel/pallas_shard.py's
// rdma_fused_trigger (the engine's sharded trigger levels with halo="rdma").
//
// Bound: per sweep, the exchange and the stop test. Driven from the host, a
// sweep is an exchange of halo rows, one launch per shard and a read of the
// error back to the host, tens of microseconds, while a sweep of one shard
// of a 2049² level takes the card a few. Design: one persistent cooperative
// launch runs the loop for the whole ring, each shard on its own slice of
// blocks (rdma.cuh); shards meet only through their own buffers and flags.
// Per sweep a shard's blocks walk its tiles with the smoother's tile code
// (jacobi_tile, legs.cuh: one sweep and the tile's error partial, exactly as
// the one-sweep shard-mode launch of jacobi.cu), interior tile rows first.
// The last of its blocks to finish the sweep sums the shard's tile partials
// in the one-launch reduction's fixed order, posts the fresh edge rows to the
// neighbours' receive buffers and the raw partial to every shard's error
// slot, and releases the sweep's tag on each shard's flag for it. Every block
// then waits for the tags of all shards, adds the partials in shard order and
// scales the sum, so every block of every shard reaches the same error and
// the same stop decision; that all-to-all is also the barrier between
// sweeps. The iterates, the stop sweep and the error are those of the loop
// of one-sweep shard-mode launches whose partials are added in shard order
// (parallel/kernel_shard.py), bit for bit.
#include "rdma.cuh"

using namespace mgk;

struct RingTriggerArgs {
  const float* u[MAX_SHARDS];  // starting iterate, shard blocks rows x n (read only)
  const float* f[MAX_SHARDS];
  float* out[MAX_SHARDS];      // final iterate
  float* tmp[MAX_SHARDS];      // ping-pong partner of out
  float* partials;             // tile partials, shard s's from part0[s]
  float* halo;                 // receive buffers (rdma.cuh)
  float* err;                  // [receiver][parity][sender] raw partials
  unsigned long long* flags;   // [receiver][sender]
  unsigned int* count;         // [2][shard]: arrivals at the first post, then at each sweep
  float* err_out;              // the final iterate's error
  int* sweeps_out;             // sweeps run
  int row0[MAX_SHARDS + 1];    // shard s owns rows [row0[s], row0[s + 1])
  int part0[MAX_SHARDS + 1];
  int shards, n, hr, err_mode, max_sweeps, blocks_per_shard;
  unsigned long long tag0;     // tag of the first post; sweep k posts tag0 + k
  float h2, omega, inv_h2, err_scale, trigger;
};

static __global__ void __launch_bounds__(THREADS) rdma_trigger_kernel(RingTriggerArgs a) {
  extern __shared__ float smem[];
  __shared__ float total_now;
  const int s = blockIdx.x / a.blocks_per_shard, lb = blockIdx.x % a.blocks_per_shard;
  const int nb = a.blocks_per_shard, P = a.shards, n = a.n;
  const int row0 = a.row0[s], rows = a.row0[s + 1] - row0;
  const Geo g(n, row0, 0, rows, n);
  const int tx = tiles_x(g), count = num_tiles(g);
  float* part = a.partials + a.part0[s];

  // the source's edge rows (parity 1, kept for the whole loop) and u_0's
  // (parity 0, the slot of iterate 0) to the neighbours
  post_edges(a.halo, a.f[s], s, P, 1, 1, rows, a.hr, n, lb, nb);
  post_edges(a.halo, a.u[s], s, P, 0, 0, rows, a.hr, n, lb, nb);
  // the first post has a count of its own: a block that arrives here and
  // runs on to the end of sweep 1 must not be counted in this round
  if (arrive_last(a.count + s, nb) && threadIdx.x == 0 && threadIdx.y == 0) {
    if (s > 0) release_tag(a.flags + (size_t)(s - 1) * P + s, a.tag0);
    if (s + 1 < P) release_tag(a.flags + (size_t)(s + 1) * P + s, a.tag0);
  }
  const Ring f = ring_source(a.f[s], a.halo, s, 1, 1, row0, rows, a.hr, n);

  const float* cur = a.u[s];
  float* nxt = a.out[s];
  float err = 0.0f;
  int k = 0;
  for (;;) {
    // sweep k + 1 reads iterate k, whose halos sit in the parity k & 1 slots
    const unsigned long long tag = a.tag0 + k;
    const Ring u = ring_source(cur, a.halo, s, k & 1, 0, row0, rows, a.hr, n);
    for (int pass = 0; pass < 2; ++pass) {  // interior tile rows, then boundary ones
      for (int t = lb; t < count; t += nb) {
        const int ty = t / tx;
        const bool top = reads_top(s, ty, a.hr), bot = reads_bot(s, P, ty, rows, a.hr);
        if ((top || bot) != (pass == 1)) continue;
        if (top) wait_tag(a.flags + (size_t)s * P + (s - 1), tag);
        if (bot) wait_tag(a.flags + (size_t)s * P + (s + 1), tag);
        jacobi_tile(smem, u, f, nxt, part + t, t % tx, ty, g, 1, a.hr, 0, a.err_mode, a.h2,
                    a.omega, a.inv_h2, 0.0f);
      }
    }
    // iterate k + 1 and the shard's tile partials are complete once every
    // block of the shard has arrived; the last one posts them. A block
    // arrives at sweep k + 2 only after this round's post (the all-to-all
    // below), so one count serves every sweep.
    const int slot = (k + 1) & 1;
    if (arrive_last(a.count + P + s, nb)) {
      const float raw = fixed_sum(part, count);
      post_edges(a.halo, nxt, s, P, slot, 0, rows, a.hr, n, 0, 1);
      if (threadIdx.x == 0 && threadIdx.y == 0)
        for (int d = 0; d < P; ++d) a.err[((size_t)d * 2 + slot) * P + s] = raw;
      __syncthreads();
      if (threadIdx.x == 0 && threadIdx.y == 0)
        for (int d = 0; d < P; ++d) release_tag(a.flags + (size_t)d * P + s, tag + 1);
    }
    // every shard's partial of iterate k + 1, added in shard order
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      float total = 0.0f;
      for (int d = 0; d < P; ++d) {
        spin_until(a.flags + (size_t)s * P + d, tag + 1);
        const float p = __ldcg(a.err + ((size_t)s * 2 + slot) * P + d);
        total = d == 0 ? p : __fadd_rn(total, p);
      }
      total_now = __fmul_rn(total, a.err_scale);
    }
    __syncthreads();
    const float e = total_now;
    __syncthreads();  // every thread has read total_now before it is rewritten
    ++k;
    // the slope test starts at sweep 2 (solver.trigger_loop)
    const bool above = k == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
    err = e;
    cur = nxt;
    nxt = nxt == a.out[s] ? a.tmp[s] : a.out[s];
    if (!(above && k < a.max_sweeps)) break;
  }
  if (cur != a.out[s]) copy_rows(a.out[s], cur, rows, n, lb, nb);  // the final iterate is in tmp
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on the shard blocks u_ptrs[s] (rows row0s[s]..row0s[s + 1]
// of the n x n level, each at least 2 rows; not written) into out_ptrs[s],
// with tmp_ptrs[s] scratch blocks of the same shapes; partials holds the
// sum over shards of mg_num_tiles_block(rows, n) floats; err_mode as
// mg_jacobi (not ERR_NONE); err_scale the metric's scale. halo, err, flags
// and count (2 * shards) are the ring workspace of `shards` shards
// (ops/rdma.py); tags
// tag0 .. tag0 + max_sweeps are above every tag the workspace has seen.
extern "C" int mg_rdma_trigger(const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* out_ptrs,
                               const unsigned long long* tmp_ptrs, const int* row0s, int shards,
                               int n, float* partials, float* halo, float* err,
                               unsigned long long* flags, unsigned int* count, float* err_out,
                               int* sweeps_out, int err_mode, float h2, float omega,
                               float inv_h2, float err_scale, float trigger, int max_sweeps,
                               unsigned long long tag0, void* stream) {
  if (shards < 1 || shards > MAX_SHARDS || n < 3 || err_mode == ERR_NONE || max_sweeps < 1 ||
      row0s[0] != 0 || row0s[shards] != n)
    return (int)cudaErrorInvalidValue;
  RingTriggerArgs a = {};
  a.hr = jacobi_halo(1, err_mode);
  int max_tiles = 0, total = 0;
  for (int s = 0; s < shards; ++s) {
    if (row0s[s + 1] - row0s[s] < a.hr) return (int)cudaErrorInvalidValue;
    a.u[s] = (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.tmp[s] = (float*)tmp_ptrs[s];
    a.row0[s] = row0s[s];
    a.part0[s] = total;
    const int t = num_tiles(Geo(n, row0s[s], 0, row0s[s + 1] - row0s[s], n));
    total += t;
    max_tiles = t > max_tiles ? t : max_tiles;
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
  a.err_mode = err_mode;
  a.max_sweeps = max_sweeps;
  a.tag0 = tag0;
  a.h2 = h2;
  a.omega = omega;
  a.inv_h2 = inv_h2;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)launch_ring(rdma_trigger_kernel, a, tile_smem_bytes(a.hr), shards, max_tiles,
                          (cudaStream_t)stream);
}
