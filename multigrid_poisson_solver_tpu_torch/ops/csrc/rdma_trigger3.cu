// The reference's whole error-triggered smoothing loop over every z-shard of
// a sharded 3-D level in one kernel: one damped-Jacobi sweep of the 7-point
// stencil at a time while |err_k − err_{k−1}| > trigger, up to max_sweeps,
// with the clean or gpu smoothing-error metric summed over the ring.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma3.py,
// _rdma_trigger3_kernel, reached through parallel/pallas_shard3.py's
// rdma_fused_trigger3 (the engine's sharded trigger levels with
// halo="rdma").
//
// Bound: per sweep, the exchange and the stop test. Driven from the host, a
// sweep is a window copy of u and f per shard, one launch per shard, the
// sum of the shards' errors and a read of it back to the host, tens of
// microseconds and more, while a sweep of a 129³ level takes the card a few.
// Design: one persistent cooperative launch runs the loop for the whole ring,
// each shard on its own slice of blocks (rdma3.cuh); shards meet only
// through their own buffers and flags. Before the loop a shard's blocks post
// the planes of f and of the starting iterate that the neighbours' windows
// take. Per sweep they walk the shard's tiles with the one-sweep error leg
// of jacobi3.cu in ring mode (legs3.cuh: the sweep and, for the clean
// metric, the extra stage of the new iterate; the tile plan of every launch
// of the trigger loops, err_plan3 of the shard's depth), and each block
// posts the fresh planes of its tiles that a neighbour's window takes. The
// last block of a shard to finish the sweep sums the shard's tile partials
// in the one-launch reduction's fixed order, posts the raw float64 sum to
// every shard's error slot and releases the sweep's tag on each shard's flag
// for it. Every block then waits for the tags of all shards, adds the raw
// sums in shard order and scales once, so every block of every shard reaches
// the same error and the same stop decision; that all-to-all is also the
// barrier between sweeps, after which every halo plane of the new iterate
// is in place. The iterates, the stop sweep and the error are those of the
// loop of one-sweep shard-mode error launches whose raw sums are added in
// shard order (parallel/kernel_shard3.py's sharded_trigger_step3), bit for
// bit. (JAX's kernel takes the clean error of the new iterate after its
// fresh halo planes arrive; here the one-sweep leg takes it with the sweep,
// from two halo planes of the old iterate: the same number.)
#include "rdma3.cuh"

using namespace mgk3;

struct RingTrigger3Args {
  Leg3 L;                          // the one-sweep error leg (pointers set per shard and sweep)
  Ring3 W;
  const float* u[MAX_SHARDS3];     // starting iterate, shard blocks (read only)
  const float* f[MAX_SHARDS3];
  float* out[MAX_SHARDS3];         // final iterate
  float* tmp[MAX_SHARDS3];         // ping-pong partner of out
  int cz[MAX_SHARDS3];             // z chunk of shard s's tile plan
  int part0[MAX_SHARDS3 + 1];      // shard s's tile partials from part0[s]
  double* partials;
  float* err_out;                  // the final iterate's error
  int* sweeps_out;                 // sweeps run
  int max_sweeps, blocks_per_shard;
  unsigned long long tag0;         // tag of the first post; sweep k posts tag0 + k
  double err_scale;                // Σ|r| (or Σ|Δu|) to the metric
  float trigger;
};

// Post the planes of tile b of shard s (its owned planes of the iterate at
// src, the block's own stores) that another shard's window takes, into the
// parity `par` buffers.
static __device__ void post_tile(const Ring3& W, int s, const Leg3& L, const Blk& b,
                                 const float* src, int par) {
  const int n = W.n, z0 = W.z0[s], z1 = W.z0[s + 1];
  const int c0 = z0 + b.z * L.cz, c1 = c0 + L.cz < z1 ? c0 + L.cz : z1;
  const int y0 = b.y * L.ty, x0 = b.x * L.tx;
  const int rows = min(L.ty, n - y0), cols = min(L.tx, n - x0);
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  for (int r = 0; r < W.shards; ++r) {
    if (r == s) continue;
    for (int side = 0; side < 2; ++side) {
      const PlaneRange x = meet(fine_window(W, r, side, L.halo), c0, c1);
      const int origin = side == 0 ? W.z0[r] - RING3_HALO : W.z0[r + 1];
      float* buf = ubuf3(W, r, par, side);
      for (int p = x.lo; p < x.hi; ++p)
        for (int idx = tid; idx < rows * cols; idx += THREADS3) {
          const int i = y0 + idx / cols, j = x0 + idx % cols;
          buf[gidx3(n, p - origin, i, j)] = __ldcg(src + gidx3(n, p - z0, i, j));
        }
    }
  }
}

static __global__ void __launch_bounds__(THREADS3) rdma_trigger3_kernel(RingTrigger3Args a) {
  extern __shared__ float smem[];
  __shared__ float err_now;
  const int s = blockIdx.x / a.blocks_per_shard, lb = blockIdx.x % a.blocks_per_shard;
  const int nb = a.blocks_per_shard;
  const Ring3& W = a.W;
  const int P = W.shards;
  const bool lead = threadIdx.x == 0 && threadIdx.y == 0;
  ShardLeg3 x = shard_leg3(a.L, W, s, a.cz[s], a.partials + a.part0[s]);
  Leg3& L = x.L;
  L.f = a.f[s];
  const int z0 = W.z0[s], cells = (W.z0[s + 1] - z0) * W.n * W.n;

  // f's planes (kept for the whole loop) and u_0's (parity 0, the slot of
  // iterate 0) to the neighbours; the first post has a count of its own: a
  // block that arrives here and runs on to the end of sweep 1 must not be
  // counted in this round
  post_inputs(W, s, a.u[s], a.f[s], nullptr, L.halo, 0, lb, nb);
  if (mgk::arrive_last(W.count + s, nb) && lead)
    for (int r = 0; r < P; ++r)
      if (r != s) mgk::release_tag(W.flags + (size_t)r * P + s, a.tag0);

  const float* cur = a.u[s];
  float* nxt = a.out[s];
  float err = 0.0f;
  int k = 0;
  for (;;) {
    // sweep k + 1 reads iterate k, whose halo planes sit in the parity k & 1
    // buffers: before sweep 1 the first post, later the all-to-all below
    // brought them
    const unsigned long long tag = a.tag0 + k;
    const int slot = (k + 1) & 1;
    L.u = cur;
    L.out = nxt;
    const RingSrc3 R = ring_src3(W, s, k & 1, cur, a.f[s], nullptr);
    bool ready = k > 0;
    for (int pass = 0; pass < 2; ++pass) {  // tiles within the shard, then the others
      for (int t = lb; t < x.count; t += nb) {
        const Blk b = leg3_blk(L, t);
        const bool ring = tile_reads_ring(W, s, L, b);
        if (ring != (pass == 1)) continue;
        if (ring && !ready) {
          wait_senders(W, s, L.halo, false, tag);
          ready = true;
        }
        run_leg3_at<true, true, false, true>(smem, L, x.P, b, &R);
        __syncthreads();
        post_tile(W, s, L, b, nxt, slot);
      }
    }
    // iterate k + 1, its posts and the shard's tile partials are complete
    // once every block of the shard has arrived; the last one sums and posts
    // the partial. A block arrives at sweep k + 2 only after this round's
    // post (the all-to-all below), so one count serves every sweep.
    if (mgk::arrive_last(W.count + P + s, nb)) {
      const double raw = fixed_sum3(L.partials, x.count);
      if (lead)
        for (int d = 0; d < P; ++d) W.err[((size_t)d * 2 + slot) * P + s] = raw;
      __syncthreads();
      if (lead)
        for (int d = 0; d < P; ++d) mgk::release_tag(W.flags + (size_t)d * P + s, tag + 1);
    }
    // every shard's raw sum of iterate k + 1, added in shard order
    if (lead) {
      double total = 0.0;
      for (int d = 0; d < P; ++d) {
        mgk::spin_until(W.flags + (size_t)s * P + d, tag + 1);
        const double p = __ldcg(W.err + ((size_t)s * 2 + slot) * P + d);
        total = d == 0 ? p : __dadd_rn(total, p);
      }
      err_now = scaled_error3(total, a.err_scale);
    }
    __syncthreads();
    const float e = err_now;
    __syncthreads();  // every thread has read err_now before it is rewritten
    ++k;
    // the slope test starts at sweep 2 (solver.trigger_loop)
    const bool above = k == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
    err = e;
    cur = nxt;
    nxt = nxt == a.out[s] ? a.tmp[s] : a.out[s];
    if (!(above && k < a.max_sweeps)) break;
  }
  if (cur != a.out[s])  // the final iterate is in tmp
    copy_floats(a.out[s], cur, (size_t)cells, lb, nb);
  if (blockIdx.x == 0 && lead) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on the shard blocks u_ptrs[s] (planes z0s[s]..z0s[s + 1]
// of the n^3 level; not written) into out_ptrs[s], with tmp_ptrs[s] scratch
// blocks of the same shapes; err_mode ERR_CLEAN or ERR_GPU; (ty, tx) and
// czs[s] each shard's tile plan (err_plan3 of its depth); partials one
// double per tile of every shard; err_scale the metric's scale. ws is the
// ring workspace of ops/rdma3.py; tags tag0 .. tag0 + max_sweeps are above
// every tag it has seen.
extern "C" int mg3_rdma_trigger(const unsigned long long* u_ptrs,
                                const unsigned long long* f_ptrs,
                                const unsigned long long* out_ptrs,
                                const unsigned long long* tmp_ptrs, const int* z0s,
                                const int* czs, int shards, int n, int err_mode, int ty, int tx,
                                double* partials, float* err_out, int* sweeps_out,
                                const unsigned long long* ws, unsigned long long tag0, float h2,
                                float w, float inv_h2, double err_scale, float trigger,
                                int max_sweeps, void* stream) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || max_sweeps < 1 || partials == nullptr)
    return (int)cudaErrorInvalidValue;
  RingTrigger3Args a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  Leg3& L = a.L;  // pointers and partials set per shard and sweep in the kernel
  L.n = n;
  L.sweeps = 1;
  L.last = err_mode == ERR_CLEAN ? EXTRA : -1;
  L.err_mode = err_mode;
  L.restrict_mode = R_NONE;
  L.ty = ty;
  L.tx = tx;
  L.halo = leg3_stages(L);
  L.h2 = h2;
  L.w = w;
  L.inv_h2 = inv_h2;
  for (int s = 0; s < shards; ++s) {
    a.u[s] = (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.tmp[s] = (float*)tmp_ptrs[s];
  }
  const int max_tiles = ring_plans3(L, a.W, czs, a.cz, a.part0);
  if (max_tiles < 0) return (int)cudaErrorInvalidValue;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.max_sweeps = max_sweeps;
  a.tag0 = tag0;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)mgk::launch_ring(rdma_trigger3_kernel, a, leg3_smem(leg3_stages(L), L.halo, ty, tx),
                               shards, max_tiles, (cudaStream_t)stream,
                               dim3(BLOCK_X, BLOCK3_Y));
}
