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
// each shard on its own slice of 128-thread blocks (ring.cuh, rdma3.cuh);
// shards meet only through their own buffers and flags. A sweep is one
// column pass of col3.cuh per shard over its owned planes (a thread streams
// one (y, x) column down z, no barrier inside the pass), so it writes only
// owned planes and reads one halo plane of u a side and no halo of f. The
// pass reads a plane from the shard's block or, beyond it, from its receive
// buffer of that parity (Col3Ring), and the thread that writes an owned
// boundary plane also writes it into the neighbour's receive slot of the
// next parity. Before the loop each shard posts u_0's boundary planes.
// With the clean metric the error of u_k comes from the pass that makes
// u_{k+1} (the same stencil read, as in trigger3.cu), so the stop test on
// u_k follows that pass and u_k is still intact in the ping-pong partner;
// a loop that reaches max_sweeps ends with one pass that only reads. The
// partials are col3.cuh's, four blocks to a tile of the shard's plan
// (err_plan3 of its depth), the tile's last block adding them in
// block_sum3's order. The last block of a shard to finish the pass sums the
// shard's tile partials in fixed_sum3's order, posts the raw float64 sum to
// every shard's error slot and releases the pass's tag on each shard's flag
// for it. Every block then waits for the tags of all shards, adds the raw
// sums in shard order and scales once, so every block of every shard reaches
// the same error and the same stop decision; that all-to-all is also the
// barrier between passes, after which every halo plane of the new iterate
// is in place. The iterates, the stop sweep and the error are those of the
// loop of one-sweep shard-mode error launches whose raw sums are added in
// shard order (parallel/kernel_shard3.py's sharded_trigger_step3), bit for
// bit.
#include "col3.cuh"
#include "rdma3.cuh"

using namespace mgk3;

// A shard's planes for a pass: the iterate read from its block [z0, z1) and
// beyond it from the receive buffers (top holds [z0 − RING3_HALO, z0), bot
// [z1, z1 + RING3_HALO)); f from its block (the halo planes' f is loaded by
// the walk's look-ahead but never used, so it reads the nearest owned
// plane); the iterate written into dst, plane z0 also into `above` (the
// upper neighbour's bot buffer, slot 0) and plane z1 − 1 into `below` (the
// lower neighbour's top buffer, slot RING3_HALO − 1).
struct Col3Ring {
  const float* u;
  const float* top;
  const float* bot;
  const float* f;
  float* dst;
  float* above;
  float* below;
  int z0, z1;
  __device__ __forceinline__ const float* up(int z, size_t pl) const {
    if (z < z0) return top + (z - z0 + RING3_HALO) * pl;
    if (z < z1) return u + (z - z0) * pl;
    return bot + (z - z1) * pl;
  }
  __device__ __forceinline__ const float* fp(int z, size_t pl) const {
    return f + (min(max(z, z0), z1 - 1) - z0) * pl;
  }
  __device__ __forceinline__ bool writes() const { return dst != nullptr; }
  __device__ __forceinline__ void put(const Col3&, int z, size_t pl, size_t col, float v) const {
    dst[(z - z0) * pl + col] = v;
    if (z == z0 && above != nullptr) above[col] = v;
    if (z == z1 - 1 && below != nullptr) below[col] = v;
  }
};

struct RingTrigger3Args {
  Ring3 W;
  Col3 C[MAX_SHARDS3];             // shard s's planes, f, tile plan and workspace
  const float* u[MAX_SHARDS3];     // starting iterate, shard blocks (read only)
  float* out[MAX_SHARDS3];         // final iterate
  float* tmp[MAX_SHARDS3];         // ping-pong partner of out
  int part0[MAX_SHARDS3 + 1];      // shard s's tile partials from part0[s]
  double* partials;
  float* err_out;                  // the final iterate's error
  int* sweeps_out;                 // sweeps run
  int err_mode, max_sweeps, blocks_per_shard;
  unsigned long long tag0;         // tag of the first post; pass j posts tag0 + j + 1
  double err_scale;                // Σ|r| (or Σ|Δu|) to the metric
  float trigger;
};

static __global__ void __launch_bounds__(COL3_THREADS, 6)
rdma_trigger3_kernel(RingTrigger3Args a) {
  __shared__ float err_now;
  const int nb = a.blocks_per_shard, s = blockIdx.x / nb, lb = blockIdx.x % nb;
  const Ring3& W = a.W;
  const Col3& C = a.C[s];
  const int P = W.shards, z0 = W.z0[s], z1 = W.z0[s + 1];
  const size_t pl = plane3(W.n);
  const int count = col3_tiles(C), units = col3_units(C), clean = a.err_mode == ERR_CLEAN;
  double* const part = a.partials + a.part0[s];
  const bool lead = threadIdx.x == 0;

  // u_0's planes that the neighbours' one-plane windows take (parity 0); the
  // first post has a count of its own: a block that arrives here and runs
  // on to the end of pass 0 must not be counted in this round
  for (int r = 0; r < P; ++r)
    if (r != s)
      for (int side = 0; side < 2; ++side)
        post_span(ubuf3(W, r, 0, side), side == 0 ? W.z0[r] - RING3_HALO : W.z0[r + 1],
                  a.u[s], z0, z1, fine_window(W, r, side, 1), pl, lb, nb);
  __threadfence();
  if (mgk::arrive_last(W.count + s, nb) && lead)
    for (int r = 0; r < P; ++r)
      if (r != s) mgk::release_tag(W.flags + (size_t)r * P + s, a.tag0);
  wait_senders(W, s, 1, false, a.tag0);

  // iterate k >= 1 lives in out for odd k, in tmp for even k
  auto buf = [&](int k) -> float* { return (k & 1) ? a.out[s] : a.tmp[s]; };
  float err = 0.0f;
  int k = 0;
  for (int j = 0;; ++j) {
    // pass j makes iterate j + 1 from iterate j (none after the last with the
    // clean error) and measures iterate k: j (clean, from j = 1) or j + 1
    // (gpu); iterate j's halo planes sit in the parity j & 1 buffers, the
    // new iterate's go to the other parity
    k = clean ? j : j + 1;
    const bool writes = !(clean && j == a.max_sweeps);
    const int rpar = j & 1, wpar = rpar ^ 1;
    const Col3Ring io{j == 0 ? a.u[s] : buf(j),
                      ubuf3(W, s, rpar, 0),
                      ubuf3(W, s, rpar, 1),
                      C.f,
                      writes ? buf(j + 1) : nullptr,
                      writes && s > 0 ? ubuf3(W, s - 1, wpar, 1) : nullptr,
                      writes && s + 1 < P ? ubuf3(W, s + 1, wpar, 0) + (RING3_HALO - 1) * pl
                                          : nullptr,
                      z0,
                      z1};
    const Col3Pass pass{nullptr, nullptr, nullptr, k >= 1 ? part : nullptr,
                        k >= 1 ? a.err_mode : ERR_NONE, z0, z1};
    for (int t = lb; t < units; t += nb) col3_unit_io<true, true>(C, pass, t, io);
    __threadfence();
    // iterate j + 1, its posts and the shard's tile partials are complete
    // once every block of the shard has arrived; the last one sums and posts
    // the raw sum. A block arrives at pass j + 1 only after this round's post
    // (the all-to-all below), so one count serves every pass.
    const unsigned long long tag = a.tag0 + j + 1;
    if (mgk::arrive_last(W.count + P + s, nb)) {
      const double raw = k >= 1 ? col3_fixed_sum(part, count) : 0.0;
      if (lead) {
        for (int d = 0; d < P; ++d) W.err[((size_t)d * 2 + rpar) * P + s] = raw;
        for (int d = 0; d < P; ++d) mgk::release_tag(W.flags + (size_t)d * P + s, tag);
      }
    }
    // every shard's raw sum of iterate k, added in shard order
    if (lead) {
      double total = 0.0;
      for (int d = 0; d < P; ++d) {
        mgk::spin_until(W.flags + (size_t)s * P + d, tag);
        const double p = __ldcg(W.err + ((size_t)s * 2 + rpar) * P + d);
        total = d == 0 ? p : __dadd_rn(total, p);
      }
      err_now = scaled_error3(total, a.err_scale);
    }
    __syncthreads();
    const float e = err_now;
    __syncthreads();  // every thread has read err_now before it is rewritten
    if (k < 1) continue;
    // the slope test starts at sweep 2 (solver.trigger_loop)
    const bool above = k == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
    err = e;
    if (!(above && k < a.max_sweeps)) break;
  }
  if (buf(k) != a.out[s])  // the final iterate is in tmp
    copy_floats(a.out[s], buf(k), (size_t)(z1 - z0) * pl, lb, nb);
  if (blockIdx.x == 0 && lead) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// The trigger loop on the shard blocks u_ptrs[s] (planes z0s[s]..z0s[s + 1]
// of the n^3 level; not written) into out_ptrs[s], with tmp_ptrs[s] scratch
// blocks of the same shapes; err_mode ERR_CLEAN or ERR_GPU; (ty, tx) and
// czs[s] each shard's tile plan (err_plan3 of its depth, at most THREADS3
// cells a tile); partials one double per tile of every shard, work the
// column pass's workspace for all of them (ops.kernels3.col3_work of the
// total); err_scale the metric's scale. ws is the ring workspace of
// ops/rdma3.py; tags tag0 .. tag0 + max_sweeps + 1 are above every tag it
// has seen.
extern "C" int mg3_rdma_trigger(const unsigned long long* u_ptrs,
                                const unsigned long long* f_ptrs,
                                const unsigned long long* out_ptrs,
                                const unsigned long long* tmp_ptrs, const int* z0s,
                                const int* czs, int shards, int n, int err_mode, int ty, int tx,
                                double* partials, double* work, float* err_out, int* sweeps_out,
                                const unsigned long long* ws, unsigned long long tag0, float h2,
                                float w, float inv_h2, double err_scale, float trigger,
                                int max_sweeps, void* stream) {
  if ((err_mode != ERR_CLEAN && err_mode != ERR_GPU) || max_sweeps < 1 || partials == nullptr ||
      work == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  RingTrigger3Args a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  // each shard's planes with a window of one plane a side (its receive
  // buffers), its plan and its share of the workspace
  int total = 0, max_units = 0;
  for (int s = 0; s < shards; ++s) {
    Col3& C = a.C[s];
    C = Col3{(const float*)f_ptrs[s], nullptr, nullptr, n, z0s[s], z0s[s + 1] - z0s[s], 1, ty,
             tx, czs[s], h2, w, inv_h2};
    if (!col3_ok(C, 1)) return (int)cudaErrorInvalidValue;
    a.part0[s] = total;
    total += col3_tiles(C);
    max_units = max(max_units, col3_units(C));
    a.u[s] = (const float*)u_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.tmp[s] = (float*)tmp_ptrs[s];
  }
  a.part0[shards] = total;
  unsigned* const arrivals = reinterpret_cast<unsigned*>(work + (size_t)total * WARPS3);
  for (int s = 0; s < shards; ++s) {
    a.C[s].wsum = work + (size_t)a.part0[s] * WARPS3;
    a.C[s].arrivals = arrivals + a.part0[s];
  }
  if ((e = cudaMemsetAsync(arrivals, 0, sizeof(unsigned) * total, st)) != cudaSuccess)
    return (int)e;
  a.partials = partials;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.err_mode = err_mode;
  a.max_sweeps = max_sweeps;
  a.tag0 = tag0;
  a.err_scale = err_scale;
  a.trigger = trigger;
  return (int)mgk::launch_ring(rdma_trigger3_kernel, a, 0, shards, max_units, st,
                               dim3(COL3_THREADS));
}
