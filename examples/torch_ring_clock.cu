// A stamped copy of the tile-era ring trigger kernel (kernel 17 as
// csrc/rdma_trigger.cu held it up to 7ca9eae), to split its time a sweep
// into the tile sweep and the all-to-all tail. Built against that tree's
// headers (rdma.cuh, legs.cuh: nvcc -I <its csrc>) and driven by
// examples/torch_ring_clock.py.
//
// The kernel is the original but for three %globaltimer stamps a block and
// sweep, taken by thread 0: t0 as the sweep starts, t1 when the block has
// walked its tiles (before its arrival), t2 when it leaves the all-to-all
// with the sweep's error. stamps[(k · blocks + block) · 3 + i] for sweep k
// < stamp_sweeps.
#include "rdma.cuh"

using namespace mgk;

struct ClockArgs {
  const float* u[MAX_SHARDS];
  const float* f[MAX_SHARDS];
  float* out[MAX_SHARDS];
  float* tmp[MAX_SHARDS];
  float* partials;
  float* halo;
  float* err;
  unsigned long long* flags;
  unsigned int* count;
  float* err_out;
  int* sweeps_out;
  unsigned long long* stamps;
  int row0[MAX_SHARDS + 1];
  int part0[MAX_SHARDS + 1];
  int shards, n, hr, err_mode, max_sweeps, blocks_per_shard, stamp_sweeps;
  unsigned long long tag0;
  float h2, omega, inv_h2, err_scale, trigger;
};

static __device__ __forceinline__ void stamp(const ClockArgs& a, int k, int i) {
  if (threadIdx.x == 0 && threadIdx.y == 0 && k < a.stamp_sweeps)
    a.stamps[((size_t)k * gridDim.x + blockIdx.x) * 3 + i] = now_ns();
}

static __global__ void __launch_bounds__(THREADS) clock_trigger_kernel(ClockArgs a) {
  extern __shared__ float smem[];
  __shared__ float total_now;
  const int s = blockIdx.x / a.blocks_per_shard, lb = blockIdx.x % a.blocks_per_shard;
  const int nb = a.blocks_per_shard, P = a.shards, n = a.n;
  const int row0 = a.row0[s], rows = a.row0[s + 1] - row0;
  const Geo g(n, row0, 0, rows, n);
  const int tx = tiles_x(g), count = num_tiles(g);
  float* part = a.partials + a.part0[s];

  post_edges(a.halo, a.f[s], s, P, 1, 1, rows, a.hr, n, lb, nb);
  post_edges(a.halo, a.u[s], s, P, 0, 0, rows, a.hr, n, lb, nb);
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
    stamp(a, k, 0);
    const unsigned long long tag = a.tag0 + k;
    const Ring u = ring_source(cur, a.halo, s, k & 1, 0, row0, rows, a.hr, n);
    for (int pass = 0; pass < 2; ++pass) {
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
    __syncthreads();
    stamp(a, k, 1);
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
    __syncthreads();
    stamp(a, k, 2);
    ++k;
    const bool above = k == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
    err = e;
    cur = nxt;
    nxt = nxt == a.out[s] ? a.tmp[s] : a.out[s];
    if (!(above && k < a.max_sweeps)) break;
  }
  if (cur != a.out[s]) copy_rows(a.out[s], cur, rows, n, lb, nb);
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// mg_rdma_trigger's arguments, then the stamp buffer (stamp_sweeps · blocks ·
// 3 values, blocks as *blocks_out reports) and the sweeps to stamp.
extern "C" int clock_rdma_trigger(const unsigned long long* u_ptrs,
                                  const unsigned long long* f_ptrs,
                                  const unsigned long long* out_ptrs,
                                  const unsigned long long* tmp_ptrs, const int* row0s,
                                  int shards, int n, float* partials, float* halo, float* err,
                                  unsigned long long* flags, unsigned int* count, float* err_out,
                                  int* sweeps_out, int err_mode, float h2, float omega,
                                  float inv_h2, float err_scale, float trigger, int max_sweeps,
                                  unsigned long long tag0, unsigned long long* stamps,
                                  int stamp_sweeps, int* blocks_out, void* stream) {
  if (shards < 1 || shards > MAX_SHARDS || n < 3 || err_mode == ERR_NONE || max_sweeps < 1 ||
      row0s[0] != 0 || row0s[shards] != n)
    return (int)cudaErrorInvalidValue;
  ClockArgs a = {};
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
  a.stamps = stamps;
  a.stamp_sweeps = stamp_sweeps;
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
  const cudaError_t e = launch_ring(clock_trigger_kernel, a, tile_smem_bytes(a.hr), shards,
                                    max_tiles, (cudaStream_t)stream);
  *blocks_out = a.blocks_per_shard * shards;
  return (int)e;
}
