// One fused pass of k <= 8 damped-Jacobi sweeps over every shard of a
// row-sharded level, the halo exchange done inside the kernel.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma.py,
// _rdma_jacobi_kernel, reached through parallel/pallas_shard.py's
// rdma_fused_jacobi (the engine's sharded sweeps with halo="rdma").
//
// Bound: device-memory bandwidth, as jacobi.cu: a pass reads u and f and
// writes u, 12 B per point, plus the halo rows. The exchange path
// (sharded_fused_jacobi) first copies each shard's halo-extended block, which
// costs another read and write of both grids and a launch per shard, and
// serialises the copy in front of the sweeps; here the halos move inside the
// one launch and interior tiles do not wait for them. Design: one persistent
// cooperative launch spans the ring, each shard on its own slice of blocks
// (rdma.cuh). A shard's blocks first post its edge rows of u and f (f only
// with from_zero: the closed-form first sweep never reads u) into its
// neighbours' receive buffers and release a tag on their flags; the last
// of its blocks to finish posting does the release. Then they smooth the
// shard's tiles with the smoother's tile code (jacobi_tile, legs.cuh),
// interior tile rows first; the boundary rows wait on the neighbours' flags
// and read their halo from the receive buffers. The owned cells are those
// of the unsharded kernel and of the exchange path, bit for bit.
#include "rdma.cuh"

using namespace mgk;

struct RingJacobiArgs {
  const float* u[MAX_SHARDS];  // shard blocks, rows x n (unread when from_zero)
  const float* f[MAX_SHARDS];
  float* out[MAX_SHARDS];
  float* halo;                 // receive buffers (rdma.cuh)
  unsigned long long* flags;   // [receiver][sender]
  unsigned int* count;         // [shard]
  int row0[MAX_SHARDS + 1];    // shard s owns rows [row0[s], row0[s + 1])
  int shards, n, n_sweeps, hr, from_zero, blocks_per_shard;
  unsigned long long tag;
  float h2, omega, zero_coef;
};

static __global__ void __launch_bounds__(THREADS) rdma_jacobi_kernel(RingJacobiArgs a) {
  extern __shared__ float smem[];
  const int s = blockIdx.x / a.blocks_per_shard, lb = blockIdx.x % a.blocks_per_shard;
  const int nb = a.blocks_per_shard, P = a.shards, n = a.n;
  const int row0 = a.row0[s], rows = a.row0[s + 1] - row0;
  const int par = (int)(a.tag & 1);
  const Geo g(n, row0, 0, rows, n);

  post_edges(a.halo, a.f[s], s, P, par, 1, rows, a.hr, n, lb, nb);
  if (!a.from_zero) post_edges(a.halo, a.u[s], s, P, par, 0, rows, a.hr, n, lb, nb);
  if (arrive_last(a.count + s, nb) && threadIdx.x == 0 && threadIdx.y == 0) {
    if (s > 0) release_tag(a.flags + (size_t)(s - 1) * P + s, a.tag);
    if (s + 1 < P) release_tag(a.flags + (size_t)(s + 1) * P + s, a.tag);
  }

  const Ring u = ring_source(a.u[s], a.halo, s, par, 0, row0, rows, a.hr, n);
  const Ring f = ring_source(a.f[s], a.halo, s, par, 1, row0, rows, a.hr, n);
  const int tx = tiles_x(g), count = num_tiles(g);
  bool top_ready = false, bot_ready = false;
  for (int pass = 0; pass < 2; ++pass) {  // interior tile rows, then boundary ones
    for (int t = lb; t < count; t += nb) {
      const int ty = t / tx;
      const bool top = reads_top(s, ty, a.hr), bot = reads_bot(s, P, ty, rows, a.hr);
      if ((top || bot) != (pass == 1)) continue;
      if (top && !top_ready) {
        wait_tag(a.flags + (size_t)s * P + (s - 1), a.tag);
        top_ready = true;
      }
      if (bot && !bot_ready) {
        wait_tag(a.flags + (size_t)s * P + (s + 1), a.tag);
        bot_ready = true;
      }
      jacobi_tile(smem, u, f, a.out[s], nullptr, t % tx, ty, g, a.n_sweeps, a.hr, a.from_zero,
                  ERR_NONE, a.h2, a.omega, 0.0f, a.zero_coef);
    }
  }
}

// steps <= MAX_STEPS sweeps (the first the closed form from u ≡ 0 with
// from_zero) of each shard's block u_ptrs[s] (rows row0s[s]..row0s[s + 1] of
// the n x n level, each at least steps rows) into out_ptrs[s]. halo, flags
// and count are the ring workspace of `shards` shards (ops/rdma.py); tag is
// above every tag the workspace has seen.
extern "C" int mg_rdma_jacobi(const unsigned long long* u_ptrs,
                              const unsigned long long* f_ptrs,
                              const unsigned long long* out_ptrs, const int* row0s, int shards,
                              int n, int steps, int from_zero, float* halo,
                              unsigned long long* flags, unsigned int* count,
                              unsigned long long tag, float h2, float omega, float zero_coef,
                              void* stream) {
  if (shards < 1 || shards > MAX_SHARDS || steps < 1 || steps > MAX_STEPS || n < 3 ||
      row0s[0] != 0 || row0s[shards] != n)
    return (int)cudaErrorInvalidValue;
  RingJacobiArgs a = {};
  int max_tiles = 0;
  for (int s = 0; s < shards; ++s) {
    if (row0s[s + 1] - row0s[s] < steps) return (int)cudaErrorInvalidValue;
    a.u[s] = (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.row0[s] = row0s[s];
    const int t = num_tiles(Geo(n, row0s[s], 0, row0s[s + 1] - row0s[s], n));
    max_tiles = t > max_tiles ? t : max_tiles;
  }
  a.row0[shards] = n;
  a.shards = shards;
  a.n = n;
  a.n_sweeps = steps - (from_zero ? 1 : 0);
  a.hr = jacobi_halo(a.n_sweeps, ERR_NONE);
  a.from_zero = from_zero;
  a.halo = halo;
  a.flags = flags;
  a.count = count;
  a.tag = tag;
  a.h2 = h2;
  a.omega = omega;
  a.zero_coef = zero_coef;
  return (int)launch_ring(rdma_jacobi_kernel, a, tile_smem_bytes(a.hr), shards, max_tiles,
                          (cudaStream_t)stream);
}
