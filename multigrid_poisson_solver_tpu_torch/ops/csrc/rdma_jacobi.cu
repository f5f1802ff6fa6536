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
// one launch and units that read no neighbour's rows do not wait for them.
//
// Design: one persistent cooperative launch spans the ring, each shard on
// its own slice of blocks (rdma.cuh). A shard's blocks first post the edge
// rows of u and f (u not with from_zero: the closed-form first sweep never
// reads it) into its neighbours' receive buffers of the launch's parity and
// release a tag on their flags; the last of its blocks to finish posting
// does the release. Then each shard is smoothed by one of two routes:
//  * the wavefront (rdma_jacobi_wave_kernel, from RING_WAVE_CELLS cells a
//    launch): kernel 17's pass (rdma.cuh's ring_pass, wave2.cuh's RING
//    stage) with K = steps − from_zero levels, no error, over the shard's
//    block: a warp streams one 128-column strip down a chunk of tile rows,
//    the K rows beyond the block from the receive buffers by 16-byte
//    cp.async.cg. Before a warp's first unit that reads a neighbour's
//    receive buffer, its lane 0 spins on that neighbour's flag.
//    The grids are read and written once; no tile recomputes a halo;
//  * the tile pipeline (rdma_jacobi_kernel, below the threshold, where a
//    shard's few tile rows leave a wavefront latency-bound): the smoother's
//    tile code (jacobi_tile, legs.cuh) over the ring source, interior tile
//    rows first; the boundary rows wait on the neighbours' flags and read
//    their halo from the receive buffers.
// The owned cells are those of the unsharded kernel and of the exchange
// path, bit for bit, on either route.
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
  int chunk_rows[MAX_SHARDS];  // the wavefront's chunk of each shard
  int shards, n, n_sweeps, hr, from_zero, blocks_per_shard;
  int even_only;               // 0: ring_pass's error arguments (the pass forms none)
  unsigned long long tag;
  float h2, omega, zero_coef, inv_h2;
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

// Rows the wavefront route loads ahead: 4 at every K (wave2.cuh's rule loads
// 2 above two sweeps). A/B on an H100, 8 row shards: 8 sweeps at 4097² 0.373
// → 0.310 ms, 3 sweeps at 4097² and 2048² unchanged. At K = 8 the deeper
// rings make blocks of 2 warps, so a shard's resident warps cover chunks of
// 96 rows in one wave, where blocks of 4 left it chunks of 128.
constexpr int RING18_AHEAD = 4;

template <int K>
using RingJacobiShape = WaveShape<K, WV_NONE, false, WV_SMOOTH, true, RING18_AHEAD>;

template <int K>
static __global__ void __launch_bounds__(RingJacobiShape<K>::THREADS,
                                         RING_WARPS_PER_SM / RingJacobiShape<K>::WARPS)
rdma_jacobi_wave_kernel(RingJacobiArgs a) {
  using S = RingJacobiShape<K>;
  const int nb = a.blocks_per_shard, s = blockIdx.x / nb, lb = blockIdx.x % nb;
  const int P = a.shards, n = a.n;
  const int row0 = a.row0[s], rows = a.row0[s + 1] - row0, chunk_rows = a.chunk_rows[s];
  const int par = (int)(a.tag & 1);
  const Geo g(n, row0, 0, rows, n);
  if constexpr (S::H > 0) {   // K = 0, the closed form alone, reads no row beyond the block
    post_edges<S::THREADS>(a.halo, a.f[s], s, P, par, 1, rows, S::H, n, lb, nb);
    if (!a.from_zero) post_edges<S::THREADS>(a.halo, a.u[s], s, P, par, 0, rows, S::H, n, lb, nb);
    if (arrive_last(a.count + s, nb) && threadIdx.x == 0) {
      if (s > 0) release_tag(a.flags + (size_t)(s - 1) * P + s, a.tag);
      if (s + 1 < P) release_tag(a.flags + (size_t)(s + 1) * P + s, a.tag);
    }
  }

  WaveRing ring = {};
  ring.u_top = recv_buf(a.halo, s, par, 0, 0, n) + (size_t)RING_HALO * n;
  ring.u_bot = recv_buf(a.halo, s, par, 1, 0, n);
  ring.f_top = recv_buf(a.halo, s, par, 0, 1, n) + (size_t)RING_HALO * n;
  ring.f_bot = recv_buf(a.halo, s, par, 1, 1, n);
  ring.sweeps = K;
  const int tx_n = tiles_x(g), chunks = (rows + chunk_rows - 1) / chunk_rows;
  // a warp's units in wave2_pass's order (A/B on an H100, 8 row shards:
  // taking the units that read no receive buffer first was 1-3% slower);
  // before the warp's first unit that reads a neighbour's receive buffer,
  // its lane 0 waits for that neighbour's post: chunk 0 reads the top's, a
  // chunk from cb the bottom's (its rows, with the H halo rows and the D
  // rows loaded ahead, reach past the block)
  const int past = rows - S::H - S::D;
  const int cb = s + 1 < P ? (past < 0 ? 0 : past / chunk_rows) : chunks;
  bool top_ready = false, bot_ready = false;
  const auto unit = [&](int w) {
    if constexpr (S::H > 0) {
      const int ch = w / tx_n;
      const bool top = s > 0 && ch == 0 && !top_ready, bot = ch >= cb && !bot_ready;
      if (top || bot) {
        if ((threadIdx.x & 31) == 0) {
          if (top) spin_until(a.flags + (size_t)s * P + (s - 1), a.tag);
          if (bot) spin_until(a.flags + (size_t)s * P + (s + 1), a.tag);
        }
        __syncwarp();   // the lanes read what the neighbour posted before its release
        top_ready |= top;
        bot_ready |= bot;
      }
    }
    return w;
  };
  ring_pass<K, WV_NONE, false, RING18_AHEAD>(a, ring, unit, s, g, S::H, S::WARPS, tx_n * chunks,
                                             chunk_rows, 0, nullptr, a.u[s], a.out[s],
                                             a.from_zero, a.zero_coef);
}

// Cells a launch from which the wavefront route runs (below: the tile
// pipeline); measured on both routes at 4097², 2049², 1025² and 513² on 8
// row shards (examples/torch_kernel_ab.py, PERF.md).
constexpr long long RING_WAVE_CELLS = 1500000;

// The route of every later launch: 0 the size rule, 1 the tile pipeline, 2
// the wavefront (mg_rdma_jacobi_force_route).
static int forced_route = 0;

extern "C" int mg_rdma_jacobi_force_route(int route) {
  if (route < 0 || route > 2) return (int)cudaErrorInvalidValue;
  forced_route = route;
  return 0;
}

// Whether a launch over an n x n level takes the wavefront route.
static bool ring_takes_wave(int n) {
  return forced_route ? forced_route == 2 : (long long)n * n >= RING_WAVE_CELLS;
}

template <int K = 0>
static cudaError_t launch_wave_k(RingJacobiArgs& a, const int* row0s, cudaStream_t stream) {
  if constexpr (K > MAX_STEPS) {
    return cudaErrorInvalidValue;
  } else {
    if (a.n_sweeps == K)
      return launch_ring_wave<RingJacobiShape<K>>(rdma_jacobi_wave_kernel<K>, a, row0s, stream);
    return launch_wave_k<K + 1>(a, row0s, stream);
  }
}

// steps <= MAX_STEPS sweeps (the first the closed form from u ≡ 0 with
// from_zero) of each shard's block u_ptrs[s] (rows row0s[s]..row0s[s + 1] of
// the n x n level, each at least steps rows) into out_ptrs[s]. halo, flags
// and count are the ring workspace of `shards` shards (ops/rdma.py); tag is
// above every tag the workspace has seen. The wavefront route copies rows of
// u and f in 16-byte chunks: a launch whose blocks do not all start 16-byte
// aligned takes the tile route, or fails (cudaErrorMisalignedAddress) where
// the wavefront is forced.
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
  bool aligned = true;
  for (int s = 0; s < shards; ++s) {
    if (row0s[s + 1] - row0s[s] < steps) return (int)cudaErrorInvalidValue;
    a.u[s] = (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.row0[s] = row0s[s];
    aligned = aligned && !misaligned(a.u[s], a.f[s]);
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (ring_takes_wave(n)) {
    if (aligned) return (int)launch_wave_k(a, row0s, st);
    if (forced_route == 2) return (int)cudaErrorMisalignedAddress;
  }
  return (int)launch_ring(rdma_jacobi_kernel, a, tile_smem_bytes(a.hr), shards, max_tiles, st);
}
