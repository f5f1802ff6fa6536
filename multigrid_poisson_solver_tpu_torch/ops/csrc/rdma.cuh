// Shared pieces of the 2-D ring kernels (rdma_jacobi.cu, rdma_trigger.cu):
// one launch runs every shard of a row-sharded level, with the tag, flag and
// launch protocol of ring.cuh. The ring source (Ring) and the tile-row tests
// are rdma_jacobi.cu's tile route, whose tiles are legs.cuh's; the wavefront
// passes (rdma_trigger.cu's, and rdma_jacobi.cu's wavefront route) read the
// receive buffers through wave2.cuh's WaveRing (ring_pass, launch_ring_wave
// below).
//
// What a shard owns in the workspace (ops/rdma.py allocates it once per
// device, shard count and width, zeroed):
//   * receive buffers: per parity, per side (0: from the shard above, 1: from
//     the shard below) and per array (0: u, 1: f), RING_HALO rows of width n;
//   * error slots: per parity and per sender, the raw error partials of up
//     to MAX_STEPS sweeps (rdma_trigger.cu's pass);
//   * flags: one 64-bit tag per sender, the last post that sender made here;
//   * arrival counts of its own blocks (two: rdma_trigger.cu's first post
//     and its passes).
// Receive buffers and error slots alternate by parity, so a sender one post
// ahead writes the other half; it cannot be two ahead, since its next sweep
// needs this shard's own post, which comes after this shard's reads.
#pragma once

#include "legs.cuh"
#include "ring.cuh"
#include "wave2.cuh"

namespace mgk {

constexpr int MAX_SHARDS = 16;
constexpr int RING_HALO = MAX_STEPS;  // rows a receive buffer holds

// The ring neighbours' rows around a shard's block: its own block, then the
// last rows of the shard above and the first rows of the shard below (hr of
// each, hr <= RING_HALO, from a receive buffer). Rows outside the grid are
// never read (row_of clips to the grid).
struct Ring {
  Win own, top, bot;
};

// The window of the ring that holds global row gi (load_tile's source).
static __device__ __forceinline__ RowRef row_of(const Ring& r, int gi, int n) {
  const Win& w = gi < r.own.r0 ? r.top : (gi < r.own.r0 + r.own.rows ? r.own : r.bot);
  return row_of(w, gi, n);
}

// Receive buffer of shard s: parity par, side (0 top, 1 bottom), array (0 u,
// 1 f); RING_HALO x n floats.
static __host__ __device__ __forceinline__ float* recv_buf(float* base, int s, int par, int side,
                                                           int arr, int n) {
  return base + ((((size_t)s * 2 + par) * 2 + side) * 2 + arr) * RING_HALO * n;
}

// The ring source of shard s's array arr: its block `own` (rows x n at row0)
// and the hr rows next to it in its receive buffers of parity par.
static __device__ __forceinline__ Ring ring_source(const float* own, float* halo, int s,
                                                   int par, int arr, int row0, int rows, int hr,
                                                   int n) {
  Ring r;
  r.own = {own, row0, 0, rows, n};
  r.top = {recv_buf(halo, s, par, 0, arr, n) + (size_t)(RING_HALO - hr) * n, row0 - hr, 0, hr, n};
  r.bot = {recv_buf(halo, s, par, 1, arr, n), row0 + rows, 0, hr, n};
  return r;
}

// Copy cnt x n floats from src to dst, the work split over nb blocks of T
// threads.
template <int T = THREADS>
static __device__ void copy_rows(float* __restrict__ dst, const float* src, int cnt, int n, int lb,
                                 int nb) {
  const size_t total = (size_t)cnt * n;
  for (size_t i = (size_t)lb * T + threadIdx.y * BLOCK_X + threadIdx.x; i < total;
       i += (size_t)nb * T)
    dst[i] = __ldcg(src + i);
}

// Post shard s's edge rows of `src` (rows x n) to its neighbours' receive
// buffers of parity par: its first hr rows to the shard above (side 1), its
// last hr rows to the shard below (side 0). Split over the nb blocks.
template <int T = THREADS>
static __device__ void post_edges(float* halo, const float* src, int s, int shards, int par,
                                  int arr, int rows, int hr, int n, int lb, int nb) {
  if (s > 0) copy_rows<T>(recv_buf(halo, s - 1, par, 1, arr, n), src, hr, n, lb, nb);
  if (s + 1 < shards)
    copy_rows<T>(recv_buf(halo, s + 1, par, 0, arr, n) + (size_t)(RING_HALO - hr) * n,
                 src + (size_t)(rows - hr) * n, hr, n, lb, nb);
}

// Whether tile row ty of a shard (rows rows, tiles staged with `halo`) reads
// the shard above (side 0) or below (side 1).
static __device__ __forceinline__ bool reads_top(int s, int ty, int halo) {
  return s > 0 && ty == 0 && halo > 0;
}

static __device__ __forceinline__ bool reads_bot(int s, int shards, int ty, int rows, int halo) {
  return s + 1 < shards && (ty + 1) * TILE_H + halo > rows;
}

// Warps an SM keeps resident in the ring's wavefront passes (launch bounds):
// the passes are latency-bound (a warp's row steps wait on its copies), and
// left to itself the compiler gives kernel 17's 7- and 8-sweep passes
// 209-224 registers, 8 warps an SM.
constexpr int RING_WARPS_PER_SM = 12;

// One wavefront pass (wave2.cuh, RING) of ring.sweeps <= K sweeps over the
// units of shard s's block g (halo rows a side from the receive buffers,
// whose pointers ring holds) that this block's `warps` warps own: src into
// dst, error kind E of every level (ALL) or of the last, its tile partials
// `stride` a level, AHEAD rows loaded ahead (0: wave2.cuh's rule). Args: the
// ring kernel's arguments (f, blocks_per_shard, even_only, h2, omega,
// inv_h2). The warp's i-th unit in turn is unit(i) (its strip and chunk,
// wave2_pass's numbering); unit may wait there for what that unit reads.
template <int K, int E, bool ALL, int AHEAD = 0, class Args, class Unit>
static __device__ __forceinline__ void ring_pass(const Args& a, WaveRing& ring, Unit unit, int s,
                                                 const Geo& g, int halo, int warps, int units,
                                                 int chunk_rows, int stride, float* part,
                                                 const float* src, float* dst, int from_zero,
                                                 float zero_coef) {
  const int lb = blockIdx.x % a.blocks_per_shard;
  for (int w = lb * warps + (threadIdx.x >> 5); w < units; w += a.blocks_per_shard * warps) {
    ring.unit = unit(w);
    __syncwarp();   // every lane is done with the previous unit's rings
    wave2_pass<true, K, E, ALL, WV_SMOOTH, true, AHEAD>(src, a.f[s], dst, part, g, halo, 0,
                                                        chunk_rows, stride, from_zero,
                                                        a.even_only, a.h2, a.omega, a.inv_h2,
                                                        zero_coef, WaveLeg{}, ring);
  }
}

// Launch a ring kernel of wavefront passes of shape S (WaveShape): each
// shard's chunk rows (args.chunk_rows) sized by wave2_rows for the warps a
// shard keeps resident at S's occupancy, then launch_ring with a block per
// S::WARPS units of the shard that has the most. Args: args.shards, args.n,
// args.chunk_rows[]; row0s the shards' first rows and n.
template <class S, typename Args>
static cudaError_t launch_ring_wave(void (*kernel)(Args), Args& a, const int* row0s,
                                   cudaStream_t stream) {
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  static_assert(S::H <= RING_HALO, "a receive buffer holds a pass's halo rows");
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::THREADS,
                                                         S::SMEM)) != cudaSuccess)
    return e;
  // the chunks of each shard for the warps a shard keeps resident
  const int resident = per_sm * sms / a.shards * S::WARPS;
  int units = 0;
  for (int s = 0; s < a.shards; ++s) {
    const Geo g(a.n, row0s[s], 0, row0s[s + 1] - row0s[s], a.n);
    a.chunk_rows[s] = wave2_rows(g, resident > 0 ? resident : 1, S::H);
    const int u = tiles_x(g) * ((g.rows + a.chunk_rows[s] - 1) / a.chunk_rows[s]);
    units = u > units ? u : units;
  }
  return launch_ring(kernel, a, S::SMEM, a.shards, (units + S::WARPS - 1) / S::WARPS, stream,
                     dim3(S::THREADS));
}

}  // namespace mgk
