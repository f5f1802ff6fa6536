// Shared pieces of the 2-D ring kernels (rdma_jacobi.cu, rdma_trigger.cu):
// one launch runs every shard of a row-sharded level, with the tag, flag and
// launch protocol of ring.cuh.
//
// What a shard owns in the workspace (ops/rdma.py allocates it once per
// device, shard count and width, zeroed):
//   * receive buffers: per parity, per side (0: from the shard above, 1: from
//     the shard below) and per array (0: u, 1: f), RING_HALO rows of width n;
//   * error slots: per parity and per sender, one raw error partial;
//   * flags: one 64-bit tag per sender, the last post that sender made here;
//   * arrival counts of its own blocks (two: rdma_trigger.cu's first post
//     and its sweeps).
// Receive buffers and error slots alternate by parity, so a sender one post
// ahead writes the other half; it cannot be two ahead, since its next sweep
// needs this shard's own post, which comes after this shard's reads.
#pragma once

#include "legs.cuh"
#include "ring.cuh"

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

// Copy cnt x n floats from src to dst, the work split over nb blocks.
static __device__ void copy_rows(float* __restrict__ dst, const float* src, int cnt, int n, int lb,
                                 int nb) {
  const size_t total = (size_t)cnt * n;
  for (size_t i = (size_t)lb * THREADS + threadIdx.y * BLOCK_X + threadIdx.x; i < total;
       i += (size_t)nb * THREADS)
    dst[i] = __ldcg(src + i);
}

// Post shard s's edge rows of `src` (rows x n) to its neighbours' receive
// buffers of parity par: its first hr rows to the shard above (side 1), its
// last hr rows to the shard below (side 0). Split over the nb blocks.
static __device__ void post_edges(float* halo, const float* src, int s, int shards, int par,
                                  int arr, int rows, int hr, int n, int lb, int nb) {
  if (s > 0) copy_rows(recv_buf(halo, s - 1, par, 1, arr, n), src, hr, n, lb, nb);
  if (s + 1 < shards)
    copy_rows(recv_buf(halo, s + 1, par, 0, arr, n) + (size_t)(RING_HALO - hr) * n,
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

}  // namespace mgk
