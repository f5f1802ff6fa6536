// Shared pieces of the ring kernels (rdma_jacobi.cu, rdma_trigger.cu): one
// launch runs every shard of a row-sharded level, each shard on its own
// slice of a persistent cooperative grid, and the shards talk only through
// buffers and flags that belong to a shard.
//
// What a shard owns in the workspace (ops/rdma.py allocates it once per
// device, shard count and width, zeroed):
//   * receive buffers: per parity, per side (0: from the shard above, 1: from
//     the shard below) and per array (0: u, 1: f), RING_HALO rows of width n;
//   * error slots: per parity and per sender, one raw error partial;
//   * flags: one 64-bit tag per sender, the last post that sender made here;
//   * arrival counts of its own blocks (two: rdma_trigger.cu's first post
//     and its sweeps).
// A sender writes a receiver's buffers and then release-stores its tag into
// the receiver's flag for it; the receiver acquire-spins until the flag
// reaches the tag it expects and then reads the buffers through L2 (__ldcg).
// Tags only grow: every post carries the launch's base tag plus the sweep,
// and the next launch starts above the last tag the previous one could use,
// so a flag left by an earlier post never passes a wait. Receive buffers and
// error slots alternate by parity, so a sender one post ahead writes the
// other half; it cannot be two ahead, since its next sweep needs this
// shard's own post, which comes after this shard's reads. This is what would
// cross a peer link, so the same device code serves one launch per GPU.
//
// Every block of the launch must be resident at once: a boundary tile waits
// on a neighbour's flag, and spinning on a peer that was never scheduled
// would hang. launch_ring sizes the grid from the occupancy and launches it
// cooperatively, which fails instead of hanging when the blocks cannot all
// be resident. Nothing here uses a grid-wide barrier.
#pragma once

#include "legs.cuh"

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

static __device__ __forceinline__ void release_tag(unsigned long long* flag,
                                                   unsigned long long tag) {
  __threadfence();
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(flag), "l"(tag) : "memory");
}

static __device__ __forceinline__ unsigned long long acquire_tag(const unsigned long long* flag) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(flag) : "memory");
  return v;
}

static __device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag >= tag. A post that never comes is a bug, not a wait:
// after 20 s the kernel traps, so the launch fails instead of hanging the
// card.
static __device__ void spin_until(const unsigned long long* flag, unsigned long long tag) {
  const unsigned long long start = now_ns();
  while (acquire_tag(flag) < tag) {
    if (now_ns() - start > 20000000000ull) __trap();
    __nanosleep(64);
  }
}

// Thread (0, 0) waits for the tag; then the block reads what the sender
// wrote before its release.
static __device__ void wait_tag(const unsigned long long* flag, unsigned long long tag) {
  if (threadIdx.x == 0 && threadIdx.y == 0) spin_until(flag, tag);
  __syncthreads();
}

// This block's arrival among the nb blocks of a shard: true in every thread
// of the block that arrived last, which then knows every block's earlier
// writes are visible. The count is reset for the next arrival.
static __device__ bool arrive_last(unsigned int* count, int nb) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    __threadfence();
    last = atomicAdd(count, 1u) == (unsigned int)(nb - 1);
    if (last) {
      atomicExch(count, 0u);
      __threadfence();
    }
  }
  __syncthreads();
  return last;
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

// Launch a ring kernel: blocks_per_shard blocks for each of `shards` shards
// (the occupancy at `smem` bytes, shared out, at most `tiles` a shard), set
// in args before the cooperative launch.
template <typename Args>
static cudaError_t launch_ring(void (*kernel)(Args), Args& args, size_t smem, int shards,
                               int tiles, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return e;
  const int per_shard = per_sm * sms / shards < tiles ? per_sm * sms / shards : tiles;
  if (per_shard < 1) return cudaErrorCooperativeLaunchTooLarge;
  args.blocks_per_shard = per_shard;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_shard * shards),
                                  dim3(BLOCK_X, BLOCK_Y), params, smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mgk
