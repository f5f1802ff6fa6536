// The protocol every ring kernel shares (the 2-D ones through rdma.cuh, the
// 3-D ones through rdma3.cuh): one launch runs every shard of a sharded
// level, each shard on its own slice of a persistent cooperative grid, and
// the shards talk only through buffers and flags that belong to a shard.
//
// A sender writes a receiver's buffers and then release-stores its tag into
// the receiver's flag for it (flags are 64-bit, [receiver][sender]); the
// receiver acquire-spins until the flag reaches the tag it expects and then
// reads the buffers through L2 (__ldcg). Tags only grow: every post carries
// the launch's base tag plus the sweep, and the next launch starts above the
// last tag the previous one could use, so a flag left by an earlier post
// never passes a wait and flags are never reset. This is what would cross a
// peer link, so the same device code serves one launch per GPU.
//
// Every block of the launch must be resident at once: a block that needs a
// neighbour's data spins on a flag, and spinning on a peer that was never
// scheduled would hang. launch_ring sizes the grid from the occupancy and
// launches it cooperatively, which fails instead of hanging when the blocks
// cannot all be resident; every block posts before it waits. A wait that
// spins 20 s traps, so a lost post fails the launch instead of hanging the
// card. Nothing here uses a grid-wide barrier.
#pragma once

#include "common.cuh"

namespace mgk {

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

// Launch a ring kernel: blocks_per_shard blocks of shape `block` for each of
// `shards` shards (the occupancy at `smem` bytes, shared out, at most `tiles`
// a shard), set in args before the cooperative launch.
template <typename Args>
static cudaError_t launch_ring(void (*kernel)(Args), Args& args, size_t smem, int shards,
                               int tiles, cudaStream_t stream,
                               dim3 block = dim3(BLOCK_X, BLOCK_Y)) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, (int)(block.x * block.y), smem)) != cudaSuccess)
    return e;
  const int per_shard = per_sm * sms / shards < tiles ? per_sm * sms / shards : tiles;
  if (per_shard < 1) return cudaErrorCooperativeLaunchTooLarge;
  args.blocks_per_shard = per_shard;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_shard * shards), block, params,
                                  smem, stream);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace mgk
