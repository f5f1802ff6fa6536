// The chains' two launches (chain_descend.cu, chain_ascend.cu): the wide
// levels as a persistent grid-wide pass over legs.cuh's tiles, and the small
// levels of the ladder (n <= the split size S) as one thread block cluster
// that holds every level whole in its shared memory.
//
// The tail. A cluster of TAIL_CTAS blocks of TAIL_THREADS threads. At a
// level of size n, block q owns the band of rows [band_lo(n, q),
// band_lo(n, q + 1)) of every level-sized array, stored row-major (stride n)
// in slots of its dynamic shared memory. A sweep reads the rows just above
// and below its band from the neighbours' slots through distributed shared
// memory (cluster.map_shared_rank); a cluster barrier before every sweep
// makes the previous iterate complete everywhere and frees the buffer the
// sweep overwrites. No halo is staged and no cell is computed twice. The
// levels n <= TAIL_SOLO (a few cells a thread) run in block 0 alone, whose
// band is the whole level, with block barriers; a cluster barrier still
// ends a level whose data crosses blocks (into or out of block 0). A
// level's input never leaves the cluster: the descend leg's restriction
// stores each coarse row into the slot of the block that owns it at the
// next level, and the ascend leg's prolongation reads the coarse rows from
// the blocks that hold them. Outputs go to global memory as they are formed.
// Every point is computed as legs.cuh computes it (jacobi_point,
// residual_point, the full weighting's rows then columns, the
// prolongation's columns then rows), with the __f*_rn intrinsics, so the tail equals
// the tile code and the plain twins bit for bit.
//
// The wide levels run the tile code with staging that keeps its loads in
// flight (legs.cuh's descend_tile / ascend_tile). Each launch's
// attributes and occupancy are computed once per device and process.
#pragma once

#include "legs.cuh"

namespace mgk {

constexpr int MAX_CHAIN = 16;
// The cluster's blocks: 8, the portable maximum (a 16-block cluster needs
// cudaFuncAttributeNonPortableClusterSizeAllowed and a GPC with 16 free SMs,
// which not every sm_90 part has; PERF.md gives what 16 would gain).
constexpr int TAIL_CTAS = 8;
constexpr int TAIL_THREADS = 1024;
constexpr int TAIL_SLOTS = 4;         // level-sized band slots a block holds
constexpr int TAIL_SMEM_LIMIT = 232448 - 1024;  // dynamic bytes, beside the static ones
constexpr int MAX_DEVICES = 64;
constexpr int TAIL_SOLO = 65;         // levels n <= TAIL_SOLO run in block 0 alone

// The split size S: levels n <= S run in the tail. Set by
// mg_chain_force_split (chain_descend.cu, which defines it); -1: the rule's.
extern int chain_forced_split;
constexpr int CHAIN_SPLIT = 257;
// The kernels the last mg_chain_descend / mg_chain_ascend call launched
// (0-2; launch_wide and launch_tail add one each), read by mg_chain_launched.
extern int chain_launched;

static inline int chain_split_size() {
  return chain_forced_split >= 0 ? chain_forced_split : CHAIN_SPLIT;
}

// Whether level n runs in block 0 alone.
static __host__ __device__ __forceinline__ bool tail_solo(int n) { return n <= TAIL_SOLO; }

static __host__ __device__ __forceinline__ int band_lo(int n, int q) {
  return tail_solo(n) ? (q > 0 ? n : 0) : n * q / TAIL_CTAS;
}

static __host__ __device__ __forceinline__ int band_rows_max(int n) {
  return tail_solo(n) ? n : (n + TAIL_CTAS - 1) / TAIL_CTAS;
}

// The block whose band at level n holds row gi.
static __device__ __forceinline__ int band_owner(int n, int gi) {
  return tail_solo(n) ? 0 : (TAIL_CTAS * (gi + 1) + n - 1) / n - 1;
}

// Floats of one band slot for the tail levels sizes[first..last].
static inline size_t tail_slot_floats(const int* sizes, int first, int last) {
  size_t floats = 0;
  for (int k = first; k <= last; ++k) {
    const size_t f = (size_t)band_rows_max(sizes[k]) * sizes[k];
    floats = f > floats ? f : floats;
  }
  return floats;
}

static inline size_t tail_smem_bytes(size_t slot_floats) {
  return TAIL_SLOTS * slot_floats * sizeof(float);
}

// The first level of the ladder sizes[0..levels] at or below S (`levels`
// when none is); -1 when the tail would not fit the cluster.
static inline int chain_split_level(const int* sizes, int levels) {
  const int s = chain_split_size();
  int k = 0;
  while (k < levels && sizes[k] > s) ++k;
  if (k < levels && tail_smem_bytes(tail_slot_floats(sizes, k, levels)) > (size_t)TAIL_SMEM_LIMIT)
    return -1;
  return k;
}

// A barrier of the whole cluster, or of this block where no data crosses
// blocks (the levels block 0 runs alone). `cluster` is the same in every
// block.
static __device__ __forceinline__ void tail_sync(bool cluster) {
  if (cluster)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// The cells idx = threadIdx.x, + TAIL_THREADS, ... of a band n wide, as
// (row i in the band, column j), stepped without a division.
struct BandCells {
  int i, j, di, dj, n;
  __device__ __forceinline__ void next() {
    i += di;
    j += dj;
    if (j >= n) {
      j -= n;
      ++i;
    }
  }
};

static __device__ __forceinline__ BandCells band_cells(int n) {
  BandCells c;
  c.n = n;
  c.i = (int)threadIdx.x / n;
  c.j = (int)threadIdx.x - c.i * n;
  c.di = TAIL_THREADS / n;
  c.dj = TAIL_THREADS - c.di * n;
  return c;
}

// Row gi of a level-n band slot, in whichever block of the cluster holds it.
template <class T>
static __device__ __forceinline__ T* cluster_row(T* slot, int n, int gi) {
  const int r = band_owner(n, gi);
  return cooperative_groups::this_cluster().map_shared_rank(slot, r) +
         (ptrdiff_t)(gi - band_lo(n, r)) * n;
}

// count floats of src into dst, in batches of 8 loads in flight a thread.
static __device__ void load_band(float* dst, const float* __restrict__ src, int count) {
  for (int base = threadIdx.x; base < count; base += 8 * TAIL_THREADS) {
    float v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * TAIL_THREADS;
      v[b] = idx < count ? __ldcg(src + idx) : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * TAIL_THREADS;
      if (idx < count) dst[idx] = v[b];
    }
  }
}

// load_band of two sources at once: 16 loads in flight a thread.
static __device__ void load_band2(float* dst0, const float* __restrict__ src0, float* dst1,
                                  const float* __restrict__ src1, int count) {
  for (int base = threadIdx.x; base < count; base += 8 * TAIL_THREADS) {
    float v0[8], v1[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * TAIL_THREADS;
      v0[b] = idx < count ? __ldcg(src0 + idx) : 0.0f;
      v1[b] = idx < count ? __ldcg(src1 + idx) : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int idx = base + b * TAIL_THREADS;
      if (idx < count) {
        dst0[idx] = v0[b];
        dst1[idx] = v1[b];
      }
    }
  }
}

// The band's cells of a level-n slot into global memory (rows lo.. of dst).
static __device__ void store_band(float* __restrict__ dst, const float* src, int count) {
  for (int idx = threadIdx.x; idx < count; idx += TAIL_THREADS) dst[idx] = src[idx];
}

// One Jacobi sweep src -> dst over the band [lo, lo + rows) of level n;
// `above` and `below` are rows lo − 1 and lo + rows of src (in the
// neighbours' slots), read only where a neighbour exists. Frozen cells are
// copied.
static __device__ void band_sweep(const float* src, float* dst, const float* sf,
                                  const float* above, const float* below, int n, int lo,
                                  int rows, float h2, float omega) {
  BandCells c = band_cells(n);
  for (int idx = threadIdx.x; idx < rows * n; idx += TAIL_THREADS, c.next()) {
    const float uc = src[idx];
    float v = uc;
    if (interior(lo + c.i, c.j, n)) {
      const float up = c.i > 0 ? src[idx - n] : above[c.j];
      const float dn = c.i + 1 < rows ? src[idx + n] : below[c.j];
      const float nb = __fadd_rn(__fadd_rn(__fadd_rn(up, dn), src[idx - 1]), src[idx + 1]);
      v = jacobi_point(nb, uc, sf[idx], h2, omega);
    }
    dst[idx] = v;
  }
}

// band_sweep from the closed-form first sweep from u ≡ 0, u_1 = zc·f on the
// interior and 0 elsewhere, formed at each read from f's band and the rows
// just above and below it (u_1 is never stored, and the sweep needs no
// barrier before it: f is complete when the level begins).
static __device__ void band_sweep_fz(const float* sf, float* dst, const float* f_above,
                                     const float* f_below, int n, int lo, int rows, float zc,
                                     float h2, float omega) {
  BandCells c = band_cells(n);
  for (int idx = threadIdx.x; idx < rows * n; idx += TAIL_THREADS, c.next()) {
    const int gi = lo + c.i, j = c.j;
    const float fc = sf[idx];
    const bool in = interior(gi, j, n);
    const float uc = in ? __fmul_rn(zc, fc) : 0.0f;
    float v = uc;
    if (in) {
      const float fu = c.i > 0 ? sf[idx - n] : f_above[j];
      const float fd = c.i + 1 < rows ? sf[idx + n] : f_below[j];
      const float up = interior(gi - 1, j, n) ? __fmul_rn(zc, fu) : 0.0f;
      const float dn = interior(gi + 1, j, n) ? __fmul_rn(zc, fd) : 0.0f;
      const float w = interior(gi, j - 1, n) ? __fmul_rn(zc, sf[idx - 1]) : 0.0f;
      const float e = interior(gi, j + 1, n) ? __fmul_rn(zc, sf[idx + 1]) : 0.0f;
      v = jacobi_point(__fadd_rn(__fadd_rn(__fadd_rn(up, dn), w), e), uc, fc, h2, omega);
    }
    dst[idx] = v;
  }
}

// Rows lo − 1 and lo + rows of a level-n slot (nullptr where there is no
// such interior neighbour row).
struct BandEdges {
  const float* above;
  const float* below;
};

static __device__ __forceinline__ BandEdges band_edges(const float* slot, int n, int lo,
                                                       int rows) {
  BandEdges e = {nullptr, nullptr};
  if (rows > 0 && lo > 0) e.above = cluster_row(slot, n, lo - 1);
  if (rows > 0 && lo + rows < n) e.below = cluster_row(slot, n, lo + rows);
  return e;
}

// --- block_sum and fixed_sum (common.cuh) for a group of BLOCK_Y warps --------
// A tail block of TAIL_THREADS threads is four groups of THREADS; group g's
// thread t plays thread (t % BLOCK_X, t / BLOCK_X) of a tile block, so the
// sums are the tile code's bit for bit. Named barrier 1 + g syncs a group.

constexpr int TAIL_GROUPS = TAIL_THREADS / THREADS;

static __device__ __forceinline__ void group_barrier(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(THREADS) : "memory");
}

static __device__ float group_sum(float v, float* warp_sums, int g) {
  const int t = threadIdx.x % THREADS, x = t % BLOCK_X, y = t / BLOCK_X;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  group_barrier(g);
  if (x == 0) warp_sums[y] = v;
  group_barrier(g);
  float total = 0.0f;
  if (y == 0) {
    total = x < BLOCK_Y ? warp_sums[x] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  }
  return total;
}

// --- the wide levels' persistent launch, planned once per device -------------

struct PersistentPlan {
  int sms[MAX_DEVICES];
  int per_sm[MAX_DEVICES][MAX_HALO + 1];  // 0: not yet queried
  bool attr[MAX_DEVICES];
};

// launch_persistent (common.cuh) with the attribute set once per device (at
// the largest halo's shared memory) and the occupancy of each halo cached.
template <typename Args>
static cudaError_t launch_wide(void (*kernel)(Args), PersistentPlan& plan, const Args& args,
                               int halo, int tiles, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || halo > MAX_HALO) return cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(halo);
  if (!plan.attr[dev]) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tile_smem_bytes(MAX_HALO))) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&plan.sms[dev], cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess)
      return e;
    plan.attr[dev] = true;
  }
  int& per_sm = plan.per_sm[dev][halo];
  if (per_sm == 0) {
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
        cudaSuccess)
      return e;
    if (per_sm < 1) {
      per_sm = 0;
      return cudaErrorCooperativeLaunchTooLarge;
    }
  }
  const int blocks = per_sm * plan.sms[dev] < tiles ? per_sm * plan.sms[dev] : tiles;
  void* params[] = {const_cast<Args*>(&args)};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(BLOCK_X, BLOCK_Y),
                                  params, smem, stream);
  if (e == cudaSuccess && (e = cudaGetLastError()) == cudaSuccess) ++chain_launched;
  return e;
}

// --- the tail's cluster launch, checked once per device ----------------------

struct ClusterPlan {
  int state[MAX_DEVICES];  // 0: not yet checked, 1: placeable
};

template <typename Args>
static cudaError_t launch_tail(void (*kernel)(Args), ClusterPlan& plan, const Args& args,
                               size_t smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || smem > (size_t)TAIL_SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = TAIL_CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(TAIL_CTAS);
  cfg.blockDim = dim3(TAIL_THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (plan.state[dev] == 0) {
    // set once at the largest tail; a cluster that cannot be placed is an error
    cfg.dynamicSmemBytes = TAIL_SMEM_LIMIT;
    int clusters = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  TAIL_SMEM_LIMIT)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess)
      return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    plan.state[dev] = 1;
  }
  cfg.dynamicSmemBytes = smem;
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e == cudaSuccess && (e = cudaGetLastError()) == cudaSuccess) ++chain_launched;
  return e;
}

}  // namespace mgk
