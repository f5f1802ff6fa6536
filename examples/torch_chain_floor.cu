// The units of the chains' floor (kernels 6 and 7): one cluster barrier of
// the tail's cluster (8 blocks of 1024 threads), one grid barrier of a
// cooperative launch of 256-thread blocks (the wide levels' launch), and one
// kernel launch. Built and driven by examples/torch_chain_floor.py.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

static __global__ void __launch_bounds__(1024, 1) cluster_sync_loop(int iters) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  for (int i = 0; i < iters; ++i) cl.sync();
}

static __global__ void __launch_bounds__(256) grid_sync_loop(int iters) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

static __global__ void empty_kernel() {}

// One cluster of 8 blocks of 1024 threads running `iters` cluster barriers.
extern "C" int probe_cluster_syncs(int iters, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 8;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(8);
  cfg.blockDim = dim3(1024);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_sync_loop, iters);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// `blocks` cooperative blocks of 256 threads running `iters` grid barriers.
extern "C" int probe_grid_syncs(int blocks, int iters, void* stream) {
  void* params[] = {&iters};
  const cudaError_t e = cudaLaunchCooperativeKernel((const void*)grid_sync_loop, dim3(blocks),
                                                    dim3(32, 8), params, 0, (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" int probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
