// The whole ascend half of a V-cycle in one kernel: from the coarse solution
// up the 2:1 ladder n_c -> ... -> n_0, at each level k the prolongation of
// the level below, its interior add and the post-sweeps, plus an optional
// fused smoothing error on level 0.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _ascend_chain_kernel, reached through fused_chain_ascend.
//
// Bound: launches, as chain_descend.cu. Design: one persistent cooperative
// launch; its blocks walk the tiles of level k with the ascend leg's tile
// code (ascend_tile, legs.cuh, exactly as ascend.cu), reading the
// correction from the level below as written before the last grid barrier,
// then meet at a barrier before level k−1 reads it. With an error, every
// tile of level 0 writes its partial, and after a last barrier block 0 sums
// them in the fixed order of the one-launch reduction.
#include "legs.cuh"

using namespace mgk;

constexpr int MAX_CHAIN = 16;

struct ChainAscendArgs {
  const float* uc;              // coarse solution at n[levels]
  const float* u[MAX_CHAIN];    // u[k]: level k after its pre-sweeps
  const float* f[MAX_CHAIN];    // f[k]: level k's right-hand side
  float* out[MAX_CHAIN];        // out[k]: level k after its post-sweeps
  float* partials;              // num_tiles(n[0]) floats when err_mode
  float* err_out;
  int n[MAX_CHAIN + 1];
  int steps[MAX_CHAIN];
  int halo[MAX_CHAIN];
  float h2[MAX_CHAIN], inv_h2[MAX_CHAIN];
  int levels, err_mode;
  float omega, err_scale;
};

static __global__ void __launch_bounds__(THREADS) chain_ascend_kernel(ChainAscendArgs a) {
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const float* child = a.uc;
  for (int k = a.levels - 1; k >= 0; --k) {
    const int n = a.n[k], tx = tiles_x(n), count = num_tiles(n);
    const int mode = k == 0 ? a.err_mode : ERR_NONE;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      ascend_tile(smem, window(a.u[k], n), window(a.f[k], n), window(child, a.n[k + 1]),
                  a.out[k], mode != ERR_NONE ? a.partials + t : nullptr, t % tx, t / tx, n,
                  a.steps[k], a.halo[k], mode, a.h2[k], a.omega, a.inv_h2[k]);
    child = a.out[k];
    if (k > 0 || a.err_mode != ERR_NONE) grid.sync();  // out[k] / the partials complete
  }
  if (a.err_mode != ERR_NONE && blockIdx.x == 0) {
    const float total = fixed_sum(a.partials, num_tiles(a.n[0]));
    if (threadIdx.x == 0 && threadIdx.y == 0) a.err_out[0] = __fmul_rn(total, a.err_scale);
  }
}

// sizes[0..levels]: the 2:1 ladder; steps[k] in 0..MAX_STEPS (>= 1 on level 0
// with an error); scalars as mg_chain_descend; u_ptrs, f_ptrs and out_ptrs
// hold `levels` device addresses each. Error arguments as mg_jacobi.
extern "C" int mg_chain_ascend(const float* uc, const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* out_ptrs, const int* sizes,
                               const int* steps, const float* scalars, int levels,
                               int err_mode, float omega, float* partials, float* err_out,
                               float err_scale, void* stream) {
  if (levels < 1 || levels > MAX_CHAIN || (err_mode != ERR_NONE && steps[0] < 1))
    return (int)cudaErrorInvalidValue;
  ChainAscendArgs a = {};
  a.uc = uc;
  a.partials = partials;
  a.err_out = err_out;
  a.levels = levels;
  a.err_mode = err_mode;
  a.omega = omega;
  a.err_scale = err_scale;
  int max_halo = 0;
  a.n[levels] = sizes[levels];
  for (int k = 0; k < levels; ++k) {
    if (steps[k] < 0 || steps[k] > MAX_STEPS || sizes[k] < 3 || sizes[k + 1] * 2 - 1 != sizes[k])
      return (int)cudaErrorInvalidValue;
    a.u[k] = (const float*)u_ptrs[k];
    a.f[k] = (const float*)f_ptrs[k];
    a.out[k] = (float*)out_ptrs[k];
    a.n[k] = sizes[k];
    a.steps[k] = steps[k];
    a.halo[k] = jacobi_halo(steps[k], k == 0 ? err_mode : ERR_NONE);
    a.h2[k] = scalars[3 * k];
    a.inv_h2[k] = scalars[3 * k + 1];
    max_halo = a.halo[k] > max_halo ? a.halo[k] : max_halo;
  }
  return (int)launch_persistent(chain_ascend_kernel, a, tile_smem_bytes(max_halo),
                                num_tiles(sizes[0]), (cudaStream_t)stream);
}
