// The whole descend half of a V-cycle below one level in one kernel: for
// each level k < c of the 2:1 ladder n_0 -> n_1 -> ... -> n_c, the pre-sweeps,
// the residual and its restriction into level k+1's right-hand side.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _descend_chain_kernel, reached through fused_chain_descend.
//
// Bound: on the small levels, launches. Run level by level, each level costs
// one kernel launch, a host call and a zero fill for a few microseconds of
// device work; below 1025² the host's launch rate, not the card, sets the
// pace. On the TPU the chain keeps every level in VMEM. Design: one
// persistent cooperative launch. Its blocks walk the tiles of level k with
// the descend leg's tile code (descend_tile, legs.cuh: sweeps, residual and
// restriction in shared memory, exactly as descend.cu), then meet at a grid
// barrier before level k+1 reads the right-hand side level k wrote. From a
// 1025² entry down, the inputs and every level's u and f come to about
// 15 MB, well inside the card's 50 MB L2, so levels meet in L2. Levels after the entry start from u ≡ 0 (the closed-form first
// sweep); the entry level does too when entry_from_zero.
#include "legs.cuh"

using namespace mgk;

constexpr int MAX_CHAIN = 16;

struct ChainDescendArgs {
  const float* u0;             // entry iterate (unread when entry_from_zero)
  float* f[MAX_CHAIN + 1];     // f[0]: entry RHS (read only); f[k+1]: written by level k
  float* u[MAX_CHAIN];         // u[k]: level k after its pre-sweeps
  int n[MAX_CHAIN + 1];
  int n_sweeps[MAX_CHAIN];
  int halo[MAX_CHAIN];
  float h2[MAX_CHAIN], inv_h2[MAX_CHAIN], zero_coef[MAX_CHAIN];
  int levels, entry_from_zero, full_weighting;
  float omega;
};

static __global__ void __launch_bounds__(THREADS) chain_descend_kernel(ChainDescendArgs a) {
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int k = 0; k < a.levels; ++k) {
    const int n = a.n[k], tx = tiles_x(n), count = num_tiles(n);
    const int fz = k > 0 || a.entry_from_zero;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      descend_tile(smem, window(fz ? nullptr : a.u0, n), window(a.f[k], n), a.u[k], a.f[k + 1],
                   nullptr, t % tx, t / tx, n, a.n_sweeps[k], a.halo[k], fz, a.full_weighting,
                   ERR_NONE, a.h2[k], a.omega, a.inv_h2[k], a.zero_coef[k]);
    if (k + 1 < a.levels) grid.sync();  // level k+1 reads f[k+1]
  }
}

// sizes[0..levels]: the 2:1 ladder; steps[k] in 1..MAX_STEPS; scalars[3k..3k+2]
// = (h², 1/h², −(ω/4)h²) of level k; f_ptrs[0..levels] and u_ptrs[0..levels)
// are device addresses (f_ptrs[0] the entry RHS, the rest outputs).
extern "C" int mg_chain_descend(const float* u0, const unsigned long long* f_ptrs,
                                const unsigned long long* u_ptrs, const int* sizes,
                                const int* steps, const float* scalars, int levels,
                                int entry_from_zero, int full_weighting, float omega,
                                void* stream) {
  if (levels < 1 || levels > MAX_CHAIN) return (int)cudaErrorInvalidValue;
  ChainDescendArgs a = {};
  a.u0 = u0;
  a.levels = levels;
  a.entry_from_zero = entry_from_zero;
  a.full_weighting = full_weighting;
  a.omega = omega;
  int max_halo = 0;
  for (int k = 0; k <= levels; ++k) {
    a.n[k] = sizes[k];
    a.f[k] = (float*)f_ptrs[k];
  }
  for (int k = 0; k < levels; ++k) {
    if (steps[k] < 1 || steps[k] > MAX_STEPS || sizes[k] < 3 || sizes[k + 1] * 2 - 1 != sizes[k])
      return (int)cudaErrorInvalidValue;
    a.u[k] = (float*)u_ptrs[k];
    a.n_sweeps[k] = steps[k] - ((k > 0 || entry_from_zero) ? 1 : 0);
    a.halo[k] = descend_halo(a.n_sweeps[k], full_weighting);
    a.h2[k] = scalars[3 * k];
    a.inv_h2[k] = scalars[3 * k + 1];
    a.zero_coef[k] = scalars[3 * k + 2];
    max_halo = a.halo[k] > max_halo ? a.halo[k] : max_halo;
  }
  return (int)launch_persistent(chain_descend_kernel, a, tile_smem_bytes(max_halo),
                                num_tiles(sizes[0]), (cudaStream_t)stream);
}
