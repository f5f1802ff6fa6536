// The whole descend half of a V-cycle below one level: for each level k < c
// of the 2:1 ladder n_0 -> n_1 -> ... -> n_c, the pre-sweeps, the residual
// and its restriction into level k+1's right-hand side.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _descend_chain_kernel, reached through fused_chain_descend.
//
// Bound: latency. From 1025² down the inputs and every level's u and f come
// to about 15 MB (3.3 µs of bytes at 3.35 TB/s); the levels below 257² are a
// few tiles each, so a chain of dependent phases, not bytes, sets the time.
// On the TPU the chain keeps every level in VMEM. Design (chain_tail.cuh):
// two launches in stream order. The levels above the split size S (1025²,
// 513²) run as one persistent cooperative launch whose blocks walk the
// descend leg's tiles (descend_tile, legs.cuh, staged with its loads in
// flight) with one grid barrier between levels. The levels at or below S run
// in one cluster of TAIL_CTAS blocks that holds each level's f and iterates
// in shared memory as bands of rows: the closed-form first sweep, the
// sweeps, −r and the restriction, with a cluster barrier between dependent
// phases; the restriction stores level k+1's f into the blocks that own it.
// Levels after the entry start from u ≡ 0 (the closed-form first sweep); the
// entry level does too when entry_from_zero.
#include "chain_tail.cuh"

using namespace mgk;

// The chains' forced split and launch count (declared in chain_tail.cuh,
// used by both chains' entry points; read and set by the entries below).
namespace mgk {
int chain_forced_split = -1;
int chain_launched = 0;
}  // namespace mgk

struct ChainDescendArgs {
  const float* u0;             // entry iterate (unread when entry_from_zero)
  float* f[MAX_CHAIN + 1];     // f[0]: entry RHS (read only); f[k+1]: written by level k
  float* u[MAX_CHAIN];         // u[k]: level k after its pre-sweeps
  int n[MAX_CHAIN + 1];
  int n_sweeps[MAX_CHAIN];
  int halo[MAX_CHAIN];
  float h2[MAX_CHAIN], inv_h2[MAX_CHAIN], zero_coef[MAX_CHAIN];
  int first, levels;           // the launch runs levels first .. levels − 1
  int entry_from_zero, full_weighting;
  int slot;                    // floats of one tail band slot
  float omega;
};

// The wide levels: tiles of level k between grid barriers.
static __global__ void __launch_bounds__(THREADS) chain_descend_kernel(ChainDescendArgs a) {
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int k = a.first; k < a.levels; ++k) {
    const int n = a.n[k], tx = tiles_x(n), count = num_tiles(n);
    const int fz = k > 0 || a.entry_from_zero;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      descend_tile(smem, window(fz ? nullptr : a.u0, n), window(a.f[k], n), a.u[k],
                   a.f[k + 1], nullptr, t % tx, t / tx, n, a.n_sweeps[k], a.halo[k], fz,
                   a.full_weighting, ERR_NONE, a.h2[k], a.omega, a.inv_h2[k],
                   a.zero_coef[k]);
    if (k + 1 < a.levels) grid.sync();  // level k+1 reads f[k+1]
  }
}

// The tail: levels first .. levels − 1 in one cluster. Slots: f of the
// level (F[cur]), f of the next (F[cur ^ 1], written by the restriction),
// two iterates. Barriers are the cluster's where a level's data crosses
// blocks, block 0's own on the levels it runs alone. From zero, the sweep
// after the closed-form one forms u_1 from f at its reads (band_sweep_fz).
static __global__ void __launch_bounds__(TAIL_THREADS, 1)
chain_descend_tail(ChainDescendArgs a) {
  extern __shared__ float smem[];
  const int q = (int)cooperative_groups::this_cluster().block_rank();
  float* F[2] = {smem, smem + a.slot};
  float* it[2] = {smem + 2 * a.slot, smem + 3 * a.slot};
  {
    const int n = a.n[a.first], lo = band_lo(n, q), cells = (band_lo(n, q + 1) - lo) * n;
    if (a.first > 0 || a.entry_from_zero)
      load_band(F[0], a.f[a.first] + (size_t)lo * n, cells);
    else
      load_band2(F[0], a.f[a.first] + (size_t)lo * n, it[0], a.u0 + (size_t)lo * n, cells);
  }
  tail_sync(!tail_solo(a.n[a.first]));  // the first sweep reads the neighbours' rows
  int cur = 0;
  for (int k = a.first; k < a.levels; ++k) {
    const int n = a.n[k], lo = band_lo(n, q), rows = band_lo(n, q + 1) - lo, cells = rows * n;
    const bool multi = !tail_solo(n);
    const float* sf = F[cur];
    const bool fz = k > 0 || a.entry_from_zero;
    const int ns = a.n_sweeps[k];
    if (fz && ns == 0) {
      // the closed-form first sweep from u ≡ 0 alone (reads only the band's f)
      BandCells c = band_cells(n);
      for (int idx = threadIdx.x; idx < cells; idx += TAIL_THREADS, c.next())
        it[0][idx] = interior(lo + c.i, c.j, n) ? __fmul_rn(a.zero_coef[k], sf[idx]) : 0.0f;
    }
    for (int s = 1; s <= ns; ++s) {
      if (fz && s == 1) {
        // the first sweep after the closed-form one, from f
        const BandEdges e = band_edges(sf, n, lo, rows);
        band_sweep_fz(sf, it[1], e.above, e.below, n, lo, rows, a.zero_coef[k], a.h2[k],
                      a.omega);
        continue;
      }
      // the neighbours' u_{s−1} complete, their reads of u_{s−2} done
      tail_sync(multi);
      const float* src = it[(s - 1) & 1];
      const BandEdges e = band_edges(src, n, lo, rows);
      band_sweep(src, it[s & 1], sf, e.above, e.below, n, lo, rows, a.h2[k], a.omega);
    }
    const float* fin = it[ns & 1];
    float* d = it[(ns & 1) ^ 1];
    // the final iterate complete everywhere; nobody reads d's slot
    tail_sync(multi);
    store_band(a.u[k] + (size_t)lo * n, fin, cells);
    {
      // d = −r(fin) on the band
      const BandEdges e = band_edges(fin, n, lo, rows);
      BandCells c = band_cells(n);
      for (int idx = threadIdx.x; idx < cells; idx += TAIL_THREADS, c.next()) {
        float v = 0.0f;
        if (interior(lo + c.i, c.j, n)) {
          const float up = c.i > 0 ? fin[idx - n] : e.above[c.j];
          const float dn = c.i + 1 < rows ? fin[idx + n] : e.below[c.j];
          const float nb =
              __fadd_rn(__fadd_rn(__fadd_rn(up, dn), fin[idx - 1]), fin[idx + 1]);
          v = -residual_point(nb, fin[idx], sf[idx], a.inv_h2[k]);
        }
        d[idx] = v;
      }
    }
    // d complete: the neighbours' rows for full weighting, the band's own
    // (other threads') for sampling
    if (a.full_weighting)
      tail_sync(multi);
    else
      __syncthreads();
    {
      // coarse row I from fine row 2I of this band, into its owner's F slot
      const int m = a.n[k + 1];
      const int i_lo = (lo + 1) >> 1, i_hi = rows > 0 ? ((lo + rows - 1) >> 1) + 1 : i_lo;
      const BandEdges e = band_edges(d, n, lo, rows);
      float* fc = F[cur ^ 1];
      float* fg = a.f[k + 1];
      for (int idx = threadIdx.x; idx < (i_hi - i_lo) * m; idx += TAIL_THREADS) {
        const int I = i_lo + idx / m, J = idx - (idx / m) * m;
        float v = 0.0f;
        if (interior(I, J, m)) {
          const int li = 2 * I - lo;
          const float* r0 = d + (ptrdiff_t)li * n + 2 * J;
          if (a.full_weighting) {
            // rows (¼·d[i−1] + ½·d[i]) + ¼·d[i+1], then the same across columns
            const float* rm = li > 0 ? r0 - n : e.above + 2 * J;
            const float* rp = li + 1 < rows ? r0 + n : e.below + 2 * J;
            float sy[3];
            for (int cc = 0; cc < 3; ++cc)
              sy[cc] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, rm[cc - 1]),
                                           __fmul_rn(0.5f, r0[cc - 1])),
                                 __fmul_rn(0.25f, rp[cc - 1]));
            v = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, sy[0]), __fmul_rn(0.5f, sy[1])),
                          __fmul_rn(0.25f, sy[2]));
          } else {
            v = r0[0];
          }
        }
        if (multi)
          cluster_row(fc, m, I)[J] = v;
        else
          fc[(size_t)I * m + J] = v;  // block 0 holds every row of a level after a solo one
        fg[(size_t)I * m + J] = v;
      }
    }
    // level k+1's f complete in every block and level k's reads done (the
    // cluster's barrier where level k's blocks wrote into other blocks);
    // after the last level, no block exits while another may still write
    // its slots
    tail_sync(multi);
    cur ^= 1;
  }
}

static PersistentPlan wide_plan;
static ClusterPlan tail_plan;

// The route of every later chain launch: S = split (levels n <= S in the
// cluster tail; 0: every level wide), or the rule's CHAIN_SPLIT with -1.
// A split whose tail would not fit the cluster makes the launch fail.
extern "C" int mg_chain_force_split(int split) {
  if (split < -1) return (int)cudaErrorInvalidValue;
  chain_forced_split = split;
  return 0;
}

// The kernels the last chain call launched: 1 (wide or tail) or 2 (both).
extern "C" int mg_chain_launched() { return chain_launched; }

// sizes[0..levels]: the 2:1 ladder; steps[k] in 1..MAX_STEPS; scalars[3k..3k+2]
// = (h², 1/h², −(ω/4)h²) of level k; f_ptrs[0..levels] and u_ptrs[0..levels)
// are device addresses (f_ptrs[0] the entry RHS, the rest outputs).
extern "C" int mg_chain_descend(const float* u0, const unsigned long long* f_ptrs,
                                const unsigned long long* u_ptrs, const int* sizes,
                                const int* steps, const float* scalars, int levels,
                                int entry_from_zero, int full_weighting, float omega,
                                void* stream) {
  chain_launched = 0;
  if (levels < 1 || levels > MAX_CHAIN) return (int)cudaErrorInvalidValue;
  ChainDescendArgs a = {};
  a.u0 = u0;
  a.entry_from_zero = entry_from_zero;
  a.full_weighting = full_weighting;
  a.omega = omega;
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
  }
  const int split = chain_split_level(sizes, levels);
  if (split < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (split > 0) {
    int max_halo = 0;
    for (int k = 0; k < split; ++k) max_halo = a.halo[k] > max_halo ? a.halo[k] : max_halo;
    a.first = 0;
    a.levels = split;
    const cudaError_t e =
        launch_wide(chain_descend_kernel, wide_plan, a, max_halo, num_tiles(sizes[0]), s);
    if (e != cudaSuccess) return (int)e;
  }
  if (split < levels) {
    a.first = split;
    a.levels = levels;
    const size_t slot = tail_slot_floats(sizes, split, levels);
    a.slot = (int)slot;
    return (int)launch_tail(chain_descend_tail, tail_plan, a, tail_smem_bytes(slot), s);
  }
  return 0;
}

