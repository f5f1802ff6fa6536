// The whole ascend half of a V-cycle: from the coarse solution up the 2:1
// ladder n_c -> ... -> n_0, at each level k the prolongation of the level
// below, its interior add and the post-sweeps, plus an optional fused
// smoothing error on level 0.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _ascend_chain_kernel, reached through fused_chain_ascend.
//
// Bound: latency, as chain_descend.cu. Design (chain_tail.cuh): two launches
// in stream order, the mirror of the descend chain's. The levels at or below
// the split size S run first, in one cluster that holds each level's f, the
// iterates and the correction from the level below in shared memory as bands
// of rows: the prolongation reads the coarse rows from the blocks that hold
// them, a cluster barrier separates the sweeps, and each level's result
// stays in the cluster as the next level's correction (and goes to out[k]).
// The levels above S then run as one persistent cooperative launch over the
// ascend leg's tiles (ascend_tile, legs.cuh, staged with its loads in
// flight), reading the correction from global memory, a grid barrier
// between levels. Level 0's error is summed as the one-level launch sums it:
// per-tile partials of legs.cuh's 32 x 128 tiles in error_partial's order
// (the tail's groups of THREADS threads play the tile blocks), then
// fixed_sum in one block.
#include "chain_tail.cuh"

using namespace mgk;

struct ChainAscendArgs {
  const float* uc;              // the correction below the launch's lowest level
  const float* u[MAX_CHAIN];    // u[k]: level k after its pre-sweeps
  const float* f[MAX_CHAIN];    // f[k]: level k's right-hand side
  float* out[MAX_CHAIN];        // out[k]: level k after its post-sweeps
  float* partials;              // num_tiles(n[0]) floats when err_mode
  float* err_out;
  int n[MAX_CHAIN + 1];
  int steps[MAX_CHAIN];
  int halo[MAX_CHAIN];
  float h2[MAX_CHAIN], inv_h2[MAX_CHAIN];
  int first, top;               // the launch runs levels top down to first
  int err_mode;
  int slot;                     // floats of one tail band slot
  float omega, err_scale;
};

// The wide levels: tiles of level k between grid barriers.
static __global__ void __launch_bounds__(THREADS) chain_ascend_kernel(ChainAscendArgs a) {
  extern __shared__ float smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const float* child = a.uc;
  for (int k = a.top; k >= a.first; --k) {
    const int n = a.n[k], tx = tiles_x(n), count = num_tiles(n);
    const int mode = k == 0 ? a.err_mode : ERR_NONE;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      ascend_tile(smem, window(a.u[k], n), window(a.f[k], n), window(child, a.n[k + 1]),
                  a.out[k], mode != ERR_NONE ? a.partials + t : nullptr, t % tx, t / tx,
                  n, a.steps[k], a.halo[k], mode, a.h2[k], a.omega, a.inv_h2[k]);
    child = a.out[k];
    if (k > a.first || mode != ERR_NONE) grid.sync();  // out[k] / the partials complete
  }
  if (a.first == 0 && a.err_mode != ERR_NONE && blockIdx.x == 0) {
    const float total = fixed_sum(a.partials, num_tiles(a.n[0]));
    if (threadIdx.x == 0 && threadIdx.y == 0) a.err_out[0] = __fmul_rn(total, a.err_scale);
  }
}

// Cell (gi, gj) of a level-n slot, from whichever block holds it.
static __device__ __forceinline__ float cluster_at(const float* slot, int n, int gi, int gj) {
  return cluster_row(slot, n, gi)[gj];
}

// Level 0's error from the tail: the partial of every 32 x 128 tile of the
// level as error_partial forms it, a tile a group, then their fixed_sum.
static __device__ void tail_error(const ChainAscendArgs& a, const float* fin, const float* prev,
                                  const float* sf, float* warp_sums) {
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int n = a.n[0], tx_count = tiles_x(n), count = num_tiles(n);
  const int g = threadIdx.x / THREADS, t = threadIdx.x % THREADS;
  const int x = t % BLOCK_X, y = t / BLOCK_X;
  for (int tile = (int)cl.block_rank() * TAIL_GROUPS + g; tile < count;
       tile += TAIL_CTAS * TAIL_GROUPS) {
    const int r0 = tile / tx_count * TILE_H, c0 = tile % tx_count * TILE_W;
    float acc = 0.0f;
    for (int i = y; i < TILE_H; i += BLOCK_Y) {
      const int gi = r0 + i;
      for (int j = x; j < TILE_W; j += BLOCK_X) {
        const int gj = c0 + j;
        if (gi < 1 || gi > n - 2 || gj < 1 || gj > n - 2) continue;
        if (a.err_mode == ERR_CPU && ((gi + gj) & 1)) continue;
        const float uc = cluster_at(fin, n, gi, gj);
        if (a.err_mode == ERR_GPU) {
          acc += fabsf(__fsub_rn(uc, cluster_at(prev, n, gi, gj)));
        } else {
          const float nb = __fadd_rn(__fadd_rn(__fadd_rn(cluster_at(fin, n, gi - 1, gj),
                                                         cluster_at(fin, n, gi + 1, gj)),
                                               cluster_at(fin, n, gi, gj - 1)),
                                     cluster_at(fin, n, gi, gj + 1));
          acc += fabsf(residual_point(nb, uc, cluster_at(sf, n, gi, gj), a.inv_h2[0]));
        }
      }
    }
    const float total = group_sum(acc, warp_sums + g * BLOCK_Y, g);
    if (t == 0) a.partials[tile] = total;
  }
  __threadfence();
  cl.sync();  // every partial written
  if (cl.block_rank() == 0 && g == 0) {
    float v = 0.0f;
    for (int i = t; i < count; i += THREADS) v += __ldcg(a.partials + i);
    const float total = group_sum(v, warp_sums, 0);
    if (t == 0) a.err_out[0] = __fmul_rn(total, a.err_scale);
  }
}

// The tail: levels top down to first in one cluster. Slots: the level's f,
// then three iterates: the correction from the level below (the previous
// level's result) and the level's two ping-pong buffers.
static __global__ void __launch_bounds__(TAIL_THREADS, 1) chain_ascend_tail(ChainAscendArgs a) {
  extern __shared__ float smem[];
  __shared__ float warp_sums[TAIL_GROUPS * BLOCK_Y];
  const int q = (int)cooperative_groups::this_cluster().block_rank();
  float* sf = smem;
  float* it[3] = {smem + a.slot, smem + 2 * a.slot, smem + 3 * a.slot};
  int child = -1;  // the slot holding the correction; -1: a.uc in global memory
  for (int k = a.top; k >= a.first; --k) {
    const int n = a.n[k], m = a.n[k + 1];
    const int lo = band_lo(n, q), rows = band_lo(n, q + 1) - lo, cells = rows * n;
    const bool multi = !tail_solo(n);
    const int p0 = child == 0 ? 1 : 0, p1 = child == 2 ? 1 : 2;  // the two free slots
    float* bufs[2] = {it[p0], it[p1]};
    load_band2(sf, a.f[k] + (size_t)lo * n, bufs[0], a.u[k] + (size_t)lo * n, cells);
    // the coarse rows the band's interior rows interpolate from, copied into
    // the spare buffer in one pass from the blocks that hold them (4 loads
    // in flight a thread)
    const int c_lo = lo >> 1;
    const int c_count = rows > 0 ? min(m - 1, ((lo + rows - 1) >> 1) + 1) - c_lo + 1 : 0;
    float* cw = bufs[1];
    for (int base = threadIdx.x; base < c_count * m; base += 4 * TAIL_THREADS) {
      float v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int idx = base + b * TAIL_THREADS, r = idx / m, J = idx - r * m, I = c_lo + r;
        v[b] = idx >= c_count * m ? 0.0f
               : child < 0        ? __ldcg(a.uc + (size_t)I * m + J)
                                  : cluster_row(it[child], m, I)[J];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (base + b * TAIL_THREADS < c_count * m) cw[base + b * TAIL_THREADS] = v[b];
    }
    __syncthreads();
    {
      // u plus the prolonged correction on the interior (ascend_tile's order)
      BandCells c = band_cells(n);
      for (int idx = threadIdx.x; idx < cells; idx += TAIL_THREADS, c.next()) {
        const int gi = lo + c.i, gj = c.j;
        if (!interior(gi, gj, n)) continue;
        const float* r0 = cw + ((gi >> 1) - c_lo) * m + (gj >> 1);
        const float w0 =
            (gj & 1) ? __fadd_rn(__fmul_rn(0.5f, r0[0]), __fmul_rn(0.5f, r0[1])) : r0[0];
        float p = w0;
        if (gi & 1) {
          const float* r1 = r0 + m;
          const float w1 =
              (gj & 1) ? __fadd_rn(__fmul_rn(0.5f, r1[0]), __fmul_rn(0.5f, r1[1])) : r1[0];
          p = __fadd_rn(__fmul_rn(0.5f, w0), __fmul_rn(0.5f, w1));
        }
        bufs[0][idx] = __fadd_rn(bufs[0][idx], p);
      }
    }
    const int steps = a.steps[k];
    for (int s = 1; s <= steps; ++s) {
      // the neighbours' previous iterate complete, their older reads done
      tail_sync(multi);
      const float* src = bufs[(s - 1) & 1];
      const BandEdges e = band_edges(src, n, lo, rows);
      band_sweep(src, bufs[s & 1], sf, e.above, e.below, n, lo, rows, a.h2[k], a.omega);
    }
    const int fin = steps & 1;
    store_band(a.out[k] + (size_t)lo * n, bufs[fin], cells);
    child = fin ? p1 : p0;
    // the result complete everywhere (the next level's correction; the
    // cluster's barrier where other blocks read it: a multi-block level, or
    // level 0's error); after the last level, no block exits while another
    // may still read its slots
    const bool err = k == 0 && a.err_mode != ERR_NONE;
    tail_sync(multi || err || (k > a.first && !tail_solo(a.n[k - 1])));
    if (err) tail_error(a, bufs[fin], bufs[fin ^ 1], sf, warp_sums);
  }
}

static PersistentPlan wide_plan;
static ClusterPlan tail_plan;

// sizes[0..levels]: the 2:1 ladder; steps[k] in 0..MAX_STEPS (>= 1 on level 0
// with an error); scalars as mg_chain_descend; u_ptrs, f_ptrs and out_ptrs
// hold `levels` device addresses each. Error arguments as mg_jacobi.
extern "C" int mg_chain_ascend(const float* uc, const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* out_ptrs, const int* sizes,
                               const int* steps, const float* scalars, int levels,
                               int err_mode, float omega, float* partials, float* err_out,
                               float err_scale, void* stream) {
  chain_launched = 0;
  if (levels < 1 || levels > MAX_CHAIN || (err_mode != ERR_NONE && steps[0] < 1))
    return (int)cudaErrorInvalidValue;
  ChainAscendArgs a = {};
  a.partials = partials;
  a.err_out = err_out;
  a.err_mode = err_mode;
  a.omega = omega;
  a.err_scale = err_scale;
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
  }
  const int split = chain_split_level(sizes, levels);
  if (split < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (split < levels) {
    a.uc = uc;
    a.first = split;
    a.top = levels - 1;
    const size_t slot = tail_slot_floats(sizes, split, levels);
    a.slot = (int)slot;
    const cudaError_t e = launch_tail(chain_ascend_tail, tail_plan, a, tail_smem_bytes(slot), s);
    if (e != cudaSuccess || split == 0) return (int)e;
  }
  int max_halo = 0;
  for (int k = 0; k < split; ++k) max_halo = a.halo[k] > max_halo ? a.halo[k] : max_halo;
  a.uc = split < levels ? a.out[split] : uc;
  a.first = 0;
  a.top = split - 1;
  return (int)launch_wide(chain_ascend_kernel, wide_plan, a, max_halo, num_tiles(sizes[0]), s);
}

