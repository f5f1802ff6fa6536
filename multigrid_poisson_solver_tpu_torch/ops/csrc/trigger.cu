// The reference's whole error-triggered smoothing loop in one kernel: one
// damped-Jacobi sweep at a time while |err_k − err_{k−1}| > trigger, up to
// max_sweeps, with the cpu / clean / gpu smoothing-error metric.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_chain.py,
// _trigger_vmem_kernel, reached through fused_trigger_vmem (the engine's
// trigger nodes of n <= 2176, trigger_fits).
//
// Bound: latency. A sweep of a 257² level is 66 K points, 37 ns of the
// card's arithmetic, while a loop of separate launches pays a launch and a
// read of the error back to the host a sweep, and a grid-wide loop a grid
// barrier and a trip through L2.
//
// Three routes by size (trigger_route; mg_trigger_force_route overrides
// it), each measured against the others on an H100 (PERF.md):
//  * levels n <= CHAIN_SPLIT (257): the whole loop in one thread block
//    cluster (chain_tail.cuh's launch_tail: TAIL_CTAS blocks of
//    TAIL_THREADS threads), nothing but the inputs and the result in device
//    memory. Block q holds a band of whole tile rows (rows [32q, 32q + 32),
//    the last block the rest) of f, of three iterate slots and of the
//    pass's error terms in shared memory, each slot with a halo row a side
//    into which the neighbours push their edge rows through distributed
//    shared memory as they form them. A pass sweeps the band in quads of
//    four cells, every load local, and stores their terms; then a group of
//    256 threads plays one tile block of legs.cuh's tile code, thread (x, y)
//    adding the terms of the tile's cells in rows y + 8a, columns x + 32b in
//    error_partial's order and group_sum forming the tile's partial, which
//    is the one kernel 1's one-sweep launch forms, pushed into every block's
//    copy of the pass's partial array. One
//    cluster barrier a sweep: the cpu and clean errors of u_k read u_k's
//    neighbours, so they are measured in the pass that makes u_{k+1} (the
//    lagged form, solver.trigger_loop_lagged), and each block's warp 31
//    sums the partials and takes the stop decision in the pass after, which
//    the next barrier publishes; u_k is then still whole in the third slot.
//    The gpu error |u_k − u_{k−1}| comes from the pass that makes u_k.
//    Levels n <= TAIL_SOLO run in block 0 alone, with block barriers.
//  * levels above it below WAVE_MIN_CELLS (1.5 M cells: 1025² but not
//    2049²): the tile loop, a sweep at a time (trigger_kernel: every block
//    sweeps its tiles with legs.cuh's jacobi_tile, one sweep plus the tile's
//    error partial, meets the others at a grid barrier, and sums all the
//    partials in the fixed order). There a wavefront pass costs its ~36
//    serial row steps a warp, 45-100 µs, more than a few such sweeps.
//  * larger levels: trigger_wave.cuh's wavefront passes with an exact
//    replay (trigger_wave_kernel), the loop trigger_stream.cu runs for
//    kernel 9.
// Each way the iterate, the stop sweep and the error are those of the loop
// of kernel 1's one-sweep launches (jacobi.cu), bit for bit.
#include "chain_tail.cuh"
#include "trigger_wave.cuh"

using namespace mgk;

// The levels above the cluster: trigger_wave.cuh's loop, in a kernel of
// kernel 8's own.
template <int E>
static __global__ void __launch_bounds__(TrigShape<TRIG_BATCH, E>::THREADS,
                                         TRIG_WARPS_PER_SM / TrigShape<TRIG_BATCH, E>::WARPS)
trigger_wave_kernel(WaveTriggerArgs a) {
  trigger_wave_loop<E>(a);
}

// The cluster route's largest level, and its tiles (3 x 9 at 257²).
constexpr int CLUSTER_MAX_N = CHAIN_SPLIT;
constexpr int CLUSTER_MAX_TILES = 32;
static_assert(((CLUSTER_MAX_N + TILE_W - 1) / TILE_W) * ((CLUSTER_MAX_N + TILE_H - 1) / TILE_H) <=
                  CLUSTER_MAX_TILES, "a partial array holds every tile");

// The first row of block q's band at level n: whole tile rows, block
// TAIL_CTAS − 1 taking the rest (a 257² level's last, one-row tile row);
// block 0 holds a level n <= TAIL_SOLO whole.
static __host__ __device__ __forceinline__ int trig_lo(int n, int q) {
  if (tail_solo(n)) return q > 0 ? n : 0;
  return q >= TAIL_CTAS || q * TILE_H > n ? n : q * TILE_H;
}

// tail_sync for a loop that every thread of the cluster runs in step: the
// cluster barrier's .aligned form (arrive with release, wait with acquire
// semantics, as cooperative_groups' cluster.sync(), which cannot assume a
// warp's threads arrive together), or block 0's own barrier.
static __device__ __forceinline__ void trig_sync(bool cluster) {
  if (cluster)
    asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
  else
    __syncthreads();
}

// One pass over a quad of the band: cells (li, 4q .. 4q + 3) of the band
// [lo, lo + rows) (global row lo + li) at slot row li + 1, rows ld floats
// apart in shared memory, the rows beside the band at slot rows 0 and rows +
// 1 (the neighbours' edge rows, which they pushed there): cur -> nxt, and
// the cells' error terms into terms (|r(cur)|, the even colour only for cpu,
// or |nxt − cur| for gpu; + 0 where error_partial skips a cell, and beyond
// the grid). An edge row of nxt also goes to the neighbour's halo row,
// push_up's and push_dn's (null: no neighbour there). 16-byte loads and
// stores, every one local: a cell's west and east neighbours are the quad's
// own but at its ends, where a frozen column reads anything.
template <bool GPU>
static __device__ __forceinline__ void sweep_quad(
    const float* __restrict__ cur, float* __restrict__ nxt, const float* __restrict__ sf,
    float* __restrict__ terms, float* __restrict__ push_up, float* __restrict__ push_dn, int n,
    int ld, int lo, int rows, int li, int q, bool cpu, float h2, float omega, float inv_h2) {
  const int gi = lo + li, at = (li + 1) * ld + 4 * q;
  const bool row_in = gi >= 1 && gi <= n - 2;
  const float4 c4 = *reinterpret_cast<const float4*>(cur + at);
  const float4 u4 = *reinterpret_cast<const float4*>(cur + at - ld);
  const float4 d4 = *reinterpret_cast<const float4*>(cur + at + ld);
  const float4 f4 = *reinterpret_cast<const float4*>(sf + at);
  const float cc[6] = {cur[at - 1], c4.x, c4.y, c4.z, c4.w, cur[at + 4]};
  const float un[4] = {u4.x, u4.y, u4.z, u4.w}, dw[4] = {d4.x, d4.y, d4.z, d4.w};
  const float ff[4] = {f4.x, f4.y, f4.z, f4.w};
  float v[4], kept[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int gj = 4 * q + e;
    const bool in = row_in && gj >= 1 && gj <= n - 2;
    const float uc = cc[e + 1];
    const float nb = __fadd_rn(__fadd_rn(__fadd_rn(un[e], dw[e]), cc[e]), cc[e + 2]);
    v[e] = in ? jacobi_point(nb, uc, ff[e], h2, omega) : uc;
    const float term = GPU ? fabsf(__fsub_rn(v[e], uc))
                           : fabsf(residual_point(nb, uc, ff[e], inv_h2));
    kept[e] = in && !(cpu && ((gi + gj) & 1)) ? term : 0.0f;
  }
  const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(nxt + at) = v4;
  *reinterpret_cast<float4*>(terms + at) = make_float4(kept[0], kept[1], kept[2], kept[3]);
  if (li == 0 && push_up) *reinterpret_cast<float4*>(push_up + 4 * q) = v4;
  if (li + 1 == rows && push_dn) *reinterpret_cast<float4*>(push_dn + 4 * q) = v4;
}

struct ClusterTriggerArgs {
  const float* u;       // starting iterate (read only)
  const float* f;
  float* out;           // final iterate
  float* err_out;       // the final iterate's error
  int* sweeps_out;      // sweeps run
  int n, ld, err_mode, max_sweeps, slot;   // ld: a band row's floats; slot: a band's
  float h2, omega, inv_h2, err_scale, trigger;
};

// A band row: n floats padded to a multiple of 4, so every row of every slot
// starts 16-byte aligned.
static __host__ __device__ __forceinline__ int band_ld(int n) { return (n + 3) / 4 * 4; }

// Shared memory: f's band, three iterate slots (u_j in slot j mod 3) and the
// error terms of the pass, each rows + 2 rows of ld floats (the band's rows
// from row 1).
static inline size_t cluster_smem_bytes(int slot) {
  return 5 * (size_t)slot * sizeof(float);
}

// A pass in two steps. Every thread sweeps quads of four cells of the band
// (16-byte loads and stores) and writes their error terms beside them; after
// a block barrier, a group of 256 threads plays one tile block of legs.cuh's
// tile code (4 groups, the band's tiles in turn): its thread (x, y) adds the
// terms of the tile's cells in rows y + 8a, columns x + 32b in error_partial's
// order, and group_sum forms the tile's partial, which is pushed into every
// block's copy of the pass's partial array. Warp 31, whose tile work is the
// least, then sums the previous pass's partials and takes the stop
// decision, which every thread reads after the next barrier: the stop at
// sweep k is seen one pass later than it could be, with u_k still whole in
// the third slot. GPU: the gpu metric (else cpu or clean).
template <bool GPU>
static __global__ void __launch_bounds__(TAIL_THREADS, 1)
trigger_cluster_kernel(ClusterTriggerArgs a) {
  extern __shared__ __align__(16) float smem[];
  // every tile's partial of the last two passes (pass j's in parts[j & 1])
  __shared__ float parts[2][CLUSTER_MAX_TILES];
  __shared__ float warp_sums[TAIL_GROUPS][BLOCK_Y];
  // the decision taken in pass j: dec_err[j & 1], dec_go[j & 1]
  __shared__ float dec_err[2];
  __shared__ int dec_go[2];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int n = a.n, ld = a.ld, q = (int)cluster.block_rank();
  const bool multi = !tail_solo(n);
  if (!multi && q > 0) return;   // block 0 runs the level alone
  const int lo = trig_lo(n, q), hi = trig_lo(n, q + 1), rows = hi - lo;
  float* const sf = smem;
  float* const slots = smem + a.slot;
  float* const terms = smem + 4 * (size_t)a.slot;
  // u_0's band and the rows beside it (the halo rows, which the neighbours
  // push in later passes), f's band
  const int top = lo > 0 && rows > 0 ? 1 : 0, bot = hi < n && rows > 0 ? 1 : 0;
  for (int i = threadIdx.x - top * n; i < (rows + bot) * n; i += TAIL_THREADS) {
    const int li = (i + n) / n - 1, j = i - li * n;
    slots[(li + 1) * ld + j] = __ldcg(a.u + (ptrdiff_t)lo * n + i);
    if (li >= 0 && li < rows) sf[(li + 1) * ld + j] = __ldcg(a.f + (ptrdiff_t)lo * n + i);
  }

  const int g = threadIdx.x / THREADS, t = threadIdx.x % THREADS;
  const int x = t % BLOCK_X, y = t / BLOCK_X;
  const int tx_n = tiles_x(n), count = num_tiles(n);
  const int ty0 = lo / TILE_H, ty1 = (hi + TILE_H - 1) / TILE_H;
  const int tiles = rows > 0 ? (ty1 - ty0) * tx_n : 0;
  const bool cpu = a.err_mode == ERR_CPU;
  const unsigned lag = GPU ? 0u : 1u;   // the pass that measures u_k makes u_{k + lag}
  const bool decider = threadIdx.x / 32 == TAIL_THREADS / 32 - 1;   // warp 31
  // this thread's quads: (li, qd), stepped by TAIL_THREADS without a division
  const int quads = ld / 4, items = rows * quads;
  const int li0 = (int)threadIdx.x / quads, q0 = (int)threadIdx.x - li0 * quads;
  const int dli = TAIL_THREADS / quads, dq = TAIL_THREADS - dli * quads;

  float err = 0.0f, d1 = 0.0f, d0 = 0.0f;   // the decider's last error and slopes
  int k = 0;
  for (unsigned j = 0;; ++j) {
    // u_j complete everywhere, pass j − 1's partials pushed and decision
    // taken, every read of slot (j + 1) mod 3 and of parts[j & 1] done
    trig_sync(multi);
    if (j >= 2 + lag) {
      // the decision on sweep j − 1 − lag, taken in pass j − 1
      if (!dec_go[(j - 1) & 1]) {
        k = (int)(j - 1 - lag);
        err = dec_err[(j - 1) & 1];
        break;
      }
    }
    // pass j: u_j -> u_{j + 1}, with the terms of u_{j + 1 − lag}'s error
    // (pass 0's lagged terms, u_0's, are never read)
    const bool want = !lag || j > 0;
    const float* cur = slots + (size_t)(j % 3) * a.slot;
    float* nxt = slots + (size_t)((j + 1) % 3) * a.slot;
    // the neighbours' halo rows of nxt: block q − 1's below its band, block
    // q + 1's above
    float* push_up =
        top ? cluster.map_shared_rank(nxt, q - 1) + (size_t)(lo - trig_lo(n, q - 1) + 1) * ld
            : nullptr;
    float* push_dn = bot ? cluster.map_shared_rank(nxt, q + 1) : nullptr;
    for (int i = threadIdx.x, li = li0, qd = q0; i < items; i += TAIL_THREADS) {
      sweep_quad<GPU>(cur, nxt, sf, terms, push_up, push_dn, n, ld, lo, rows, li, qd, cpu, a.h2,
                      a.omega, a.inv_h2);
      li += dli;
      qd += dq;
      if (qd >= quads) {
        qd -= quads;
        ++li;
      }
    }
    __syncthreads();   // the pass's terms complete
    if (want) {
      for (int tl = g; tl < tiles; tl += TAIL_GROUPS) {
        const int ty = ty0 + tl / tx_n, tx = tl % tx_n;
        // the 16 terms loaded at once (a cell beyond the band reads the
        // band's first row and adds + 0), then added in order; a warp whose
        // rows all lie beyond the band adds nothing
        float acc = 0.0f;
        if (ty * TILE_H + y < hi) {
          float term[TILE_H / BLOCK_Y][TILE_W / BLOCK_X];
#pragma unroll
          for (int r = 0; r < TILE_H / BLOCK_Y; ++r)
#pragma unroll
            for (int c = 0; c < TILE_W / BLOCK_X; ++c) {
              const int gi = ty * TILE_H + y + BLOCK_Y * r, gj = tx * TILE_W + x + BLOCK_X * c;
              const bool here = gi < hi && gj < n;
              term[r][c] = terms[(here ? gi - lo + 1 : 1) * ld + (here ? gj : 0)];
              term[r][c] = here ? term[r][c] : 0.0f;
            }
#pragma unroll
          for (int r = 0; r < TILE_H / BLOCK_Y; ++r)
#pragma unroll
            for (int c = 0; c < TILE_W / BLOCK_X; ++c) acc = __fadd_rn(acc, term[r][c]);
        }
        // the partial, in every lane of the group's warp 0; lane r pushes it
        // to block r
        const float p = group_sum(acc, warp_sums[g], g);
        const int tile = ty * tx_n + tx;
        if (multi && t < TAIL_CTAS)
          cluster.map_shared_rank(&parts[j & 1][0], t)[tile] = p;
        else if (!multi && t == 0)
          parts[j & 1][tile] = p;
      }
    }
    if (decider && j >= 1 + lag) {
      // sweep j − lag's error, from pass j − 1's partials in
      // sum_partials_kernel's order (every block's copy the same, so every
      // block's decision)
      const float e = __fmul_rn(warp_block_sum(parts[(j - 1) & 1], count), a.err_scale);
      const bool go = trigger_goes_on((int)(j - lag) - 1, e, a.trigger, a.max_sweeps, err, d1, d0);
      if (threadIdx.x % 32 == 0) {
        dec_err[j & 1] = e;
        dec_go[j & 1] = go;
      }
    }
  }
  // u_k is whole in its slot; nothing reads another block's memory any more
  const float* fin = slots + (size_t)(k % 3) * a.slot;
  for (int i = threadIdx.x; i < rows * n; i += TAIL_THREADS) {
    const int li = i / n, j = i - li * n;
    a.out[(size_t)lo * n + i] = fin[(li + 1) * ld + j];
  }
  if (q == 0 && threadIdx.x == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// --- the tile loop -----------------------------------------------------------

struct TriggerArgs {
  const float* u;       // starting iterate (read only)
  const float* f;
  float* out;           // final iterate
  float* tmp;           // ping-pong partner of out
  float* partials;      // 2 * num_tiles(n) floats
  float* err_out;       // the final iterate's error
  int* sweeps_out;      // sweeps run
  int n, halo, err_mode, max_sweeps;
  float h2, omega, inv_h2, err_scale, trigger;
};

// A sweep at a time: every block sweeps its tiles (jacobi_tile with one
// sweep: the tile's error partial too), the grid meets, and every block sums
// the partials in the one-launch reduction's fixed order, so all blocks reach
// the same error and stop decision without another barrier. The iterate
// ping-pongs between out and tmp (copied into out when it lands in tmp); the
// partials alternate between two halves of their buffer, so a sweep never
// overwrites partials another block may still be summing.
static __global__ void __launch_bounds__(THREADS) trigger_kernel(TriggerArgs a) {
  extern __shared__ float smem[];
  __shared__ float err_now;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int tx = tiles_x(a.n), count = num_tiles(a.n);
  const float* src = a.u;
  float* dst = a.out;
  float err = 0.0f;
  int k = 0;
  for (;;) {
    float* part = a.partials + (k & 1) * count;
    for (int t = blockIdx.x; t < count; t += gridDim.x)
      jacobi_tile(smem, window(src, a.n), window(a.f, a.n), dst, part + t, t % tx, t / tx, a.n,
                  1, a.halo, 0, a.err_mode, a.h2, a.omega, a.inv_h2, 0.0f);
    grid.sync();  // dst and the partials complete
    const float total = fixed_sum(part, count);
    if (threadIdx.x == 0 && threadIdx.y == 0) err_now = __fmul_rn(total, a.err_scale);
    __syncthreads();
    const float e = err_now;
    ++k;
    // the slope test starts at sweep 2 (solver.trigger_loop)
    const bool above = k == 1 || fabsf(__fsub_rn(e, err)) > a.trigger;
    err = e;
    src = dst;
    dst = dst == a.out ? a.tmp : a.out;
    if (!(above && k < a.max_sweeps)) break;
  }
  if (src != a.out) {  // the final iterate is in tmp
    const size_t cells = (size_t)a.n * a.n;
    for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.y * BLOCK_X + threadIdx.x;
         i < cells; i += (size_t)gridDim.x * THREADS)
      a.out[i] = __ldcg(src + i);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0) {
    a.err_out[0] = err;
    a.sweeps_out[0] = k;
  }
}

// --- routing ------------------------------------------------------------------

enum TriggerRoute { ROUTE_RULE = 0, ROUTE_CLUSTER = 1, ROUTE_TILE = 2, ROUTE_WAVE = 3 };

// The wavefront's smallest level, in cells (3 · 2^19, the legs' rule too,
// descend.cu: between 1025²'s 1.05 M and 2049²'s 4.2 M).
constexpr long WAVE_MIN_CELLS = 3L << 19;

// The route of every later mg_trigger call, ROUTE_RULE: trigger_route's.
static int forced_route = ROUTE_RULE;

static inline int trigger_route(int n) {
  if (forced_route != ROUTE_RULE) return forced_route;
  if (n <= CLUSTER_MAX_N) return ROUTE_CLUSTER;
  return (long)n * n >= WAVE_MIN_CELLS ? ROUTE_WAVE : ROUTE_TILE;
}

static ClusterPlan cluster_plan[2];   // the cpu / clean and the gpu instance

// The route of every later mg_trigger call: 1 the cluster, 2 the tile loop,
// 3 the wavefront passes, 0 the size rule's again. All three are bit for bit
// the loop of one-sweep kernel 1 launches; a level above CHAIN_SPLIT sent to
// the cluster makes the call fail (its bands would not fit).
extern "C" int mg_trigger_force_route(int route) {
  if (route < ROUTE_RULE || route > ROUTE_WAVE) return (int)cudaErrorInvalidValue;
  forced_route = route;
  return 0;
}

// The trigger loop on u (not written) into out; tmp is an n x n scratch grid
// and partials as mg_trigger_stream takes them (both unused on the cluster;
// on the wavefront u, f, out and tmp start 16-byte aligned, else
// cudaErrorMisalignedAddress); err_mode as mg_jacobi (not ERR_NONE).
extern "C" int mg_trigger(const float* u, const float* f, float* out, float* tmp,
                          float* partials, float* err_out, int* sweeps_out, int n,
                          int err_mode, float h2, float omega, float inv_h2, float err_scale,
                          float trigger, int max_sweeps, void* stream) {
  if (n < 3 || err_mode <= ERR_NONE || err_mode > ERR_GPU || max_sweeps < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int route = trigger_route(n);
  if (route == ROUTE_WAVE) {
    WaveTriggerArgs w;
    const cudaError_t e = trigger_wave_args(u, f, out, tmp, partials, err_out, sweeps_out, n,
                                            err_mode, TRIG_BATCH, h2, omega, inv_h2, err_scale,
                                            trigger, max_sweeps, w);
    if (e != cudaSuccess) return (int)e;
    return (int)(err_mode == ERR_GPU
                     ? launch_wave_trigger<WV_GPU>(trigger_wave_kernel<WV_GPU>, w, s)
                     : launch_wave_trigger<WV_RES>(trigger_wave_kernel<WV_RES>, w, s));
  }
  if (route == ROUTE_TILE) {
    TriggerArgs a = {};
    a.u = u;
    a.f = f;
    a.out = out;
    a.tmp = tmp;
    a.partials = partials;
    a.err_out = err_out;
    a.sweeps_out = sweeps_out;
    a.n = n;
    a.halo = jacobi_halo(1, err_mode);
    a.err_mode = err_mode;
    a.max_sweeps = max_sweeps;
    a.h2 = h2;
    a.omega = omega;
    a.inv_h2 = inv_h2;
    a.err_scale = err_scale;
    a.trigger = trigger;
    return (int)launch_persistent(trigger_kernel, a, tile_smem_bytes(a.halo), num_tiles(n), s);
  }
  if (n > CLUSTER_MAX_N) return (int)cudaErrorInvalidValue;
  ClusterTriggerArgs a = {};
  a.u = u;
  a.f = f;
  a.out = out;
  a.err_out = err_out;
  a.sweeps_out = sweeps_out;
  a.n = n;
  a.err_mode = err_mode;
  a.max_sweeps = max_sweeps;
  int rows = 0;
  for (int q = 0; q < TAIL_CTAS; ++q) {
    const int r = trig_lo(n, q + 1) - trig_lo(n, q);
    rows = r > rows ? r : rows;
  }
  a.ld = band_ld(n);
  a.slot = (rows + 2) * a.ld;
  a.h2 = h2;
  a.omega = omega;
  a.inv_h2 = inv_h2;
  a.err_scale = err_scale;
  a.trigger = trigger;
  const bool gpu = err_mode == ERR_GPU;
  return (int)launch_tail(gpu ? trigger_cluster_kernel<true> : trigger_cluster_kernel<false>,
                          cluster_plan[gpu ? 1 : 0], a, cluster_smem_bytes(a.slot), s);
}
