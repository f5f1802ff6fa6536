// 5-point residual r = (Σnb − 4u)/h² − f on the interior, 0 elsewhere,
// optionally negated.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _residual_kernel, reached through residual_pallas.
//
// Bound: device-memory bandwidth, one pass that reads u and f and writes r
// (12 B per point). Design: each block stages its 32 x 128 tile of u with a
// one-cell halo in shared memory, so every u value is read from device memory
// about once (1.08x for the halo); f and r are streamed once, coalesced.
//
// Shard mode (_residual_shard_call, reached through parallel/pallas_shard.py's
// sharded_residual_pallas): the residual of one shard's block, u and f
// extended by the ring neighbours' halo rows (and columns); masks by global
// index; r laid out as the block. mg_residual_shard launches it for one
// shard; mg_residual_shards (residual_shards_kernel) for every shard of a
// level on one card in one launch: the blocks walk the shards' tiles as one
// flat index (shard s's tiles from tile0[s]), each running the same tile
// body, so r is bit for bit one launch a shard's. A level's residual was a
// launch a shard, each a few µs of latency on a grid too small to fill the
// card (8 of them at 4097² on 8 row shards left tail waves).
#include "legs.cuh"

using namespace mgk;

// Tile (tx, ty) of the residual of region<SHARD>(g_): the tile of u with a
// one-cell halo staged in smem, f and r streamed. BATCHED (the batched
// launch, whose small levels are one wave of tiles and so one tile's serial
// latency): u staged with every load of a batch in flight
// (load_tile_batched) and a thread's 16 values of f loaded before any is
// used; the arithmetic is the same.
template <bool SHARD, bool BATCHED = false>
static __device__ __forceinline__ void residual_tile(float* smem, const float* __restrict__ u_,
                                                     const float* __restrict__ f_,
                                                     float* __restrict__ r, const Geo& g_,
                                                     int ext_r, int ext_c, float inv_h2,
                                                     int negate, int tx, int ty) {
  const Geo g = region<SHARD>(g_);
  const Win u = region<SHARD>(u_, g, ext_r, ext_c), f = region<SHARD>(f_, g, ext_r, ext_c);
  const int n = g.n;
  const Tile t = make_tile(g, 1, tx, ty);
  if constexpr (BATCHED) {
    constexpr int RI = TILE_H / BLOCK_Y, CJ = TILE_W / BLOCK_X;   // a thread's cells
    float fv[RI][CJ];
#pragma unroll
    for (int a = 0; a < RI; ++a)
#pragma unroll
      for (int b = 0; b < CJ; ++b) {
        const int gi = t.gr0 + 1 + threadIdx.y + a * BLOCK_Y;
        const int gj = t.gc0 + 1 + threadIdx.x + b * BLOCK_X;
        fv[a][b] = owned(g, gi, gj) && interior(gi, gj, n)
                       ? f.p[(ptrdiff_t)(gi - f.r0) * f.cols + (gj - f.c0)] : 0.0f;
      }
    load_tile_batched(smem, u, n, t);
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RI; ++a)
#pragma unroll
      for (int b = 0; b < CJ; ++b) {
        const int i = 1 + threadIdx.y + a * BLOCK_Y, j = 1 + threadIdx.x + b * BLOCK_X;
        const int gi = t.gr0 + i, gj = t.gc0 + j;
        if (!owned(g, gi, gj)) continue;
        float v = 0.0f;
        if (interior(gi, gj, n)) {
          v = residual_point(nb_sum(smem, t.cols, i, j), smem[i * t.cols + j], fv[a][b], inv_h2);
          if (negate) v = -v;
        }
        r[out_at(g, gi, gj)] = v;
      }
  } else {
    load_tile(smem, u, n, t);
    __syncthreads();
    for (int i = 1 + threadIdx.y; i < 1 + TILE_H; i += BLOCK_Y) {
      const int gi = t.gr0 + i;
      for (int j = 1 + threadIdx.x; j < 1 + TILE_W; j += BLOCK_X) {
        const int gj = t.gc0 + j;
        if (!owned(g, gi, gj)) continue;
        float v = 0.0f;
        if (interior(gi, gj, n)) {
          v = residual_point(nb_sum(smem, t.cols, i, j), smem[i * t.cols + j],
                             f.p[(ptrdiff_t)(gi - f.r0) * f.cols + (gj - f.c0)], inv_h2);
          if (negate) v = -v;
        }
        r[out_at(g, gi, gj)] = v;
      }
    }
  }
}

template <bool SHARD>
static __global__ void __launch_bounds__(THREADS)
residual_kernel(const float* __restrict__ u_, const float* __restrict__ f_,
                float* __restrict__ r, Geo g_, int ext_r, int ext_c, float inv_h2, int negate) {
  extern __shared__ float smem[];
  residual_tile<SHARD>(smem, u_, f_, r, g_, ext_r, ext_c, inv_h2, negate, blockIdx.x,
                       blockIdx.y);
}

// The shards of one launch of residual_shards_kernel: each one's windows,
// output and block (row0, col0, rows, cols), its first flat tile, and what
// they share (n, the halo, 1/h², negate).
constexpr int MAX_BATCH = 16;

struct ResidualShards {
  const float* u[MAX_BATCH];
  const float* f[MAX_BATCH];
  float* r[MAX_BATCH];
  int row0[MAX_BATCH], col0[MAX_BATCH], rows[MAX_BATCH], cols[MAX_BATCH];
  int tile0[MAX_BATCH + 1];   // shard s's tiles are flat tiles [tile0[s], tile0[s + 1])
  int shards, n, ext_r, ext_c, negate;
  float inv_h2;
};

static __global__ void __launch_bounds__(THREADS) residual_shards_kernel(ResidualShards a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  int s = 0;
  while (b >= a.tile0[s + 1]) ++s;   // uniform across the block
  const Geo g(a.n, a.row0[s], a.col0[s], a.rows[s], a.cols[s]);
  const int t = b - a.tile0[s], tx_n = tiles_x(g);
  residual_tile<true, true>(smem, a.u[s], a.f[s], a.r[s], g, a.ext_r, a.ext_c, a.inv_h2,
                            a.negate, t % tx_n, t / tx_n);
}

static bool bad_block(int n, int row0, int col0, int rows, int cols, int ext_r, int ext_c) {
  return n < 3 || rows < 1 || cols < 1 || row0 < 0 || col0 < 0 || row0 + rows > n ||
         col0 + cols > n || ext_r < 0 || ext_c < 0;
}

// The residual of the rows x cols block at global (row0, col0) into r (laid
// out as the block); u and f are the block extended by ext_r rows and ext_c
// columns per side (ext >= 1 where the block has a neighbour).
extern "C" int mg_residual_shard(const float* u, const float* f, float* r, int n, int row0,
                                 int col0, int rows, int cols, int ext_r, int ext_c,
                                 float inv_h2, int negate, void* stream) {
  if (bad_block(n, row0, col0, rows, cols, ext_r, ext_c)) return (int)cudaErrorInvalidValue;
  const Geo g(n, row0, col0, rows, cols);
  const size_t smem = tile_floats(1) * sizeof(float);
  const auto kernel =
      whole_grid(g, ext_r, ext_c) ? residual_kernel<false> : residual_kernel<true>;
  kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), smem, (cudaStream_t)stream>>>(
      u, f, r, g, ext_r, ext_c, inv_h2, negate);
  return (int)cudaGetLastError();
}

// The residual of `shards` <= MAX_BATCH blocks of one n x n level in one
// launch: block s is rows rows[s] x cols[s] at global (row0s[s], col0s[s]),
// its windows u_ptrs[s] and f_ptrs[s] extended by ext_r rows and ext_c
// columns per side (as mg_residual_shard's), its output r_ptrs[s].
extern "C" int mg_residual_shards(const unsigned long long* u_ptrs,
                                  const unsigned long long* f_ptrs,
                                  const unsigned long long* r_ptrs, const int* row0s,
                                  const int* col0s, const int* rows, const int* cols,
                                  int shards, int n, int ext_r, int ext_c, float inv_h2,
                                  int negate, void* stream) {
  if (shards < 1 || shards > MAX_BATCH) return (int)cudaErrorInvalidValue;
  ResidualShards a = {};
  int tiles = 0;
  for (int s = 0; s < shards; ++s) {
    if (bad_block(n, row0s[s], col0s[s], rows[s], cols[s], ext_r, ext_c))
      return (int)cudaErrorInvalidValue;
    a.u[s] = (const float*)u_ptrs[s];
    a.f[s] = (const float*)f_ptrs[s];
    a.r[s] = (float*)r_ptrs[s];
    a.row0[s] = row0s[s];
    a.col0[s] = col0s[s];
    a.rows[s] = rows[s];
    a.cols[s] = cols[s];
    a.tile0[s] = tiles;
    tiles += num_tiles(Geo(n, row0s[s], col0s[s], rows[s], cols[s]));
  }
  for (int s = shards; s <= MAX_BATCH; ++s) a.tile0[s] = tiles;
  a.shards = shards;
  a.n = n;
  a.ext_r = ext_r;
  a.ext_c = ext_c;
  a.negate = negate;
  a.inv_h2 = inv_h2;
  residual_shards_kernel<<<dim3(tiles), dim3(BLOCK_X, BLOCK_Y), tile_floats(1) * sizeof(float),
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mg_residual(const float* u, const float* f, float* r, int n, float inv_h2,
                           int negate, void* stream) {
  return mg_residual_shard(u, f, r, n, 0, 0, n, n, 0, 0, inv_h2, negate, stream);
}
