// Shared pieces of the 3-D ring kernels (rdma_jacobi3.cu, rdma_descend3.cu,
// rdma_ascend3.cu, rdma_trigger3.cu): one launch runs every z-shard of a
// sharded n^3 level, with the tag, flag and launch protocol of ring.cuh, and
// each block walks its shard's tiles with the pipeline of legs3.cuh in ring
// mode (run_leg3_at with RING: a plane comes from the shard's own block or
// from a receive buffer), so the owned planes and the error partials are
// those of the shard-mode launch on extended windows, bit for bit.
//
// What a shard owns in the workspace (ops/rdma3.py allocates it once per
// device, shard count and n, zeroed; Ring3 holds its base pointers):
//   * receive buffers of u: per parity and side (0: the planes above its
//     block, 1: the planes below), RING3_HALO planes of n^2;
//   * receive buffers of f: per side, RING3_HALO planes;
//   * receive buffers of the ascend leg's coarse correction: per side,
//     RING3_HALO planes of m^2, m = (n + 1) / 2;
//   * error slots: per parity and per sender, one raw float64 error sum;
//   * flags: one 64-bit tag per sender; arrival counts of its own blocks
//     (two: the first post, then the sweeps or the pass's error).
//
// A shard's window is halo planes a side (the leg's pipeline halo, at most
// RING3_HALO). Blocks may be shallower than that (the port's split gives
// the last shard the remainder and JAX's planes per device can exceed a
// block), so a window may span several shards: every sender posts to every
// shard whose window meets its block, and a receiver waits for each of
// them. The coarse correction is split like the fine level, shard s owning
// coarse planes [z0 / 2, (z1 + 1) / 2) of its block [z0, z1); its window is
// the coarse planes the staged fine planes interpolate from.
#pragma once

#include "legs3.cuh"
#include "ring.cuh"

namespace mgk3 {

constexpr int MAX_SHARDS3 = 16;

// A ring of z-shards and its workspace.
struct Ring3 {
  int z0[MAX_SHARDS3 + 1];  // shard s owns planes [z0[s], z0[s + 1])
  int shards, n;
  float* ubuf;
  float* fbuf;
  float* cbuf;
  double* err;                 // [receiver][parity][sender]
  unsigned long long* flags;   // [receiver][sender]
  unsigned int* count;         // [2][shard]
};

static __host__ __device__ __forceinline__ size_t plane3(int n) { return (size_t)n * n; }

static __host__ __device__ __forceinline__ float* ubuf3(const Ring3& W, int s, int par,
                                                        int side) {
  return W.ubuf + (((size_t)s * 2 + par) * 2 + side) * RING3_HALO * plane3(W.n);
}

static __host__ __device__ __forceinline__ float* fbuf3(const Ring3& W, int s, int side) {
  return W.fbuf + ((size_t)s * 2 + side) * RING3_HALO * plane3(W.n);
}

static __host__ __device__ __forceinline__ float* cbuf3(const Ring3& W, int s, int side) {
  return W.cbuf + ((size_t)s * 2 + side) * RING3_HALO * plane3((W.n + 1) / 2);
}

// The coarse planes shard s owns, [cz0, cz1).
static __host__ __device__ __forceinline__ int cz0_of(const Ring3& W, int s) {
  return W.z0[s] / 2;
}
static __host__ __device__ __forceinline__ int cz1_of(const Ring3& W, int s) {
  return (W.z0[s + 1] + 1) / 2;
}

// Shard r's windows, planes [lo, hi): fine (side 0 above its block, 1 below)
// and coarse (the planes the staged interior planes interpolate from).
struct PlaneRange {
  int lo, hi;
};

static __host__ __device__ __forceinline__ PlaneRange fine_window(const Ring3& W, int r,
                                                                  int side, int halo) {
  return side == 0 ? PlaneRange{W.z0[r] - halo, W.z0[r]}
                   : PlaneRange{W.z0[r + 1], W.z0[r + 1] + halo};
}

static __host__ __device__ __forceinline__ PlaneRange coarse_window(const Ring3& W, int r,
                                                                    int side, int halo) {
  const int m = (W.n + 1) / 2;
  if (side == 0) {
    const int lo = W.z0[r] - halo > 0 ? W.z0[r] - halo : 0;
    return PlaneRange{lo >> 1, cz0_of(W, r)};
  }
  const int hi = ((W.z0[r + 1] + halo) >> 1) + 1;
  return PlaneRange{cz1_of(W, r), hi < m ? hi : m};
}

static __host__ __device__ __forceinline__ PlaneRange meet(PlaneRange a, int lo, int hi) {
  return PlaneRange{a.lo > lo ? a.lo : lo, a.hi < hi ? a.hi : hi};
}

// Whether shard r's windows take planes of shard s's blocks.
static __device__ bool reads_from(const Ring3& W, int r, int s, int halo, bool coarse) {
  for (int side = 0; side < 2; ++side) {
    const PlaneRange f = meet(fine_window(W, r, side, halo), W.z0[s], W.z0[s + 1]);
    if (f.lo < f.hi) return true;
    if (coarse) {
      const PlaneRange c = meet(coarse_window(W, r, side, halo), cz0_of(W, s), cz1_of(W, s));
      if (c.lo < c.hi) return true;
    }
  }
  return false;
}

// Thread (0, 0) waits for the tag of every shard whose blocks shard s's
// windows take; then the block reads the receive buffers.
static __device__ void wait_senders(const Ring3& W, int s, int halo, bool coarse,
                                    unsigned long long tag) {
  if (threadIdx.x == 0 && threadIdx.y == 0)
    for (int d = 0; d < W.shards; ++d)
      if (d != s && reads_from(W, s, d, halo, coarse))
        mgk::spin_until(W.flags + (size_t)s * W.shards + d, tag);
  __syncthreads();
}

// Copy `count` floats, the work split over the nb blocks of a shard.
static __device__ void copy_floats(float* __restrict__ dst, const float* src, size_t count, int lb,
                                   int nb) {
  for (size_t i = (size_t)lb * THREADS3 + threadIdx.y * BLOCK_X + threadIdx.x; i < count;
       i += (size_t)nb * THREADS3)
    dst[i] = __ldcg(src + i);
}

// Post the planes of src (planes [b0, b1) of a level whose planes are `pl`
// floats) that shard r's window `win` takes into r's buffer, which holds the
// planes from `origin` on.
static __device__ void post_span(float* buf, int origin, const float* src, int b0, int b1,
                                 PlaneRange win, size_t pl, int lb, int nb) {
  const PlaneRange x = meet(win, b0, b1);
  if (x.lo < x.hi)
    copy_floats(buf + (size_t)(x.lo - origin) * pl, src + (size_t)(x.lo - b0) * pl,
                (size_t)(x.hi - x.lo) * pl, lb, nb);
}

// Shard s's blocks post their inputs to every other shard's windows: u (into
// the parity `par` buffers; skipped when null), f, and the coarse correction
// c (skipped when null). Split over the shard's nb blocks.
static __device__ void post_inputs(const Ring3& W, int s, const float* u, const float* f,
                                   const float* c, int halo, int par, int lb, int nb) {
  const int n = W.n, m = (n + 1) / 2;
  for (int r = 0; r < W.shards; ++r) {
    if (r == s) continue;
    for (int side = 0; side < 2; ++side) {
      const PlaneRange win = fine_window(W, r, side, halo);
      const int origin = side == 0 ? W.z0[r] - RING3_HALO : W.z0[r + 1];
      if (u != nullptr)
        post_span(ubuf3(W, r, par, side), origin, u, W.z0[s], W.z0[s + 1], win, plane3(n), lb, nb);
      post_span(fbuf3(W, r, side), origin, f, W.z0[s], W.z0[s + 1], win, plane3(n), lb, nb);
      if (c != nullptr) {
        const int corigin = side == 0 ? cz0_of(W, r) - RING3_HALO : cz1_of(W, r);
        post_span(cbuf3(W, r, side), corigin, c, cz0_of(W, s), cz1_of(W, s),
                  coarse_window(W, r, side, halo), plane3(m), lb, nb);
      }
    }
  }
}

// Shard s's ring source: its blocks, and its receive buffers (u of parity par).
static __device__ RingSrc3 ring_src3(const Ring3& W, int s, int par, const float* u,
                                     const float* f, const float* c) {
  RingSrc3 R;
  R.own[0] = u;
  R.own[1] = f;
  R.top[0] = ubuf3(W, s, par, 0);
  R.top[1] = fbuf3(W, s, 0);
  R.bot[0] = ubuf3(W, s, par, 1);
  R.bot[1] = fbuf3(W, s, 1);
  R.cown = c;
  R.ctop = W.cbuf != nullptr ? cbuf3(W, s, 0) : nullptr;
  R.cbot = W.cbuf != nullptr ? cbuf3(W, s, 1) : nullptr;
  R.cz0 = cz0_of(W, s);
  R.cz1 = cz1_of(W, s);
  return R;
}

// Whether tile b of shard s (z chunks of L.cz planes) stages a plane of
// another shard.
static __device__ __forceinline__ bool tile_reads_ring(const Ring3& W, int s, const Leg3& L,
                                                       const Blk& b) {
  const int z0 = W.z0[s], z1 = W.z0[s + 1];
  const int c0 = z0 + b.z * L.cz, c1 = c0 + L.cz < z1 ? c0 + L.cz : z1;
  return (c0 - L.halo < z0 && z0 > 0) || (c1 + L.halo > z1 && z1 < W.n);
}

// The leg of shard s as every ring kernel sets it up: its blocks, its tile
// plan's z chunk, its partials.
struct ShardLeg3 {
  Leg3 L;
  Planes3 P;
  int count;  // tiles of the shard
};

static __device__ __forceinline__ ShardLeg3 shard_leg3(const Leg3& base, const Ring3& W, int s,
                                                       int cz, double* partials) {
  ShardLeg3 x;
  x.L = base;
  x.L.cz = cz;
  x.L.partials = partials;
  x.P = Planes3{W.z0[s], W.z0[s + 1] - W.z0[s], base.halo, 0, 0};
  x.count = leg3_blocks(x.L, x.P.nz);
  return x;
}

// One pass of a leg over the ring (kernels 20-22): post the inputs, release
// this shard's tag, run the tiles that stage no other shard's plane, wait
// for the senders, run the others; then the last block of the shard sums
// its tile partials in the one-launch reduction's order into raw[s].
struct RingLeg3Args {
  Leg3 L;                          // the leg; per-shard pointers below
  Ring3 W;
  const float* u[MAX_SHARDS3];     // shard blocks (unread when L.u is null: from zero)
  const float* f[MAX_SHARDS3];
  const float* c[MAX_SHARDS3];     // ascend: the shard's coarse planes [cz0, cz1)
  float* out[MAX_SHARDS3];
  float* fc[MAX_SHARDS3];          // descend: the shard's coarse planes from z0 / 2
  int cz[MAX_SHARDS3];             // z chunk of shard s's tile plan
  int part0[MAX_SHARDS3 + 1];      // shard s's partials from part0[s]
  double* partials;                // or null: no error
  double* raw;                     // raw[s]: shard s's raw error sum
  unsigned long long tag;
  int blocks_per_shard;
};

template <bool COARSE>
static __device__ void ring_leg3(const RingLeg3Args& a, float* smem) {
  const int s = blockIdx.x / a.blocks_per_shard, lb = blockIdx.x % a.blocks_per_shard;
  const int nb = a.blocks_per_shard;
  const Ring3& W = a.W;
  const int P = W.shards, par = (int)(a.tag & 1);
  ShardLeg3 x = shard_leg3(a.L, W, s, a.cz[s],
                           a.partials != nullptr ? a.partials + a.part0[s] : nullptr);
  Leg3& L = x.L;
  if (a.L.u != nullptr) L.u = a.u[s];
  L.f = a.f[s];
  L.c = COARSE ? a.c[s] : nullptr;
  L.out = a.out[s];
  L.fc = a.fc[s];

  post_inputs(W, s, L.u, L.f, L.c, L.halo, par, lb, nb);
  if (mgk::arrive_last(W.count + s, nb) && threadIdx.x == 0 && threadIdx.y == 0)
    for (int r = 0; r < P; ++r)
      if (r != s) mgk::release_tag(W.flags + (size_t)r * P + s, a.tag);

  const RingSrc3 R = ring_src3(W, s, par, L.u, L.f, L.c);
  bool ready = false;
  for (int pass = 0; pass < 2; ++pass) {  // tiles within the shard, then the others
    for (int t = lb; t < x.count; t += nb) {
      const Blk b = leg3_blk(L, t);
      const bool ring = tile_reads_ring(W, s, L, b);
      if (ring != (pass == 1)) continue;
      if (ring && !ready) {
        wait_senders(W, s, L.halo, COARSE, a.tag);
        ready = true;
      }
      run_leg3_at<1, false, true, false, true>(smem, L, x.P, b, &R);
    }
  }
  if (L.partials != nullptr && mgk::arrive_last(W.count + P + s, nb)) {
    const double total = fixed_sum3(L.partials, x.count);
    if (threadIdx.x == 0 && threadIdx.y == 0) a.raw[s] = total;
  }
}

// Host side: fill the ring from the C interface's arrays and validate every
// shard's leg (check_leg3 over its planes, its windows no deeper than the
// buffers). z0s has shards + 1 entries; ws the workspace (ubuf, fbuf, cbuf,
// err, flags, count).
static inline cudaError_t ring3_setup(Ring3& W, const int* z0s, int shards, int n,
                                      const unsigned long long* ws) {
  if (shards < 1 || shards > MAX_SHARDS3 || n < 3 || z0s[0] != 0 || z0s[shards] != n)
    return cudaErrorInvalidValue;
  for (int s = 0; s <= shards; ++s) {
    if (s < shards && z0s[s + 1] <= z0s[s]) return cudaErrorInvalidValue;
    W.z0[s] = z0s[s];
  }
  W.shards = shards;
  W.n = n;
  W.ubuf = (float*)ws[0];
  W.fbuf = (float*)ws[1];
  W.cbuf = (float*)ws[2];
  W.err = (double*)ws[3];
  W.flags = (unsigned long long*)ws[4];
  W.count = (unsigned int*)ws[5];
  return cudaSuccess;
}

// Validate shard s's leg (tile plan z chunk cz) as check_leg3 does a shard
// launch with a window of L.halo planes, its coarse window included.
static inline cudaError_t check_ring_leg3(const Leg3& base, const Ring3& W, int s, int cz) {
  Leg3 L = base;
  L.cz = cz;
  Planes3 P{W.z0[s], W.z0[s + 1] - W.z0[s], L.halo, 0, 0};
  if (L.halo > RING3_HALO) return cudaErrorInvalidValue;
  if (L.c != nullptr) {
    const PlaneRange top = coarse_window(W, s, 0, L.halo), bot = coarse_window(W, s, 1, L.halo);
    if (cz0_of(W, s) - top.lo > RING3_HALO || bot.hi - cz1_of(W, s) > RING3_HALO)
      return cudaErrorInvalidValue;
    P.cz0 = top.lo;
    P.cnz = bot.hi - top.lo;
  }
  return check_leg3(L, P);
}

// Validate every shard's leg (z chunk czs[s]) and lay out its tile plan:
// cz[s], its partials from part0[s] (part0[shards]: the total). Returns the
// largest shard's tile count, or -1 when a shard's leg is invalid.
static inline int ring_plans3(const Leg3& base, const Ring3& W, const int* czs, int* cz,
                              int* part0) {
  int max_tiles = 0, total = 0;
  for (int s = 0; s < W.shards; ++s) {
    if (check_ring_leg3(base, W, s, czs[s]) != cudaSuccess) return -1;
    Leg3 L = base;
    L.cz = czs[s];
    const int t = leg3_blocks(L, W.z0[s + 1] - W.z0[s]);
    cz[s] = czs[s];
    part0[s] = total;
    total += t;
    max_tiles = t > max_tiles ? t : max_tiles;
  }
  part0[W.shards] = total;
  return max_tiles;
}

// Launch a ring pass of the legs (RingLeg3Args with L, W, the shard
// pointers, raw and tag set) with tile plans czs and the partials buffer.
template <typename Kernel>
static inline cudaError_t launch_ring_leg3(Kernel kernel, RingLeg3Args& a, const int* czs,
                                           double* partials, cudaStream_t stream) {
  const int max_tiles = ring_plans3(a.L, a.W, czs, a.cz, a.part0);
  if (max_tiles < 0) return cudaErrorInvalidValue;
  a.partials = partials;
  return mgk::launch_ring(kernel, a, leg3_smem(leg3_stages(a.L), a.L.halo, a.L.ty, a.L.tx),
                          a.W.shards, max_tiles, stream, dim3(BLOCK_X, BLOCK3_Y));
}

}  // namespace mgk3
