// Shared pieces of the 3-D ring kernels (rdma_jacobi3.cu, rdma_descend3.cu,
// rdma_ascend3.cu, rdma_trigger3.cu): one launch runs every z-shard of a
// sharded n^3 level, with the tag, flag and launch protocol of ring.cuh.
// Kernel 19 runs col3.cuh's column pass over the receive buffers in one
// persistent launch (rdma_trigger3.cu); kernels 20, 21 and 22 post their
// halos once and then run their shard modes' column passes on each shard,
// a launch a pass (RingCol3 below). Owned planes and error partials are
// those of the shard-mode launches on extended windows, bit for bit.
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
// A shard's window is halo planes a side (at most RING3_HALO). Blocks may be
// shallower than that (the port's split gives the last shard the remainder
// and JAX's planes per device can exceed a block), so a window may span
// several shards: every sender posts to every shard whose window meets its
// block, and a receiver waits for each of them. The coarse correction is
// split like the fine level, shard s owning coarse planes [z0 / 2, (z1 + 1)
// / 2) of its block [z0, z1); its window is the coarse planes the window's
// fine planes interpolate from.
#pragma once

#include "col3_legs.cuh"
#include "ring.cuh"

namespace mgk3 {

constexpr int MAX_SHARDS3 = 16;
// The planes a receive buffer holds a side.
constexpr int RING3_HALO = MAX_HALO3;

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

// Copy `count` floats, the work split over the nb blocks of a shard (blocks
// of COL3_THREADS threads).
static __device__ void copy_floats(float* __restrict__ dst, const float* src, size_t count, int lb,
                                   int nb) {
  for (size_t i = (size_t)lb * COL3_THREADS + threadIdx.x; i < count;
       i += (size_t)nb * COL3_THREADS)
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
        post_span(ubuf3(W, r, par, side), origin, u, W.z0[s], W.z0[s + 1], win, plane3(n), lb,
                  nb);
      post_span(fbuf3(W, r, side), origin, f, W.z0[s], W.z0[s + 1], win, plane3(n), lb, nb);
      if (c != nullptr) {
        const int corigin = side == 0 ? cz0_of(W, r) - RING3_HALO : cz1_of(W, r);
        post_span(cbuf3(W, r, side), corigin, c, cz0_of(W, s), cz1_of(W, s),
                  coarse_window(W, r, side, halo), plane3(m), lb, nb);
      }
    }
  }
}

// Host side: fill the ring from the C interface's arrays. z0s has shards + 1
// entries; ws the workspace (ubuf, fbuf, cbuf, err, flags, count).
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

// A 2:1 leg's ring: every shard's origin even, so that a fine plane's
// parity is its global one.
static inline bool ring_even3(const Ring3& W) {
  for (int s = 0; s < W.shards; ++s)
    if (W.z0[s] % 2) return false;
  return true;
}

// --- Kernels 20, 21 and 22: one post, then column passes ---
//
// A call posts the planes of its inputs that the neighbours' windows take
// (u and f; the ascend leg also the coarse correction; from zero no u) into
// their receive buffers and releases its tag (a launch of its own,
// ring_post3_kernel); the first pass waits for the senders. From then on
// every pass is shard-local: each shard runs its shard mode's column passes
// (jacobi3.cu's, descend3.cu's, ascend3.cu's: col3_unit_io and the bodies
// of col3_legs.cuh), reading a plane of the inputs from its block or from a
// receive buffer (ring_vol3) and the iterates from two scratch windows of
// its own (planes [z0 − depth, z1 + depth)), so its owned planes, coarse
// planes and tile partials are those of the shard mode on windows of
// `depth` planes, bit for bit, with the same tile plan; ring_raw3_kernel
// sums each shard's partials in fixed_sum3's order into raw[s]. A pass is
// one launch over every shard (blockIdx.y the shard), as the shard mode's
// passes are, so a pass reads the planes the one before wrote through L1:
// one cooperative launch with a barrier per shard between the passes, its
// loads through L2, took 8.17 ms against 5.56 for the descend leg at 513³
// on 8 z-shards of an H100 (PERF.md).
struct RingCol3 {
  Ring3 W;
  Col3 C[MAX_SHARDS3];          // shard s: planes (ext = depth), tile plan, workspace
  const float* u[MAX_SHARDS3];  // shard blocks (nullptr: from zero)
  const float* f[MAX_SHARDS3];
  const float* c[MAX_SHARDS3];  // ascend: the shard's coarse planes [cz0, cz1)
  float* out[MAX_SHARDS3];
  float* wa[MAX_SHARDS3];       // scratch windows, planes [z0 − depth, z1 + depth)
  float* wb[MAX_SHARDS3];
  float* s[MAX_SHARDS3];        // descend: the restriction's z steps from coarse plane z0 / 2
  float* fc[MAX_SHARDS3];       // descend: the shard's coarse planes from z0 / 2
  int part0[MAX_SHARDS3 + 1];   // shard s's tile partials from part0[s]
  double* partials;             // or nullptr: no error
  unsigned long long tag;       // the post's
  int steps, mode, tail, depth; // the sweeps (col3_schedule's k, error mode and tail)
  int fw;                       // descend: full weighting (else sampling)
  int wait;                     // this launch is the first pass: wait for the senders
};

// A shard's input planes (its block `own`, planes [z0, z1), and its receive
// buffers top and bot of planes `pl` floats) as a Vol3.
static __device__ __forceinline__ Vol3 ring_vol3(const float* own, const float* top,
                                                 const float* bot, int z0, int z1, size_t pl) {
  const ptrdiff_t p = (ptrdiff_t)pl;
  return Vol3{top - (z0 - RING3_HALO) * p, own - z0 * p, bot - z1 * p, z0, z1};
}

// f of shard s as its passes read it.
static __device__ __forceinline__ Vol3 ring_f3(const RingCol3& a, int s) {
  const Ring3& W = a.W;
  return ring_vol3(a.f[s], fbuf3(W, s, 0), fbuf3(W, s, 1), W.z0[s], W.z0[s + 1], plane3(W.n));
}

// A scratch window of shard s, offset so that plane z is at z · pl.
static __device__ __forceinline__ float* ring_window(const RingCol3& a, float* w, int s) {
  return w - (ptrdiff_t)(a.W.z0[s] - a.depth) * (ptrdiff_t)plane3(a.W.n);
}

// Whether a sweep's unit `unit` of shard s reads only planes of its own
// block: its z chunk [e0, e1) and one plane a side within [z0, z1). Such a
// unit takes its planes from the block alone (Col3Io), without the choice of
// place per plane (the window sweeps 1.14 → 1.10 ms at 513³ on 8 z-shards
// of an H100); the others also read receive buffers or halo planes.
static __device__ __forceinline__ bool ring_inner_unit(const Col3& C, int unit) {
  const int bz = unit / COL3_QUARTERS / (col3_gx(C) * col3_gy(C));
  const int e0 = C.z0 + bz * C.cz, e1 = min(e0 + C.cz, C.z0 + C.nz);
  return e0 > C.z0 && e1 < C.z0 + C.nz;
}

// The first pass waits for the shard's senders in each block that reads a
// receive buffer (block-uniform `halo`).
static __device__ __forceinline__ void ring_wait(const RingCol3& a, int s, bool halo,
                                                 bool coarse) {
  if (a.wait && halo) wait_senders(a.W, s, a.depth, coarse, a.tag);
}

// The post: shard blockIdx.y's blocks copy the planes of its inputs that
// the other shards' windows take into their receive buffers (coarse: the
// ascend leg's correction too), and the last of them releases the tag.
static __global__ void __launch_bounds__(COL3_THREADS) ring_post3_kernel(RingCol3 a,
                                                                         int coarse) {
  const int s = blockIdx.y, lb = blockIdx.x, nb = gridDim.x, P = a.W.shards;
  post_inputs(a.W, s, a.u[s], a.f[s], coarse ? a.c[s] : nullptr, a.depth, (int)(a.tag & 1), lb,
              nb);
  __threadfence();
  if (mgk::arrive_last(a.W.count + s, nb) && threadIdx.x == 0)
    for (int r = 0; r < P; ++r)
      if (r != s) mgk::release_tag(a.W.flags + (size_t)r * P + s, a.tag);
}

// Sweep j of col3_schedule's a.steps on shard blockIdx.y (unit blockIdx.x):
// from the shard's input (INPUT: its block and receive buffers), from u ≡ 0
// (ZERO), or from a scratch window, into the windows and the owned planes.
template <bool ZERO, bool INPUT>
static __global__ void __launch_bounds__(COL3_THREADS) ring_sweep3_kernel(RingCol3 a, int j) {
  const int s = blockIdx.y, unit = blockIdx.x;
  const Col3& C = a.C[s];
  const bool inner = unit < col3_units(C) && ring_inner_unit(C, unit);
  ring_wait(a, s, !inner, false);
  if (unit >= col3_units(C)) return;
  const Ring3& W = a.W;
  const int z0 = W.z0[s], z1 = W.z0[s + 1];
  float* const wa = ring_window(a, a.wa[s], s);
  float* const wb = ring_window(a, a.wb[s], s);
  // the sweeps' iterate 0: the input, nothing, or u + prolong(c) in the
  // window iterate 1 does not go to
  const float* const src0 = ZERO ? nullptr : INPUT ? a.u[s] : (a.steps - 1) % 2 == 0 ? wb : wa;
  Col3Pass P;
  col3_schedule(C, P, j, a.steps, a.mode, src0, wa, wb, a.out[s],
                a.partials != nullptr ? a.partials + a.part0[s] : nullptr, col3_tiles(C),
                ROWS_LAST, a.tail);
  const size_t pl = plane3(W.n);
  if (inner) {
    const ptrdiff_t base = -(ptrdiff_t)z0 * (ptrdiff_t)pl;  // the blocks' global plane 0
    col3_unit_io<false, true, ZERO>(
        C, P, unit, Col3Io{INPUT ? a.u[s] + base : P.src, a.f[s] + base, P.dst, P.own});
  } else if (INPUT) {
    const int par = (int)(a.tag & 1);
    col3_unit_io<false, true, ZERO>(
        C, P, unit,
        col3_src(ring_vol3(a.u[s], ubuf3(W, s, par, 0), ubuf3(W, s, par, 1), z0, z1, pl),
                 ring_f3(a, s), P.dst, P.own));
  } else {
    col3_unit_io<false, true, ZERO>(C, P, unit,
                                    col3_src(Flat3{P.src}, ring_f3(a, s), P.dst, P.own));
  }
}

// Shard s's raw error sum: its tile partials in fixed_sum3's order (the
// shard mode's sum_partials3_raw_kernel), block s for shard s.
static __global__ void __launch_bounds__(THREADS3) ring_raw3_kernel(RingCol3 a, double* raw) {
  const int s = blockIdx.x;
  const double total = fixed_sum3(a.partials + a.part0[s], col3_tiles(a.C[s]));
  if (threadIdx.x == 0 && threadIdx.y == 0) raw[s] = total;
}

// Host side: shard s's column passes over windows of `depth` planes (tile
// plan ty x tx x czs[s], validated by col3_ok for `depth` stencil reads;
// the receive buffers hold at most RING3_HALO planes), the partials' layout
// and the workspace `work` (ops.kernels3.col3_work of every shard's tiles;
// its arrival counters zeroed on the stream). errors false: no workspace.
// Returns the most column-pass units of a shard in *units.
static inline cudaError_t ring_col3_setup(RingCol3& a, const unsigned long long* f_ptrs,
                                          const int* czs, int depth, int ty, int tx,
                                          double* work, bool errors, float h2, float w,
                                          float inv_h2, int* units, cudaStream_t stream) {
  const Ring3& W = a.W;
  if (depth < 0 || depth > RING3_HALO || (errors && work == nullptr))
    return cudaErrorInvalidValue;
  int total = 0;
  *units = 0;
  for (int s = 0; s < W.shards; ++s) {
    Col3& C = a.C[s];
    C = Col3{(const float*)f_ptrs[s], nullptr, nullptr, W.n, W.z0[s], W.z0[s + 1] - W.z0[s],
             depth, ty, tx, czs[s], h2, w, inv_h2};
    if (C.f == nullptr || !col3_ok(C, depth)) return cudaErrorInvalidValue;
    a.f[s] = C.f;
    a.part0[s] = total;
    total += col3_tiles(C);
    *units = col3_units(C) > *units ? col3_units(C) : *units;
  }
  a.part0[W.shards] = total;
  a.depth = depth;
  if (!errors) return cudaSuccess;
  unsigned* const arrivals = reinterpret_cast<unsigned*>(work + (size_t)total * WARPS3);
  for (int s = 0; s < W.shards; ++s) {
    a.C[s].wsum = work + (size_t)a.part0[s] * WARPS3;
    a.C[s].arrivals = arrivals + a.part0[s];
  }
  return cudaMemsetAsync(arrivals, 0, sizeof(unsigned) * total, stream);
}

// Blocks a shard of the post: enough to stream its halo planes (64 took
// 0.31 ms for the descend leg's at 513³ on 8 z-shards of an H100).
constexpr int RING_POST3_BLOCKS = 256;

// The post (then the first pass waits for the senders where it reads a
// receive buffer).
static inline cudaError_t ring_post3(RingCol3& a, bool coarse, cudaStream_t stream) {
  ring_post3_kernel<<<dim3(RING_POST3_BLOCKS, a.W.shards), COL3_THREADS, 0, stream>>>(a, coarse);
  a.wait = 1;
  return cudaGetLastError();
}

// col3_schedule's passes of a leg's sweeps on every shard (a.steps, and the
// clean error's read-only pass with a.partials and ERR_CLEAN), from the
// input (from zero where a.u is null) or from a window; units: the most of
// a shard.
static inline cudaError_t ring_sweeps3(RingCol3& a, bool input, int passes, int units,
                                       cudaStream_t stream) {
  const bool zero = input && a.u[0] == nullptr;
  for (int j = 0; j < passes; ++j) {
    const dim3 grid(units, a.W.shards);
    if (j == 0 && zero)
      ring_sweep3_kernel<true, false><<<grid, COL3_THREADS, 0, stream>>>(a, j);
    else if (j == 0 && input)
      ring_sweep3_kernel<false, true><<<grid, COL3_THREADS, 0, stream>>>(a, j);
    else
      ring_sweep3_kernel<false, false><<<grid, COL3_THREADS, 0, stream>>>(a, j);
    a.wait = 0;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Each shard's raw sum into raw[s].
static inline cudaError_t ring_raw3(const RingCol3& a, double* raw, cudaStream_t stream) {
  ring_raw3_kernel<<<a.W.shards, dim3(BLOCK_X, BLOCK3_Y), 0, stream>>>(a, raw);
  return cudaGetLastError();
}

}  // namespace mgk3
