// The whole 3-D ascend leg over every z-shard of a sharded level: the
// trilinear prolongation of the coarse correction, its add on the interior
// and k post-sweeps, with the clean smoothing error optionally, the fine and
// coarse plane halos moving only through the ring's receive buffers.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_rdma3.py,
// _rdma_ascend3_kernel, reached through parallel/pallas_shard3.py's
// rdma_fused_ascend3 (the sharded ascend legs with halo="rdma").
//
// Bound: device-memory bandwidth, as ascend3.cu: 12.5 B per fine point for
// the whole leg, plus the halo planes. The exchange path
// (sharded_fused_ascend3) copies every shard's windows of u, f and the
// coarse correction first; here only the k (+ clean) halo planes a side and
// the coarse planes they interpolate from move, the coarse correction as a
// third channel of receive buffers. Design: the ring leg of rdma3.cuh (post
// once, then shard-local column passes, a launch each over every shard)
// with the passes of ascend3.cu's shard mode: u plus the correction prolonged
// from the coarse planes of the shard's block or of its coarse receive
// buffers, on every window plane a sweep reads (halo planes included), into
// the scratch window the first sweep does not write; then col3_schedule's k
// sweeps and, with the clean error, the pass that only reads iterate k.
// Owned planes and the shard's raw Σ|r| are mg3_ascend_shard's with the same
// tile plan, bit for bit.
#include "rdma3.cuh"

using namespace mgk3;

// u0 = u + prolong(c) on shard blockIdx.z: column (y, x) of a 32 x 8 tile
// (blockIdx.x) over PRO3_CHUNK planes (blockIdx.y) of the window planes
// [z0 − depth, z1 + depth) within the grid, into the window iterate 1 does
// not go to; u and c from the shard's blocks and (a chunk that reaches
// beyond them) its receive buffers.
static __global__ void __launch_bounds__(256) ring_prolong3_kernel(RingCol3 a) {
  const int s = blockIdx.z;
  const Ring3& W = a.W;
  const int n = W.n, m = (n + 1) / 2, z0 = W.z0[s], z1 = W.z0[s + 1];
  const int plo = max(z0 - a.depth, 0), phi = min(z1 + a.depth, n);
  const int zs = plo + PRO3_CHUNK * blockIdx.y, ze = min(zs + PRO3_CHUNK, phi);
  // a chunk within [z0, z1 − 1) prolongs from the shard's own coarse planes
  const bool inner = zs >= z0 && ze < z1;
  ring_wait(a, s, !inner, true);
  const int gx = (n + 31) / 32;
  const int y = (blockIdx.x / gx) * 8 + threadIdx.y, x = (blockIdx.x % gx) * 32 + threadIdx.x;
  if (zs >= phi || y >= n || x >= n) return;
  const size_t pl = plane3(n), mp = plane3(m);
  float* const u0 = ring_window(a, (a.steps - 1) % 2 == 0 ? a.wb[s] : a.wa[s], s);
  if (inner) {
    ascend3_prolong_col(flat3(a.u[s], z0, pl), flat3(a.c[s], cz0_of(W, s), mp), u0, n, y, x,
                        zs, ze);
  } else {
    const int par = (int)(a.tag & 1);
    ascend3_prolong_col(ring_vol3(a.u[s], ubuf3(W, s, par, 0), ubuf3(W, s, par, 1), z0, z1, pl),
                        ring_vol3(a.c[s], cbuf3(W, s, 0), cbuf3(W, s, 1), cz0_of(W, s),
                                  cz1_of(W, s), mp),
                        u0, n, y, x, zs, ze);
  }
}

// Each shard's block u_ptrs[s] (planes z0s[s]..z0s[s + 1] of the n^3 level,
// n = 2m − 1, every z0s[s] even) plus the correction prolonged from the m^3
// coarse level, whose planes [z0 / 2, (z1 + 1) / 2) shard s holds at
// c_ptrs[s], then steps <= 8 sweeps into out_ptrs[s]. err_mode ERR_NONE or
// ERR_CLEAN (steps <= 7; raw[s] the shard's raw Σ|r|, partials one double
// per tile of every shard, work the column pass's workspace for all of
// them, ops.kernels3.col3_work of the total). wa_ptrs[s] and wb_ptrs[s] are
// scratch windows of the shard's planes and steps (+ 1 with the error) more
// a side. (ty, tx) and czs[s]: each shard's tile plan (err_plan3 of its
// depth). ws is the ring workspace of ops/rdma3.py; tag is above every tag
// it has seen.
extern "C" int mg3_rdma_ascend(const unsigned long long* u_ptrs,
                               const unsigned long long* f_ptrs,
                               const unsigned long long* c_ptrs,
                               const unsigned long long* out_ptrs,
                               const unsigned long long* wa_ptrs,
                               const unsigned long long* wb_ptrs, const int* z0s,
                               const int* czs, int shards, int n, int steps, int err_mode,
                               int ty, int tx, double* partials, double* work, double* raw,
                               const unsigned long long* ws, unsigned long long tag, float h2,
                               float w, float inv_h2, void* stream) {
  const int clean = err_mode == ERR_CLEAN ? 1 : 0;
  if (steps < 1 || steps + clean > MAX_STEPS3 || n % 2 == 0 ||
      (err_mode != ERR_NONE && err_mode != ERR_CLEAN) ||
      (clean && (partials == nullptr || raw == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  RingCol3 a{};
  cudaError_t e = ring3_setup(a.W, z0s, shards, n, ws);
  if (e != cudaSuccess) return (int)e;
  if (!ring_even3(a.W)) return (int)cudaErrorInvalidValue;
  const int depth = steps + clean;  // the planes a side the sweeps read
  int units = 0;
  if ((e = ring_col3_setup(a, f_ptrs, czs, depth, ty, tx, work, clean, h2, w, inv_h2, &units,
                           st)) != cudaSuccess)
    return (int)e;
  int planes = 0;  // the most window planes of a shard
  for (int s = 0; s < shards; ++s) {
    a.u[s] = (const float*)u_ptrs[s];
    a.c[s] = (const float*)c_ptrs[s];
    a.out[s] = (float*)out_ptrs[s];
    a.wa[s] = (float*)wa_ptrs[s];
    a.wb[s] = (float*)wb_ptrs[s];
    if (a.u[s] == nullptr || a.c[s] == nullptr || a.out[s] == nullptr || a.wa[s] == nullptr ||
        a.wb[s] == nullptr)
      return (int)cudaErrorInvalidValue;
    const int plo = z0s[s] - depth > 0 ? z0s[s] - depth : 0;
    const int phi = z0s[s + 1] + depth < n ? z0s[s + 1] + depth : n;
    planes = phi - plo > planes ? phi - plo : planes;
  }
  a.partials = clean ? partials : nullptr;
  a.tag = tag;
  a.steps = steps;
  a.mode = err_mode;
  if ((e = ring_post3(a, true, st)) != cudaSuccess) return (int)e;
  const dim3 pgrid(((n + 31) / 32) * ((n + 7) / 8), (planes + PRO3_CHUNK - 1) / PRO3_CHUNK,
                   shards);
  ring_prolong3_kernel<<<pgrid, dim3(32, 8), 0, st>>>(a);
  a.wait = 0;
  if ((e = cudaGetLastError()) != cudaSuccess ||
      (e = ring_sweeps3(a, false, steps + clean, units, st)) != cudaSuccess || !clean)
    return (int)e;
  return (int)ring_raw3(a, raw, st);
}
