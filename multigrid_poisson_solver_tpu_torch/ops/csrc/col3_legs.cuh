// The passes of the 3-D legs that are not sweeps, as device functions over a
// plane source: the descend leg's residual pass and restriction
// (descend3.cu) and the ascend leg's prolongation (ascend3.cu). The
// one-launch kernels of descend3.cu and ascend3.cu (whole grid and shard
// mode) and the ring legs of rdma_descend3.cu and rdma_ascend3.cu run the
// same bodies; only where a plane comes from differs (a volume laid out as
// the inputs, or a shard's block and its receive buffers). Every pass is a
// launch of its own, so its loads go through L1 (__ldg).
#pragma once

#include "col3.cuh"

namespace mgk3 {

// Plane z of a contiguous volume whose planes are `pl` floats: p offset so
// that p + z · pl is plane z (Col3Io's arithmetic).
struct Flat3 {
  const float* p;
  __device__ __forceinline__ const float* at(int z, size_t pl) const { return p + z * pl; }
};

// A contiguous volume whose plane 0 is global plane `first`.
static __device__ __forceinline__ Flat3 flat3(const float* p, int first, size_t pl) {
  return Flat3{p - (ptrdiff_t)first * (ptrdiff_t)pl};
}

// Plane z of a volume from one of three places: lo below plane z0, mid on
// [z0, z1), hi from z1 on, each pointer offset as Flat3's (a z-shard's block
// and its receive buffers, rdma3.cuh).
struct Vol3 {
  const float *lo, *mid, *hi;
  int z0, z1;
  __device__ __forceinline__ const float* at(int z, size_t pl) const {
    return (z < z0 ? lo : z < z1 ? mid : hi) + z * pl;
  }
};

// The plane source of a column pass (col3_walk, col3_stream): the iterate
// read (U) and f (F), volumes of Flat3's or Vol3's kind; the iterate written
// into dst (offset as a Flat3, or nullptr) and its owned planes into own
// (the owned planes from C.z0, or nullptr).
template <class U, class F>
struct Col3Src {
  U u;
  F f;
  float* dst;
  float* own;
  __device__ __forceinline__ const float* up(int z, size_t pl) const { return u.at(z, pl); }
  __device__ __forceinline__ const float* fp(int z, size_t pl) const { return f.at(z, pl); }
  __device__ __forceinline__ bool writes() const { return dst != nullptr || own != nullptr; }
  __device__ __forceinline__ void put(const Col3& C, int z, size_t pl, size_t col,
                                      float v) const {
    if (dst != nullptr) dst[z * pl + col] = v;
    if (own != nullptr && z >= C.z0 && z < C.z0 + C.nz) own[(z - C.z0) * pl + col] = v;
  }
};

template <class U, class F>
static __device__ __forceinline__ Col3Src<U, F> col3_src(const U& u, const F& f, float* dst,
                                                         float* own) {
  return Col3Src<U, F>{u, f, dst, own};
}

// ¼·a + ½·b, then + ¼·c: one step of full weighting.
static __device__ __forceinline__ float fw3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.5f, b)), __fmul_rn(0.25f, c));
}

// Unit `unit` of the descend leg's residual pass over iterate k (the source
// io's u): the tile's columns over its z chunk [e0, e1) of the owned
// planes, −r on the planes [e0 − FW, e1 + FW) of the grid, the error of the
// chunk's planes into the tile's partial, and s_K for the chunk's coarse
// planes K (2K in [e0, e1)) into s (plane K − z0 / 2; interior K only). A
// face column has −r = 0 and no coarse point reads it.
template <bool FW, class Io>
static __device__ __forceinline__ void descend3_residual_unit(const Col3& C, const Io& io,
                                                              float* s, double* partials,
                                                              int unit) {
  const int n = C.n, m = (n + 1) / 2, gx = col3_gx(C), gy = col3_gy(C);
  const int tile = unit / COL3_QUARTERS, q = unit - tile * COL3_QUARTERS;
  const int bx = tile % gx, by = (tile / gx) % gy, bz = tile / (gx * gy);
  const int e0 = C.z0 + bz * C.cz, e1 = min(e0 + C.cz, C.z0 + C.nz);
  const int v = q * COL3_THREADS + threadIdx.x;  // the tile's thread (block_sum3's numbering)
  double acc = 0.0;
  if (v < C.ty * C.tx) {
    const int i = v / C.tx;
    const int y = by * C.ty + i, x = bx * C.tx + (v - i * C.tx);
    if (y < n && x < n && inner(y, n) && inner(x, n)) {
      const size_t pl = (size_t)n * n, col = (size_t)y * n + x;
      const int K0 = C.z0 / 2;
      float d2 = 0.0f, d1 = 0.0f;  // −r at z − 2 and z − 1
      auto at = [&](int z, const Col3Plane& p, float cm, float cp) {
        float d = 0.0f;
        if (inner(z, n)) {
          d = -__fsub_rn(__fmul_rn(C.inv_h2, col3_lap(p, cm, cp)), p.f);
          if (z >= e0 && z < e1) acc += (double)fabsf(d);
        }
        // coarse plane K once its fine planes are in the registers
        const int K = FW ? (z - 1) >> 1 : z >> 1;
        if ((FW ? (z & 1) : !(z & 1)) && 2 * K >= e0 && 2 * K < e1 && inner(K, m))
          s[(size_t)(K - K0) * pl + col] = FW ? fw3(d2, d1, d) : d;
        d2 = d1;
        d1 = d;
      };
      col3_stream<false>(io, n, pl, col, true, max(e0 - FW, 0), min(e1 + FW, n), at);
    }
  }
  if (partials != nullptr) col3_finish(C, partials, tile, q, acc);
}

// The restriction's y and x steps at coarse point (K0 + k, I, J) of the m^3
// grid from s (plane k: the z step at coarse plane K0 + k on the fine n x n
// plane), into fc's plane k; 0 on the coarse boundary.
template <bool FW>
static __device__ __forceinline__ void descend3_restrict_at(const float* s, float* fc, int n,
                                                            int K0, int k, int I, int J) {
  const int m = (n + 1) / 2;
  if (I >= m || J >= m) return;
  float v = 0.0f;
  if (inner(K0 + k, m) && inner(I, m) && inner(J, m)) {
    const float* const c = s + ((size_t)k * n + 2 * I) * n + 2 * J;
    if (FW) {
      float sy[3];
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx)
        sy[dx + 1] = fw3(__ldg(c - n + dx), __ldg(c + dx), __ldg(c + n + dx));
      v = fw3(sy[0], sy[1], sy[2]);
    } else {
      v = __ldg(c);
    }
  }
  fc[((size_t)k * m + I) * m + J] = v;
}

// Planes a thread of the prolongation pass takes, its loads of u kept in
// flight by unrolling.
constexpr int PRO3_CHUNK = 8;

// u0 = u + prolong(c) on the interior, u elsewhere, for column (y, x) over
// the planes [zs, ze): u's planes from the volume u, the coarse planes from
// the volume c (planes of m² floats; Flat3 or Vol3 each), u0 offset as a
// Flat3. models.poisson3d.prolong3's arithmetic with the column's coarse
// values in registers: the (up to) four coarse columns (I, J), (I, J + 1),
// (I + 1, J), (I + 1, J + 1) of coarse planes Z and Z + 1, so a coarse plane
// is loaded once for the two fine planes that read it (on an H100 the pass
// took 0.64 ms a 513³ v_cycle3 cycle, against 0.72 for the earlier
// prolongation that loaded per point, PERF.md).
template <class U, class C>
static __device__ __forceinline__ void ascend3_prolong_col(const U& u, const C& c,
                                                           float* u0, int n, int y, int x,
                                                           int zs, int ze) {
  const bool cin = inner(y, n) && inner(x, n);
  const int m = (n + 1) / 2, yo = y & 1, xo = x & 1;
  const size_t mp = (size_t)m * m, o00 = (size_t)(y >> 1) * m + (x >> 1);
  const size_t o01 = o00 + xo, o10 = o00 + yo * m, o11 = o10 + xo;
  const size_t pl = (size_t)n * n, col = (size_t)y * n + x;
  float p0[4], p1[4];  // the four columns of coarse planes Z and Z + 1
  auto load = [&](float(&p)[4], int Z) {
    const float* cz = c.at(Z, mp);
    p[0] = __ldg(cz + o00);
    p[1] = __ldg(cz + o01);
    p[2] = __ldg(cz + o10);
    p[3] = __ldg(cz + o11);
  };
  if (cin) load(p0, zs >> 1);
#pragma unroll
  for (int t = 0; t < PRO3_CHUNK; ++t) {
    const int z = zs + t;
    if (z >= ze) break;
    float v = __ldg(u.at(z, pl) + col);
    if (cin && inner(z, n)) {
      // along z (odd planes ½·(a + b)), then y, then x
      float a[4];
      if (z & 1) {
        load(p1, (z >> 1) + 1);
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = __fmul_rn(0.5f, __fadd_rn(p0[k], p1[k]));
#pragma unroll
        for (int k = 0; k < 4; ++k) p0[k] = p1[k];  // plane Z + 1 is the next plane's Z
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = p0[k];
      }
      const float b0 = yo ? __fmul_rn(0.5f, __fadd_rn(a[0], a[2])) : a[0];
      const float b1 = yo ? __fmul_rn(0.5f, __fadd_rn(a[1], a[3])) : a[1];
      v = __fadd_rn(v, xo ? __fmul_rn(0.5f, __fadd_rn(b0, b1)) : b0);
    }
    u0[z * pl + col] = v;
  }
}

}  // namespace mgk3
