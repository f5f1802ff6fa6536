// Compensated 7-point residual of a multi-word fp32 state: r = A·(u0 + u1
// [+ u2]) − f on the interior, 0 elsewhere, with the stencil sums of u0 and
// u1 carried by doubly compensated error-free (two-sum) chains and u2's by a
// plain sum, combined big part first (refine3.residual_tw3's arithmetic).
// nwords = 2 is the df32 state (the second word also gets its chain, so the
// result is more accurate than refine3.residual_df3), nwords = 3 tw32. One
// term more than the TPU kernel: the rounding error of hi0·h⁻² (Dekker's
// exact product). It is 0 on 2^k + 1 grids, where h⁻² is a power of two;
// elsewhere (a 256³ schedule: h⁻² = 65025) it keeps the residual exact near
// convergence.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas3d.py,
// _residual_mw3_kernel, reached through residual_tw3_pallas and
// residual_df3_pallas.
//
// Bound: device-memory bandwidth. One pass reads nwords + 1 grids and writes
// one: at 513³ (540 MB a grid) 2.70 GB for tw32, 0.81 ms at 3.35 TB/s, and
// 2.16 GB for df32, 0.65 ms. The arithmetic, ~280 fp32 operations a point
// for tw32, is ~0.55 ms at 67 TFLOP/s, just under the memory time. Design:
// a block is a 32 x 8 column tile of (x, y) that marches down a chunk of z
// planes, one thread per column. Each thread keeps the z − 1, z and z + 1
// values of every word in registers, so the z neighbors come from device
// memory once; the four in-plane neighbors come through the read-only cache,
// which the block's neighboring columns share. Every two-sum survives the
// compiler: all arithmetic is the __f*_rn intrinsics, which nvcc neither
// contracts into FMAs nor reassociates, in the plain twin's operation order
// (ops.kernels3.residual_mw3_torch), so the kernel reproduces it bit for bit.
#include "common.cuh"

using namespace mgk;

constexpr int MW3_CZ = 32;  // z planes a block marches through

// s + e = a + b exactly (Knuth's two-sum).
static __device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// Veltkamp's split: a = hi + lo, each with at most 12 significant bits.
static __device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(4097.0f, a);
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

// p + e = a·b exactly, without an FMA (Dekker's product).
static __device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
}

// (hi, lo, m): hi + lo + m ≈ Σ6 neighbors − 6u at point k of word w, whose
// z neighbors are zm and zp and center c; the error word itself compensated
// (refine3._eft_stencil_sum_dd3: the z pair first, then y−, y+, x−, x+, then
// six −u terms).
static __device__ __forceinline__ void dd_chain3(const float* __restrict__ w, size_t k, int n,
                                                 float zm, float c, float zp, float& hi,
                                                 float& lo, float& m) {
  const float terms[10] = {__ldg(w + k - n), __ldg(w + k + n), __ldg(w + k - 1),
                           __ldg(w + k + 1), -c, -c, -c, -c, -c, -c};
  float e, e2;
  two_sum(zm, zp, hi, lo);
  float lo2 = 0.0f;
#pragma unroll
  for (int q = 0; q < 10; ++q) {
    two_sum(hi, terms[q], hi, e);
    two_sum(lo, e, lo, e2);
    lo2 = __fadd_rn(lo2, e2);
  }
  two_sum(hi, lo, hi, e);
  two_sum(e, lo2, lo, m);
}

static __global__ void __launch_bounds__(THREADS)
residual_mw3_kernel(const float* __restrict__ u0, const float* __restrict__ u1,
                    const float* __restrict__ u2, const float* __restrict__ f,
                    float* __restrict__ r, int n, float inv_h2) {
  const int gx = blockIdx.x * BLOCK_X + threadIdx.x;
  const int gy = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (gx >= n || gy >= n) return;
  const int z0 = blockIdx.z * MW3_CZ, z1 = min(z0 + MW3_CZ, n);
  const size_t plane = (size_t)n * n, col = (size_t)gy * n + gx;
  const bool in2 = interior(gy, gx, n);
  // the z − 1, z, z + 1 values of each word at this column (0 outside the grid)
  float a0[3], a1[3], a2[3];
  auto at = [&](const float* w, int z) -> float {
    return (w != nullptr && z >= 0 && z < n) ? __ldg(w + z * plane + col) : 0.0f;
  };
  a0[1] = at(u0, z0 - 1), a0[2] = at(u0, z0);
  a1[1] = at(u1, z0 - 1), a1[2] = at(u1, z0);
  a2[1] = at(u2, z0 - 1), a2[2] = at(u2, z0);
  for (int z = z0; z < z1; ++z) {
    a0[0] = a0[1], a0[1] = a0[2], a0[2] = at(u0, z + 1);
    a1[0] = a1[1], a1[1] = a1[2], a1[2] = at(u1, z + 1);
    a2[0] = a2[1], a2[1] = a2[2], a2[2] = at(u2, z + 1);
    const size_t k = z * plane + col;
    if (!(in2 && z >= 1 && z <= n - 2)) {
      r[k] = 0.0f;
      continue;
    }
    float hi0, lo0, m0, hi1, lo1, m1;
    dd_chain3(u0, k, n, a0[0], a0[1], a0[2], hi0, lo0, m0);
    dd_chain3(u1, k, n, a1[0], a1[1], a1[2], hi1, lo1, m1);
    float s2 = 0.0f;
    if (u2 != nullptr)
      s2 = __fsub_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a2[0], a2[2]),
                                                             __ldg(u2 + k - n)),
                                                   __ldg(u2 + k + n)),
                                         __ldg(u2 + k - 1)),
                               __ldg(u2 + k + 1)),
                     __fmul_rn(6.0f, a2[1]));
    // big part first (exact by Sterbenz near convergence) with the rounding
    // error of hi0·h⁻² added back, then the small terms in compensated order
    // of magnitude
    float p, pe;
    two_prod(hi0, inv_h2, p, pe);
    const float r_big = __fadd_rn(__fsub_rn(p, __ldg(f + k)), pe);
    float t, tc;
    two_sum(lo0, hi1, t, tc);
    const float t2 = __fadd_rn(__fadd_rn(__fadd_rn(lo1, m0), __fadd_rn(m1, s2)), tc);
    r[k] = __fadd_rn(__fadd_rn(r_big, __fmul_rn(t, inv_h2)), __fmul_rn(t2, inv_h2));
  }
}

// r = the compensated residual of the nwords-word n^3 state (u0, u1[, u2]);
// u2 is ignored (may be null) when nwords == 2.
extern "C" int mg3_residual_mw(const float* u0, const float* u1, const float* u2,
                               const float* f, float* r, int n, int nwords, float inv_h2,
                               void* stream) {
  if (n < 3 || (nwords != 2 && nwords != 3) || (nwords == 3 && u2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BLOCK_X - 1) / BLOCK_X, (n + BLOCK_Y - 1) / BLOCK_Y,
                  (n + MW3_CZ - 1) / MW3_CZ);
  residual_mw3_kernel<<<grid, dim3(BLOCK_X, BLOCK_Y), 0, (cudaStream_t)stream>>>(
      u0, u1, nwords == 3 ? u2 : nullptr, f, r, n, inv_h2);
  return (int)cudaGetLastError();
}
