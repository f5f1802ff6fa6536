// Compensated 5-point residual of a multi-word fp32 state: r = A·(u0 + u1
// [+ u2]) − f on the interior, 0 elsewhere, with the stencil sums of u0 and
// u1 carried by doubly compensated error-free (two-sum) chains and u2's by a
// plain sum, combined big part first (refine.residual_tw_p's arithmetic).
// nwords = 2 is the df32 state (the second word also gets its chain, so the
// result is more accurate than refine.residual_df_p), nwords = 3 tw32. One
// term more than the TPU kernel: the rounding error of hi0·h⁻² (Dekker's
// exact product). It is 0 on 2^k + 1 grids, where h⁻² is a power of two;
// elsewhere (a 256² schedule: h⁻² = 65025) it is what lets the state reach
// 1e-10.
//
// Replaces: multigrid_poisson_solver_tpu/ops/pallas_kernels.py,
// _residual_mw_kernel, reached through residual_df_pallas and
// residual_tw_pallas.
//
// Bound: device-memory bandwidth. One pass reads nwords + 1 grids and writes
// one: at 8193² (268.5 MB a grid) 1.34 GB for tw32, 0.401 ms at 3.35 TB/s,
// and 1.07 GB for df32, 0.321 ms. The arithmetic, ~220 fp32 operations a
// point for tw32, is ~0.22 ms at 67 TFLOP/s, under the memory time. Design:
// one thread per point, warps along rows, every word's five stencil values
// read through the read-only cache, so neighboring threads share lines and
// each grid comes from device memory about once. Every two-sum survives the
// compiler: all arithmetic is the __f*_rn intrinsics, which nvcc neither
// contracts into FMAs nor reassociates, in the plain twin's operation order
// (ops.kernels.residual_mw_torch), so the kernel reproduces it bit for bit.
#include "common.cuh"

using namespace mgk;

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

// (hi, lo, m): hi + lo + m ≈ Σ4 neighbors − 4u at point k, the error word
// itself compensated (refine._eft_stencil_sum_dd).
static __device__ __forceinline__ void dd_chain(const float* __restrict__ w, size_t k, int n,
                                                float& hi, float& lo, float& m) {
  const float uc = __ldg(w + k);
  const float terms[6] = {__ldg(w + k - 1), __ldg(w + k + 1), -uc, -uc, -uc, -uc};
  float e, e2;
  two_sum(__ldg(w + k - n), __ldg(w + k + n), hi, lo);
  float lo2 = 0.0f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    two_sum(hi, terms[q], hi, e);
    two_sum(lo, e, lo, e2);
    lo2 = __fadd_rn(lo2, e2);
  }
  two_sum(hi, lo, hi, e);
  two_sum(e, lo2, lo, m);
}

static __global__ void __launch_bounds__(THREADS)
residual_mw_kernel(const float* __restrict__ u0, const float* __restrict__ u1,
                   const float* __restrict__ u2, const float* __restrict__ f,
                   float* __restrict__ r, int n, float inv_h2) {
  const int gj = blockIdx.x * BLOCK_X + threadIdx.x;
  const int gi = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (gi >= n || gj >= n) return;
  const size_t k = (size_t)gi * n + gj;
  if (!interior(gi, gj, n)) {
    r[k] = 0.0f;
    return;
  }
  float hi0, lo0, m0, hi1, lo1, m1;
  dd_chain(u0, k, n, hi0, lo0, m0);
  dd_chain(u1, k, n, hi1, lo1, m1);
  float s2 = 0.0f;
  if (u2 != nullptr)
    s2 = __fsub_rn(__fadd_rn(__fadd_rn(__fadd_rn(__ldg(u2 + k - n), __ldg(u2 + k + n)),
                                       __ldg(u2 + k - 1)),
                             __ldg(u2 + k + 1)),
                   __fmul_rn(4.0f, __ldg(u2 + k)));
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

// r = the compensated residual of the nwords-word state (u0, u1[, u2]); u2 is
// ignored (may be null) when nwords == 2.
extern "C" int mg_residual_mw(const float* u0, const float* u1, const float* u2,
                              const float* f, float* r, int n, int nwords, float inv_h2,
                              void* stream) {
  if (n < 3 || (nwords != 2 && nwords != 3) || (nwords == 3 && u2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + BLOCK_X - 1) / BLOCK_X, (n + BLOCK_Y - 1) / BLOCK_Y);
  residual_mw_kernel<<<grid, dim3(BLOCK_X, BLOCK_Y), 0, (cudaStream_t)stream>>>(
      u0, u1, nwords == 3 ? u2 : nullptr, f, r, n, inv_h2);
  return (int)cudaGetLastError();
}
