// Shared pieces of the bf16 modes of kernels 1-4 (jacobi_bf16.cu,
// residual_bf16.cu, descend_bf16.cu, ascend_bf16.cu): a bfloat16 state on
// the whole grid of one device.
//
// Replaces: the bf16 states of multigrid_poisson_solver_tpu/ops/
// pallas_kernels.py's _fused_jacobi_kernel (its Jacobi modes),
// _residual_kernel, _fused_descend_kernel and _fused_ascend_kernel, which
// trace and run with a bf16 state (tests/test_dtypes.py) and sum their error
// partials in f32, presenting the error in the state's dtype
// (pallas_kernels.py, fused_descend_padded's rescale).
//
// Contract: bit for bit the plain twins of ops/kernels.py run on bf16
// tensors (common.cuh, "Storage type T"): the same instances as the fp32
// sources with the storage type bf16, so the wavefront's row ranges, chunks
// and error partial order, and the tile kernels' tiles, are the fp32
// kernels'. Error partials are float sums of the rounded terms in legs.cuh's
// tile order; the second pass scales in float and rounds the metric to bf16
// (JAX's (raw · scale).astype(dtype)). Each mode is its own translation unit,
// so the fp32 sources compile as they did.
//
// Bound: a state word is 2 bytes, so a pass moves half the fp32 kernel's
// bytes; the rounding after every operation roughly doubles the
// instructions a point, so the many-sweep passes are bound by operations.
#pragma once

#include "wave2.cuh"

namespace mgk {

using bf16 = __nv_bfloat16;

// Second pass of a bf16 mode's error reduction: sum_partials_kernel's
// fixed-order float sum and scale, rounded to bf16 into out[b].
static __global__ void __launch_bounds__(THREADS)
sum_partials_bf16_kernel(const float* __restrict__ partials, int count, float scale,
                         bf16* __restrict__ out) {
  const float total = fixed_sum(partials + (size_t)blockIdx.x * count, count);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    out[blockIdx.x] = __float2bfloat16_rn(__fmul_rn(total, scale));
}

static inline cudaError_t launch_error_sum_bf16(const float* partials, int count, float scale,
                                                bf16* out, cudaStream_t stream) {
  sum_partials_bf16_kernel<<<1, dim3(BLOCK_X, BLOCK_Y), 0, stream>>>(partials, count, scale,
                                                                     out);
  return cudaGetLastError();
}

// A wavefront instance of shape S for the bf16 state: blocks for a warp a
// strip and chunk, the chunk rows from its occupancy (wave2_rows).
template <class S, class F, class... A>
static cudaError_t launch_bf16_wave(F kernel, const Geo& g, int halo, cudaStream_t stream,
                                    A... args) {
  static_assert(S::SMEM <= 48 * 1024, "a block's rings fit the default shared memory");
  static const int resident = wave2_resident_warps(kernel, S::THREADS, S::SMEM);
  const int rows = wave2_rows(g, resident, halo);
  kernel<<<wave_grid(g, rows, S::WARPS), S::THREADS, S::SMEM, stream>>>(args..., rows);
  return cudaGetLastError();
}

// The wavefront instance of a runtime sweep count k (K0..MAX_STEPS) and
// error mode: call.run<K, E>(), E the wave2 error kind of err_mode.
template <int K0, class C, int K = K0>
static cudaError_t launch_bf16_k(int k, int err_mode, const C& call) {
  if constexpr (K > MAX_STEPS) {
    return cudaErrorInvalidValue;
  } else {
    if (k != K) return launch_bf16_k<K0, C, K + 1>(k, err_mode, call);
    switch (err_mode) {
      case ERR_NONE: return call.template run<K, WV_NONE>();
      case ERR_GPU: return call.template run<K, WV_GPU>();
      default: return call.template run<K, WV_RES>();
    }
  }
}

}  // namespace mgk
