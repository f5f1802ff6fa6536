// Kernel 1's bf16 mode: k <= 8 damped-Jacobi sweeps of a bfloat16 state a
// pass over device memory, from_zero, with the cpu / clean / gpu error of
// the last iterate, on the whole grid (bf16.cuh: what it replaces, its
// contract and its bound).
//
// Design: jacobi.cu's wavefront (wave2.cuh) with the storage type bf16: the
// same K = 0..8 sweep instances × no / gpu / residual error, whole grid only
// (27 instances). Every pass copies 16-byte chunks of 8 values, a ring row
// at any of 8 offsets; the sweeps run in float registers and round to bf16
// after each of the twin's ops.
#include "bf16.cuh"

using namespace mgk;

template <int K, int E>
using JacobiBf16Shape = WaveShape<K, E, false, WV_SMOOTH, false, 0, bf16>;

template <int K, int E>
static __global__ void __launch_bounds__(JacobiBf16Shape<K, E>::THREADS)
jacobi_bf16_kernel(const bf16* __restrict__ u, const bf16* __restrict__ f, bf16* __restrict__ out,
                   float* __restrict__ partials, int n, int from_zero, int even_only, float h2,
                   float omega, float inv_h2, float zero_coef, int chunk_rows) {
  wave2_pass<false, K, E, false, WV_SMOOTH, false, 0, bf16>(
      u, f, out, partials, Geo(n), 0, 0, chunk_rows, 0, from_zero, even_only, h2, omega, inv_h2,
      zero_coef);
}

struct JacobiBf16Call {
  const bf16* u;
  const bf16* f;
  bf16* out;
  float* partials;
  int n, from_zero, even_only;
  float h2, omega, inv_h2, zero_coef;
  cudaStream_t stream;

  template <int K, int E>
  cudaError_t run() const {
    using S = JacobiBf16Shape<K, E>;
    return launch_bf16_wave<S>(jacobi_bf16_kernel<K, E>, Geo(n), S::H, stream, u, f, out,
                               partials, n, from_zero, even_only, h2, omega, inv_h2, zero_coef);
  }
};

// steps <= MAX_STEPS sweeps of the bf16 grid u (ignored when from_zero) into
// out, u and f starting 16-byte aligned (else cudaErrorMisalignedAddress).
// With err_mode != ERR_NONE, partials holds mg_num_tiles(n) floats and
// err_out[0] (bf16) receives their sum times err_scale.
extern "C" int mg_jacobi_bf16(const bf16* u, const bf16* f, bf16* out, float* partials,
                              bf16* err_out, int n, int steps, int from_zero, int err_mode,
                              float h2, float omega, float inv_h2, float zero_coef,
                              float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || err_mode < ERR_NONE || err_mode > ERR_GPU || n < 3)
    return (int)cudaErrorInvalidValue;
  if (misaligned(from_zero ? nullptr : u, f)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  const JacobiBf16Call c = {u, f, out, partials, n, from_zero ? 1 : 0,
                            err_mode == ERR_CPU ? 1 : 0, h2, omega, inv_h2, zero_coef, s};
  const cudaError_t e = launch_bf16_k<0>(steps - (from_zero ? 1 : 0), err_mode, c);
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum_bf16(partials, num_tiles(Geo(n)), err_scale, err_out, s);
}
