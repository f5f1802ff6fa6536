// Kernel 3's bf16 mode: the descend leg of a bfloat16 state on the whole
// grid: k <= 8 sweeps, the residual of the final iterate and its 2:1
// restriction (sampling or full weighting) of −r into the coarse right-hand
// side, with an optional cpu / clean / gpu error (bf16.cuh: what it
// replaces, its contract and its bound).
//
// Design: descend.cu's two routes with the storage type bf16, chosen by
// legs_take_wave with this leg's own crossover (forced_leg_route reaches
// both): from 5 M cells the wavefront with the descend stage (K = 0..8
// sweeps in the pass × no / gpu / residual error, 27 instances), below it
// the tile kernel (descend_tile staged in float shared memory, one
// instance). Measured with examples/torch_bf16_leg_routes.py on an NVIDIA
// H100 80GB HBM3 at 700 W (3 sweeps, sampling, device µs a call, tile
// against wave): 1025² 38.2 / 84.2, 1449² 62.4 / 97.3, 2049² 100.1 /
// 126.3, 2561² 163.2 / 161.1, 2897² 197.0 / 161.9, 4097² 372.0 / 324.9.
// The bf16 wavefront pass is bound by its operations (every op rounds),
// so it overtakes the tiles later than fp32's at 1.5 M.
#include "bf16.cuh"
#include "legs.cuh"

using namespace mgk;

static __global__ void __launch_bounds__(THREADS)
descend_bf16_tile_kernel(const bf16* __restrict__ u, const bf16* __restrict__ f,
                         bf16* __restrict__ out, bf16* __restrict__ fc,
                         float* __restrict__ partials, int n, int n_sweeps, int halo,
                         int from_zero, int full_weighting, int err_mode, float h2, float omega,
                         float inv_h2, float zero_coef) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const Geo g(n);
  descend_tile(smem, window(u, g), window(f, g), out, fc, partials ? partials + t : nullptr,
               blockIdx.x, blockIdx.y, g, n_sweeps, halo, from_zero, full_weighting, err_mode,
               h2, omega, inv_h2, zero_coef);
}

template <int K, int E>
using DescendBf16Shape = WaveShape<K, E, false, WV_DESCEND, false, 0, bf16>;

template <int K, int E>
static __global__ void __launch_bounds__(DescendBf16Shape<K, E>::THREADS)
descend_bf16_wave_kernel(const bf16* __restrict__ u, const bf16* __restrict__ f,
                         bf16* __restrict__ out, bf16* __restrict__ fc,
                         float* __restrict__ partials, int n, int from_zero, int full_weighting,
                         int even_only, float h2, float omega, float inv_h2, float zero_coef,
                         int chunk_rows) {
  wave2_pass<false, K, E, false, WV_DESCEND, false, 0, bf16>(
      u, f, out, partials, Geo(n), 0, 0, chunk_rows, 0, from_zero, even_only, h2, omega, inv_h2,
      zero_coef, WaveLegT<bf16>{fc, full_weighting, WinT<bf16>{}});
}

// The wavefront from 5 M cells (5 · 2^20: between 2049²'s 4.2 M and
// 2561²'s 6.6 M, where the routes tie; see the header).
constexpr long DESCEND_BF16_WAVE_MIN_CELLS = 5L << 20;

struct DescendBf16Call {
  const bf16* u;
  const bf16* f;
  bf16* out;
  bf16* fc;
  float* partials;
  int n, from_zero, full_weighting, even_only;
  float h2, omega, inv_h2, zero_coef;
  cudaStream_t stream;

  template <int K, int E>
  cudaError_t run() const {
    using S = DescendBf16Shape<K, E>;
    return launch_bf16_wave<S>(descend_bf16_wave_kernel<K, E>, Geo(n), S::H + full_weighting,
                               stream, u, f, out, fc, partials, n, from_zero, full_weighting,
                               even_only, h2, omega, inv_h2, zero_coef);
  }
};

// steps <= MAX_STEPS sweeps of the n x n bf16 level (n = 2m − 1) into out,
// the restricted negated residual into the m x m fc (bf16). u and f start
// 16-byte aligned (else cudaErrorMisalignedAddress; u may be null from
// zero). Error arguments as mg_jacobi_bf16.
extern "C" int mg_descend_bf16(const bf16* u, const bf16* f, bf16* out, bf16* fc,
                               float* partials, bf16* err_out, int n, int steps, int from_zero,
                               int full_weighting, int err_mode, float h2, float omega,
                               float inv_h2, float zero_coef, float err_scale, void* stream) {
  if (steps < 1 || steps > MAX_STEPS || n < 3 || n % 2 == 0 || err_mode < ERR_NONE ||
      err_mode > ERR_GPU)
    return (int)cudaErrorInvalidValue;
  if (misaligned(from_zero ? nullptr : u, f)) return (int)cudaErrorMisalignedAddress;
  const Geo g(n);
  const int n_sweeps = steps - (from_zero ? 1 : 0);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (legs_take_wave(n, n, DESCEND_BF16_WAVE_MIN_CELLS)) {
    const DescendBf16Call c = {u, f, out, fc, partials, n, from_zero ? 1 : 0,
                               full_weighting ? 1 : 0, err_mode == ERR_CPU ? 1 : 0, h2, omega,
                               inv_h2, zero_coef, s};
    e = launch_bf16_k<0>(n_sweeps, err_mode, c);
  } else {
    const int halo = descend_halo(n_sweeps, full_weighting);
    e = cudaFuncSetAttribute(descend_bf16_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tile_smem_bytes(MAX_HALO));
    if (e != cudaSuccess) return (int)e;
    descend_bf16_tile_kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
        u, f, out, fc, partials, n, n_sweeps, halo, from_zero, full_weighting, err_mode, h2,
        omega, inv_h2, zero_coef);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum_bf16(partials, num_tiles(g), err_scale, err_out, s);
}
