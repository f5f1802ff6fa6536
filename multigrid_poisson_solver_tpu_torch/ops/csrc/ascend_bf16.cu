// Kernel 4's bf16 mode: the ascend leg of a bfloat16 state on the whole
// grid: 2:1 bilinear prolongation of the coarse correction, its
// interior-only add, and k <= 8 post-sweeps, with an optional cpu / clean /
// gpu error (bf16.cuh: what it replaces, its contract and its bound).
//
// Design: ascend.cu's two routes with the storage type bf16, chosen by
// legs_take_wave with this leg's own crossover (forced_leg_route reaches
// both): from 2.5 M cells the wavefront with the ascend stage (K = 1..8 ×
// no / gpu / residual error, 24 instances; the coarse rows arrive in
// 16-byte chunks, so c starts 16-byte aligned as u and f do), below it the
// tile kernel (ascend_tile staged in float shared memory, one instance).
// Measured with examples/torch_bf16_leg_routes.py on an NVIDIA H100 80GB
// HBM3 at 700 W (3 sweeps, device µs a call, tile against wave): 1025²
// 40.5 / 64.0, 1281² 61.9 / 63.9, 1449² 66.6 / 76.0, 1793² 90.2 / 76.2,
// 2049² 108.0 / 103.1, 4097² 417.8 / 244.3.
#include "bf16.cuh"
#include "legs.cuh"

using namespace mgk;

static __global__ void __launch_bounds__(THREADS)
ascend_bf16_tile_kernel(const bf16* __restrict__ u, const bf16* __restrict__ f,
                        const bf16* __restrict__ c, bf16* __restrict__ out,
                        float* __restrict__ partials, int n, int steps, int halo, int err_mode,
                        float h2, float omega, float inv_h2) {
  extern __shared__ float smem[];
  const int t = blockIdx.y * gridDim.x + blockIdx.x;
  const Geo g(n);
  ascend_tile(smem, window(u, g), window(f, g), window(c, Geo((n + 1) / 2)), out,
              partials ? partials + t : nullptr, blockIdx.x, blockIdx.y, g, steps, halo,
              err_mode, h2, omega, inv_h2);
}

template <int K, int E>
using AscendBf16Shape = WaveShape<K, E, false, WV_ASCEND, false, 0, bf16>;

template <int K, int E>
static __global__ void __launch_bounds__(AscendBf16Shape<K, E>::THREADS)
ascend_bf16_wave_kernel(const bf16* __restrict__ u, const bf16* __restrict__ f,
                        const bf16* __restrict__ c, bf16* __restrict__ out,
                        float* __restrict__ partials, int n, int even_only, float h2,
                        float omega, float inv_h2, int chunk_rows) {
  wave2_pass<false, K, E, false, WV_ASCEND, false, 0, bf16>(
      u, f, out, partials, Geo(n), 0, 0, chunk_rows, 0, 0, even_only, h2, omega, inv_h2, 0.0f,
      WaveLegT<bf16>{nullptr, 0, window(c, Geo((n + 1) / 2))});
}

// The wavefront from 2.5 M cells (5 · 2^19: between 1449²'s 2.1 M and
// 1793²'s 3.2 M; see the header).
constexpr long ASCEND_BF16_WAVE_MIN_CELLS = 5L << 19;

struct AscendBf16Call {
  const bf16* u;
  const bf16* f;
  const bf16* c;
  bf16* out;
  float* partials;
  int n, even_only;
  float h2, omega, inv_h2;
  cudaStream_t stream;

  template <int K, int E>
  cudaError_t run() const {
    using S = AscendBf16Shape<K, E>;
    return launch_bf16_wave<S>(ascend_bf16_wave_kernel<K, E>, Geo(n), S::H, stream, u, f, c,
                               out, partials, n, even_only, h2, omega, inv_h2);
  }
};

// Fine level n = 2m − 1 (bf16): out = k sweeps of (u + prolong(c)) with c
// the m x m coarse correction; u, f and c start 16-byte aligned (else
// cudaErrorMisalignedAddress). Error arguments as mg_jacobi_bf16.
extern "C" int mg_ascend_bf16(const bf16* u, const bf16* f, const bf16* c, bf16* out,
                              float* partials, bf16* err_out, int n, int steps, int err_mode,
                              float h2, float omega, float inv_h2, float err_scale,
                              void* stream) {
  if (steps < 1 || steps > MAX_STEPS || n < 3 || n % 2 == 0 || err_mode < ERR_NONE ||
      err_mode > ERR_GPU)
    return (int)cudaErrorInvalidValue;
  if (misaligned(u, f) || misaligned(c, nullptr)) return (int)cudaErrorMisalignedAddress;
  const Geo g(n);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (legs_take_wave(n, n, ASCEND_BF16_WAVE_MIN_CELLS)) {
    const AscendBf16Call a = {u, f, c, out, partials, n, err_mode == ERR_CPU ? 1 : 0, h2, omega,
                              inv_h2, s};
    e = launch_bf16_k<1>(steps, err_mode, a);
  } else {
    const int halo = jacobi_halo(steps, err_mode);
    e = cudaFuncSetAttribute(ascend_bf16_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)tile_smem_bytes(MAX_HALO));
    if (e != cudaSuccess) return (int)e;
    ascend_bf16_tile_kernel<<<tile_grid(g), dim3(BLOCK_X, BLOCK_Y), tile_smem_bytes(halo), s>>>(
        u, f, c, out, partials, n, steps, halo, err_mode, h2, omega, inv_h2);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess || err_mode == ERR_NONE) return (int)e;
  return (int)launch_error_sum_bf16(partials, num_tiles(g), err_scale, err_out, s);
}
