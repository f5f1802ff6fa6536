// The work of one tile for each fused operation that keeps the tile
// pipeline: the smoother's tile (jacobi_tile, jacobi_errs_tile) in the
// trigger loops (trigger.cu, trigger_stream.cu) and the ring kernels
// (rdma_jacobi.cu, rdma_trigger.cu); rb-GS (jacobi.cu); the descend leg
// (chain_descend.cu, and descend.cu's small levels) and the ascend leg
// (chain_ascend.cu, and ascend.cu's small levels). Kernel 1's Jacobi modes
// and the legs' larger levels run wave2.cuh's wavefront instead, whose
// iterates, coarse right-hand sides and error partials equal these tiles'
// bit for bit. A one-launch kernel runs one tile per block; a persistent kernel
// walks many tiles per block and levels or sweeps between grid barriers.
// Both run this same code, so the chain and trigger kernels reproduce the
// per-level launches bit for bit.
//
// `smem` holds tile_smem_bytes(halo): f, then two ping-pong buffers. Every
// function starts with a barrier, so a block may call them back to back.
// `g` is the owned region (the whole grid, or one shard's block): tiles are
// laid over it, outputs are laid out as it, masks use global indices, and
// the error partials count its cells only. Inputs are windows (Win, or the
// ring source of the rdma kernels) holding at least the owned region plus
// the tile halo.
#pragma once

#include "common.cuh"

namespace mgk {

// Stage the starting iterate into buf: u's window, or with from_zero the
// closed-form first sweep from u ≡ 0, zero_coef·f on the interior (u unread).
template <class S>
static __device__ void stage_iterate(float* buf, const float* sf, const S& u, int n,
                                     const Tile& t, int from_zero, float zero_coef) {
  if (!from_zero) {
    load_tile(buf, u, n, t);
    return;
  }
  __syncthreads();  // sf complete
  for (int i = threadIdx.y; i < t.rows; i += BLOCK_Y)
    for (int j = threadIdx.x; j < t.cols; j += BLOCK_X) {
      const int k = i * t.cols + j;
      buf[k] = interior(t.gr0 + i, t.gc0 + j, n) ? __fmul_rn(zero_coef, sf[k]) : 0.0f;
    }
}

// n_sweeps (after the closed-form one when from_zero) Jacobi sweeps of tile
// (tx, ty) into out; with err_mode, the tile's error partial into *partial.
template <class S>
static __device__ void jacobi_tile(float* smem, const S& u, const S& f, float* __restrict__ out,
                                   float* partial, int tx, int ty, const Geo& g, int n_sweeps,
                                   int halo, int from_zero, int err_mode, float h2, float omega,
                                   float inv_h2, float zero_coef) {
  __syncthreads();
  const int n = g.n;
  const Tile t = make_tile(g, halo, tx, ty);
  const int cells = t.rows * t.cols;
  float* sf = smem;
  float* bufs[2] = {smem + cells, smem + 2 * cells};

  load_tile(sf, f, n, t);
  stage_iterate(bufs[0], sf, u, n, t, from_zero, zero_coef);
  __syncthreads();

  const int fin = run_sweeps(bufs, sf, t, n_sweeps, n, h2, omega);
  store_owned(out, bufs[fin], g, t, halo);
  if (err_mode != ERR_NONE) {
    // gpu metric of a closed-form-only pass: Δ from the implicit zero iterate
    const float* prev = n_sweeps > 0 ? bufs[fin ^ 1] : nullptr;
    error_partial(partial, bufs[fin], prev, sf, t, halo, g, err_mode, inv_h2);
  }
}

// n_sweeps Jacobi sweeps of tile (tx, ty) into out with the error of every
// iterate: after sweep s the tile's partial of u_s goes to
// partials[(s − 1) · stride]. Each partial is the one jacobi_tile writes
// after s sweeps (the same cells, values and order), so a row of partials
// sums to what a launch of s sweeps reports.
static __device__ void jacobi_errs_tile(float* smem, const Win& u, const Win& f,
                                        float* __restrict__ out, float* partials, int stride,
                                        int tx, int ty, const Geo& g, int n_sweeps, int halo,
                                        int err_mode, float h2, float omega, float inv_h2) {
  __syncthreads();
  const int n = g.n;
  const Tile t = make_tile(g, halo, tx, ty);
  const int cells = t.rows * t.cols;
  float* sf = smem;
  float* bufs[2] = {smem + cells, smem + 2 * cells};

  load_tile(sf, f, n, t);
  load_tile(bufs[0], u, n, t);
  __syncthreads();
  for (int s = 1; s <= n_sweeps; ++s) {
    sweep(bufs[(s - 1) & 1], bufs[s & 1], sf, t, s, n, h2, omega);
    __syncthreads();
    // ends with block_sum's barriers: the next sweep may overwrite u_{s−1}
    error_partial(partials + (size_t)(s - 1) * stride, bufs[s & 1],
                  err_mode == ERR_GPU ? bufs[(s - 1) & 1] : nullptr, sf, t, halo, g, err_mode,
                  inv_h2);
  }
  store_owned(out, bufs[n_sweeps & 1], g, t, halo);
}

// One red-black Gauss-Seidel half-update of `color` (0: even, (i + j) even;
// 1: odd) in place over the staged region shrunk by lo: u = ¼·(nb − h²f) on
// the interior cells of that color (stencils.redblack_gs_sweep). A cell of
// one color reads only neighbors of the other, so updating in place is the
// twin's read-all-then-write half.
static __device__ void rbgs_half(float* buf, const float* sf, const Tile& t, int lo, int n,
                                 int color, float h2) {
  for (int i = lo + threadIdx.y; i < t.rows - lo; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = lo + threadIdx.x; j < t.cols - lo; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (!interior(gi, gj, n) || ((gi + gj) & 1) != color) continue;
      const int k = i * t.cols + j;
      buf[k] = __fmul_rn(0.25f, __fsub_rn(nb_sum(buf, t.cols, i, j), __fmul_rn(h2, sf[k])));
    }
  }
}

// The rb-GS error partial of one tile: Σ|Δ| over its owned interior cells
// (ERR_CPU: even color only), Δ = ¼·((nb − 4u) − h²f) the step an ω = 1
// Jacobi sweep would take from the final iterate, i.e. (h²/4)·r.
static __device__ void rbgs_error_partial(float* __restrict__ partial, const float* fin,
                                          const float* sf, const Tile& t, int halo, const Geo& g,
                                          int err_mode, float h2) {
  const Span sp = owned_interior(g);
  float acc = 0.0f;
  for (int i = halo + threadIdx.y; i < halo + TILE_H; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = halo + threadIdx.x; j < halo + TILE_W; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (gi < sp.i_lo || gi > sp.i_hi || gj < sp.j_lo || gj > sp.j_hi) continue;
      if (err_mode == ERR_CPU && ((gi + gj) & 1)) continue;
      const int k = i * t.cols + j;
      const float d = __fsub_rn(__fsub_rn(nb_sum(fin, t.cols, i, j), __fmul_rn(4.0f, fin[k])),
                                __fmul_rn(h2, sf[k]));
      acc += fabsf(__fmul_rn(0.25f, d));
    }
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) *partial = total;
}

// n_sweeps rb-GS sweeps (2·n_sweeps half-updates, even color first) of tile
// (tx, ty) into out, in one staged buffer after f; from_zero: the iterate is
// 0 and u is not read. With err_mode (cpu or clean), the tile's error
// partial into *partial.
static __device__ void rbgs_tile(float* smem, const Win& u, const Win& f,
                                 float* __restrict__ out, float* partial, int tx, int ty,
                                 const Geo& g, int n_sweeps, int halo, int from_zero, int err_mode,
                                 float h2) {
  __syncthreads();
  const int n = g.n;
  const Tile t = make_tile(g, halo, tx, ty);
  float* sf = smem;
  float* buf = smem + t.rows * t.cols;

  load_tile(sf, f, n, t);
  if (from_zero) {
    for (int i = threadIdx.y; i < t.rows; i += BLOCK_Y)
      for (int j = threadIdx.x; j < t.cols; j += BLOCK_X) buf[i * t.cols + j] = 0.0f;
  } else {
    load_tile(buf, u, n, t);
  }
  __syncthreads();
  for (int s = 1; s <= 2 * n_sweeps; ++s) {
    rbgs_half(buf, sf, t, s, n, (s - 1) & 1, h2);
    __syncthreads();
  }
  store_owned(out, buf, g, t, halo);
  if (err_mode != ERR_NONE) rbgs_error_partial(partial, buf, sf, t, halo, g, err_mode, h2);
}

// The descend leg of tile (tx, ty) on the level n = 2m − 1: sweeps into out,
// then −r of the final iterate restricted (sampling or full weighting) into
// the tile's 16 x 64 window of the coarse right-hand side fc. fc is laid out
// as the coarse points of g's region: rows from row0 / 2, (rows + 1) / 2 of
// them, and the same for columns (the m x m grid for the whole level; g's
// origin is even).
static __device__ void descend_tile(float* smem, const Win& u, const Win& f,
                                    float* __restrict__ out, float* __restrict__ fc,
                                    float* partial, int tx, int ty, const Geo& g, int n_sweeps,
                                    int halo, int from_zero, int full_weighting, int err_mode,
                                    float h2, float omega, float inv_h2, float zero_coef) {
  __syncthreads();
  const int n = g.n;
  const Tile t = make_tile(g, halo, tx, ty);
  const int cells = t.rows * t.cols;
  float* sf = smem;
  float* bufs[2] = {smem + cells, smem + 2 * cells};

  load_tile(sf, f, n, t);
  stage_iterate(bufs[0], sf, u, n, t, from_zero, zero_coef);
  __syncthreads();

  const int fin_i = run_sweeps(bufs, sf, t, n_sweeps, n, h2, omega);
  const float* fin = bufs[fin_i];
  float* d = bufs[fin_i ^ 1];
  store_owned(out, fin, g, t, halo);
  if (err_mode != ERR_NONE) {
    const float* prev = n_sweeps > 0 ? d : nullptr;
    error_partial(partial, fin, prev, sf, t, halo, g, err_mode, inv_h2);
  }
  __syncthreads();  // the error pass may still read the spare buffer

  // d = −r(fin) on the owned window plus the ring full weighting reads
  const int e = full_weighting ? 1 : 0;
  for (int i = halo - e + threadIdx.y; i < halo + TILE_H + e; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = halo - e + threadIdx.x; j < halo + TILE_W + e; j += BLOCK_X) {
      const int k = i * t.cols + j;
      d[k] = interior(gi, t.gc0 + j, n)
                 ? -residual_point(nb_sum(fin, t.cols, i, j), fin[k], sf[k], inv_h2)
                 : 0.0f;
    }
  }
  __syncthreads();

  const int m = (n + 1) / 2;
  const int crows = (g.rows + 1) / 2, ccols = (g.cols + 1) / 2;
  for (int ci = threadIdx.y; ci < TILE_H / 2; ci += BLOCK_Y) {
    const int lI = ty * (TILE_H / 2) + ci, I = g.row0 / 2 + lI;
    const int li = halo + 2 * ci;
    for (int cj = threadIdx.x; cj < TILE_W / 2; cj += BLOCK_X) {
      const int lJ = tx * (TILE_W / 2) + cj, J = g.col0 / 2 + lJ;
      if (I >= m || J >= m || lI >= crows || lJ >= ccols) continue;
      float v = 0.0f;
      if (interior(I, J, m)) {
        const int k = li * t.cols + halo + 2 * cj;
        if (full_weighting) {
          // rows (¼·d[i−1] + ½·d[i]) + ¼·d[i+1], then the same across columns
          float sy[3];
          for (int c = 0; c < 3; ++c) {
            const int kc = k + c - 1;
            sy[c] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, d[kc - t.cols]), __fmul_rn(0.5f, d[kc])),
                              __fmul_rn(0.25f, d[kc + t.cols]));
          }
          v = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, sy[0]), __fmul_rn(0.5f, sy[1])),
                        __fmul_rn(0.25f, sy[2]));
        } else {
          v = d[k];
        }
      }
      fc[(size_t)lI * ccols + lJ] = v;
    }
  }
}

// Coarse row I interpolated to fine column gj (the prolongation's column pass).
static __device__ __forceinline__ float wide(const Win& c, int I, int gj) {
  const int J = gj >> 1;
  const float a = at(c, I, J);
  if (!(gj & 1)) return a;
  return __fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, at(c, I, J + 1)));
}

// The ascend leg of tile (tx, ty) on the level n = 2m − 1: u plus the
// prolonged correction on the interior, then `steps` sweeps into out. c is a
// window of the m x m coarse correction holding every coarse cell the
// interior cells of u's window interpolate from (mg_ascend_shard checks it).
static __device__ void ascend_tile(float* smem, const Win& u, const Win& f, const Win& c,
                                   float* __restrict__ out, float* partial, int tx, int ty,
                                   const Geo& g, int steps, int halo, int err_mode, float h2,
                                   float omega, float inv_h2) {
  __syncthreads();
  const int n = g.n;
  const Tile t = make_tile(g, halo, tx, ty);
  const int cells = t.rows * t.cols;
  float* sf = smem;
  float* bufs[2] = {smem + cells, smem + 2 * cells};

  load_tile(sf, f, n, t);
  // the cells of u's window in the grid
  const Geo held(n, max(0, u.r0), max(0, u.c0), min(n, u.r0 + u.rows) - max(0, u.r0),
                 min(n, u.c0 + u.cols) - max(0, u.c0));
  for (int i = threadIdx.y; i < t.rows; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = threadIdx.x; j < t.cols; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      float v = 0.0f;
      if (owned(held, gi, gj)) {
        v = at(u, gi, gj);
        if (interior(gi, gj, n)) {
          const int I = gi >> 1;
          const float p = (gi & 1) ? __fadd_rn(__fmul_rn(0.5f, wide(c, I, gj)),
                                               __fmul_rn(0.5f, wide(c, I + 1, gj)))
                                   : wide(c, I, gj);
          v = __fadd_rn(v, p);
        }
      }
      bufs[0][i * t.cols + j] = v;
    }
  }
  __syncthreads();

  const int fin = run_sweeps(bufs, sf, t, steps, n, h2, omega);
  store_owned(out, bufs[fin], g, t, halo);
  if (err_mode != ERR_NONE)
    error_partial(partial, bufs[fin], bufs[fin ^ 1], sf, t, halo, g, err_mode, inv_h2);
}

// Halo of each tile operation (see the header of common.cuh).
static inline int jacobi_halo(int n_sweeps, int err_mode) {
  return n_sweeps + ((err_mode == ERR_CPU || err_mode == ERR_CLEAN) ? 1 : 0);
}

static inline int descend_halo(int n_sweeps, int full_weighting) {
  return n_sweeps + 1 + (full_weighting ? 1 : 0);
}

// rb-GS: each half-update consumes one halo cell, the error's Δ one more.
static inline int rbgs_halo(int n_sweeps, int err_mode) {
  return 2 * n_sweeps + (err_mode != ERR_NONE ? 1 : 0);
}

// Shared memory of an rb-GS tile: f and one in-place buffer.
static inline size_t rbgs_smem_bytes(int halo) {
  return 2 * tile_floats(halo) * sizeof(float);
}

}  // namespace mgk
