// The work of one tile for each fused operation that keeps the tile
// pipeline: the smoother's tile (jacobi_tile) in the ring kernel
// rdma_jacobi.cu; the descend leg (chain_descend.cu, and descend.cu's small
// levels) and the ascend leg (chain_ascend.cu, and ascend.cu's small
// levels). Kernel 1 (its Jacobi and rb-GS modes), the trigger loops
// (trigger_stream.cu, rdma_trigger.cu) and the legs' larger levels run
// wave2.cuh's wavefront instead, and trigger.cu's small levels a thread
// block cluster; their iterates, coarse right-hand sides and error partials
// equal these tiles' bit for bit. A one-launch kernel runs one tile per block; a
// persistent kernel walks many tiles per block and levels or sweeps between
// grid barriers.
// Both run this same code, so the chain kernels reproduce the per-level
// launches bit for bit.
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

// load_tile with every load of a batch in flight before the first store:
// warp y stages rows y, y + BLOCK_Y, ... as load_tile does, TILE_BATCH_ROWS
// of them at a time, each row's TILE_BATCH_COLS column slots (lane x:
// x + 32c; a staged row is at most 148 wide) loaded into registers before
// any is stored. load_tile's loop waits on each load before the next. The
// descend and ascend tiles stage this way.
constexpr int TILE_BATCH_ROWS = 4;
constexpr int TILE_BATCH_COLS = (TILE_W + 2 * MAX_HALO + BLOCK_X - 1) / BLOCK_X;

template <class T>
static __device__ void load_tile_batched(float* s, const WinT<T>& src, int n, const Tile& t) {
  for (int i0 = threadIdx.y; i0 < t.rows; i0 += TILE_BATCH_ROWS * BLOCK_Y) {
    float v[TILE_BATCH_ROWS][TILE_BATCH_COLS];
#pragma unroll
    for (int r = 0; r < TILE_BATCH_ROWS; ++r) {
      const int i = i0 + r * BLOCK_Y;
      const RowRefT<T> row = i < t.rows ? row_of(src, t.gr0 + i, n) : RowRefT<T>{src.p, 0, 0};
#pragma unroll
      for (int c = 0; c < TILE_BATCH_COLS; ++c) {
        const int j = threadIdx.x + c * BLOCK_X, gj = t.gc0 + j;
        v[r][c] = j < t.cols && gj >= row.c_lo && gj < row.c_hi ? to_f(__ldcg(row.p + gj)) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < TILE_BATCH_ROWS; ++r) {
      const int i = i0 + r * BLOCK_Y;
#pragma unroll
      for (int c = 0; c < TILE_BATCH_COLS; ++c) {
        const int j = threadIdx.x + c * BLOCK_X;
        if (i < t.rows && j < t.cols) s[i * t.cols + j] = v[r][c];
      }
    }
  }
}

// Stage the starting iterate into buf: u's window, or with from_zero the
// closed-form first sweep from u ≡ 0, zero_coef·f on the interior (u unread).
template <class T = float, class S>
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
      buf[k] = interior(t.gr0 + i, t.gc0 + j, n) ? rnd<T>(__fmul_rn(zero_coef, sf[k])) : 0.0f;
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

// The descend leg of tile (tx, ty) on the level n = 2m − 1: sweeps into out,
// then −r of the final iterate restricted (sampling or full weighting) into
// the tile's 16 x 64 window of the coarse right-hand side fc. fc is laid out
// as the coarse points of g's region: rows from row0 / 2, (rows + 1) / 2 of
// them, and the same for columns (the m x m grid for the whole level; g's
// origin is even). T: the grids' storage type (common.cuh).
template <class T>
static __device__ void descend_tile(float* smem, const WinT<T>& u, const WinT<T>& f,
                                    T* __restrict__ out, T* __restrict__ fc,
                                    float* partial, int tx, int ty, const Geo& g, int n_sweeps,
                                    int halo, int from_zero, int full_weighting, int err_mode,
                                    float h2, float omega, float inv_h2, float zero_coef) {
  __syncthreads();
  const int n = g.n;
  const Tile t = make_tile(g, halo, tx, ty);
  const int cells = t.rows * t.cols;
  float* sf = smem;
  float* bufs[2] = {smem + cells, smem + 2 * cells};

  load_tile_batched(sf, f, n, t);
  if (from_zero)
    stage_iterate<T>(bufs[0], sf, u, n, t, 1, zero_coef);
  else
    load_tile_batched(bufs[0], u, n, t);
  __syncthreads();

  const int fin_i = run_sweeps<T>(bufs, sf, t, n_sweeps, n, h2, omega);
  const float* fin = bufs[fin_i];
  float* d = bufs[fin_i ^ 1];
  store_owned(out, fin, g, t, halo);
  if (err_mode != ERR_NONE) {
    const float* prev = n_sweeps > 0 ? d : nullptr;
    error_partial<T>(partial, fin, prev, sf, t, halo, g, err_mode, inv_h2);
  }
  __syncthreads();  // the error pass may still read the spare buffer

  // d = −r(fin) on the owned window plus the ring full weighting reads
  const int e = full_weighting ? 1 : 0;
  for (int i = halo - e + threadIdx.y; i < halo + TILE_H + e; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = halo - e + threadIdx.x; j < halo + TILE_W + e; j += BLOCK_X) {
      const int k = i * t.cols + j;
      d[k] = interior(gi, t.gc0 + j, n)
                 ? -residual_point<T>(nb_sum<T>(fin, t.cols, i, j), fin[k], sf[k], inv_h2)
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
            sy[c] = fw_comb<T>(d[kc - t.cols], d[kc], d[kc + t.cols]);
          }
          v = fw_comb<T>(sy[0], sy[1], sy[2]);
        } else {
          v = d[k];
        }
      }
      fc[(size_t)lI * ccols + lJ] = from_f<T>(v);
    }
  }
}

// The ascend leg of tile (tx, ty) on the level n = 2m − 1: u plus the
// prolonged correction on the interior, then `steps` sweeps into out. c is a
// window of the m x m coarse correction holding every coarse cell the
// interior cells of u's window interpolate from (mg_ascend_shard checks it).
// u, f and the tile's coarse cells are staged by load_tile_batched (the
// coarse ones into the spare buffer) and the prolongation reads them there.
template <class T>
static __device__ void ascend_tile(float* smem, const WinT<T>& u, const WinT<T>& f,
                                   const WinT<T>& c, T* __restrict__ out, float* partial,
                                   int tx, int ty,
                                   const Geo& g, int steps, int halo, int err_mode, float h2,
                                   float omega, float inv_h2) {
  __syncthreads();
  const int n = g.n;
  const Tile t = make_tile(g, halo, tx, ty);
  const int cells = t.rows * t.cols;
  float* sf = smem;
  float* bufs[2] = {smem + cells, smem + 2 * cells};

  const Geo held(n, max(0, u.r0), max(0, u.c0), min(n, u.r0 + u.rows) - max(0, u.r0),
                 min(n, u.c0 + u.cols) - max(0, u.c0));
  // coarse rows (gi >> 1) .. (gi >> 1) + 1 of the tile's interior rows gi,
  // and the same for columns
  const int i_lo = max(1, t.gr0), i_hi = min(n - 2, t.gr0 + t.rows - 1);
  const int j_lo = max(1, t.gc0), j_hi = min(n - 2, t.gc0 + t.cols - 1);
  Tile ct;
  ct.gr0 = i_lo >> 1;
  ct.gc0 = j_lo >> 1;
  ct.rows = (i_hi >> 1) + 2 - ct.gr0;
  ct.cols = (j_hi >> 1) + 2 - ct.gc0;
  float* cw = bufs[1];
  load_tile_batched(sf, f, n, t);
  load_tile_batched(bufs[0], u, n, t);  // 0 outside u's window: not held
  load_tile_batched(cw, c, (n + 1) / 2, ct);
  __syncthreads();
  for (int i = threadIdx.y; i < t.rows; i += BLOCK_Y) {
    const int gi = t.gr0 + i;
    for (int j = threadIdx.x; j < t.cols; j += BLOCK_X) {
      const int gj = t.gc0 + j;
      if (!owned(held, gi, gj) || !interior(gi, gj, n)) continue;
      const float* r0 = cw + ((gi >> 1) - ct.gr0) * ct.cols + ((gj >> 1) - ct.gc0);
      const float* r1 = r0 + ct.cols;
      // the column pass on coarse rows I = gi >> 1 and I + 1, then the row pass
      const float w0 = (gj & 1) ? half_sum<T>(r0[0], r0[1]) : r0[0];
      float p = w0;
      if (gi & 1) {
        const float w1 = (gj & 1) ? half_sum<T>(r1[0], r1[1]) : r1[0];
        p = half_sum<T>(w0, w1);
      }
      bufs[0][i * t.cols + j] = rnd<T>(__fadd_rn(bufs[0][i * t.cols + j], p));
    }
  }
  __syncthreads();
  const int fin = run_sweeps<T>(bufs, sf, t, steps, n, h2, omega);
  store_owned(out, bufs[fin], g, t, halo);
  if (err_mode != ERR_NONE)
    error_partial<T>(partial, bufs[fin], bufs[fin ^ 1], sf, t, halo, g, err_mode, inv_h2);
}

// Halo of each tile operation (see the header of common.cuh).
static inline int jacobi_halo(int n_sweeps, int err_mode) {
  return n_sweeps + ((err_mode == ERR_CPU || err_mode == ERR_CLEAN) ? 1 : 0);
}

static inline int descend_halo(int n_sweeps, int full_weighting) {
  return n_sweeps + 1 + (full_weighting ? 1 : 0);
}

}  // namespace mgk
