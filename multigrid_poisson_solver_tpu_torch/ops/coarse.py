"""Exact coarse-grid solvers.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/coarse.py``, mirroring the
reference's doExactSolver options (MG_solver_CPU.cpp:627-638):

  * option 0, ``dense_solve``: the (tiny, coarsest-level) operator inverse is
    computed once on the host in float64, cached, and applied as one
    ``torch.matmul`` in the grid's dtype.
  * option 1/2, ``gauss_seidel_solve``: red-black Gauss-Seidel from U = 0
    until the mean |interior residual| drops below ``target_error``, with the
    JAX package's exact stopping rule (compensated residual, ``max_iters``
    backstop, stop after 128 sweeps without improvement). The loop runs on
    the host: one device→host read of two flags per sweep.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .stencils import redblack_gs_sweep, residual_compensated

STALL_LIMIT = 128


@lru_cache(maxsize=None)
def _poisson_matrix_np(n: int, h: float) -> np.ndarray:
    """Dense (n², n²) 5-point Laplacian with identity rows on the boundary,
    row order the flat [iy, ix] layout (MG_solver_CPU.cpp:802-832)."""
    m = n * n
    a = np.zeros((m, m), dtype=np.float64)
    inv_h2 = 1.0 / (h * h)
    for iy in range(n):
        for ix in range(n):
            row = iy * n + ix
            if ix == 0 or ix == n - 1 or iy == 0 or iy == n - 1:
                a[row, row] = 1.0
            else:
                a[row, row] = -4.0 * inv_h2
                a[row, row - 1] = inv_h2
                a[row, row + 1] = inv_h2
                a[row, row - n] = inv_h2
                a[row, row + n] = inv_h2
    return a


@lru_cache(maxsize=None)
def _poisson_inverse_np(n: int, h: float) -> np.ndarray:
    return np.linalg.inv(_poisson_matrix_np(n, h))


@lru_cache(maxsize=32)
def _poisson_inverse(n: int, h: float, dtype: torch.dtype,
                     device: torch.device) -> torch.Tensor:
    """A⁻¹ cast to ``dtype`` and resident on ``device`` (cached, so repeated
    coarse solves copy nothing from the host)."""
    return torch.as_tensor(_poisson_inverse_np(n, h)).to(device=device, dtype=dtype)


def dense_solve(f: torch.Tensor, h: float) -> torch.Tensor:
    """Direct solve of the boundary-aware dense system A·u = f; ``f`` carries
    the RHS inside and the Dirichlet values on the border (identity rows)."""
    n = f.shape[0]
    a_inv = _poisson_inverse(n, h, f.dtype, f.device)
    return (a_inv @ f.reshape(-1)).reshape(n, n)


def gauss_seidel_solve(f: torch.Tensor, h: float, target_error: float,
                       norm: str = "interior", max_iters: int = 100_000):
    """Red-black GS from U = 0 until mean |interior residual| ≤ target_error.

    Returns (u, final_error, iterations). ``norm``: "interior" divides by
    (n−2)² (CPU reference, MG_solver_CPU.cpp:1059), "full" by n² (GPU
    reference, MG_solver_GPU.cu:1521)."""
    n = f.shape[0]
    denom = {"interior": (n - 2) * (n - 2), "full": n * n}[norm]
    u = torch.zeros_like(f)
    u[0, :] = f[0, :]
    u[-1, :] = f[-1, :]
    u[:, 0] = f[:, 0]
    u[:, -1] = f[:, -1]
    tgt = torch.tensor(target_error, dtype=f.dtype, device=f.device)
    err = tgt + 1.0
    best = torch.tensor(torch.finfo(f.dtype).max, dtype=f.dtype, device=f.device)
    iters = stall = 0
    above = True
    while above and iters < max_iters and stall < STALL_LIMIT:
        u = redblack_gs_sweep(u, f, h)
        r = residual_compensated(u, f, h)
        err = torch.sum(torch.abs(r[1:-1, 1:-1])) / denom
        improved = err < best * (1.0 - 1e-6)
        best = torch.minimum(best, err)
        above, improved = torch.stack([err > tgt, improved]).tolist()
        stall = 0 if improved else stall + 1
        iters += 1
    return u, err, iters
