"""The unified bilinear "zoom" primitive: general N→M grid resampling.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/zoom.py`` (``zoom``, its
3-D member ``zoom3``, ``zoom_matrix``, ``restrict_residual`` and
``prolongate``) and of the gather form ``zoom_take_p`` in
``ops/padded.py``. Restriction and
prolongation are the same resampling op with swapped sizes (ker_Zoom_GPU,
MG_solver_GPU.cu:913-958): target point ``i`` maps to source coordinate
``s = i · (n_src − 1) / (n_dst − 1)`` and is interpolated linearly from the
two neighboring source points along each axis.

Two forms with the JAX package's exact arithmetic:
  * ``"take"`` (default): separable 2-tap gathers with fp32 tap weights; the
    axis processed first keeps the intermediate at the coarse size.
  * ``"matmul"``: two dense interpolation-matrix products, weights built in
    float64 then cast (the interpreted engine's form, ``SolverConfig.zoom``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _take_taps_np(n_src: int, n_dst: int, zero_boundary: bool):
    """(i0, w0, w1): out[j] = w0[j]·src[i0[j]] + w1[j]·src[i0[j]+1]; weights
    are fp32 (as the JAX gather zoom stores them) and, for
    ``zero_boundary``, zero at j = 0 and j = n_dst − 1."""
    s = np.arange(n_dst, dtype=np.float64) * ((n_src - 1) / (n_dst - 1))
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n_src - 2)
    w = (s - i0).astype(np.float32)
    w0 = (1.0 - w).astype(np.float32)
    w1 = w.copy()
    if zero_boundary:
        w0[0] = w1[0] = 0.0
        w0[n_dst - 1] = w1[n_dst - 1] = 0.0
    return i0, w0, w1


@lru_cache(maxsize=None)
def _zoom_matrix_np(n_src: int, n_dst: int) -> np.ndarray:
    """Dense float64 1-D align-corners interpolation matrix W: (n_dst, n_src)."""
    s = np.arange(n_dst, dtype=np.float64) * ((n_src - 1) / (n_dst - 1))
    i0 = np.clip(np.floor(s).astype(np.int64), 0, n_src - 2)
    w = s - i0
    mat = np.zeros((n_dst, n_src), dtype=np.float64)
    rows = np.arange(n_dst)
    mat[rows, i0] = 1.0 - w
    mat[rows, i0 + 1] = w
    return mat


def zoom_matrix(n_src: int, n_dst: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The (n_dst, n_src) interpolation matrix, built in float64 then cast
    (JAX ``ops/zoom.py:46``)."""
    return torch.as_tensor(_zoom_matrix_np(n_src, n_dst), device=device).to(dtype)


def _zero_border(a: torch.Tensor) -> torch.Tensor:
    a[0, :] = 0
    a[-1, :] = 0
    a[:, 0] = 0
    a[:, -1] = 0
    return a


def _zoom_take(src: torch.Tensor, n_dst: int, zero_boundary: bool) -> torch.Tensor:
    n_src = src.shape[0]
    i0, w0, w1 = _take_taps_np(n_src, n_dst, zero_boundary)
    idx = torch.as_tensor(i0, device=src.device)
    w0 = torch.as_tensor(w0, device=src.device).to(src.dtype)
    w1 = torch.as_tensor(w1, device=src.device).to(src.dtype)

    def rows_pass(a):
        return a[idx] * w0[:, None] + a[idx + 1] * w1[:, None]

    def cols_pass(a):
        return a[:, idx] * w0[None, :] + a[:, idx + 1] * w1[None, :]

    if n_dst <= n_src:          # restriction: shrink rows before cols
        return cols_pass(rows_pass(src))
    return rows_pass(cols_pass(src))   # prolongation: expand rows last


def _zoom_matmul(src: torch.Tensor, n_dst: int, zero_boundary: bool) -> torch.Tensor:
    n_src = src.shape[0]
    if n_dst == n_src:
        out = src.clone()
    else:
        w = zoom_matrix(n_src, n_dst, src.dtype, src.device)
        out = (w @ src) @ w.T
    if zero_boundary:
        out = _zero_border(out)
    return out


def zoom3(src: torch.Tensor, n_dst: int, zero_boundary: bool = False) -> torch.Tensor:
    """Trilinearly resample an (n, n, n) volume to (n_dst,)³, corners aligned:
    the 1-D interpolation matrix contracted along each axis in turn (the
    general restriction and prolongation of the 3-D engines; the JAX
    package's ``zoom3``). ``zero_boundary`` zeroes the output's faces."""
    n_src = src.shape[0]
    if n_dst == n_src:
        out = src.clone()
    else:
        w = zoom_matrix(n_src, n_dst, src.dtype, src.device)
        out = src
        for _ in range(3):
            # contract the leading axis; the axes cycle back after three passes
            out = torch.tensordot(w, out, dims=([1], [0])).permute(1, 2, 0)
        out = out.contiguous()
    if zero_boundary:
        interior = out[1:-1, 1:-1, 1:-1].clone()
        out.zero_()
        out[1:-1, 1:-1, 1:-1] = interior
    return out


def zoom(src: torch.Tensor, n_dst: int, zero_boundary: bool = False,
         form: str = "take") -> torch.Tensor:
    """Bilinearly resample an (n, n) grid to (n_dst, n_dst), corners aligned.

    ``zero_boundary=True`` forces the output border to 0 (restriction
    semantics: the restricted residual lives in a zero-Dirichlet correction
    space, MG_solver_CPU.cpp:651-652)."""
    if form == "take":
        return _zoom_take(src, n_dst, zero_boundary)
    if form == "matmul":
        return _zoom_matmul(src, n_dst, zero_boundary)
    raise ValueError(f"unknown zoom form {form!r}; expected 'take' or 'matmul'")


def restrict_residual(d: torch.Tensor, n_coarse: int) -> torch.Tensor:
    """Coarse-level RHS = zoom of the *negated* fine residual, zero boundary:
    the scheduler's down-leg F_coarse = restrict(−D_fine)
    (MG_solver_CPU.cpp:274-287; JAX ``ops/zoom.py:104``, whose zoom is the
    matrix form)."""
    return zoom(-d, n_coarse, zero_boundary=True, form="matmul")


def prolongate(u_coarse: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Fine-level correction = zoom of the coarse solution
    (MG_solver_CPU.cpp:682-724; JAX ``ops/zoom.py:113``)."""
    return zoom(u_coarse, n_fine, zero_boundary=False, form="matmul")
