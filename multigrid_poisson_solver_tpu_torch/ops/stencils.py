"""Core 5-point stencil operations: residual, smoothers, error metrics.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/stencils.py`` (plus the
compensated residual of ``ops/precision.py``). These are the port's oracle
ops: plain tensor code on ``(n, n)`` grids, dtype-polymorphic, that every
CUDA kernel's plain twin is built from (``ops.kernels``).

Reference semantics reproduced here:
  * residual: getResidual, MG_solver_CPU.cpp:554-564
  * Jacobi smoother: doSmoothing, MG_solver_CPU.cpp:573-604, with damping ω
  * red-black Gauss-Seidel sweep: GaussSeidel, MG_solver_CPU.cpp:996-1055
  * smoothing error: MG_solver_CPU.cpp:607-622, including the reference's
    color bug under ``compat=True`` (the even color counted twice, the odd
    color never; SURVEY.md §5)

Layout: arrays are (n, n), indexed [iy, ix]; smoothers never modify the
boundary and the residual is 0 there. Functions return new tensors and leave
their arguments untouched. The operation order follows the JAX oracle term
for term, so float64 results agree to rounding.
"""

from __future__ import annotations

import torch


def _nb_sum(u: torch.Tensor) -> torch.Tensor:
    """Sum of the four neighbors for every interior point; shape (n-2, n-2)."""
    return u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]


def residual(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """r = ∇²u − f on the interior, 0 on the boundary (5-point stencil)."""
    inv_h2 = 1.0 / (h * h)
    r = torch.zeros_like(u)
    r[1:-1, 1:-1] = inv_h2 * (_nb_sum(u) - 4.0 * u[1:-1, 1:-1]) - f[1:-1, 1:-1]
    return r


def interior_color_masks(n: int, dtype=torch.bool, device="cpu"):
    """(even, odd) checkerboard masks over the (n-2, n-2) interior.

    "Even" means (iy + ix) % 2 == 0 in full-grid coordinates, the color the
    reference's smoother error counts (MG_solver_CPU.cpp:610)."""
    i = torch.arange(1, n - 1, device=device)
    par = (i[:, None] + i[None, :]) % 2
    return (par == 0).to(dtype), (par == 1).to(dtype)


def jacobi_sweep(u: torch.Tensor, f: torch.Tensor, h: float,
                 omega: float = 1.0) -> torch.Tensor:
    """One damped Jacobi sweep, boundary untouched:
    u_new = u + ω·¼(Σ neighbors − 4u − h²f) (MG_solver_CPU.cpp:590-603)."""
    h2 = h * h
    incr = 0.25 * (_nb_sum(u) - 4.0 * u[1:-1, 1:-1] - h2 * f[1:-1, 1:-1])
    out = u.clone()
    out[1:-1, 1:-1] = u[1:-1, 1:-1] + omega * incr
    return out


def redblack_gs_sweep(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep: even half-sweep, then odd half-sweep,
    the odd half reading the fresh even values."""
    h2 = h * h
    even, odd = interior_color_masks(u.shape[0], u.dtype, u.device)

    def half(u, mask):
        val = 0.25 * (_nb_sum(u) - h2 * f[1:-1, 1:-1])
        out = u.clone()
        out[1:-1, 1:-1] = mask * val + (1 - mask) * u[1:-1, 1:-1]
        return out

    return half(half(u, even), odd)


def smoothing_error(u: torch.Tensor, f: torch.Tensor, h: float,
                    compat: bool = True) -> torch.Tensor:
    """The post-smoothing error metric driving trigger-mode schedules.

    compat=True: 2 · Σ|residual| over the even-color interior, / N² (the
    reference's color bug). compat=False: Σ|residual| over the interior / N².
    """
    r = residual(u, f, h)
    n = u.shape[0]
    if compat:
        even, _ = interior_color_masks(n, u.dtype, u.device)
        s = 2.0 * torch.sum(torch.abs(r[1:-1, 1:-1]) * even)
    else:
        s = torch.sum(torch.abs(r[1:-1, 1:-1]))
    return s / (n * n)


def gpu_smoothing_error(u_new: torch.Tensor, u_old: torch.Tensor,
                        h: float) -> torch.Tensor:
    """The GPU reference's metric: Σ|U_new − U_old| · 4/h² over the interior,
    / N² (ker_Smoothing_GPU, MG_solver_GPU.cu:633, 1266-1272)."""
    n = u_new.shape[0]
    d = torch.abs(u_new[1:-1, 1:-1] - u_old[1:-1, 1:-1])
    return torch.sum(d) * (4.0 / (h * h)) / (n * n)


def smooth(u: torch.Tensor, f: torch.Tensor, h: float, steps: int,
           omega: float = 1.0, compat=True, smoother: str = "jacobi"):
    """Run ``steps`` smoothing sweeps and return (u, error).

    ``compat`` selects the metric: True (CPU color-bugged), False (clean), or
    "gpu" (|ΔU|·4/h² of the final sweep)."""
    if smoother == "jacobi":
        def sweep(v):
            return jacobi_sweep(v, f, h, omega)
    elif smoother == "rbgs":
        def sweep(v):
            return redblack_gs_sweep(v, f, h)
    else:
        raise ValueError(f"unknown smoother {smoother!r}")
    if compat == "gpu":
        if steps == 0:
            return u, torch.zeros((), dtype=u.dtype, device=u.device)
        prev, u = u, sweep(u)
        for _ in range(steps - 1):
            prev, u = u, sweep(u)
        return u, gpu_smoothing_error(u, prev, h)
    for _ in range(steps):
        u = sweep(u)
    return u, smoothing_error(u, f, h, compat=compat)


def mean_abs_error(u: torch.Tensor, reference_u: torch.Tensor) -> torch.Tensor:
    """Mean |u − u_ref| over all N² points (MG_solver_CPU.cpp:438-445)."""
    return torch.mean(torch.abs(u - reference_u))


# --- compensated residual (port of ops/precision.py) --------------------------

def two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly (Knuth 2Sum)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def residual_compensated(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """5-point residual with a two-sum compensated stencil sum; 0 on the
    boundary. Immune to the fp32 eps·|u|/h² cancellation noise of the naive
    form (the coarse Gauss-Seidel stopping test relies on it)."""
    un, us = u[:-2, 1:-1], u[2:, 1:-1]
    uw, ue = u[1:-1, :-2], u[1:-1, 2:]
    uc = u[1:-1, 1:-1]
    hi, lo = two_sum(un, us)
    hi, e = two_sum(hi, uw)
    lo = lo + e
    hi, e = two_sum(hi, ue)
    lo = lo + e
    for _ in range(4):
        hi, e = two_sum(hi, -uc)
        lo = lo + e
    hi, lo = two_sum(hi, lo)
    inv_h2 = 1.0 / (h * h)
    r = torch.zeros_like(u)
    r[1:-1, 1:-1] = (hi * inv_h2 - f[1:-1, 1:-1]) + lo * inv_h2
    return r
