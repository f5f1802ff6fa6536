"""3-D geometric multigrid: the oracle ops, the problems and the V-cycle.

PyTorch port of ``multigrid_poisson_solver_tpu/models/poisson3d.py``. Grids
are vertex-centered contiguous (n, n, n) tensors over [0, 1]³ indexed
[z, y, x], with Dirichlet boundaries; hierarchies use the odd-halve rule
n → (n+1)/2 (2:1 vertex alignment). The functions here are plain tensor code
with the JAX oracle's operation order, so float64 results agree to rounding;
they are what the plain twins of the 3-D kernels (``ops.kernels3``) are
built from.

``v_cycle3`` runs either these ops alone (``kernels="torch"``) or, on levels
of at least 65³, the hand-written CUDA kernels of ``ops.kernels3`` in the
order the JAX package's kernel path (``v_cycle3_p``) runs them.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Callable, Optional

import numpy as np
import torch

# levels below this run the plain ops on the kernel path (compiled3._PALLAS3_MIN_N)
KERNEL3_MIN_N = 65


def _nb_sum3(u: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbors for every interior point, (n-2)³:
    ((((z− + z+) + y−) + y+) + x−) + x+."""
    return (u[:-2, 1:-1, 1:-1] + u[2:, 1:-1, 1:-1]
            + u[1:-1, :-2, 1:-1] + u[1:-1, 2:, 1:-1]
            + u[1:-1, 1:-1, :-2] + u[1:-1, 1:-1, 2:])


def residual3(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """r = ∇²u − f (7-point stencil) on the interior, 0 on the boundary."""
    inv_h2 = 1.0 / (h * h)
    r = torch.zeros_like(u)
    r[1:-1, 1:-1, 1:-1] = (inv_h2 * (_nb_sum3(u) - 6.0 * u[1:-1, 1:-1, 1:-1])
                           - f[1:-1, 1:-1, 1:-1])
    return r


def jacobi_sweep3(u: torch.Tensor, f: torch.Tensor, h: float,
                  omega: float = 0.857) -> torch.Tensor:
    """One damped Jacobi sweep, u + (ω/6)·((Σnb − 6u) − h²f) on the interior
    (ω = 6/7 damps the checkerboard mode to |1 − 2ω| ≈ 5/7)."""
    incr = (_nb_sum3(u) - 6.0 * u[1:-1, 1:-1, 1:-1]) - (h * h) * f[1:-1, 1:-1, 1:-1]
    out = u.clone()
    out[1:-1, 1:-1, 1:-1] = u[1:-1, 1:-1, 1:-1] + (omega / 6.0) * incr
    return out


def _even_mask3(n: int, dtype, device) -> torch.Tensor:
    """1 where (z + y + x) is even over the (n-2)³ interior, else 0."""
    i = torch.arange(1, n - 1, device=device)
    par = (i[:, None, None] + i[None, :, None] + i[None, None, :]) % 2
    return (par == 0).to(dtype)


def redblack_gs_sweep3(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """One red-black Gauss-Seidel sweep: the even (z+y+x) half, then the odd
    half reading the fresh even values."""
    h2 = h * h
    even = _even_mask3(u.shape[0], u.dtype, u.device)

    def half(u, mask):
        val = (_nb_sum3(u) - h2 * f[1:-1, 1:-1, 1:-1]) / 6.0
        out = u.clone()
        out[1:-1, 1:-1, 1:-1] = mask * val + (1 - mask) * u[1:-1, 1:-1, 1:-1]
        return out

    return half(half(u, even), 1.0 - even)


def error_scale3(compat: str, n: int, h: float) -> float:
    """The factor from Σ|r| (clean) or Σ|U_new − U_old| (gpu) to the metric."""
    return (6.0 / (h * h) if compat == "gpu" else 1.0) / n ** 3


def _sum64(terms: torch.Tensor, scale: float, dtype) -> torch.Tensor:
    """Σ terms·scale in float64, rounded to ``dtype`` once. An fp32 sum's
    value depends on its order by ~1e-6 relative, enough to flip a trigger
    loop's stop where a slope ends near the threshold; this one hardly
    depends on it, and the 3-D kernels sum their errors alike."""
    return (torch.sum(terms, dtype=torch.float64) * scale).to(dtype)


def smoothing_error3(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """Mean |residual| over all n³ points (the clean metric)."""
    n = u.shape[0]
    r = residual3(u, f, h)
    return _sum64(torch.abs(r[1:-1, 1:-1, 1:-1]), error_scale3("clean", n, h), u.dtype)


def gpu_smoothing_error3(u_new: torch.Tensor, u_old: torch.Tensor,
                         h: float) -> torch.Tensor:
    """Mean |U_new − U_old|·6/h² over all n³ points (the GPU reference's
    metric one dimension up)."""
    n = u_new.shape[0]
    d = torch.abs(u_new[1:-1, 1:-1, 1:-1] - u_old[1:-1, 1:-1, 1:-1])
    return _sum64(d, error_scale3("gpu", n, h), u_new.dtype)


def _sweep_fn(smoother: str, omega: float):
    if smoother == "jacobi":
        return lambda u, f, h: jacobi_sweep3(u, f, h, omega)
    if smoother == "rbgs":
        return redblack_gs_sweep3
    raise ValueError(f"unknown smoother {smoother!r}")


def smooth3(u, f, h: float, steps: int, omega: float = 0.857, compat="clean",
            smoother: str = "jacobi"):
    """``steps`` sweeps, then the error metric: (u, err). ``compat="gpu"``
    takes |ΔU|·6/h² of the last sweep, anything else the clean metric."""
    sweep = _sweep_fn(smoother, omega)
    if compat == "gpu":
        if steps == 0:
            return u, torch.zeros((), dtype=u.dtype, device=u.device)
        prev, u = u, sweep(u, f, h)
        for _ in range(steps - 1):
            prev, u = u, sweep(u, f, h)
        return u, gpu_smoothing_error3(u, prev, h)
    for _ in range(steps):
        u = sweep(u, f, h)
    return u, smoothing_error3(u, f, h)


def trigger_smooth3(u, f, h: float, trigger: float, omega: float, compat,
                    smoother: str, max_sweeps: int):
    """Error-triggered smoothing: sweep while |err_k − err_{k−1}| > trigger,
    at most ``max_sweeps``; one host read per sweep. Returns (u, err, sweeps)."""
    from ..solver import trigger_loop

    sweep = _sweep_fn(smoother, omega)

    def step(v):
        v_new = sweep(v, f, h)
        if compat == "gpu":
            return v_new, gpu_smoothing_error3(v_new, v, h)
        return v_new, smoothing_error3(v_new, f, h)

    return trigger_loop(step, u, trigger, max_sweeps)


@lru_cache(maxsize=8)
def _laplacian3_inverse_np(n: int, h: float) -> np.ndarray:
    """float64 inverse of the interior 7-point Laplacian on an n³ grid
    ((n−2)³ unknowns), capped at 4096 unknowns as in the JAX package."""
    m = n - 2
    if m ** 3 > 4096:
        raise ValueError(
            f"dense 3-D coarse solve capped at 4096 unknowns, got {m ** 3} "
            f"(n={n}); use the red-black GS option for bigger coarse grids")
    eye = np.eye(m, dtype=np.float64)
    lap1 = (np.diag(np.full(m - 1, 1.0), 1) + np.diag(np.full(m - 1, 1.0), -1)
            - 2.0 * eye)
    a = (np.kron(np.kron(lap1, eye), eye) + np.kron(np.kron(eye, lap1), eye)
         + np.kron(np.kron(eye, eye), lap1)) / (h * h)
    return np.linalg.inv(a)


@lru_cache(maxsize=16)
def _laplacian3_inverse(n: int, h: float, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
    """The inverse cast to ``dtype`` and resident on ``device``."""
    return torch.as_tensor(_laplacian3_inverse_np(n, h)).to(device=device, dtype=dtype)


def dense_solve3(f: torch.Tensor, h: float) -> torch.Tensor:
    """Exact coarse solve through the cached dense inverse (CoarseSolve option
    0): ``f`` carries the Dirichlet values on its border and the right-hand
    side inside; the boundary terms move to the right-hand side."""
    n = f.shape[0]
    inv = _laplacian3_inverse(n, float(h), f.dtype, f.device)
    bc = f.clone()
    bc[1:-1, 1:-1, 1:-1] = 0
    rhs = f[1:-1, 1:-1, 1:-1] - _nb_sum3(bc) / (h * h)
    m = n - 2
    out = bc
    out[1:-1, 1:-1, 1:-1] = (inv @ rhs.reshape(-1)).reshape(m, m, m)
    return out


def gauss_seidel_solve3(f: torch.Tensor, h: float, target: float,
                        norm: str = "interior", max_iters: int = 100_000):
    """Red-black GS at the coarsest level from the Dirichlet data until the
    mean |residual| ≤ target, with the JAX engine's stagnation stop (an
    improvement of less than a 1e-7 share ends the loop). One host read per
    sweep. Returns (u, err, iterations)."""
    n = f.shape[0]
    u = f.clone()
    u[1:-1, 1:-1, 1:-1] = 0
    denom = (n - 2) ** 3 if norm == "interior" else n ** 3

    def err_of(v):
        r = residual3(v, f, h)
        return torch.sum(torch.abs(r[1:-1, 1:-1, 1:-1])) / denom

    u = redblack_gs_sweep3(u, f, h)
    err = err_of(u)
    prev = torch.tensor(math.inf, dtype=err.dtype, device=err.device)
    k = 1
    while k < max_iters and bool((err > target) & (err < prev * (1.0 - 1e-7))):
        u = redblack_gs_sweep3(u, f, h)
        prev, err = err, err_of(u)
        k += 1
    return u, err, k


def restrict3(d: torch.Tensor, m: int) -> torch.Tensor:
    """2:1 full-weighting restriction onto (m, m, m), zero boundary:
    (¼·d[i−1] + ½·d[i]) + ¼·d[i+1] along z, then y, then x, at the even
    fine points (needs n == 2m − 1)."""
    n = d.shape[0]
    if n != 2 * m - 1:
        raise ValueError(f"need n == 2m-1, got {n} -> {m}")
    s = (0.25 * d[1:n - 3:2] + 0.5 * d[2:n - 2:2]) + 0.25 * d[3:n - 1:2]
    s = (0.25 * s[:, 1:n - 3:2] + 0.5 * s[:, 2:n - 2:2]) + 0.25 * s[:, 3:n - 1:2]
    s = (0.25 * s[:, :, 1:n - 3:2] + 0.5 * s[:, :, 2:n - 2:2]) + 0.25 * s[:, :, 3:n - 1:2]
    out = torch.zeros((m, m, m), dtype=d.dtype, device=d.device)
    out[1:-1, 1:-1, 1:-1] = s
    return out


def prolong3(uc: torch.Tensor, n: int) -> torch.Tensor:
    """2:1 trilinear prolongation: even fine points copy, odd ones take
    ½·(a + b) of their two neighbors, along z, then y, then x."""
    m = uc.shape[0]
    if n != 2 * m - 1:
        raise ValueError(f"need n == 2m-1, got {m} -> {n}")
    a = torch.empty((n, m, m), dtype=uc.dtype, device=uc.device)
    a[::2] = uc
    a[1::2] = 0.5 * (uc[:-1] + uc[1:])
    b = torch.empty((n, n, m), dtype=uc.dtype, device=uc.device)
    b[:, ::2] = a
    b[:, 1::2] = 0.5 * (a[:, :-1] + a[:, 1:])
    out = torch.empty((n, n, n), dtype=uc.dtype, device=uc.device)
    out[:, :, ::2] = b
    out[:, :, 1::2] = 0.5 * (b[:, :, :-1] + b[:, :, 1:])
    return out


Field3D = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Problem3D:
    """∇²u = f on [0, 1]³ with a Dirichlet boundary; fields take (x, y, z)
    coordinate tensors (indexing "ij")."""

    source: Field3D
    boundary: Optional[Field3D] = None
    analytic: Optional[Field3D] = None
    name: str = "custom3d"

    def _grid(self, fn, n: int, dtype, device) -> torch.Tensor:
        # x_i = i / (n − 1) correctly rounded, as jnp.linspace(0, 1, n) gives
        # it (torch.linspace rounds differently); a tensor divisor keeps the
        # division exact on CUDA, which multiplies by a scalar's reciprocal
        x = (torch.arange(n, dtype=dtype, device=device)
             / torch.full((), n - 1, dtype=dtype, device=device))
        X, Y, Z = torch.meshgrid(x, x, x, indexing="ij")
        return fn(X, Y, Z).to(dtype)

    def source_grid(self, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
        return self._grid(self.source, n, dtype, device)

    def boundary_grid(self, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
        """The Dirichlet data on the border and 0 inside."""
        if self.boundary is None:
            return torch.zeros((n, n, n), dtype=dtype, device=device)
        g = self._grid(self.boundary, n, dtype, device)
        g[1:-1, 1:-1, 1:-1] = 0
        return g

    def analytic_grid(self, n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
        if self.analytic is None:
            raise ValueError(f"problem {self.name!r} has no analytic solution")
        return self._grid(self.analytic, n, dtype, device)


_TWO_PI = 2 * math.pi

# manufactured 3-D analog of the reference's 2-D problem
REFERENCE_PROBLEM_3D = Problem3D(
    source=lambda x, y, z: -3.0 * _TWO_PI ** 2
    * torch.sin(_TWO_PI * x) * torch.sin(_TWO_PI * y) * torch.sin(_TWO_PI * z),
    analytic=lambda x, y, z: torch.sin(_TWO_PI * x)
    * torch.sin(_TWO_PI * y) * torch.sin(_TWO_PI * z),
    name="sine3d",
)

# degree-2-per-axis polynomial solution: the discrete solution is h-exact
POLY_PROBLEM_3D = Problem3D(
    source=lambda x, y, z: -2.0 * (y * (1 - y) * z * (1 - z)
                                   + x * (1 - x) * z * (1 - z)
                                   + x * (1 - x) * y * (1 - y)),
    analytic=lambda x, y, z: x * (1 - x) * y * (1 - y) * z * (1 - z),
    name="poly3d",
)

# boundary-driven harmonic problem: f = 0, u the harmonic extension
HARMONIC_PROBLEM_3D = Problem3D(
    source=lambda x, y, z: torch.zeros_like(x),
    boundary=lambda x, y, z: x * x - 0.5 * y * y - 0.5 * z * z,
    analytic=lambda x, y, z: x * x - 0.5 * y * y - 0.5 * z * z,
    name="harmonic3d",
)

BUILTIN_PROBLEMS_3D = {
    "reference": REFERENCE_PROBLEM_3D,
    "poly": POLY_PROBLEM_3D,
    "harmonic": HARMONIC_PROBLEM_3D,
}


def _sizes(n_max: int, n_min: int) -> list[int]:
    sizes = [n_max]
    while sizes[-1] > n_min and (sizes[-1] + 1) % 2 == 0 and sizes[-1] >= 5:
        m = (sizes[-1] + 1) // 2
        if m < n_min or m == sizes[-1]:
            break
        sizes.append(m)
    return sizes


def v_cycle3(u, f, h: float, n_min: int = 5, pre: int = 2, post: int = 2,
             coarse_sweeps: int = 50, omega: float = 0.857, kernels: str = "auto"):
    """One recursive 3-D V-cycle with full-weighting restriction and the
    coarsest level relaxed by ``coarse_sweeps`` Jacobi sweeps.

    ``kernels`` is "auto" (the CUDA kernels when u lies on a CUDA device),
    "cuda" or "torch" (the oracle ops only). The kernel path runs, on levels
    of at least 65³, the fused descend leg, the fused ascend leg, the fused
    smoother and the residual kernel where the JAX package's kernel path
    (``v_cycle3_p``) runs them; smaller levels use the oracle ops."""
    if u.dim() != 3 or f.shape != u.shape:
        raise ValueError(f"expected (n, n, n) u and f, got {tuple(u.shape)}, {tuple(f.shape)}")
    from ..ops import kernels as K

    sizes = _sizes(u.shape[0], n_min)
    if K.use_kernels(kernels, u.device):
        return _v_cycle3_kernels(u, f, h, sizes, pre, post, coarse_sweeps, omega)

    def smooth(u, f, h, k):
        for _ in range(k):
            u = jacobi_sweep3(u, f, h, omega)
        return u

    def run(u, f, h, depth):
        n = u.shape[0]
        if depth == len(sizes) - 1:
            return smooth(u, f, h, coarse_sweeps)
        u = smooth(u, f, h, pre)
        m = sizes[depth + 1]
        fc = restrict3(-residual3(u, f, h), m)
        ec = run(torch.zeros((m, m, m), dtype=u.dtype, device=u.device), fc, 2 * h, depth + 1)
        u = u + prolong3(ec, n)
        u[0] = 0   # prolongation keeps the z faces at 0 anyway
        u[-1] = 0
        return smooth(u, f, h, post)

    return run(u, f, h, 0)


def _v_cycle3_kernels(u, f, h: float, sizes, pre: int, post: int, coarse_sweeps: int,
                      omega: float):
    """``v_cycle3`` on the kernel path (the JAX package's ``v_cycle3_p`` on
    plain tensors)."""
    from ..ops import kernels3 as K3
    from ..ops import transfers3 as T3

    def smooth(u, f, nn, h, k, from_zero=False):
        if nn >= KERNEL3_MIN_N:
            while k > 0:
                kk = min(k, K3.MAX_FUSED_SWEEPS_3D)
                u = K3.fused_jacobi3(u, f, h, kk, omega, from_zero)
                from_zero = False
                k -= kk
            return u
        if from_zero:
            u = torch.zeros_like(u)
        for _ in range(k):
            u = jacobi_sweep3(u, f, h, omega)
        return u

    def run(u, f, nn, h, depth, from_zero):
        if depth == len(sizes) - 1:
            return smooth(u, f, nn, h, coarse_sweeps, from_zero)
        m = sizes[depth + 1]
        if nn >= KERNEL3_MIN_N and 1 <= pre - from_zero <= K3.MAX_DESCEND3_SWEEPS_FW:
            u, fc, _ = K3.fused_descend3(u, f, h, pre, omega, from_zero=from_zero)
        else:
            u = smooth(u, f, nn, h, pre, from_zero)
            rneg = (K3.residual3(u, f, h, negate=True) if nn >= KERNEL3_MIN_N
                    else -residual3(u, f, h))
            fc = T3.restrict3(rneg, m)
        # the zero iterate is never read: the coarse level starts from_zero
        ec = run(torch.zeros_like(fc), fc, m, 2 * h, depth + 1, True)
        if nn >= KERNEL3_MIN_N and 1 <= post <= K3.MAX_FUSED_SWEEPS_3D:
            return K3.fused_ascend3(u, f, ec, h, post, omega)[0]
        u = T3.prolong3_add(u, ec)
        return smooth(u, f, nn, h, post)

    return run(u, f, sizes[0], h, 0, False)


def solve3(problem: Problem3D, n: int, cycles: int = 10, dtype=torch.float32,
           kernels: str = "auto", device="cuda"):
    """Chained 3-D V-cycles from the boundary data; returns (u, mean
    |u − analytic| or None)."""
    h = 1.0 / (n - 1)
    f = problem.source_grid(n, dtype, device) + problem.boundary_grid(n, dtype, device)
    u = problem.boundary_grid(n, dtype, device)
    for _ in range(cycles):
        u = v_cycle3(u, f, h, kernels=kernels)
    err = None
    if problem.analytic is not None:
        err = float(torch.mean(torch.abs(u - problem.analytic_grid(n, dtype, device))))
    return u, err
