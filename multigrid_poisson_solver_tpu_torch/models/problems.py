"""Problem definitions: source term, Dirichlet boundary, optional analytic solution.

PyTorch port of ``multigrid_poisson_solver_tpu/models/problems.py``. A
:class:`Problem` bundles callables evaluated on grid coordinate tensors;
:data:`REFERENCE_PROBLEM` is the reference's manufactured solution
(getSource/getBoundary/getAnalytic, MG_solver_CPU.cpp:468-548).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..grid import GridSpec

Field2D = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # (x, y) -> value


def _zero_field(x, y):
    return torch.zeros_like(x)


def _zero_border(a: torch.Tensor) -> torch.Tensor:
    a = a.clone()
    a[0, :] = 0
    a[-1, :] = 0
    a[:, 0] = 0
    a[:, -1] = 0
    return a


@dataclasses.dataclass(frozen=True)
class Problem:
    """A 2D Poisson problem ``∇²u = f`` on a square with Dirichlet boundary.

    Attributes:
        source: f(x, y) evaluated at interior points.
        boundary: u(x, y) evaluated on the boundary (Dirichlet data).
        analytic: optional exact solution for validation.
        name: identifier used in logs/reports.
    """

    source: Field2D
    boundary: Field2D = _zero_field
    analytic: Optional[Field2D] = None
    name: str = "custom"

    def source_grid(self, spec: GridSpec, dtype=torch.float32,
                    device="cpu") -> torch.Tensor:
        """RHS with boundary entries zeroed (getSource, MG_solver_CPU.cpp:468-491)."""
        x, y = spec.coords(dtype, device)
        return _zero_border(self.source(x, y).to(dtype))

    def boundary_grid(self, spec: GridSpec, dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
        """The Dirichlet data on the border and 0 inside."""
        x, y = spec.coords(dtype, device)
        g = self.boundary(x, y).to(dtype)
        out = torch.zeros(spec.shape, dtype=dtype, device=device)
        out[0, :] = g[0, :]
        out[-1, :] = g[-1, :]
        out[:, 0] = g[:, 0]
        out[:, -1] = g[:, -1]
        return out

    def analytic_grid(self, spec: GridSpec, dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
        """Exact solution on the interior, boundary data on the border
        (getAnalytic, MG_solver_CPU.cpp:525-548)."""
        if self.analytic is None:
            raise ValueError(f"problem {self.name!r} has no analytic solution")
        x, y = spec.coords(dtype, device)
        u = self.analytic(x, y).to(dtype)
        return _zero_border(u) + self.boundary_grid(spec, dtype, device)


# --- The reference's manufactured problem -----------------------------------
# source   f = 2 x (y - 1) (y - 2x + xy + 2) e^(x - y)   (MG_solver_CPU.cpp:488)
# boundary u = 0                                          (MG_solver_CPU.cpp:497-523)
# analytic u = e^(x - y) x (1 - x) y (1 - y)              (MG_solver_CPU.cpp:543)

def _ref_source(x, y):
    return 2.0 * x * (y - 1.0) * (y - 2.0 * x + x * y + 2.0) * torch.exp(x - y)


def _ref_analytic(x, y):
    return torch.exp(x - y) * x * (1.0 - x) * y * (1.0 - y)


REFERENCE_PROBLEM = Problem(
    source=_ref_source,
    boundary=_zero_field,
    analytic=_ref_analytic,
    name="reference-manufactured",
)


# --- Additional built-in problem families ------------------------------------

def sine_problem(kx: int = 1, ky: int = 1) -> Problem:
    """u = sin(kx·πx)·sin(ky·πy): smooth eigenfunction problem, zero boundary."""
    cx, cy = kx * math.pi, ky * math.pi

    def source(x, y):
        return -(cx * cx + cy * cy) * torch.sin(cx * x) * torch.sin(cy * y)

    def analytic(x, y):
        return torch.sin(cx * x) * torch.sin(cy * y)

    return Problem(source=source, analytic=analytic, name=f"sine-{kx}-{ky}")


def polynomial_problem() -> Problem:
    """u = x(1-x)y(1-y): lowest-order polynomial with zero boundary."""

    def source(x, y):
        return -2.0 * (y * (1.0 - y) + x * (1.0 - x))

    def analytic(x, y):
        return x * (1.0 - x) * y * (1.0 - y)

    return Problem(source=source, analytic=analytic, name="polynomial")


def gaussian_charge_problem(x0: float = 0.5, y0: float = 0.5,
                            sigma: float = 0.05) -> Problem:
    """Point-like Gaussian charge; no closed-form solution (validation via residual)."""

    def source(x, y):
        r2 = (x - x0) ** 2 + (y - y0) ** 2
        return torch.exp(-r2 / (2.0 * sigma * sigma))

    return Problem(source=source, name="gaussian-charge")


BUILTIN_PROBLEMS = {
    "reference": REFERENCE_PROBLEM,
    "sine": sine_problem(),
    "polynomial": polynomial_problem(),
    "gaussian": gaussian_charge_problem(),
}
