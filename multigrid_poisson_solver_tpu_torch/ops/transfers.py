"""Grid transfers and level-wide metrics on plain ``(n, n)`` tensors.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/layout.py`` and
``ops/padded.py``. The port keeps no padded tile layout: every level is a
contiguous (n, n) tensor, so the pad masks, the row/lane split of the 2:1
transfers and the tile bookkeeping of those modules have no counterpart.
What remains are the 2:1 operators the fused kernels' plain twins are built
from, with the JAX package's operation order:

  * ``sample_restrict``: 2:1 sampling (the aligned case of the bilinear
    zoom, doRestriction), zero boundary;
  * ``full_weighting_restrict``: separable [¼, ½, ¼]² then even sampling;
  * ``prolong``: 2:1 bilinear prolongation, columns first then rows, as the
    gather zoom and the fused ascend kernel compute it;
  * ``add_correction``: interior-only add (doGridAddition);
  * ``relative_residual_norm``: compensated ‖r‖₂/‖f‖₂ over the interior.
"""

from __future__ import annotations

import torch

from .stencils import residual_compensated


def _check_aligned(n: int, m: int) -> None:
    if n != 2 * m - 1:
        raise ValueError(f"2:1 transfer needs n == 2*m - 1, got {n} -> {m}")


def sample_restrict(d: torch.Tensor, m: int) -> torch.Tensor:
    """Coarse (m, m) grid sampling d at even fine points, boundary zero."""
    _check_aligned(d.shape[0], m)
    out = torch.zeros((m, m), dtype=d.dtype, device=d.device)
    out[1:-1, 1:-1] = d[2:-2:2, 2:-2:2]
    return out


def full_weighting_restrict(d: torch.Tensor, m: int) -> torch.Tensor:
    """Full-weighting 2:1 restriction of d onto (m, m), boundary zero:
    rows (¼·d[i−1] + ½·d[i]) + ¼·d[i+1] at even i, then the same along
    columns at even j (the JAX ``full_weighting_restrict_p`` order)."""
    n = d.shape[0]
    _check_aligned(n, m)
    sy = (0.25 * d[1:n - 3:2] + 0.5 * d[2:n - 2:2]) + 0.25 * d[3:n - 1:2]
    sxy = ((0.25 * sy[:, 1:n - 3:2] + 0.5 * sy[:, 2:n - 2:2])
           + 0.25 * sy[:, 3:n - 1:2])
    out = torch.zeros((m, m), dtype=d.dtype, device=d.device)
    out[1:-1, 1:-1] = sxy
    return out


def prolong(c: torch.Tensor, n: int) -> torch.Tensor:
    """2:1 bilinear prolongation of a coarse (m, m) grid onto (n, n):
    fine(2I, 2J) = c(I, J), odd points average their 2 (or 4) neighbors as
    ½a + ½b, columns first then rows."""
    m = c.shape[0]
    _check_aligned(n, m)
    wide = torch.empty((m, n), dtype=c.dtype, device=c.device)
    wide[:, ::2] = c
    wide[:, 1::2] = 0.5 * c[:, :-1] + 0.5 * c[:, 1:]
    out = torch.empty((n, n), dtype=c.dtype, device=c.device)
    out[::2] = wide
    out[1::2] = 0.5 * wide[:-1] + 0.5 * wide[1:]
    return out


def add_correction(u: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
    """u + corr on the interior only; the boundary keeps its Dirichlet data."""
    out = u.clone()
    out[1:-1, 1:-1] = u[1:-1, 1:-1] + corr[1:-1, 1:-1]
    return out


def relative_residual_norm(u: torch.Tensor, f: torch.Tensor, h: float) -> torch.Tensor:
    """Compensated ‖r‖₂ / ‖f‖₂ over the interior (the benchmark's convergence
    metric). Pass float64 copies for a figure free of fp32 rounding."""
    r = residual_compensated(u, f, h)
    num = torch.linalg.vector_norm(r[1:-1, 1:-1])
    den = torch.linalg.vector_norm(f[1:-1, 1:-1])
    return num / torch.clamp(den, min=torch.finfo(u.dtype).tiny)
