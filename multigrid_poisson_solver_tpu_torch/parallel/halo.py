"""Halo-exchange stencil ops per shard: the plain sharded path.

PyTorch port of ``multigrid_poisson_solver_tpu/parallel/halo.py``. Each shard
owns a block of grid rows (and columns, under a block policy); before every
sweep, one halo row (and column) per side comes from its ring neighbours
(``sharded.extend_all``, the counterpart of ``lax.ppermute``), and error
reductions add the shards' partials in shard order (``sharded.psum``). Masks
use the global index, so the Dirichlet boundary stays frozen and the result
on owned cells is the unsharded op's (``ops.stencils``), bit for bit for the
sweeps and the residual.

The per-shard functions take a shard's block extended by one cell per side
(``u_ext``, ``f_ext``) and its ``ShardGeo``; the whole-level wrappers take
ShardedGrids. The compiled engine runs these on sharded levels when it runs
no kernels (``kernels="torch"``), as JAX's XLA path under a policy runs
GSPMD-partitioned stencils.
"""

from __future__ import annotations

import torch

from ..ops import kernels as K
from .sharded import ShardedGrid, extend_all, psum


def shard_geo(x: ShardedGrid, i: int, j: int, ext: int = 1) -> K.ShardGeo:
    """The geometry of block (i, j) of x, its windows carrying ``ext`` halo
    cells per side."""
    (r0, r1), (c0, c1) = x.layout.rows[i], x.layout.cols[j]
    return K.ShardGeo(x.n, r0, c0, r1 - r0, c1 - c0, ext, ext)


def jacobi_sweep_shard(u_ext, f_ext, geo: K.ShardGeo, h: float, omega: float = 1.0):
    """One damped-Jacobi sweep of a shard's block (stencils.jacobi_sweep on
    its cells)."""
    inside = geo.interior(f_ext.device)
    return geo.owned(K._sweep_ext(u_ext, f_ext, inside, h, omega)).contiguous()


def redblack_half_shard(u_ext, f_ext, geo: K.ShardGeo, h: float, color: int):
    """One colored half-sweep of red-black Gauss-Seidel on a shard's block,
    the color by global parity (0: (i + j) even)."""
    dev = f_ext.device
    take = geo.interior(dev) & (geo.even(dev) if color == 0 else ~geo.even(dev))
    return geo.owned(K._rbgs_half_ext(u_ext, f_ext, take, h)).contiguous()


def residual_shard(u_ext, f_ext, geo: K.ShardGeo, h: float):
    """The 5-point residual of a shard's block, 0 off the global interior."""
    return geo.owned(K._residual_ext(u_ext, f_ext, geo.interior(f_ext.device), h)).contiguous()


def smoothing_error_shard(u_ext, f_ext, geo: K.ShardGeo, h: float, compat: bool = True):
    """A shard's partial of the smoothing error: 2·Σ|r| over its owned even
    cells (compat, the reference's color bug) or Σ|r| (JAX's form; the
    wrapper adds the partials and divides by n²)."""
    inside = geo.interior(f_ext.device)
    r = torch.abs(K._residual_ext(u_ext, f_ext, inside, h))
    if compat:
        return 2.0 * K._raw_partial(r, geo, inside, "cpu")
    return K._raw_partial(r, geo, inside, "clean")


def _per_shard(x: ShardedGrid, f: ShardedGrid, fn):
    """A grid of x's layout whose block (i, j) is fn(u_ext, f_ext, geo), the
    windows from one exchange each."""
    ue, fe = extend_all(x, 1, 1), extend_all(f, 1, 1)
    return x.map(lambda i, j, *_: fn(ue[i, j], fe[i, j], shard_geo(x, i, j)))


def sharded_smooth(u: ShardedGrid, f: ShardedGrid, h: float, steps: int, omega: float = 1.0,
                   smoother: str = "jacobi") -> ShardedGrid:
    """``steps`` smoothing sweeps (Jacobi or rb-GS), one halo exchange per
    sweep (two for rb-GS, one per color)."""
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    for _ in range(steps):
        if smoother == "jacobi":
            u = _per_shard(u, f, lambda ue, fe, g: jacobi_sweep_shard(ue, fe, g, h, omega))
        else:
            for color in (0, 1):
                u = _per_shard(u, f, lambda ue, fe, g, c=color:
                               redblack_half_shard(ue, fe, g, h, c))
    return u


def sharded_residual(u: ShardedGrid, f: ShardedGrid, h: float) -> ShardedGrid:
    return _per_shard(u, f, lambda ue, fe, g: residual_shard(ue, fe, g, h))


def sharded_smoothing_error(u: ShardedGrid, f: ShardedGrid, h: float,
                            compat: bool = True) -> torch.Tensor:
    """The smoothing error of a sharded level: the shards' partials added in
    shard order, / n²."""
    ue, fe = extend_all(u, 1, 1), extend_all(f, 1, 1)
    parts = [smoothing_error_shard(ue[i, j], fe[i, j], shard_geo(u, i, j), h, compat)
             for i, j in u.layout.local_order()]
    return psum(parts, u) / (u.n * u.n)


def sharded_gpu_smoothing_error(u_new: ShardedGrid, u_old: ShardedGrid,
                                h: float) -> torch.Tensor:
    """The GPU reference's metric, Σ|u_new − u_old| over the interior · 4/h²
    / n², the shards' partials added in shard order."""
    parts = []
    for i, j in u_new.layout.local_order():
        geo = shard_geo(u_new, i, j, 0)
        d = torch.abs(u_new.blocks[i][j] - u_old.blocks[i][j])
        parts.append(K._raw_partial(d, geo, geo.interior(d.device), "clean"))
    n = u_new.n
    return psum(parts, u_new) * (4.0 / (h * h)) / (n * n)
