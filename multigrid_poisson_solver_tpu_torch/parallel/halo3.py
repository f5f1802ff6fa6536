"""Plain per-shard 3-D ops on z-sharded volumes: the sharded path without kernels.

No file of the JAX package holds this: under a ``ZShardingPolicy3`` without
its Pallas kernels, JAX runs the plain ``v_cycle3`` ops on global arrays and
lets GSPMD partition them (``compiled3.py:129-136``, ``tests/test_parallel3.py``).
Here each shard owns a block of z planes; before every sweep one plane per
side comes from its ring neighbours (``sharded.extend_all``, the ppermute
exchange), the masks go by global z (``ops.kernels3.ShardGeo3``), and error
sums add each shard's float64 partial over its owned interior in shard order
(``sharded.psum``), scaled and rounded once. The owned planes are the plain
unsharded ops' (``models.poisson3d``) bit for bit, and the errors theirs but
for the order of a float64 sum.

``compile_program3(..., policy=...)`` and ``v_cycle3_sharded`` run these on
sharded levels with ``kernels="torch"``.
"""

from __future__ import annotations

import torch

from ..models import poisson3d as p3
from ..ops import kernels3 as K3
from .sharded import ShardedGrid, extend_all, psum


def geo3(x: ShardedGrid, i: int, ext: int = 1) -> K3.ShardGeo3:
    """The geometry of z block i of x, its windows carrying ``ext`` planes
    per side."""
    z0, z1 = x.layout.rows[i]
    return K3.ShardGeo3(x.n, z0, z1 - z0, ext)


def sum_err3(raws, compat: str, n: int, h: float, dtype, x) -> torch.Tensor:
    """The shards' raw float64 error sums added in shard order, scaled,
    rounded to ``dtype`` once (``x``: the level they are of, as
    ``sharded.psum`` takes it)."""
    return (psum(raws, x) * p3.error_scale3(compat, n, h)).to(dtype)


def _per_shard(u: ShardedGrid, f: ShardedGrid, fn) -> ShardedGrid:
    """A grid of u's layout whose block i is fn(u_ext, f_ext, geo), the
    windows one plane deep."""
    ue, fe = extend_all(u, 1), extend_all(f, 1)
    return u.map(lambda i, j, *_: fn(ue[i, j], fe[i, j], geo3(u, i)))


def jacobi_sweep3_shard(u_ext, f_ext, geo: K3.ShardGeo3, h: float, omega: float):
    """One damped-Jacobi sweep of a shard's planes (``jacobi_sweep3``)."""
    out = K3._sweep3_ext(u_ext, f_ext, geo.inner(f_ext.device), h, omega)
    return geo.owned(out).contiguous()


def sharded_smooth3(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                    omega: float) -> ShardedGrid:
    """``steps`` Jacobi sweeps, one plane exchange per sweep."""
    for _ in range(steps):
        u = _per_shard(u, f, lambda ue, fe, g: jacobi_sweep3_shard(ue, fe, g, h, omega))
    return u


def sharded_residual3(u: ShardedGrid, f: ShardedGrid, h: float,
                      negate: bool = False) -> ShardedGrid:
    """The 7-point residual (``residual3``), optionally negated."""
    return _per_shard(u, f, lambda ue, fe, g: K3.residual3_shard_torch(ue, fe, g, h, negate))


def sharded_smoothing_error3(u: ShardedGrid, f: ShardedGrid, h: float) -> torch.Tensor:
    """The clean metric Σ|r|/n³ (``smoothing_error3``), the shards' float64
    partials added in shard order."""
    ue, fe = extend_all(u, 1), extend_all(f, 1)
    parts = [K3._raw3(torch.abs(K3._residual3_ext(
        ue[i, j], fe[i, j], geo3(u, i).inner(u.device), h)), geo3(u, i))
        for i, j in u.layout.local_order()]
    return sum_err3(parts, "clean", u.n, h, u.dtype, u)


def sharded_gpu_smoothing_error3(u_new: ShardedGrid, u_old: ShardedGrid,
                                 h: float) -> torch.Tensor:
    """The gpu metric Σ|u_new − u_old|·6/h²/n³ (``gpu_smoothing_error3``)."""
    parts = [K3._raw3(torch.abs(u_new.blocks[i][0] - u_old.blocks[i][0]), geo3(u_new, i, 0))
             for i, _ in u_new.layout.local_order()]
    return sum_err3(parts, "gpu", u_new.n, h, u_new.dtype, u_new)


def sharded_smooth3_err(u: ShardedGrid, f: ShardedGrid, h: float, steps: int, omega: float,
                        compat: str):
    """``steps`` sweeps and the error of the result: (u, err), as
    ``models.poisson3d.smooth3`` (the gpu metric of no sweep is 0)."""
    if compat == "gpu":
        if steps == 0:
            return u, torch.zeros((), dtype=u.dtype, device=u.device)
        prev = sharded_smooth3(u, f, h, steps - 1, omega)
        u = sharded_smooth3(prev, f, h, 1, omega)
        return u, sharded_gpu_smoothing_error3(u, prev, h)
    u = sharded_smooth3(u, f, h, steps, omega)
    return u, sharded_smoothing_error3(u, f, h)
