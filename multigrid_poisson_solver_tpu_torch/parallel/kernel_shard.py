"""The fused kernels on sharded levels: one halo exchange per pass, then the
shard-mode kernel on every shard.

PyTorch port of ``multigrid_poisson_solver_tpu/parallel/pallas_shard.py``
(named for what it holds: the port's kernels are CUDA, not Pallas). Per
fused pass (at most 8 sweeps, 4 for rb-GS) each shard's block is extended by
8 rows (and 8 columns under a block policy) of its ring neighbours
(``sharded.extend_all``, the ppermute exchange: one batched exchange a call
site, across processes too), and the shard-mode kernel
(``ops.kernels``, ``*_shard``) runs on it with the block's global origin, so
the Dirichlet masks stay exact and the owned cells are the unsharded
kernel's, bit for bit (the trapezoid argument of the single-device tiles
applies to the shard halo as it does to the tile halo). Errors come back as
each shard's raw partial over its owned cells; they are added in shard
order (``sharded.psum``) and scaled once, the order the ring kernels of
``ops.rdma`` use too.

``rdma_fused_jacobi`` and ``rdma_fused_trigger`` take the ring kernels
instead (``SolverConfig(halo="rdma")``); like JAX's they are for rows-only
layouts.

Every function takes and returns ``ShardedGrid``s and works on this
process's blocks (every process calls it). The shard-mode kernels
are looked up in ``ops.kernels`` at each call, so replacing them there by
their ``*_torch`` twins runs these wrappers on the twins (CPU blocks always
run them). Each shard's kernel launches with its shard's card current, so a
mesh may span several cards.
"""

from __future__ import annotations

from ..ops import kernels as K
from ..ops import rdma
from .sharded import Layout, ShardedGrid, exchange, extend_all, on_device, psum

HALO = 8  # rows (and columns) of a shard's halo per fused pass


def _ext_c(x: ShardedGrid, k: int) -> int:
    """Halo columns of a layout's blocks: k where columns are split."""
    return k if len(x.layout.cols) > 1 else 0


def _geo(x: ShardedGrid, i: int, j: int, ext_r: int, ext_c: int) -> K.ShardGeo:
    (r0, r1), (c0, c1) = x.layout.rows[i], x.layout.cols[j]
    return K.ShardGeo(x.n, r0, c0, r1 - r0, c1 - c0, ext_r, ext_c)


def _rows_only(x: ShardedGrid, what: str):
    if len(x.layout.cols) != 1:
        raise ValueError(f"{what} supports 1-D row partitions; use the exchange path "
                         f"(halo='ppermute') for 2-D block policies")


def _err_scale(err_mode: str, n: int, h: float, smoother: str = "jacobi") -> float:
    """Sum of raw shard partials → the reference metric (JAX's
    ``pallas_shard._err_scale``; the port's kernels sum |r| where JAX's sum
    |Δ|, hence no ω)."""
    return K.shard_err_scale(err_mode, n, h, smoother)


class _Pass:
    """The exchanged windows of one fused pass over every shard."""

    def __init__(self, f: ShardedGrid):
        self.f = f
        self.ec = _ext_c(f, HALO)
        self.f_ext = extend_all(f, HALO, self.ec)

    def geo(self, i, j):
        return _geo(self.f, i, j, HALO, self.ec)

    def u_ext(self, u: ShardedGrid) -> dict:
        """Every local block of u with the pass's halo (one exchange)."""
        return extend_all(u, HALO, self.ec)


def _each(x: ShardedGrid, fn) -> dict:
    """{(i, j): fn(i, j)} over this process's shards of x in shard order,
    each call with its shard's card current."""
    out = {}
    for i, j in x.layout.local_order():
        with on_device(x.layout.devices[i][j]):
            out[i, j] = fn(i, j)
    return out


def _grid(x: ShardedGrid, blocks: dict) -> ShardedGrid:
    return x.map(lambda i, j, b: blocks[i, j])


def _passes(u: ShardedGrid, px: _Pass, steps: int, cap: int, from_zero: bool, fn):
    """``steps`` sweeps as passes of at most ``cap``; fn(u_ext, f_ext, geo, k,
    fz) runs one pass on one shard and returns its owned block."""
    first = True
    while steps > 0:
        k = min(steps, cap)
        fz = from_zero and first
        ue = None if fz else px.u_ext(u)
        u = _grid(u, _each(u, lambda i, j, k=k, fz=fz: fn(
            None if fz else ue[i, j], px.f_ext[i, j], px.geo(i, j), k, fz)))
        steps -= k
        first = False
    return u


def _smooth(u, f, h, steps, omega, from_zero, smoother, op) -> ShardedGrid:
    cap = K.MAX_FUSED_RBGS if smoother == "rbgs" else K.MAX_FUSED_SWEEPS
    return _passes(u, _Pass(f), steps, cap, from_zero,
                   lambda ue, fe, g, k, fz: op(ue, fe, g, h, k, omega, fz, None, smoother)[0])


def sharded_fused_jacobi(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                         omega: float = 1.0, from_zero: bool = False,
                         smoother: str = "jacobi") -> ShardedGrid:
    """``steps`` fused smoothing sweeps of a sharded level (ω ignored for
    rb-GS); owned cells bit-match the unsharded kernel. One exchange per
    pass of ≤ 8 sweeps (≤ 4 for rb-GS). ``from_zero``: u ≡ 0, not read."""
    return _smooth(u, f, h, steps, omega, from_zero, smoother, K.fused_jacobi_shard)


def sharded_residual(u: ShardedGrid, f: ShardedGrid, h: float,
                     negate: bool = False) -> ShardedGrid:
    """The 5-point residual of a sharded level (one halo row and column):
    one ``K.residual_shards`` call per card over the shards that live there,
    in shard order, with that card current."""
    ec = _ext_c(f, 1)
    lay = f.layout
    by_card: dict = {}
    for ij in lay.local_order():
        by_card.setdefault(lay.devices[ij[0]][ij[1]], []).append(ij)
    ue, fe = extend_all(u, 1, ec), extend_all(f, 1, ec)
    blocks = {}
    for dev, ijs in by_card.items():
        with on_device(dev):
            rs = K.residual_shards([ue[ij] for ij in ijs], [fe[ij] for ij in ijs],
                                   [_geo(f, i, j, 1, ec) for i, j in ijs], h, negate)
        blocks.update(zip(ijs, rs))
    return _grid(u, blocks)


def _sum_err(raws, mode, x: ShardedGrid, h, smoother="jacobi"):
    """The shards' raw partials of level x added in shard order, then
    scaled."""
    return psum(raws, x) * _err_scale(mode, x.n, h, smoother)


def _smooth_err(u, f, h, steps, omega, compat, from_zero, smoother, op):
    mode = K.err_mode_of(compat)
    if smoother == "rbgs":
        if mode == "gpu":
            raise ValueError("rb-GS fuses only the cpu and clean metrics")
        cap, last_cap = K.MAX_FUSED_RBGS, (HALO - 1) // 2
    else:
        cap, last_cap = K.MAX_FUSED_SWEEPS, K.errs_sweep_cap(compat)
    if steps < 1:
        raise ValueError(f"an error pass needs at least one sweep, got {steps}")
    px = _Pass(f)
    last = min(steps, last_cap)
    if steps > last:
        u = _passes(u, px, steps - last, cap, from_zero,
                    lambda ue, fe, g, k, fz: op(ue, fe, g, h, k, omega, fz, None, smoother)[0])
        from_zero = False
    ue = None if from_zero else px.u_ext(u)
    res = _each(f, lambda i, j: op(None if from_zero else ue[i, j], px.f_ext[i, j],
                                   px.geo(i, j), h, last, omega, from_zero, mode, smoother))
    return (_grid(u, {ij: b for ij, (b, _) in res.items()}),
            _sum_err([raw for _, raw in res.values()], mode, f, h, smoother))


def sharded_fused_jacobi_err(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                             omega: float = 1.0, compat=True, from_zero: bool = False,
                             smoother: str = "jacobi"):
    """``steps`` sharded sweeps with the smoothing error fused into the last
    pass (rb-GS: cpu and clean only): (u, err), the shards' partials added
    in shard order."""
    return _smooth_err(u, f, h, steps, omega, compat, from_zero, smoother, K.fused_jacobi_shard)


def sharded_fused_jacobi_errs(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                              omega: float = 1.0, compat=True):
    """One pass of ``steps`` ≤ errs_sweep_cap sweeps with the error of every
    iterate (trigger batching): (u, errs), each the shards' partials added
    in shard order."""
    if not 1 <= steps <= K.errs_sweep_cap(compat):
        raise ValueError(f"a per-sweep error pass runs 1..{K.errs_sweep_cap(compat)} sweeps, "
                         f"got {steps}")
    mode = K.err_mode_of(compat)
    px = _Pass(f)
    ue = px.u_ext(u)
    res = _each(f, lambda i, j: K.fused_jacobi_errs_shard(
        ue[i, j], px.f_ext[i, j], px.geo(i, j), h, steps, omega, mode))
    return (_grid(u, {ij: b for ij, (b, _) in res.items()}),
            _sum_err([r for _, r in res.values()], mode, f, h))


def _coarse_layout(x: ShardedGrid) -> Layout:
    """The layout of a 2:1 leg's coarse points of x's blocks (even origins):
    each block's rows from r0 / 2 to ⌈r1 / 2⌉, the same for columns."""
    lay = x.layout
    m = (x.n + 1) // 2
    half = tuple((a // 2, (b + 1) // 2) for a, b in lay.rows)
    halfc = tuple((a // 2, (b + 1) // 2) for a, b in lay.cols)
    return lay.coarse(m, half, halfc)


def sharded_fused_descend(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                          omega: float = 1.0, restriction: str = "sampling", err_mode=None,
                          from_zero: bool = False):
    """The fused descend leg per shard: (u, coarse right-hand side, err or
    None). The coarse grid comes back laid out as the blocks' coarse points
    (``_coarse_layout``); ``sharded.as_level`` re-splits it for the coarse
    level where that level is laid out otherwise."""
    px = _Pass(f)
    ue = None if from_zero else px.u_ext(u)
    res = _each(f, lambda i, j: K.fused_descend_shard(
        None if from_zero else ue[i, j], px.f_ext[i, j], px.geo(i, j), h, steps, omega,
        restriction, err_mode, from_zero))
    lay = _coarse_layout(f)
    fc = ShardedGrid(lay, [[res[i, j][1] if (i, j) in res else None
                            for j in range(len(lay.cols))] for i in range(len(lay.rows))])
    err = None if err_mode is None else _sum_err([r for _, _, r in res.values()], err_mode,
                                                 f, h)
    return _grid(u, {ij: b for ij, (b, _, _) in res.items()}), fc, err


# coarse rows (and columns) around a block's coarse points that the ascend
# leg's window reads: fine halo cell r0 − HALO interpolates from coarse row
# r0/2 − HALO/2, the last one from ⌈r1/2⌉ + HALO/2
COARSE_HALO = HALO // 2 + 1


def sharded_fused_ascend(u: ShardedGrid, f: ShardedGrid, child, h: float, steps: int,
                         omega: float = 1.0, err_mode=None):
    """The fused ascend leg per shard: ``child`` is the coarse correction
    (m, m), a tensor or a ShardedGrid in any layout; each shard reads the
    window of it around its coarse points. Returns (u, err or None)."""
    px = _Pass(f)
    ch = COARSE_HALO
    lay = f.layout
    ue = px.u_ext(u)
    c_win = exchange(child, lay, lambda i, j: (
        lay.rows[i][0] // 2 - ch, (lay.rows[i][1] + 1) // 2 + ch,
        lay.cols[j][0] // 2 - ch, (lay.cols[j][1] + 1) // 2 + ch))

    def one(i, j):
        cr0, cc0 = lay.rows[i][0] // 2 - ch, lay.cols[j][0] // 2 - ch
        return K.fused_ascend_shard(ue[i, j], px.f_ext[i, j], c_win[i, j], cr0, cc0,
                                    px.geo(i, j), h, steps, omega, err_mode)

    res = _each(f, one)
    err = None if err_mode is None else _sum_err([r for _, r in res.values()], err_mode, f, h)
    return _grid(u, {ij: b for ij, (b, _) in res.items()}), err


def rdma_fused_jacobi(u: ShardedGrid, f: ShardedGrid, h: float, steps: int, omega: float = 1.0,
                      from_zero: bool = False) -> ShardedGrid:
    """``steps`` fused Jacobi sweeps of a row-sharded level, each pass of ≤ 8
    one launch of the ring kernel (``ops.rdma.rdma_jacobi``): the halos move
    inside the launch and interior tiles do not wait for them. Owned cells
    bit-match ``sharded_fused_jacobi``."""
    _rows_only(f, "rdma_fused_jacobi")
    first = True
    with on_device(f.device):
        while steps > 0:
            k = min(steps, K.MAX_FUSED_SWEEPS)
            u = rdma.rdma_jacobi(f if (from_zero and first) else u, f, h, k, omega,
                                 from_zero and first)
            steps -= k
            first = False
    return u


def rdma_fused_trigger(u: ShardedGrid, f: ShardedGrid, h: float, trigger: float,
                       omega: float = 1.0, compat=True, max_sweeps: int = 100_000):
    """The whole error-triggered loop of a row-sharded level in one launch of
    the ring kernel (``ops.rdma.rdma_trigger``): (u, err, sweeps), bit for
    bit the loop of one-sweep ``sharded_fused_jacobi_err`` passes."""
    _rows_only(f, "rdma_fused_trigger")
    with on_device(f.device):
        return rdma.rdma_trigger(u, f, h, omega, compat, trigger, max_sweeps)


def sharded_fused_jacobi_torch(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                               omega: float = 1.0, from_zero: bool = False) -> ShardedGrid:
    """``sharded_fused_jacobi`` on the shard-mode twins whatever the device:
    the ring smoother's twin (``ops.rdma.rdma_jacobi_torch``)."""
    return _smooth(u, f, h, steps, omega, from_zero, "jacobi", K.fused_jacobi_shard_torch)


def sharded_fused_jacobi_err_torch(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                                   omega: float = 1.0, compat=True):
    """``sharded_fused_jacobi_err`` on the shard-mode twins whatever the
    device: the sweep of the ring trigger's twin
    (``ops.rdma.rdma_trigger_torch``)."""
    return _smooth_err(u, f, h, steps, omega, compat, False, "jacobi",
                       K.fused_jacobi_shard_torch)
