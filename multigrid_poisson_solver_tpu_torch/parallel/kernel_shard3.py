"""The fused 3-D kernels on z-sharded volumes: one plane exchange per pass,
then the shard-mode kernel on every shard; and the sharded V-cycle.

PyTorch port of ``multigrid_poisson_solver_tpu/parallel/pallas_shard3.py``
with ``halo="ppermute"`` (its ``:173-506`` and ``v_cycle3_sharded``,
``:721-848``). Per fused pass each shard's planes are extended by the halo
planes of its ring neighbours (``sharded.extend_all``, the counterpart of
``_extend_planes``: one batched exchange, across processes too) and the
shard-mode kernel (``ops.kernels3``, ``*_shard``) runs on them with the
shard's global z origin, so the
z-Dirichlet gates stay exact and the owned planes are the unsharded
kernel's, bit for bit. Each shard's error comes back as its raw float64 sum
over its owned interior planes; the sums are added in shard order
(``sharded.psum``), scaled and rounded to the level's dtype once.

Pass chunking, halo depths and the routes between the fused legs and their
fallbacks follow JAX's planes per device ``nl``, not the port's split:
every wrapper takes it as ``nl`` (by default JAX's depth padded to a
multiple of the shard count, ``padded_depth3(n, P) // P``). The port's
windows are assembled from every block they overlap, so a halo deeper than
the port's neighbour block (JAX's nl can exceed the port's ``2⌊n/2P⌋`` by 2)
is still exact.

``halo="rdma"``: JAX's ring kernels 19-22 (``ops/pallas_rdma3.py``,
``pallas_shard3.py:505-720``), ``ops.rdma3``: the plane exchange inside one
launch over the ring. ``rdma_fused_jacobi3``, ``rdma_fused_jacobi3_err``,
``rdma_fused_descend3``, ``rdma_fused_ascend3`` and ``rdma_fused_trigger3``
chunk their passes as JAX does (at most min(8, nl) sweeps, a pass cut down
while ``rdma_jacobi3_fits`` refuses it; the clean error's last pass at most
min(7, nl − 1)) and return what the exchange path returns, the same values
bit for bit. Their callers route by JAX's admission predicates on JAX's nl
and padded (rp, cp). A ring launch runs every shard on one card, so a mesh
over several cards or several processes keeps the exchange path and
refuses "rdma", as the 2-D engine does (across processes: ROADMAP Queue 2
A1).

The shard-mode kernels are looked up in ``ops.kernels3`` at each call, so
replacing them there by their ``*_torch`` twins runs these wrappers on the
twins (CPU blocks always run them). Each shard's kernel launches with its
shard's card current.
"""

from __future__ import annotations

import torch

from ..models import poisson3d as p3
from ..ops import kernels as K
from ..ops import kernels3 as K3
from ..ops import rdma3 as R3
from ..ops import transfers3 as T3
from . import halo3
from .mesh import Z_AXIS, padded_depth3
from .sharded import (Layout, ShardedGrid, as_level, each_shard, exchange, extend_all, gather,
                      home, on_device)

MULTI_PROCESS_RDMA = "ROADMAP Queue 2 A1"


def check_rdma_one_process(mesh) -> None:
    """Refuse halo="rdma" on a mesh of several processes: a ring launch
    reads every shard's buffers, which another process does not map."""
    if not mesh.one_process:
        raise ValueError(f"halo='rdma' needs every shard of a ring in one process; this mesh "
                         f"spans processes {sorted(set(mesh.ranks))}: use halo='ppermute' "
                         f"(the ring across processes is {MULTI_PROCESS_RDMA})")


def check_halo3(halo: str, mesh=None) -> None:
    """Refuse an unknown halo, and halo="rdma" on a mesh of several
    processes or over several cards: a ring kernel runs every shard of a
    ring in one launch on one card (the 2-D engine's refusal,
    ``compiled.py``)."""
    if halo not in ("ppermute", "rdma"):
        raise ValueError(f"unknown halo {halo!r}; expected ppermute or rdma")
    if halo == "rdma" and mesh is not None:
        check_rdma_one_process(mesh)
    if halo == "rdma" and mesh is not None and len(set(mesh.devices)) > 1:
        raise ValueError(f"halo='rdma' runs every shard of a ring in one launch on one card; "
                         f"this mesh spans {sorted(set(map(str, mesh.devices)))}: use "
                         f"halo='ppermute'")


def _nl(x: ShardedGrid, nl) -> int:
    """JAX's planes per device: ``nl``, or the depth padded to ×P over P."""
    if nl is not None:
        return nl
    ndev = len(x.layout.rows)
    return padded_depth3(x.n, ndev) // ndev


def _geo(x: ShardedGrid, i: int, ext: int) -> K3.ShardGeo3:
    return halo3.geo3(x, i, ext)


def _grid(x: ShardedGrid, blocks) -> ShardedGrid:
    """x's layout with ``blocks``, this process's blocks in shard order (as
    ``each_shard`` returns them)."""
    it = iter(blocks)
    return x.map(lambda i, j, b: next(it))


def _passes(u: ShardedGrid, f: ShardedGrid, h: float, steps: int, omega: float,
            from_zero: bool, kmax: int, ext_of):
    """``steps`` sweeps as passes of at most ``kmax``, pass k with f and u
    extended by ext_of(k) planes (u not read on a from_zero first pass).
    Returns (u, whether the from_zero sweep is still to come)."""
    f_e, first = {}, True
    while steps > 0:
        k = min(steps, kmax)
        ext = ext_of(k)
        if ext not in f_e:
            f_e[ext] = extend_all(f, ext)
        fz = from_zero and first
        ue = None if fz else extend_all(u, ext)
        u = _grid(u, each_shard(f, lambda i: K3.fused_jacobi3_shard(
            None if fz else ue[i, 0], f_e[ext][i, 0], _geo(f, i, ext), h, k, omega, fz)[0]))
        steps -= k
        first = False
    return u, from_zero and first


def sharded_fused_jacobi3(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                          omega: float = 6.0 / 7.0, from_zero: bool = False,
                          nl=None) -> ShardedGrid:
    """``steps`` fused sweeps of a z-sharded level (``sharded_fused_jacobi3``):
    passes of at most min(8, nl) sweeps, each after one exchange of min(steps,
    that) planes. ``from_zero``: u ≡ 0, not read."""
    kmax = min(K3.MAX_FUSED_SWEEPS_3D, _nl(f, nl))
    ext = min(steps, kmax)
    return _passes(u, f, h, steps, omega, from_zero, kmax, lambda k: ext)[0]


def sharded_fused_jacobi3_err(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                              omega: float = 6.0 / 7.0, compat: str = "clean",
                              from_zero: bool = False, nl=None, err_plan: bool = False):
    """``steps`` sharded sweeps with the error of the result fused into the
    final pass (``sharded_fused_jacobi3_err``): (u, err). The clean metric's
    extra stencil read takes one halo plane, so its final pass runs at most
    min(7, nl − 1) sweeps. ``err_plan``: the final pass uses the trigger
    loops' tile plan (a one-sweep step of a trigger loop)."""
    mode = "gpu" if compat == "gpu" else "clean"
    if steps < 1:
        raise ValueError(f"an error pass needs at least one sweep, got {steps}")
    nl = _nl(f, nl)
    kmax = min(K3.MAX_FUSED_SWEEPS_3D, nl)
    if mode == "clean" and nl < 2:
        raise ValueError("the clean metric needs at least 2 planes per device")
    last = min(steps, kmax if mode == "gpu" else min(7, nl - 1))
    u, fz = _passes(u, f, h, steps - last, omega, from_zero, kmax, lambda k: k)
    z_halo = last if mode == "gpu" else last - fz + 1
    ext = min(max(z_halo, 1), nl)
    ue, fe = None if fz else extend_all(u, ext), extend_all(f, ext)

    def one(i):
        geo = _geo(f, i, ext)
        plan = K3.err_plan3(geo.nz) if err_plan else None
        return K3.fused_jacobi3_shard(None if fz else ue[i, 0], fe[i, 0], geo, h, last, omega,
                                      fz, mode, plan)

    res = each_shard(f, one)
    return (_grid(u, [b for b, _ in res]),
            halo3.sum_err3([raw for _, raw in res], mode, f.n, h, f.dtype, f))


def sharded_trigger_step3(u: ShardedGrid, f: ShardedGrid, h: float, omega: float = 6.0 / 7.0,
                          compat: str = "clean", nl=None):
    """One sweep and the error of the result, a step of a sharded trigger
    loop (JAX's ``one_sharded``): (u, err), every shard on the trigger
    loops' tile plan, so the error is the float the sharded per-sweep passes
    report for the same iterate."""
    return sharded_fused_jacobi3_err(u, f, h, 1, omega, compat, nl=nl, err_plan=True)


def sharded_trigger_pass3(u: ShardedGrid, f: ShardedGrid, h: float, omega: float = 6.0 / 7.0,
                          compat: str = "clean"):
    """One sweep of a z-sharded level with the error a trigger loop that
    takes the clean error one sweep behind reads (``solver.
    trigger_loop_lagged``): (u_next, err), err the clean error of u itself
    or the gpu error of u_next, from one pass per shard after a one-plane
    exchange; the same float ``sharded_trigger_step3`` reports for that
    iterate."""
    mode = "gpu" if compat == "gpu" else "clean"
    ue, fe = extend_all(u, 1), extend_all(f, 1)
    res = each_shard(f, lambda i: K3.trigger_pass3_shard(
        ue[i, 0], fe[i, 0], _geo(f, i, 1), h, omega, mode))
    return (_grid(u, [b for b, _ in res]),
            halo3.sum_err3([raw for _, raw in res], mode, f.n, h, f.dtype, f))


def sharded_fused_jacobi3_errs(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                               omega: float = 6.0 / 7.0, compat: str = "clean", nl=None):
    """One pass of ``steps`` ≤ ``errs3_sweep_cap(compat)`` sweeps with the
    error of every iterate (``sharded_fused_jacobi3_errs``, trigger batching):
    (u, errs). The halo is steps (+1 for the clean metric) planes, which must
    fit JAX's nl."""
    mode = "gpu" if compat == "gpu" else "clean"
    if not 1 <= steps <= K3.errs3_sweep_cap(mode):
        raise ValueError(f"a per-sweep error pass runs 1..{K3.errs3_sweep_cap(mode)} sweeps, "
                         f"got {steps}")
    ext = steps if mode == "gpu" else steps + 1
    if ext > _nl(f, nl):
        raise ValueError(f"a batched sharded trigger pass needs {ext} halo planes <= "
                         f"{_nl(f, nl)} planes per device")
    ue, fe = extend_all(u, ext), extend_all(f, ext)
    res = each_shard(f, lambda i: K3.fused_jacobi3_errs_shard(
        ue[i, 0], fe[i, 0], _geo(f, i, ext), h, steps, omega, mode))
    return (_grid(u, [b for b, _ in res]),
            halo3.sum_err3([raws for _, raws in res], mode, f.n, h, f.dtype, f))


def sharded_residual3(u: ShardedGrid, f: ShardedGrid, h: float,
                      negate: bool = False) -> ShardedGrid:
    """The 7-point residual of a z-sharded level (``sharded_residual3_pallas``;
    one halo plane)."""
    ue, fe = extend_all(u, 1), extend_all(f, 1)
    return _grid(u, each_shard(f, lambda i: K3.residual3_shard(
        ue[i, 0], fe[i, 0], _geo(f, i, 1), h, negate)))


def sharded_smooth_residual3(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                             omega: float = 6.0 / 7.0, from_zero: bool = False,
                             negate: bool = False, nl=None):
    """``steps`` sweeps and the residual of the result from one pass per shard
    (kernel 10's emit_residual mode; ``sharded_smooth_residual3``): (u, r).
    Where the fused form's ≤ 7-sweep ring or JAX's shard depth cannot hold
    the halo, the pair ``sharded_fused_jacobi3`` + ``sharded_residual3``."""
    nl = _nl(f, nl)
    k_eff = steps - int(from_zero)
    if not (1 <= steps and k_eff <= 7 and k_eff + 1 <= nl):
        out = sharded_fused_jacobi3(u, f, h, steps, omega, from_zero, nl)
        return out, sharded_residual3(out, f, h, negate)
    ext = k_eff + 1
    ue, fe = None if from_zero else extend_all(u, ext), extend_all(f, ext)
    res = each_shard(f, lambda i: K3.fused_jacobi3_residual_shard(
        None if from_zero else ue[i, 0], fe[i, 0], _geo(f, i, ext), h, steps, omega, from_zero,
        negate))
    return _grid(u, [a for a, _ in res]), _grid(u, [b for _, b in res])


def _coarse_layout3(x: ShardedGrid) -> Layout:
    """The layout of a descend leg's coarse planes: each shard's
    ``coarse_planes3``."""
    lay, m = x.layout, (x.n + 1) // 2
    half = tuple((a // 2, (b + 1) // 2) for a, b in lay.rows)
    return lay.coarse(m, half, ((0, m),))


def sharded_fused_descend3(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                           omega: float = 6.0 / 7.0, from_zero: bool = False,
                           restriction: str = "full_weighting", want_err: bool = False,
                           nl=None):
    """The whole descend leg per shard (``sharded_fused_descend3``): sweeps,
    −r and its restriction in one leg call per shard, the halo k + 2 planes (full
    weighting) or k + 1, k the neighbour-reading sweeps. Needs an even JAX nl
    holding the halo. Returns (u, the coarse right-hand side laid out as the
    shards' coarse planes, the clean error or None)."""
    nl = _nl(f, nl)
    fw = restriction == "full_weighting"
    k_nb = steps - int(from_zero)
    z_halo = k_nb + (2 if fw else 1)
    cap = K3.MAX_DESCEND3_SWEEPS_FW if fw else K3.MAX_DESCEND3_SWEEPS_SAMPLING
    if nl % 2 or not (1 <= steps and 0 <= k_nb <= cap and z_halo <= nl):
        raise ValueError(f"the sharded descend leg needs an even plane count per device "
                         f"holding its {z_halo}-plane halo, got nl={nl}, steps={steps}")
    ue, fe = None if from_zero else extend_all(u, z_halo), extend_all(f, z_halo)
    res = each_shard(f, lambda i: K3.fused_descend3_shard(
        None if from_zero else ue[i, 0], fe[i, 0], _geo(f, i, z_halo), h, steps, omega,
        from_zero, restriction, want_err))
    lay = _coarse_layout3(f)
    fc = _grid(ShardedGrid(lay, [[None] for _ in lay.rows]), [c for _, c, _ in res])
    err = (halo3.sum_err3([raw for _, _, raw in res], "clean", f.n, h, f.dtype, f) if want_err
           else None)
    return _grid(u, [b for b, _, _ in res]), fc, err


def ascend3_halo(steps: int, want_err: bool) -> tuple[int, int]:
    """(ext_z, ext_c) of the sharded ascend leg: an even fine halo of at
    least the pipeline's depth, and half of it in coarse planes."""
    z_halo = steps + int(want_err)
    ext_z = z_halo + z_halo % 2
    return ext_z, ext_z // 2


def sharded_fused_ascend3(u: ShardedGrid, f: ShardedGrid, child, h: float, steps: int,
                          omega: float = 6.0 / 7.0, want_err: bool = False, nl=None):
    """The whole ascend leg per shard (``sharded_fused_ascend3``): prolongation
    of the coarse correction ``child`` ((m, m, m), a tensor or a ShardedGrid
    in any layout), its add and ``steps`` sweeps in one leg call per shard, the
    fine halo ext_z (even) and the coarse window ext_c planes above the
    shard's coarse planes and ext_c + 1 below. Returns (u, clean error or
    None)."""
    nl = _nl(f, nl)
    ext_z, ext_c = ascend3_halo(steps, want_err)
    if (nl % 2 or not 1 <= steps <= K3.MAX_FUSED_SWEEPS_3D - int(want_err)
            or ext_z > nl or ext_c + 1 > nl // 2):
        raise ValueError(f"the sharded ascend leg needs an even plane count per device "
                         f"holding its {ext_z}-plane halo, got nl={nl}, steps={steps}")

    lay, m = f.layout, child.shape[0]
    ue, fe = extend_all(u, ext_z), extend_all(f, ext_z)
    c_win = exchange(child, lay, lambda i, j: (lay.rows[i][0] // 2 - ext_c,
                                               (lay.rows[i][1] + 1) // 2 + ext_c + 1, 0, m))

    def one(i):
        cz0 = lay.rows[i][0] // 2 - ext_c
        return K3.fused_ascend3_shard(ue[i, 0], fe[i, 0], c_win[i, 0], cz0, _geo(f, i, ext_z), h,
                                      steps, omega, want_err)

    res = each_shard(f, one)
    err = (halo3.sum_err3([raw for _, raw in res], "clean", f.n, h, f.dtype, f) if want_err
           else None)
    return _grid(u, [b for b, _ in res]), err


# --- halo="rdma": the ring kernels 19-22 (ops.rdma3) ---------------------------------

def _rdma_k(remaining: int, kmax: int, nl: int, rc, err: bool = False) -> int:
    """A pass of at most ``kmax`` sweeps, cut down while JAX's
    ``rdma_jacobi3_fits`` refuses it."""
    k = min(remaining, kmax)
    while k > 1 and not R3.rdma_jacobi3_fits(nl, *rc, k, err=err):
        k -= 1
    return k


def rdma_fused_jacobi3(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                       omega: float = 6.0 / 7.0, from_zero: bool = False, nl=None):
    """``steps`` sweeps of a z-sharded level through the ring smoother
    (``rdma_fused_jacobi3``): passes of at most min(8, nl) sweeps, each cut
    down while JAX's predicate refuses it; ``from_zero`` on the first."""
    nl, rc, first = _nl(f, nl), R3.padded_rc(f.n), True
    kmax = min(K3.MAX_FUSED_SWEEPS_3D, nl)
    while steps > 0:
        k = _rdma_k(steps, kmax, nl, rc)
        u = R3.rdma_jacobi3(u, f, h, k, omega, from_zero and first)[0]
        steps -= k
        first = False
    return u


def rdma_fused_jacobi3_err(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                           omega: float = 6.0 / 7.0, compat: str = "clean", nl=None):
    """``rdma_fused_jacobi3`` with the error of the result fused into the
    final pass (``rdma_fused_jacobi3_err``): (u, err). The final pass runs at
    most min(8, nl) sweeps (gpu) or min(7, nl − 1) (clean), cut while the
    predicate refuses it with the error's halo; the passes before it at most
    min(8, nl)."""
    mode = "gpu" if compat == "gpu" else "clean"
    if steps < 1:
        raise ValueError(f"an error pass needs at least one sweep, got {steps}")
    nl, rc = _nl(f, nl), R3.padded_rc(f.n)
    kmax = min(K3.MAX_FUSED_SWEEPS_3D, nl)
    last = _rdma_k(steps, kmax if mode == "gpu" else min(7, nl - 1), nl, rc, mode == "clean")
    remaining = steps - last
    while remaining > 0:
        k = _rdma_k(remaining, kmax, nl, rc)
        u = R3.rdma_jacobi3(u, f, h, k, omega)[0]
        remaining -= k
    u, raws = R3.rdma_jacobi3(u, f, h, last, omega, err_mode=mode)
    return u, halo3.sum_err3(raws, mode, f.n, h, f.dtype, f)


def rdma_fused_descend3(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                        omega: float = 6.0 / 7.0, from_zero: bool = False,
                        restriction: str = "full_weighting", want_err: bool = False, nl=None):
    """The whole descend leg through the ring kernel (``rdma_fused_descend3``):
    what ``sharded_fused_descend3`` returns, from one launch. Needs an even
    JAX nl, as the exchange leg."""
    nl = _nl(f, nl)
    if nl % 2:
        raise ValueError(f"the sharded descend leg needs an even plane count per device, "
                         f"got nl={nl}")
    u, fc, raws = R3.rdma_descend3(u, f, h, steps, omega, from_zero, restriction, want_err)
    return u, fc, (halo3.sum_err3(raws, "clean", f.n, h, f.dtype, f) if want_err else None)


def rdma_fused_ascend3(u: ShardedGrid, f: ShardedGrid, child, h: float, steps: int,
                       omega: float = 6.0 / 7.0, want_err: bool = False, nl=None):
    """The whole ascend leg through the ring kernel (``rdma_fused_ascend3``):
    what ``sharded_fused_ascend3`` returns, from one launch; ``child`` is the
    coarse correction ((m, m, m), a tensor or a ShardedGrid)."""
    nl = _nl(f, nl)
    if nl % 2:
        raise ValueError(f"the sharded ascend leg needs an even plane count per device, "
                         f"got nl={nl}")
    u, raws = R3.rdma_ascend3(u, f, child, h, steps, omega, want_err)
    return u, (halo3.sum_err3(raws, "clean", f.n, h, f.dtype, f) if want_err else None)


def rdma_fused_trigger3(u: ShardedGrid, f: ShardedGrid, h: float, omega: float = 6.0 / 7.0,
                        compat: str = "clean", trigger: float = 0.01,
                        max_sweeps: int = 100_000):
    """The whole trigger loop of a z-sharded level in one ring launch
    (``rdma_fused_trigger3``): (u, err, sweeps), those of the loop of
    ``sharded_trigger_step3`` launches, bit for bit."""
    mode = "gpu" if compat == "gpu" else "clean"
    return R3.rdma_trigger3(u, f, h, omega, mode, trigger, max_sweeps)


class CyclePolicy3:
    """The sharding rule of ``v_cycle3_sharded``: a level of at least 65³
    shards where JAX's depth padded to ×P gives every device at least
    ``threshold_planes`` planes (``pallas_shard3.py:761-763``; the compiled
    engine's ``ZShardingPolicy3`` pads to ×2P instead)."""

    def __init__(self, mesh, threshold_planes: int = 8, axis_name: str = Z_AXIS):
        self.mesh = mesh
        self.axis_name = axis_name
        self.threshold_planes = threshold_planes

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def is_sharded(self, n: int) -> bool:
        ndev = self.n_devices
        return (ndev > 1 and n >= 65
                and padded_depth3(n, ndev) // ndev >= self.threshold_planes)

    def spec(self, n: int) -> tuple:
        return (self.axis_name, None, None) if self.is_sharded(n) else ()


def v_cycle3_sharded(u, f, h: float, mesh, n_min: int = 5, pre: int = 3, post: int = 3,
                     coarse_sweeps: int = 50, omega: float = 6.0 / 7.0,
                     threshold_planes: int = 8, halo: str = "ppermute", kernels: str = "auto"):
    """One recursive 3-D V-cycle on a z-plane mesh (``v_cycle3_sharded``):
    per-shard kernels on every level deep enough to shard, the port's
    ``v_cycle3`` replicated below (coarse-level agglomeration).

    ``u`` and ``f`` are the finest level, (n, n, n) tensors or ShardedGrids;
    the result is the finest level in the cycle's layout (a ShardedGrid where
    it shards; ``sharded.gather`` gives the volume). Routing is JAX's, on
    JAX's depths: the top depth padded to ×2P, a child half its parent's after
    a fused descend leg, else padded to ×P (or n where it does not shard).
    On a level that shards, the descend leg runs per shard where JAX's nl is
    even and holds the halo, else the emit_residual pass and the 2:1
    restriction on the gathered −r; the ascend leg runs per shard where the
    child's depth is half the level's, else the prolongation and add on the
    gathered level and ``sharded_fused_jacobi3``. ``kernels="torch"``: the
    plain per-shard ops (``parallel.halo3``) and the plain cycle below, as
    ``v_cycle3(kernels="torch")`` runs them. ``halo="rdma"`` on the kernel
    path takes the ring kernels where JAX's predicates admit them on its nl
    and padded (rp, cp) (``pallas_shard3.py:795-839``): the descend leg, the
    ascend leg and the post-smoothing after the prolongation and add; the
    emit_residual fallback keeps the exchange."""
    pol = CyclePolicy3(mesh, threshold_planes)
    ndev = pol.n_devices
    dev = home(pol)
    n = u.shape[0]
    sizes = p3._sizes(n, n_min)
    use_k = K.use_kernels(kernels, dev)
    check_halo3(halo, mesh if use_k else None)
    ring = use_k and halo == "rdma"

    def lay(x, nn):
        return as_level(x, pol, nn)

    def run(up, fp, nn, hh, depth, from_zero, zp):
        if not pol.is_sharded(nn):
            return p3.v_cycle3(gather(up, dev), gather(fp, dev), hh, n_min=n_min, pre=pre,
                               post=post, coarse_sweeps=coarse_sweeps, omega=omega,
                               kernels=kernels)
        up, fp = lay(up, nn), lay(fp, nn)
        nl = zp // ndev
        if depth == len(sizes) - 1:   # a sharded coarsest level (a large n_min only)
            if use_k:
                return sharded_fused_jacobi3(up, fp, hh, coarse_sweeps, omega, from_zero, nl)
            return halo3.sharded_smooth3(up, fp, hh, coarse_sweeps, omega)
        m = sizes[depth + 1]
        k_nb = pre - int(from_zero)
        if not use_k:
            up = halo3.sharded_smooth3(up, fp, hh, pre, omega)
            fc = T3.restrict3(gather(halo3.sharded_residual3(up, fp, hh, negate=True)), m)
            zp_c = m
        elif nl % 2 == 0 and 1 <= k_nb <= K3.MAX_DESCEND3_SWEEPS_FW and k_nb + 2 <= nl:
            down = sharded_fused_descend3
            if ring and R3.rdma_descend3_fits(nl, *R3.padded_rc(nn), pre, from_zero):
                down = rdma_fused_descend3
            up, fc, _ = down(up, fp, hh, pre, omega, from_zero, "full_weighting", nl=nl)
            zp_c = zp // 2
        else:
            up, rneg = sharded_smooth_residual3(up, fp, hh, pre, omega, from_zero, True, nl)
            fc = T3.restrict3(gather(rneg), m)
            zp_c = padded_depth3(m, ndev) if pol.is_sharded(m) else m
        fc = lay(fc, m)
        ec = run(fc.map(lambda i, j, b: torch.zeros_like(b)) if isinstance(fc, ShardedGrid)
                 else torch.zeros_like(fc), fc, m, 2 * hh, depth + 1, True, zp_c)
        ext_z, ext_c = ascend3_halo(post, False)
        if (use_k and nl % 2 == 0 and 1 <= post <= K3.MAX_FUSED_SWEEPS_3D and 2 * zp_c == zp
                and ext_z <= nl and ext_c + 1 <= nl // 2):
            up_fn = sharded_fused_ascend3
            if ring and R3.rdma_ascend3_fits(nl, *R3.padded_rc(nn), post, False):
                up_fn = rdma_fused_ascend3
            return up_fn(up, fp, ec, hh, post, omega, nl=nl)[0]
        if use_k:
            up = lay(T3.prolong3_add(gather(up), gather(ec, dev)), nn)
            smooth = sharded_fused_jacobi3
            if ring and R3.rdma_jacobi3_fits(nl, *R3.padded_rc(nn),
                                             min(post, K3.MAX_FUSED_SWEEPS_3D, nl)):
                smooth = rdma_fused_jacobi3
            return smooth(up, fp, hh, post, omega, nl=nl)
        # the plain v_cycle3's add (its z faces kept at 0)
        g = gather(up) + p3.prolong3(gather(ec, dev), nn)
        g[0] = 0
        g[-1] = 0
        return halo3.sharded_smooth3(lay(g, nn), fp, hh, post, omega)

    with on_device(dev):
        return run(u, f, n, h, 0, False, padded_depth3(n, 2 * ndev))
