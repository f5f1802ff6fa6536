"""The 3-D hot-path kernels: hand-written CUDA for Hopper, each with a plain twin.

PyTorch port of the single-device kernels of
``multigrid_poisson_solver_tpu/ops/pallas3d.py`` that a fixed-step 3-D cycle
reaches:

  * ``fused_jacobi3``, ``fused_jacobi3_err``: ``csrc/jacobi3.cu``, replaces
    ``_fused_jacobi3_kernel`` (plain sweeps, from_zero, the clean and gpu
    errors);
  * ``fused_descend3``: ``csrc/descend3.cu``, replaces
    ``_fused_descend3_kernel`` and the lane pass ``restrict3_lanes_p``;
  * ``fused_ascend3``: ``csrc/ascend3.cu``, replaces ``_fused_ascend3_kernel``
    and the lane pass ``prolong3_lanes_p``;
  * ``residual3``: ``csrc/residual3.cu``, replaces ``_residual3_kernel``;
  * ``fused_jacobi3_errs``: ``csrc/jacobi3.cu``, ``_fused_jacobi3_kernel``'s
    per_sweep mode (``fused_jacobi3_errs_padded``: the error of every
    iterate of a pass); ``trigger_step3``: the same kernel's one-sweep error
    launch of a trigger loop;
  * ``trigger_smooth3``: ``csrc/trigger3.cu``, replaces
    ``_trigger3_vmem_kernel`` (the whole trigger loop, one launch);
  * ``trigger_smooth3_stream``: ``csrc/trigger3_stream.cu``, replaces
    ``_trigger3_stream_kernel`` (the same loop in passes of B sweeps);
  * ``residual_df3``, ``residual_tw3``: ``csrc/residual_mw3.cu``, replaces
    ``_residual_mw3_kernel`` (the compensated residual of a 2- or 3-word
    state);
  * ``fused_jacobi3_residual``: ``csrc/jacobi3.cu``, the same kernel's
    emit_residual mode (``fused_jacobi3_residual_padded``: sweeps and the
    residual of the last iterate from one pass);
  * the shard modes (``*_shard``, ``ShardGeo3``): kernels 10 (every mode and
    emit_residual), 11, 12 and 13 on one z-shard's planes of a sharded
    level, replacing ``_fused_jacobi3_shard_call``,
    ``_fused_descend3_shard_call``, ``_fused_ascend3_shard_call`` and
    ``_residual3_shard_call``; ``parallel.kernel_shard3`` runs them per
    shard.

All but the last share the tile pipeline of ``csrc/legs3.cuh``. The TPU
kernels' brick geometry (``_brick_geometry``: ×8-row and ×128-lane padding,
VMEM budgets) has no counterpart: the port's levels are plain contiguous
(n, n, n) tensors, and ``plan3`` picks a column tile and a z chunk that fit
a block's shared memory. Every launch of a trigger loop uses one plan,
``err_plan3`` (the deepest per-sweep pass's): the kernels sum a block's
error cells in an order fixed by the plan alone, so the error of an iterate
is the same float whether a one-sweep step, a per-sweep pass or a
whole-loop trigger kernel measured it, and the trigger routes stop at the
same sweep by construction. (The errors are float64 sums rounded once, so
launches with other plans report the same float but for a double sum that
falls within 1e-16 of an fp32 rounding boundary.)

Routing is by the tensors' device and nothing else: CPU tensors run the plain
twin (``*_torch``, built from ``models.poisson3d``), CUDA tensors launch the
kernel, and a build or launch failure or an input the kernel does not take
raises. The twins fix the operation order the kernels follow: the oracle
ops' (so a cycle on the kernels reproduces the plain cycle's iterates), with
the clean error Σ|r|/n³ (the TPU kernels take Σ|r| from the step of one
more sweep, 6/(ωh²)·Σ|Δ|; the port keeps the plain path's residual), every
error summed in float64 and rounded to the level's dtype once, so the
kernels, the twins and the plain path measure the same float. The twins of the
two trigger kernels are one loop of one-sweep twins with a host stop test
per sweep; the twin of the multi-word residual is ``_residual_mw3_kernel``'s
arithmetic plus the exact product of hi·h⁻² (``ops.kernels._two_prod``).
Launches count in ``ops.kernels.launches``. Every function returns new
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import poisson3d as p3
from . import kernels as K
from . import transfers3 as T3

MAX_FUSED_SWEEPS_3D = 8
# the descend halo absorbs k sweeps, the Δ stage and (full weighting) one ring
MAX_DESCEND3_SWEEPS_FW = 6
MAX_DESCEND3_SWEEPS_SAMPLING = 7

SMEM_MAX3 = 232448 - 1024   # SMEM_MAX3 in legs3.cuh
PLANE_MAX3 = 6 * 512        # PREF3 * THREADS3 in legs3.cuh: staged cells of a plane
TILES3 = ((32, 64), (32, 32), (16, 32), (16, 16), (8, 16), (8, 8))  # (y, x), largest first
CHUNK3 = 64                 # about this many owned z planes per block
# (ty, tx, cz) for every 3-D launch instead of plan3's choice (tests force
# several tiles per dimension); all three even
FORCE_TILE3 = None

_ERR_CODES3 = {None: 0, "clean": 2, "gpu": 3}   # ErrMode in common.cuh
TRIGGER3_VMEM_BUDGET = 96 * 1024 * 1024
TRIGGER3_STREAM_BUDGET = 116 * 1024 * 1024
ZB3 = 8


def errs3_sweep_cap(compat) -> int:
    """Sweeps per per-sweep-error pass (``pallas3d.errs3_sweep_cap``): the
    clean metric's extra Δ stage takes one halo ring."""
    return MAX_FUSED_SWEEPS_3D if compat == "gpu" else MAX_FUSED_SWEEPS_3D - 1


def _check_compat3(compat) -> None:
    if compat not in ("clean", "gpu"):
        raise ValueError(f"unknown error metric {compat!r}; expected 'clean' or 'gpu'")


def _padded3(n: int):
    """The TPU's padded (nz, rp, cp) shape of an n³ level (rows ×16, lanes ×128)."""
    return n, -(-n // 16) * 16, -(-n // 128) * 128


def trigger3_fits(n: int, itemsize: int = 4, budget: int = TRIGGER3_VMEM_BUDGET) -> bool:
    """Whether JAX runs a trigger node as its whole-loop VMEM kernel
    (``pallas3d.trigger3_fits``), kept so a schedule's routing can be held
    against JAX's."""
    nz, rp, cp = _padded3(n)
    return 3 * nz * rp * cp * itemsize + 8 * 1024 * 1024 <= budget


def trigger3_stream_fits(n: int, itemsize: int = 4) -> bool:
    """Whether JAX runs a trigger node as its streamed whole-loop kernel
    (``pallas3d.trigger3_stream_fits``)."""
    nz, rp, cp = _padded3(n)
    plane = rp * cp * itemsize
    if nz < 2 * ZB3:
        return False
    return nz * plane + 3 * ZB3 * plane + 10 * plane <= TRIGGER3_STREAM_BUDGET


def smem3(stages: int, halo: int, ty: int, tx: int) -> int:
    """Shared memory of a tile (leg3_smem): a ring of three planes for the
    starting iterate and for each stage, and f's ring of S + 1 planes."""
    return 4 * 4 * (stages + 1) * (ty + 2 * halo) * (tx + 2 * halo)


def plan3(n: int, stages: int, halo: int):
    """(ty, tx, cz): the largest column tile whose pipeline of ``stages``
    stages and ``halo`` fits a block's shared memory and the registers that
    carry a plane's loads, and an even z chunk of about CHUNK3 planes."""
    if FORCE_TILE3 is not None:
        return tuple(FORCE_TILE3)
    for ty, tx in TILES3:
        if (smem3(stages, halo, ty, tx) <= SMEM_MAX3
                and (ty + 2 * halo) * (tx + 2 * halo) <= PLANE_MAX3):
            break
    else:
        raise ValueError(f"no 3-D tile fits {stages} stages with halo {halo}")
    chunks = -(-n // CHUNK3)
    cz = -(-n // chunks)
    return ty, tx, max(2, cz + cz % 2)


def err_plan3(n: int):
    """The tile plan of every launch of a trigger loop: the deepest per-sweep
    pass's (8 stages, halo 8), which every shallower pipeline fits."""
    return plan3(n, MAX_FUSED_SWEEPS_3D, MAX_FUSED_SWEEPS_3D)


def blocks3(n: int, ty: int, tx: int, cz: int, nz=None) -> int:
    """Blocks of a launch over the n³ grid, or over nz of its planes."""
    return -(-n // tx) * -(-n // ty) * -(-(n if nz is None else nz) // cz)


@dataclasses.dataclass(frozen=True)
class ShardGeo3:
    """One z-shard's planes of an n³ level: [z0, z0 + nz) owned, its input
    windows holding ``ext`` planes of the neighbours per side (zero beyond the
    grid), global plane z at window plane z − z0 + ext. The whole grid is
    ``ShardGeo3(n, 0, n)``."""

    n: int
    z0: int
    nz: int
    ext: int = 0

    @property
    def ext_shape(self) -> tuple[int, int, int]:
        return self.nz + 2 * self.ext, self.n, self.n

    @property
    def whole(self) -> bool:
        return self.z0 == 0 and self.nz == self.n and self.ext == 0

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """The owned planes of a window-shaped tensor."""
        return x[self.ext:self.ext + self.nz]

    def gz(self, device) -> torch.Tensor:
        """Global z of the window's planes."""
        return torch.arange(self.z0 - self.ext, self.z0 + self.nz + self.ext, device=device)

    def inner(self, device) -> torch.Tensor:
        """The window's planes on the grid's interior (1..n − 2)."""
        gz = self.gz(device)
        return (gz >= 1) & (gz <= self.n - 2)

    def owned_inner(self, device) -> torch.Tensor:
        """The window's owned interior planes."""
        take = self.inner(device)
        take[:self.ext] = False
        take[self.ext + self.nz:] = False
        return take


# --- plain PyTorch twins ------------------------------------------------------

def _sweeps3(u, f, h: float, k: int, omega: float):
    for _ in range(k):
        u = p3.jacobi_sweep3(u, f, h, omega)
    return u


def fused_jacobi3_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                        from_zero: bool = False):
    """``steps`` sweeps; ``from_zero``: u is known to be 0 (not read; the
    first sweep from zero is the kernel's closed form bit for bit)."""
    return _sweeps3(torch.zeros_like(f) if from_zero else u, f, h, steps, omega)


def fused_jacobi3_err_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                            err_mode: str = "clean", from_zero: bool = False):
    """``steps`` sweeps and the error of the result: (u, err). "clean":
    Σ|r|/n³; "gpu": Σ|u_k − u_{k−1}|·6/h²/n³ (``models.poisson3d``)."""
    if err_mode == "gpu":
        prev = fused_jacobi3_torch(u, f, h, steps - 1, omega, from_zero)
        fin = p3.jacobi_sweep3(prev, f, h, omega)
        return fin, p3.gpu_smoothing_error3(fin, prev, h)
    fin = fused_jacobi3_torch(u, f, h, steps, omega, from_zero)
    return fin, p3.smoothing_error3(fin, f, h)


def fused_descend3_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                         from_zero: bool = False, restriction: str = "full_weighting",
                         want_err: bool = False):
    """Sweeps, then the 2:1 restriction of −r: (u, f_coarse, clean err or None)."""
    m = (f.shape[0] + 1) // 2
    u = fused_jacobi3_torch(u, f, h, steps, omega, from_zero)
    err = p3.smoothing_error3(u, f, h) if want_err else None
    return u, T3.restrict3(-p3.residual3(u, f, h), m, restriction), err


def fused_ascend3_torch(u, f, uc, h: float, steps: int, omega: float = 6.0 / 7.0,
                        want_err: bool = False):
    """Prolong uc, add it on the interior, post-sweeps: (u, clean err or None)."""
    u = _sweeps3(T3.prolong3_add(u, uc, interior_only=True), f, h, steps, omega)
    return u, (p3.smoothing_error3(u, f, h) if want_err else None)


def residual3_torch(u, f, h: float, negate: bool = False):
    r = p3.residual3(u, f, h)
    return -r if negate else r


def fused_jacobi3_errs_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                             compat: str = "clean"):
    """``steps`` sweeps and the error of every iterate: (u, errs), errs[s − 1]
    the error ``fused_jacobi3_err_torch`` reports after s sweeps."""
    errs = []
    for _ in range(steps):
        prev, u = u, p3.jacobi_sweep3(u, f, h, omega)
        errs.append(p3.gpu_smoothing_error3(u, prev, h) if compat == "gpu"
                    else p3.smoothing_error3(u, f, h))
    return u, torch.stack(errs)


def trigger_step3_torch(u, f, h: float, omega: float = 6.0 / 7.0, compat: str = "clean"):
    return fused_jacobi3_err_torch(u, f, h, 1, omega, compat)


def trigger_smooth3_torch(u, f, h: float, omega: float = 6.0 / 7.0, compat: str = "clean",
                          trigger: float = 0.01, max_sweeps: int = 100_000):
    """Error-triggered smoothing, one sweep-plus-error step at a time with a
    host stop test per sweep: (u, err, sweeps). The twin of both whole-loop
    kernels."""
    from ..solver import trigger_loop

    u, err, sweeps = trigger_loop(lambda v: trigger_step3_torch(v, f, h, omega, compat), u,
                                  trigger, max_sweeps)
    return u, err, torch.tensor(sweeps, dtype=torch.int32, device=f.device)


def _dd_chain3(u):
    """(hi, lo, m) on the interior: hi + lo + m ≈ Σ6 neighbors − 6u, the error
    word itself compensated (refine3._eft_stencil_sum_dd3: the z pair first,
    then y−, y+, x−, x+, then six −u terms)."""
    uc = u[1:-1, 1:-1, 1:-1]
    hi, lo = K._two_sum(u[:-2, 1:-1, 1:-1], u[2:, 1:-1, 1:-1])
    lo2 = torch.zeros_like(hi)
    for term in (u[1:-1, :-2, 1:-1], u[1:-1, 2:, 1:-1], u[1:-1, 1:-1, :-2], u[1:-1, 1:-1, 2:],
                 -uc, -uc, -uc, -uc, -uc, -uc):
        hi, e = K._two_sum(hi, term)
        lo, e2 = K._two_sum(lo, e)
        lo2 = lo2 + e2
    hi, e = K._two_sum(hi, lo)
    lo, e2 = K._two_sum(e, lo2)
    return hi, lo, e2


def residual_mw3_torch(words, f, h: float):
    """Compensated 7-point residual of a 2- or 3-word fp32 state, 0 off the
    interior, in the arithmetic of ``_residual_mw3_kernel`` (the combination
    of ``refine3.residual_tw3``; with two words both get the dd chain). One
    term more: the rounding error of hi0·h⁻², exact by Dekker's product; it
    is 0 where h⁻² is a power of two (2^k + 1 grids)."""
    c = torch.tensor(1.0 / (h * h), dtype=f.dtype, device=f.device)
    hi0, lo0, m0 = _dd_chain3(words[0])
    hi1, lo1, m1 = _dd_chain3(words[1])
    if len(words) == 3:
        s2 = p3._nb_sum3(words[2]) - 6.0 * words[2][1:-1, 1:-1, 1:-1]
    else:
        s2 = torch.zeros_like(hi0)
    p, pe = K._two_prod(hi0, c)
    r_big = (p - f[1:-1, 1:-1, 1:-1]) + pe
    t, tc = K._two_sum(lo0, hi1)
    t2 = ((lo1 + m0) + (m1 + s2)) + tc
    r = torch.zeros_like(f)
    r[1:-1, 1:-1, 1:-1] = (r_big + t * c) + t2 * c
    return r


def residual_df3_torch(u0, u1, f, h: float):
    return residual_mw3_torch((u0, u1), f, h)


def residual_tw3_torch(u0, u1, u2, f, h: float):
    return residual_mw3_torch((u0, u1, u2), f, h)


def fused_jacobi3_residual_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                                 from_zero: bool = False, negate: bool = False):
    """``steps`` sweeps and the residual of the result (negated when
    ``negate``): (u, r)."""
    u = fused_jacobi3_torch(u, f, h, steps, omega, from_zero)
    return u, residual3_torch(u, f, h, negate)


# --- plain twins of the shard modes, on a shard's windows ---------------------------

def _inner3(x):
    return x[1:-1, 1:-1, 1:-1]


def _sweep3_ext(u, f, zin, h: float, omega: float):
    """``models.poisson3d.jacobi_sweep3`` on a window, frozen on the planes
    where ``zin`` is False (the global z faces and beyond the grid)."""
    incr = (p3._nb_sum3(u) - 6.0 * _inner3(u)) - (h * h) * _inner3(f)
    out = u.clone()
    out[1:-1, 1:-1, 1:-1] = torch.where(zin[1:-1, None, None],
                                        _inner3(u) + (omega / 6.0) * incr, _inner3(u))
    return out


def _residual3_ext(u, f, zin, h: float):
    """``models.poisson3d.residual3`` on a window, 0 off the interior."""
    inv_h2 = 1.0 / (h * h)
    r = torch.zeros_like(u)
    r[1:-1, 1:-1, 1:-1] = torch.where(
        zin[1:-1, None, None], inv_h2 * (p3._nb_sum3(u) - 6.0 * _inner3(u)) - _inner3(f),
        torch.zeros((), dtype=u.dtype, device=u.device))
    return r


def _raw3(vals, geo: ShardGeo3):
    """Σ vals over the owned interior cells in float64: a shard's raw error."""
    take = geo.owned_inner(vals.device)
    return torch.sum(vals[take][:, 1:-1, 1:-1], dtype=torch.float64)


def _raw_error3(fin, prev, f, geo: ShardGeo3, zin, h: float, mode: str):
    """Σ|r(fin)| (clean) or Σ|fin − prev| (gpu) over the owned interior."""
    if mode == "gpu":
        return _raw3(torch.abs(fin - prev), geo)
    return _raw3(torch.abs(_residual3_ext(fin, f, zin, h)), geo)


def _sweeps3_ext(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int, omega: float,
                 from_zero: bool):
    """``steps`` sweeps on a window: (the iterate, the one before it). From
    u ≡ 0 (``from_zero``) the first is the closed form (ω/6)·(0 − h²f), the
    sweep's arithmetic on zeros, taken pointwise so that it spends no halo
    plane, as in the kernels."""
    zin = geo.inner(f_ext.device)
    u = prev = u_ext
    if from_zero:
        prev = torch.zeros_like(f_ext)
        u = prev.clone()
        u[:, 1:-1, 1:-1] = torch.where(
            zin[:, None, None],
            (omega / 6.0) * (prev[:, 1:-1, 1:-1] - (h * h) * f_ext[:, 1:-1, 1:-1]),
            prev[:, 1:-1, 1:-1])
        steps -= 1
    for _ in range(steps):
        prev, u = u, _sweep3_ext(u, f_ext, zin, h, omega)
    return u, prev


def fused_jacobi3_shard_torch(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                              omega: float = 6.0 / 7.0, from_zero: bool = False, err_mode=None,
                              plan=None):
    """Twin of ``fused_jacobi3_shard``: (owned planes, raw error or None;
    the tile ``plan`` has no counterpart here)."""
    u, prev = _sweeps3_ext(u_ext, f_ext, geo, h, steps, omega, from_zero)
    raw = None
    if err_mode is not None:
        raw = _raw_error3(u, prev, f_ext, geo, geo.inner(f_ext.device), h, err_mode)
    return geo.owned(u).contiguous(), raw


def fused_jacobi3_errs_shard_torch(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                                   omega: float = 6.0 / 7.0, compat: str = "clean"):
    """Twin of ``fused_jacobi3_errs_shard``: (owned planes, the raw error of
    every iterate)."""
    zin = geo.inner(f_ext.device)
    u, raws = u_ext, []
    for _ in range(steps):
        prev, u = u, _sweep3_ext(u, f_ext, zin, h, omega)
        raws.append(_raw_error3(u, prev, f_ext, geo, zin, h, compat))
    return geo.owned(u).contiguous(), torch.stack(raws)


def fused_jacobi3_residual_shard_torch(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                                       omega: float = 6.0 / 7.0, from_zero: bool = False,
                                       negate: bool = False):
    """Twin of ``fused_jacobi3_residual_shard``: (owned planes of the
    iterate, of its residual)."""
    u, _ = _sweeps3_ext(u_ext, f_ext, geo, h, steps, omega, from_zero)
    r = geo.owned(_residual3_ext(u, f_ext, geo.inner(f_ext.device), h)).contiguous()
    return geo.owned(u).contiguous(), (-r if negate else r)


def residual3_shard_torch(u_ext, f_ext, geo: ShardGeo3, h: float, negate: bool = False):
    """Twin of ``residual3_shard``: the owned planes of the residual."""
    r = geo.owned(_residual3_ext(u_ext, f_ext, geo.inner(f_ext.device), h)).contiguous()
    return -r if negate else r


def coarse_planes3(geo: ShardGeo3) -> tuple[int, int]:
    """[K0, K1): the coarse planes of an even-origin shard's fine planes,
    the slab its descend leg writes."""
    return geo.z0 // 2, (geo.z0 + geo.nz + 1) // 2


def _restrict_yx(s, n: int, fw: bool):
    """The y and x passes of ``transfers3.restrict3`` on a stack of
    z-restricted planes: (k, n, n) → (k, m − 2, m − 2)."""
    if not fw:
        return s[:, 2:-2:2, 2:-2:2]
    s = (0.25 * s[:, 1:n - 3:2] + 0.5 * s[:, 2:n - 2:2]) + 0.25 * s[:, 3:n - 1:2]
    return (0.25 * s[:, :, 1:n - 3:2] + 0.5 * s[:, :, 2:n - 2:2]) + 0.25 * s[:, :, 3:n - 1:2]


def fused_descend3_shard_torch(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                               omega: float = 6.0 / 7.0, from_zero: bool = False,
                               restriction: str = "full_weighting", want_err: bool = False):
    """Twin of ``fused_descend3_shard``: (owned planes, the shard's slab of
    the coarse right-hand side, raw clean error or None)."""
    n, m = geo.n, (geo.n + 1) // 2
    zin = geo.inner(f_ext.device)
    u, _ = _sweeps3_ext(u_ext, f_ext, geo, h, steps, omega, from_zero)
    d = -_residual3_ext(u, f_ext, zin, h)
    raw = _raw3(torch.abs(d), geo) if want_err else None
    k0, k1 = coarse_planes3(geo)
    ks = [k for k in range(k0, k1) if 1 <= k <= m - 2]
    fc = torch.zeros((k1 - k0, m, m), dtype=f_ext.dtype, device=f_ext.device)
    if ks:
        # window plane of fine plane 2K
        zk = torch.tensor([2 * k - geo.z0 + geo.ext for k in ks], device=d.device)
        if restriction == "full_weighting":
            s = (0.25 * d[zk - 1] + 0.5 * d[zk]) + 0.25 * d[zk + 1]
        else:
            s = d[zk]
        fc[ks[0] - k0:ks[-1] - k0 + 1, 1:-1, 1:-1] = _restrict_yx(
            s, n, restriction == "full_weighting")
    return geo.owned(u).contiguous(), fc, raw


def _prolong3_planes(c_win, cz0: int, geo: ShardGeo3):
    """``models.poisson3d.prolong3`` at the window's planes from the coarse
    planes [cz0, cz0 + len(c_win)) (z, then y, then x); planes it cannot
    reach hold garbage that the caller masks."""
    n = geo.n
    gz = geo.gz(c_win.device)
    top = c_win.shape[0] - 1
    lo = torch.clamp(torch.div(gz, 2, rounding_mode="floor") - cz0, 0, top)
    hi = torch.clamp(lo + 1, 0, top)
    a = torch.where((gz % 2 == 1)[:, None, None], 0.5 * (c_win[lo] + c_win[hi]), c_win[lo])
    b = torch.empty((a.shape[0], n, a.shape[2]), dtype=a.dtype, device=a.device)
    b[:, ::2] = a
    b[:, 1::2] = 0.5 * (a[:, :-1] + a[:, 1:])
    out = torch.empty((a.shape[0], n, n), dtype=a.dtype, device=a.device)
    out[:, :, ::2] = b
    out[:, :, 1::2] = 0.5 * (b[:, :, :-1] + b[:, :, 1:])
    return out


def fused_ascend3_shard_torch(u_ext, f_ext, c_win, cz0: int, geo: ShardGeo3, h: float,
                              steps: int, omega: float = 6.0 / 7.0, want_err: bool = False):
    """Twin of ``fused_ascend3_shard``: (owned planes, raw clean error or
    None)."""
    zin = geo.inner(f_ext.device)
    e = _prolong3_planes(c_win, cz0, geo)
    u = u_ext.clone()
    u[:, 1:-1, 1:-1] = torch.where(zin[:, None, None],
                                   u_ext[:, 1:-1, 1:-1] + e[:, 1:-1, 1:-1], u_ext[:, 1:-1, 1:-1])
    return fused_jacobi3_shard_torch(u, f_ext, geo, h, steps, omega, False,
                                     "clean" if want_err else None)


# --- CUDA launches ---------------------------------------------------------------

def _grid3_args(f: torch.Tensor, aligned: bool = False):
    """Validate the level's f and return (n, device, library, stream)."""
    from . import build

    if not f.is_cuda:
        raise ValueError(f"CUDA kernel called on a {f.device} tensor")
    n = f.shape[0]
    if f.dim() != 3 or n < 3 or (aligned and n % 2 == 0):
        raise ValueError(f"expected an (n, n, n) level with n >= 3"
                         f"{' odd (2:1-aligned)' if aligned else ''}, got {tuple(f.shape)}")
    K._check("f", f, (n, n, n), f.device)
    if f.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {f.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return n, f.device, build.load(), torch.cuda.current_stream(f.device).cuda_stream


def _err_buffers3(want: bool, n: int, plan, device):
    """(the float64 block partials, the 1-element fp32 metric), or Nones."""
    if not want:
        return None, None
    return (torch.empty(blocks3(n, *plan), dtype=torch.float64, device=device),
            torch.empty(1, dtype=torch.float32, device=device))


def _scalar(err):
    return None if err is None else err.reshape(())


def _check_steps3(steps: int, cap: int, what: str) -> None:
    if not 1 <= steps <= cap:
        raise ValueError(f"{what} runs 1..{cap} sweeps per pass, got {steps}")


def _jacobi3_cuda(u, f, h: float, steps: int, omega: float, from_zero: bool, mode,
                  plan=None):
    n, dev, lib, stream = _grid3_args(f)
    if not from_zero:
        K._check("u", u, (n, n, n), dev)
    stages = steps - int(from_zero) + (mode == "clean")
    plan = plan or plan3(n, stages, stages)
    out = torch.empty_like(f)
    partials, err = _err_buffers3(mode is not None, n, plan, dev)
    rc = lib.mg3_jacobi(K._ptr(None if from_zero else u), f.data_ptr(), out.data_ptr(),
                        K._ptr(partials), K._ptr(err), n, steps, int(from_zero),
                        _ERR_CODES3[mode], *plan, h * h, omega / 6.0, 1.0 / (h * h),
                        p3.error_scale3(mode, n, h), stream)
    K._raise_on(lib, rc, "jacobi3")
    K.launches["jacobi3"] += 1
    return out, _scalar(err)


# --- public entry points ------------------------------------------------------

def fused_jacobi3(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                  from_zero: bool = False):
    """1..8 damped-Jacobi sweeps in one pass over memory (counterpart of
    ``fused_jacobi3_padded``). ``from_zero``: the caller guarantees u ≡ 0,
    and u is not read."""
    _check_steps3(steps, MAX_FUSED_SWEEPS_3D, "fused_jacobi3")
    if not f.is_cuda:
        return fused_jacobi3_torch(u, f, h, steps, omega, from_zero)
    return _jacobi3_cuda(u, f, h, steps, omega, from_zero, None)[0]


def fused_jacobi3_err(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                      err_mode: str = "clean", from_zero: bool = False):
    """1..8 sweeps with the smoothing error of the result fused into the
    pass (``fused_jacobi3_padded(err_mode=...)``, divided by n³): (u, err).
    "clean" takes one more halo ring, so at most 7 sweeps after from_zero's
    closed-form one."""
    if err_mode not in ("clean", "gpu"):
        raise ValueError(f"unknown err_mode {err_mode!r}; expected 'clean' or 'gpu'")
    _check_steps3(steps, MAX_FUSED_SWEEPS_3D, "fused_jacobi3_err")
    if err_mode == "clean" and steps - int(from_zero) > MAX_FUSED_SWEEPS_3D - 1:
        raise ValueError("the fused clean error needs at most 7 neighbor-reading sweeps")
    if not f.is_cuda:
        return fused_jacobi3_err_torch(u, f, h, steps, omega, err_mode, from_zero)
    return _jacobi3_cuda(u, f, h, steps, omega, from_zero, err_mode)


def trigger_step3(u, f, h: float, omega: float = 6.0 / 7.0, compat: str = "clean"):
    """One sweep and the error of the result, a step of a trigger loop: on
    the card a one-sweep ``fused_jacobi3_err`` launch with the trigger loops'
    tile plan (``err_plan3``), so its error is the float the per-sweep passes
    and the whole-loop kernels report for the same iterate. (u, err)."""
    _check_compat3(compat)
    if not f.is_cuda:
        return trigger_step3_torch(u, f, h, omega, compat)
    return _jacobi3_cuda(u, f, h, 1, omega, False, compat, err_plan3(f.shape[0]))


def fused_descend3(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                   from_zero: bool = False, restriction: str = "full_weighting",
                   want_err: bool = False):
    """The descend leg on an aligned level n = 2m − 1: ``steps`` sweeps, −r
    of the result and its 2:1 restriction, in one pass (counterpart of
    ``fused_descend3_padded`` + ``restrict3_lanes_p``). Returns (u,
    f_coarse (m, m, m), the clean error or None)."""
    fw = restriction == "full_weighting"
    if not fw and restriction != "sampling":
        raise ValueError(f"unknown restriction mode {restriction!r}")
    cap = MAX_DESCEND3_SWEEPS_FW if fw else MAX_DESCEND3_SWEEPS_SAMPLING
    if steps < 1 or not 0 <= steps - int(from_zero) <= cap:
        raise ValueError(f"the {restriction} descend leg runs 1..{cap} neighbor-reading "
                         f"sweeps, got steps={steps}, from_zero={from_zero}")
    if not f.is_cuda:
        return fused_descend3_torch(u, f, h, steps, omega, from_zero, restriction, want_err)
    n, dev, lib, stream = _grid3_args(f, aligned=True)
    if not from_zero:
        K._check("u", u, (n, n, n), dev)
    m = (n + 1) // 2
    stages = steps - int(from_zero) + 1
    plan = plan3(n, stages, stages + int(fw))
    out = torch.empty_like(f)
    fc = torch.empty((m, m, m), dtype=f.dtype, device=dev)
    partials, err = _err_buffers3(want_err, n, plan, dev)
    rc = lib.mg3_descend(K._ptr(None if from_zero else u), f.data_ptr(), out.data_ptr(),
                         fc.data_ptr(), K._ptr(partials), K._ptr(err), n, steps, int(from_zero),
                         int(fw), int(want_err), *plan, h * h, omega / 6.0, 1.0 / (h * h),
                         p3.error_scale3("clean", n, h), stream)
    K._raise_on(lib, rc, "descend3")
    K.launches["descend3"] += 1
    return out, fc, _scalar(err)


def fused_ascend3(u, f, uc, h: float, steps: int, omega: float = 6.0 / 7.0,
                  want_err: bool = False):
    """The ascend leg on an aligned level n = 2m − 1: prolong the coarse
    (m, m, m) correction ``uc``, add it on the interior, ``steps`` sweeps, in
    one pass (counterpart of ``prolong3_lanes_p`` + ``fused_ascend3_padded``).
    Returns (u, the clean error or None); the error needs steps ≤ 7."""
    _check_steps3(steps, MAX_FUSED_SWEEPS_3D - int(want_err), "fused_ascend3")
    if not f.is_cuda:
        return fused_ascend3_torch(u, f, uc, h, steps, omega, want_err)
    n, dev, lib, stream = _grid3_args(f, aligned=True)
    m = (n + 1) // 2
    K._check("u", u, (n, n, n), dev)
    K._check("uc", uc, (m, m, m), dev)
    stages = steps + int(want_err)
    plan = plan3(n, stages, stages)
    out = torch.empty_like(f)
    partials, err = _err_buffers3(want_err, n, plan, dev)
    rc = lib.mg3_ascend(u.data_ptr(), f.data_ptr(), uc.data_ptr(), out.data_ptr(),
                        K._ptr(partials), K._ptr(err), n, steps, _ERR_CODES3["clean" if want_err
                                                                              else None],
                        *plan, h * h, omega / 6.0, 1.0 / (h * h),
                        p3.error_scale3("clean", n, h), stream)
    K._raise_on(lib, rc, "ascend3")
    K.launches["ascend3"] += 1
    return out, _scalar(err)


def residual3(u, f, h: float, negate: bool = False):
    """7-point residual, 0 on the faces, optionally negated (counterpart of
    ``residual3_pallas``)."""
    if not f.is_cuda:
        return residual3_torch(u, f, h, negate)
    n, dev, lib, stream = _grid3_args(f)
    K._check("u", u, (n, n, n), dev)
    r = torch.empty_like(f)
    rc = lib.mg3_residual(u.data_ptr(), f.data_ptr(), r.data_ptr(), n, int(negate),
                          *plan3(n, 1, 1), 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "residual3")
    K.launches["residual3"] += 1
    return r


def fused_jacobi3_errs(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                       compat: str = "clean"):
    """``steps`` ≤ ``errs3_sweep_cap(compat)`` sweeps in one pass with the
    error of every iterate (counterpart of ``fused_jacobi3_errs_padded``):
    (u, errs), errs[s − 1] the error ``fused_jacobi3_err`` reports after s
    sweeps, and on the card bit for bit the error of the s-th of s
    ``trigger_step3`` launches (both use ``err_plan3``)."""
    _check_compat3(compat)
    _check_steps3(steps, errs3_sweep_cap(compat), f"fused_jacobi3_errs ({compat})")
    if not f.is_cuda:
        return fused_jacobi3_errs_torch(u, f, h, steps, omega, compat)
    n, dev, lib, stream = _grid3_args(f)
    K._check("u", u, (n, n, n), dev)
    plan = err_plan3(n)
    out = torch.empty_like(f)
    partials = torch.empty(steps * blocks3(n, *plan), dtype=torch.float64, device=dev)
    errs = torch.empty(steps, dtype=torch.float32, device=dev)
    rc = lib.mg3_jacobi_errs(u.data_ptr(), f.data_ptr(), out.data_ptr(), partials.data_ptr(),
                             errs.data_ptr(), n, steps, _ERR_CODES3[compat], *plan, h * h,
                             omega / 6.0, 1.0 / (h * h), p3.error_scale3(compat, n, h), stream)
    K._raise_on(lib, rc, "jacobi3_errs")
    K.launches["jacobi3_errs"] += 1
    return out, errs


def _trigger3_cuda(name: str, u, f, h: float, omega: float, compat: str, trigger: float,
                   max_sweeps: int):
    """One launch of a whole-loop trigger kernel: (u, err, sweeps)."""
    if not 1 <= max_sweeps < 2 ** 31:
        raise ValueError(f"max_sweeps must lie in 1..2**31 − 1, got {max_sweeps}")
    n, dev, lib, stream = _grid3_args(f)
    K._check("u", u, (n, n, n), dev)
    plan = err_plan3(n)
    batch = errs3_sweep_cap(compat) if name == "trigger3_stream" else 1
    out, tmp = torch.empty_like(f), torch.empty_like(f)
    partials = torch.empty(2 * batch * blocks3(n, *plan), dtype=torch.float64, device=dev)
    err = torch.empty(1, dtype=torch.float32, device=dev)
    sweeps = torch.empty(1, dtype=torch.int32, device=dev)
    head = (u.data_ptr(), f.data_ptr(), out.data_ptr(), tmp.data_ptr(), partials.data_ptr(),
            err.data_ptr(), sweeps.data_ptr(), n, _ERR_CODES3[compat])
    tail = (*plan, h * h, omega / 6.0, 1.0 / (h * h), p3.error_scale3(compat, n, h), trigger,
            max_sweeps, stream)
    if name == "trigger3_stream":
        rc = lib.mg3_trigger_stream(*head, batch, *tail)
    else:
        rc = lib.mg3_trigger(*head, *tail)
    K._raise_on(lib, rc, name)
    K.launches[name] += 1
    return out, err.reshape(()), sweeps.reshape(())


def trigger_smooth3(u, f, h: float, omega: float = 6.0 / 7.0, compat: str = "clean",
                    trigger: float = 0.01, max_sweeps: int = 100_000):
    """Error-triggered smoothing with the whole loop in one launch
    (counterpart of ``fused_trigger3_vmem``): one sweep at a time while
    |err_k − err_{k−1}| > trigger, at most ``max_sweeps``. Returns (u, err,
    sweeps), ``sweeps`` a 0-d int32 tensor; nothing is read back to the host.
    On the card the iterate, the stop sweep and the error are those of the
    loop of ``trigger_step3`` launches, bit for bit."""
    _check_compat3(compat)
    if not f.is_cuda:
        return trigger_smooth3_torch(u, f, h, omega, compat, trigger, max_sweeps)
    return _trigger3_cuda("trigger3", u, f, h, omega, compat, trigger, max_sweeps)


def trigger_smooth3_stream(u, f, h: float, omega: float = 6.0 / 7.0, compat: str = "clean",
                           trigger: float = 0.01, max_sweeps: int = 100_000):
    """The same loop for levels too large for ``trigger_smooth3`` to stay in
    L2 (counterpart of ``fused_trigger3_stream``): passes of
    ``errs3_sweep_cap(compat)`` sweeps with an exact replay of the stop rule,
    so the iterate, the stop sweep and the error are the sweep-at-a-time
    loop's. Returns (u, err, sweeps) as ``trigger_smooth3``."""
    _check_compat3(compat)
    if not f.is_cuda:
        return trigger_smooth3_torch(u, f, h, omega, compat, trigger, max_sweeps)
    return _trigger3_cuda("trigger3_stream", u, f, h, omega, compat, trigger, max_sweeps)


def _residual_mw3_cuda(words, f, h: float):
    n, dev, lib, stream = _grid3_args(f)
    for k, w in enumerate(words):
        K._check(f"u{k}", w, (n, n, n), dev)
    r = torch.empty_like(f)
    rc = lib.mg3_residual_mw(words[0].data_ptr(), words[1].data_ptr(),
                             K._ptr(words[2] if len(words) == 3 else None), f.data_ptr(),
                             r.data_ptr(), n, len(words), 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "residual_mw3")
    K.launches["residual_mw3"] += 1
    return r


def residual_df3(u0, u1, f, h: float):
    """Compensated 7-point residual of the double-word state (u0, u1), 0 off
    the interior (counterpart of ``residual_df3_pallas``)."""
    if not f.is_cuda:
        return residual_df3_torch(u0, u1, f, h)
    return _residual_mw3_cuda((u0, u1), f, h)


def residual_tw3(u0, u1, u2, f, h: float):
    """Compensated 7-point residual of the triple-word state (u0, u1, u2), 0
    off the interior (counterpart of ``residual_tw3_pallas``)."""
    if not f.is_cuda:
        return residual_tw3_torch(u0, u1, u2, f, h)
    return _residual_mw3_cuda((u0, u1, u2), f, h)


# --- the shard modes on the card -----------------------------------------------------

def _shard3_args(u_ext, f_ext, geo: ShardGeo3, halo: int, need_u: bool = True):
    """Validate a shard-mode launch; return (library, stream, device)."""
    from . import build

    if not f_ext.is_cuda:
        raise ValueError(f"CUDA kernel called on a {f_ext.device} tensor")
    n = geo.n
    if not (n >= 3 and 0 <= geo.z0 and geo.nz >= 1 and geo.z0 + geo.nz <= n
            and geo.ext >= 0):
        raise ValueError(f"a shard's planes must lie in the {n}³ grid, got {geo}")
    # the window must hold the pass's halo wherever the shard has a neighbour
    if geo.ext < halo and (geo.z0 > 0 or geo.z0 + geo.nz < n):
        raise ValueError(f"the pass needs {halo} halo planes, the shard carries {geo.ext}")
    K._check("f", f_ext, geo.ext_shape, f_ext.device)
    if need_u:
        K._check("u", u_ext, geo.ext_shape, f_ext.device)
    if f_ext.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {f_ext.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return build.load(), torch.cuda.current_stream(f_ext.device).cuda_stream, f_ext.device


def _planes3(geo: ShardGeo3):
    return geo.n, geo.z0, geo.nz, geo.ext


def _raw_buffers3(want: bool, geo: ShardGeo3, plan, device, rows: int = 1):
    """(the float64 block partials, the shard's raw sums), or Nones."""
    if not want:
        return None, None
    nb = blocks3(geo.n, *plan, nz=geo.nz)
    return (torch.empty(rows * nb, dtype=torch.float64, device=device),
            torch.empty(rows, dtype=torch.float64, device=device))


def fused_jacobi3_shard(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                        omega: float = 6.0 / 7.0, from_zero: bool = False, err_mode=None,
                        plan=None):
    """One pass of 1..8 sweeps on one z-shard's planes (kernel 10's shard
    mode): ``u_ext``, ``f_ext`` are its windows (u unread when
    ``from_zero``); ``err_mode`` None, "clean" (at most 7 sweeps after the
    closed-form one) or "gpu" adds the shard's raw error over its owned
    planes, a float64 Σ|r| or Σ|Δu|. ``plan``: the tile plan (``err_plan3``
    of the shard's depth in a trigger loop). Returns (owned planes, raw
    error as a 0-d float64 tensor, or None)."""
    if err_mode not in (None, "clean", "gpu"):
        raise ValueError(f"unknown err_mode {err_mode!r}; expected None, 'clean' or 'gpu'")
    _check_steps3(steps, MAX_FUSED_SWEEPS_3D, "fused_jacobi3_shard")
    stages = steps - int(from_zero) + (err_mode == "clean")
    if stages > MAX_FUSED_SWEEPS_3D:
        raise ValueError("the fused clean error needs at most 7 neighbor-reading sweeps")
    if not f_ext.is_cuda:
        return fused_jacobi3_shard_torch(u_ext, f_ext, geo, h, steps, omega, from_zero, err_mode)
    lib, stream, dev = _shard3_args(u_ext, f_ext, geo, stages, not from_zero)
    plan = plan or plan3(geo.nz, stages, stages)
    out = torch.empty((geo.nz, geo.n, geo.n), dtype=f_ext.dtype, device=dev)
    partials, raw = _raw_buffers3(err_mode is not None, geo, plan, dev)
    rc = lib.mg3_jacobi_shard(K._ptr(None if from_zero else u_ext), f_ext.data_ptr(),
                              out.data_ptr(), K._ptr(partials), K._ptr(raw), *_planes3(geo),
                              steps, int(from_zero), _ERR_CODES3[err_mode], *plan, h * h,
                              omega / 6.0, 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "jacobi3 shard")
    K.launches["jacobi3_shard"] += 1
    return out, _scalar(raw)


def fused_jacobi3_errs_shard(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                             omega: float = 6.0 / 7.0, compat: str = "clean"):
    """``steps`` ≤ ``errs3_sweep_cap(compat)`` sweeps on one z-shard's planes
    in one pass with the raw error of every iterate (kernel 10's per_sweep
    shard mode), with the trigger loops' tile plan of the shard's depth:
    (owned planes, raws of shape (steps,), float64)."""
    _check_compat3(compat)
    _check_steps3(steps, errs3_sweep_cap(compat), f"fused_jacobi3_errs_shard ({compat})")
    if not f_ext.is_cuda:
        return fused_jacobi3_errs_shard_torch(u_ext, f_ext, geo, h, steps, omega, compat)
    lib, stream, dev = _shard3_args(u_ext, f_ext, geo, steps + (compat == "clean"))
    plan = err_plan3(geo.nz)
    out = torch.empty((geo.nz, geo.n, geo.n), dtype=f_ext.dtype, device=dev)
    partials, raws = _raw_buffers3(True, geo, plan, dev, steps)
    rc = lib.mg3_jacobi_errs_shard(u_ext.data_ptr(), f_ext.data_ptr(), out.data_ptr(),
                                   partials.data_ptr(), raws.data_ptr(), *_planes3(geo), steps,
                                   _ERR_CODES3[compat], *plan, h * h, omega / 6.0,
                                   1.0 / (h * h), stream)
    K._raise_on(lib, rc, "jacobi3_errs shard")
    K.launches["jacobi3_errs_shard"] += 1
    return out, raws


def fused_jacobi3_residual_shard(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                                 omega: float = 6.0 / 7.0, from_zero: bool = False,
                                 negate: bool = False):
    """Kernel 10's emit_residual mode on one z-shard's planes: ``steps``
    sweeps (at most 7 after from_zero's closed-form one) and the residual of
    the result, negated when ``negate``, from one pass. Returns (owned planes
    of the iterate, of the residual)."""
    if steps < 1 or steps - int(from_zero) > MAX_FUSED_SWEEPS_3D - 1:
        raise ValueError(f"emit_residual runs 1..7 neighbor-reading sweeps, got steps={steps}, "
                         f"from_zero={from_zero}")
    if not f_ext.is_cuda:
        return fused_jacobi3_residual_shard_torch(u_ext, f_ext, geo, h, steps, omega, from_zero,
                                                  negate)
    stages = steps - int(from_zero) + 1
    lib, stream, dev = _shard3_args(u_ext, f_ext, geo, stages, not from_zero)
    out = torch.empty((geo.nz, geo.n, geo.n), dtype=f_ext.dtype, device=dev)
    r = torch.empty_like(out)
    rc = lib.mg3_jacobi_residual_shard(K._ptr(None if from_zero else u_ext), f_ext.data_ptr(),
                                       out.data_ptr(), r.data_ptr(), *_planes3(geo), steps,
                                       int(from_zero), int(negate), *plan3(geo.nz, stages, stages),
                                       h * h, omega / 6.0, 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "jacobi3 emit_residual")
    K.launches["jacobi3_residual"] += 1
    return out, r


def fused_jacobi3_residual(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                           from_zero: bool = False, negate: bool = False):
    """``steps`` sweeps (at most 7 after from_zero's closed-form one) and the
    residual of the result from one pass over memory (counterpart of
    ``fused_jacobi3_residual_padded``): (u, r)."""
    if not f.is_cuda:
        return fused_jacobi3_residual_torch(u, f, h, steps, omega, from_zero, negate)
    n = _grid3_args(f)[0]
    return fused_jacobi3_residual_shard(u, f, ShardGeo3(n, 0, n), h, steps, omega, from_zero,
                                        negate)


def residual3_shard(u_ext, f_ext, geo: ShardGeo3, h: float, negate: bool = False):
    """The 7-point residual of one z-shard's planes (kernel 13's shard mode;
    windows of ≥ 1 halo plane), optionally negated: its owned planes."""
    if not f_ext.is_cuda:
        return residual3_shard_torch(u_ext, f_ext, geo, h, negate)
    lib, stream, dev = _shard3_args(u_ext, f_ext, geo, 1)
    r = torch.empty((geo.nz, geo.n, geo.n), dtype=f_ext.dtype, device=dev)
    rc = lib.mg3_residual_shard(u_ext.data_ptr(), f_ext.data_ptr(), r.data_ptr(), *_planes3(geo),
                                int(negate), *plan3(geo.nz, 1, 1), 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "residual3 shard")
    K.launches["residual3_shard"] += 1
    return r


def _check_leg_shard3(geo: ShardGeo3):
    if geo.n % 2 == 0 or geo.z0 % 2:
        raise ValueError(f"a 2:1 leg needs an odd level and an even shard origin, got {geo}")


def fused_descend3_shard(u_ext, f_ext, geo: ShardGeo3, h: float, steps: int,
                         omega: float = 6.0 / 7.0, from_zero: bool = False,
                         restriction: str = "full_weighting", want_err: bool = False):
    """The descend leg on one z-shard's planes of an aligned level n = 2m − 1
    (kernel 11's shard mode; even origin): sweeps, −r and its restriction onto
    the shard's coarse planes (``coarse_planes3``), with the raw clean error
    when ``want_err``. Returns (owned planes, coarse slab (K1 − K0, m, m), raw
    error or None)."""
    fw = restriction == "full_weighting"
    if not fw and restriction != "sampling":
        raise ValueError(f"unknown restriction mode {restriction!r}")
    cap = MAX_DESCEND3_SWEEPS_FW if fw else MAX_DESCEND3_SWEEPS_SAMPLING
    if steps < 1 or not 0 <= steps - int(from_zero) <= cap:
        raise ValueError(f"the {restriction} descend leg runs 1..{cap} neighbor-reading "
                         f"sweeps, got steps={steps}, from_zero={from_zero}")
    _check_leg_shard3(geo)
    if not f_ext.is_cuda:
        return fused_descend3_shard_torch(u_ext, f_ext, geo, h, steps, omega, from_zero,
                                          restriction, want_err)
    stages = steps - int(from_zero) + 1
    lib, stream, dev = _shard3_args(u_ext, f_ext, geo, stages + int(fw), not from_zero)
    m = (geo.n + 1) // 2
    k0, k1 = coarse_planes3(geo)
    plan = plan3(geo.nz, stages, stages + int(fw))
    out = torch.empty((geo.nz, geo.n, geo.n), dtype=f_ext.dtype, device=dev)
    fc = torch.empty((k1 - k0, m, m), dtype=f_ext.dtype, device=dev)
    partials, raw = _raw_buffers3(want_err, geo, plan, dev)
    rc = lib.mg3_descend_shard(K._ptr(None if from_zero else u_ext), f_ext.data_ptr(),
                               out.data_ptr(), fc.data_ptr(), K._ptr(partials), K._ptr(raw),
                               *_planes3(geo), steps, int(from_zero), int(fw), int(want_err),
                               *plan, h * h, omega / 6.0, 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "descend3 shard")
    K.launches["descend3_shard"] += 1
    return out, fc, _scalar(raw)


def fused_ascend3_shard(u_ext, f_ext, c_win, cz0: int, geo: ShardGeo3, h: float, steps: int,
                        omega: float = 6.0 / 7.0, want_err: bool = False):
    """The ascend leg on one z-shard's planes of an aligned level n = 2m − 1
    (kernel 12's shard mode; even origin): ``c_win`` holds the coarse
    correction's planes [cz0, cz0 + len(c_win)), every one the shard's window
    interpolates from. Returns (owned planes, raw clean error or None; the
    error needs steps ≤ 7)."""
    _check_steps3(steps, MAX_FUSED_SWEEPS_3D - int(want_err), "fused_ascend3_shard")
    _check_leg_shard3(geo)
    if not f_ext.is_cuda:
        return fused_ascend3_shard_torch(u_ext, f_ext, c_win, cz0, geo, h, steps, omega,
                                         want_err)
    stages = steps + int(want_err)
    lib, stream, dev = _shard3_args(u_ext, f_ext, geo, stages)
    m = (geo.n + 1) // 2
    K._check("c", c_win, (c_win.shape[0], m, m), dev)
    plan = plan3(geo.nz, stages, stages)
    out = torch.empty((geo.nz, geo.n, geo.n), dtype=f_ext.dtype, device=dev)
    partials, raw = _raw_buffers3(want_err, geo, plan, dev)
    rc = lib.mg3_ascend_shard(u_ext.data_ptr(), f_ext.data_ptr(), c_win.data_ptr(),
                              out.data_ptr(), K._ptr(partials), K._ptr(raw), *_planes3(geo), cz0,
                              c_win.shape[0], steps, _ERR_CODES3["clean" if want_err else None],
                              *plan, h * h, omega / 6.0, 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "ascend3 shard")
    K.launches["ascend3_shard"] += 1
    return out, _scalar(raw)
