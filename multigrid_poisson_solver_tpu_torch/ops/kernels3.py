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
  * ``residual3``: ``csrc/residual3.cu``, replaces ``_residual3_kernel``.

The four share the tile pipeline of ``csrc/legs3.cuh``. The TPU kernels'
brick geometry (``_brick_geometry``: ×8-row and ×128-lane padding, VMEM
budgets) has no counterpart: the port's levels are plain contiguous
(n, n, n) tensors, and ``plan3`` picks a column tile and a z chunk that fit
a block's shared memory.

Routing is by the tensors' device and nothing else: CPU tensors run the plain
twin (``*_torch``, built from ``models.poisson3d``), CUDA tensors launch the
kernel, and a build or launch failure or an input the kernel does not take
raises. The twins fix the operation order the kernels follow: the oracle
ops' (so a cycle on the kernels reproduces the plain cycle's iterates), with
the clean error taken as the TPU kernels take it, from Δ, the step of one
more sweep from the final iterate (Σ|r| = 6/(ωh²)·Σ|Δ|). Launches count in
``ops.kernels.launches``. Every function returns new tensors.
"""

from __future__ import annotations

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


def blocks3(n: int, ty: int, tx: int, cz: int) -> int:
    return -(-n // tx) * -(-n // ty) * -(-n // cz)


# --- plain PyTorch twins ------------------------------------------------------

def _sweeps3(u, f, h: float, k: int, omega: float):
    for _ in range(k):
        u = p3.jacobi_sweep3(u, f, h, omega)
    return u


def _delta3(u, f, h: float, omega: float):
    """The interior step of one more sweep from u: (ω/6)·((Σnb − 6u) − h²f)."""
    c = (slice(1, -1),) * 3
    return (omega / 6.0) * ((p3._nb_sum3(u) - 6.0 * u[c]) - (h * h) * f[c])


def _clean_err3(u, f, h: float, omega: float):
    n = f.shape[0]
    return torch.sum(torch.abs(_delta3(u, f, h, omega))) * (6.0 / (omega * h * h) / n ** 3)


def fused_jacobi3_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                        from_zero: bool = False):
    """``steps`` sweeps; ``from_zero``: u is known to be 0 (not read; the
    first sweep from zero is the kernel's closed form bit for bit)."""
    return _sweeps3(torch.zeros_like(f) if from_zero else u, f, h, steps, omega)


def fused_jacobi3_err_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                            err_mode: str = "clean", from_zero: bool = False):
    """``steps`` sweeps and the error of the result: (u, err). "clean":
    Σ|Δ|·6/(ωh²)/n³; "gpu": Σ|u_k − u_{k−1}|·6/h²/n³."""
    if err_mode == "gpu":
        n = f.shape[0]
        prev = fused_jacobi3_torch(u, f, h, steps - 1, omega, from_zero)
        fin = p3.jacobi_sweep3(prev, f, h, omega)
        c = (slice(1, -1),) * 3
        return fin, torch.sum(torch.abs(fin[c] - prev[c])) * (6.0 / (h * h) / n ** 3)
    fin = fused_jacobi3_torch(u, f, h, steps, omega, from_zero)
    return fin, _clean_err3(fin, f, h, omega)


def fused_descend3_torch(u, f, h: float, steps: int, omega: float = 6.0 / 7.0,
                         from_zero: bool = False, restriction: str = "full_weighting",
                         want_err: bool = False):
    """Sweeps, then the 2:1 restriction of −r: (u, f_coarse, clean err or None)."""
    m = (f.shape[0] + 1) // 2
    u = fused_jacobi3_torch(u, f, h, steps, omega, from_zero)
    err = _clean_err3(u, f, h, omega) if want_err else None
    return u, T3.restrict3(-p3.residual3(u, f, h), m, restriction), err


def fused_ascend3_torch(u, f, uc, h: float, steps: int, omega: float = 6.0 / 7.0,
                        want_err: bool = False):
    """Prolong uc, add it on the interior, post-sweeps: (u, clean err or None)."""
    u = _sweeps3(T3.prolong3_add(u, uc, interior_only=True), f, h, steps, omega)
    return u, (_clean_err3(u, f, h, omega) if want_err else None)


def residual3_torch(u, f, h: float, negate: bool = False):
    r = p3.residual3(u, f, h)
    return -r if negate else r


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
    if not want:
        return None, None
    return (torch.empty(blocks3(n, *plan), dtype=torch.float32, device=device),
            torch.empty(1, dtype=torch.float32, device=device))


def _scalar(err):
    return None if err is None else err.reshape(())


def _check_steps3(steps: int, cap: int, what: str) -> None:
    if not 1 <= steps <= cap:
        raise ValueError(f"{what} runs 1..{cap} sweeps per pass, got {steps}")


def _jacobi3_cuda(u, f, h: float, steps: int, omega: float, from_zero: bool, mode):
    n, dev, lib, stream = _grid3_args(f)
    if not from_zero:
        K._check("u", u, (n, n, n), dev)
    stages = steps - int(from_zero) + (mode == "clean")
    plan = plan3(n, stages, stages)
    out = torch.empty_like(f)
    partials, err = _err_buffers3(mode is not None, n, plan, dev)
    scale = (6.0 / (omega * h * h) if mode == "clean" else 6.0 / (h * h)) / n ** 3
    rc = lib.mg3_jacobi(K._ptr(None if from_zero else u), f.data_ptr(), out.data_ptr(),
                        K._ptr(partials), K._ptr(err), n, steps, int(from_zero),
                        _ERR_CODES3[mode], *plan, h * h, omega / 6.0, scale, stream)
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
                         6.0 / (omega * h * h) / n ** 3, stream)
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
                        *plan, h * h, omega / 6.0, 6.0 / (omega * h * h) / n ** 3, stream)
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
