"""The hot-path kernels: hand-written CUDA for Hopper, each with a plain twin.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/pallas_kernels.py`` and
``ops/pallas_chain.py`` (the kernels every 2-D single-device run reaches):

  * ``fused_jacobi``, ``fused_jacobi_err``: ``csrc/jacobi.cu``, replaces
    ``_fused_jacobi_kernel`` (its Jacobi modes);
  * ``fused_jacobi_errs``: ``csrc/jacobi.cu``, the same kernel's per-sweep
    error mode (``fused_jacobi_errs_padded``);
  * ``fused_rbgs``, ``fused_rbgs_err``: ``csrc/rbgs.cu``, the same
    kernel's rb-GS modes (``fused_rbgs_padded``, ``fused_rbgs_err_padded``);
  * ``residual``: ``csrc/residual.cu``, replaces ``_residual_kernel``;
  * ``residual_df``, ``residual_tw``: ``csrc/residual_mw.cu``, replaces
    ``_residual_mw_kernel``;
  * ``fused_descend``: ``csrc/descend.cu``, replaces ``_fused_descend_kernel``;
  * ``fused_ascend``: ``csrc/ascend.cu``, replaces ``_fused_ascend_kernel``;
  * ``chain_descend``: ``csrc/chain_descend.cu``, replaces
    ``_descend_chain_kernel``;
  * ``chain_ascend``: ``csrc/chain_ascend.cu``, replaces
    ``_ascend_chain_kernel`` (both chains: the levels above the split size
    ``CHAIN_SPLIT`` of ``csrc/chain_tail.cuh`` as a grid-wide tile launch,
    those at or below it in one thread block cluster);
  * ``trigger_smooth``: ``csrc/trigger.cu``, replaces ``_trigger_vmem_kernel``
    (levels up to 257² in one thread block cluster, then a tile loop, and
    from 1.5 M cells the next kernel's passes);
  * ``trigger_smooth_stream``: ``csrc/trigger_stream.cu``, replaces
    ``_trigger_stream_kernel`` (wavefront passes with an exact replay).

Routing is by the tensors' device and nothing else: CPU tensors run the
plain PyTorch twin (``*_torch``, built from the oracle ops in
``ops.stencils`` and ``ops.transfers``); CUDA tensors launch the kernel, and
a build or launch failure, or an input the kernel does not take (not fp32,
not contiguous, wrong shape), raises. There is no fallback.

bf16 states: ``fused_jacobi``, ``fused_jacobi_err``, ``residual``,
``fused_descend`` and ``fused_ascend`` also take bfloat16 grids on the whole
grid (``csrc/*_bf16.cu``, the bf16 modes of kernels 1-4, counted under
``*_bf16``): bit for bit their twins run on bf16 tensors, which PyTorch
computes op by op in float and rounds to bf16; the error partials are
float, the error a bf16 scalar. Every other entry point takes float32 only
(ROADMAP Queue 2 A2).

``launches`` counts kernel launches per kernel (the ``sum_partials`` second
pass of an error reduction belongs to the launch it finishes); it lets a run
show that the main path went through the kernels. A chain call counts the
kernels it launched: the wide launch, the cluster tail, or both. The 3-D kernels
(``ops.kernels3``) count in the same dictionary.

Grids are plain contiguous (n, n) tensors. Every function returns new
tensors and leaves its arguments untouched.

Shard mode (``*_shard``): the same kernels on one shard's block of a sharded
level, the counterparts of ``_fused_jacobi_shard_call``,
``_residual_shard_call``, ``_fused_descend_shard_call`` and
``_fused_ascend_shard_call``. The block is described by a ``ShardGeo`` (its
global origin and extent, and the halo rows and columns its inputs carry);
masks use global indices, only owned cells come back, and an error comes
back as the shard's raw partial, which ``parallel.kernel_shard`` adds over
the shards in shard order before scaling. They count under their own names
(``jacobi_shard``, ...). The ring kernels of ``ops.rdma`` count here too.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from . import stencils
from . import transfers as T

MAX_FUSED_SWEEPS = 8
# rb-GS spends two halo cells a sweep (pallas_kernels.MAX_FUSED_RBGS), and
# the fused error's extra Δ one more: ≤ 3 sweeps in an error pass
MAX_FUSED_RBGS = MAX_FUSED_SWEEPS // 2
MAX_CHAIN_LEVELS = 16       # MAX_CHAIN in chain_descend.cu / chain_ascend.cu
TRIGGER_BATCH = 7           # TRIG_BATCH in trigger_wave.cuh: a trigger pass's most sweeps
CHAIN_MAX_ROOT = 1025       # pallas_chain.CHAIN_MAX_ROOT
STREAM_BUDGET = 112 * 1024 * 1024   # pallas_chain.STREAM_VMEM_BUDGET
_ERR_CODES = {None: 0, "cpu": 1, "clean": 2, "gpu": 3}

launches = {"jacobi": 0, "jacobi_errs": 0, "rbgs": 0, "residual": 0, "residual_mw": 0,
            "descend": 0, "ascend": 0, "chain_descend": 0, "chain_ascend": 0,
            "trigger": 0, "trigger_stream": 0,
            # the 3-D kernels (ops.kernels3)
            "jacobi3": 0, "descend3": 0, "ascend3": 0, "residual3": 0, "jacobi3_errs": 0,
            "trigger3": 0, "trigger3_stream": 0, "residual_mw3": 0, "jacobi3_residual": 0,
            # the shard modes of the 3-D kernels (ops.kernels3)
            "jacobi3_shard": 0, "jacobi3_errs_shard": 0, "descend3_shard": 0,
            "ascend3_shard": 0, "residual3_shard": 0,
            # the shard modes of the 2-D kernels and the ring kernels (ops.rdma)
            "jacobi_shard": 0, "jacobi_errs_shard": 0, "rbgs_shard": 0, "residual_shard": 0,
            "descend_shard": 0, "ascend_shard": 0, "rdma_jacobi": 0, "rdma_trigger": 0,
            # the 3-D ring kernels (ops.rdma3)
            "rdma_jacobi3": 0, "rdma_descend3": 0, "rdma_ascend3": 0, "rdma_trigger3": 0,
            # the bf16 modes of kernels 1-4
            "jacobi_bf16": 0, "residual_bf16": 0, "descend_bf16": 0, "ascend_bf16": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def use_kernels(kernels: str, device: torch.device) -> bool:
    """Whether an engine on ``device`` runs the CUDA kernels: ``kernels`` is
    "auto" (on a CUDA device), "cuda" (required) or "torch" (never)."""
    if kernels == "torch":
        return False
    if kernels == "auto":
        return device.type == "cuda"
    if kernels == "cuda":
        if device.type != "cuda":
            raise ValueError(f"kernels='cuda' needs a CUDA device, got {device}")
        return True
    raise ValueError(f"unknown kernels {kernels!r}; expected auto, cuda or torch")


def err_mode_of(compat) -> str:
    """SolverConfig.compat_error → the fused error mode."""
    return "gpu" if compat == "gpu" else ("cpu" if compat else "clean")


def _err_scale(mode: str, n: int, h: float) -> float:
    # the kernels sum |r| (cpu, clean) or |Δu| (gpu); JAX's kernels sum
    # |Δ| = (ω/4)h²|r| and scale by 4/(ωh²) instead: the same metric
    if mode == "gpu":
        return 4.0 / (h * h) / (n * n)
    return (2.0 if mode == "cpu" else 1.0) / (n * n)


def shard_err_scale(mode: str, n: int, h: float, smoother: str = "jacobi") -> float:
    """The scale that turns a sum of raw shard partials (Σ|r|, or Σ|Δu| for
    gpu, or Σ|Δ| of the rb-GS kernel) into the metric the unsharded kernels
    report."""
    if smoother == "rbgs":
        return (2.0 if mode == "cpu" else 1.0) * 4.0 / (h * h) / (n * n)
    return _err_scale(mode, n, h)


def _zero_coef(h: float, omega: float) -> float:
    """The closed-form first sweep from u ≡ 0: u₁ = zero_coef · f."""
    return -0.25 * omega * h * h


def chain_fits(sizes) -> bool:
    """Whether a V-ladder runs as the two chain kernels: JAX's admission rule
    (``pallas_chain.chain_fits``), so a schedule reaches the same operations
    in both packages. At least one transition, a root of at most
    CHAIN_MAX_ROOT, every transition 2:1 (JAX's VMEM budget admits every
    such ladder)."""
    return (2 <= len(sizes) <= MAX_CHAIN_LEVELS + 1 and sizes[0] <= CHAIN_MAX_ROOT
            and all(a == 2 * b - 1 for a, b in zip(sizes, sizes[1:])))


def trigger_fits(n: int) -> bool:
    """Whether a trigger node runs as the whole-loop kernel: JAX's admission
    bound (``pallas_chain.trigger_fits``: five level-sized buffers in 96 MiB
    of VMEM, on the TPU's ×16-row / ×128-lane padded shape), kept so a
    schedule reaches the same operations; it admits n ≤ 2176."""
    rp, cp = -(-n // 16) * 16, -(-n // 128) * 128
    return 5 * rp * cp * 4 <= 96 * 1024 * 1024


def trigger_stream_fits(n: int) -> bool:
    """Whether a trigger node above ``trigger_fits`` runs as the streamed
    whole-loop kernel: JAX's admission bound (``pallas_chain.
    trigger_stream_fits``: the resident iterate plus the strip working set in
    112 MiB of VMEM, on the padded shape), kept so a schedule reaches the same
    operations; it admits n ≤ 4097."""
    rp, cp = -(-n // 16) * 16, -(-n // 128) * 128
    left = STREAM_BUDGET - (rp + 16 + 5 * 16) * cp * 4
    s = max(32, min((left // (8 * cp * 4)) // 16 * 16, 512))
    return ((rp + 16) * cp + 3 * s * cp + 5 * (s + 16) * cp) * 4 <= STREAM_BUDGET


def errs_sweep_cap(compat) -> int:
    """Sweeps per ``fused_jacobi_errs`` pass (JAX's trapezoid budget: the
    cpu and clean metrics read one more halo cell)."""
    return MAX_FUSED_SWEEPS if compat == "gpu" else MAX_FUSED_SWEEPS - 1


def _level_h(h0: float, k: int) -> float:
    """Spacing of level k of a 2:1 ladder (exactly GridSpec.h of that level)."""
    return h0 * 2 ** k


# --- plain PyTorch twins ------------------------------------------------------

def _from_zero_iterate(f: torch.Tensor, h: float, omega: float) -> torch.Tensor:
    u = torch.zeros_like(f)
    u[1:-1, 1:-1] = _zero_coef(h, omega) * f[1:-1, 1:-1]
    return u


def fused_jacobi_torch(u, f, h: float, steps: int, omega: float = 1.0,
                       from_zero: bool = False):
    """``steps`` Jacobi sweeps; ``from_zero``: u is known to be 0 (not read)."""
    if steps <= 0:
        return u
    if from_zero:
        u = _from_zero_iterate(f, h, omega)
        steps -= 1
    for _ in range(steps):
        u = stencils.jacobi_sweep(u, f, h, omega)
    return u


def fused_jacobi_err_torch(u, f, h: float, steps: int, omega: float = 1.0,
                           compat=True, from_zero: bool = False):
    """``steps`` sweeps and the smoothing error of the result: (u, err)."""
    if steps <= 0:
        return u, torch.zeros((), dtype=f.dtype, device=f.device)
    if compat == "gpu":
        if steps == 1:
            prev = torch.zeros_like(f) if from_zero else u
        else:
            prev = fused_jacobi_torch(u, f, h, steps - 1, omega, from_zero)
        new = fused_jacobi_torch(prev, f, h, 1, omega, from_zero and steps == 1)
        return new, stencils.gpu_smoothing_error(new, prev, h)
    u = fused_jacobi_torch(u, f, h, steps, omega, from_zero)
    return u, stencils.smoothing_error(u, f, h, compat=compat)


def fused_jacobi_errs_torch(u, f, h: float, steps: int, omega: float = 1.0, compat=True):
    """``steps`` sweeps and the error of every iterate: (u, errs), errs[s − 1]
    the error ``fused_jacobi_err_torch`` reports after s sweeps."""
    errs = []
    for _ in range(steps):
        prev, u = u, stencils.jacobi_sweep(u, f, h, omega)
        errs.append(stencils.gpu_smoothing_error(u, prev, h) if compat == "gpu"
                    else stencils.smoothing_error(u, f, h, compat=compat))
    return u, torch.stack(errs)


def fused_rbgs_torch(u, f, h: float, steps: int, from_zero: bool = False):
    """``steps`` red-black Gauss-Seidel sweeps; ``from_zero``: u is known to
    be 0 (not read; GS has no closed-form first sweep)."""
    if steps <= 0:
        return u
    if from_zero:
        u = torch.zeros_like(f)
    for _ in range(steps):
        u = stencils.redblack_gs_sweep(u, f, h)
    return u


def _rbgs_error(u, f, h: float, compat) -> torch.Tensor:
    """The rb-GS kernel's error: Σ|Δ| of one ω = 1 Jacobi step from u,
    Δ = ¼·((nb − 4u) − h²f) = (h²/4)·r, scaled by 4/h²/n² (×2 for cpu, over
    the even color only): the smoothing error in the TPU kernel's form."""
    n = u.shape[0]
    d = torch.abs(0.25 * (stencils._nb_sum(u) - 4.0 * u[1:-1, 1:-1]
                          - (h * h) * f[1:-1, 1:-1]))
    scale = 4.0 / (h * h) / (n * n)
    if compat:
        even, _ = stencils.interior_color_masks(n, u.dtype, u.device)
        return torch.sum(d * even) * (2.0 * scale)
    return torch.sum(d) * scale


def fused_rbgs_err_torch(u, f, h: float, steps: int, compat=True, from_zero: bool = False):
    """``steps`` rb-GS sweeps and the cpu or clean error of the result:
    (u, err). The gpu metric has no fused form (JAX's neither)."""
    if compat == "gpu":
        raise ValueError("the rb-GS kernel fuses the cpu and clean metrics only; the gpu "
                         "metric takes the two-call form")
    if steps <= 0:
        return u, torch.zeros((), dtype=f.dtype, device=f.device)
    u = fused_rbgs_torch(u, f, h, steps, from_zero)
    return u, _rbgs_error(u, f, h, compat)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _dd_chain(u):
    """(hi, lo, m) on the interior: hi + lo + m ≈ Σ4 neighbors − 4u, the
    error word itself compensated (refine._eft_stencil_sum_dd)."""
    uc = u[1:-1, 1:-1]
    hi, lo = _two_sum(u[:-2, 1:-1], u[2:, 1:-1])
    lo2 = torch.zeros_like(hi)
    for term in (u[1:-1, :-2], u[1:-1, 2:], -uc, -uc, -uc, -uc):
        hi, e = _two_sum(hi, term)
        lo, e2 = _two_sum(lo, e)
        lo2 = lo2 + e2
    hi, e = _two_sum(hi, lo)
    lo, e2 = _two_sum(e, lo2)
    return hi, lo, e2


def _split(a):
    """Veltkamp's split of fp32 values: a = hi + lo, each with ≤ 12 bits."""
    t = 4097.0 * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + e = a·b exactly, without an FMA (Dekker's product)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, (((ah * bh - p) + ah * bl) + al * bh) + al * bl


def residual_mw_torch(words, f, h: float):
    """Compensated residual of a 2- or 3-word fp32 state, 0 off the interior,
    in the arithmetic of ``_residual_mw_kernel`` (``refine.residual_tw_p``'s
    combination; with two words both get the dd chain). One term more: the
    rounding error of hi0·h⁻², exact by Dekker's product. It is 0 where
    h⁻² is a power of two (2^k + 1 grids), and elsewhere it is what keeps the
    residual exact near convergence (JAX's CPU runs get it from an FMA that
    XLA contracts; the TPU kernel has none)."""
    c = torch.tensor(1.0 / (h * h), dtype=f.dtype, device=f.device)
    hi0, lo0, m0 = _dd_chain(words[0])
    hi1, lo1, m1 = _dd_chain(words[1])
    if len(words) == 3:
        s2 = stencils._nb_sum(words[2]) - 4.0 * words[2][1:-1, 1:-1]
    else:
        s2 = torch.zeros_like(hi0)
    p, pe = _two_prod(hi0, c)
    r_big = (p - f[1:-1, 1:-1]) + pe
    t, tc = _two_sum(lo0, hi1)
    t2 = ((lo1 + m0) + (m1 + s2)) + tc
    r = torch.zeros_like(f)
    r[1:-1, 1:-1] = (r_big + t * c) + t2 * c
    return r


def residual_df_torch(u0, u1, f, h: float):
    return residual_mw_torch((u0, u1), f, h)


def residual_tw_torch(u0, u1, u2, f, h: float):
    return residual_mw_torch((u0, u1, u2), f, h)


def residual_torch(u, f, h: float, negate: bool = False):
    r = stencils.residual(u, f, h)
    return -r if negate else r


def fused_descend_torch(u, f, h: float, steps: int, omega: float = 1.0,
                        restriction: str = "sampling", compat=True,
                        want_err: bool = False, from_zero: bool = False):
    """Sweeps, residual, 2:1 restriction of −r: (u, f_coarse, err or None)."""
    m = (f.shape[0] + 1) // 2
    err = None
    if want_err:
        u, err = fused_jacobi_err_torch(u, f, h, steps, omega, compat, from_zero)
    else:
        u = fused_jacobi_torch(u, f, h, steps, omega, from_zero)
    d = -stencils.residual(u, f, h)
    if restriction == "full_weighting":
        return u, T.full_weighting_restrict(d, m), err
    return u, T.sample_restrict(d, m), err


def fused_ascend_torch(u, f, uc, h: float, steps: int, omega: float = 1.0,
                       compat=True, want_err: bool = False):
    """Prolong uc, add on the interior, post-sweeps: (u, err or None)."""
    u = T.add_correction(u, T.prolong(uc, f.shape[0]))
    if want_err:
        return fused_jacobi_err_torch(u, f, h, steps, omega, compat)
    return fused_jacobi_torch(u, f, h, steps, omega), None


def chain_descend_torch(u0, f0, sizes, h0: float, pre_steps, omega: float = 1.0,
                        restriction: str = "sampling", entry_from_zero: bool = False):
    """The descend legs of levels 0..c−1 in turn: (u_list, f_list), u_list[k]
    level k after its pre-sweeps, f_list[k] the right-hand side of level k+1."""
    u_list, f_list = [], []
    u, f = u0, f0
    for k, steps in enumerate(pre_steps):
        fz = entry_from_zero or k > 0
        u, f, _ = fused_descend_torch(torch.zeros_like(f) if fz else u, f, _level_h(h0, k),
                                      steps, omega, restriction, from_zero=fz)
        u_list.append(u)
        f_list.append(f)
    return u_list, f_list


def chain_ascend_torch(u_list, f_list, uc, sizes, h0: float, post_steps, omega: float = 1.0,
                       compat=True, want_err: bool = False):
    """The ascend legs of levels c−1..0 in turn from the coarse solution uc;
    f_list[k] is level k's right-hand side. Returns (u_0, level 0's error or
    None)."""
    child, err = uc, None
    for k in reversed(range(len(post_steps))):
        child, err = fused_ascend_torch(u_list[k], f_list[k], child, _level_h(h0, k),
                                        post_steps[k], omega, compat, want_err and k == 0)
    return child, err


def trigger_smooth_torch(u, f, h: float, omega: float = 1.0, compat=True,
                         trigger: float = 0.01, max_sweeps: int = 100_000):
    """Error-triggered smoothing, one fused sweep-plus-error step at a time
    with a host stop test per sweep: (u, err, sweeps)."""
    from ..solver import trigger_loop

    u, err, sweeps = trigger_loop(
        lambda v: fused_jacobi_err_torch(v, f, h, 1, omega, compat), u, trigger, max_sweeps)
    return u, err, torch.tensor(sweeps, dtype=torch.int32, device=f.device)


# --- CUDA launches ---------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} here, got {t.dtype}"
                        + ("" if dtype != torch.float32 else
                           " (bfloat16 only on kernels 1-4, ROADMAP Queue 2 A2)"))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _grid_args(f: torch.Tensor, aligned: bool = False, bf16: bool = False):
    """Validate the level's f and return (n, device, library, stream).
    ``bf16``: the entry point has a bf16 mode (kernels 1-4), so f may be
    bfloat16 too; the caller checks the other grids against f's dtype."""
    from . import build

    if not f.is_cuda:
        raise ValueError(f"CUDA kernel called on a {f.device} tensor")
    n = f.shape[0]
    if f.dim() != 2 or f.shape[1] != n or n < 3 or (aligned and n % 2 == 0):
        raise ValueError(f"expected an (n, n) level with n >= 3"
                         f"{' odd (2:1-aligned)' if aligned else ''}, got {tuple(f.shape)}")
    _check("f", f, (n, n), f.device,
           f.dtype if bf16 and f.dtype == torch.bfloat16 else torch.float32)
    if f.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {f.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return n, f.device, build.load(), torch.cuda.current_stream(f.device).cuda_stream


def _check_steps(steps: int) -> None:
    if not 1 <= steps <= MAX_FUSED_SWEEPS:
        raise ValueError(f"a fused leg runs 1..{MAX_FUSED_SWEEPS} sweeps, got {steps}")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel failed: CUDA error {rc} "
                           f"({lib.mg_error_string(rc).decode()})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(t):
    """t, or a copy of it where it does not start 16-byte aligned (a view at
    an offset): the wavefront (kernel 1's Jacobi and rb-GS modes, the legs
    of kernels 3 and 4, the ring trigger kernel 17) copies rows of u and f
    in 16-byte chunks."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


@contextlib.contextmanager
def forced_chunk_rows(rows: int):
    """The wavefront's launches (kernel 1's Jacobi modes and the legs of
    kernels 3 and 4, whole grid and shard mode) with chunks of ``rows``
    owned rows, a multiple of 32, instead of the ones ``csrc/wave2.cuh``'s
    occupancy rule picks, which are one tile row at small sizes: lets a
    check reach chunks of several tile rows on small grids. The iterate,
    the coarse right-hand side and the errors do not depend on the chunks."""
    from . import build

    lib = build.load()
    _raise_on(lib, lib.mg_wave2_force_rows(rows), "wave2 chunk rows")
    try:
        yield
    finally:
        lib.mg_wave2_force_rows(0)


_LEG_ROUTES = {"tile": 1, "wave": 2}


@contextlib.contextmanager
def forced_leg_route(route: str):
    """The legs' launches (kernels 3 and 4, whole grid and shard mode) on
    one route, ``"tile"`` (legs.cuh's tile kernel) or ``"wave"`` (the
    wavefront), instead of the one the legs' size rule picks
    (``legs_take_wave`` in ``csrc/wave2.cuh``): lets a check or a timing
    reach both at any size. Both are bit for bit the plain twins'."""
    from . import build

    lib = build.load()
    _raise_on(lib, lib.mg_legs_force_route(_LEG_ROUTES[route]), "legs route")
    try:
        yield
    finally:
        lib.mg_legs_force_route(0)


@contextlib.contextmanager
def forced_chain_split(split: int):
    """The chains' launches (kernels 6 and 7) with the levels n <= ``split``
    in the cluster tail (0: every level on the wide tile launch) instead of
    the rule's (``CHAIN_SPLIT`` in csrc/chain_tail.cuh): lets a check or a
    timing reach every split. A split whose tail does not fit the cluster
    makes the chains raise."""
    from . import build

    lib = build.load()
    _raise_on(lib, lib.mg_chain_force_split(split), "chain split")
    try:
        yield
    finally:
        lib.mg_chain_force_split(-1)


_TRIGGER_ROUTES = {"cluster": 1, "tile": 2, "wave": 3}


@contextlib.contextmanager
def forced_trigger_route(route: str):
    """``trigger_smooth``'s launches (kernel 8) on one route, ``"cluster"``
    (one thread block cluster, levels up to 257²), ``"tile"`` (the tile
    loop) or ``"wave"`` (the wavefront passes), instead of the one its size
    rule picks (``csrc/trigger.cu``): lets a check or a timing reach every
    route at every size it takes. All are bit for bit the loop of one-sweep
    kernel 1 launches; a level above 257² sent to the cluster raises."""
    from . import build

    lib = build.load()
    _raise_on(lib, lib.mg_trigger_force_route(_TRIGGER_ROUTES[route]), "trigger route")
    try:
        yield
    finally:
        lib.mg_trigger_force_route(0)


@contextlib.contextmanager
def forced_trigger_batch(batch: int):
    """The wavefront trigger passes (kernel 8's wavefront route and kernel 9)
    of exactly ``batch`` sweeps, 1..TRIGGER_BATCH, instead of next_sweeps'
    lengths (2, 1, then the slopes' prediction): lets a check reach stops
    inside long passes. Results do not depend on the passes' lengths."""
    from . import build

    lib = build.load()
    _raise_on(lib, lib.mg_trigger_force_batch(batch), "trigger batch")
    try:
        yield
    finally:
        lib.mg_trigger_force_batch(0)


def _err_buffers(lib, mode, n: int, device, dtype=torch.float32):
    """(per-tile float partials, the 1-element metric in the state's dtype),
    or Nones without an error."""
    if mode is None:
        return None, None
    return (torch.empty(lib.mg_num_tiles(n), dtype=torch.float32, device=device),
            torch.empty(1, dtype=dtype, device=device))


def _mode(name: str, f: torch.Tensor, lib):
    """(the C entry point of kernel ``name`` for f's dtype, its launch
    count's key): the fp32 one, or its bf16 mode (``mg_<name>_bf16``)."""
    key = name + ("_bf16" if f.dtype == torch.bfloat16 else "")
    return getattr(lib, "mg_" + key), key


def _jacobi_cuda(u, f, h: float, steps: int, omega: float, from_zero: bool, mode):
    """One ≤8-sweep launch; returns (u, err or None)."""
    n, dev, lib, stream = _grid_args(f, bf16=True)
    if not from_zero:
        _check("u", u, (n, n), dev, f.dtype)
    out = torch.empty_like(f)
    partials, err = _err_buffers(lib, mode, n, dev, f.dtype)
    u, f = _aligned(None if from_zero else u), _aligned(f)
    fn, key = _mode("jacobi", f, lib)
    rc = fn(_ptr(u), f.data_ptr(), out.data_ptr(),
            _ptr(partials), _ptr(err), n, steps, int(from_zero),
            _ERR_CODES[mode], h * h, omega, 1.0 / (h * h), _zero_coef(h, omega),
            _err_scale(mode, n, h) if mode else 0.0, stream)
    _raise_on(lib, rc, key)
    launches[key] += 1
    return out, (None if err is None else err.reshape(()))


def _chunked(u, f, h: float, steps: int, omega: float, from_zero: bool, mode):
    """``steps`` sweeps as ≤8-sweep launches; the error rides on the last."""
    err = None
    first = True
    while steps > 0:
        k = min(steps, MAX_FUSED_SWEEPS)
        steps -= k
        u, err = _jacobi_cuda(u, f, h, k, omega, from_zero and first,
                              mode if steps == 0 else None)
        first = False
    return u, err


# --- public entry points ------------------------------------------------------

def fused_jacobi(u, f, h: float, steps: int, omega: float = 1.0,
                 from_zero: bool = False):
    """``steps`` damped-Jacobi sweeps, ≤8 per pass over memory (counterpart of
    ``fused_jacobi_padded``). ``from_zero``: the caller guarantees u ≡ 0."""
    if not f.is_cuda:
        return fused_jacobi_torch(u, f, h, steps, omega, from_zero)
    if steps <= 0:
        return u
    return _chunked(u, f, h, steps, omega, from_zero, None)[0]


def fused_jacobi_err(u, f, h: float, steps: int, omega: float = 1.0, compat=True,
                     from_zero: bool = False):
    """``steps`` sweeps with the smoothing-error metric fused into the last
    pass (counterpart of ``fused_jacobi_err_padded``): (u, err)."""
    if not f.is_cuda:
        return fused_jacobi_err_torch(u, f, h, steps, omega, compat, from_zero)
    if steps <= 0:
        return u, torch.zeros((), dtype=f.dtype, device=f.device)
    return _chunked(u, f, h, steps, omega, from_zero, err_mode_of(compat))


def residual(u, f, h: float, negate: bool = False):
    """5-point residual, 0 off the interior, optionally negated (counterpart
    of ``residual_pallas``)."""
    if not f.is_cuda:
        return residual_torch(u, f, h, negate)
    n, dev, lib, stream = _grid_args(f, bf16=True)
    _check("u", u, (n, n), dev, f.dtype)
    r = torch.empty_like(f)
    fn, key = _mode("residual", f, lib)
    rc = fn(u.data_ptr(), f.data_ptr(), r.data_ptr(), n, 1.0 / (h * h), int(negate), stream)
    _raise_on(lib, rc, key)
    launches[key] += 1
    return r


def fused_descend(u, f, h: float, steps: int, omega: float = 1.0,
                  restriction: str = "sampling", compat=True, want_err: bool = False,
                  from_zero: bool = False):
    """The descend leg on an aligned level n = 2m − 1: ``steps`` sweeps, the
    residual, and its 2:1 restriction (sampling or full weighting) of −r in
    one pass (counterpart of ``fused_descend_padded`` + ``restrict_lanes_p``).
    Returns (u, f_coarse (m, m), err or None)."""
    if restriction not in ("sampling", "full_weighting"):
        raise ValueError(f"unknown restriction {restriction!r}")
    if not f.is_cuda:
        return fused_descend_torch(u, f, h, steps, omega, restriction, compat,
                                   want_err, from_zero)
    _check_steps(steps)
    n, dev, lib, stream = _grid_args(f, aligned=True, bf16=True)
    if not from_zero:
        _check("u", u, (n, n), dev, f.dtype)
    m = (n + 1) // 2
    out = torch.empty_like(f)
    fc = torch.empty((m, m), dtype=f.dtype, device=dev)
    mode = err_mode_of(compat) if want_err else None
    partials, err = _err_buffers(lib, mode, n, dev, f.dtype)
    u, f = _aligned(None if from_zero else u), _aligned(f)
    fn, key = _mode("descend", f, lib)
    rc = fn(_ptr(u), f.data_ptr(), out.data_ptr(),
            fc.data_ptr(), _ptr(partials), _ptr(err), n, steps, int(from_zero),
            int(restriction == "full_weighting"), _ERR_CODES[mode], h * h, omega,
            1.0 / (h * h), _zero_coef(h, omega),
            _err_scale(mode, n, h) if mode else 0.0, stream)
    _raise_on(lib, rc, key)
    launches[key] += 1
    return out, fc, (None if err is None else err.reshape(()))


def fused_ascend(u, f, uc, h: float, steps: int, omega: float = 1.0, compat=True,
                 want_err: bool = False):
    """The ascend leg on an aligned level n = 2m − 1: prolong the coarse
    (m, m) correction ``uc``, add it on the interior, ``steps`` post-sweeps,
    in one pass (counterpart of ``prolong_lanes_p`` + ``fused_ascend_padded``).
    Returns (u, err or None)."""
    if not f.is_cuda:
        return fused_ascend_torch(u, f, uc, h, steps, omega, compat, want_err)
    _check_steps(steps)
    n, dev, lib, stream = _grid_args(f, aligned=True, bf16=True)
    m = (n + 1) // 2
    _check("u", u, (n, n), dev, f.dtype)
    _check("uc", uc, (m, m), dev, f.dtype)
    out = torch.empty_like(f)
    mode = err_mode_of(compat) if want_err else None
    partials, err = _err_buffers(lib, mode, n, dev, f.dtype)
    # the bf16 mode copies the coarse rows in 16-byte chunks too
    u, f = _aligned(u), _aligned(f)
    if f.dtype == torch.bfloat16:
        uc = _aligned(uc)
    fn, key = _mode("ascend", f, lib)
    rc = fn(u.data_ptr(), f.data_ptr(), uc.data_ptr(), out.data_ptr(),
            _ptr(partials), _ptr(err), n, steps, _ERR_CODES[mode], h * h, omega,
            1.0 / (h * h), _err_scale(mode, n, h) if mode else 0.0, stream)
    _raise_on(lib, rc, key)
    launches[key] += 1
    return out, (None if err is None else err.reshape(()))


def _c_array(ctype, values):
    return (ctype * len(values))(*values)


def _check_ladder(sizes, steps, lo: int, what: str):
    c = len(sizes) - 1
    if not 1 <= c <= MAX_CHAIN_LEVELS or len(steps) != c:
        raise ValueError(f"{what}: expected 1..{MAX_CHAIN_LEVELS} transitions and one "
                         f"sweep count per level, got sizes {sizes}, steps {steps}")
    if any(a != 2 * b - 1 for a, b in zip(sizes, sizes[1:])):
        raise ValueError(f"{what}: every transition must be 2:1 (n = 2m − 1), got {sizes}")
    if not all(lo <= s <= MAX_FUSED_SWEEPS for s in steps):
        raise ValueError(f"{what}: sweep counts must lie in {lo}..{MAX_FUSED_SWEEPS}, "
                         f"got {steps}")


def _level_scalars(h0: float, omega: float, levels: int):
    """(h², 1/h², −(ω/4)h²) per level, as the one-level launches pass them."""
    out = []
    for k in range(levels):
        h = _level_h(h0, k)
        out += [h * h, 1.0 / (h * h), _zero_coef(h, omega)]
    return _c_array(ctypes.c_float, out)


def chain_descend(u0, f0, sizes, h0: float, pre_steps, omega: float = 1.0,
                  restriction: str = "sampling", entry_from_zero: bool = False):
    """The whole descend half of a V below ``sizes[0]`` in one call, the wide
    launch then the cluster tail (``csrc/chain_tail.cuh``; counterpart of
    ``fused_chain_descend``): per level k < c the pre-sweeps,
    the residual and its restriction. Returns (u_list, f_list) as the twin.
    ``entry_from_zero``: the caller guarantees u0 ≡ 0 (u0 may be None)."""
    sizes, pre_steps = tuple(sizes), tuple(pre_steps)
    if restriction not in ("sampling", "full_weighting"):
        raise ValueError(f"unknown restriction {restriction!r}")
    _check_ladder(sizes, pre_steps, 1, "chain_descend")
    if not f0.is_cuda:
        return chain_descend_torch(u0, f0, sizes, h0, pre_steps, omega, restriction,
                                   entry_from_zero)
    n, dev, lib, stream = _grid_args(f0, aligned=True)
    if n != sizes[0]:
        raise ValueError(f"chain_descend: f0 is {n}², the ladder starts at {sizes[0]}")
    if not entry_from_zero:
        _check("u0", u0, (n, n), dev)
    c = len(sizes) - 1
    u_list = [torch.empty((s, s), dtype=f0.dtype, device=dev) for s in sizes[:-1]]
    f_list = [torch.empty((s, s), dtype=f0.dtype, device=dev) for s in sizes[1:]]
    rc = lib.mg_chain_descend(
        _ptr(None if entry_from_zero else u0),
        _c_array(ctypes.c_uint64, [t.data_ptr() for t in [f0, *f_list]]),
        _c_array(ctypes.c_uint64, [t.data_ptr() for t in u_list]),
        _c_array(ctypes.c_int, sizes), _c_array(ctypes.c_int, pre_steps),
        _level_scalars(h0, omega, c), c, int(entry_from_zero),
        int(restriction == "full_weighting"), omega, stream)
    _raise_on(lib, rc, "chain_descend")
    launches["chain_descend"] += lib.mg_chain_launched()
    return u_list, f_list


def chain_ascend(u_list, f_list, uc, sizes, h0: float, post_steps, omega: float = 1.0,
                 compat=True, want_err: bool = False):
    """The whole ascend half of a V up to ``sizes[0]`` in one call, the
    cluster tail then the wide launch (``csrc/chain_tail.cuh``; counterpart of
    ``fused_chain_ascend``): from the coarse solution uc, per
    level k = c−1..0 the prolongation, the interior add and the post-sweeps.
    ``u_list`` is chain_descend's, ``f_list[k]`` level k's right-hand side.
    Returns (u_0, level 0's error or None)."""
    sizes, post_steps = tuple(sizes), tuple(post_steps)
    _check_ladder(sizes, post_steps, 0, "chain_ascend")
    if want_err and post_steps[0] < 1:
        raise ValueError("chain_ascend: the error needs at least one sweep on level 0")
    if not uc.is_cuda:
        return chain_ascend_torch(u_list, f_list, uc, sizes, h0, post_steps, omega, compat,
                                  want_err)
    c = len(sizes) - 1
    n, dev, lib, stream = _grid_args(f_list[0], aligned=True)
    if len(u_list) != c or len(f_list) != c:
        raise ValueError(f"chain_ascend: expected {c} levels of u and f")
    for k in range(c):
        _check(f"u_list[{k}]", u_list[k], (sizes[k], sizes[k]), dev)
        _check(f"f_list[{k}]", f_list[k], (sizes[k], sizes[k]), dev)
    _check("uc", uc, (sizes[-1], sizes[-1]), dev)
    outs = [torch.empty((s, s), dtype=uc.dtype, device=dev) for s in sizes[:-1]]
    mode = err_mode_of(compat) if want_err else None
    partials, err = _err_buffers(lib, mode, n, dev)
    rc = lib.mg_chain_ascend(
        uc.data_ptr(), _c_array(ctypes.c_uint64, [t.data_ptr() for t in u_list]),
        _c_array(ctypes.c_uint64, [t.data_ptr() for t in f_list]),
        _c_array(ctypes.c_uint64, [t.data_ptr() for t in outs]),
        _c_array(ctypes.c_int, sizes), _c_array(ctypes.c_int, post_steps),
        _level_scalars(h0, omega, c), c, _ERR_CODES[mode], omega, _ptr(partials), _ptr(err),
        _err_scale(mode, n, h0) if mode else 0.0, stream)
    _raise_on(lib, rc, "chain_ascend")
    launches["chain_ascend"] += lib.mg_chain_launched()
    return outs[0], (None if err is None else err.reshape(()))


def _trigger_buffers(lib, n: int, device):
    """(out, tmp, partials, err, sweeps) of a whole-loop trigger launch:
    the partials of two passes of up to TRIGGER_BATCH sweeps
    (``csrc/trigger_wave.cuh``)."""
    part = 2 * TRIGGER_BATCH * lib.mg_num_tiles(n)
    return (torch.empty(n, n, dtype=torch.float32, device=device),
            torch.empty(n, n, dtype=torch.float32, device=device),
            torch.empty(part, dtype=torch.float32, device=device),
            torch.empty(1, dtype=torch.float32, device=device),
            torch.empty(1, dtype=torch.int32, device=device))


def _check_max_sweeps(max_sweeps: int) -> None:
    if not 1 <= max_sweeps < 2 ** 31:
        raise ValueError(f"max_sweeps must lie in 1..2**31 − 1, got {max_sweeps}")


def trigger_smooth(u, f, h: float, omega: float = 1.0, compat=True, trigger: float = 0.01,
                   max_sweeps: int = 100_000):
    """Error-triggered smoothing with the whole loop in one launch
    (counterpart of ``fused_trigger_vmem``): one sweep at a time while
    |err_k − err_{k−1}| > trigger, at most ``max_sweeps``. Levels up to
    257² run in one thread block cluster, those below 1.5 M cells as a
    sweep-at-a-time tile loop, larger ones as ``trigger_smooth_stream``'s
    passes (``csrc/trigger.cu``; ``forced_trigger_route`` overrides the
    rule). Returns (u, err, sweeps), ``sweeps`` a 0-d int32 tensor; nothing
    is read back to the host."""
    if not f.is_cuda:
        return trigger_smooth_torch(u, f, h, omega, compat, trigger, max_sweeps)
    _check_max_sweeps(max_sweeps)
    n, dev, lib, stream = _grid_args(f)
    _check("u", u, (n, n), dev)
    mode = err_mode_of(compat)
    out, tmp, partials, err, sweeps = _trigger_buffers(lib, n, dev)
    u, f = _aligned(u), _aligned(f)
    rc = lib.mg_trigger(u.data_ptr(), f.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                        partials.data_ptr(), err.data_ptr(), sweeps.data_ptr(), n,
                        _ERR_CODES[mode], h * h, omega, 1.0 / (h * h), _err_scale(mode, n, h),
                        trigger, max_sweeps, stream)
    _raise_on(lib, rc, "trigger")
    launches["trigger"] += 1
    return out, err.reshape(()), sweeps.reshape(())


def trigger_smooth_stream(u, f, h: float, omega: float = 1.0, compat=True,
                          trigger: float = 0.01, max_sweeps: int = 100_000):
    """The same loop for levels too large for ``trigger_smooth`` to stay in
    L2 (counterpart of ``fused_trigger_stream``): wavefront passes of up to
    ``TRIGGER_BATCH`` sweeps with an exact replay of the stop rule, so the
    iterate, the stop sweep and the error are the sweep-at-a-time loop's.
    Returns (u, err, sweeps) as ``trigger_smooth``."""
    if not f.is_cuda:
        return trigger_smooth_torch(u, f, h, omega, compat, trigger, max_sweeps)
    _check_max_sweeps(max_sweeps)
    n, dev, lib, stream = _grid_args(f)
    _check("u", u, (n, n), dev)
    mode = err_mode_of(compat)
    out, tmp, partials, err, sweeps = _trigger_buffers(lib, n, dev)
    u, f = _aligned(u), _aligned(f)
    rc = lib.mg_trigger_stream(u.data_ptr(), f.data_ptr(), out.data_ptr(), tmp.data_ptr(),
                               partials.data_ptr(), err.data_ptr(), sweeps.data_ptr(), n,
                               _ERR_CODES[mode], errs_sweep_cap(compat), h * h, omega,
                               1.0 / (h * h), _err_scale(mode, n, h), trigger, max_sweeps,
                               stream)
    _raise_on(lib, rc, "trigger_stream")
    launches["trigger_stream"] += 1
    return out, err.reshape(()), sweeps.reshape(())


def fused_jacobi_errs(u, f, h: float, steps: int, omega: float = 1.0, compat=True):
    """``steps`` ≤ ``errs_sweep_cap(compat)`` sweeps in one pass with the
    error of every iterate (counterpart of ``fused_jacobi_errs_padded``):
    (u, errs), errs[s − 1] the error ``fused_jacobi_err`` reports after s
    sweeps."""
    if not 1 <= steps <= errs_sweep_cap(compat):
        raise ValueError(f"a per-sweep error pass runs 1..{errs_sweep_cap(compat)} sweeps "
                         f"with compat={compat!r}, got {steps}")
    if not f.is_cuda:
        return fused_jacobi_errs_torch(u, f, h, steps, omega, compat)
    n, dev, lib, stream = _grid_args(f)
    _check("u", u, (n, n), dev)
    mode = err_mode_of(compat)
    out = torch.empty_like(f)
    partials = torch.empty(steps * lib.mg_num_tiles(n), dtype=torch.float32, device=dev)
    errs = torch.empty(steps, dtype=torch.float32, device=dev)
    u, f = _aligned(u), _aligned(f)
    rc = lib.mg_jacobi_errs(u.data_ptr(), f.data_ptr(), out.data_ptr(), partials.data_ptr(),
                            errs.data_ptr(), n, steps, _ERR_CODES[mode], h * h, omega,
                            1.0 / (h * h), _err_scale(mode, n, h), stream)
    _raise_on(lib, rc, "jacobi_errs")
    launches["jacobi_errs"] += 1
    return out, errs


def _rbgs_cuda(u, f, h: float, steps: int, from_zero: bool, mode):
    """One ≤4-sweep rb-GS launch (≤3 with an error); returns (u, err or None)."""
    n, dev, lib, stream = _grid_args(f)
    if not from_zero:
        _check("u", u, (n, n), dev)
    out = torch.empty_like(f)
    partials, err = _err_buffers(lib, mode, n, dev)
    scale = (2.0 if mode == "cpu" else 1.0) * 4.0 / (h * h) / (n * n)
    u, f = _aligned(None if from_zero else u), _aligned(f)
    rc = lib.mg_rbgs(_ptr(u), f.data_ptr(), out.data_ptr(),
                     _ptr(partials), _ptr(err), n, steps, int(from_zero), _ERR_CODES[mode],
                     h * h, scale if mode else 0.0, stream)
    _raise_on(lib, rc, "rbgs")
    launches["rbgs"] += 1
    return out, (None if err is None else err.reshape(()))


def fused_rbgs(u, f, h: float, steps: int, from_zero: bool = False):
    """``steps`` red-black Gauss-Seidel sweeps, ≤4 per pass over memory
    (counterpart of ``fused_rbgs_padded``). ``from_zero``: the caller
    guarantees u ≡ 0, and the first pass does not read it."""
    if not f.is_cuda:
        return fused_rbgs_torch(u, f, h, steps, from_zero)
    first = True
    while steps > 0:
        k = min(steps, MAX_FUSED_RBGS)
        steps -= k
        u, _ = _rbgs_cuda(u, f, h, k, from_zero and first, None)
        first = False
    return u


def fused_rbgs_err(u, f, h: float, steps: int, compat=True, from_zero: bool = False):
    """``steps`` rb-GS sweeps with the cpu or clean error fused into the last
    pass (counterpart of ``fused_rbgs_err_padded``): (u, err)."""
    if not f.is_cuda or compat == "gpu":   # the twin refuses the gpu metric
        return fused_rbgs_err_torch(u, f, h, steps, compat, from_zero)
    if steps <= 0:
        return u, torch.zeros((), dtype=f.dtype, device=f.device)
    last = min(steps, (MAX_FUSED_SWEEPS - 1) // 2)
    if steps > last:
        u = fused_rbgs(u, f, h, steps - last, from_zero)
        from_zero = False
    return _rbgs_cuda(u, f, h, last, from_zero, err_mode_of(compat))


def _residual_mw_cuda(words, f, h: float):
    n, dev, lib, stream = _grid_args(f)
    for k, w in enumerate(words):
        _check(f"u{k}", w, (n, n), dev)
    r = torch.empty_like(f)
    rc = lib.mg_residual_mw(words[0].data_ptr(), words[1].data_ptr(),
                            _ptr(words[2] if len(words) == 3 else None), f.data_ptr(),
                            r.data_ptr(), n, len(words), 1.0 / (h * h), stream)
    _raise_on(lib, rc, "residual_mw")
    launches["residual_mw"] += 1
    return r


def residual_df(u0, u1, f, h: float):
    """Compensated residual of the double-word state (u0, u1), 0 off the
    interior (counterpart of ``residual_df_pallas``)."""
    if not f.is_cuda:
        return residual_df_torch(u0, u1, f, h)
    return _residual_mw_cuda((u0, u1), f, h)


def residual_tw(u0, u1, u2, f, h: float):
    """Compensated residual of the triple-word state (u0, u1, u2), 0 off the
    interior (counterpart of ``residual_tw_pallas``)."""
    if not f.is_cuda:
        return residual_tw_torch(u0, u1, u2, f, h)
    return _residual_mw_cuda((u0, u1, u2), f, h)


# --- shard mode ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardGeo:
    """One shard's block of an n x n level: rows [row0, row0 + rows) x
    columns [col0, col0 + cols), whose input windows carry ``ext_r`` halo
    rows and ``ext_c`` halo columns per side (zero outside the grid). The
    whole grid is ``ShardGeo(n, 0, 0, n, n)``."""

    n: int
    row0: int
    col0: int
    rows: int
    cols: int
    ext_r: int = 0
    ext_c: int = 0

    @property
    def ext_shape(self) -> tuple[int, int]:
        return self.rows + 2 * self.ext_r, self.cols + 2 * self.ext_c

    def owned(self, x: torch.Tensor) -> torch.Tensor:
        """The owned block of a window-shaped tensor."""
        return x[self.ext_r:self.ext_r + self.rows, self.ext_c:self.ext_c + self.cols]

    def coords(self, device):
        """Global row and column indices of the window's cells."""
        gi = torch.arange(self.row0 - self.ext_r, self.row0 + self.rows + self.ext_r,
                          device=device)
        gj = torch.arange(self.col0 - self.ext_c, self.col0 + self.cols + self.ext_c,
                          device=device)
        return gi, gj

    def interior(self, device) -> torch.Tensor:
        """The window's cells on the grid's interior (1..n − 2 both ways)."""
        gi, gj = self.coords(device)
        n = self.n
        return ((gi >= 1) & (gi <= n - 2))[:, None] & ((gj >= 1) & (gj <= n - 2))[None, :]

    def owned_mask(self, device) -> torch.Tensor:
        rows = torch.zeros(self.ext_shape[0], dtype=torch.bool, device=device)
        cols = torch.zeros(self.ext_shape[1], dtype=torch.bool, device=device)
        rows[self.ext_r:self.ext_r + self.rows] = True
        cols[self.ext_c:self.ext_c + self.cols] = True
        return rows[:, None] & cols[None, :]

    def even(self, device) -> torch.Tensor:
        """The window's cells of the even color, (i + j) even globally."""
        gi, gj = self.coords(device)
        return (gi[:, None] + gj[None, :]) % 2 == 0


def _inner(x):
    return x[1:-1, 1:-1]


def _sweep_ext(u, f, inside, h: float, omega: float):
    """stencils.jacobi_sweep on a window, frozen where ``inside`` is False."""
    incr = 0.25 * (stencils._nb_sum(u) - 4.0 * _inner(u) - (h * h) * _inner(f))
    out = u.clone()
    out[1:-1, 1:-1] = torch.where(_inner(inside), _inner(u) + omega * incr, _inner(u))
    return out


def _residual_ext(u, f, inside, h: float):
    """stencils.residual on a window, 0 where ``inside`` is False."""
    inv_h2 = 1.0 / (h * h)
    r = torch.zeros_like(u)
    r[1:-1, 1:-1] = torch.where(_inner(inside),
                                inv_h2 * (stencils._nb_sum(u) - 4.0 * _inner(u)) - _inner(f),
                                torch.zeros((), dtype=u.dtype, device=u.device))
    return r


def _raw_partial(vals, geo: ShardGeo, inside, mode):
    """Σ vals over the owned interior cells (the even color for cpu)."""
    take = inside & geo.owned_mask(vals.device)
    if mode == "cpu":
        take = take & geo.even(vals.device)
    return torch.sum(torch.where(take, vals, torch.zeros((), dtype=vals.dtype,
                                                         device=vals.device)))


def _raw_error(fin, prev, f, geo: ShardGeo, inside, h: float, mode: str):
    """The shard's raw error partial: Σ|fin − prev| (gpu; prev None is the
    zero iterate) or Σ|r(fin)| (cpu, clean) over its owned interior."""
    if mode == "gpu":
        return _raw_partial(torch.abs(fin if prev is None else fin - prev), geo, inside, mode)
    return _raw_partial(torch.abs(_residual_ext(fin, f, inside, h)), geo, inside, mode)


def _rbgs_half_ext(u, f, take, h: float):
    val = 0.25 * (stencils._nb_sum(u) - (h * h) * _inner(f))
    out = u.clone()
    out[1:-1, 1:-1] = torch.where(_inner(take), val, _inner(u))
    return out


def _rbgs_delta_ext(u, f, h: float):
    """|Δ| of one ω = 1 Jacobi step from u on a window (the rb-GS error)."""
    d = torch.zeros_like(u)
    d[1:-1, 1:-1] = torch.abs(0.25 * (stencils._nb_sum(u) - 4.0 * _inner(u)
                                      - (h * h) * _inner(f)))
    return d


def _jacobi_window(u_ext, f_ext, inside, h: float, steps: int, omega: float, from_zero: bool):
    """``steps`` sweeps on a window (the first the closed form when
    ``from_zero``): (iterate, the one before it or None for the zero one)."""
    prev = u_ext
    if from_zero:
        prev = None
        u = torch.where(inside, _zero_coef(h, omega) * f_ext,
                        torch.zeros((), dtype=f_ext.dtype, device=f_ext.device))
        steps -= 1
    else:
        u = u_ext
    for _ in range(steps):
        prev, u = u, _sweep_ext(u, f_ext, inside, h, omega)
    return u, prev


def fused_jacobi_shard_torch(u_ext, f_ext, geo: ShardGeo, h: float, steps: int,
                             omega: float = 1.0, from_zero: bool = False, err_mode=None,
                             smoother: str = "jacobi"):
    """Twin of ``fused_jacobi_shard``: (owned block, raw error partial or None)."""
    inside = geo.interior(f_ext.device)
    if smoother == "rbgs":
        u = torch.zeros_like(f_ext) if from_zero else u_ext
        even = geo.even(f_ext.device)
        for _ in range(steps):
            u = _rbgs_half_ext(u, f_ext, inside & even, h)
            u = _rbgs_half_ext(u, f_ext, inside & ~even, h)
        raw = None
        if err_mode is not None:
            raw = _raw_partial(_rbgs_delta_ext(u, f_ext, h), geo, inside, err_mode)
        return geo.owned(u).contiguous(), raw
    u, prev = _jacobi_window(u_ext, f_ext, inside, h, steps, omega, from_zero)
    raw = None if err_mode is None else _raw_error(u, prev, f_ext, geo, inside, h, err_mode)
    return geo.owned(u).contiguous(), raw


def fused_jacobi_errs_shard_torch(u_ext, f_ext, geo: ShardGeo, h: float, steps: int,
                                  omega: float = 1.0, err_mode: str = "cpu"):
    """Twin of ``fused_jacobi_errs_shard``: (owned block, raw partial of every
    iterate)."""
    inside = geo.interior(f_ext.device)
    u, raws = u_ext, []
    for _ in range(steps):
        prev, u = u, _sweep_ext(u, f_ext, inside, h, omega)
        raws.append(_raw_error(u, prev, f_ext, geo, inside, h, err_mode))
    return geo.owned(u).contiguous(), torch.stack(raws)


def residual_shard_torch(u_ext, f_ext, geo: ShardGeo, h: float, negate: bool = False):
    """Twin of ``residual_shard``: the owned block of the residual."""
    r = geo.owned(_residual_ext(u_ext, f_ext, geo.interior(f_ext.device), h)).contiguous()
    return -r if negate else r


def _coarse_block(geo: ShardGeo):
    """(row0, col0, rows, cols) of the coarse points of an even-origin block."""
    return geo.row0 // 2, geo.col0 // 2, (geo.rows + 1) // 2, (geo.cols + 1) // 2


def fused_descend_shard_torch(u_ext, f_ext, geo: ShardGeo, h: float, steps: int,
                              omega: float = 1.0, restriction: str = "sampling", err_mode=None,
                              from_zero: bool = False):
    """Twin of ``fused_descend_shard``: (owned block, the block's coarse
    right-hand side, raw error partial or None)."""
    inside = geo.interior(f_ext.device)
    u, prev = _jacobi_window(u_ext, f_ext, inside, h, steps, omega, from_zero)
    raw = None if err_mode is None else _raw_error(u, prev, f_ext, geo, inside, h, err_mode)
    # −r with a zero ring, so the restriction's outer taps stay in range
    d = torch.nn.functional.pad(-_residual_ext(u, f_ext, inside, h), (1, 1, 1, 1))
    cr0, cc0, crows, ccols = _coarse_block(geo)
    rr = geo.ext_r + 1 + 2 * torch.arange(crows, device=d.device)
    cc = geo.ext_c + 1 + 2 * torch.arange(ccols, device=d.device)
    if restriction == "full_weighting":
        sy = (0.25 * d[rr - 1] + 0.5 * d[rr]) + 0.25 * d[rr + 1]
        v = (0.25 * sy[:, cc - 1] + 0.5 * sy[:, cc]) + 0.25 * sy[:, cc + 1]
    else:
        v = d[rr][:, cc]
    m = (geo.n + 1) // 2
    ci = torch.arange(cr0, cr0 + crows, device=d.device)
    cj = torch.arange(cc0, cc0 + ccols, device=d.device)
    keep = ((ci >= 1) & (ci <= m - 2))[:, None] & ((cj >= 1) & (cj <= m - 2))[None, :]
    fc = torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device))
    return geo.owned(u).contiguous(), fc.contiguous(), raw


def _prolong_ext(c_win, cr0: int, cc0: int, geo: ShardGeo):
    """The bilinear prolongation at the window's cells from a window of the
    coarse grid at global (cr0, cc0) (transfers.prolong's order: columns,
    then rows); 0 where the coarse window holds no value."""
    gi, gj = geo.coords(c_win.device)
    cp = torch.nn.functional.pad(c_win, (2, 2, 2, 2))
    hi, wi = cp.shape

    def coarse(I, J):
        return cp[torch.clamp(I - cr0 + 2, 0, hi - 1)][:, torch.clamp(J - cc0 + 2, 0, wi - 1)]

    I, J = torch.div(gi, 2, rounding_mode="floor"), torch.div(gj, 2, rounding_mode="floor")
    odd_c = (gj % 2 == 1)[None, :]

    def wide(I):
        a = coarse(I, J)
        return torch.where(odd_c, 0.5 * a + 0.5 * coarse(I, J + 1), a)

    w0 = wide(I)
    return torch.where((gi % 2 == 1)[:, None], 0.5 * w0 + 0.5 * wide(I + 1), w0)


def fused_ascend_shard_torch(u_ext, f_ext, c_win, cr0: int, cc0: int, geo: ShardGeo, h: float,
                             steps: int, omega: float = 1.0, err_mode=None):
    """Twin of ``fused_ascend_shard``: (owned block, raw error partial or None)."""
    inside = geo.interior(f_ext.device)
    u = torch.where(inside, u_ext + _prolong_ext(c_win, cr0, cc0, geo), u_ext)
    return fused_jacobi_shard_torch(u, f_ext, geo, h, steps, omega, False, err_mode)


def _check_shard(name: str, t, geo: ShardGeo, shape=None):
    _check(name, t, geo.ext_shape if shape is None else shape, t.device)


def _check_shard_block(u_ext, f_ext, geo: ShardGeo, halo: int, need_u: bool = True):
    """Validate one shard's block and windows for a shard-mode launch."""
    if not f_ext.is_cuda:
        raise ValueError(f"CUDA kernel called on a {f_ext.device} tensor")
    n = geo.n
    if not (n >= 3 and 0 <= geo.row0 and geo.row0 + geo.rows <= n and 0 <= geo.col0
            and geo.col0 + geo.cols <= n and geo.rows >= 1 and geo.cols >= 1):
        raise ValueError(f"a shard block must lie in the {n}² grid, got {geo}")
    # the halo must cover the tile halo wherever the block has a neighbour
    for ext, lo, hi, what in ((geo.ext_r, geo.row0, geo.row0 + geo.rows, "rows"),
                              (geo.ext_c, geo.col0, geo.col0 + geo.cols, "columns")):
        if ext < halo and (lo > 0 or hi < n):
            raise ValueError(f"the pass needs {halo} halo {what}, the block carries {ext}")
    _check_shard("f", f_ext, geo)
    if need_u:
        _check_shard("u", u_ext, geo)


def _shard_launch_args(u_ext, f_ext, geo: ShardGeo, halo: int, need_u: bool = True):
    """Validate a shard-mode launch; return (library, stream, device)."""
    from . import build

    _check_shard_block(u_ext, f_ext, geo, halo, need_u)
    if f_ext.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {f_ext.device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return build.load(), torch.cuda.current_stream(f_ext.device).cuda_stream, f_ext.device


def _geo_args(geo: ShardGeo):
    return (geo.n, geo.row0, geo.col0, geo.rows, geo.cols, geo.ext_r, geo.ext_c)


def _shard_err_buffers(lib, mode, geo: ShardGeo, device, rows: int = 1):
    if mode is None:
        return None, None
    tiles = lib.mg_num_tiles_block(geo.rows, geo.cols)
    return (torch.empty(rows * tiles, dtype=torch.float32, device=device),
            torch.empty(rows, dtype=torch.float32, device=device))


def fused_jacobi_shard(u_ext, f_ext, geo: ShardGeo, h: float, steps: int, omega: float = 1.0,
                       from_zero: bool = False, err_mode=None, smoother: str = "jacobi"):
    """One pass of ``steps`` sweeps (≤ 8 Jacobi, ≤ 4 rb-GS; ω ignored for
    rb-GS) on one shard's block: ``u_ext``, ``f_ext`` are the block's
    windows with ``geo``'s halo (u unread when ``from_zero``). ``err_mode``
    (None, "cpu", "clean", or for Jacobi "gpu") adds the raw error partial of
    the result over the owned cells. Returns (owned block, raw partial as a
    0-d tensor, or None)."""
    if smoother not in ("jacobi", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if not f_ext.is_cuda:
        return fused_jacobi_shard_torch(u_ext, f_ext, geo, h, steps, omega, from_zero, err_mode,
                                        smoother)
    mode_code = _ERR_CODES[err_mode]
    if smoother == "rbgs":
        halo = 2 * steps + (err_mode is not None)
        if err_mode == "gpu" or steps < 1 or halo > MAX_FUSED_SWEEPS:
            raise ValueError(f"an rb-GS pass runs 1..{MAX_FUSED_RBGS} sweeps (fewer with an "
                             f"error) and no gpu metric, got {steps}, {err_mode}")
    else:
        _check_steps(steps)
        halo = steps - from_zero + (err_mode in ("cpu", "clean"))
    lib, stream, dev = _shard_launch_args(u_ext, f_ext, geo, halo, not from_zero)
    out = torch.empty((geo.rows, geo.cols), dtype=f_ext.dtype, device=dev)
    partials, err = _shard_err_buffers(lib, err_mode, geo, dev)
    u_ext, f_ext = _aligned(None if from_zero else u_ext), _aligned(f_ext)
    if smoother == "rbgs":
        rc = lib.mg_rbgs_shard(_ptr(u_ext), f_ext.data_ptr(), out.data_ptr(), _ptr(partials),
                               _ptr(err), *_geo_args(geo), steps, int(from_zero), mode_code,
                               h * h, 1.0, stream)
        _raise_on(lib, rc, "rbgs shard")
        launches["rbgs_shard"] += 1
    else:
        rc = lib.mg_jacobi_shard(_ptr(u_ext), f_ext.data_ptr(),
                                 out.data_ptr(), _ptr(partials), _ptr(err), *_geo_args(geo),
                                 steps, int(from_zero), mode_code, h * h, omega, 1.0 / (h * h),
                                 _zero_coef(h, omega), 1.0, stream)
        _raise_on(lib, rc, "jacobi shard")
        launches["jacobi_shard"] += 1
    return out, (None if err is None else err.reshape(()))


def fused_jacobi_errs_shard(u_ext, f_ext, geo: ShardGeo, h: float, steps: int,
                            omega: float = 1.0, err_mode: str = "cpu"):
    """``steps`` ≤ 8 (≤ 7 for cpu, clean) Jacobi sweeps on one shard's block
    in one pass with the raw error partial of every iterate (the per-sweep
    mode): (owned block, raws of shape (steps,))."""
    cap = MAX_FUSED_SWEEPS if err_mode == "gpu" else MAX_FUSED_SWEEPS - 1
    if err_mode not in ("cpu", "clean", "gpu") or not 1 <= steps <= cap:
        raise ValueError(f"a per-sweep error pass runs 1..{cap} sweeps with a cpu, clean or "
                         f"gpu error, got {steps}, {err_mode}")
    if not f_ext.is_cuda:
        return fused_jacobi_errs_shard_torch(u_ext, f_ext, geo, h, steps, omega, err_mode)
    lib, stream, dev = _shard_launch_args(u_ext, f_ext, geo, steps + (err_mode != "gpu"))
    out = torch.empty((geo.rows, geo.cols), dtype=f_ext.dtype, device=dev)
    partials, raws = _shard_err_buffers(lib, err_mode, geo, dev, steps)
    u_ext, f_ext = _aligned(u_ext), _aligned(f_ext)
    rc = lib.mg_jacobi_errs_shard(u_ext.data_ptr(), f_ext.data_ptr(), out.data_ptr(),
                                  partials.data_ptr(), raws.data_ptr(), *_geo_args(geo), steps,
                                  _ERR_CODES[err_mode], h * h, omega, 1.0 / (h * h), 1.0, stream)
    _raise_on(lib, rc, "jacobi_errs shard")
    launches["jacobi_errs_shard"] += 1
    return out, raws


def residual_shard(u_ext, f_ext, geo: ShardGeo, h: float, negate: bool = False):
    """The 5-point residual of one shard's block (optionally negated), 0 off
    the interior; ``u_ext``, ``f_ext`` are its windows (halo ≥ 1)."""
    if not f_ext.is_cuda:
        return residual_shard_torch(u_ext, f_ext, geo, h, negate)
    lib, stream, dev = _shard_launch_args(u_ext, f_ext, geo, 1)
    r = torch.empty((geo.rows, geo.cols), dtype=f_ext.dtype, device=dev)
    rc = lib.mg_residual_shard(u_ext.data_ptr(), f_ext.data_ptr(), r.data_ptr(), *_geo_args(geo),
                               1.0 / (h * h), int(negate), stream)
    _raise_on(lib, rc, "residual shard")
    launches["residual_shard"] += 1
    return r


MAX_RESIDUAL_BATCH = 16   # MAX_BATCH in csrc/residual.cu: the shards of one launch


def residual_shards_torch(u_exts, f_exts, geos, h: float, negate: bool = False):
    """Twin of ``residual_shards``: ``residual_shard_torch`` of each shard."""
    return [residual_shard_torch(ue, fe, g, h, negate) for ue, fe, g in zip(u_exts, f_exts, geos)]


def residual_shards(u_exts, f_exts, geos, h: float, negate: bool = False):
    """``residual_shard`` of every shard of one level that lives on one card,
    as one launch per ``MAX_RESIDUAL_BATCH`` shards
    (``residual_shards_kernel``), each shard's r bit for bit its own launch's.
    The windows share one halo (``geos``' ext_r and ext_c) and the current
    card. Counts ``launches["residual_shard"]`` once per launch. Returns the
    owned blocks in the order given."""
    if not f_exts[0].is_cuda:
        return residual_shards_torch(u_exts, f_exts, geos, h, negate)
    if len({(g.n, g.ext_r, g.ext_c) for g in geos}) != 1:
        raise ValueError("one launch takes the shards of one level with one halo")
    out = []
    for a in range(0, len(geos), MAX_RESIDUAL_BATCH):
        us, fs, gs = (x[a:a + MAX_RESIDUAL_BATCH] for x in (u_exts, f_exts, geos))
        lib, stream, dev = _shard_launch_args(us[0], fs[0], gs[0], 1)
        for ue, fe, g in zip(us, fs, gs):
            _check_shard_block(ue, fe, g, 1)
            if fe.device != dev or ue.device != dev:
                raise ValueError(f"one launch runs on one card, {dev}: got {ue.device}, "
                                 f"{fe.device}")
        rs = [torch.empty((g.rows, g.cols), dtype=torch.float32, device=dev) for g in gs]

        ptrs = [_c_array(ctypes.c_uint64, [t.data_ptr() for t in ts]) for ts in (us, fs, rs)]
        blocks = [_c_array(ctypes.c_int, [getattr(g, k) for g in gs])
                  for k in ("row0", "col0", "rows", "cols")]
        rc = lib.mg_residual_shards(*ptrs, *blocks, len(gs), gs[0].n, gs[0].ext_r, gs[0].ext_c,
                                    1.0 / (h * h), int(negate), stream)
        _raise_on(lib, rc, "residual shards")
        launches["residual_shard"] += 1
        out += rs
    return out


def _check_leg_block(geo: ShardGeo):
    if geo.n % 2 == 0 or geo.row0 % 2 or geo.col0 % 2:
        raise ValueError(f"a 2:1 leg needs an odd level and an even block origin, got {geo}")


def fused_descend_shard(u_ext, f_ext, geo: ShardGeo, h: float, steps: int, omega: float = 1.0,
                        restriction: str = "sampling", err_mode=None, from_zero: bool = False):
    """The descend leg on one shard's block of an aligned level n = 2m − 1
    (even origin): sweeps, residual and restriction of −r onto the block's
    coarse points (rows from row0 / 2, ⌈rows / 2⌉ of them; the same for
    columns). Returns (owned block, coarse block, raw partial or None)."""
    if restriction not in ("sampling", "full_weighting"):
        raise ValueError(f"unknown restriction {restriction!r}")
    _check_leg_block(geo)
    if not f_ext.is_cuda:
        return fused_descend_shard_torch(u_ext, f_ext, geo, h, steps, omega, restriction,
                                         err_mode, from_zero)
    _check_steps(steps)
    halo = steps - from_zero + 1 + (restriction == "full_weighting")
    lib, stream, dev = _shard_launch_args(u_ext, f_ext, geo, halo, not from_zero)
    out = torch.empty((geo.rows, geo.cols), dtype=f_ext.dtype, device=dev)
    _, _, crows, ccols = _coarse_block(geo)
    fc = torch.empty((crows, ccols), dtype=f_ext.dtype, device=dev)
    partials, err = _shard_err_buffers(lib, err_mode, geo, dev)
    u_ext, f_ext = _aligned(None if from_zero else u_ext), _aligned(f_ext)
    rc = lib.mg_descend_shard(_ptr(u_ext), f_ext.data_ptr(),
                              out.data_ptr(), fc.data_ptr(), _ptr(partials), _ptr(err),
                              *_geo_args(geo), steps, int(from_zero),
                              int(restriction == "full_weighting"), _ERR_CODES[err_mode], h * h,
                              omega, 1.0 / (h * h), _zero_coef(h, omega), 1.0, stream)
    _raise_on(lib, rc, "descend shard")
    launches["descend_shard"] += 1
    return out, fc, (None if err is None else err.reshape(()))


def fused_ascend_shard(u_ext, f_ext, c_win, cr0: int, cc0: int, geo: ShardGeo, h: float,
                       steps: int, omega: float = 1.0, err_mode=None):
    """The ascend leg on one shard's block of an aligned level n = 2m − 1
    (even origin): ``c_win`` is the window of the (m, m) coarse correction
    at global (cr0, cc0) holding the coarse cells the block's window
    interpolates from. Returns (owned block, raw partial or None)."""
    _check_leg_block(geo)
    if not f_ext.is_cuda:
        return fused_ascend_shard_torch(u_ext, f_ext, c_win, cr0, cc0, geo, h, steps, omega,
                                        err_mode)
    _check_steps(steps)
    lib, stream, dev = _shard_launch_args(u_ext, f_ext, geo,
                                          steps + (err_mode in ("cpu", "clean")))
    _check("c", c_win, tuple(c_win.shape), dev)
    out = torch.empty((geo.rows, geo.cols), dtype=f_ext.dtype, device=dev)
    partials, err = _shard_err_buffers(lib, err_mode, geo, dev)
    u_ext, f_ext = _aligned(u_ext), _aligned(f_ext)
    rc = lib.mg_ascend_shard(u_ext.data_ptr(), f_ext.data_ptr(), c_win.data_ptr(),
                             out.data_ptr(), _ptr(partials), _ptr(err), *_geo_args(geo), cr0, cc0,
                             c_win.shape[0], c_win.shape[1], steps, _ERR_CODES[err_mode], h * h,
                             omega, 1.0 / (h * h), 1.0, stream)
    _raise_on(lib, rc, "ascend shard")
    launches["ascend_shard"] += 1
    return out, (None if err is None else err.reshape(()))
