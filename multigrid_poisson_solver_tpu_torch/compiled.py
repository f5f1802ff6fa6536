"""The whole-schedule engine: a CycleProgram run as one fixed sequence of
device operations.

PyTorch port of ``multigrid_poisson_solver_tpu/compiled.py``. The JAX engine
traces every instruction of a schedule into one jitted XLA program; PyTorch
runs eagerly, so here the same instruction walk (``_run``, the counterpart
of ``_run_traced``) issues the level operations directly. Every level shape,
sweep count and restriction target is static, so a cycle on the CUDA
kernel path enqueues kernels without reading anything back from the device,
except where the data decides: trigger smoothing (``steps == -1``) and the
Gauss-Seidel coarse solve test their stopping rule on the host once per
sweep.

Routing keeps the JAX engine's predicates, so a schedule reaches the same
operations (``ops.kernels``): a pure V below a level of at most 1025² runs
as two chain kernels around the coarse solve (``_match_chain``); a
2:1-aligned Jacobi descend or ascend with a fixed sweep count within the
fused budget runs as one fused-leg kernel; anything else runs sweeps
(Jacobi or rb-GS), residual, zoom and correction as separate operations. A
Jacobi trigger node runs, in JAX's order: its whole loop as one kernel on a
level of at most 2176² (``trigger_fits``), or up to 4097²
(``trigger_stream_fits``); with an integer ``trigger_batch > 1`` passes of
that many sweeps with the error of every iterate (``fused_jacobi_errs``),
the stop rule replayed over them; with ``"auto"`` 2B exact sweeps first and
then such passes of B = ``errs_sweep_cap`` sweeps; else the exact loop of
one fused sweep-plus-error launch and one host stop test per sweep. The
batched passes overshoot the stop sweep by up to B − 1 sweeps, as JAX's
do. The plain path keeps the exact loop everywhere, as JAX's XLA path does.
The names ``compile_program``/``CompiledCycle`` are kept for the
counterpart; nothing is compiled ahead of time except the CUDA kernels
(``ops.build``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .grid import GridSpec
from .models.problems import Problem
from .ops import kernels as K
from .ops import stencils
from .ops import transfers
from .ops.zoom import zoom
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import SolverConfig, coarse_solve, restrict, trigger_loop


def _use_kernels(cfg: SolverConfig, device: torch.device) -> bool:
    """Whether the hot path runs the CUDA kernels (``ops.kernels``)."""
    if cfg.kernels == "torch":
        return False
    if cfg.kernels == "auto":
        return device.type == "cuda"
    if cfg.kernels == "cuda":
        if device.type != "cuda":
            raise ValueError(f"kernels='cuda' needs a CUDA device, got {device}")
        return True
    raise ValueError(f"unknown kernels {cfg.kernels!r}; expected auto, cuda or torch")


def _check_ported(cfg: SolverConfig, use_kernels: bool) -> None:
    """Refuse configurations the kernels do not take instead of quietly
    running the plain path."""
    if use_kernels and cfg.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got dtype={cfg.dtype}; "
                        f"use kernels='torch' for other dtypes")


@dataclasses.dataclass
class _Level:
    spec: GridSpec
    u: torch.Tensor
    f: torch.Tensor
    is_fmg: bool = False


class CompiledCycle:
    """A CycleProgram bound to a problem, a numerical policy and a device.

    ``init()`` gives the finest level's ``(u0, f0)`` on the device; calling
    the object runs one cycle and returns ``(u, err)``, ``err`` being the
    most recent finest-level smoothing error (a device scalar). Arguments
    are never modified.

    Warm restart (the reference's init flag, linkedlist.h:38-41): with
    ``warm=False`` every call resets the finest iterate, so chaining the
    output into the same instance repeats cycle 1. Build a ``warm=True``
    instance to continue cycles, or use :meth:`iterate`.

    Set ``trigger_sweeps`` to a list to have every trigger node append
    ``(n, sweeps run)`` to it (one read from the device per node).
    """

    trigger_sweeps = None

    def __init__(self, program: CycleProgram, problem: Problem,
                 config: SolverConfig = SolverConfig(), device="cuda",
                 warm: bool = False):
        program.validate()
        self.program = program
        self.problem = problem
        self.config = config
        self.device = torch.device(device)
        self.warm = warm
        self.use_kernels = _use_kernels(config, self.device)
        _check_ported(config, self.use_kernels)
        self.finest_spec = GridSpec(program.n_max, program.length,
                                    program.min_x, program.min_y)

    def init(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(u0, f0) for the finest level, on the device."""
        cfg, spec = self.config, self.finest_spec
        b = self.problem.boundary_grid(spec, cfg.dtype, self.device)
        f = self.problem.source_grid(spec, cfg.dtype, self.device) + b
        return b.clone(), f

    def __call__(self, u, f):
        return _run(u, f, self.program, self.problem, self.config, self.device,
                    self.warm, self.use_kernels, self.trigger_sweeps)

    def iterate(self, cycles: int):
        """``fn(u0, f) -> u``: one cold cycle, then ``cycles − 1`` warm ones."""
        warm = CompiledCycle(self.program, self.problem, self.config, self.device,
                             warm=True)

        def chained(u, f):
            u = self(u, f)[0]
            for _ in range(cycles - 1):
                u = warm(u, f)[0]
            return u

        return chained

    def unpad(self, u: torch.Tensor) -> torch.Tensor:
        """The identity: the port's levels carry no padding."""
        return u


def _fuse_descend_ok(cfg: SolverConfig, use_kernels: bool, n: int, m: int,
                     steps: int) -> bool:
    """The JAX engine's predicate for the one-kernel descend leg: Jacobi, a
    2:1 vertex-aligned coarse level, a sweep count within the fused budget."""
    if not (use_kernels and cfg.smoother == "jacobi" and n == 2 * m - 1):
        return False
    cap = 6 if cfg.restriction == "full_weighting" else 7
    return 1 <= steps <= cap


def _fuse_ascend_ok(cfg: SolverConfig, use_kernels: bool, n: int, n_child: int,
                    steps: int, finest: bool) -> bool:
    """The JAX engine's predicate for the one-kernel ascend leg."""
    if not (use_kernels and cfg.smoother == "jacobi" and n == 2 * n_child - 1):
        return False
    cap = 8 if (not finest or cfg.compat_error == "gpu") else 7
    return 1 <= steps <= cap


def _match_chain(instructions, i: int, n0: int, cfg: SolverConfig, use_kernels: bool,
                 finest: bool):
    """Match a pure V-shaped sub-pattern starting at instruction ``i``:
    Descend×c (fixed steps, 2:1-aligned all the way), CoarseSolve, Ascend×c,
    the shape the two chain kernels run (``compiled.py::_match_chain``).
    Returns (sizes, pre_steps, post_steps, solve_ins, next_i) or None.

    JAX's guards: kernels and Jacobi only; trigger (−1) and FMG (0) descents
    never chain; the ladder must pass ``chain_fits``; at the finest level the
    error metric must be cpu or clean. One more here: every sweep count
    within the tile budget of the leg kernels whose tile code the chain
    kernels run (JAX's chain sweeps whole levels, uncapped)."""
    if cfg.smoother != "jacobi" or not use_kernels:
        return None
    if finest and cfg.compat_error == "gpu":
        return None
    sizes, pre = [n0], []
    j = i
    while j < len(instructions) and isinstance(instructions[j], Descend):
        d = instructions[j]
        if d.steps <= 0 or d.next_n != (sizes[-1] + 1) // 2:
            return None
        pre.append(d.steps)
        sizes.append(d.next_n)
        j += 1
    if not pre or j >= len(instructions) or not isinstance(instructions[j], CoarseSolve):
        return None
    solve_ins = instructions[j]
    j += 1
    post = []
    while (j < len(instructions) and len(post) < len(pre)
           and isinstance(instructions[j], Ascend)):
        if instructions[j].steps == -1:
            return None
        post.append(instructions[j].steps)
        j += 1
    if len(post) != len(pre) or not K.chain_fits(sizes):
        return None
    if max(pre + post) > K.MAX_FUSED_SWEEPS:
        return None
    # instruction order ascends coarse→fine; the chain wants per-level steps
    return tuple(sizes), tuple(pre), tuple(reversed(post)), solve_ins, j


def _batched_trigger(u, f, h: float, cfg: SolverConfig, batch: int, prev, k: int):
    """Trigger passes of ``batch`` sweeps (``fused_jacobi_errs``) after ``k``
    sweeps whose last error is ``prev``, until a pass holds a sweep whose
    slope is within the trigger or ``max_trigger_sweeps`` is reached; the
    stop rule is replayed over each pass's error vector (JAX's
    ``batch_step``). The iterate is the pass's last, up to batch − 1 sweeps
    past the stop sweep; the error is that of the stop sweep. One host read
    per pass. Returns (u, err, sweeps run)."""
    while True:
        u, errs = K.fused_jacobi_errs(u, f, h, batch, cfg.omega, cfg.compat_error)
        k += batch
        stop = torch.abs(errs - torch.cat([prev.reshape(1), errs[:-1]])) <= cfg.trigger
        if bool(stop.any()):
            return u, errs[int(torch.argmax(stop.to(torch.int32)))], k
        prev = errs[-1]
        if k >= cfg.max_trigger_sweeps:
            return u, prev, k


def _trigger_smooth(u, f, h: float, n: int, cfg: SolverConfig, use_kernels: bool):
    """Error-triggered smoothing: sweep while |err_k − err_{k−1}| > trigger.
    Returns (u, err, sweeps run); routing as in the module docstring
    (``_trigger_smooth_traced``)."""
    max_sweeps = cfg.max_trigger_sweeps
    auto = False
    if cfg.smoother == "jacobi":
        if use_kernels and (K.trigger_fits(n) or K.trigger_stream_fits(n)):
            loop = K.trigger_smooth if K.trigger_fits(n) else K.trigger_smooth_stream
            return loop(u, f, h, cfg.omega, cfg.compat_error, cfg.trigger, max_sweeps)
        if use_kernels and isinstance(cfg.trigger_batch, int) and cfg.trigger_batch > 1:
            # the first pass has no slope at sweep 1: prev = +inf masks it
            batch = min(cfg.trigger_batch, K.errs_sweep_cap(cfg.compat_error))
            inf = torch.full((), math.inf, dtype=f.dtype, device=f.device)
            return _batched_trigger(u, f, h, cfg, batch, inf, 0)
        fused = K.fused_jacobi_err if use_kernels else K.fused_jacobi_err_torch
        auto = use_kernels and cfg.trigger_batch == "auto"

        def step(v):
            return fused(v, f, h, 1, cfg.omega, cfg.compat_error)
    elif use_kernels and cfg.compat_error != "gpu":
        def step(v):
            return K.fused_rbgs_err(v, f, h, 1, cfg.compat_error)
    else:
        gs = K.fused_rbgs if use_kernels else K.fused_rbgs_torch

        def step(v):
            v_new = gs(v, f, h, 1)
            if cfg.compat_error == "gpu":
                return v_new, stencils.gpu_smoothing_error(v_new, v, h)
            return v_new, stencils.smoothing_error(v_new, f, h, compat=cfg.compat_error)
    if not auto:
        return trigger_loop(step, u, cfg.trigger, max_sweeps)
    # "auto": first 2B exact sweeps, so a level that stops within them is the
    # trigger_batch=1 loop bit for bit; one still running continues in
    # B-sweep passes
    batch = K.errs_sweep_cap(cfg.compat_error)
    warm = min(2 * batch, max_sweeps)
    u, err = step(u)
    k, above = 1, True
    while above and k < warm:
        u, new_err = step(u)
        above = bool(torch.abs(new_err - err) > cfg.trigger)
        err, k = new_err, k + 1
    if not above or k >= max_sweeps:
        return u, err, k
    return _batched_trigger(u, f, h, cfg, batch, err, k)


def _smooth(u, f, h: float, n: int, steps: int, cfg: SolverConfig, want_err: bool,
            use_kernels: bool, from_zero: bool = False, trigger_sweeps=None):
    """``steps`` sweeps (or the trigger loop), with the finest level's error
    when ``want_err``: (u, err or None). ``from_zero``: u ≡ 0 (a freshly
    reset correction level), so the first Jacobi sweep is the closed form and
    u is not read."""
    if steps == -1:
        u, err, sweeps = _trigger_smooth(u, f, h, n, cfg, use_kernels)
        if trigger_sweeps is not None:
            trigger_sweeps.append((n, int(sweeps)))
        return u, err
    if cfg.smoother == "jacobi" and steps >= 1:
        if want_err:
            fused = K.fused_jacobi_err if use_kernels else K.fused_jacobi_err_torch
            return fused(u, f, h, steps, cfg.omega, cfg.compat_error, from_zero)
        fused = K.fused_jacobi if use_kernels else K.fused_jacobi_torch
        return fused(u, f, h, steps, cfg.omega, from_zero), None
    gs = K.fused_rbgs if use_kernels else K.fused_rbgs_torch
    if want_err and steps >= 1:
        if use_kernels and cfg.compat_error != "gpu":
            # the cpu / clean error fused into the last pass
            return K.fused_rbgs_err(u, f, h, steps, cfg.compat_error, from_zero)
        if cfg.compat_error == "gpu":
            # the GPU metric needs the final sweep's pair (JAX's two-call form)
            u_prev = u if steps == 1 else gs(u, f, h, steps - 1, from_zero)
            u = gs(u_prev, f, h, 1, from_zero and steps == 1)
            return u, stencils.gpu_smoothing_error(u, u_prev, h)
    u = gs(u, f, h, steps, from_zero)
    if not want_err:
        return u, None
    return u, stencils.smoothing_error(u, f, h, compat=cfg.compat_error)


def _run(u0, f0, program: CycleProgram, problem: Problem, cfg: SolverConfig,
         device: torch.device, warm: bool, use_kernels: bool, trigger_sweeps=None):
    """Walk the instruction sequence. Returns (u_finest, last_err), last_err
    being the most recent finest-level smoothing error; ``trigger_sweeps``,
    when a list, receives (n, sweeps run) of every trigger node."""
    finest_spec = GridSpec(program.n_max, program.length, program.min_x, program.min_y)
    levels = [_Level(finest_spec, u0, f0)]
    warm_now = warm
    last_err = torch.zeros((), dtype=cfg.dtype, device=device)

    def boundary(spec):
        return problem.boundary_grid(spec, cfg.dtype, device)

    def zeros(spec):
        return torch.zeros(spec.shape, dtype=cfg.dtype, device=device)

    instructions = program.instructions
    i = 0
    while i < len(instructions):
        ins = instructions[i]
        i += 1
        lvl = levels[-1]
        n, h = lvl.spec.n, lvl.spec.h

        if isinstance(ins, Descend):
            finest = len(levels) == 1
            was_zeroed = False
            if not (finest and warm_now) and not lvl.is_fmg:
                # reference memset semantics (MG_solver_CPU.cpp:209-214)
                lvl.u = boundary(lvl.spec) if finest else zeros(lvl.spec)
                was_zeroed = not finest   # correction levels reset to u ≡ 0

            chain = _match_chain(instructions, i - 1, n, cfg, use_kernels, finest)
            if chain is not None:
                # the V below this level as two launches around the coarse
                # solve; the iterate is the per-level legs' bit for bit
                sizes, pre, post, solve_ins, i = chain
                u_list, f_list = K.chain_descend(lvl.u, lvl.f, sizes, h, pre, cfg.omega,
                                                 cfg.restriction, entry_from_zero=was_zeroed)
                uc = coarse_solve(f_list[-1], lvl.spec.coarsened(sizes[-1]).h, solve_ins,
                                  cfg.dtype, cfg.coarse_gs_norm)[0]
                fuse_err = finest and post[0] != 0
                lvl.u, err = K.chain_ascend(u_list, [lvl.f] + f_list[:-1], uc, sizes, h, post,
                                            cfg.omega, cfg.compat_error, want_err=fuse_err)
                if finest:
                    # with no finest post-sweeps the metric is that of the
                    # pre-smoothed iterate
                    last_err = err if fuse_err else stencils.smoothing_error(
                        u_list[0], lvl.f, h, compat=cfg.compat_error)
                    warm_now = True
                continue

            next_spec = lvl.spec.coarsened(ins.next_n)
            m = ins.next_n
            if ins.steps == 0:
                # FMG descent: restrict the full RHS, no smoothing
                # (the reference's TODO branch, MG_solver_CPU.cpp:296-299)
                f_c = zoom(lvl.f, m, zero_boundary=True, form=cfg.zoom) + boundary(next_spec)
                levels.append(_Level(next_spec, zeros(next_spec), f_c, is_fmg=True))
                continue

            if _fuse_descend_ok(cfg, use_kernels, n, m, ins.steps):
                # sweeps + residual + restriction in one kernel
                lvl.u, f_c, err = K.fused_descend(
                    lvl.u, lvl.f, h, ins.steps, cfg.omega, cfg.restriction,
                    cfg.compat_error, want_err=finest, from_zero=was_zeroed)
            else:
                lvl.u, err = _smooth(lvl.u, lvl.f, h, n, ins.steps, cfg, finest,
                                     use_kernels, was_zeroed, trigger_sweeps)
                d = (K.residual(lvl.u, lvl.f, h) if use_kernels
                     else stencils.residual(lvl.u, lvl.f, h))
                f_c = restrict(d, m, cfg.restriction, cfg.zoom)
            if finest and err is not None:
                last_err = err
            levels.append(_Level(next_spec, zeros(next_spec), f_c))

        elif isinstance(ins, CoarseSolve):
            lvl.u = coarse_solve(lvl.f, h, ins, cfg.dtype, cfg.coarse_gs_norm)[0]

        elif isinstance(ins, Ascend):
            child = levels.pop()
            lvl = levels[-1]
            n, h = lvl.spec.n, lvl.spec.h
            if len(levels) == 1:
                warm_now = True
            finest = len(levels) == 1
            if _fuse_ascend_ok(cfg, use_kernels, n, child.spec.n, ins.steps, finest):
                # prolongation + interior add + post-sweeps in one kernel
                lvl.u, err = K.fused_ascend(lvl.u, lvl.f, child.u, h, ins.steps,
                                            cfg.omega, cfg.compat_error, want_err=finest)
                if finest and err is not None:
                    last_err = err
                continue
            corr = zoom(child.u, n, form=cfg.zoom)
            lvl.u = transfers.add_correction(lvl.u, corr)
            if ins.steps != 0:
                lvl.u, err = _smooth(lvl.u, lvl.f, h, n, ins.steps, cfg, finest, use_kernels,
                                     trigger_sweeps=trigger_sweeps)
                if finest and err is not None:
                    last_err = err
        else:  # pragma: no cover
            raise TypeError(f"unknown instruction {ins!r}")

    return levels[0].u, last_err


def compile_program(program: CycleProgram, problem: Problem,
                    config: SolverConfig = SolverConfig(), device="cuda",
                    warm: bool = False) -> CompiledCycle:
    """Bind ``program`` to ``problem``, ``config`` and ``device`` (default
    ``"cuda"``; a CPU run needs ``device="cpu"``)."""
    return CompiledCycle(program, problem, config, device, warm)
