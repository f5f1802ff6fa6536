"""The interpreted multigrid engine and the solver's numerical policy.

PyTorch port of ``multigrid_poisson_solver_tpu/solver.py``. Executes a
CycleProgram one instruction at a time on a level stack, with the oracle ops
only (``ops.stencils``, ``ops.zoom``, ``ops.coarse``); it is the
instrumented, per-node-reporting path, and ``compiled.py`` is the fast one.
Both keep the reference's semantics:

  * every Descend re-zeroes the level's correction before smoothing, except
    the warm restart: the finest level after a completed cycle (init flag,
    linkedlist.h:38-41, MG_solver_CPU.cpp:209-214);
  * the exact solvers start from zero (MG_solver_CPU.cpp:993);
  * the smoothing-error metric defaults to the reference's color-bugged
    variant, so trigger schedules run the same number of sweeps.

``f`` arrays carry the boundary values on their border and the PDE
right-hand side inside; ``u`` arrays carry the boundary on their border.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

import torch

from .grid import GridSpec
from .models.problems import Problem
from .ops import coarse as coarse_ops
from .ops import stencils
from .ops import transfers
from .ops.zoom import zoom
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend, TRIGGER_DEFAULT

logger = logging.getLogger("multigrid_poisson_solver_tpu_torch")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Numerical policy for a solver instance (fields as in the JAX package)."""

    dtype: Any = torch.float32
    smoother: str = "jacobi"          # "jacobi" | "rbgs"
    omega: float = 1.0                # Jacobi damping (reference uses 1.0)
    compat_error: Any = True          # trigger metric: True (the CPU
                                      # reference's color-bugged sum), False
                                      # (clean mean |residual|) or "gpu" (the
                                      # GPU reference's |ΔU|·4/h² of the last
                                      # sweep)
    trigger: float = TRIGGER_DEFAULT  # |Δerr| threshold for step == -1
    max_trigger_sweeps: int = 100_000
    trigger_batch: Any = "auto"       # trigger sweeps per pass on the kernel
                                      # path above the whole-loop kernels: 1
                                      # the exact loop, B > 1 B-sweep passes
                                      # (overshooting the stop by < B
                                      # sweeps), "auto" 2B exact sweeps,
                                      # then passes
    coarse_gs_norm: str = "interior"  # "interior" (CPU ref) | "full" (GPU ref)
    collect_node_stats: bool = True   # pull per-node scalars to the host
    kernels: str = "auto"             # "auto" | "cuda" | "torch": hot-path
                                      # routing of the compiled engine
                                      # ("auto": the CUDA kernels when the
                                      # device is CUDA, plain PyTorch else)
    zoom: str = "take"                # "take" (gather) | "matmul" (dense
                                      # interpolation matrices)
    restriction: str = "sampling"     # "sampling" (reference semantics) |
                                      # "full_weighting" (2:1-aligned levels
                                      # only; required by the rbgs smoother)
    halo: str = "ppermute"            # sharded halo exchange; single-device
                                      # runs have no halo to exchange


@dataclasses.dataclass
class Level:
    spec: GridSpec
    u: torch.Tensor
    f: torch.Tensor
    is_fmg: bool = False  # pushed by an FMG descent (f is a restricted RHS)


@dataclasses.dataclass
class NodeReport:
    kind: str
    n: int
    steps: Optional[int] = None
    error: Optional[float] = None
    detail: str = ""


@dataclasses.dataclass
class SolveReport:
    u: torch.Tensor
    spec: GridSpec
    wall_time_s: float
    nodes: list[NodeReport]
    error_vs_analytic: Optional[float] = None

    def summary(self) -> str:
        lines = ["===== Final Result ====="]
        if self.error_vs_analytic is not None:
            lines.append(f"    Error = {self.error_vs_analytic:.6e}")
        lines.append(f"Time Used = {self.wall_time_s * 1e3:.3f} (ms)")
        return "\n".join(lines)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trigger_loop(step: Callable, u: torch.Tensor, trigger: float, max_sweeps: int):
    """Error-triggered smoothing (MG_solver_CPU.cpp:194-240, 376-408): sweep
    while |err_k − err_{k−1}| > trigger. ``step(u) -> (u_next, err)``. The
    first sweep only records the error; the slope test starts at sweep 2.
    Each sweep reads one flag back to the host. Returns (u, err, sweeps)."""
    u, err = step(u)
    k = 1
    above = True
    while above and k < max_sweeps:
        u, new_err = step(u)
        above = bool(torch.abs(new_err - err) > trigger)
        err = new_err
        k += 1
    return u, err, k


def trigger_loop_lagged(pass_: Callable, u: torch.Tensor, trigger: float, max_sweeps: int):
    """``trigger_loop`` for a sweep that measures the iterate it reads:
    ``pass_(u) -> (u_next, err(u))`` (the clean error from the stencil read
    that makes u_next). Sweep k's error comes from the pass that makes
    u_{k+1}, so K sweeps take K + 1 passes instead of K sweeps and K error
    reads, and u_k is kept beside u_{k+1}; the iterates, errors and stop
    sweep are ``trigger_loop``'s with step(u) = (u_next, err(u_next)).
    Returns (u, err, sweeps)."""
    cur, _ = pass_(u)
    nxt, err = pass_(cur)
    k = 1
    above = True
    while above and k < max_sweeps:
        cur, (nxt, new_err) = nxt, pass_(nxt)
        above = bool(torch.abs(new_err - err) > trigger)
        err = new_err
        k += 1
    return cur, err, k


def coarse_solve(f: torch.Tensor, h: float, ins: CoarseSolve,
                 dtype: torch.dtype, gs_norm: str):
    """doExactSolver: option 0 dense; 1 Gauss-Seidel in float64 (the
    reference's fp64 GS); 2 Gauss-Seidel in float32. Returns
    (u, err, iterations), the last two None for the dense solve."""
    if ins.option == 0:
        return coarse_ops.dense_solve(f, h), None, None
    dt = {1: torch.float64, 2: torch.float32}.get(ins.option, dtype)
    u, err, iters = coarse_ops.gauss_seidel_solve(f.to(dt), h, ins.target_error,
                                                  norm=gs_norm)
    return u.to(dtype), err, iters


def restrict(d: torch.Tensor, m: int, restriction: str, form: str) -> torch.Tensor:
    """The coarse right-hand side from the fine residual d: negate, restrict
    onto (m, m), zero boundary (the scheduler's down-leg tail,
    MG_solver_CPU.cpp:268-287)."""
    n = d.shape[0]
    if restriction == "full_weighting":
        if n != 2 * m - 1:
            # never fall back silently: FW is requested to avoid the rb-GS
            # sampling pathology; degrading to sampling would diverge
            raise ValueError(
                f"restriction='full_weighting' requires 2:1 vertex-aligned "
                f"levels (n == 2m-1), got {n} -> {m}; build the schedule "
                f"with coarsen=3 (odd-halve) or use restriction='sampling'")
        return transfers.full_weighting_restrict(-d, m)
    return zoom(-d, m, zero_boundary=True, form=form)


class MultigridSolver:
    """Executes CyclePrograms for one Problem under one numerical policy."""

    def __init__(self, problem: Problem, config: SolverConfig = SolverConfig(),
                 device="cuda"):
        self.problem = problem
        self.config = config
        self.device = torch.device(device)

    def _grid(self, kind: str, spec: GridSpec) -> torch.Tensor:
        return getattr(self.problem, kind)(spec, self.config.dtype, self.device)

    def run(self, program: CycleProgram) -> SolveReport:
        cfg = self.config
        spec = GridSpec(program.n_max, program.length, program.min_x, program.min_y)
        levels = [Level(spec, self._grid("boundary_grid", spec),
                        self._grid("source_grid", spec) + self._grid("boundary_grid", spec))]
        warm = False  # becomes True once a cycle returns to the finest level
        nodes: list[NodeReport] = []

        synchronize(self.device)
        start = time.perf_counter()
        for ins in program.instructions:
            lvl = levels[-1]
            n, h = lvl.spec.n, lvl.spec.h

            if isinstance(ins, Descend):
                finest = len(levels) == 1
                # FMG solution levels keep their iterate (an approximation
                # of the solution, the nested-iteration initial guess)
                if not (finest and warm) and not lvl.is_fmg:
                    lvl.u = (self._grid("boundary_grid", lvl.spec) if finest
                             else torch.zeros(lvl.spec.shape, dtype=cfg.dtype,
                                              device=self.device))
                next_spec = lvl.spec.coarsened(ins.next_n)
                zeros = torch.zeros(next_spec.shape, dtype=cfg.dtype, device=self.device)
                if ins.steps == 0:
                    # FMG descent (the reference's TODO branch,
                    # MG_solver_CPU.cpp:296-299): restrict the full RHS
                    f_coarse = (zoom(lvl.f, ins.next_n, zero_boundary=True, form="matmul")
                                + self._grid("boundary_grid", next_spec))
                    levels.append(Level(next_spec, zeros, f_coarse, is_fmg=True))
                    nodes.append(NodeReport("fmg-descend", n, steps=0))
                    continue
                lvl.u, err, taken = self._smooth(lvl, ins.steps)
                f_coarse = restrict(stencils.residual(lvl.u, lvl.f, h), ins.next_n,
                                    cfg.restriction, form="matmul")
                levels.append(Level(next_spec, zeros, f_coarse))
                nodes.append(self._node_report("descend", n, err, taken))

            elif isinstance(ins, CoarseSolve):
                lvl.u, err, iters = coarse_solve(lvl.f, h, ins, cfg.dtype,
                                                 cfg.coarse_gs_norm)
                if ins.option == 0:
                    nodes.append(NodeReport("coarse-solve", n, detail="dense"))
                else:
                    rep = self._node_report("coarse-solve", n, err, iters)
                    rep.detail = f"rbgs target={ins.target_error:g}"
                    nodes.append(rep)

            elif isinstance(ins, Ascend):
                if len(levels) < 2:
                    raise RuntimeError("Ascend with no coarser level (malformed schedule)")
                child = levels.pop()
                lvl = levels[-1]
                n = lvl.spec.n
                lvl.u = transfers.add_correction(lvl.u, zoom(child.u, n, form="matmul"))
                if len(levels) == 1:
                    warm = True  # init-flag semantics, linkedlist.cpp:63-66
                if ins.steps == 0:
                    nodes.append(NodeReport("ascend", n, steps=0))
                else:
                    lvl.u, err, taken = self._smooth(lvl, ins.steps)
                    nodes.append(self._node_report("ascend", n, err, taken))
            else:
                raise TypeError(f"unknown instruction {ins!r}")

            if cfg.collect_node_stats:
                logger.info("%s", nodes[-1])

        final = levels[-1]
        synchronize(self.device)
        wall = time.perf_counter() - start

        err_vs_analytic = None
        if self.problem.analytic is not None:
            ua = self._grid("analytic_grid", final.spec)
            err_vs_analytic = float(stencils.mean_abs_error(final.u, ua))
        return SolveReport(u=final.u, spec=final.spec, wall_time_s=wall,
                           nodes=nodes, error_vs_analytic=err_vs_analytic)

    def _smooth(self, lvl: Level, steps: int):
        """Fixed-step or trigger smoothing; returns (u, err, steps_taken)."""
        cfg = self.config
        h = lvl.spec.h
        if steps != -1:
            u, err = stencils.smooth(lvl.u, lvl.f, h, steps=steps, omega=cfg.omega,
                                     compat=cfg.compat_error, smoother=cfg.smoother)
            return u, err, steps

        def step(u):
            u_new = (stencils.jacobi_sweep(u, lvl.f, h, cfg.omega)
                     if cfg.smoother == "jacobi" else stencils.redblack_gs_sweep(u, lvl.f, h))
            if cfg.compat_error == "gpu":
                return u_new, stencils.gpu_smoothing_error(u_new, u, h)
            return u_new, stencils.smoothing_error(u_new, lvl.f, h, compat=cfg.compat_error)

        return trigger_loop(step, lvl.u, cfg.trigger, cfg.max_trigger_sweeps)

    def _node_report(self, kind: str, n: int, err, steps) -> NodeReport:
        if self.config.collect_node_stats:
            return NodeReport(kind, n, steps=int(steps) if steps is not None else None,
                              error=float(err) if err is not None else None)
        return NodeReport(kind, n)


def solve(problem: Problem, program: CycleProgram,
          config: SolverConfig = SolverConfig(), device="cuda") -> SolveReport:
    """One-call convenience wrapper."""
    return MultigridSolver(problem, config, device).run(program)
