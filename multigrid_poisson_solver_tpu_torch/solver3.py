"""The interpreted 3-D schedule engine: a CycleProgram on a cubic hierarchy.

PyTorch port of ``multigrid_poisson_solver_tpu/solver3.py``. The schedule
grammar is dimension-agnostic, so the same parsed programs drive this engine;
node semantics follow the 2-D ``MultigridSolver`` one dimension up:

  * Descend: (re-zero the correction unless warm finest / FMG) → smooth →
    restrict the negated residual through the general trilinear ``zoom3``
    (or full weighting on 2:1 levels);
  * CoarseSolve: option 0 the dense cached-inverse solve, options 1/2
    red-black GS to the target (float64 for option 1, float32 for 2);
  * Ascend: zoom3-prolong and add into the parent's interior → post-smooth;
  * steps == −1: error-triggered smoothing.

It runs the oracle ops only, one node at a time with per-node reports
(``compiled3`` is the fast engine). compat=True maps to the clean mean
|residual| metric (the 2-D reference's color bug is 2-D-specific);
compat="gpu" keeps |ΔU|·6/h².
"""

from __future__ import annotations

import time

import torch

from .grid import GridSpec
from .models import poisson3d as p3
from .models.poisson3d import Problem3D
from .ops.zoom import zoom3
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import Level, NodeReport, SolveReport, SolverConfig, logger, synchronize


def _restrict_residual3(u, f, h: float, m: int, restriction: str = "sampling"):
    """residual → negate → restriction onto (m, m, m) → zero boundary."""
    d = p3.residual3(u, f, h)
    n = u.shape[0]
    if restriction == "full_weighting":
        if n != 2 * m - 1:
            raise ValueError(
                f"restriction='full_weighting' requires 2:1 vertex-aligned "
                f"levels (n == 2m-1), got {n} -> {m}")
        return p3.restrict3(-d, m)
    return zoom3(-d, m, zero_boundary=True)


def _prolong_add3(u_coarse, u_fine, n: int):
    """u_fine + zoom3(u_coarse) on the interior."""
    corr = zoom3(u_coarse, n)
    out = u_fine.clone()
    out[1:-1, 1:-1, 1:-1] = u_fine[1:-1, 1:-1, 1:-1] + corr[1:-1, 1:-1, 1:-1]
    return out


def coarse_solve3(f, h: float, ins: CoarseSolve, dtype, gs_norm: str):
    """The exact solve of a CoarseSolve node: (u, err or None, iterations or None)."""
    if ins.option == 0:
        return p3.dense_solve3(f, h), None, None
    dt = {1: torch.float64, 2: torch.float32}.get(ins.option, dtype)
    u, err, iters = p3.gauss_seidel_solve3(f.to(dt), h, ins.target_error, norm=gs_norm)
    return u.to(dtype), err, iters


def smooth3_node(u, f, h: float, steps: int, cfg: SolverConfig):
    """A smoothing node on the oracle ops: (u, err, sweeps run)."""
    compat = "gpu" if cfg.compat_error == "gpu" else "clean"
    if steps == -1:
        return p3.trigger_smooth3(u, f, h, cfg.trigger, cfg.omega, compat, cfg.smoother,
                                  cfg.max_trigger_sweeps)
    u, err = p3.smooth3(u, f, h, steps, omega=cfg.omega, compat=compat,
                        smoother=cfg.smoother)
    return u, err, steps


class Solver3D:
    """Executes CyclePrograms on 3-D problems under a SolverConfig."""

    def __init__(self, problem: Problem3D, config: SolverConfig = SolverConfig(),
                 device="cuda"):
        self.problem = problem
        self.config = config
        self.device = torch.device(device)

    def _zeros(self, n: int):
        return torch.zeros((n, n, n), dtype=self.config.dtype, device=self.device)

    def _finest_level(self, program: CycleProgram) -> Level:
        spec = GridSpec(program.n_max, program.length, program.min_x, program.min_y)
        dtype = self.config.dtype
        f = (self.problem.source_grid(spec.n, dtype, self.device)
             + self.problem.boundary_grid(spec.n, dtype, self.device))
        u = self.problem.boundary_grid(spec.n, dtype, self.device)
        return Level(spec=spec, u=u, f=f)

    def run(self, program: CycleProgram) -> SolveReport:
        cfg = self.config
        levels: list[Level] = [self._finest_level(program)]
        warm = False
        nodes: list[NodeReport] = []

        synchronize(self.device)
        start = time.perf_counter()
        for ins in program.instructions:
            lvl = levels[-1]
            n, h = lvl.spec.n, lvl.spec.h

            if isinstance(ins, Descend):
                finest = len(levels) == 1
                if not (finest and warm) and not lvl.is_fmg:
                    lvl.u = (self.problem.boundary_grid(n, cfg.dtype, self.device) if finest
                             else self._zeros(n))
                next_spec = lvl.spec.coarsened(ins.next_n)
                if ins.steps == 0:  # FMG descent: restrict the RHS itself
                    f_c = (zoom3(lvl.f, ins.next_n, zero_boundary=True)
                           + self.problem.boundary_grid(next_spec.n, cfg.dtype, self.device))
                    levels.append(Level(spec=next_spec, u=self._zeros(next_spec.n), f=f_c,
                                        is_fmg=True))
                    nodes.append(NodeReport("fmg-descend", n, steps=0))
                    continue
                lvl.u, err, taken = smooth3_node(lvl.u, lvl.f, h, ins.steps, cfg)
                f_c = _restrict_residual3(lvl.u, lvl.f, h, ins.next_n,
                                          restriction=cfg.restriction)
                levels.append(Level(spec=next_spec, u=self._zeros(next_spec.n), f=f_c))
                nodes.append(self._node_report("descend", n, err, taken))

            elif isinstance(ins, CoarseSolve):
                lvl.u, err, iters = coarse_solve3(lvl.f, h, ins, cfg.dtype, cfg.coarse_gs_norm)
                if ins.option == 0:
                    nodes.append(NodeReport("coarse-solve", n, detail="dense"))
                else:
                    rep = self._node_report("coarse-solve", n, err, iters)
                    rep.detail = f"rbgs target={ins.target_error:g}"
                    nodes.append(rep)

            elif isinstance(ins, Ascend):
                if len(levels) < 2:
                    raise RuntimeError("Ascend with no coarser level")
                child = levels.pop()
                lvl = levels[-1]
                n = lvl.spec.n
                lvl.u = _prolong_add3(child.u, lvl.u, n)
                if len(levels) == 1:
                    warm = True
                if ins.steps == 0:
                    nodes.append(NodeReport("ascend", n, steps=0))
                else:
                    lvl.u, err, taken = smooth3_node(lvl.u, lvl.f, lvl.spec.h, ins.steps, cfg)
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
            ua = self.problem.analytic_grid(final.spec.n, cfg.dtype, self.device)
            err_vs_analytic = float(torch.mean(torch.abs(final.u - ua)))
        return SolveReport(u=final.u, spec=final.spec, wall_time_s=wall, nodes=nodes,
                           error_vs_analytic=err_vs_analytic)

    def _node_report(self, kind: str, n: int, err, steps) -> NodeReport:
        if self.config.collect_node_stats:
            return NodeReport(kind, n, steps=int(steps) if steps is not None else None,
                              error=float(err) if err is not None else None)
        return NodeReport(kind, n)


def solve3_program(problem: Problem3D, program: CycleProgram,
                   config: SolverConfig = SolverConfig(), device="cuda") -> SolveReport:
    """One-call convenience wrapper (3-D counterpart of ``solver.solve``)."""
    return Solver3D(problem, config, device).run(program)
