"""Carry state, programs and policies over from the JAX package.

No counterpart in the JAX package. These helpers let one test feed both
packages the same thing. They read the JAX objects by duck typing (class
names, attributes and numpy conversion), so this module imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.problems import BUILTIN_PROBLEMS, Problem
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import SolverConfig

_KERNELS = {"auto": "auto", "pallas": "cuda", "xla": "torch"}
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def grid_from_jax(padded, n: int, device="cpu") -> torch.Tensor:
    """The true (n, n) grid of a JAX level array in its padded tile layout
    (the top-left corner; ``ops/layout.py::unpad_grid``)."""
    arr = np.asarray(padded)[:n, :n]
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def words_from_jax(words, n: int, device="cpu") -> tuple[torch.Tensor, ...]:
    """The (n, n) words of a JAX multi-word refinement state (df32 / tw32,
    each word in the padded tile layout)."""
    return tuple(grid_from_jax(w, n, device) for w in words)


def checkpoint_from_jax(state, n: int):
    """A JAX package ``SolverState`` (padded arrays) as the port's, every
    array cropped to (n, n) (``utils.checkpoint.crop_to``)."""
    from .utils.checkpoint import SolverState, crop_to

    def crop(a):
        if a is None:
            return None
        out = crop_to(np.asarray(a), n)
        if out is None:
            raise ValueError(f"array of shape {np.shape(a)} is no layout of a {n}² grid")
        return np.ascontiguousarray(out)

    return SolverState(u=crop(state.u), f=crop(state.f), u_lo=crop(state.u_lo),
                       u_lo2=crop(state.u_lo2), cycle=state.cycle, meta=dict(state.meta or {}))


def program_from_jax(program) -> CycleProgram:
    """The same CycleProgram, built from the JAX package's one."""
    out = []
    for ins in program.instructions:
        kind = type(ins).__name__
        if kind == "Descend":
            out.append(Descend(next_n=ins.next_n, steps=ins.steps))
        elif kind == "CoarseSolve":
            out.append(CoarseSolve(target_error=ins.target_error, option=ins.option))
        elif kind == "Ascend":
            out.append(Ascend(steps=ins.steps))
        else:
            raise TypeError(f"unknown instruction {ins!r}")
    return CycleProgram(length=program.length, min_x=program.min_x, min_y=program.min_y,
                        n_max=program.n_max, instructions=tuple(out))


def config_from_jax(cfg) -> SolverConfig:
    """The same numerical policy; kernels 'pallas'/'xla' map to 'cuda'/'torch'."""
    return SolverConfig(
        dtype=_DTYPES[np.dtype(cfg.dtype).name],
        smoother=cfg.smoother,
        omega=cfg.omega,
        compat_error=cfg.compat_error,
        trigger=cfg.trigger,
        max_trigger_sweeps=cfg.max_trigger_sweeps,
        trigger_batch=cfg.trigger_batch,
        coarse_gs_norm=cfg.coarse_gs_norm,
        collect_node_stats=cfg.collect_node_stats,
        kernels=_KERNELS[cfg.kernels],
        zoom=cfg.zoom,
        restriction=cfg.restriction,
        halo=cfg.halo,
    )


def problem_from_jax_grids(jproblem, jspec) -> Problem:
    """A problem whose fp32 grids on ``jspec``'s grid are the JAX problem's,
    value for value. The two packages evaluate the same formulas, but
    torch's and XLA's fp32 ``exp`` differ by an ulp at a few percent of
    points, which moves a 1e-10 solve's error against the analytic solution
    in its 5th digit; this problem lets a test feed both the same data."""
    def field(kind):
        grid = torch.from_numpy(np.array(getattr(jproblem, kind)(jspec, np.float32)))
        return lambda x, y: grid.to(x.device, x.dtype)

    analytic = field("analytic_grid") if jproblem.analytic is not None else None
    return Problem(source=field("source_grid"), boundary=field("boundary_grid"),
                   analytic=analytic, name=f"{jproblem.name}-grids")


def problem_from_jax(name: str) -> Problem:
    """The built-in problem with this key ("reference") or name
    ("reference-manufactured") in either package."""
    if name in BUILTIN_PROBLEMS:
        return BUILTIN_PROBLEMS[name]
    for problem in BUILTIN_PROBLEMS.values():
        if problem.name == name:
            return problem
    raise KeyError(f"no built-in problem {name!r}")
