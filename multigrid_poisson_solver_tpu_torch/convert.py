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


def problem_from_jax(name: str) -> Problem:
    """The built-in problem with this key ("reference") or name
    ("reference-manufactured") in either package."""
    if name in BUILTIN_PROBLEMS:
        return BUILTIN_PROBLEMS[name]
    for problem in BUILTIN_PROBLEMS.values():
        if problem.name == name:
            return problem
    raise KeyError(f"no built-in problem {name!r}")
