"""Carry state, programs and policies over from the JAX package.

No counterpart in the JAX package. These helpers let one test feed both
packages the same thing. They read the JAX objects by duck typing (class
names, attributes and numpy conversion), so this module imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.poisson3d import Problem3D
from .models.problems import BUILTIN_PROBLEMS, Problem
from .parallel.mesh import BlockShardingPolicy, Mesh, ShardingPolicy, ZShardingPolicy3
from .parallel.sharded import as_level
from .schedule import Ascend, CoarseSolve, CycleProgram, Descend
from .solver import SolverConfig

_KERNELS = {"auto": "auto", "pallas": "cuda", "xla": "torch"}
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def grid_from_jax(padded, n: int, device="cpu") -> torch.Tensor:
    """The true (n, n) grid of a JAX level array in its padded tile layout
    (the top-left corner; ``ops/layout.py::unpad_grid``)."""
    arr = np.asarray(padded)[:n, :n]
    if arr.dtype.name == "bfloat16":
        # numpy holds JAX's bf16 as ml_dtypes' type, which torch does not
        # read: through float32, exactly
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def grid3_from_jax(padded, n: int, device="cpu") -> torch.Tensor:
    """The true (n, n, n) volume of a JAX 3-D level array, cropped from its
    padded (nz, rp, cp) brick layout (``ops/pallas3d.py::unpad_grid3``)."""
    return torch.from_numpy(np.array(np.asarray(padded)[:n, :n, :n])).to(device)


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


def words3_from_jax(words, n: int, device="cpu") -> tuple[torch.Tensor, ...]:
    """The (n, n, n) words of a JAX 3-D refinement state (df32 / tw32, each
    word in the padded brick layout)."""
    return tuple(grid3_from_jax(w, n, device) for w in words)


def problem3_from_jax_grids(jproblem) -> Problem3D:
    """A 3-D problem whose grids are the JAX ``Problem3D``'s, value for value,
    at every size and float dtype it is asked for (torch's and XLA's fp32
    ``sin`` differ by an ulp at some points, which moves fp32 comparisons of
    whole solves). Each field evaluates the JAX problem's grid of the size
    and dtype of the coordinates it is handed. It keeps the JAX problem's
    name, which a 3-D refinement checkpoint's fingerprint carries."""
    def field(kind):
        def fn(x, y, z):
            dtype = np.float64 if x.dtype == torch.float64 else np.float32
            grid = np.array(getattr(jproblem, kind)(x.shape[0], dtype))
            return torch.from_numpy(grid).to(x.device, x.dtype)
        return fn

    analytic = field("analytic_grid") if jproblem.analytic is not None else None
    return Problem3D(source=field("source_grid"), boundary=field("boundary_grid"),
                     analytic=analytic, name=jproblem.name)


def problem_from_jax(name: str) -> Problem:
    """The built-in problem with this key ("reference") or name
    ("reference-manufactured") in either package."""
    if name in BUILTIN_PROBLEMS:
        return BUILTIN_PROBLEMS[name]
    for problem in BUILTIN_PROBLEMS.values():
        if problem.name == name:
            return problem
    raise KeyError(f"no built-in problem {name!r}")


def policy_from_jax(jax_policy, device="cpu"):
    """The same sharding policy (mesh shape, axis names, threshold) over a
    mesh whose every entry is ``device``: one shard per JAX device."""
    mesh = jax_policy.mesh
    names = tuple(mesh.axis_names)
    sizes = tuple(int(mesh.shape[name]) for name in names)
    ours = Mesh((torch.device(device),) * int(np.prod(sizes)), names, sizes)
    kind = type(jax_policy).__name__
    if kind == "ShardingPolicy":
        return ShardingPolicy(ours, jax_policy.axis_name, jax_policy.threshold_rows)
    if kind == "BlockShardingPolicy":
        return BlockShardingPolicy(ours, jax_policy.row_axis, jax_policy.col_axis,
                                   jax_policy.threshold_rows)
    raise TypeError(f"unknown sharding policy {jax_policy!r}")


def sharded_from_jax(global_padded, policy, n: int, device="cpu"):
    """A JAX level array (padded, sharded or not) as the port's level n under
    ``policy``: unpadded, then split into the policy's blocks (a tensor where
    the level is replicated)."""
    return as_level(grid_from_jax(global_padded, n, device), policy, n)


def policy3_from_jax(jax_policy, device="cpu") -> ZShardingPolicy3:
    """The same z-plane policy (device count, axis name, threshold) over a
    mesh whose every entry is ``device``: one shard per JAX device."""
    if type(jax_policy).__name__ != "ZShardingPolicy3":
        raise TypeError(f"not a z-plane sharding policy: {jax_policy!r}")
    mesh = jax_policy.mesh
    names = tuple(mesh.axis_names)
    sizes = tuple(int(mesh.shape[name]) for name in names)
    ours = Mesh((torch.device(device),) * int(np.prod(sizes)), names, sizes)
    return ZShardingPolicy3(ours, jax_policy.axis_name, jax_policy.threshold_planes)


def sharded3_from_jax(global_padded, policy, n: int, device="cpu"):
    """A JAX 3-D level array (padded, z-padded to its policy depth, sharded or
    not) as the port's level n under ``policy``: cropped to (n, n, n), then
    split into the policy's z blocks (a tensor where the level is
    replicated)."""
    return as_level(grid3_from_jax(global_padded, n, device), policy, n)
