"""Chained bf16 cycles and bf16-inner refinement, JAX's package beside the
port, cycle by cycle, on the CPU (not collected by pytest: run it by hand).

    python tests/bf16_witness.py [--cycles 4] [--refine 0] [--f32-arithmetic] N [N ...]

For each N, ``--cycles`` chained bf16 V(3,3) cycles (ω 0.8, coarsen=3, dense
coarse solve) through JAX's XLA engine and through the port's (its kernel
routing, the twins on the CPU): the float64 relative residual and the mean
|u − analytic| after each cycle. With ``--refine C``, C cycles of tw32
refinement with bf16 inner cycles from both packages' solvers: the relative
residual after each. ``--f32-arithmetic`` reruns the port's side with each
bf16 kernel twin computed in float32 on bf16 inputs and its outputs rounded
once (bf16 storage, f32 arithmetic), the contract the port does not use.
"""

import argparse
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import multigrid_poisson_solver_tpu as jmg  # noqa: E402
import multigrid_poisson_solver_tpu_torch as tmg  # noqa: E402
from multigrid_poisson_solver_tpu_torch import compiled  # noqa: E402
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, grid_from_jax,  # noqa: E402
                                                        problem_from_jax_grids, program_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels as K  # noqa: E402
from multigrid_poisson_solver_tpu_torch.ops.transfers import relative_residual_norm  # noqa: E402

BF16 = torch.bfloat16


def _f32_arithmetic(fn):
    """``fn`` on float32 copies of bf16 inputs, each output rounded to bf16."""
    def run(*args, **kw):
        if not any(isinstance(a, torch.Tensor) and a.dtype == BF16 for a in args):
            return fn(*args, **kw)
        out = fn(*(a.float() if isinstance(a, torch.Tensor) else a for a in args), **kw)
        cast = lambda o: o.to(BF16) if isinstance(o, torch.Tensor) else o  # noqa: E731
        return tuple(map(cast, out)) if isinstance(out, tuple) else cast(out)
    return run


def chained(n, cycles):
    """{package: (relative residuals, mean errors)} after each chained cycle."""
    jprogram = jmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(dtype=jnp.bfloat16, omega=0.8, kernels="xla",
                            collect_node_stats=False)
    program, cfg = program_from_jax(jprogram), config_from_jax(jcfg)
    h = 1.0 / (n - 1)
    ua = grid_from_jax(jmg.REFERENCE_PROBLEM.analytic_grid(jmg.GridSpec(n), jnp.float32),
                       n).double()
    runs = {"jax": (jmg.compile_program(jprogram, jmg.REFERENCE_PROBLEM, jcfg, donate=False),
                    jmg.compile_program(jprogram, jmg.REFERENCE_PROBLEM, jcfg, donate=False,
                                        warm=True), lambda a: grid_from_jax(a, n)),
            "port": (tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu"),
                     tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu",
                                         warm=True), lambda a: a)}
    out = {}
    for who, (cold, warm, to_th) in runs.items():
        u, f = cold.init()
        rels, errs = [], []
        for c in range(cycles):
            u, _ = (cold if c == 0 else warm)(u, f)
            ut = to_th(u).double()
            rels.append(float(relative_residual_norm(ut, to_th(f).double(), h)))
            errs.append(float((ut - ua).abs().mean()))
        out[who] = (rels, errs)
    return out


def refined(n, cycles):
    """{package: relative residual after each tw32 cycle with bf16 inner cycles}."""
    js = jmg.refine.IterativeRefinementSolver(jmg.REFERENCE_PROBLEM, n, max_cycles=cycles,
                                              state="tw32", inner_dtype=jnp.bfloat16)
    f = js.init_rhs()
    u0, u1 = js.initial_state()
    u2, jax_rels = jnp.zeros_like(u0), []
    for _ in range(cycles):
        u0, u1, u2, rel, _ = js._run(u0, u1, u2, f, 0.0, 1)
        jax_rels.append(float(rel))
    problem = problem_from_jax_grids(jmg.REFERENCE_PROBLEM, jmg.GridSpec(n))
    ts = tmg.IterativeRefinementSolver(problem, n, state="tw32", inner_dtype=BF16,
                                       device="cpu")
    f, words, port_rels = ts.init_rhs(), ts._fresh(), []
    for _ in range(cycles):
        words, rel, _ = ts._words(words, f, 0.0, 1)
        port_rels.append(float(rel))
    return {"jax": jax_rels, "port": port_rels}


def _row(values, fmt="{:.3e}"):
    return ", ".join(fmt.format(v) for v in values)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="+", type=int)
    p.add_argument("--cycles", type=int, default=4)
    p.add_argument("--refine", type=int, default=0)
    p.add_argument("--f32-arithmetic", action="store_true")
    args = p.parse_args(argv)
    # the kernel routing (the twins on CPU tensors), as the card runs it
    compiled._use_kernels = lambda cfg, device: True
    if args.f32_arithmetic:
        for name in ("fused_jacobi", "fused_jacobi_err", "residual", "fused_descend",
                     "fused_ascend"):
            setattr(K, name, _f32_arithmetic(getattr(K, name)))
    for n in args.sizes:
        if args.cycles:
            for who, (rels, errs) in chained(n, args.cycles).items():
                print(f"{n}² {who} chained bf16 V(3,3): rel. residual {_row(rels)}; "
                      f"mean|u − analytic| {_row(errs)}", flush=True)
        if args.refine:
            for who, rels in refined(n, args.refine).items():
                print(f"{n}² {who} tw32, bf16 inner cycles: {_row(rels, '{:.2e}')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
