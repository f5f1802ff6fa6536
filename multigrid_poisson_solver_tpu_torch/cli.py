"""Command-line entry point.

PyTorch port of ``multigrid_poisson_solver_tpu/cli.py``, a drop-in for the
reference binaries' invocation (``./MG_GPU N_THREADS cycle_file.txt``):

    python -m multigrid_poisson_solver_tpu_torch [N_THREADS] cycle_file.txt [options]

The thread-count argument is accepted and ignored. Output: the reference's
final-result block (mean |U − analytic| and wall ms) and a
``Sol_GPU_<cyclefile>`` (``Sol_CPU_`` with ``--device cpu``) CSV. The run
uses ``--device`` (default ``cuda``) and never falls back to the CPU.
Deep-solve mode (``--tol``) refines to a relative residual with the cycle
file's program as the inner cycle (``refine.IterativeRefinementSolver``,
ω = 0.8, as JAX's CLI). ``--dim 3`` drives the same schedule through the 3-D
engines (``compiled3``, ``solver3``) and writes ``.npz`` output; its deep
solve (``--dim 3 --tol``) is 3-D iterative refinement
(``refine3.IterativeRefinement3``) at the schedule's finest size, with the
df32 or tw32 state.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import torch

from .models.poisson3d import BUILTIN_PROBLEMS_3D
from .models.problems import BUILTIN_PROBLEMS
from .schedule import parse_cycle_path
from .solver import MultigridSolver, SolveReport, SolverConfig, synchronize
from .utils.io import solution_filename, write_solution_csv

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="multigrid_poisson_solver_tpu_torch",
        description="geometric-multigrid Poisson solver (PyTorch, CUDA kernels)",
    )
    p.add_argument("args", nargs="+",
                   help="[N_THREADS] cycle_file.txt — thread count accepted for "
                        "reference compatibility and ignored")
    p.add_argument("--problem", default="reference",
                   help="built-in problem family (default: the reference's "
                        "manufactured solution); 2-D: " + ", ".join(sorted(BUILTIN_PROBLEMS))
                        + "; 3-D (--dim 3): " + ", ".join(sorted(BUILTIN_PROBLEMS_3D)))
    p.add_argument("--dim", type=int, default=2, choices=[2, 3],
                   help="spatial dimension: 2 (reference-compatible) or 3 (the same "
                        "cycle file drives a cubic hierarchy; .npz output)")
    p.add_argument("--dtype", default="f32", choices=sorted(DTYPES),
                   help="level-array precision (default f32; the CUDA kernels take f32)")
    p.add_argument("--smoother", default="jacobi", choices=["jacobi", "rbgs"])
    p.add_argument("--restriction", default="sampling",
                   choices=["sampling", "full_weighting"],
                   help="restriction operator (rb-GS smoothing needs "
                        "full_weighting, which needs 2:1 vertex-aligned "
                        "levels, e.g. con_N=3 schedules)")
    p.add_argument("--omega", type=float, default=1.0,
                   help="Jacobi damping factor (reference: 1.0; 0.8 converges deeper)")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the schedule this many times (warm restart chaining)")
    p.add_argument("--trigger-batch", default="auto",
                   type=lambda s: s if s == "auto" else int(s),
                   help="trigger sweeps per pass on the kernel path above the "
                        "whole-loop kernels: 'auto' (default; exact sweeps "
                        "first, then batched only in the many-sweep regime), "
                        "1 (always exact) or >1 (always batched: overshoots "
                        "the stop point by up to batch-1 sweeps)")
    p.add_argument("--kernels", default="auto", choices=["auto", "cuda", "torch"],
                   help="hot-path routing: the CUDA kernels (auto = on a CUDA "
                        "device) or plain PyTorch")
    p.add_argument("--halo", default="ppermute", choices=["ppermute", "rdma"],
                   help="sharded halo exchange (no effect on one device)")
    p.add_argument("--trigger", type=float, default=0.01,
                   help="error-trigger slope threshold (reference hardcodes 0.01)")
    p.add_argument("--error-metric", default="cpu", choices=["cpu", "clean", "gpu"],
                   help="trigger-mode smoothing-error metric: cpu (the CPU "
                        "reference's color-bugged sum), clean (mean |residual| "
                        "over the interior), gpu (the GPU reference's "
                        "|dU|*4/h^2 of the final sweep)")
    p.add_argument("--output", default=None,
                   help="solution CSV path (default Sol_GPU_<cyclefile>, "
                        "Sol_CPU_ with --device cpu)")
    p.add_argument("--no-output", action="store_true", help="skip the CSV dump")
    p.add_argument("--quiet", action="store_true", help="suppress per-node narration")
    p.add_argument("--stats", action="store_true",
                   help="print per-node reports (grid size, sweeps, error)")
    p.add_argument("--engine", default="auto", choices=["auto", "interpreted", "compiled"],
                   help="interpreted: per-node dispatch with live stats; "
                        "compiled: the whole-schedule engine with the CUDA kernels "
                        "(auto: compiled unless --stats/per-node narration is on)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solve runs (default cuda)")
    p.add_argument("--tol", type=float, default=None,
                   help="deep-solve mode: iterate mixed-precision refinement "
                        "until the relative residual reaches this tolerance "
                        "(the cycle file's program as the inner cycle, "
                        "omega 0.8; e.g. --tol 1e-10)")
    p.add_argument("--state", default="df32", choices=["df32", "tw32", "f64"],
                   help="refinement state precision for --tol (df32: "
                        "double-float pair, floor ~3e-9 at N=4097; tw32: "
                        "triple-word, reaches 1e-10 at N=8193; f64: float64)")
    p.add_argument("--max-cycles", type=int, default=60,
                   help="refinement cycle cap for --tol")
    p.add_argument("--checkpoint", default=None,
                   help="directory for --tol checkpoints (resumes if present)")
    return p


def _run_refine(problem, program, args):
    """Deep-solve mode (--tol): mixed-precision iterative refinement with
    JAX's policy (config=None: omega 0.8), routed by --kernels."""
    from .refine import IterativeRefinementSolver

    solver = IterativeRefinementSolver(
        problem, program.n_max, program=program,
        config=SolverConfig(omega=0.8, kernels=args.kernels),
        max_cycles=args.max_cycles, state=args.state, device=args.device)
    checkpoints = None
    if args.checkpoint:
        from .utils.checkpoint import CheckpointManager

        checkpoints = CheckpointManager(args.checkpoint)
    return solver.solve(args.tol, checkpoints=checkpoints)


def _run_compiled(problem, program, config, device) -> SolveReport:
    """Execute via the whole-schedule engine (compiled.CompiledCycle)."""
    from .compiled import compile_program
    from .ops.stencils import mean_abs_error

    cc = compile_program(program, problem, config, device=device)
    u, f = cc.init()
    synchronize(cc.device)
    start = time.perf_counter()
    u1, _ = cc(u, f)
    synchronize(cc.device)
    wall = time.perf_counter() - start

    err = None
    if problem.analytic is not None:
        ua = problem.analytic_grid(cc.finest_spec, config.dtype, cc.device)
        err = float(mean_abs_error(u1, ua))
    return SolveReport(u=u1, spec=cc.finest_spec, wall_time_s=wall,
                       nodes=[], error_vs_analytic=err)


def _run_refine3(problem, program, args, cycle_path, prefix) -> int:
    """--dim 3 --tol: 3-D mixed-precision iterative refinement, routed by
    --kernels (JAX's ``cli._run_3d`` deep-solve branch)."""
    import numpy as np

    from .refine3 import IterativeRefinement3

    if args.state == "f64":
        print("[ ERROR ]: --state f64 is 2-D only; the 3-D refinement states are "
              "df32/tw32 (tw32 reaches 1e-10+)", file=sys.stderr)
        return 1
    solver = IterativeRefinement3(problem, program.n_max, max_cycles=args.max_cycles,
                                  state=args.state, kernels=args.kernels, device=args.device)
    checkpoints = None
    if args.checkpoint:
        from .utils.checkpoint import CheckpointManager

        checkpoints = CheckpointManager(args.checkpoint)
    rep = solver.solve(args.tol, checkpoints=checkpoints)
    print()
    print("===== Final Result =====")
    if rep.error_vs_analytic is not None:
        print(f"    Error = {rep.error_vs_analytic:e}")
    print(f"Relative residual = {rep.rel_residual:.3e} ({rep.cycles} refinement cycles)")
    print(f"Time Used = {rep.wall_time_s * 1e3:.3f} (ms)")
    if not args.no_output:
        out = args.output or (solution_filename(cycle_path, prefix) + ".npz")
        np.savez_compressed(out, u=rep.u.cpu().numpy(), u_lo=rep.u_lo.cpu().numpy())
        print(f"Output file name = {out}")
    return 0


def _run_3d(program, config, args, cycle_path, prefix) -> int:
    """--dim 3: the same parsed schedule through the 3-D engines."""
    import numpy as np

    if args.problem not in BUILTIN_PROBLEMS_3D:
        print(f"[ ERROR ]: unknown 3-D problem {args.problem!r} "
              f"(choose from {sorted(BUILTIN_PROBLEMS_3D)})", file=sys.stderr)
        return 1
    problem = BUILTIN_PROBLEMS_3D[args.problem]
    if args.tol is not None:
        return _run_refine3(problem, program, args, cycle_path, prefix)
    engine = args.engine
    if engine == "auto":
        engine = "interpreted" if (args.stats or not args.quiet) else "compiled"

    if engine == "compiled":
        from .compiled3 import compile_program3

        cc = compile_program3(program, problem, config, device=args.device)
        u, f = cc.init()
        synchronize(cc.device)
        start = time.perf_counter()
        u1, _ = cc(u, f)
        synchronize(cc.device)
        wall = time.perf_counter() - start
        err = None
        if problem.analytic is not None:
            ua = problem.analytic_grid(program.n_max, config.dtype, cc.device)
            err = float(torch.mean(torch.abs(u1 - ua)))
        report = SolveReport(u=u1, spec=cc.finest_spec, wall_time_s=wall, nodes=[],
                             error_vs_analytic=err)
    else:
        from .solver3 import Solver3D

        report = Solver3D(problem, config, args.device).run(program)
        if args.stats:
            for node in report.nodes:
                print(f"  {node.kind:<12} N={node.n:<6} steps={node.steps} "
                      f"error={node.error}")
    print()
    print(report.summary())
    if not args.no_output:
        out = args.output or (solution_filename(cycle_path, prefix) + ".npz")
        np.savez_compressed(out, u=report.u.cpu().numpy())
        print(f"Output file name = {out}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    positional = list(args.args)
    if len(positional) == 2 and positional[0].lstrip("-").isdigit():
        print(f"OpenMP threads argument ({positional[0]}) ignored")
        positional = positional[1:]
    if len(positional) != 1:
        print("[ ERROR ]: expected [N_THREADS] cycle_file.txt", file=sys.stderr)
        return 1
    cycle_path = positional[0]
    print(f"Cycle structure file name = {cycle_path}")

    try:
        program = parse_cycle_path(cycle_path)
    except OSError as e:
        print(f"[ ERROR ]: Cannot open file {cycle_path}: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"[ ERROR ]: Bad cycle file: {e}", file=sys.stderr)
        return 1

    if args.repeat > 1:
        from .schedule import repeat as repeat_program

        program = repeat_program(program, args.repeat)

    if not args.quiet:
        logging.basicConfig(level=logging.INFO, format="%(message)s")

    if args.dim == 2 and args.problem not in BUILTIN_PROBLEMS:
        print(f"[ ERROR ]: unknown 2-D problem {args.problem!r} "
              f"(choose from {sorted(BUILTIN_PROBLEMS)})", file=sys.stderr)
        return 1

    if args.smoother == "rbgs" and args.restriction == "sampling":
        print("[ WARNING ]: rb-GS smoothing with sampling restriction "
              "aliases the one-color residual (degraded convergence); "
              "use --restriction full_weighting on a 2:1-aligned schedule",
              file=sys.stderr)

    config = SolverConfig(
        dtype=DTYPES[args.dtype],
        smoother=args.smoother,
        restriction=args.restriction,
        omega=args.omega,
        trigger=args.trigger,
        compat_error={"cpu": True, "clean": False, "gpu": "gpu"}[args.error_metric],
        kernels=args.kernels,
        halo=args.halo,
        trigger_batch=args.trigger_batch,
        collect_node_stats=args.stats or not args.quiet,
    )
    prefix = "Sol_GPU_" if args.device == "cuda" else "Sol_CPU_"
    if args.dim == 3:
        return _run_3d(program, config, args, cycle_path, prefix)
    problem = BUILTIN_PROBLEMS[args.problem]

    if args.tol is not None:
        rep = _run_refine(problem, program, args)
        print()
        print("===== Final Result =====")
        print(f"   RelRes = {rep.rel_residual:.6e} after {rep.cycles} cycles")
        if rep.error_vs_analytic is not None:
            print(f"    Error = {rep.error_vs_analytic:.6e}")
        print(f"Time Used = {rep.wall_time_s * 1e3:.3f} (ms)")
        if not args.no_output:
            out = args.output or solution_filename(cycle_path, prefix)
            write_solution_csv(rep.u, out)
            print(f"Output file name = {out}")
        return 0

    engine = args.engine
    if engine == "auto":
        engine = "interpreted" if (args.stats or not args.quiet) else "compiled"

    if engine == "compiled":
        report = _run_compiled(problem, program, config, args.device)
    else:
        report = MultigridSolver(problem, config, args.device).run(program)
        if args.stats:
            for node in report.nodes:
                print(f"  {node.kind:<12} N={node.n:<6} steps={node.steps} "
                      f"error={node.error}")

    print()
    print(report.summary())

    if not args.no_output:
        out = args.output or solution_filename(cycle_path, prefix)
        write_solution_csv(report.u, out)
        print(f"Output file name = {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
