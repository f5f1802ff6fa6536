"""Deep convergence with the PyTorch port: solve to 1e-10 relative residual in fp32 arithmetic.

The port's version of ``examples/02_deep_solve.py``. The fast path is fp32,
so the solver uses double-float iterative refinement (``refine.py``): fp32
V-cycles on the CUDA kernels inside, a two-word fp32 state outside.

    python examples/torch_02_deep_solve.py [n] [--device cuda|cpu]

Runs on ``--device`` (default ``cuda``) and never falls back to the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import multigrid_poisson_solver_tpu_torch as mg  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=257)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    n = args.n

    report = mg.solve_to_tolerance(mg.REFERENCE_PROBLEM, n, tol=1e-10, device=args.device)
    print(f"N={n}: rel residual {report.rel_residual:.3e} "
          f"after {report.cycles} refinement cycles "
          f"({report.wall_time_s:.2f}s)")
    print(f"error vs analytic: {report.error_vs_analytic:.3e} "
          "(discretization floor)")

    # below the df32 floor: triple-word fp32 state (inner cycles stay fp32)
    deep = mg.solve_to_tolerance(mg.REFERENCE_PROBLEM, n, tol=1e-13,
                                 state="tw32", max_cycles=30, device=args.device)
    print(f"tw32 state: rel residual {deep.rel_residual:.3e} "
          f"after {deep.cycles} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
