"""Custom Poisson problem + programmatic schedule with the PyTorch port (no Cycle.txt file).

The port's version of ``examples/03_custom_problem.py``. The reference
hardcodes one manufactured problem (reference README.md:272); here problems
are pluggable objects and schedules are first-class Python values.

    python examples/torch_03_custom_problem.py [n] [--device cuda|cpu]

Runs on ``--device`` (default ``cuda``) and never falls back to the CPU.
"""

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import multigrid_poisson_solver_tpu_torch as mg  # noqa: E402
from multigrid_poisson_solver_tpu_torch.models.problems import Problem  # noqa: E402
from multigrid_poisson_solver_tpu_torch.solver import SolverConfig  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=129)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    # u = sin(πx)·sinh(πy)/sinh(π): harmonic, nonzero Dirichlet boundary
    def boundary(x, y):
        return torch.sin(math.pi * x) * torch.sinh(math.pi * y) / math.sinh(math.pi)

    problem = Problem(source=lambda x, y: torch.zeros_like(x),
                      boundary=boundary, analytic=boundary,
                      name="laplace-sinh")

    # W-cycle on an odd-halved (2:1-aligned) hierarchy with red-black GS
    # smoothing + full-weighting restriction: the fastest-converging combo
    program = mg.w_cycle(args.n, n_min=5, steps=2, coarse_option=0, coarsen=3)
    config = SolverConfig(smoother="rbgs", restriction="full_weighting")

    report = mg.solve(problem, program, config, device=args.device)
    print(f"W-cycle error vs analytic: {report.error_vs_analytic:.3e}")

    deep = mg.solve_to_tolerance(problem, args.n, tol=1e-10, program=program,
                                 config=config, device=args.device)
    print(f"refined to {deep.rel_residual:.3e} in {deep.cycles} cycles; "
          f"error {deep.error_vs_analytic:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
