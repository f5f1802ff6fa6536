"""Reference-style run of the PyTorch port: a bundled Cycle.txt schedule, both engines.

The port's version of ``examples/01_reference_style.py``; equivalent of
``./MG_GPU 1 Vcycle.txt`` (reference README.md:130-139).

    python examples/torch_01_reference_style.py [schedules/Vcycle.txt] [--device cuda|cpu]

Runs on ``--device`` (default ``cuda``) and never falls back to the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import multigrid_poisson_solver_tpu_torch as mg  # noqa: E402
from multigrid_poisson_solver_tpu_torch.ops.stencils import mean_abs_error  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("cycle_file", nargs="?", default="schedules/Vcycle.txt")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    program = mg.parse_cycle_path(args.cycle_file)
    print(f"schedule: {args.cycle_file}: N={program.n_max}, "
          f"{len(program.instructions)} instructions")

    # interpreted engine: per-node stats, like the reference's narration
    report = mg.solve(mg.REFERENCE_PROBLEM, program, device=args.device)
    print("[interpreted]", report.summary().replace("\n", " | "))

    # compiled engine: the CUDA kernels on the card
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, device=args.device)
    u, f = cc.init()
    u, err = cc(u, f)
    ua = mg.REFERENCE_PROBLEM.analytic_grid(cc.finest_spec, device=cc.device)
    print(f"[compiled]    Error = {float(mean_abs_error(cc.unpad(u), ua)):.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
