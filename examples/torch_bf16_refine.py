"""Print the relative residual after each cycle of tw32 refinement with bf16
correction cycles (``inner_dtype=torch.bfloat16``), beside the fp32 inner
cycles', at several sizes.

    python3 examples/torch_bf16_refine.py [--device cpu|cuda] [--cycles 12] [N ...]

Sizes default to 129 257 513 1025. The default V(3,3) inner cycle (ω 0.8,
coarsen=3, dense coarse solve) runs on the kernels on a CUDA device and on
the plain twins on the CPU: the same function (chip_smoke.py holds the
kernels bit for bit to the twins). A bf16 correction carries its rounding,
2^-9 of |e| at each point, and the operator multiplies that high-frequency
part by about 8/h², so the residual after a correction grows with n.
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import multigrid_poisson_solver_tpu_torch as tmg  # noqa: E402


def residuals(n, inner, cycles, device):
    """The relative residual after each of ``cycles`` cycles."""
    solver = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n, state="tw32",
                                           inner_dtype=inner, device=device)
    f = solver.init_rhs()
    words, out = solver._fresh(), []
    for _ in range(cycles):
        words, rel, _ = solver._words(words, f, 0.0, 1)
        out.append(float(rel))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("sizes", nargs="*", type=int, default=[129, 257, 513, 1025])
    p.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    p.add_argument("--cycles", type=int, default=12)
    args = p.parse_args(argv)
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0))
    for n in args.sizes:
        for label, inner in (("bf16", torch.bfloat16), ("fp32", None)):
            rels = residuals(n, inner, args.cycles, args.device)
            print(f"{n}² {label} inner cycles: " + ", ".join(f"{r:.2e}" for r in rels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
