"""Sub-cycle chains with the PyTorch port: a V-cycle's ladder in two kernels.

The port's version of ``examples/05_vmem_chain.py``. For 2:1-aligned
V-shaped schedules the compiled engine runs the whole ladder from 1025²
down as the chain kernels (kernels 6 and 7: ``chain_descend`` and
``chain_ascend``, ``ops/csrc/chain_*.cu``) around the dense coarse solve,
instead of one descend and one ascend launch a level. This example runs
one V(3,3) cycle with the chains on and off (``compiled._match_chain``
patched to match nothing, as the JAX example does) and compares.

    python examples/torch_05_chain.py [n] [--device cuda|cpu]

Runs on ``--device`` (default ``cuda``; the chains are CUDA kernels, so on
the CPU both runs take the plain path) and never falls back to the CPU.
"""

import argparse
import sys
import unittest.mock as mock
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import multigrid_poisson_solver_tpu_torch as mg  # noqa: E402
from multigrid_poisson_solver_tpu_torch import compiled as C  # noqa: E402
from multigrid_poisson_solver_tpu_torch.ops import kernels as K  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=1025)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    program = mg.v_cycle(args.n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    cfg = mg.SolverConfig(omega=0.8, collect_node_stats=False)

    def cycle():
        cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, cfg, device=args.device)
        u, f = cc.init()
        K.reset_launch_counts()
        u, _ = cc(u, f)
        return cc, u, K.launches["chain_descend"] + K.launches["chain_ascend"]

    cc, u_chain, chained = cycle()
    with mock.patch.object(C, "_match_chain", lambda *a, **k: None):
        _, u_plain, unchained = cycle()

    d = float((u_chain - u_plain).abs().max())
    same = bool(torch.equal(u_chain, u_plain))
    print(f"N={args.n}: chain kernel launches {chained} (chains on), {unchained} (off)")
    print(f"N={args.n}: chain vs per-level engine maxdiff = {d} "
          f"({'BIT-IDENTICAL' if same else 'MISMATCH'})")

    ana = mg.REFERENCE_PROBLEM.analytic_grid(cc.finest_spec, torch.float32, cc.device)
    err = float((cc.unpad(u_chain) - ana).abs().mean())
    print(f"mean|u − analytic| after one V(3,3) cycle: {err:.3e}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
