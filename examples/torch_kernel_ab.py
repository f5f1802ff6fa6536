"""Time the port's single-device 2-D kernels of one source tree, to compare
two trees on the same card.

    python3 examples/torch_kernel_ab.py ROOT

ROOT is a checkout (or an unpacked ``git archive``) holding
``multigrid_poisson_solver_tpu_torch``; its kernels are built from ROOT's
sources and timed with CUDA events (median of 5 rounds of 10 calls) at the
main paths' shapes, with one V(3,3) cycle at 4097² (ω 0.8, coarsen=3). It
prints one JSON line of milliseconds. Compare two trees in one process run
each, alternating (A, B, B, A), on one card: a card set below its power
limit, or another card, moves every number.
"""

import json
import os
import statistics
import sys

import torch

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)

import multigrid_poisson_solver_tpu_torch as tmg  # noqa: E402
from multigrid_poisson_solver_tpu_torch.ops import build, kernels as K  # noqa: E402

if not K.__file__.startswith(root):
    sys.exit(f"imported {K.__file__}, not the tree under {root}")
build.build()
build.load()


def timed(fn, reps=10, rounds=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


g = torch.Generator(device="cuda")
g.manual_seed(7)


def rand(m):
    return torch.randn(m, m, generator=g, device="cuda")


n, n8 = 4097, 8193
u, f, uc, h = rand(n), rand(n), rand((n + 1) // 2), 1 / (n - 1)
u8, f8, h8 = rand(n8), rand(n8), 1 / (n8 - 1)
res = {
    "jacobi8_8193": timed(lambda: K.fused_jacobi(u8, f8, h8, 8, 0.8)),
    "jacobi3err_4097": timed(lambda: K.fused_jacobi_err(u, f, h, 3, 0.8, True)),
    "descend_4097": timed(lambda: K.fused_descend(u, f, h, 3, 0.8, "sampling", True, True)),
    "ascend_4097": timed(lambda: K.fused_ascend(u, f, uc, h, 3, 0.8, True, True)),
    "residual_4097": timed(lambda: K.residual(u, f, h)),
    "rbgs2err_4097": timed(lambda: K.fused_rbgs_err(u, f, h, 2, True)),
}
prog = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False)
warm = tmg.compile_program(prog, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
u0, f0 = warm.init()
res["vcycle_4097"] = timed(lambda: warm(u0, f0), reps=5, rounds=3)
print(json.dumps({"root": sys.argv[1], **{k: round(v, 4) for k, v in res.items()}}), flush=True)
