"""Time the bf16 V(3,3) cycle at 4097² (ω 0.8, coarsen=3, dense coarse
solve, warm) of one source tree, to compare two trees on one card.

    python3 examples/torch_bf16_cycle_ab.py ROOT

ROOT is a checkout (or an unpacked ``git archive``) holding
``multigrid_poisson_solver_tpu_torch``; its kernels are built from ROOT's
sources. Prints the cycle's ms by CUDA events (median, min and max of 7
rounds of 10 cycles), its kernels' device ms a cycle (torch.profiler, 5
cycles) and the 2049² bf16 descend leg from zero (3 sweeps, sampling, as the
cycle calls it) on each route. Compare two trees in one call, a process a
side, alternating (A, B, B, A).
"""

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


def timed(fn, reps=10, rounds=7):
    """(median, min, max) ms a call over ``rounds`` of ``reps`` calls."""
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
    return statistics.median(out), min(out), max(out)


n = 4097
program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, dtype=torch.bfloat16)
cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
u, f = cold.init()
u, _ = cold(u, f)
print(os.path.basename(root), "bf16 V(3,3) cycle ms (median, min, max):",
      timed(lambda: warm(u, f)), flush=True)
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as p:
    for _ in range(5):
        warm(u, f)
    torch.cuda.synchronize()
# the kernels' own rows (an operator's row repeats its kernels' time)
rows = [(e.device_time_total / 5, e.count // 5, e.key[:70]) for e in p.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
for d, c, k in sorted(rows, reverse=True)[:12]:
    print(f"   {d / 1e3:8.4f} ms/cycle  x{c}  {k}")
print("   kernels' device ms a cycle:", sum(r[0] for r in rows) / 1e3, flush=True)
m = 2049
h = 1.0 / (m - 1)
g = torch.Generator(device="cuda").manual_seed(0)
uu, ff = (torch.randn(m, m, device="cuda", generator=g).to(torch.bfloat16) for _ in range(2))
for route in ("tile", "wave"):
    with K.forced_leg_route(route):
        print(f"   2049² descend from_zero {route}: ms",
              timed(lambda: K.fused_descend(uu, ff, h, 3, 0.8, "sampling", True, False, True),
                    reps=20), flush=True)
