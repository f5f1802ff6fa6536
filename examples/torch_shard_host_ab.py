"""Time the host-bound sharded cycles of two source trees on one card, to
compare the sharded layer's host cost.

    python3 examples/torch_shard_host_ab.py ROOT [ROOT ...]

Each ROOT (a checkout, or an unpacked ``git archive``, holding
``multigrid_poisson_solver_tpu_torch``) runs in a fresh process of its own,
in the order given: list two trees alternating (A B B A) to compare them.
Each process builds ROOT's kernels and times, on one card:

  * ``chip_smoke.py``'s G2 V(3,3): ``v_cycle(4097, n_min=8, steps=3,
    coarsen=3)``, ω 0.8, through ``compile_program`` on a row ring of 8
    shards of ``cuda:0`` (threshold 16, halo ppermute);
  * its H2 ``v_cycle3_sharded`` V(3,3) at 513³ (ω 0.857, n_min 5) on 8
    z-shards of ``cuda:0`` (threshold 8).

Per program, ``ROUNDS`` rounds of ``CYCLES`` warm cycles after one cold
and one warm cycle: the host ms a cycle until the calls return ("host"),
and until the card has finished them ("wall", a synchronize at the round's
end). Prints one JSON line per tree and, last, each tree's medians.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

ROUNDS = 7
CYCLES = {"G2 V(3,3) 4097² 8 row shards": 5, "H2 v_cycle3_sharded 513³ 8 z-shards": 3}


def _rounds(step, u, cycles):
    import torch

    host, wall = [], []
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cycles):
            u = step(u)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3 / cycles)
        wall.append((t2 - t0) * 1e3 / cycles)
    return {"host_ms": host, "wall_ms": wall}


def one(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import multigrid_poisson_solver_tpu_torch as tmg
    from multigrid_poisson_solver_tpu_torch.ops import build
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    assert tmg.__file__.startswith(root), tmg.__file__
    build.load()
    out = {"root": root}
    name = "G2 V(3,3) 4097² 8 row shards"
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16)
    prog = tmg.v_cycle(4097, n_min=8, steps=3, coarse_option=0, coarsen=3)
    cfg = tmg.SolverConfig(collect_node_stats=False, omega=0.8)
    cold = tmg.compile_program(prog, tmg.REFERENCE_PROBLEM, cfg, device="cuda", policy=pol)
    warm = tmg.compile_program(prog, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True,
                               policy=pol)
    u, f = cold.init()
    u = warm(cold(u, f)[0], f)[0]
    out[name] = _rounds(lambda v: warm(v, f)[0], u, CYCLES[name])

    name = "H2 v_cycle3_sharded 513³ 8 z-shards"
    n = 513
    h = 1.0 / (n - 1)
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cuda")
    f = prob.source_grid(n, torch.float32, "cuda") + u0
    pol = M.ZShardingPolicy3(M.make_mesh_z(["cuda:0"] * 8), threshold_planes=8)
    fs = S.as_level(f, pol, n)

    def step(v):
        return tmg.v_cycle3_sharded(v, fs, h, pol.mesh, n_min=5, pre=3, post=3, omega=0.857)

    u = step(step(u0))
    out[name] = _rounds(step, u, CYCLES[name])
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__)
        return 2
    results = []
    for root in argv:
        p = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                           text=True)
        sys.stderr.write(p.stderr[-3000:])
        if p.returncode:
            print(f"{root}: exit {p.returncode}", flush=True)
            return p.returncode
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    for r in results:
        print(r["root"], "; ".join(
            f"{name}: host {statistics.median(r[name]['host_ms']):.3f} "
            f"[{min(r[name]['host_ms']):.3f}-{max(r[name]['host_ms']):.3f}], wall "
            f"{statistics.median(r[name]['wall_ms']):.3f} ms/cycle" for name in CYCLES))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
