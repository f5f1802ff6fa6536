"""Run the port's 2-D sharded engine over a mesh of several cards and hold
it against the same shards all on one card, bit for bit.

    python3 examples/torch_multicard_check.py [N]

Needs two or more CUDA devices. For each program (the bench's V(3,3) with
coarsen=3, bench_scaling.py's coarsen=1 program, an rb-GS V(2,2) with full
weighting, and a trigger V-cycle with trigger_batch "auto"; at N², default
2049) and each policy (rows over every card; 2 x k/2 blocks with four or
more cards), one cold and one warm cycle run on the mesh of distinct cards
and on a mesh of as many shards all on cuda:0. The shards and their sums
are the same, so the gathered iterates, errors and trigger stop sweeps must
be equal. Also: halo="rdma" on a mesh of several cards is refused, and the
ring kernels run on a ring of shards all on the last card (not the current
one). Prints one JSON line; exits 1 on any difference.
"""

import json
import sys
import time

import torch

sys.path.insert(0, __file__.rsplit("/examples/", 1)[0])

import multigrid_poisson_solver_tpu_torch as tmg  # noqa: E402
from multigrid_poisson_solver_tpu_torch.ops import kernels as K  # noqa: E402
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M  # noqa: E402

n = int(sys.argv[1]) if len(sys.argv) > 1 else 2049
cards = torch.cuda.device_count()
if cards < 2:
    sys.exit(f"needs two or more CUDA devices, found {cards}")
every = [f"cuda:{k}" for k in range(cards)]

programs = {
    "V(3,3) coarsen=3": (tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3),
                         {"omega": 0.8}),
    "bench_scaling coarsen=1": (tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=1),
                                {}),
    "rb-GS V(2,2) FW": (tmg.v_cycle(n, n_min=8, steps=2, coarse_option=0, coarsen=3),
                        {"smoother": "rbgs", "restriction": "full_weighting"}),
    "trigger auto": (tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3),
                     {"omega": 0.8, "trigger_batch": "auto", "max_trigger_sweeps": 2000}),
}


def policies(devices):
    out = {"rows": M.ShardingPolicy(M.make_mesh(devices), threshold_rows=16)}
    if len(devices) >= 4 and len(devices) % 2 == 0:
        out["block"] = M.BlockShardingPolicy(M.make_mesh_2d((2, len(devices) // 2), devices),
                                             threshold_rows=16)
    return out


def run(program, kw, policy, halo="ppermute"):
    cfg = tmg.SolverConfig(collect_node_stats=False, halo=halo, **kw)
    cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                               policy=policy)
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True,
                               policy=policy)
    cold.trigger_sweeps, warm.trigger_sweeps = [], []
    u0, f = cold.init()
    K.reset_launch_counts()
    for k in range(cards):
        torch.cuda.synchronize(k)
    t0 = time.perf_counter()
    u, err = cold(u0, f)
    u, err = warm(u, f)
    for k in range(cards):
        torch.cuda.synchronize(k)
    ms = (time.perf_counter() - t0) * 1e3 / 2
    return (cold.unpad(u).to("cuda:0"), float(err), cold.trigger_sweeps + warm.trigger_sweeps,
            ms, {k: v for k, v in K.launches.items() if v})


result, ok = {"cards": cards, "n": n, "runs": {}}, True
for pname, (program, kw) in programs.items():
    for tag, pol in policies(every).items():
        many = run(program, kw, pol)
        one = run(program, kw, policies(["cuda:0"] * cards)[tag])
        same = (bool(torch.equal(many[0], one[0])) and many[1] == one[1]
                and many[2] == one[2])
        ok &= same
        result["runs"][f"{pname} {tag}"] = {
            "identical": same, "ms_per_cycle_cards": round(many[3], 3),
            "ms_per_cycle_one_card": round(one[3], 3), "launches": many[4],
            "stop_sweeps": many[2] or None}

program, kw = programs["bench_scaling coarsen=1"]
try:
    run(program, kw, policies(every)["rows"], halo="rdma")
    refused = False
except ValueError:
    refused = True
ok &= refused
last = f"cuda:{cards - 1}"
ring = run(program, kw, policies([last] * 4)["rows"], halo="rdma")
exchange = run(program, kw, policies([last] * 4)["rows"])
ring_ok = ring[4].get("rdma_jacobi", 0) > 0 and bool(torch.equal(ring[0], exchange[0]))
ok &= ring_ok
result.update({"rdma_refused_across_cards": refused,
               f"rdma_ring_on_{last}_matches_exchange": ring_ok, "ok": ok})
print(json.dumps(result), flush=True)
sys.exit(0 if ok else 1)
