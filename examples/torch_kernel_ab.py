"""Time the port's single-device 2-D and 3-D kernels of one source tree, to
compare two trees on the same card.

    python3 examples/torch_kernel_ab.py ROOT

ROOT is a checkout (or an unpacked ``git archive``) holding
``multigrid_poisson_solver_tpu_torch``; its kernels are built from ROOT's
sources and timed with CUDA events (median of 5 rounds of 10 calls) at the
main paths' shapes (2-D at 4097² and 8193², 3-D at 513³), with one V(3,3)
cycle at 4097² (ω 0.8, coarsen=3) and one 3-D ``v_cycle3`` V(3,3) at 513³;
then the ring kernels on rings of 8 shards of the card: the 2-D ones at
4097², and, where the tree has them (``ops/rdma3.py``), the 3-D ones at 513³
(the trigger loop at 257³). It prints one JSON line of milliseconds. Compare two trees in one process run
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
from multigrid_poisson_solver_tpu_torch.ops import build, kernels as K, kernels3 as K3  # noqa: E402,E501
from multigrid_poisson_solver_tpu_torch.ops import rdma  # noqa: E402
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M, sharded as S  # noqa: E402

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
ring = S.layout_of(M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16), n)
us, fs = S.shard(u, ring), S.shard(f, ring)
res.update({
    "rdma_jacobi8_4097": timed(lambda: rdma.rdma_jacobi(us, fs, h, 8, 0.8)),
    "rdma_trigger98_4097": timed(lambda: rdma.rdma_trigger(us, fs, h, 0.8, True, 0.0, 98),
                                 reps=3),
})
del u, f, uc, u8, f8, u0, f0, us, fs

n3, w3 = 513, 6.0 / 7.0
h3 = 1 / (n3 - 1)
u3, f3 = (torch.randn(n3, n3, n3, generator=g, device="cuda") for _ in range(2))
c3 = torch.randn((n3 + 1) // 2, (n3 + 1) // 2, (n3 + 1) // 2, generator=g, device="cuda")
res.update({
    "jacobi3_3err_513": timed(lambda: K3.fused_jacobi3_err(u3, f3, h3, 3, w3, "clean")),
    "jacobi3_errs7_513": timed(lambda: K3.fused_jacobi3_errs(u3, f3, h3, 7, w3, "clean"), reps=3),
    "descend3_513": timed(lambda: K3.fused_descend3(u3, f3, h3, 3, w3, want_err=True)),
    "ascend3_513": timed(lambda: K3.fused_ascend3(u3, f3, c3, h3, 3, w3)),
    "residual3_513": timed(lambda: K3.residual3(u3, f3, h3, True)),
})
p3 = tmg.REFERENCE_PROBLEM_3D
b3 = p3.boundary_grid(n3, torch.float32, "cuda")
s3 = p3.source_grid(n3, torch.float32, "cuda") + b3
res["v_cycle3_513"] = timed(lambda: tmg.v_cycle3(b3, s3, h3, n_min=5, pre=3, post=3,
                                                  omega=0.857), reps=3, rounds=3)
if os.path.exists(os.path.join(root, "multigrid_poisson_solver_tpu_torch", "ops", "rdma3.py")):
    from multigrid_poisson_solver_tpu_torch.ops import rdma3  # noqa: E402

    zring = M.ZShardingPolicy3(M.make_mesh_z(["cuda:0"] * 8))
    zu, zf = (S.shard(v, S.layout_of(zring, n3)) for v in (u3, f3))
    zc = S.shard(c3, rdma3.coarse_layout3(zf))
    n15 = 257
    u15, f15 = (torch.randn(n15, n15, n15, generator=g, device="cuda") for _ in range(2))
    zu15, zf15 = (S.shard(v, S.layout_of(zring, n15)) for v in (u15, f15))
    res.update({
        "rdma_jacobi3_3gpu_513": timed(lambda: rdma3.rdma_jacobi3(zu, zf, h3, 3, w3, False,
                                                                  "gpu")),
        "rdma_descend3_513": timed(lambda: rdma3.rdma_descend3(zu, zf, h3, 3, w3, False,
                                                               "full_weighting", True)),
        "rdma_ascend3_513": timed(lambda: rdma3.rdma_ascend3(zu, zf, zc, h3, 3, w3)),
        "rdma_trigger3_98_257": timed(lambda: rdma3.rdma_trigger3(
            zu15, zf15, 1 / (n15 - 1), w3, "clean", 0.0, 98), reps=3),
    })
print(json.dumps({"root": sys.argv[1], **{k: round(v, 4) for k, v in res.items()}}), flush=True)
