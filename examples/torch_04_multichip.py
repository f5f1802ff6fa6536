"""Sharded execution with the PyTorch port: 8 shards of one device.

The port's version of ``examples/04_multichip.py``. The port is
single-controller: a mesh's entries are torch devices and an entry may
repeat, so eight shards on one card are a real ring (each shard its own
buffers and neighbours). The same code runs one shard per card on a mesh
of several cards (``make_mesh()`` takes every CUDA device).

    python examples/torch_04_multichip.py [n] [--device cuda|cpu]

Runs on ``--device`` (default ``cuda``) and never falls back to the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import multigrid_poisson_solver_tpu_torch as mg  # noqa: E402
from multigrid_poisson_solver_tpu_torch.parallel.mesh import (  # noqa: E402
    BlockShardingPolicy, ShardingPolicy, make_mesh, make_mesh_2d,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=257)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    shards = [args.device] * 8

    # 1-D row partition: fine levels sharded, coarse levels replicated
    mesh = make_mesh(shards)
    policy = ShardingPolicy(mesh, threshold_rows=16)
    program = mg.v_cycle(args.n, n_min=8, steps=3)
    cc = mg.compile_program(program, mg.REFERENCE_PROBLEM, policy=policy)
    u, f = cc.init()
    u, err = cc(u, f)
    print(f"row-sharded over {mesh.size} shards of {args.device}: "
          f"finest smoothing error {float(err):.3e}")

    # 2-D block partition
    mesh2 = make_mesh_2d((2, 4), shards)
    policy2 = BlockShardingPolicy(mesh2, threshold_rows=16)
    cc2 = mg.compile_program(program, mg.REFERENCE_PROBLEM, policy=policy2)
    u2, f2 = cc2.init()
    u2, err2 = cc2(u2, f2)
    print(f"block-sharded on mesh {mesh2.shape}: "
          f"finest smoothing error {float(err2):.3e}")

    # deep solve, sharded
    rep = mg.solve_to_tolerance(mg.REFERENCE_PROBLEM, args.n, tol=1e-9,
                                policy=policy, device=args.device)
    print(f"sharded refinement: {rep.rel_residual:.3e} in {rep.cycles} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
