"""The port's sharded cycles across processes: 2 gloo processes with 2 CPU
mesh entries each against 1 process with 4 entries on the same logical mesh.

The counterpart of tests/test_multihost_proc.py. The programs are those of
``examples/torch_multihost_cpu.py`` (its ``CPU_SPECS``): JAX's example's
block-sharded V(3,3) at 129² on the 2×2 ``hybrid_block_mesh``, a
row-sharded trigger V-cycle at 129², ``compile_program3`` V(3,3) at 65³
(coarsen=3, ω 6/7) and ``v_cycle3_sharded`` on a z ring of 4 entries across
both processes, each on the plain per-shard ops and through the shard-mode
kernels' twins; and refinement to a tolerance under the block policy. Every
owned block (SHA-256), error, trigger stop sweep and the sharded layer's
counters are the one-process run's, bit for bit.

The worker processes start once for the file (``multihost.spawn``: a
``file://`` rendezvous in the test's temporary directory, one intra-op
thread, a 120 s deadline after which they are killed). The one-process run
is also held against JAX's engines under the same policies, to the
tolerances of tests/test_torch_shard.py::test_engine_under_policy_matches_jax.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
from multigrid_poisson_solver_tpu.compiled import compile_program as jcompile_program
from multigrid_poisson_solver_tpu.compiled3 import compile_program3 as jcompile_program3
from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.parallel import pallas_shard3 as jps3
from multigrid_poisson_solver_tpu.parallel.mesh import (BlockShardingPolicy as JBlock,
                                                        ShardingPolicy as JRows,
                                                        make_mesh as jmake_mesh,
                                                        make_mesh_2d as jmake_mesh_2d)

import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
from multigrid_poisson_solver_tpu_torch.parallel import multihost

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import torch_multihost_cpu as runner  # noqa: E402

U_RTOL, U_ATOL, ERR_RTOL = 1e-4, 1e-6, 1e-3   # test_engine_under_policy_matches_jax's

SPECS = dict(runner.CPU_SPECS)
SPECS.update({f"{name} twins": {**spec, "twins": True} for name, spec in runner.CPU_SPECS.items()})
SPECS["refine2d"] = {"kind": "refine2d", "n": 65, "threshold": 8, "tol": 1e-9}
NAMES = list(SPECS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = runner.run_programs(SPECS, ["cpu"] * 4, keep=True)
    finally:
        torch.set_num_threads(prev)
    init = tmp_path_factory.mktemp("rendezvous") / "init"
    each = multihost.spawn(runner.worker, 2, (SPECS, 2, "cpu"), init_file=str(init),
                           timeout=120, threads=1)
    return one, each


@pytest.mark.parametrize("name", NAMES)
def test_two_processes_bit_match_one(runs, name):
    one, each = runs
    multi = runner.merge(each)
    assert runner.compare({name: one[name]}, {name: multi[name]}) == {name: []}
    a, b = one[name], multi[name]
    assert b["processes"] == 2 and a["processes"] == 1
    assert a["mesh"] == b["mesh"]
    # every block is owned by exactly one process, and each owns its own
    owned = [set(r[name]["blocks"]) for r in each]
    if name != "refine2d":
        assert not owned[0] & owned[1] and owned[0] | owned[1] == set(a["blocks"])
        assert all(len(o) == 2 for o in owned)
    assert all(e is None or np.isfinite(e) for e in a["errs"])
    assert not any(r[name]["launches"] for r in each)        # CPU tensors: the twins


def test_counters_split_traffic_by_process(runs):
    """The processes move between them what the one-process run copied
    between shards of the other row: the same pieces and bytes, a share of
    them in messages; gathers receive the other process's half."""
    one, each = runs
    c1, c2 = one["block2d twins"]["counts"], each[0]["block2d twins"]["counts"]
    for n, c in c2.items():
        assert c1[n]["xproc_pieces"] == c1[n]["messages"] == c1[n]["gather_xproc_bytes"] == 0
        assert 0 < c["xproc_pieces"] < c["pieces"] and c["messages"] > 0 or not c["pieces"]
        if c["gathers"]:
            assert c["gather_xproc_bytes"] == c["gather_bytes"]   # 2 processes, half each


def test_trigger_stops_agree(runs):
    one, each = runs
    for name in ("trigger2d", "trigger2d twins"):
        sweeps = one[name]["sweeps"]
        assert sweeps and all(s > 0 for _, s in sweeps)
        assert all(r[name]["sweeps"] == sweeps for r in each)


def test_refinement_across_processes(runs):
    """Refinement under a policy runs across processes: the state lives
    whole on every process and ends bit for bit the one-process state."""
    one, each = runs
    a = one["refine2d"]
    assert a["errs"][0] <= 1e-9 and a["sweeps"][0] > 1
    for r in each:
        assert r["refine2d"]["blocks"] == a["blocks"]
        assert r["refine2d"]["errs"] == a["errs"] and r["refine2d"]["sweeps"] == a["sweeps"]


def _jcfg(spec):
    kw = {k: v for k, v in spec["config"].items()}
    return jmg.SolverConfig(kernels="xla", collect_node_stats=False, **kw)


@pytest.mark.parametrize("name", ["block2d", "trigger2d"])
def test_one_process_matches_jax(runs, name):
    one, _ = runs
    spec = SPECS[name]
    program = jmg.v_cycle(spec["n"], **spec["program"])
    devs = jax.devices()[:4]
    if name == "block2d":
        jpol = JBlock(jmake_mesh_2d((2, 2), devs), threshold_rows=spec["threshold"])
    else:
        jpol = JRows(jmake_mesh(devs), threshold_rows=spec["threshold"])
    cc = jcompile_program(program, jmg.REFERENCE_PROBLEM, _jcfg(spec), policy=jpol, donate=False)
    ju, jf = cc.init()
    ju1, jerr = cc(ju, jf)
    want = np.asarray(cc.unpad(ju1))[:spec["n"], :spec["n"]]
    for variant in (name, f"{name} twins"):
        got = one[variant]
        np.testing.assert_allclose(got["u"], want, rtol=U_RTOL, atol=U_ATOL)
        assert got["errs"][0] == pytest.approx(float(jerr), rel=ERR_RTOL)
    if name == "block2d":
        assert 0.01 < one[name]["errs"][0] < 0.05        # JAX's example's check at 129²


def test_one_process_matches_jax_3d(runs):
    one, _ = runs
    spec = SPECS["compiled3"]
    n = spec["n"]
    program = jmg.v_cycle(n, **spec["program"])
    mesh_z = jps3.make_mesh_z(jax.devices()[:4])
    zpol = jps3.ZShardingPolicy3(mesh_z, threshold_planes=spec["threshold"])
    with mesh_z:
        cc = jcompile_program3(program, jp3.REFERENCE_PROBLEM_3D, _jcfg(spec), policy=zpol)
        u3, f3 = cc.init()
        o3, err3 = cc(u3, f3)
    want = np.asarray(cc.unpad(o3)) if hasattr(cc, "unpad") else np.asarray(o3)
    want = want[:n, :n, :n]
    for variant in ("compiled3", "compiled3 twins"):
        got = one[variant]
        np.testing.assert_allclose(got["u"], want, rtol=U_RTOL, atol=U_ATOL)
        assert got["errs"][0] == pytest.approx(float(err3), rel=ERR_RTOL)


def test_rdma_refused_across_processes():
    """halo="rdma" on a mesh of two processes raises, naming the ROADMAP
    item (a ring launch needs every shard in one process)."""
    mesh = M.make_mesh_2d((2, 2), ["cpu"] * 4, ranks=(0, 0, 1, 1))
    pol = multihost.block_policy(mesh, threshold_rows=8)
    cfg = tmg.SolverConfig(halo="rdma")
    program = tmg.v_cycle(129, n_min=8, steps=3)
    with pytest.raises(ValueError, match="ROADMAP Queue 2 A1"):
        tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cpu", policy=pol)
    zmesh = M.make_mesh_z(["cpu"] * 4, ranks=(0, 0, 1, 1))
    with pytest.raises(ValueError, match="ROADMAP Queue 2 A1"):
        tmg.compile_program3(tmg.v_cycle(65, n_min=5, steps=3), tmg.REFERENCE_PROBLEM_3D, cfg,
                             device="cpu", policy=M.ZShardingPolicy3(zmesh))
    with runner.kernel_twins(), pytest.raises(ValueError, match="ROADMAP Queue 2 A1"):
        u = torch.zeros(65, 65, 65)
        tmg.v_cycle3_sharded(u, u, 1 / 64, zmesh, halo="rdma")
    with pytest.raises(ValueError, match="ROADMAP Queue 2 A1"):
        KS3.check_halo3("rdma", zmesh)
    KS3.check_halo3("ppermute", zmesh)            # the exchange path is taken
