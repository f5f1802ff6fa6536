"""The port's 3-D communication model (``utils.scaling_model3``) against what
the sharded layer counts when ``v_cycle3_sharded`` runs.

JAX's tests/test_scaling_model3.py pins its model against the lowered HLO's
collectives; here ``comm_report3`` must equal ``sharded.counts()`` of one
``v_cycle3_sharded`` call exactly, level by level, on the kernel path (the
shard-mode twins on CPU tensors), in one process over several n, ring
sizes (odd ones too), thresholds and sweep counts, and across two gloo
processes. The level list and sharded flags are JAX's ``comm_report3``'s;
the bytes are not, by design: JAX moves whole padded (rp, cp) planes of its
×16/×128 layout, half-height lane-expanded coarse planes and estimated
GSPMD transfers, the port n × n planes of its own windows and gathers.
"""

import sys
from pathlib import Path

import pytest
import torch

from multigrid_poisson_solver_tpu.utils import scaling_model3 as jsm3

import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
from multigrid_poisson_solver_tpu_torch.parallel import multihost
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
from multigrid_poisson_solver_tpu_torch.utils import scaling_model as sm
from multigrid_poisson_solver_tpu_torch.utils import scaling_model3 as sm3

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import torch_multihost_cpu as runner  # noqa: E402

# (n, ring, threshold, pre, post)
CASES = [(65, 4, 8, 3, 3), (65, 2, 8, 3, 3), (65, 8, 8, 3, 3), (65, 3, 8, 3, 3),
         (129, 4, 8, 3, 3), (129, 8, 16, 2, 4), (129, 2, 8, 1, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n,ndev,th,pre,post", CASES)
def test_model_equals_counters_one_process(n, ndev, th, pre, post):
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cpu")
    f = prob.source_grid(n, torch.float32, "cpu") + u0
    with runner.kernel_twins():
        S.reset_counts()
        tmg.v_cycle3_sharded(u0, f, 1.0 / (n - 1), M.make_mesh_z(["cpu"] * ndev), n_min=5,
                             pre=pre, post=post, threshold_planes=th)
    got = S.counts()
    rep = sm3.comm_report3(n, ndev, pre, post, threshold_planes=th)
    assert got and rep.counts() == got
    assert rep.pieces_xproc == rep.messages == 0


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    init = tmp_path_factory.mktemp("rendezvous") / "init"
    spec = {"vcycle3": dict(runner.CPU_SPECS["vcycle3"], twins=True)}
    return runner.merge(multihost.spawn(runner.worker, 2, (spec, 2, "cpu"),
                                        init_file=str(init), timeout=120, threads=1))


def test_model_equals_counters_two_processes(two_processes):
    """A z ring of 4 entries, 2 a process: the model with processes=2 equals
    the counters; the planes crossing the middle of the ring and the
    agglomeration's other half are what crosses processes."""
    n = runner.CPU_SPECS["vcycle3"]["n"]
    rep = sm3.comm_report3(n, 4, threshold_planes=8, processes=2)
    assert rep.counts() == two_processes["vcycle3"]["counts"]
    assert 0 < rep.pieces_xproc < rep.pieces and rep.messages > 0
    assert 0 < rep.gather_bytes_xproc < 2 * rep.gather_bytes


@pytest.mark.parametrize("n,ndev", [(65, 4), (65, 8), (129, 4), (257, 8), (513, 8), (513, 4)])
def test_levels_match_jax(n, ndev):
    jrep = jsm3.comm_report3(n, ndev)
    rep = sm3.comm_report3(n, ndev)
    assert [(lc.n, lc.sharded) for lc in rep.levels] == [(lc.n, lc.sharded)
                                                          for lc in jrep.levels]
    assert rep.exchange_bytes != jrep.ppermute_bytes


def test_strong_scaling_falls_with_more_cards():
    rows = sm3.scaling_table3(30e-3, 513, ndevs=(2, 4, 8))
    effs = [r["efficiency"] for r in rows]
    assert all(0 < e < 1 for e in effs) and effs == sorted(effs, reverse=True)
    weak = sm3.scaling_table3(30e-3, 129, ndevs=(2, 4), mode="weak")
    assert weak[1]["efficiency"] > weak[0]["efficiency"]    # the cube's work grows ×c²
    for r in rows + weak:
        assert r["efficiency_overlap_bound"] >= r["efficiency"]


def test_trigger_loop_model3_structure(monkeypatch):
    small, big = sm3.trigger_loop_model3(129, 8), sm3.trigger_loop_model3(513, 8)
    for r in (small, big):
        assert r["t_sweep_us"] == pytest.approx(r["t_sweep_compute_us"] + r["t_sweep_comm_us"])
    assert big["efficiency"] > small["efficiency"]
    one = sm3.trigger_loop_model3(513, 8, processes=1)
    monkeypatch.setattr(sm, "MESSAGE_S", 10 * sm.MESSAGE_S)
    assert sm3.trigger_loop_model3(513, 8, processes=1) == one      # copies only
    assert sm3.trigger_loop_model3(513, 8)["t_sweep_comm_us"] > big["t_sweep_comm_us"]
