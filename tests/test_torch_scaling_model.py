"""The port's 2-D communication model (``utils.scaling_model``) against what
the sharded layer counts when the program runs.

JAX's tests/test_scaling_model.py pins its model against the collectives of
the lowered HLO; the port has no HLO, and ``parallel.sharded``'s counters
take that role. ``comm_report`` must equal ``sharded.counts()`` of one cold
cycle exactly, level by level (pieces and bytes between shards, those
between processes, messages, psums, gathers and their bytes), on the kernel
path (the shard-mode kernels' twins on CPU tensors), in one process over
several n, shard counts, block_cols and thresholds, and across two gloo
processes. Its level list and sharded flags are JAX's ``comm_report``'s for
the same program; its bytes are not, by design: JAX charges its padded
(×16 rows, ×128 lanes) halos of HALO = 8 rows and the lane-expanded coarse
correction, the port the cells of its own windows (8 rows and 8 columns a
pass, 1 for the residual, ``COARSE_HALO`` coarse rows of the correction).
"""

import sys
from pathlib import Path

import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
from multigrid_poisson_solver_tpu.utils import scaling_model as jsm

import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch.convert import program_from_jax
from multigrid_poisson_solver_tpu_torch.parallel import multihost
from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
from multigrid_poisson_solver_tpu_torch.utils import scaling_model as sm

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import torch_multihost_cpu as runner  # noqa: E402

V3 = dict(n_min=8, steps=3, coarse_option=0, coarsen=3)
# (n, shards, block_cols, threshold, config, program, fmg)
CASES = [
    (129, 8, 1, 8, {}, V3, False),
    (129, 8, 4, 8, {}, V3, True),
    (257, 4, 2, 16, {"omega": 0.8}, V3, False),
    (257, 8, 1, 8, {}, dict(V3, coarsen=1), False),
    (129, 4, 2, 8, {}, dict(n_min=8, steps=3, coarse_target=1e-7), False),
    (257, 8, 4, 8, {"smoother": "rbgs"}, dict(V3, steps=2), True),
    (257, 4, 1, 8, {"compat_error": "gpu"}, V3, False),
    (129, 4, 1, 8, {}, dict(V3, steps=9), False),
    (257, 4, 1, 32, {}, V3, True),
]


def _program(n, pk, fmg):
    if fmg:
        return tmg.fmg(n, n_min=8, steps=pk["steps"], coarsen=pk.get("coarsen", 3))
    return tmg.v_cycle(n, **pk)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}-t{c[3]}-{c[6]}")
def test_model_equals_counters_one_process(case):
    n, ndev, bc, th, kw, pk, fmg = case
    prog = _program(n, pk, fmg)
    cfg = tmg.SolverConfig(collect_node_stats=False, **kw)
    with runner.kernel_twins():      # the kernel path: the twins on CPU tensors
        cc = tmg.compile_program(prog, tmg.REFERENCE_PROBLEM, cfg, device="cpu",
                                 policy=sm.make_policy(ndev, th, bc))
        u, f = cc.init()
        S.reset_counts()
        cc(u, f)
    got = S.counts()
    rep = sm.comm_report(prog, ndev, th, bc, config=cfg)
    assert got and rep.counts() == got
    assert rep.pieces_xproc == rep.messages == rep.gather_bytes_xproc == 0


SPECS = {
    "block": dict(runner.CPU_SPECS["block2d"], twins=True,
                  program=V3, config={"omega": 0.8}),
    "rows": dict(runner.CPU_SPECS["trigger2d"], kind="rows2d", twins=True,
                 program=V3, config={"omega": 0.8}),
}


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    init = tmp_path_factory.mktemp("rendezvous") / "init"
    return runner.merge(multihost.spawn(runner.worker, 2, (SPECS, 2, "cpu"),
                                        init_file=str(init), timeout=120, threads=1))


@pytest.mark.parametrize("name,block_cols", [("block", 2), ("rows", 1)])
def test_model_equals_counters_two_processes(two_processes, name, block_cols):
    """2 processes × 2 entries (processes on the row axis): the model with
    processes=2 equals the counters, and its between-process share is what
    crosses the process boundary."""
    spec = SPECS[name]
    prog = tmg.v_cycle(spec["n"], **spec["program"])
    cfg = tmg.SolverConfig(collect_node_stats=False, **spec["config"])
    rep = sm.comm_report(prog, 4, spec["threshold"], block_cols, 2, cfg)
    assert rep.counts() == two_processes[name]["counts"]
    assert 0 < rep.pieces_xproc < rep.pieces and rep.messages > 0
    one = sm.comm_report(prog, 4, spec["threshold"], block_cols, 1, cfg)
    for n, c in one.counts().items():      # the same traffic, split by process
        assert {k: c[k] for k in runner.SHARED_COUNTS} == {
            k: rep.counts()[n][k] for k in runner.SHARED_COUNTS}


@pytest.mark.parametrize("n,ndev,th,bc,pk", [
    (129, 8, 8, 1, V3), (129, 8, 8, 4, V3), (1025, 8, 32, 1, V3), (1025, 8, 32, 4, V3),
    (129, 4, 8, 2, dict(n_min=8, steps=3, coarse_target=1e-7)), (4097, 4, 32, 2, V3)])
def test_levels_match_jax(n, ndev, th, bc, pk):
    """The same levels communicate, with the same sharded flags; the bytes
    differ by design (module docstring)."""
    jprog = jmg.v_cycle(n, **pk)
    jrep = jsm.comm_report(jprog, ndev, threshold_rows=th, block_cols=bc)
    rep = sm.comm_report(program_from_jax(jprog), ndev, th, bc)
    assert [(lc.n, lc.sharded) for lc in rep.levels] == [(lc.n, lc.sharded)
                                                          for lc in jrep.levels]
    assert rep.exchange_bytes != jrep.ppermute_bytes


def test_efficiency_falls_with_more_shards():
    """Strong scaling of a fixed grid: every added shard adds exchanges and
    takes compute away; weak scaling holds up better."""
    strong = sm.multihost_scaling_table(10e-3, n=8193, n_hosts=(1, 2, 4), local_devices=4)
    effs = [r["efficiency"] for r in strong]
    assert all(0 < e < 1 for e in effs) and effs == sorted(effs, reverse=True)
    weak = sm.multihost_scaling_table(10e-3, n=8193, n_hosts=(1, 2, 4), local_devices=4,
                                      mode="weak")
    assert all(w["efficiency"] > s["efficiency"] for w, s in zip(weak[1:], strong[1:]))
    for r in strong + weak:
        assert r["efficiency_overlap_bound"] >= r["efficiency"]
        assert r["t_comm_xproc_ms"] <= r["t_comm_ms"]


def test_scaling_table_weak_ladder():
    """JAX's weak ladder, one process (card) a shard: n_c = (base_n − 1)·c
    + 1, compute t1·c; every shard's halos cross processes, and each row is
    ``predicted_efficiency`` of that program's report."""
    rows = sm.scaling_table(2049, 5e-3, ndevs=(2, 4, 8), threshold_rows=32)
    assert [r["n"] for r in rows] == [4097, 8193, 16385]
    for c, r in zip((2, 4, 8), rows):
        assert r["ndev"] == r["processes"] == c
        assert 0 < r["efficiency"] <= r["efficiency_overlap_bound"] < 1
        assert 0 < r["t_comm_xproc_ms"] <= r["t_comm_ms"]
        assert r["t_compute_ms"] == pytest.approx(5e-3 * c * 1e3)
    want = sm.predicted_efficiency(sm.comm_report(tmg.v_cycle(8193, **V3), 4, 32, 1, 4), 20e-3)
    assert {k: rows[1][k] for k in want} == want


def test_process_attribution():
    """One process: nothing crosses; one process a shard on a row ring:
    every piece between shards is a message's; a hybrid mesh of 2 hosts ×
    4 cards: the row halos cross, the column halos stay, and the same
    traffic over InfiniBand costs more than over NVLink."""
    prog = tmg.v_cycle(257, **V3)
    base = sm.comm_report(prog, 8, 16)
    assert base.pieces_xproc == base.bytes_xproc == base.messages == 0
    ring = sm.comm_report(prog, 8, 16, processes=8)
    assert ring.pieces_xproc == ring.pieces and ring.bytes_xproc == ring.exchange_bytes
    assert 0 < ring.gather_bytes_xproc < 8 * ring.gather_bytes   # 7 of 8 shards' blocks each
    hyb = sm.comm_report(prog, 8, 16, block_cols=4, processes=2)
    assert 0 < hyb.pieces_xproc < hyb.pieces and 0 < hyb.bytes_xproc < hyb.exchange_bytes
    ib = sm.comm_report(prog, 8, 16, block_cols=4, processes=2, link="ib")
    assert ib.t_comm() > hyb.t_comm() > 0


def test_tune_threshold_interior_optimum(monkeypatch):
    """Raising the agglomeration threshold deletes the coarse levels'
    events until their replicated compute costs more: an interior optimum
    (the overheads fixed here, so that the test checks the sweep, not the
    measured constants)."""
    for name, value in (("PIECE_S", 1.3e-4), ("MESSAGE_S", 1.8e-3), ("COLLECTIVE_S", 2.3e-3)):
        monkeypatch.setattr(sm, name, value)
    res = sm.tune_threshold(16385, 0.2, hosts=4, local_devices=4, schedule="v",
                            thresholds=(16, 64, 256, 1024, 4096, 16384))
    ths = [r["threshold_rows"] for r in res["rows"]]
    ts = [r["t_total_ms"] for r in res["rows"]]
    assert res["best"]["threshold_rows"] not in (ths[0], ths[-1])
    assert min(ts) == res["best"]["t_total_ms"] < ts[0]
    assert res["rows"][-1]["t_comm_ms"] == 0           # 16384: every level replicated


def test_trigger_loop_model_structure(monkeypatch):
    """A sweep of a sharded trigger loop pays two exchanges and a psum; the
    share of them falls as the shard grows; in one process only the copies
    cost, across processes the messages and the psum too."""
    small, big = sm.trigger_loop_model(1025, 8), sm.trigger_loop_model(8193, 8)
    for r in (small, big):
        assert r["t_sweep_us"] == pytest.approx(r["t_sweep_compute_us"] + r["t_sweep_comm_us"])
        assert 0 < r["efficiency"] < 1
    assert big["efficiency"] > small["efficiency"]
    one = sm.trigger_loop_model(8193, 8, processes=1)
    monkeypatch.setattr(sm, "MESSAGE_S", 10 * sm.MESSAGE_S)
    monkeypatch.setattr(sm, "COLLECTIVE_S", 10 * sm.COLLECTIVE_S)
    assert sm.trigger_loop_model(8193, 8, processes=1) == one
    assert sm.trigger_loop_model(8193, 8)["t_sweep_comm_us"] > big["t_sweep_comm_us"]
