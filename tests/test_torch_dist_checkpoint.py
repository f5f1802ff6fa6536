"""The port's torch.distributed.checkpoint manager (utils/dist_checkpoint.py),
the counterpart of the JAX package's OrbaxCheckpointManager.

A solve stopped by ``max_cycles`` and resumed from ``latest()`` by a fresh
solver (and a fresh manager on the same directory) must end bit for bit as
the uninterrupted solve: the same cycle count, words and residual. The
uninterrupted port solve's cycle count equals the JAX package's on the same
fp32 problem data (``convert.problem_from_jax_grids``). Saves keep the cycle
cadence (``every``) and the newest ``keep`` steps, and only committed steps
(``dcp``'s ``.metadata`` written) are read back.
"""

import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu import refine as jrefine
from multigrid_poisson_solver_tpu_torch.convert import problem_from_jax_grids
from multigrid_poisson_solver_tpu_torch.utils.checkpoint import SolverState
from multigrid_poisson_solver_tpu_torch.utils.dist_checkpoint import DistCheckpointManager


@pytest.mark.parametrize("state,n,tol,async_save", [
    ("df32", 65, 1e-10, True),
    ("tw32", 65, 1e-13, True),
    ("f64", 65, 1e-13, True),
    ("tw32", 129, 1e-12, False),
])
def test_resume_is_bit_for_bit_the_uninterrupted_solve(tmp_path, state, n, tol, async_save):
    def solver(**kw):
        return tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n, state=state,
                                             device="cpu", **kw)

    full = solver().solve(tol)
    cut = solver(max_cycles=5)
    with DistCheckpointManager(tmp_path / "ck", every=2, keep=2,
                               async_save=async_save) as mgr:
        rep1 = cut.solve(tol, checkpoints=mgr, checkpoint_chunk=1)
    assert rep1.cycles == 5 and rep1.rel_residual > tol
    mgr2 = DistCheckpointManager(tmp_path / "ck", every=2, keep=2, async_save=async_save)
    assert mgr2.steps() == [2, 4]              # cadence 2, the newest 2 kept
    saved = mgr2.latest()
    assert saved.cycle == 4 and saved.u.shape == (n, n)
    assert (saved.u_lo2 is not None) == (state == "tw32")
    rep2 = solver().solve(tol, checkpoints=mgr2, checkpoint_chunk=1)
    mgr2.close()
    assert rep2.cycles == full.cycles
    assert rep2.rel_residual == full.rel_residual
    assert torch.equal(rep2.u, full.u) and torch.equal(rep2.u_lo, full.u_lo)


def test_uninterrupted_cycles_equal_jax(tmp_path):
    n, tol = 65, 1e-13
    spec = jmg.GridSpec(n)
    full_jax = jrefine.IterativeRefinementSolver(jmg.REFERENCE_PROBLEM, n, state="tw32").solve(tol)
    problem = problem_from_jax_grids(jmg.REFERENCE_PROBLEM, spec)
    with DistCheckpointManager(tmp_path / "ck", every=3) as mgr:
        rep = tmg.IterativeRefinementSolver(problem, n, state="tw32", device="cpu").solve(
            tol, checkpoints=mgr, checkpoint_chunk=3)
    assert rep.cycles == full_jax.cycles and rep.rel_residual <= tol


def test_refine3_resume_is_bit_for_bit(tmp_path):
    tol, n = 1e-11, 17

    def solver(max_cycles):
        return tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, n, max_cycles=max_cycles,
                                        state="tw32", device="cpu")

    full = solver(40).solve(tol)
    with DistCheckpointManager(tmp_path / "ck", every=2) as mgr:
        assert solver(3).solve(tol, checkpoints=mgr, checkpoint_chunk=1).cycles == 3
    with DistCheckpointManager(tmp_path / "ck", every=2) as mgr:
        assert mgr.latest().cycle == 2
        rep = solver(40).solve(tol, checkpoints=mgr, checkpoint_chunk=1)
    assert rep.cycles == full.cycles and rep.rel_residual == full.rel_residual
    assert torch.equal(rep.u, full.u) and torch.equal(rep.u_lo, full.u_lo)


@pytest.mark.parametrize("async_save", [True, False])
def test_cadence_rotation_and_round_trip(tmp_path, rng, async_save):
    u = rng.standard_normal((9, 9)).astype(np.float32)
    f = torch.from_numpy(rng.standard_normal((9, 9)))
    mgr = DistCheckpointManager(tmp_path / "ck", every=3, keep=2, async_save=async_save)
    assert mgr.latest() is None
    saved = [mgr.maybe_save(SolverState(u=u * c, f=f, u_lo=torch.full((9, 9), float(c)),
                                        cycle=c, meta={"schedule": "abc", "tol": 1e-9}))
             for c in range(11)]
    assert saved == [c % 3 == 0 for c in range(11)]
    mgr.wait_until_finished()
    assert mgr.steps() == [6, 9]
    got = mgr.latest()
    assert got.cycle == 9 and got.meta == {"schedule": "abc", "tol": 1e-9}
    np.testing.assert_array_equal(got.u, u * 9)
    assert got.u.dtype == np.float32 and got.f.dtype == np.float64
    np.testing.assert_array_equal(got.f, f.numpy())
    np.testing.assert_array_equal(got.u_lo, np.full((9, 9), 9.0, np.float32))
    assert got.u_lo2 is None
    # a step already committed is not written again
    assert not mgr.maybe_save(SolverState(u=u, f=f, cycle=9))
    mgr.close()


def test_uncommitted_step_is_not_read(tmp_path, rng):
    mgr = DistCheckpointManager(tmp_path / "ck", async_save=False)
    mgr.maybe_save(SolverState(u=rng.standard_normal((5, 5)), f=np.zeros((5, 5)), cycle=1))
    partial = tmp_path / "ck" / "step-00000002"
    partial.mkdir()
    (partial / "__0_0.distcp").write_bytes(b"half a save")
    assert mgr.steps() == [1]
    assert mgr.latest().cycle == 1
