"""Iterative refinement under a sharding policy (2-D): the port's
``IterativeRefinementSolver(policy=...)`` and ``solve_to_tolerance(policy=...)``
against the JAX package's solver under the same row and block policies on
the virtual 8-device CPU mesh (``convert.policy_from_jax``, as
tests/test_torch_shard.py builds them).

Under a policy both packages run the correction cycle on the mesh and the
plain multi-word residual. The port's cycle runs its plain sharded path, and
with the kernel routing switched on, the shard-mode kernels' twins. Both
packages get the same fp32 problem data (``problem_from_jax_grids``).

Tolerances: the cycle counts are equal; the final relative residuals agree
within REL_TOL, the bound tests/test_torch_refine.py holds the unsharded
solvers to (each residual is within a cycle's contraction of the target,
and the two packages' fp32 cycles round differently); the port's sharded
run is bit for bit its unsharded run (the sharded twins mask by global
index, so every owned cell is the unsharded op's).
"""

import jax
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu.parallel.mesh import (
    BlockShardingPolicy as JBlock,
    ShardingPolicy as JRows,
    make_mesh as jmake_mesh,
    make_mesh_2d as jmake_mesh_2d,
)
from multigrid_poisson_solver_tpu_torch import compiled
from multigrid_poisson_solver_tpu_torch.convert import (config_from_jax, policy_from_jax,
                                                        problem_from_jax_grids, program_from_jax)

REL_TOL = 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jpolicy(kind):
    if kind == "rows-8":
        return JRows(jmake_mesh(), threshold_rows=8)
    if kind == "rows-4":
        return JRows(jmake_mesh(jax.devices()[:4]), threshold_rows=8)
    return JBlock(jmake_mesh_2d((2, 4)), threshold_rows=8)


def _port(n, jprogram, jcfg, state, tol, policy, max_cycles=40):
    spec = jmg.GridSpec(n)
    return tmg.IterativeRefinementSolver(
        problem_from_jax_grids(jmg.REFERENCE_PROBLEM, spec), n,
        program=program_from_jax(jprogram), config=config_from_jax(jcfg),
        max_cycles=max_cycles, state=state, device="cpu", policy=policy).solve(tol)


@pytest.mark.parametrize("kind,n,state,tol", [("rows-8", 129, "tw32", 1e-10),
                                              ("block-2x4", 65, "tw32", 1e-10),
                                              ("rows-4", 65, "df32", 1e-8)])
@pytest.mark.parametrize("routed", [False, True])
def test_refine_under_policy_matches_jax(monkeypatch, kind, n, state, tol, routed):
    jprogram = jmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(omega=0.8, kernels="xla")
    jpol = _jpolicy(kind)
    jrep = jmg.refine.IterativeRefinementSolver(jmg.REFERENCE_PROBLEM, n, program=jprogram,
                                                config=jcfg, policy=jpol, max_cycles=40,
                                                state=state).solve(tol)
    if routed:
        monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    pol = policy_from_jax(jpol)
    rep = _port(n, jprogram, jcfg, state, tol, pol)
    assert rep.rel_residual <= tol and jrep.rel_residual <= tol
    assert rep.cycles == jrep.cycles
    assert rep.rel_residual == pytest.approx(jrep.rel_residual, rel=REL_TOL)
    assert rep.u.shape == (n, n) and rep.u.device == pol.mesh.devices[0]
    np.testing.assert_allclose(rep.u.numpy(), np.asarray(jrep.u), rtol=0,
                               atol=1e-6 * float(np.abs(np.asarray(jrep.u)).max()))
    # the sharded run is the unsharded one bit for bit
    flat = _port(n, jprogram, jcfg, state, tol, None)
    assert rep.cycles == flat.cycles and torch.equal(rep.u, flat.u)
    assert torch.equal(rep.u_lo, flat.u_lo)


def test_solve_to_tolerance_takes_a_policy(monkeypatch):
    """``solve_to_tolerance(policy=...)`` forwards the policy: the
    correction cycles run on the mesh (the sharded levels' kernel entry
    points are reached) and the cycles equal the unsharded call's."""
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS

    calls = []
    orig = KS.sharded_fused_descend
    monkeypatch.setattr(KS, "sharded_fused_descend",
                        lambda *a, **kw: (calls.append(a[0].n), orig(*a, **kw))[1])
    monkeypatch.setattr(compiled, "_use_kernels", lambda cfg, device: True)
    pol = policy_from_jax(_jpolicy("rows-8"))
    rep = tmg.solve_to_tolerance(tmg.REFERENCE_PROBLEM, 65, tol=1e-9, state="tw32",
                                 device="cpu", policy=pol)
    flat = tmg.solve_to_tolerance(tmg.REFERENCE_PROBLEM, 65, tol=1e-9, state="tw32",
                                  device="cpu")
    assert rep.rel_residual <= 1e-9 and rep.cycles == flat.cycles
    assert calls and set(calls) <= {65}
    assert torch.equal(rep.u, flat.u)
