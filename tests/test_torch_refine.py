"""The port's iterative refinement (multigrid_poisson_solver_tpu_torch.refine),
its multi-word residual kernel's twins and its checkpoints, against the JAX
package's.

Tolerances:
  * the multi-word residual twins against JAX's Pallas kernel (interpret
    mode) and ``residual_tw_p``: 1e-6·max|want|, since XLA:CPU may contract
    the final multiply-add (and the port adds the exact rounding error of
    hi·h⁻², which is 0 where h⁻² is a power of two); against a long double
    truth, JAX's own bounds (tests/test_refine.py);
  * df_add and tw_add: exact;
  * solve_to_tolerance: the cycle count equal to JAX's, rel_residual within
    10%, error_vs_analytic to 6 digits. Both packages get the same fp32
    problem data (``convert.problem_from_jax_grids``): torch's and XLA's
    fp32 exp differ by an ulp at a few percent of points, which moves the
    error of a 1e-10 solve in its 5th digit.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu as jmg
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu import cli as jcli
from multigrid_poisson_solver_tpu import refine as jrefine
from multigrid_poisson_solver_tpu.ops import pallas_kernels as pk
from multigrid_poisson_solver_tpu.ops.layout import pad_grid
from multigrid_poisson_solver_tpu.utils import checkpoint as jck
from multigrid_poisson_solver_tpu_torch import cli, refine
from multigrid_poisson_solver_tpu_torch.convert import (checkpoint_from_jax, config_from_jax,
                                                        problem_from_jax_grids, program_from_jax,
                                                        words_from_jax)
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.utils import checkpoint as ck

ROOT = Path(__file__).resolve().parent.parent
PROBLEM = jmg.REFERENCE_PROBLEM
HARMONIC = jmg.models.problems.Problem(
    source=lambda x, y: jnp.zeros_like(x), boundary=lambda x, y: x + y,
    analytic=lambda x, y: x + y, name="harmonic-linear")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _th(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _state_words(rng, n, scales):
    """Refinement-like words: the analytic solution, then noise at each scale,
    the ring zero below the first word."""
    spec = jmg.GridSpec(n)
    words = [np.asarray(PROBLEM.analytic_grid(spec, jnp.float32))]
    for s in scales:
        w = (rng.standard_normal((n, n)) * s).astype(np.float32)
        w[0, :] = w[-1, :] = w[:, 0] = w[:, -1] = 0
        words.append(w)
    return spec, words, np.asarray(PROBLEM.source_grid(spec, jnp.float32))


def _truth(words, f, h):
    U = sum(np.asarray(w, np.longdouble) for w in words)
    t = np.zeros_like(U)
    t[1:-1, 1:-1] = ((U[:-2, 1:-1] + U[2:, 1:-1] + U[1:-1, :-2] + U[1:-1, 2:]
                      - 4 * U[1:-1, 1:-1]) / np.longdouble(h) ** 2
                     - np.asarray(f, np.longdouble)[1:-1, 1:-1])
    return t


@pytest.mark.parametrize("n", [65, 129])
def test_residual_tw_twin_matches_jax(rng, n):
    spec, words, f = _state_words(rng, n, (1e-8, 1e-16))
    got = K.residual_tw_torch(*map(_th, words), _th(f), spec.h).numpy()
    padded = [pad_grid(jnp.asarray(w)) for w in words + [f]]
    for want in (jrefine.residual_tw_p(*padded, spec.h, n),
                 pk.residual_tw_pallas(*padded, n, spec.h, interpret=True)):
        want = np.asarray(want)[:n, :n]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert torch.equal(refine.residual_tw_p(*map(_th, words), _th(f), spec.h), _th(got))


@pytest.mark.parametrize("n", [65, 129])
def test_residual_df_twin_matches_jax_pallas(rng, n):
    spec, words, f = _state_words(rng, n, (1e-8,))
    got = K.residual_df_torch(*map(_th, words), _th(f), spec.h).numpy()
    padded = [pad_grid(jnp.asarray(w)) for w in words + [f]]
    want = np.asarray(pk.residual_df_pallas(*padded, n, spec.h, interpret=True))[:n, :n]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # JAX's residual_df_p form, ported as it is
    want_p = np.asarray(jrefine.residual_df_p(*padded, spec.h, n))[:n, :n]
    np.testing.assert_allclose(refine.residual_df_p(*map(_th, words), _th(f), spec.h).numpy(),
                               want_p, rtol=0, atol=1e-6 * np.abs(want_p).max())


@pytest.mark.parametrize("n,nwords", [(257, 3), (257, 2), (256, 3), (256, 2)])
def test_multiword_residual_matches_long_double_truth(n, nwords):
    """JAX's bounds (tests/test_refine.py): eps relative to the residual plus
    a tiny absolute floor, also on a 256² grid (h⁻² = 65025, not a power of
    two), where the exact product of hi·h⁻² keeps the floor."""
    spec, words, f = _state_words(np.random.default_rng(11), n, (1e-9, 1e-17)[:nwords - 1])
    fn = K.residual_tw_torch if nwords == 3 else K.residual_df_torch
    got = fn(*map(_th, words), _th(f), spec.h).numpy()
    truth = _truth(words, f, spec.h)
    err = np.abs(np.asarray(got, np.longdouble) - truth).max()
    assert err < max(1e-5 * float(np.abs(truth).max()), 1e-12)
    assert err < 1e-7 * float(np.abs(truth).max())


def test_public_residuals_run_the_twins_on_cpu_tensors(rng):
    _, words, f = _state_words(rng, 33, (1e-8, 1e-16))
    u0, u1, u2, ft = (_th(a) for a in words + [f])
    assert torch.equal(K.residual_tw(u0, u1, u2, ft, 1 / 32), K.residual_tw_torch(u0, u1, u2, ft, 1 / 32))
    assert torch.equal(K.residual_df(u0, u1, ft, 1 / 32), K.residual_df_torch(u0, u1, ft, 1 / 32))
    assert K.launches["residual_mw"] == 0


def test_tw_add_exact(rng):
    u0 = rng.standard_normal(200).astype(np.float32)
    u1 = (rng.standard_normal(200) * 1e-8).astype(np.float32)
    u2 = (rng.standard_normal(200) * 1e-16).astype(np.float32)
    e = (rng.standard_normal(200) * 1e-4).astype(np.float32)
    got = refine.tw_add(*map(_th, (u0, u1, u2, e)))
    want = sum(np.asarray(a, np.longdouble) for a in (u0, u1, u2, e))
    np.testing.assert_array_equal(sum(np.asarray(a.numpy(), np.longdouble) for a in got), want)
    for a, b in zip(got, jrefine.tw_add(*map(jnp.asarray, (u0, u1, u2, e)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_df_add_exact(rng):
    hi = rng.standard_normal(100).astype(np.float32)
    lo = (rng.standard_normal(100) * 1e-8).astype(np.float32)
    e = (rng.standard_normal(100) * 1e-4).astype(np.float32)
    nhi, nlo = refine.df_add(*map(_th, (hi, lo, e)))
    want = hi.astype(np.float64) + lo.astype(np.float64) + e.astype(np.float64)
    np.testing.assert_allclose(nhi.numpy().astype(np.float64) + nlo.numpy(), want, rtol=1e-14)
    for a, b in zip((nhi, nlo), jrefine.df_add(*map(jnp.asarray, (hi, lo, e)))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _both(jproblem, n, tol, state="df32", max_cycles=60, jprogram=None, jconfig=None):
    """(port report, JAX report) of the same solve on the same fp32 data."""
    jrep = jrefine.solve_to_tolerance(jproblem, n, tol=tol, program=jprogram, config=jconfig,
                                      max_cycles=max_cycles, state=state)
    spec = jmg.GridSpec(n) if jprogram is None else jmg.GridSpec(
        jprogram.n_max, jprogram.length, jprogram.min_x, jprogram.min_y)
    ours = tmg.solve_to_tolerance(
        problem_from_jax_grids(jproblem, spec), n, tol=tol,
        program=None if jprogram is None else program_from_jax(jprogram),
        config=None if jconfig is None else config_from_jax(jconfig),
        max_cycles=max_cycles, state=state, device="cpu")
    return ours, jrep


def _assert_same_solve(ours, theirs):
    assert ours.cycles == theirs.cycles
    assert ours.rel_residual == pytest.approx(theirs.rel_residual, rel=0.1)
    assert f"{ours.error_vs_analytic:.5e}" == f"{theirs.error_vs_analytic:.5e}"
    assert ours.u.shape == ours.u_lo.shape == (ours.spec.n, ours.spec.n)


@pytest.mark.parametrize("state,tol", [("df32", 1e-10), ("tw32", 1e-10), ("tw32", 1e-13),
                                       ("f64", 1e-12)])
def test_solve_to_tolerance_matches_jax(state, tol):
    ours, theirs = _both(PROBLEM, 129, tol, state, max_cycles=30)
    assert ours.rel_residual <= tol
    _assert_same_solve(ours, theirs)


def test_refine_rbgs_full_weighting_matches_jax():
    jprog = jmg.v_cycle(129, n_min=5, steps=2, coarse_option=0, coarsen=3)
    jcfg = jmg.SolverConfig(smoother="rbgs", restriction="full_weighting")
    ours, theirs = _both(PROBLEM, 129, 1e-10, jprogram=jprog, jconfig=jcfg)
    assert ours.rel_residual <= 1e-10 and ours.cycles <= 9
    _assert_same_solve(ours, theirs)


def test_refine_nonzero_boundary_problem_matches_jax():
    ours, theirs = _both(HARMONIC, 65, 1e-9)
    assert ours.error_vs_analytic < 1e-5
    _assert_same_solve(ours, theirs)


def test_refine_cli_matches_jax_cli_table(capsys):
    """The JAX CLI's deep solves (--tol 1e-10): the same cycles and relative
    residuals; the error to the 4 digits the two packages' fp32 problem data
    share (the test above holds the solver to 6 on shared data)."""
    table = {("Vcycle.txt", "df32"): (16, 7.305191e-11, 2.221315e-07),
             ("Vcycle.txt", "tw32"): (16, 6.920428e-11, 2.221316e-07),
             ("test.txt", "tw32"): (23, 8.104069e-11, 5.718353e-05)}
    for (name, state), (cycles, rel, err) in table.items():
        argv = ["1", str(ROOT / "schedules" / name), "--tol", "1e-10", "--state", state,
                "--quiet", "--no-output", "--device", "cpu"]
        assert cli.main(argv) == 0
        out = capsys.readouterr().out
        m = re.search(r"RelRes = (\S+) after (\d+) cycles\n\s+Error = (\S+)\nTime Used = ", out)
        assert m, out
        assert int(m.group(2)) == cycles
        assert float(m.group(1)) == pytest.approx(rel, rel=0.1)
        assert float(m.group(3)) == pytest.approx(err, rel=1e-4)


def test_refine_cli_solver_on_shared_data_prints_the_jax_cli_digits(capsys):
    """Vcycle.txt tw32 to 1e-10: the JAX CLI in this process, and the port
    CLI's solver on the JAX problem's fp32 data, print the same cycles and
    the same 6 digits of Error."""
    path = ROOT / "schedules" / "Vcycle.txt"
    assert jcli.main(["1", str(path), "--tol", "1e-10", "--state", "tw32", "--quiet",
                      "--no-output", "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"RelRes = \S+ after (\d+) cycles\n\s+Error = (\S+)", out)
    program = tmg.parse_cycle_path(path)
    spec = jmg.GridSpec(program.n_max, program.length, program.min_x, program.min_y)
    rep = tmg.IterativeRefinementSolver(problem_from_jax_grids(PROBLEM, spec), program.n_max,
                                        program=program, state="tw32", device="cpu").solve(1e-10)
    assert rep.cycles == int(m.group(1)) == 16
    assert f"{rep.error_vs_analytic:.6e}" == m.group(2)


def test_inner_bf16_runs_on_the_plain_path_and_is_refused_by_the_kernels(monkeypatch):
    """bf16 inner cycles converge on the plain path, and the kernel route
    admits them for the default fixed-step V(3,3) (kernels 1-4's bf16 modes;
    their twins on CPU tensors, the same iterates as the plain run's fused
    twins) but refuses a program with a trigger node (no bf16 mode of kernels
    8, 9 or the per_sweep pass)."""
    rep = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 65, state="df32", max_cycles=40,
                                        inner_dtype=torch.bfloat16, device="cpu").solve(1e-7)
    assert rep.rel_residual < 1e-7
    monkeypatch.setattr(tmg.compiled, "_use_kernels", lambda cfg, device: True)
    routed = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 65, state="df32",
                                           max_cycles=40, inner_dtype=torch.bfloat16,
                                           device="cpu")
    assert routed._cycle.use_kernels
    rep_k = routed.solve(1e-7)
    assert rep_k.rel_residual < 1e-7 and rep_k.cycles == rep.cycles
    trigger = tmg.v_cycle(65, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    with pytest.raises(TypeError, match="trigger node.*Queue 2 A2"):
        tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 65, program=trigger,
                                      inner_dtype=torch.bfloat16, device="cpu")


def test_schedule_fingerprint_matches_jax():
    for jprog in (jmg.v_cycle(129, n_min=8, steps=3, coarse_option=0, coarsen=3),
                  jmg.parse_cycle_path(ROOT / "schedules" / "Vcycle.txt")):
        assert ck.schedule_fingerprint(program_from_jax(jprog)) == jck.schedule_fingerprint(jprog)


@pytest.mark.parametrize("state,tol", [("tw32", 1e-13), ("f64", 1e-12)])
def test_checkpoint_resume_keeps_all_words(tmp_path, state, tol):
    """A run cut after 4 cycles resumes from its checkpoint to the deep
    target, with every word (the f64 array at full width) saved."""
    mgr = ck.CheckpointManager(tmp_path / "ck")
    s1 = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 65, state=state, device="cpu")
    s1.max_cycles = 4
    rep1 = s1.solve(tol, checkpoints=mgr, checkpoint_chunk=4)
    assert rep1.rel_residual > tol and rep1.cycles == 4
    saved = mgr.latest()
    assert saved.cycle == 4 and saved.u.shape == (65, 65)
    if state == "f64":
        assert saved.u.dtype == np.float64 and saved.u_lo is None
    else:
        assert saved.u_lo2 is not None and saved.u.dtype == np.float32
    rep2 = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 65, state=state,
                                         device="cpu").solve(tol, checkpoints=mgr,
                                                             checkpoint_chunk=6)
    assert rep2.rel_residual <= tol and rep2.cycles > 4
    # a fresh run lands on the same cycle count
    assert rep2.cycles == tmg.IterativeRefinementSolver(
        tmg.REFERENCE_PROBLEM, 65, state=state, device="cpu").solve(tol).cycles


def test_resumes_a_jax_written_checkpoint(tmp_path):
    """JAX saves padded (rows × 16, lanes × 128) words; the port crops them
    and continues the same tw32 state."""
    n, tol = 65, 1e-13
    mgr = jck.CheckpointManager(tmp_path / "ck")
    js = jrefine.IterativeRefinementSolver(PROBLEM, n, state="tw32")
    js.max_cycles = 3
    js.solve(tol, checkpoints=mgr, checkpoint_chunk=3)
    saved = jck.load_checkpoint(mgr.existing()[-1])
    assert saved.u.shape != (n, n)
    mine = checkpoint_from_jax(saved, n)
    assert mine.u.shape == mine.u_lo2.shape == (n, n) and mine.cycle == 3
    np.testing.assert_array_equal(words_from_jax([saved.u], n)[0].numpy(), mine.u)
    spec = jmg.GridSpec(n)
    rep = tmg.IterativeRefinementSolver(problem_from_jax_grids(PROBLEM, spec), n, state="tw32",
                                        device="cpu").solve(
        tol, checkpoints=ck.CheckpointManager(tmp_path / "ck"), checkpoint_chunk=6)
    assert rep.rel_residual <= tol and rep.cycles > 3
    full = jrefine.IterativeRefinementSolver(PROBLEM, n, state="tw32").solve(tol)
    assert rep.cycles == full.cycles


def test_checkpoint_rejects_another_schedule(tmp_path):
    mgr = ck.CheckpointManager(tmp_path / "ck")
    s1 = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, 33, state="df32", device="cpu")
    s1.max_cycles = 2
    s1.solve(1e-12, checkpoints=mgr, checkpoint_chunk=2)
    other = tmg.IterativeRefinementSolver(
        tmg.REFERENCE_PROBLEM, 33, state="df32", device="cpu",
        program=tmg.v_cycle(33, n_min=8, steps=2, coarse_option=0, coarsen=3))
    assert other._resume(mgr.latest()) is None
    assert ck.crop_to(np.zeros((48, 128)), 49) is None
    assert ck.crop_to(np.zeros((48, 128)), 33).shape == (33, 33)
