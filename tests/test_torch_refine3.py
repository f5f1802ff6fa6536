"""The port's 3-D iterative refinement (multigrid_poisson_solver_tpu_torch.refine3),
its multi-word residual kernel's twins and its checkpoints, against the JAX
package's (refine3.py, ops/pallas3d.py).

Tolerances:
  * the multi-word residual twins against JAX's Pallas kernel (interpret
    mode) and XLA forms on a 2^k + 1 grid: 1e-6·max|want|, since XLA:CPU may
    contract the final multiply-add (the port's exact rounding error of
    hi·h⁻² is 0 there, h⁻² being a power of two); against a long double
    truth, on a 2^k + 1 grid and on one that is not, the bounds of the 2-D
    test (tests/test_torch_refine.py);
  * solve_to_tolerance3: the cycle count equal to JAX's, rel_residual ≤ tol
    and within 10% of JAX's, error_vs_analytic within 1e-4 relative. Both
    packages get the same fp32 problem data
    (``convert.problem3_from_jax_grids``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu import refine3 as jrefine3
from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.utils import checkpoint as jck
import multigrid_poisson_solver_tpu_torch as tmg
from multigrid_poisson_solver_tpu_torch import cli, refine3
from multigrid_poisson_solver_tpu_torch.convert import problem3_from_jax_grids, words3_from_jax
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.utils import checkpoint as ck

ROOT = Path(__file__).resolve().parent.parent
PROBLEM = jp3.REFERENCE_PROBLEM_3D


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _th(a):
    return torch.from_numpy(np.array(a))


def _state_words(rng, n, scales):
    """Refinement-like words: the analytic solution, then noise at each scale,
    the faces zero below the first word; and the source."""
    words = [np.asarray(PROBLEM.analytic_grid(n, jnp.float32))]
    for s in scales:
        w = np.zeros((n, n, n), np.float32)
        w[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3) * s
        words.append(w)
    return words, np.asarray(PROBLEM.source_grid(n, jnp.float32))


def _truth(words, f, h):
    U = sum(np.asarray(w, np.longdouble) for w in words)
    c = (slice(1, -1),) * 3
    t = np.zeros_like(U)
    t[c] = ((U[:-2, 1:-1, 1:-1] + U[2:, 1:-1, 1:-1] + U[1:-1, :-2, 1:-1] + U[1:-1, 2:, 1:-1]
             + U[1:-1, 1:-1, :-2] + U[1:-1, 1:-1, 2:] - 6 * U[c]) / np.longdouble(h) ** 2
            - np.asarray(f, np.longdouble)[c])
    return t


def test_residual_tw3_twin_matches_jax(rng):
    n, h = 33, 1.0 / 32
    words, f = _state_words(rng, n, (1e-8, 1e-16))
    got = K3.residual_tw3_torch(*map(_th, words), _th(f), h).numpy()
    padded = [jp3k.pad_grid3(jnp.asarray(w)) for w in words + [f]]
    for want in (jrefine3.residual_tw3(*padded, h),
                 jp3k.residual_tw3_pallas(*padded, n, h, interpret=True)):
        want = np.asarray(want)[:n, :n, :n]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert torch.equal(refine3.residual_tw3(*map(_th, words), _th(f), h), _th(got))


def test_residual_df3_twin_matches_jax_pallas(rng):
    n, h = 33, 1.0 / 32
    words, f = _state_words(rng, n, (1e-8,))
    got = K3.residual_df3_torch(*map(_th, words), _th(f), h).numpy()
    padded = [jp3k.pad_grid3(jnp.asarray(w)) for w in words + [f]]
    want = np.asarray(jp3k.residual_df3_pallas(*padded, n, h, interpret=True))[:n, :n, :n]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # JAX's XLA form of the df32 residual, ported as it is (plus the exact
    # product, 0 here)
    want_p = np.asarray(jrefine3.residual_df3(*padded, h))[:n, :n, :n]
    np.testing.assert_allclose(refine3.residual_df3(*map(_th, words), _th(f), h).numpy(),
                               want_p, rtol=0, atol=1e-6 * np.abs(want_p).max())


@pytest.mark.parametrize("n,nwords", [(33, 3), (33, 2), (48, 3), (48, 2)])
def test_multiword_residual3_matches_long_double_truth(n, nwords):
    """JAX's bounds (tests/test_refine.py): eps relative to the residual plus
    a tiny absolute floor, also on a 48³ grid (h⁻² = 2209, not a power of
    two), where the exact product of hi·h⁻² keeps the floor; both forms, the
    kernel's twin and the plain path's."""
    h = 1.0 / (n - 1)
    words, f = _state_words(np.random.default_rng(11), n, (1e-9, 1e-17)[:nwords - 1])
    truth = _truth(words, f, h)
    twin = K3.residual_tw3_torch if nwords == 3 else K3.residual_df3_torch
    plain = refine3.residual_tw3 if nwords == 3 else refine3.residual_df3
    for fn in (twin, plain):
        got = fn(*map(_th, words), _th(f), h).numpy()
        err = np.abs(np.asarray(got, np.longdouble) - truth).max()
        assert err < max(1e-5 * float(np.abs(truth).max()), 1e-12)
        assert err < 1e-7 * float(np.abs(truth).max())


def test_exact_product_keeps_the_floor_off_2k1_grids(monkeypatch, capsys):
    """ROADMAP Queue 3, item 4: without the exact rounding error of
    hi·h⁻² (Dekker's product; XLA's CPU gets it from a contracted FMA) the
    residual of a 48³ tw32 state misses the long double truth by far more
    than its bound, and --dim 3 --tol 1e-10 on test.txt (16³, h⁻² = 225)
    stalls above 1e-9 through the 60-cycle cap instead of reaching 1e-10."""
    monkeypatch.setattr(K, "_two_prod", lambda a, b: (a * b, torch.zeros_like(a * b)))
    n, h = 48, 1.0 / 47
    words, f = _state_words(np.random.default_rng(11), n, (1e-9, 1e-17))
    truth = _truth(words, f, h)
    got = K3.residual_tw3_torch(*map(_th, words), _th(f), h).numpy()
    assert np.abs(np.asarray(got, np.longdouble) - truth).max() > 1e-6 * float(np.abs(truth).max())
    argv = ["1", str(ROOT / "schedules" / "test.txt"), "--dim", "3", "--tol", "1e-10", "--state",
            "tw32", "--device", "cpu", "--quiet", "--no-output"]
    assert cli.main(argv) == 0
    m = re.search(r"Relative residual = (\S+) \((\d+) refinement cycles\)", capsys.readouterr().out)
    assert int(m.group(2)) == 60 and float(m.group(1)) > 1e-9


def test_public_residuals_run_the_twins_on_cpu_tensors(rng):
    words, f = _state_words(rng, 17, (1e-8, 1e-16))
    u0, u1, u2, ft = (_th(a) for a in words + [f])
    K.reset_launch_counts()
    assert torch.equal(K3.residual_tw3(u0, u1, u2, ft, 1 / 16),
                       K3.residual_tw3_torch(u0, u1, u2, ft, 1 / 16))
    assert torch.equal(K3.residual_df3(u0, u1, ft, 1 / 16),
                       K3.residual_df3_torch(u0, u1, ft, 1 / 16))
    assert K.launches["residual_mw3"] == 0


def _both(jproblem, n, tol, state, max_cycles=60, kernels="xla", monkeypatch=None):
    """(port report, JAX report) of the same solve on the same fp32 data; JAX's
    kernels="pallas" runs its Pallas kernels in interpret mode, the port's
    kernel route its twins (the CUDA route forced on CPU tensors)."""
    jrep = jrefine3.solve_to_tolerance3(jproblem, n, tol=tol, max_cycles=max_cycles, state=state,
                                        kernels=kernels)
    if kernels == "pallas":
        monkeypatch.setattr(K, "use_kernels", lambda kernels, device: True)
    ours = tmg.solve_to_tolerance3(problem3_from_jax_grids(jproblem), n, tol=tol,
                                   max_cycles=max_cycles, state=state, device="cpu")
    return ours, jrep


def _assert_same_solve(ours, theirs, tol):
    assert ours.cycles == theirs.cycles
    assert ours.rel_residual <= tol
    assert ours.rel_residual == pytest.approx(theirs.rel_residual, rel=0.1)
    assert ours.error_vs_analytic == pytest.approx(theirs.error_vs_analytic, rel=1e-4)
    assert ours.u.shape == ours.u_lo.shape == (33, 33, 33)


# the JAX package's own cases (tests/test_refine3.py)
@pytest.mark.parametrize("problem,state,tol,max_cycles", [
    (jp3.REFERENCE_PROBLEM_3D, "df32", 1e-9, 60),
    (jp3.REFERENCE_PROBLEM_3D, "tw32", 1e-12, 40),
    (jp3.HARMONIC_PROBLEM_3D, "df32", 1e-8, 60)], ids=["df32", "tw32", "harmonic"])
def test_solve_to_tolerance3_matches_jax(problem, state, tol, max_cycles):
    ours, theirs = _both(problem, 33, tol, state, max_cycles)
    _assert_same_solve(ours, theirs, tol)


@pytest.mark.parametrize("state", ["tw32", "df32"])
def test_refine3_kernel_route_matches_jax_pallas(monkeypatch, state):
    """The kernel route (kernel 14's twin, v_cycle3's kernel path) against
    JAX's kernels="pallas" run (its multi-word residual kernel in interpret
    mode, as tests/test_refine3.py runs it)."""
    ours, theirs = _both(PROBLEM, 33, 1e-9, state, 30, "pallas", monkeypatch)
    _assert_same_solve(ours, theirs, 1e-9)
    assert ours.error_vs_analytic < 4e-3


def test_refine3_kernel_route_reaches_the_kernels(monkeypatch):
    """The kernel route calls the multi-word residual and the inner cycle's
    kernel path; the plain route calls neither."""
    calls = {"residual": 0, "cycle": []}
    real_tw, real_cycle = K3.residual_tw3, refine3.v_cycle3

    def tw(*a):
        calls["residual"] += 1
        return real_tw(*a)

    def cycle(*a, **kw):
        calls["cycle"].append(kw["kernels"])
        return real_cycle(*a, **kw)

    monkeypatch.setattr(K3, "residual_tw3", tw)
    monkeypatch.setattr(refine3, "v_cycle3", cycle)
    tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 17, max_cycles=2, state="tw32",
                             kernels="torch", device="cpu").solve(1e-14)
    assert calls == {"residual": 0, "cycle": ["torch", "torch"]}
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: True)
    rep = tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 17, max_cycles=2, state="tw32",
                                   device="cpu").solve(1e-14)
    assert rep.cycles == 2 and calls["residual"] == 4
    assert calls["cycle"][2:] == ["cuda", "cuda"]


def test_refine3_checks_its_arguments(monkeypatch):
    with pytest.raises(ValueError, match="df32 or tw32"):
        tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 17, state="f64", device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 17, kernels="cuda", device="cpu")
    monkeypatch.setattr(K, "use_kernels", lambda kernels, device: True)
    with pytest.raises(TypeError, match="float32"):
        tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 17, dtype=torch.float64, device="cpu")


def test_refine3_checkpoint_resume_keeps_all_words(tmp_path):
    """A run cut after 4 cycles resumes from its checkpoint to the deep target
    with every word saved, and lands on a fresh run's cycle count."""
    tol = 1e-11
    mgr = ck.CheckpointManager(tmp_path / "ck")
    s1 = tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 33, max_cycles=4, state="tw32",
                                  device="cpu")
    rep1 = s1.solve(tol, checkpoints=mgr, checkpoint_chunk=2)
    assert rep1.cycles == 4 and rep1.rel_residual > tol
    saved = mgr.latest()
    assert saved.cycle == 4 and saved.u.shape == saved.u_lo2.shape == (33, 33, 33)
    rep2 = tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 33, max_cycles=40, state="tw32",
                                    device="cpu").solve(tol, checkpoints=mgr, checkpoint_chunk=5)
    assert rep2.rel_residual <= tol and rep2.cycles > 4
    assert rep2.cycles == tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 33, max_cycles=40,
                                                   state="tw32", device="cpu").solve(tol).cycles
    # a resume at the exhausted budget reports the restored state's residual
    again = tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, 33, max_cycles=4, state="tw32",
                                     device="cpu")
    ck2 = ck.CheckpointManager(tmp_path / "ck2")
    again.solve(tol, checkpoints=ck2, checkpoint_chunk=4)
    rep3 = again.solve(tol, checkpoints=ck2, checkpoint_chunk=4)
    assert rep3.cycles == 4 and rep3.rel_residual == pytest.approx(rep1.rel_residual, rel=1e-3)


def test_resumes_a_jax_written_refine3_checkpoint(tmp_path):
    """JAX's IterativeRefinement3 saves its padded (n, rows × 16, lanes × 128)
    words mid-solve; the port crops them, continues the same tw32 state and
    reaches the tolerance in JAX's total cycle count."""
    n, tol = 33, 1e-11
    mgr = jck.CheckpointManager(tmp_path / "ck")
    jrefine3.IterativeRefinement3(PROBLEM, n, max_cycles=3, state="tw32").solve(
        tol, checkpoints=mgr, checkpoint_chunk=3)
    saved = jck.load_checkpoint(mgr.existing()[-1])
    assert saved.u.shape == jp3k.padded_shape3(n) != (n, n, n) and saved.cycle == 3
    assert ck.crop_to(saved.u, n, dim=3).shape == (n, n, n)
    np.testing.assert_array_equal(words3_from_jax([saved.u_lo2], n)[0].numpy(),
                                  ck.crop_to(saved.u_lo2, n, dim=3))
    rep = tmg.IterativeRefinement3(problem3_from_jax_grids(PROBLEM), n, max_cycles=40,
                                   state="tw32", device="cpu").solve(
        tol, checkpoints=ck.CheckpointManager(tmp_path / "ck"), checkpoint_chunk=6)
    assert rep.rel_residual <= tol and rep.cycles > 3
    full = jrefine3.IterativeRefinement3(PROBLEM, n, max_cycles=40, state="tw32").solve(tol)
    assert rep.cycles == full.cycles


def test_crop_to_takes_both_layouts_in_both_dimensions():
    for dim, padded in ((2, (48, 128)), (3, (33, 48, 128))):
        a = np.arange(np.prod(padded), dtype=np.float32).reshape(padded)
        got = ck.crop_to(a, 33, dim=dim)
        assert got.shape == (33,) * dim
        np.testing.assert_array_equal(got, a[(slice(0, 33),) * dim])
        assert ck.crop_to(got, 33, dim=dim) is got
        assert ck.crop_to(a, 31, dim=dim) is None


# JAX's CLI on test.txt --dim 3 --tol 1e-10 --state tw32 (fp32, CPU): 6
# cycles, Error = 3.101690e-03, relative residual 9.312e-11. The port's own
# problem data differ from XLA's by an ulp of fp32 sin at some points (ROADMAP
# Queue 3, item 3): the bound on Error is 2e-5 relative.
JAX_DIM3_TOL = (6, 3.101690e-03, 9.312e-11)


def test_cli_dim3_tol_matches_jax_cli(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["1", str(ROOT / "schedules" / "test.txt"), "--dim", "3", "--tol", "1e-10",
            "--state", "tw32", "--device", "cpu", "--quiet"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    m = re.search(r"Error = (\S+)\nRelative residual = (\S+) \((\d+) refinement cycles\)\n"
                  r"Time Used = ", out)
    assert m, out
    cycles, err, rel = JAX_DIM3_TOL
    assert int(m.group(3)) == cycles
    assert float(m.group(1)) == pytest.approx(err, rel=2e-5)
    assert float(m.group(2)) <= 1e-10 and float(m.group(2)) == pytest.approx(rel, rel=0.1)
    assert "Output file name = Sol_CPU_test.txt.npz" in out
    with np.load(tmp_path / "Sol_CPU_test.txt.npz") as z:
        assert z["u"].shape == z["u_lo"].shape == (16, 16, 16)
