"""The port's 3-D kernel module (multigrid_poisson_solver_tpu_torch.ops.kernels3)
against the JAX package's Pallas kernels (ops/pallas3d.py).

On the CPU every public kernel function runs its plain PyTorch twin, so these
tests hold each twin against the Pallas entry point it replaces, run in
interpret mode at 33³ with the VMEM budgets cut so that every call is split
into several bricks (the way tests/test_pallas3d.py forces them), and against
the oracle composition of models.poisson3d in float64. The CUDA kernels are
held against the same twins on the card by chip_smoke.py.

Tolerances (fp32): the Pallas sweep folds the update into u + a·(Σnb − 6u) −
a·h²f while the twin keeps the oracle's u + (ω/6)·((Σnb − 6u) − h²f), so
iterates differ by a few ulps a sweep: |Δu| ≤ 1e-5·max|u|. The restricted
−r of the descend leg is 6/(ωh²) times a Δ formed both ways: 2e-5·max|f_c|.
Error scalars are sums over n³ terms in another order: 1e-4 relative.
Residuals carry the fp32 cancellation noise eps·|u|/h².
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.ops import padded3 as jpd3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3
from multigrid_poisson_solver_tpu_torch.ops import kernels as K
from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
from multigrid_poisson_solver_tpu_torch.ops import transfers3 as T3
from multigrid_poisson_solver_tpu_torch.ops.zoom import zoom3
from multigrid_poisson_solver_tpu_torch.solver3 import _prolong_add3

U_RTOL = 1e-5
FC_RTOL = 2e-5
ERR_RTOL = 1e-4
OMEGA3 = 6.0 / 7.0
N = 33
H = 1.0 / (N - 1)
# VMEM budgets that split a 33³ call into several (z, row) bricks at every
# halo the cases below need (1..8 planes)
SMOOTHER_BUDGET = 1_500_000
LEGS_BUDGET = 3_000_000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def bricks(monkeypatch):
    monkeypatch.setattr(jp3k, "_VMEM_BUDGET_3D_BYTES", SMOOTHER_BUDGET)
    monkeypatch.setattr(jp3k, "_VMEM_BUDGET_3D_LEGS_BYTES", LEGS_BUDGET)


def _data(seed, n=N):
    rng = np.random.default_rng(seed)
    u = np.zeros((n, n, n), np.float32)
    u[1:-1, 1:-1, 1:-1] = rng.standard_normal((n - 2,) * 3)
    f = rng.standard_normal((n, n, n)).astype(np.float32)
    return u, f


def _coarse(seed, m):
    rng = np.random.default_rng(seed)
    c = np.zeros((m, m, m), np.float32)
    c[1:-1, 1:-1, 1:-1] = rng.standard_normal((m - 2,) * 3)
    return c


def _jx(a):
    return jp3k.pad_grid3(jnp.asarray(a))


def _th(a):
    return torch.from_numpy(np.array(a))


def _crop(a, n):
    return np.asarray(a)[:n, :n, :n]


def _assert_close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * float(np.abs(want).max()))


def test_forced_bricks_are_several(bricks):
    """The cut budgets really split the JAX calls: more than one brick in z
    and, for the smoother, in rows, at the smallest and largest halos."""
    nz, rp, cp = jp3k.padded_shape3(N)
    for z_halo in (1, 8):
        zs, rs, _, _ = jp3k._brick_geometry(nz, rp, cp, 4, z_halo=z_halo, num_bufs=6.0)
        assert zs < nz and (rs < rp or z_halo == 1)
    for z_halo in (1, 8):
        zs, _, _, _ = jp3k._brick_geometry(nz, rp, cp, 4, z_halo=z_halo, num_bufs=6.6,
                                           orow_mult=16, oz_even=True,
                                           budget=jp3k._VMEM_BUDGET_3D_LEGS_BYTES)
        assert zs < nz


@pytest.mark.parametrize("steps,from_zero,err_mode", [
    (1, False, "gpu"), (1, True, "clean"), (2, False, "clean"), (3, True, "gpu"),
    (4, False, None), (5, True, None), (6, False, "gpu"), (7, False, "clean"),
    (8, True, "clean"), (8, False, "gpu"), (8, False, None)])
def test_fused_jacobi3_twin_matches_pallas(bricks, steps, from_zero, err_mode):
    u, f = _data(steps)
    want = jp3k.fused_jacobi3_padded(_jx(u), _jx(f), N, H, steps, omega=OMEGA3,
                                     from_zero=from_zero, interpret=True, err_mode=err_mode)
    if err_mode is None:
        got = K3.fused_jacobi3_torch(_th(u), _th(f), H, steps, OMEGA3, from_zero)
        _assert_close(got, _crop(want, N), U_RTOL)
        return
    got_u, got_e = K3.fused_jacobi3_err_torch(_th(u), _th(f), H, steps, OMEGA3, err_mode,
                                              from_zero)
    _assert_close(got_u, _crop(want[0], N), U_RTOL)
    assert float(got_e) == pytest.approx(float(want[1]) / N ** 3, rel=ERR_RTOL)


@pytest.mark.parametrize("steps,from_zero,restriction", [
    (1, False, "full_weighting"), (2, True, "sampling"), (3, False, "sampling"),
    (4, True, "full_weighting"), (5, False, "full_weighting"), (6, False, "full_weighting"),
    (7, True, "full_weighting"), (7, False, "sampling"), (8, True, "sampling"),
    (1, True, "sampling")])
def test_fused_descend3_twin_matches_pallas(bricks, steps, from_zero, restriction):
    u, f = _data(20 + steps)
    m = (N + 1) // 2
    want_u, dwide, raw = jp3k.fused_descend3_padded(
        _jx(u), _jx(f), N, H, steps, omega=OMEGA3, from_zero=from_zero,
        restriction=restriction, interpret=True)
    want_fc = _crop(jpd3.restrict3_lanes_p(dwide, N, m), m)
    got_u, got_fc, got_e = K3.fused_descend3_torch(_th(u), _th(f), H, steps, OMEGA3, from_zero,
                                                   restriction, want_err=True)
    _assert_close(got_u, _crop(want_u, N), U_RTOL)
    _assert_close(got_fc, want_fc, FC_RTOL)
    assert float(got_e) == pytest.approx(float(raw[0, 0]) / N ** 3, rel=ERR_RTOL)


@pytest.mark.parametrize("steps,want_err", [(1, True), (2, False), (3, True), (4, False),
                                            (5, False), (6, True), (7, True), (8, False)])
def test_fused_ascend3_twin_matches_pallas(bricks, steps, want_err):
    u, f = _data(40 + steps)
    m = (N + 1) // 2
    c = _coarse(50 + steps, m)
    cw = jpd3.prolong3_lanes_p(jnp.pad(jnp.asarray(c), [(0, s - m) for s in
                                                        jp3k.padded_shape3(m)]), N, m)
    want = jp3k.fused_ascend3_padded(_jx(u), _jx(f), cw, N, H, steps, omega=OMEGA3,
                                     interpret=True, err_mode="clean" if want_err else None)
    got_u, got_e = K3.fused_ascend3_torch(_th(u), _th(f), _th(c), H, steps, OMEGA3, want_err)
    if want_err:
        _assert_close(got_u, _crop(want[0], N), U_RTOL)
        assert float(got_e) == pytest.approx(float(want[1]) / N ** 3, rel=ERR_RTOL)
    else:
        _assert_close(got_u, _crop(want, N), U_RTOL)
        assert got_e is None


@pytest.mark.parametrize("negate", [False, True])
def test_residual3_twin_matches_pallas(bricks, negate):
    u, f = _data(60)
    want = _crop(jp3k.residual3_pallas(_jx(u), _jx(f), N, H, negate=negate, interpret=True), N)
    got = K3.residual3_torch(_th(u), _th(f), H, negate)
    # the fp32 cancellation noise of a 7-point residual: ~eps·|u|·k/h²
    atol = 12 * 1.2e-7 * float(np.abs(u).max()) / (H * H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


# --- the twins against the oracle composition, float64 --------------------------

def _data64(seed, n=17):
    rng = np.random.default_rng(seed)
    u = torch.zeros((n, n, n), dtype=torch.float64)
    u[1:-1, 1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((n - 2,) * 3))
    return u, torch.from_numpy(rng.standard_normal((n, n, n))), 1.0 / (n - 1)


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("steps,from_zero", [(1, True), (3, False), (8, False)])
def test_jacobi3_twins_are_the_oracle_composition(steps, from_zero):
    u, f, h = _data64(steps)
    start = torch.zeros_like(u) if from_zero else u
    want_u, want_clean = p3.smooth3(start, f, h, steps, OMEGA3, "clean")
    _, want_gpu = p3.smooth3(start, f, h, steps, OMEGA3, "gpu")
    assert torch.equal(K3.fused_jacobi3_torch(u, f, h, steps, OMEGA3, from_zero), want_u)
    got_u, got_gpu = K3.fused_jacobi3_err_torch(u, f, h, steps, OMEGA3, "gpu", from_zero)
    assert torch.equal(got_u, want_u) and _rel(got_gpu, want_gpu) < 1e-12
    if steps - from_zero <= 7:
        # the clean error from Δ: Σ|Δ|·6/(ωh²) is Σ|r|
        _, got_clean = K3.fused_jacobi3_err_torch(u, f, h, steps, OMEGA3, "clean", from_zero)
        assert _rel(got_clean, want_clean) < 1e-10


@pytest.mark.parametrize("restriction", ["full_weighting", "sampling"])
@pytest.mark.parametrize("steps,from_zero", [(1, True), (3, False)])
def test_descend3_twin_is_the_oracle_composition(restriction, steps, from_zero):
    u, f, h = _data64(10 + steps)
    m = 9
    start = torch.zeros_like(u) if from_zero else u
    want_u, want_e = p3.smooth3(start, f, h, steps, OMEGA3, "clean")
    rneg = -p3.residual3(want_u, f, h)
    want_fc = (p3.restrict3(rneg, m) if restriction == "full_weighting"
               else zoom3(rneg, m, zero_boundary=True))
    got_u, got_fc, got_e = K3.fused_descend3_torch(u, f, h, steps, OMEGA3, from_zero,
                                                   restriction, want_err=True)
    assert torch.equal(got_u, want_u)
    assert _rel(got_fc, want_fc) < 1e-10 and _rel(got_e, want_e) < 1e-10
    assert K3.fused_descend3_torch(u, f, h, steps, OMEGA3, from_zero, restriction)[2] is None


def test_ascend3_and_residual3_twins_are_the_oracle_composition():
    u, f, h = _data64(30)
    c = torch.zeros((9, 9, 9), dtype=torch.float64)
    c[1:-1, 1:-1, 1:-1] = torch.from_numpy(np.random.default_rng(31).standard_normal((7,) * 3))
    want_u, want_e = p3.smooth3(_prolong_add3(c, u, 17), f, h, 3, OMEGA3, "clean")
    got_u, got_e = K3.fused_ascend3_torch(u, f, c, h, 3, OMEGA3, want_err=True)
    assert _rel(got_u, want_u) < 1e-12 and _rel(got_e, want_e) < 1e-10
    assert torch.equal(K3.residual3_torch(u, f, h, True), -p3.residual3(u, f, h))
    assert torch.equal(T3.prolong3_add(u, c), u + p3.prolong3(c, 17))


# --- wrappers, tile plans, predicates ----------------------------------------------

def test_public_entry_points_run_the_twins_on_cpu_tensors():
    u, f = (_th(a) for a in _data(70, 17))
    h = 1.0 / 16
    c = _th(_coarse(71, 9))
    K.reset_launch_counts()
    assert torch.equal(K3.fused_jacobi3(u, f, h, 3), K3.fused_jacobi3_torch(u, f, h, 3))
    for a, b in zip(K3.fused_jacobi3_err(u, f, h, 2, err_mode="gpu", from_zero=True),
                    K3.fused_jacobi3_err_torch(u, f, h, 2, err_mode="gpu", from_zero=True)):
        assert torch.equal(a, b)
    for a, b in zip(K3.fused_descend3(u, f, h, 2, restriction="sampling", want_err=True),
                    K3.fused_descend3_torch(u, f, h, 2, restriction="sampling", want_err=True)):
        assert torch.equal(a, b)
    for a, b in zip(K3.fused_ascend3(u, f, c, h, 4, want_err=True),
                    K3.fused_ascend3_torch(u, f, c, h, 4, want_err=True)):
        assert torch.equal(a, b)
    assert torch.equal(K3.residual3(u, f, h, True), K3.residual3_torch(u, f, h, True))
    assert all(v == 0 for v in K.launches.values())
    assert {"jacobi3", "descend3", "ascend3", "residual3"} <= set(K.launches)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    u, f = (_th(a) for a in _data(72, 17))
    h = 1.0 / 16
    c = _th(_coarse(73, 9))
    with pytest.raises(ValueError, match="1..8"):
        K3.fused_jacobi3(u, f, h, 9)
    with pytest.raises(ValueError, match="at most 7"):
        K3.fused_jacobi3_err(u, f, h, 8, err_mode="clean")
    K3.fused_jacobi3_err(u, f, h, 8, err_mode="clean", from_zero=True)   # 7 after the first
    with pytest.raises(ValueError, match="err_mode"):
        K3.fused_jacobi3_err(u, f, h, 2, err_mode="cpu")
    with pytest.raises(ValueError, match="neighbor-reading"):
        K3.fused_descend3(u, f, h, 7, restriction="full_weighting")
    K3.fused_descend3(u, f, h, 7, restriction="full_weighting", from_zero=True)
    with pytest.raises(ValueError, match="restriction"):
        K3.fused_descend3(u, f, h, 2, restriction="bilinear")
    with pytest.raises(ValueError, match="1..7"):
        K3.fused_ascend3(u, f, c, h, 8, want_err=True)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        K3._jacobi3_cuda(u, f, h, 3, OMEGA3, False, None)


@pytest.mark.parametrize("stages,halo", [(1, 1), (3, 3), (4, 5), (7, 8), (8, 8)])
def test_plan3_fits_shared_memory(stages, halo):
    """Every pipeline the wrappers launch gets an even tile and chunk that fit
    a block's shared memory; larger pipelines get smaller tiles."""
    for n in (65, 129, 131, 513):
        ty, tx, cz = K3.plan3(n, stages, halo)
        assert ty % 2 == 0 and tx % 2 == 0 and cz % 2 == 0 and cz >= 2
        assert K3.smem3(stages, halo, ty, tx) <= K3.SMEM_MAX3
        assert (ty + 2 * halo) * (tx + 2 * halo) <= K3.PLANE_MAX3
        assert -(-n // cz) == -(-n // K3.CHUNK3)
    assert K3.plan3(513, 3, 3)[:2] == (32, 64) and K3.plan3(513, 8, 8)[:2] == (16, 32)
    assert K3.blocks3(513, 32, 64, 58) == 9 * 17 * 9


def test_force_tile3_overrides_the_plan(monkeypatch):
    monkeypatch.setattr(K3, "FORCE_TILE3", (8, 16, 10))
    assert K3.plan3(131, 8, 8) == (8, 16, 10)


@pytest.mark.parametrize("n", [9, 33, 65, 129, 161, 257, 513])
def test_trigger3_predicates_agree_with_jax(n):
    assert K3.trigger3_fits(n) == jp3k.trigger3_fits(n)
    assert K3.trigger3_stream_fits(n) == jp3k.trigger3_stream_fits(n)
    for compat in ("clean", "gpu"):
        assert K3.errs3_sweep_cap(compat) == jp3k.errs3_sweep_cap(compat)
    assert (K3.MAX_FUSED_SWEEPS_3D, K3.MAX_DESCEND3_SWEEPS_FW,
            K3.MAX_DESCEND3_SWEEPS_SAMPLING) == (jp3k.MAX_FUSED_SWEEPS_3D,
                                                  jp3k.MAX_DESCEND3_SWEEPS_FW,
                                                  jp3k.MAX_DESCEND3_SWEEPS_SAMPLING)
