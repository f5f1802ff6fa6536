"""The port's 3-D oracle ops, coarse solvers, transfers, zoom3, problems and
V-cycle (multigrid_poisson_solver_tpu_torch.models.poisson3d, ops.zoom,
ops.transfers3) against the JAX package's, on numpy inputs from a seed.

float64: 1e-12 relative (the same operations in the same order; only libm
and summation order differ). fp32: each test states its bound; XLA may
contract a multiply and an add into an FMA where the port rounds twice, so
a sweep differs by a few ulps of max|u|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu.models import poisson3d as jp3
from multigrid_poisson_solver_tpu.ops import padded3 as jpd3
from multigrid_poisson_solver_tpu.ops import pallas3d as jp3k
from multigrid_poisson_solver_tpu.ops.zoom import zoom3 as jzoom3
from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3
from multigrid_poisson_solver_tpu_torch.ops import transfers3 as T3
from multigrid_poisson_solver_tpu_torch.ops.zoom import zoom3

RTOL = 1e-12
OMEGA3 = 6.0 / 7.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _vol(rng, n, dtype=np.float64, zero_border=False):
    a = rng.standard_normal((n, n, n)).astype(dtype)
    if zero_border:
        b = np.zeros_like(a)
        b[1:-1, 1:-1, 1:-1] = a[1:-1, 1:-1, 1:-1]
        a = b
    return a


def _th(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [5, 12, 17])
def test_stencil_ops_match_float64(rng, n):
    u, f, v = _vol(rng, n), _vol(rng, n), _vol(rng, n)
    h = 1.0 / (n - 1)
    ju, jf, jv = jnp.asarray(u), jnp.asarray(f), jnp.asarray(v)
    tu, tf, tv = _th(u), _th(f), _th(v)
    _close(p3._nb_sum3(tu), jp3._nb_sum3(ju))
    _close(p3.residual3(tu, tf, h), jp3.residual3(ju, jf, h))
    _close(p3.jacobi_sweep3(tu, tf, h, OMEGA3), jp3.jacobi_sweep3(ju, jf, h, OMEGA3))
    _close(p3.redblack_gs_sweep3(tu, tf, h), jp3.redblack_gs_sweep3(ju, jf, h))
    _close(p3.smoothing_error3(tu, tf, h), jp3.smoothing_error3(ju, jf, h))
    _close(p3.gpu_smoothing_error3(tu, tv, h), jp3.gpu_smoothing_error3(ju, jv, h))


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
@pytest.mark.parametrize("compat", ["clean", "gpu"])
@pytest.mark.parametrize("steps", [0, 1, 3])
def test_smooth3_matches_float64(rng, smoother, compat, steps):
    n = 9
    h = 1.0 / (n - 1)
    u, f = _vol(rng, n), _vol(rng, n)
    got_u, got_e = p3.smooth3(_th(u), _th(f), h, steps, 0.9, compat, smoother)
    want_u, want_e = jp3.smooth3(jnp.asarray(u), jnp.asarray(f), h, steps, 0.9, compat,
                                 smoother)
    _close(got_u, want_u)
    _close(got_e, want_e, 1e-10)


@pytest.mark.parametrize("compat", ["clean", "gpu"])
@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
def test_trigger_smooth3_stops_where_jax_does(compat, smoother):
    n = 9
    h = 1.0 / (n - 1)
    prob = jp3.REFERENCE_PROBLEM_3D
    f = np.asarray(prob.source_grid(n, jnp.float64))
    u = np.zeros_like(f)
    got = p3.trigger_smooth3(_th(u), _th(f), h, 1e-3, OMEGA3, compat, smoother, 500)
    want = jp3.trigger_smooth3(jnp.asarray(u), jnp.asarray(f), h, 1e-3, OMEGA3, compat,
                               smoother, 500)
    assert 1 < got[2] < 500 and got[2] == int(want[2])
    _close(got[0], want[0])
    _close(got[1], want[1], 1e-10)   # a sum over n³ terms in another order


@pytest.mark.parametrize("n", [5, 9, 17])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-11), (np.float32, 2e-5)])
def test_dense_solve3_matches(rng, n, dtype, rtol):
    """fp32: the inverse is applied as a product in the grid's dtype; the two
    packages sum its (n−2)³ terms in another order (bound 2e-5·max|u|)."""
    f = _vol(rng, n, dtype)
    h = 1.0 / (n - 1)
    got = p3.dense_solve3(_th(f), h)
    want = jp3.dense_solve3(jnp.asarray(f), h)
    _close(got, want, rtol)
    # the solve is exact: the residual of the interior system vanishes
    if dtype == np.float64:
        r = p3.residual3(got, _th(f), h)
        assert float(r.abs().max()) < 1e-9 * float(np.abs(f).max())


def test_dense_solve3_capped_at_4096_unknowns():
    with pytest.raises(ValueError, match="4096"):
        p3.dense_solve3(torch.zeros((19, 19, 19), dtype=torch.float64), 1.0 / 18)


@pytest.mark.parametrize("norm", ["interior", "full"])
@pytest.mark.parametrize("target", [1e-3, 1e-8])
def test_gauss_seidel_solve3_matches(norm, target):
    """Equal iteration counts (the stop test and the stagnation stop), and
    the same iterate in float64."""
    n = 9
    h = 1.0 / (n - 1)
    prob = jp3.HARMONIC_PROBLEM_3D
    f = np.asarray(prob.source_grid(n, jnp.float64) + prob.boundary_grid(n, jnp.float64))
    got_u, got_e, got_k = p3.gauss_seidel_solve3(_th(f), h, target, norm)
    want_u, want_e, want_k = jp3.gauss_seidel_solve3(jnp.asarray(f), h, target, norm)
    assert got_k == int(want_k) and got_k > 1
    _close(got_u, want_u)
    # near convergence the error is the rounding noise of residuals that
    # cancel: compare it on the scale of the data
    assert abs(float(got_e) - float(want_e)) <= 1e-12 * float(np.abs(f).max())


@pytest.mark.parametrize("m", [3, 9, 17])
def test_restrict3_and_prolong3_match(rng, m):
    n = 2 * m - 1
    d, c = _vol(rng, n), _vol(rng, m, zero_border=True)
    _close(p3.restrict3(_th(d), m), jp3.restrict3(jnp.asarray(d), m))
    _close(p3.prolong3(_th(c), n), jp3.prolong3(jnp.asarray(c), n))
    with pytest.raises(ValueError):
        p3.restrict3(_th(d), m + 1)


@pytest.mark.parametrize("mode", ["full_weighting", "sampling"])
def test_transfers3_match_padded3(rng, mode):
    """restrict3 and prolong3_add against ops/padded3.py's padded operators
    (cropped), float64."""
    m = 9
    n = 2 * m - 1
    d, u, c = _vol(rng, n), _vol(rng, n), _vol(rng, m, zero_border=True)
    want = jpd3.restrict3_p(jp3k.pad_grid3(jnp.asarray(d)), n, m, mode=mode)
    _close(T3.restrict3(_th(d), m, mode), np.asarray(want)[:m, :m, :m])
    cp = jp3k.pad_grid3(jnp.asarray(c))
    for interior_only in (False, True):
        want = jpd3.prolong3_add_p(jp3k.pad_grid3(jnp.asarray(u)), cp, n, m,
                                   interior_only=interior_only)
        _close(T3.prolong3_add(_th(u), _th(c), interior_only), np.asarray(want)[:n, :n, :n])


@pytest.mark.parametrize("n_src,n_dst", [(16, 8), (17, 9), (8, 16), (9, 17), (12, 7), (9, 9)])
@pytest.mark.parametrize("zero_boundary", [False, True])
def test_zoom3_matches(rng, n_src, n_dst, zero_boundary):
    src = _vol(rng, n_src)
    _close(zoom3(_th(src), n_dst, zero_boundary), jzoom3(jnp.asarray(src), n_dst, zero_boundary))


@pytest.mark.parametrize("name", ["reference", "poly", "harmonic"])
@pytest.mark.parametrize("n", [9, 16])
def test_problem_grids_match(name, n):
    """float64 to 1e-12; fp32 to 8 ulps of the largest value (torch's and
    XLA's fp32 sin round differently; the coordinates are i/(n−1) correctly
    rounded in both)."""
    ours, theirs = p3.BUILTIN_PROBLEMS_3D[name], jp3.BUILTIN_PROBLEMS_3D[name]
    assert ours.name == theirs.name
    for kind in ("source_grid", "boundary_grid", "analytic_grid"):
        _close(getattr(ours, kind)(n, torch.float64), getattr(theirs, kind)(n, jnp.float64))
        want = np.asarray(getattr(theirs, kind)(n, jnp.float32))
        _close(getattr(ours, kind)(n, torch.float32), want, 8 * 2.0 ** -23)


def test_sizes_match():
    for n, n_min in ((513, 5), (65, 9), (33, 33), (16, 5), (9, 3)):
        assert p3._sizes(n, n_min) == jp3._sizes(n, n_min)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12), (np.float32, 2e-5)])
def test_v_cycle3_plain_matches_jax_xla(dtype, rtol):
    """The oracle V-cycle (kernels='torch') against JAX's XLA path, two
    cycles; fp32 bound 2e-5·max|u| (a few ulps a sweep over ~70 sweeps)."""
    n = 17
    h = 1.0 / (n - 1)
    prob = jp3.REFERENCE_PROBLEM_3D
    f = np.asarray(prob.source_grid(n, dtype) + prob.boundary_grid(n, dtype))
    ju, tu = jnp.zeros((n,) * 3, dtype), torch.zeros((n,) * 3, dtype=getattr(torch, dtype.__name__))
    for _ in range(2):
        ju = jp3.v_cycle3(ju, jnp.asarray(f), h, n_min=5, pre=2, post=3, coarse_sweeps=20)
        tu = p3.v_cycle3(tu, _th(f), h, n_min=5, pre=2, post=3, coarse_sweeps=20,
                         kernels="torch")
        _close(tu, ju, rtol)


def test_v_cycle3_refuses_cuda_kernels_on_cpu():
    u = torch.zeros((9, 9, 9))
    with pytest.raises(ValueError, match="CUDA"):
        p3.v_cycle3(u, u, 0.125, kernels="cuda")
    with pytest.raises(ValueError, match="unknown kernels"):
        p3.v_cycle3(u, u, 0.125, kernels="xla")


def test_solve3_converges_like_jax():
    """solve3 on the CPU: ten cycles reach JAX's error against the analytic
    solution (the discretization error of a 17³ grid)."""
    ours = p3.solve3(p3.REFERENCE_PROBLEM_3D, 17, cycles=10, kernels="torch", device="cpu")[1]
    theirs = jp3.solve3(jp3.REFERENCE_PROBLEM_3D, 17, cycles=10)[1]
    assert ours == pytest.approx(theirs, rel=1e-4)
