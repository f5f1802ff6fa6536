"""The port's oracle ops, zoom, coarse solvers, transfers and problem grids
against the JAX package's, in float64 (to 1e-12 relative: both sides run
the same operations in the same order; only libm and summation order
differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multigrid_poisson_solver_tpu import models as jmodels
from multigrid_poisson_solver_tpu.grid import GridSpec as JGridSpec
from multigrid_poisson_solver_tpu.ops import coarse as jcoarse
from multigrid_poisson_solver_tpu.ops import layout
from multigrid_poisson_solver_tpu.ops import padded as P
from multigrid_poisson_solver_tpu.ops import precision as jprecision
from multigrid_poisson_solver_tpu.ops import stencils as jst
from multigrid_poisson_solver_tpu.ops.zoom import zoom as jzoom
from multigrid_poisson_solver_tpu_torch.convert import problem_from_jax
from multigrid_poisson_solver_tpu_torch.grid import GridSpec
from multigrid_poisson_solver_tpu_torch.ops import coarse, stencils, transfers
from multigrid_poisson_solver_tpu_torch.ops.zoom import zoom

RTOL = 1e-12


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


def _pair(rng, n):
    u = rng.standard_normal((n, n))
    f = rng.standard_normal((n, n))
    return (u, f), (torch.from_numpy(u), torch.from_numpy(f)), (jnp.asarray(u), jnp.asarray(f))


@pytest.mark.parametrize("n", [9, 40])
def test_stencil_ops_match(rng, n):
    _, (u, f), (ju, jf) = _pair(rng, n)
    h = 1.0 / (n - 1)
    _close(stencils.residual(u, f, h), jst.residual(ju, jf, h))
    _close(stencils.jacobi_sweep(u, f, h, 0.8), jst.jacobi_sweep(ju, jf, h, 0.8))
    _close(stencils.redblack_gs_sweep(u, f, h), jst.redblack_gs_sweep(ju, jf, h))
    for compat in (True, False):
        _close(stencils.smoothing_error(u, f, h, compat),
               jst.smoothing_error(ju, jf, h, compat))
    _close(stencils.gpu_smoothing_error(u, f, h), jst.gpu_smoothing_error(ju, jf, h))
    _close(stencils.mean_abs_error(u, f), jst.mean_abs_error(ju, jf))
    _close(stencils.residual_compensated(u, f, h),
           jprecision.residual_compensated(ju, jf, h))


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs"])
@pytest.mark.parametrize("compat", [True, False, "gpu"])
def test_smooth_matches(rng, smoother, compat):
    n = 17
    _, (u, f), (ju, jf) = _pair(rng, n)
    h = 1.0 / (n - 1)
    got_u, got_e = stencils.smooth(u, f, h, 3, 0.9, compat, smoother)
    want_u, want_e = jst.smooth(ju, jf, h, 3, 0.9, compat, smoother)
    _close(got_u, want_u)
    _close(got_e, want_e)


@pytest.mark.parametrize("n_src,n_dst", [(65, 33), (33, 65), (64, 32), (32, 64),
                                         (100, 37), (37, 100)])
@pytest.mark.parametrize("zero_boundary", [False, True])
def test_zoom_matches_both_forms(rng, n_src, n_dst, zero_boundary):
    src = rng.standard_normal((n_src, n_src))
    t, j = torch.from_numpy(src), jnp.asarray(src)
    want_take = P.zoom_take_p(layout.pad_grid(j), n_src, n_dst,
                              layout.padded_shape(n_dst), zero_boundary)
    _close(zoom(t, n_dst, zero_boundary), layout.unpad_grid(want_take, n_dst))
    _close(zoom(t, n_dst, zero_boundary, form="matmul"),
           jzoom(j, n_dst, zero_boundary))


@pytest.mark.parametrize("n,m", [(65, 33), (17, 9)])
def test_transfers_match(rng, n, m):
    d = rng.standard_normal((n, n))
    d[0, :] = d[-1, :] = d[:, 0] = d[:, -1] = 0   # a residual is 0 off the interior
    t, jp = torch.from_numpy(d), layout.pad_grid(jnp.asarray(d))
    mshape = layout.padded_shape(m)
    _close(transfers.sample_restrict(t, m),
           layout.unpad_grid(P.zoom_take_p(jp, n, m, mshape, zero_boundary=True), m))
    _close(transfers.full_weighting_restrict(t, m),
           layout.unpad_grid(P.full_weighting_restrict_p(jp, n, m, mshape), m))
    c = rng.standard_normal((m, m))
    want = P.zoom_take_p(layout.pad_grid(jnp.asarray(c)), m, n, layout.padded_shape(n))
    _close(transfers.prolong(torch.from_numpy(c), n), layout.unpad_grid(want, n))
    u = rng.standard_normal((n, n))
    _close(transfers.add_correction(torch.from_numpy(u), t),
           layout.unpad_grid(P.add_correction_p(layout.pad_grid(jnp.asarray(u)), jp, n), n))
    f = rng.standard_normal((n, n))
    h = 1.0 / (n - 1)
    _close(transfers.relative_residual_norm(torch.from_numpy(u), torch.from_numpy(f), h),
           P.relative_residual_norm_p(layout.pad_grid(jnp.asarray(u)),
                                      layout.pad_grid(jnp.asarray(f)), h, n))
    with pytest.raises(ValueError, match="2:1"):
        transfers.sample_restrict(t, m + 1)


@pytest.mark.parametrize("n", [9, 17])
def test_dense_solve_matches(rng, n):
    f = rng.standard_normal((n, n))
    h = 1.0 / (n - 1)
    _close(coarse.dense_solve(torch.from_numpy(f), h), jcoarse.dense_solve(jnp.asarray(f), h),
           rtol=1e-11)


@pytest.mark.parametrize("norm", ["interior", "full"])
def test_gauss_seidel_solve_matches(rng, norm):
    """Same iterate, same final error, same iteration count (the stopping rule
    is an integer outcome)."""
    n = 8
    f = rng.standard_normal((n, n))
    f[0, :] = f[-1, :] = f[:, 0] = f[:, -1] = 0
    h = 1.0 / (n - 1)
    u, err, iters = coarse.gauss_seidel_solve(torch.from_numpy(f), h, 1e-7, norm=norm)
    ju, jerr, jiters = jcoarse.gauss_seidel_solve(jnp.asarray(f), h, 1e-7, norm=norm)
    assert iters == int(jiters)
    _close(u, ju)
    _close(err, jerr, rtol=1e-9)


@pytest.mark.parametrize("name", ["reference", "sine", "polynomial", "gaussian"])
def test_problem_grids_match(name):
    spec, jspec = GridSpec(33), JGridSpec(33)
    ours, theirs = problem_from_jax(name), jmodels.BUILTIN_PROBLEMS[name]
    assert problem_from_jax(theirs.name) is ours
    for kind in ("source_grid", "boundary_grid"):
        _close(getattr(ours, kind)(spec, torch.float64),
               getattr(theirs, kind)(jspec, jnp.float64))
    if theirs.analytic is not None:
        _close(ours.analytic_grid(spec, torch.float64),
               theirs.analytic_grid(jspec, jnp.float64))
    x, y = spec.coords(torch.float64)
    jx, jy = jspec.coords(jnp.float64)
    _close(x, jx)
    _close(y, jy)
