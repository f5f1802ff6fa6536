"""The port's solution I/O (utils/io.py) and public zoom operators
(ops/zoom.py, ops/__init__.py) against the JAX package's.

Tolerances:
  * format_grid / print_grid text, read_solution_csv and the writer's
    bytes: exact;
  * zoom_matrix: exact (both built in float64 by the same arithmetic, then
    cast);
  * restrict_residual and prolongate: 1e-6·max|x| in fp32 (matrix products
    summed in another order) and 1e-12 relative in float64.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multigrid_poisson_solver_tpu.ops as jops
from multigrid_poisson_solver_tpu import native as jnative
from multigrid_poisson_solver_tpu.utils import io as jio
from multigrid_poisson_solver_tpu_torch import ops as tops
from multigrid_poisson_solver_tpu_torch.utils import io as tio

# the modules (each package's ops exports a function of the same name)
jzoom = importlib.import_module("multigrid_poisson_solver_tpu.ops.zoom")
tzoom = importlib.import_module("multigrid_poisson_solver_tpu_torch.ops.zoom")

TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}


@pytest.fixture(autouse=True)
def jax_writer_in_python(monkeypatch):
    """The JAX package's writer on its Python path: its binding would run
    ``make`` in native/ when its library is absent."""
    monkeypatch.setattr(jnative, "load", lambda: None)


@pytest.mark.parametrize("shape,decimals", [((5, 5), 3), ((4, 7), 3), ((9, 9), 5)])
def test_format_grid_matches_jax(rng, shape, decimals):
    u = rng.standard_normal(shape).astype(np.float32) * 10.0 ** rng.integers(-4, 4, shape)
    assert tio.format_grid(torch.from_numpy(u), decimals) == jio.format_grid(u, decimals)
    assert tio.format_grid(u, decimals) == jio.format_grid(u, decimals)


def test_print_grid_matches_jax(rng, capsys):
    u = rng.standard_normal((6, 6))
    tio.print_grid(torch.from_numpy(u))
    ours = capsys.readouterr().out
    jio.print_grid(u)
    assert ours == capsys.readouterr().out
    assert ours.count("\n") == 6


def test_format_grid_refuses_a_volume():
    with pytest.raises(ValueError, match="2D"):
        tio.format_grid(torch.zeros(3, 3, 3))
    with pytest.raises(ValueError, match="2D"):
        tio.write_solution_csv(torch.zeros(3, 3, 3), "never_written.csv")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_read_solution_csv_roundtrip(tmp_path, rng, dtype):
    u = torch.from_numpy(rng.standard_normal((17, 17))).to(dtype)
    path = tmp_path / "Sol_GPU_x.txt"
    tio.write_solution_csv(u, path)
    back = tio.read_solution_csv(path)
    assert isinstance(back, np.ndarray) and back.shape == (17, 17)
    np.testing.assert_array_equal(back, jio.read_solution_csv(path))
    want = np.array([[float(f"{v:.6f}") for v in row] for row in u.double().numpy()])
    np.testing.assert_array_equal(back, want)            # [iy, ix]: the y flip undone
    # the file's first line is the top row (largest y), as the JAX writer's
    jio.write_solution_csv(u.numpy(), tmp_path / "jax.txt")
    assert path.read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_solution_filename():
    assert tio.solution_filename("schedules/Vcycle.txt") == "Sol_GPU_Vcycle.txt"
    assert tio.solution_filename("Vcycle.txt", "Sol_CPU_") == "Sol_CPU_Vcycle.txt"


@pytest.mark.parametrize("n_src,n_dst", [(17, 9), (9, 17), (33, 12), (12, 33), (65, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zoom_matrix_equals_jax(n_src, n_dst, dtype):
    got = tzoom.zoom_matrix(n_src, n_dst, dtype, device="cpu")
    want = np.asarray(jzoom.zoom_matrix(n_src, n_dst, JDT[dtype]))
    assert got.dtype == dtype and tuple(got.shape) == (n_dst, n_src)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m", [(33, 17), (65, 33), (40, 13)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_restrict_residual_matches_jax(rng, n, m, dtype):
    d = rng.standard_normal((n, n))
    got = tops.restrict_residual(torch.from_numpy(d).to(dtype), m)
    want = np.asarray(jops.restrict_residual(jnp.asarray(d, JDT[dtype]), m))
    assert got.dtype == dtype and tuple(got.shape) == (m, m)
    assert not got[0].any() and not got[-1].any() and not got[:, 0].any() \
        and not got[:, -1].any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("m,n", [(17, 33), (33, 65), (13, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prolongate_matches_jax(rng, m, n, dtype):
    u = rng.standard_normal((m, m))
    got = tops.prolongate(torch.from_numpy(u).to(dtype), n)
    want = np.asarray(jops.prolongate(jnp.asarray(u, JDT[dtype]), n))
    assert got.dtype == dtype and tuple(got.shape) == (n, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def test_ops_exports_what_the_port_has_of_jax():
    jax_names = {"add_correction", "interior_color_masks", "jacobi_sweep", "mean_abs_error",
                 "mean_abs_interior_residual", "redblack_gs_sweep", "relative_residual_norm",
                 "residual", "smooth", "smoothing_error", "prolongate", "restrict_residual",
                 "zoom", "dense_solve", "exact_solve", "gauss_seidel_solve"}
    assert jax_names <= set(dir(jops))
    missing = {"exact_solve", "mean_abs_interior_residual"}
    for name in jax_names - missing:
        assert callable(getattr(tops, name)), name
    for name in missing:
        assert not hasattr(tops, name), name
