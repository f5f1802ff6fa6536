"""The port's plotting helpers (utils/plotting.py) against the JAX package's,
under matplotlib's Agg backend.

``comparison_figure`` must draw the same image arrays (numerical, analytic,
|difference|) as JAX's on the same input: the analytic panel is the float64
analytic grid of each package's problem, which agree to 1e-15 relative
(torch's and XLA's float64 exp); the numerical panel is the input itself.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from multigrid_poisson_solver_tpu.models import poisson3d as jp3  # noqa: E402
from multigrid_poisson_solver_tpu.utils import plotting as jplot  # noqa: E402
from multigrid_poisson_solver_tpu_torch.models import poisson3d as tp3  # noqa: E402
from multigrid_poisson_solver_tpu_torch.utils import plotting as tplot  # noqa: E402
from multigrid_poisson_solver_tpu_torch.utils.io import write_solution_csv  # noqa: E402


def images(fig):
    return [np.asarray(im.get_array()) for ax in fig.axes for im in ax.get_images()]


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


@pytest.mark.parametrize("n", [17, 33])
def test_comparison_figure_draws_jax_images(rng, n):
    u = rng.random((n, n))
    ours, theirs = images(tplot.comparison_figure(torch.from_numpy(u))), \
        images(jplot.comparison_figure(u))
    assert len(ours) == len(theirs) == 3
    np.testing.assert_array_equal(ours[0], theirs[0])
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-15)
    titles = [ax.get_title() for ax in tplot.comparison_figure(u).axes[:3]]
    assert titles == [ax.get_title() for ax in jplot.comparison_figure(u).axes[:3]]


def test_surface_figure(rng):
    fig = tplot.surface_figure(torch.from_numpy(rng.random((17, 17))))
    assert fig.axes and fig.axes[0].get_xlabel() == "x"


def test_slice_figure3_with_analytic_matches_jax():
    u = tp3.REFERENCE_PROBLEM_3D.analytic_grid(17, torch.float64)
    ours = images(tplot.slice_figure3(u, problem=tp3.REFERENCE_PROBLEM_3D))
    theirs = images(jplot.slice_figure3(np.asarray(jp3.REFERENCE_PROBLEM_3D.analytic_grid(
        17, np.float64)), problem=jp3.REFERENCE_PROBLEM_3D))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-15)


def test_slice_figure3_plain(rng):
    fig = tplot.slice_figure3(rng.random((9, 9, 9)), axis=2, index=4)
    assert len(images(fig)) == 1
    with pytest.raises(ValueError, match="volume"):
        tplot.slice_figure3(rng.random((9, 9)))


def test_plotting_cli_csv(tmp_path, rng):
    u = rng.random((17, 17))
    path = tmp_path / "Sol_GPU_x.txt"
    write_solution_csv(torch.from_numpy(u), path)
    out = tmp_path / "x.png"
    assert tplot.main([str(path), str(out)]) == 0
    assert out.stat().st_size > 0
    assert tplot.main([]) == 1


def test_plotting_cli_npz(tmp_path):
    u = tp3.REFERENCE_PROBLEM_3D.analytic_grid(9).numpy()
    npz = tmp_path / "Sol_x.npz"
    np.savez_compressed(npz, u=u)
    out = tmp_path / "x.png"
    assert tplot.main([str(npz), str(out)]) == 0
    assert out.exists()
