"""Offline visualization of solver output (the analog of the reference's plot/).

PyTorch port of ``multigrid_poisson_solver_tpu/utils/plotting.py``
(``comparison_figure`` :21, ``surface_figure`` :46, ``slice_figure3`` :62,
``main`` :94). The reference ships two matplotlib scripts reading the Sol_*
CSV dumps: plot/plot.py (2D imshow of numerical vs analytic vs diff) and
plot/plot3D.py (3D surfaces). These helpers give the same views on the host;
``python -m multigrid_poisson_solver_tpu_torch.utils.plotting
Sol_GPU_Vcycle.txt`` draws the side-by-side comparison. matplotlib is
imported inside the functions only: the solver's path never needs it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..grid import GridSpec
from ..models.problems import REFERENCE_PROBLEM, Problem
from .io import read_solution_csv


def _host(u) -> np.ndarray:
    return u.detach().cpu().numpy() if isinstance(u, torch.Tensor) else np.asarray(u)


def comparison_figure(u, problem: Problem = REFERENCE_PROBLEM,
                      length: float = 1.0, min_x: float = 0.0, min_y: float = 0.0):
    """2D panels: numerical, analytic, and |difference| (plot/plot.py:16-22 analog).

    Returns the matplotlib Figure; raises ImportError if matplotlib is absent.
    """
    import matplotlib.pyplot as plt

    u = _host(u)
    n = u.shape[0]
    spec = GridSpec(n, length, min_x, min_y)
    ua = problem.analytic_grid(spec, dtype=torch.float64).numpy()
    diff = np.abs(u - ua)

    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    extent = [min_x, min_x + length, min_y, min_y + length]
    for ax, (data, title) in zip(
        axes,
        [(u, "numerical"), (ua, "analytic"), (diff, f"|diff| (mean {diff.mean():.3e})")],
    ):
        im = ax.imshow(data, origin="lower", extent=extent, cmap="viridis")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    return fig


def surface_figure(u, length: float = 1.0, min_x: float = 0.0, min_y: float = 0.0):
    """3D surface of the solution (plot/plot3D.py analog)."""
    import matplotlib.pyplot as plt

    u = _host(u)
    n = u.shape[0]
    xs = np.linspace(min_x, min_x + length, n)
    x, y = np.meshgrid(xs, xs, indexing="xy")
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(x, y, u, cmap="viridis", linewidth=0)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    return fig


def slice_figure3(u, axis: int = 0, index: int | None = None,
                  length: float = 1.0, min_x: float = 0.0,
                  min_y: float = 0.0, problem=None):
    """Orthogonal slice view of a 3-D solution volume: numerical, analytic
    (when a Problem3D with an analytic solution is given), and |difference|
    panels through the mid-plane (or ``index``) of ``axis``; the 3-D analog
    of comparison_figure for the CLI's ``--dim 3`` npz dumps."""
    import matplotlib.pyplot as plt

    u = _host(u)
    if u.ndim != 3:
        raise ValueError(f"expected an (n, n, n) volume, got {u.shape}")
    n = u.shape[0]
    idx = n // 2 if index is None else index
    sl = np.take(u, idx, axis=axis)

    panels = [(sl, f"numerical (axis {axis}, slice {idx})")]
    if problem is not None and getattr(problem, "analytic", None) is not None:
        ua = problem.analytic_grid(n, torch.float64).numpy()
        sa = np.take(ua, idx, axis=axis)
        diff = np.abs(sl - sa)
        panels += [(sa, "analytic"),
                   (diff, f"|diff| (mean {diff.mean():.3e})")]

    fig, axes = plt.subplots(1, len(panels), figsize=(4.7 * len(panels), 4),
                             squeeze=False)
    extent = [min_x, min_x + length, min_y, min_y + length]
    for ax, (data, title) in zip(axes[0], panels):
        im = ax.imshow(data, origin="lower", extent=extent, cmap="viridis")
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    return fig


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m multigrid_poisson_solver_tpu_torch.utils.plotting "
              "Sol_file.csv|Sol_file.npz [out.png]", file=sys.stderr)
        return 1
    if argv[0].endswith(".npz"):
        from ..models.poisson3d import REFERENCE_PROBLEM_3D

        u = np.load(argv[0])["u"]
        fig = slice_figure3(u, problem=REFERENCE_PROBLEM_3D)
    else:
        u = read_solution_csv(argv[0])
        fig = comparison_figure(u)
    out = argv[1] if len(argv) > 1 else argv[0] + ".png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
