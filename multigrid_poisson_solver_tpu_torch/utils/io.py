"""Solution I/O: CSV writer byte-compatible with the reference's Sol_* dumps.

PyTorch port of ``multigrid_poisson_solver_tpu/utils/io.py``. The reference
writes the final grid as comma-separated ``%lf`` values, rows top-to-bottom
in y (doPrint2File, MG_solver_CPU.cpp:735-754), to ``Sol_CPU_<cyclefile>``
or ``Sol_GPU_<cyclefile>`` (MG_solver_CPU.cpp:453-459), so the reference's
plot scripts read this output unchanged.

The writer first tries the native runtime's multithreaded formatter
(``native.write_csv_native``, as JAX's ``utils/io.py:36-41`` does) and falls
back to numpy when the library is unavailable; both write the same bytes.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..native import write_csv_native


def solution_filename(cycle_file: str | os.PathLike, prefix: str = "Sol_GPU_") -> str:
    """Mirror the reference naming: prefix + the schedule file's basename."""
    return prefix + Path(cycle_file).name


def _host64(u) -> np.ndarray:
    # float64 holds every fp32/bf16 value exactly, so the digits are those of
    # the stored values
    return (u.detach().cpu().to(torch.float64).numpy() if isinstance(u, torch.Tensor)
            else np.asarray(u))


def write_solution_csv(u, path: str | os.PathLike, decimals: int = 6) -> None:
    """Write a grid (tensor or array) as CSV, top y row first, ``%.6f``
    fixed point, one line per row (doPrint2File)."""
    arr = _host64(u)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {arr.shape}")
    if write_csv_native(arr[::-1, :], str(path), decimals):
        return
    with open(path, "w") as fh:
        np.savetxt(fh, arr[::-1, :], fmt=f"%.{decimals}f", delimiter=",")


def format_grid(u, decimals: int = 3) -> str:
    """Console grid dump in the reference's doPrint layout
    (MG_solver_CPU.cpp:726-733): rows printed top y first, values as
    ``%2.3e``-style scientific with a trailing space per value."""
    arr = _host64(u)
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {arr.shape}")
    return "\n".join(
        "".join(f"{v:2.{decimals}e} " for v in row) for row in arr[::-1, :])


def print_grid(u, decimals: int = 3) -> None:
    print(format_grid(u, decimals))


def read_solution_csv(path: str | os.PathLike) -> np.ndarray:
    """Read a Sol_* CSV back into an [iy, ix] numpy grid (undoing the y flip)."""
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    return data[::-1, :]
