"""Solution I/O: CSV writer byte-compatible with the reference's Sol_* dumps.

PyTorch port of ``multigrid_poisson_solver_tpu/utils/io.py`` (the numpy
path; the optional C++ writer is not ported). The reference writes the final
grid as comma-separated ``%lf`` values, rows top-to-bottom in y
(doPrint2File, MG_solver_CPU.cpp:735-754), to ``Sol_CPU_<cyclefile>`` or
``Sol_GPU_<cyclefile>`` (MG_solver_CPU.cpp:453-459), so the reference's
plot scripts read this output unchanged.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch


def solution_filename(cycle_file: str | os.PathLike, prefix: str = "Sol_GPU_") -> str:
    """Mirror the reference naming: prefix + the schedule file's basename."""
    return prefix + Path(cycle_file).name


def write_solution_csv(u, path: str | os.PathLike, decimals: int = 6) -> None:
    """Write a grid (tensor or array) as CSV, top y row first, ``%.6f``
    fixed point, one line per row (doPrint2File)."""
    # float64 holds every fp32/bf16 value exactly, so the digits are those of
    # the stored values
    arr = (u.detach().cpu().to(torch.float64).numpy() if isinstance(u, torch.Tensor)
           else np.asarray(u))
    if arr.ndim != 2:
        raise ValueError(f"expected a 2D grid, got shape {arr.shape}")
    with open(path, "w") as fh:
        np.savetxt(fh, arr[::-1, :], fmt=f"%.{decimals}f", delimiter=",")
