"""The 2:1 grid transfers of the 3-D kernel path on plain (n, n, n) tensors.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/padded3.py``. The JAX
module keeps every level in the TPU's padded (nz, rp, cp) brick layout and
writes the transfers as weight-matrix contractions and gathers on it; the
port keeps no padding, so what remains is the two operators themselves:

  * ``restrict3``: 2:1 restriction fine → coarse with zero boundary, in
    "full_weighting" ([¼, ½, ¼]³) or "sampling" (even points, the
    reference's doRestriction) mode (``restrict3_p``);
  * ``prolong3_add``: u + trilinear(c), optionally on the interior only
    (``prolong3_add_p``).

The lane passes ``restrict3_lanes_p`` and ``prolong3_lanes_p`` have no
counterpart: they exist because Mosaic cannot de-interleave lanes, and the
port's fused legs do all three axes themselves.
"""

from __future__ import annotations

import torch

from ..models.poisson3d import prolong3, restrict3 as _full_weighting3


def restrict3(d: torch.Tensor, m: int, mode: str = "full_weighting") -> torch.Tensor:
    """(n, n, n) → (m, m, m) with n == 2m − 1, zero boundary."""
    n = d.shape[0]
    if n != 2 * m - 1:
        raise ValueError(f"need n == 2m-1, got {n} -> {m}")
    if mode == "full_weighting":
        return _full_weighting3(d, m)
    if mode != "sampling":
        raise ValueError(f"unknown restriction mode {mode!r}")
    out = torch.zeros((m, m, m), dtype=d.dtype, device=d.device)
    out[1:-1, 1:-1, 1:-1] = d[2:-2:2, 2:-2:2, 2:-2:2]
    return out


def prolong3_add(u: torch.Tensor, c: torch.Tensor, interior_only: bool = False) -> torch.Tensor:
    """u + trilinear(c) for the coarse (m, m, m) c on the fine (n, n, n) u,
    n == 2m − 1; ``interior_only`` leaves u's faces as they are (needed when
    the coarse level carries a full FMG solution with a nonzero boundary)."""
    e = prolong3(c, u.shape[0])
    if not interior_only:
        return u + e
    out = u.clone()
    out[1:-1, 1:-1, 1:-1] = u[1:-1, 1:-1, 1:-1] + e[1:-1, 1:-1, 1:-1]
    return out
