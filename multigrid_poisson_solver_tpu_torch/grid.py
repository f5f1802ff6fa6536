"""Grid specification for the vertex-centered square domain.

PyTorch port of ``multigrid_poisson_solver_tpu/grid.py``. An ``n x n`` grid of
vertices *including* the boundary, spacing ``h = length / (n - 1)``, covering
``[min_x, min_x + length] x [min_y, min_y + length]``.

Array layout: ``a[iy, ix]``, row index y, column index x (the reference's flat
index ``ix + N * iy``, MG_solver_CPU.cpp:485); x is the contiguous dimension.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static description of one multigrid level's grid.

    Attributes:
        n: number of vertices per side (including both boundary vertices).
        length: side length of the square domain.
        min_x: x coordinate of the lower-left corner.
        min_y: y coordinate of the lower-left corner.
    """

    n: int
    length: float = 1.0
    min_x: float = 0.0
    min_y: float = 0.0

    def __post_init__(self):
        if self.n < 3:
            raise ValueError(f"grid needs at least 3 points per side, got n={self.n}")

    @property
    def h(self) -> float:
        """Grid spacing; the reference's ``h = L / (N - 1)`` (MG_solver_CPU.cpp:469)."""
        return self.length / (self.n - 1)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def num_points(self) -> int:
        return self.n * self.n

    @property
    def num_interior(self) -> int:
        return (self.n - 2) * (self.n - 2)

    def coarsened(self, next_n: int) -> "GridSpec":
        """The same physical domain discretized with ``next_n`` points per side."""
        return dataclasses.replace(self, n=next_n)

    def coords(self, dtype=torch.float32, device="cpu"):
        """Return (x, y) coordinate tensors of shape (n, n), indexed [iy, ix]."""
        idx = torch.arange(self.n, dtype=dtype, device=device)
        h = torch.tensor(self.h, dtype=dtype, device=device)
        x = self.min_x + idx * h
        y = self.min_y + idx * h
        return torch.meshgrid(x, y, indexing="xy")


def level_sizes(n_max: int, n_min: int, rule: int) -> list[int]:
    """Per-level grid sizes (the reference's ``N_array``).

    ``rule`` follows the cycle-file ``con_N`` semantics
    (MG_solver_CPU.cpp:111-146):
      * 1: halve (``N -> N / 2`` integer division) while ``N >= n_min``
      * 2: decrement (``N -> N - 1``) down to ``n_min``
      * 3: odd-halve (``N -> (N + 1) / 2``), an extension that keeps 2^k + 1
        hierarchies exactly 2:1 vertex-aligned, as full weighting and the
        fused descend/ascend kernels require
    """
    if rule == 1:
        sizes = []
        n = n_max
        while n >= n_min:
            sizes.append(n)
            n //= 2
        return sizes
    if rule == 2:
        return list(range(n_max, n_min - 1, -1))
    if rule == 3:
        sizes = []
        n = n_max
        while n >= n_min:
            sizes.append(n)
            if n <= 2:
                break
            n = (n + 1) // 2
        return sizes
    raise ValueError(
        f"unknown coarsening rule {rule}; expected 1 (halve), 2 (decrement), "
        "or 3 (odd-halve)")
