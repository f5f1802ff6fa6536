"""Meshes of shards and the sharding policies of the grid hierarchy.

PyTorch port of ``multigrid_poisson_solver_tpu/parallel/mesh.py``. JAX's
``Mesh`` names the axes of an array of devices; here a ``Mesh`` names the
axes of an array of torch devices, and a device may appear more than once:
each entry is one shard, with its own buffers and neighbours, wherever it
lives. A level is row-sharded (or block-sharded) while every shard owns at
least ``threshold_rows`` rows, replicated below (coarse-level
agglomeration), with JAX's rules unchanged.

A policy's ``spec(n)`` is a tuple in ``PartitionSpec``'s form: ``()``
replicated, ``("rows", None)`` row blocks, ``("rows", "cols")`` 2-D blocks.

The port keeps no padded tile layout (its levels are plain (n, n) tensors),
but the JAX engine takes some routing decisions on its padded shapes; this
module keeps a copy of that arithmetic (``ops/layout.py``'s
``padded_shape`` and ``_policy_padded_shape``) for those predicates only,
so that the same n and shard count take the same route in both packages.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

ROW_AXIS = "rows"
COL_AXIS = "cols"

# A level is row-sharded only while every device owns at least this many rows.
DEFAULT_SHARD_THRESHOLD_ROWS = 32

# ops/layout.py: lanes pad to ×128, rows to ×16 (two sublane tiles)
LANE = 128
ROW_PAD = 16


def padded_shape(n: int) -> tuple[int, int]:
    """JAX's padded tile shape of an (n, n) level (``ops/layout.py``)."""
    return -(-n // ROW_PAD) * ROW_PAD, -(-n // LANE) * LANE


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a row-major array of torch devices (repeats allowed)."""

    devices: tuple
    axis_names: tuple
    axis_sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes) or \
                math.prod(self.axis_sizes) != len(self.devices):
            raise ValueError(f"a mesh of shape {self.axis_sizes} needs "
                             f"{math.prod(self.axis_sizes)} devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.devices)


def _devices(devices) -> tuple:
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = tuple(torch.device(d) for d in devices)
    if not out:
        raise ValueError("a mesh needs at least one device")
    return out


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = ROW_AXIS) -> Mesh:
    """A 1-D mesh over the given devices (default: every CUDA device), named
    for the row axis. ``make_mesh(["cuda:0"] * 8)`` is a ring of eight
    shards on one card."""
    devs = _devices(devices)
    return Mesh(devs, (axis_name,), (len(devs),))


def make_mesh_2d(shape: tuple[int, int], devices: Optional[Sequence] = None,
                 axis_names: tuple[str, str] = (ROW_AXIS, COL_AXIS)) -> Mesh:
    """A 2-D mesh for block partitioning (rows × cols of the grid)."""
    return Mesh(_devices(devices), tuple(axis_names), tuple(shape))


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Decides per level whether it is row-sharded or replicated."""

    mesh: Mesh
    axis_name: str = ROW_AXIS
    threshold_rows: int = DEFAULT_SHARD_THRESHOLD_ROWS

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def is_sharded(self, n: int) -> bool:
        return n // self.n_devices >= self.threshold_rows and self.n_devices > 1

    def spec(self, n: int) -> tuple:
        return (self.axis_name, None) if self.is_sharded(n) else ()

    def padded_shape(self, n: int) -> tuple[int, int]:
        """JAX's padded shape of level n under this policy (routing only)."""
        return _policy_padded_shape(n, self.spec(n), self.mesh)


@dataclasses.dataclass(frozen=True)
class BlockShardingPolicy:
    """2-D block partition: (rows, cols) while the level is large, falling
    back to rows only, then replicated (coarse agglomeration)."""

    mesh: Mesh
    row_axis: str = ROW_AXIS
    col_axis: str = COL_AXIS
    threshold_rows: int = DEFAULT_SHARD_THRESHOLD_ROWS

    def _dims(self) -> tuple[int, int]:
        return self.mesh.shape[self.row_axis], self.mesh.shape[self.col_axis]

    def spec(self, n: int) -> tuple:
        rows_dev, cols_dev = self._dims()
        if n // rows_dev >= self.threshold_rows:
            if cols_dev > 1 and n // cols_dev >= self.threshold_rows:
                return (self.row_axis, self.col_axis)
            if rows_dev > 1:
                return (self.row_axis, None)
        return ()

    def is_sharded(self, n: int) -> bool:
        return self.spec(n) != ()

    def padded_shape(self, n: int) -> tuple[int, int]:
        """JAX's padded shape of level n under this policy (routing only)."""
        return _policy_padded_shape(n, self.spec(n), self.mesh)


def _policy_padded_shape(n: int, spec: tuple, mesh: Mesh) -> tuple[int, int]:
    """Rows a multiple of ROW_PAD·(row-axis devices), lanes of
    LANE·(column-axis devices) when the axis is sharded (JAX's
    ``parallel/mesh.py::_policy_padded_shape``)."""
    rp, cp = padded_shape(n)
    if len(spec) >= 1 and spec[0] is not None:
        q = ROW_PAD * mesh.shape[spec[0]]
        rp = -(-rp // q) * q
    if len(spec) >= 2 and spec[1] is not None:
        q = LANE * mesh.shape[spec[1]]
        cp = -(-cp // q) * q
    return rp, cp
