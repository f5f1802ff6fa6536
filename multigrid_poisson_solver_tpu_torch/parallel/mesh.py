"""Meshes of shards and the sharding policies of the grid hierarchy.

PyTorch port of ``multigrid_poisson_solver_tpu/parallel/mesh.py``, and of
the z-plane policy of ``parallel/pallas_shard3.py:57-141`` (``make_mesh_z``,
``padded_depth3``, ``ZShardingPolicy3``). JAX's
``Mesh`` names the axes of an array of devices; here a ``Mesh`` names the
axes of an array of torch devices, and a device may appear more than once:
each entry is one shard, with its own buffers and neighbours, wherever it
lives. A level is row-sharded (or block-sharded) while every shard owns at
least ``threshold_rows`` rows, replicated below (coarse-level
agglomeration), with JAX's rules unchanged.

A policy's ``spec(n)`` is a tuple in ``PartitionSpec``'s form: ``()``
replicated, ``("rows", None)`` row blocks, ``("rows", "cols")`` 2-D blocks,
``("z", None, None)`` z-plane blocks of a volume.

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
Z_AXIS = "z"

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


def make_mesh_z(devices: Optional[Sequence] = None, axis_name: str = Z_AXIS) -> Mesh:
    """A 1-D mesh over the z (plane) axis of a volume (default: every CUDA
    device); ``make_mesh_z(["cuda:0"] * 8)`` is a ring of eight z-shards on
    one card."""
    return make_mesh(devices, axis_name)


def padded_depth3(n: int, n_devices: int) -> int:
    """JAX's plane count of an n-deep volume padded to a multiple of
    ``n_devices`` (``pallas_shard3.padded_depth3``; routing only)."""
    return -(-n // n_devices) * n_devices


@dataclasses.dataclass(frozen=True)
class ZShardingPolicy3:
    """Per-level z-plane sharding of the 3-D hierarchy
    (``pallas_shard3.ZShardingPolicy3``): a level of at least 65³ whose
    JAX depth gives every device at least ``threshold_planes`` planes is
    split into contiguous plane blocks, coarser ones are replicated.

    JAX pads a sharded level's depth to a multiple of 2·n_devices, so every
    shard owns an even plane count, the fused legs' parity contract. The
    port's volumes stay (n, n, n) and split by ``sharded.split_bounds``
    (even origins, the last shard takes the rest); ``padded_depth`` keeps
    JAX's depth for the routing predicates only, so that the same n and
    device count take the same route in both packages."""

    mesh: Mesh
    axis_name: str = Z_AXIS
    threshold_planes: int = 8

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def is_sharded(self, n: int) -> bool:
        ndev = self.n_devices
        return ndev > 1 and n >= 65 and self.padded_depth(n) // ndev >= self.threshold_planes

    def padded_depth(self, n: int) -> int:
        """JAX's stored plane count of level n: ×(2·n_devices) where the
        level would shard, n otherwise."""
        ndev = self.n_devices
        if ndev > 1 and n >= 65:
            zp = padded_depth3(n, 2 * ndev)
            if zp // ndev >= self.threshold_planes:
                return zp
        return n

    def planes_per_device(self, n: int) -> int:
        """JAX's planes per device of a sharded level n (its nl)."""
        return self.padded_depth(n) // self.n_devices

    def spec(self, n: int) -> tuple:
        return (self.axis_name, None, None) if self.is_sharded(n) else ()
