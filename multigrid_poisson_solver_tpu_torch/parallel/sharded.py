"""Levels split into per-shard blocks, and the data movement between shards.

No file of the JAX package holds this: there a sharded level is one global
array with a ``NamedSharding``, ``device_put`` splits it, ``shard_map`` hands
each device its block, ``lax.ppermute`` moves halo rows between ring
neighbours (``parallel/halo.py:44-61``, ``parallel/pallas_shard.py:55-77``,
``:173-178``), ``lax.psum`` adds the shards' partials, and GSPMD re-splits
arrays between levels (``compiled.py::_constrain``). Here:

  * ``ShardedGrid`` holds one level's blocks, each its own tensor on its
    shard's device, with the level's global n and its ``Layout``;
  * ``shard`` splits a global (n, n) tensor by a policy's spec, ``gather``
    puts it back together;
  * ``window`` assembles any rectangle of the global grid from the blocks
    (zero outside the grid) by ``copy_`` from each block that overlaps it;
    ``extend`` is a block plus k halo rows (and columns) from its ring
    neighbours, the counterpart of the ppermute exchange;
  * ``psum`` adds per-shard partials in shard order (row-major over the
    mesh), the one order every sharded path of the port uses;
  * ``as_level`` re-splits a level between layouts, or gathers it for a
    replicated level.
  * ``on_device`` makes a shard's card current for its launches, so a mesh
    may span several cards.

Splitting: every shard but the last of an axis owns 2⌊n / 2P⌋ rows (an even
count, so every origin is even and a 2:1 leg's coarse points start at
origin / 2); the last owns the rest. The JAX package splits padded arrays
into equal blocks instead; the split does not change any owned value, and
the policies' thresholds keep every shard at least that wide.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Union

import torch


def split_bounds(n: int, parts: int) -> tuple[tuple[int, int], ...]:
    """[start, stop) of each of ``parts`` shards along an axis of n cells."""
    base = 2 * (n // (2 * parts))
    if base < 2:
        raise ValueError(f"{n} cells cannot be split into {parts} shards of at least 2")
    return tuple((i * base, (i + 1) * base if i < parts - 1 else n) for i in range(parts))


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a level of size n is split: row ranges, column ranges and the
    device of each block (``devices[i][j]``)."""

    n: int
    rows: tuple
    cols: tuple
    devices: tuple

    def order(self):
        """(i, j) of every block in shard order (row-major over the mesh)."""
        return [(i, j) for i in range(len(self.rows)) for j in range(len(self.cols))]


def _axis_device(mesh, idx: dict) -> torch.device:
    """The mesh entry at the given axis indices (0 on the other axes)."""
    flat = 0
    for name, size in zip(mesh.axis_names, mesh.axis_sizes):
        flat = flat * size + idx.get(name, 0)
    return mesh.devices[flat]


def layout_of(policy, n: int) -> Optional[Layout]:
    """The layout of level n under ``policy``, None where it is replicated."""
    if policy is None or not policy.is_sharded(n):
        return None
    spec = policy.spec(n)
    mesh = policy.mesh
    row_axis = spec[0]
    col_axis = spec[1] if len(spec) > 1 else None
    nr = mesh.shape[row_axis]
    nc = mesh.shape[col_axis] if col_axis else 1
    rows = split_bounds(n, nr)
    cols = split_bounds(n, nc) if col_axis else ((0, n),)
    devices = tuple(tuple(_axis_device(mesh, {row_axis: i, **({col_axis: j} if col_axis else {})})
                          for j in range(nc)) for i in range(nr))
    return Layout(n, rows, cols, devices)


def on_device(dev: torch.device):
    """A context with ``dev`` the current card (the kernels launch on the
    current one); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def home(policy, default="cpu") -> torch.device:
    """Where a policy keeps replicated levels: its mesh's first device."""
    return torch.device(default) if policy is None else policy.mesh.devices[0]


class ShardedGrid:
    """One level's blocks: ``blocks[i][j]`` is the (rows_i, cols_j) tensor of
    shard (i, j) on ``layout.devices[i][j]``."""

    def __init__(self, layout: Layout, blocks):
        self.layout = layout
        self.blocks = [list(row) for row in blocks]

    @property
    def n(self) -> int:
        return self.layout.n

    @property
    def shape(self) -> tuple[int, int]:
        return self.layout.n, self.layout.n

    @property
    def dtype(self):
        return self.blocks[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0][0].device

    def map(self, fn, *others: "ShardedGrid") -> "ShardedGrid":
        """A grid of the same layout whose block (i, j) is fn(i, j, block,
        *other blocks)."""
        return ShardedGrid(self.layout, [[fn(i, j, b, *(o.blocks[i][j] for o in others))
                                          for j, b in enumerate(row)]
                                         for i, row in enumerate(self.blocks)])

    def __repr__(self) -> str:
        return (f"ShardedGrid(n={self.n}, rows={self.layout.rows}, cols={self.layout.cols}, "
                f"dtype={self.dtype})")


Level = Union[torch.Tensor, ShardedGrid]


def shard(x: torch.Tensor, layout: Layout) -> ShardedGrid:
    """Split a global (n, n) tensor into the layout's blocks, each a copy of
    its own on its shard's device."""
    if tuple(x.shape) != (layout.n, layout.n):
        raise ValueError(f"expected a ({layout.n}, {layout.n}) grid, got {tuple(x.shape)}")
    blocks = []
    for i, (r0, r1) in enumerate(layout.rows):
        row = []
        for j, (c0, c1) in enumerate(layout.cols):
            b = torch.empty((r1 - r0, c1 - c0), dtype=x.dtype, device=layout.devices[i][j])
            row.append(b.copy_(x[r0:r1, c0:c1]))
        blocks.append(row)
    return ShardedGrid(layout, blocks)


def gather(x: Level, device=None) -> torch.Tensor:
    """The global (n, n) tensor of a level (a tensor comes back as it is)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    dev = x.device if device is None else torch.device(device)
    return torch.cat([torch.cat([b.to(dev) for b in row], dim=1) for row in x.blocks], dim=0)


def window(x: Level, r_lo: int, r_hi: int, c_lo: int, c_hi: int,
           device=None) -> torch.Tensor:
    """Rows [r_lo, r_hi) x columns [c_lo, c_hi) of the global grid (0 outside
    it), assembled on ``device`` by a copy from each block that overlaps."""
    n = x.shape[0]
    dev = (x.device if device is None else torch.device(device))
    out = torch.empty((r_hi - r_lo, c_hi - c_lo), dtype=x.dtype, device=dev)
    # the blocks cover the grid: only the cells beyond it need a fill
    out[:max(0, -r_lo)].zero_()
    out[max(0, n - r_lo):].zero_()
    out[:, :max(0, -c_lo)].zero_()
    out[:, max(0, n - c_lo):].zero_()
    if isinstance(x, torch.Tensor):
        pieces = [((0, n), (0, n), x)]
    else:
        lay = x.layout
        pieces = [(lay.rows[i], lay.cols[j], x.blocks[i][j]) for i, j in lay.order()]
    for (r0, r1), (c0, c1), b in pieces:
        a0, a1 = max(r0, r_lo), min(r1, r_hi)
        b0, b1 = max(c0, c_lo), min(c1, c_hi)
        if a0 < a1 and b0 < b1:
            out[a0 - r_lo:a1 - r_lo, b0 - c_lo:b1 - c_lo].copy_(
                b[a0 - r0:a1 - r0, b0 - c0:b1 - c0])
    return out


def extend(x: ShardedGrid, i: int, j: int, ext_r: int, ext_c: int) -> torch.Tensor:
    """Block (i, j) with ``ext_r`` rows and ``ext_c`` columns of its ring
    neighbours on each side (0 beyond the grid): the halo exchange."""
    (r0, r1), (c0, c1) = x.layout.rows[i], x.layout.cols[j]
    return window(x, r0 - ext_r, r1 + ext_r, c0 - ext_c, c1 + ext_c,
                  x.layout.devices[i][j])


def psum(parts) -> torch.Tensor:
    """Σ of per-shard partials, added one at a time in shard order on the
    first one's device (every sharded path adds in this order)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def as_level(x: Level, policy, n: int) -> Level:
    """Level n's array in the layout ``policy`` gives it: a ShardedGrid where
    the level is sharded (re-split if its blocks are laid out otherwise), the
    global tensor on the mesh's first device where it is replicated."""
    lay = layout_of(policy, n)
    if lay is None:
        return gather(x, home(policy, x.device))
    if isinstance(x, ShardedGrid) and x.layout == lay:
        return x
    return shard(gather(x), lay)
