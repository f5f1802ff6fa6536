"""Levels split into per-shard blocks, and the data movement between shards.

No file of the JAX package holds this: there a sharded level is one global
array with a ``NamedSharding``, ``device_put`` splits it, ``shard_map`` hands
each device its block, ``lax.ppermute`` moves halo rows between ring
neighbours (``parallel/halo.py:44-61``, ``parallel/pallas_shard.py:55-77``,
``:173-178``), ``lax.psum`` adds the shards' partials, and GSPMD re-splits
arrays between levels (``compiled.py::_constrain``). Here:

  * ``ShardedGrid`` holds one level's blocks, each its own tensor on its
    shard's device, with the level's global n and its ``Layout``;
  * ``shard`` splits a global (n, n) tensor by a policy's spec, or an (n, n,
    n) volume into z-plane blocks under ``ZShardingPolicy3``; ``gather``
    puts it back together;
  * ``window`` assembles any rectangle of the global grid from the blocks
    (zero outside the grid) by ``copy_`` from each block that overlaps it,
    ``planes`` any range of z planes of a volume; ``extend`` is a block plus
    k halo rows (and columns), or k planes, from its ring neighbours, the
    counterpart of the ppermute exchange (``pallas_shard3._extend_planes``
    for volumes); a halo deeper than a neighbour's block comes from every
    block it overlaps, which a ppermute could not do;
  * ``psum`` adds per-shard partials in shard order (row-major over the
    mesh), the one order every sharded path of the port uses;
  * ``as_level`` re-splits a level between layouts, or gathers it for a
    replicated level.
  * ``on_device`` makes a shard's card current for its launches, so a mesh
    may span several cards.

Across processes (a mesh whose entries name their owners, ``Mesh.ranks``,
built by ``parallel.multihost``): every process holds the same layouts, a
``ShardedGrid`` holds the blocks of this process's entries (another's is
None), and every process calls the primitives below in the same order, as
JAX's SPMD programs do. ``exchange`` (``extend_all``) assembles the windows
of this process's blocks in one batched exchange a call site: ``plan``, a
pure function of the layouts and the windows (cached), names the pieces;
local pieces move by ``copy_``, each peer's pieces packed into one message a
direction (``batch_isend_irecv``; under gloo staged through host memory). ``psum``
gathers every shard's partial and adds them in shard order on every
process, so every process reads the same float; ``gather`` gathers the
blocks to every process. On a one-process mesh these make no
``torch.distributed`` call and copy what they copied before.

Counters (``reset_counts``, ``counts``): per level, the pieces and bytes the
exchanges move between shards (of them, those between processes, and the
messages), the psums and the gathers with their bytes. They take the role
JAX's ``hlo_collective_counts`` has there; ``utils.scaling_model`` predicts
them exactly, counting through the same ``plan`` and ``LevelCounts``
methods.

Splitting: every shard but the last of an axis owns 2⌊n / 2P⌋ rows (or
planes: an even count, so every origin is even and a 2:1 leg's coarse
points start at origin / 2); the last owns the rest. The JAX package splits
padded arrays into equal blocks instead (its volumes padded to ×2P planes);
the split does not change any owned value, and the policies' thresholds
keep every shard at least that wide.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Union

import torch

from .mesh import process_rank


def split_bounds(n: int, parts: int) -> tuple[tuple[int, int], ...]:
    """[start, stop) of each of ``parts`` shards along an axis of n cells."""
    base = 2 * (n // (2 * parts))
    if base < 2:
        raise ValueError(f"{n} cells cannot be split into {parts} shards of at least 2")
    return tuple((i * base, (i + 1) * base if i < parts - 1 else n) for i in range(parts))


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a level of size n is split: row ranges, column ranges and the
    device of each block (``devices[i][j]``). A volume (``dim`` 3) splits
    its z planes as ``rows``, with one column range covering (y, x).

    ``ranks[i][j]``: the process that owns block (i, j), None where this
    process owns them all; ``entries[i][j]``: the block's flat mesh index
    (shard order where None), which tells two layouts' blocks on one mesh
    entry apart from blocks on two."""

    n: int
    rows: tuple
    cols: tuple
    devices: tuple
    dim: int = 2
    ranks: Optional[tuple] = None
    entries: Optional[tuple] = dataclasses.field(default=None, compare=False)

    def order(self):
        """(i, j) of every block in shard order (row-major over the mesh)."""
        return [(i, j) for i in range(len(self.rows)) for j in range(len(self.cols))]

    @property
    def one_process(self) -> bool:
        return self.ranks is None

    def owner(self, i: int, j: int) -> Optional[int]:
        """The rank that owns block (i, j), None on a one-process layout."""
        return None if self.ranks is None else self.ranks[i][j]

    def local_order(self):
        """(i, j) of this process's blocks in shard order."""
        if self.ranks is None:
            return self.order()
        me = process_rank()
        return [(i, j) for i, j in self.order() if self.ranks[i][j] == me]

    def entry(self, i: int, j: int) -> int:
        return i * len(self.cols) + j if self.entries is None else self.entries[i][j]

    def coarse(self, m: int, rows: tuple, cols: tuple) -> "Layout":
        """A layout of size m over the same blocks' entries (a leg's coarse
        points)."""
        return dataclasses.replace(self, n=m, rows=rows, cols=cols)


@dataclasses.dataclass
class LevelCounts:
    """What one level's sharded data movement did (``counts``)."""

    exchanges: int = 0          # batched exchanges that moved a piece between shards
    pieces: int = 0             # pieces copied from one shard's block into another's window
    bytes: int = 0              # their bytes
    xproc_pieces: int = 0       # of those, pieces between processes
    xproc_bytes: int = 0
    messages: int = 0           # packed messages between processes (one per peer a direction)
    psums: int = 0              # psums of per-shard partials
    gathers: int = 0            # gathers of a sharded level
    gather_bytes: int = 0       # the level's bytes each gather assembles
    gather_xproc_bytes: int = 0  # Σ over processes of the bytes it gathered from others

    def add_exchange(self, p: "Plan", cell_bytes: int) -> None:
        """Count an exchange by its plan (``cell_bytes``: a source cell's)."""
        self.exchanges += p.pieces > 0
        self.pieces += p.pieces
        self.bytes += p.cells * cell_bytes
        self.xproc_pieces += p.xproc_pieces
        self.xproc_bytes += p.xproc_cells * cell_bytes
        self.messages += p.messages

    def add_gather(self, lay: "Layout", item: int) -> None:
        """Count a gather of a level laid out as ``lay`` (``item``: bytes an
        element)."""
        total = lay.n ** lay.dim
        self.gathers += 1
        self.gather_bytes += total * item
        if not lay.one_process:
            self.gather_xproc_bytes += sum(total - c for c in _rank_cells(lay).values()) * item


_COUNTS: dict = {}


def reset_counts() -> None:
    """Set every level's counters to 0."""
    _COUNTS.clear()


def counts() -> dict:
    """{n: LevelCounts fields as a dict} of every level that moved data since
    ``reset_counts``; the same on every process of a run."""
    out = {n: dataclasses.asdict(c) for n, c in sorted(_COUNTS.items(), reverse=True)}
    return {n: c for n, c in out.items() if any(c.values())}


def _count(n: int) -> LevelCounts:
    c = _COUNTS.get(n)
    if c is None:
        c = _COUNTS[n] = LevelCounts()
    return c


def _axis_index(mesh, idx: dict) -> int:
    """The flat index of the mesh entry at the given axis indices (0 on the
    other axes)."""
    flat = 0
    for name, size in zip(mesh.axis_names, mesh.axis_sizes):
        flat = flat * size + idx.get(name, 0)
    return flat


def z_layout(n: int, devices, ranks=None) -> Layout:
    """The z-plane split of an (n, n, n) volume over ``devices`` (one block
    per entry, repeats allowed; ``ranks``: each entry's process)."""
    devs = tuple(torch.device(d) for d in devices)
    rk = None if ranks is None or len(set(ranks)) == 1 else tuple((int(r),) for r in ranks)
    return Layout(n, split_bounds(n, len(devs)), ((0, n),), tuple((d,) for d in devs), 3, rk)


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
    flat = tuple(tuple(_axis_index(mesh, {row_axis: i, **({col_axis: j} if col_axis else {})})
                       for j in range(nc)) for i in range(nr))
    devices = tuple(tuple(mesh.devices[k] for k in row) for row in flat)
    ranks = None
    if not mesh.one_process:
        ranks = tuple(tuple(mesh.ranks[k] for k in row) for row in flat)
        missing = set(mesh.ranks) - {r for row in ranks for r in row}
        if missing:
            raise ValueError(f"level {n} ({spec}) leaves processes {sorted(missing)} no block; "
                             f"every process must own a block of every sharded level")
    return Layout(n, rows, cols, devices, max(2, len(spec)), ranks, flat)


def on_device(dev: torch.device):
    """A context with ``dev`` the current card (the kernels launch on the
    current one); nothing for a CPU device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def each_shard(x: "ShardedGrid", fn) -> list:
    """[fn(i)] over this process's z blocks (or row blocks) of x in shard
    order, each call with its shard's card current."""
    out = []
    for i, _ in x.layout.local_order():
        with on_device(x.layout.devices[i][0]):
            out.append(fn(i))
    return out


def home(policy, default="cpu") -> torch.device:
    """Where a policy keeps replicated levels: this process's first mesh
    entry."""
    if policy is None:
        return torch.device(default)
    return policy.mesh.devices[policy.mesh.local_entries()[0]]


class ShardedGrid:
    """One level's blocks: ``blocks[i][j]`` is the (rows_i, cols_j) tensor of
    shard (i, j) on ``layout.devices[i][j]``, None where another process
    owns it."""

    def __init__(self, layout: Layout, blocks):
        self.layout = layout
        self.blocks = [list(row) for row in blocks]

    @property
    def n(self) -> int:
        return self.layout.n

    @property
    def shape(self) -> tuple:
        return (self.layout.n,) * self.layout.dim

    def _first(self) -> torch.Tensor:
        i, j = self.layout.local_order()[0]
        return self.blocks[i][j]

    @property
    def dtype(self):
        return self._first().dtype

    @property
    def device(self) -> torch.device:
        return self._first().device

    def local(self) -> list:
        """[(i, j, block)] of this process's blocks in shard order."""
        return [(i, j, self.blocks[i][j]) for i, j in self.layout.local_order()]

    def map(self, fn, *others: "ShardedGrid") -> "ShardedGrid":
        """A grid of the same layout whose block (i, j) is fn(i, j, block,
        *other blocks), over this process's blocks."""
        blocks = [[None] * len(row) for row in self.blocks]
        for i, j, b in self.local():
            blocks[i][j] = fn(i, j, b, *(o.blocks[i][j] for o in others))
        return ShardedGrid(self.layout, blocks)

    def __repr__(self) -> str:
        return (f"ShardedGrid(n={self.n}, rows={self.layout.rows}, cols={self.layout.cols}, "
                f"dtype={self.dtype})")


Level = Union[torch.Tensor, ShardedGrid]


def shard(x: torch.Tensor, layout: Layout) -> ShardedGrid:
    """Split a global (n, n) tensor (or (n, n, n) volume) into the layout's
    blocks, each a copy of its own on its shard's device (this process's
    blocks; every process holds the global tensor)."""
    if tuple(x.shape) != (layout.n,) * layout.dim:
        raise ValueError(f"expected a {(layout.n,) * layout.dim} grid, got {tuple(x.shape)}")
    blocks = [[None] * len(layout.cols) for _ in layout.rows]
    for i, j in layout.local_order():
        (r0, r1), (c0, c1) = layout.rows[i], layout.cols[j]
        b = torch.empty((r1 - r0, c1 - c0) + tuple(x.shape[2:]), dtype=x.dtype,
                        device=layout.devices[i][j])
        blocks[i][j] = b.copy_(x[r0:r1, c0:c1])
    return ShardedGrid(layout, blocks)


# --- between processes ----------------------------------------------------------------

def _dist():
    import torch.distributed as dist

    return dist


def _staged() -> bool:
    """Whether messages go through host memory: every backend but NCCL
    (gloo's point-to-point is not relied on for CUDA tensors)."""
    return _dist().get_backend() != "nccl"


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if _staged() else t


def _all_gather_flat(local: torch.Tensor, sizes: list) -> list:
    """Every process's flat ``local`` (``sizes[r]`` elements on rank r), one
    all_gather of buffers padded to the largest."""
    dist = _dist()
    top = max(sizes)
    buf = _wire(local.reshape(-1))
    if buf.numel() < top:
        buf = torch.cat([buf, buf.new_zeros(top - buf.numel())])
    outs = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, buf.contiguous())
    return [o[:sizes[r]] for r, o in enumerate(outs)]


def _p2p(sends: dict, recvs: dict) -> None:
    """One batched point-to-point round: ``sends[peer]`` and ``recvs[peer]``
    are lists of views, each peer's packed into one message in list order."""
    dist = _dist()
    ops, unpack = [], []
    for peer in sorted(sends):
        buf = _wire(torch.cat([v.reshape(-1) for v in sends[peer]]))
        ops.append(dist.P2POp(dist.isend, buf.contiguous(), peer))
    for peer in sorted(recvs):
        views = recvs[peer]
        dev = "cpu" if _staged() else views[0].device
        buf = torch.empty(sum(v.numel() for v in views), dtype=views[0].dtype, device=dev)
        ops.append(dist.P2POp(dist.irecv, buf, peer))
        unpack.append((buf, views))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for buf, views in unpack:
        off = 0
        for v in views:
            v.copy_(buf[off:off + v.numel()].view(v.shape))
            off += v.numel()


# --- assembling windows ---------------------------------------------------------------

def _blank(shape: tuple, r_lo: int, c_lo: int, n: int, dtype, dev) -> torch.Tensor:
    """An empty window whose cells beyond the grid are 0 (the blocks cover
    the grid, so only those need a fill)."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    if r_lo < 0:
        out[:-r_lo].zero_()
    if r_lo + shape[0] > n:
        out[max(0, n - r_lo):].zero_()
    if c_lo < 0:
        out[:, :-c_lo].zero_()
    if c_lo + shape[1] > n:
        out[:, max(0, n - c_lo):].zero_()
    return out


@dataclasses.dataclass(frozen=True)
class Plan:
    """What one exchange moves (``plan``), in cells of the source: the
    windows of this process's target blocks, the pieces it copies itself,
    sends and receives, and the totals the counters take."""

    windows: tuple       # ((i, j), (r_lo, r_hi, c_lo, c_hi)) of this process's target blocks
    copies: tuple        # ((i, j), k, (a0, a1), (b0, b1)): source k's cells into window (i, j)
    sends: tuple         # (peer, ((k, (a0, a1), (b0, b1)), ...)): source cells for the peer
    recvs: tuple         # (peer, (((i, j), (a0, a1), (b0, b1)), ...)): window cells from it
    pieces: int = 0      # pieces from one shard's block into another shard's window
    cells: int = 0       # their cells
    xproc_pieces: int = 0
    xproc_cells: int = 0
    messages: int = 0    # pairs of processes a piece crosses between, each direction


def _source_bounds(src) -> list:
    """[(entry, owner, (r0, r1), (c0, c1))] of a source: a layout's blocks in
    shard order, or one replicated tensor of size ``src`` every process holds
    (entry and owner None)."""
    if isinstance(src, int):
        return [(None, None, (0, src), (0, src))]
    return [(src.entry(i, j), src.owner(i, j), src.rows[i], src.cols[j]) for i, j in src.order()]


def _sources(x: "Level"):
    """(the source argument of ``plan``, [(entry, owner, rows, cols, block)])
    of a level."""
    if isinstance(x, torch.Tensor):
        src, blocks = x.shape[0], [x]
    else:
        src, blocks = x.layout, [x.blocks[i][j] for i, j in x.layout.order()]
    return src, [b + (blk,) for b, blk in zip(_source_bounds(src), blocks)]


@functools.lru_cache(maxsize=4096)
def _plan(src, src_entries, target: Layout, target_entries, rects: tuple, me) -> Plan:
    del src_entries, target_entries    # in the key only: layouts compare without them
    copies, sends, recvs, windows = [], {}, {}, []
    pieces = cells = xp = xc = 0
    pairs = set()
    srcs = _source_bounds(src)
    for (i, j), (r_lo, r_hi, c_lo, c_hi) in zip(target.order(), rects):
        dst, t_entry = target.owner(i, j), target.entry(i, j)
        here = dst == me
        if here:
            windows.append(((i, j), (r_lo, r_hi, c_lo, c_hi)))
        for k, (entry, owner, (r0, r1), (c0, c1)) in enumerate(srcs):
            if r1 <= r_lo or r0 >= r_hi or c1 <= c_lo or c0 >= c_hi:
                continue
            rows = (max(r0, r_lo), min(r1, r_hi))
            cols = (max(c0, c_lo), min(c1, c_hi))
            owner = dst if owner is None else owner   # a replicated tensor: this copy
            if entry is not None and entry != t_entry:
                size = (rows[1] - rows[0]) * (cols[1] - cols[0])
                pieces += 1
                cells += size
                if owner != dst:
                    xp += 1
                    xc += size
                    pairs.add((owner, dst))
            if here and owner == me:
                copies.append(((i, j), k, rows, cols))
            elif here:
                recvs.setdefault(owner, []).append(((i, j), rows, cols))
            elif owner == me:
                sends.setdefault(dst, []).append((k, rows, cols))
    return Plan(tuple(windows), tuple(copies),
                tuple((p, tuple(v)) for p, v in sorted(sends.items())),
                tuple((p, tuple(v)) for p, v in sorted(recvs.items())),
                pieces, cells, xp, xc, len(pairs))


def plan(src, target: Layout, rects) -> Plan:
    """The pieces of an exchange into ``target``'s windows, ``rects[k]`` =
    (r_lo, r_hi, c_lo, c_hi) of block k in shard order, from ``src``: a
    Layout, or the n of a replicated tensor. Pure (cached): ``exchange``
    moves what it names and ``utils.scaling_model`` counts it."""
    rects = tuple(tuple(r) for r in rects)
    me = None if target.one_process else process_rank()
    src_entries = None if isinstance(src, int) else src.entries
    return _plan(src, src_entries, target, target.entries, rects, me)


def _rank_cells(lay: Layout) -> dict:
    """{rank: cells of its blocks} of a multi-process layout (a volume's
    cell: one (z, y) row of n)."""
    tail = lay.n ** (lay.dim - 2)
    out: dict = {}
    for i, j in lay.order():
        r = lay.owner(i, j)
        out[r] = out.get(r, 0) + ((lay.rows[i][1] - lay.rows[i][0])
                                  * (lay.cols[j][1] - lay.cols[j][0]) * tail)
    return out


def exchange(x: Level, target: Layout, rect) -> dict:
    """{(i, j): window} over this process's blocks of ``target``: window
    (i, j) is rows [r_lo, r_hi) x columns [c_lo, c_hi) of x's global grid
    (0 outside it; a volume's rows are z planes and its columns (0, n)) on
    block (i, j)'s device, where ``rect(i, j)`` gives (r_lo, r_hi, c_lo,
    c_hi). x is a ShardedGrid or a replicated tensor. Collective on a
    multi-process layout: every process calls it with the same arguments, and
    each peer's pieces travel as one message a direction. Counts its pieces
    between shards at level ``target.n``."""
    n = x.shape[0]
    tail = tuple(x.shape[2:])
    dtype = x.dtype
    src, srcs = _sources(x)
    p = plan(src, target, [rect(i, j) for i, j in target.order()])
    _count(target.n).add_exchange(p, dtype.itemsize * n ** len(tail))
    out = {}
    for (i, j), (r_lo, r_hi, c_lo, c_hi) in p.windows:
        out[i, j] = _blank((r_hi - r_lo, c_hi - c_lo) + tail, r_lo, c_lo, n, dtype,
                           target.devices[i][j])
    rect_of = dict(p.windows)

    def win(ij, rows, cols):
        r_lo, _, c_lo, _ = rect_of[ij]
        return out[ij][rows[0] - r_lo:rows[1] - r_lo, cols[0] - c_lo:cols[1] - c_lo]

    def src_view(k, rows, cols):
        _, _, (r0, _), (c0, _), b = srcs[k]
        return b[rows[0] - r0:rows[1] - r0, cols[0] - c0:cols[1] - c0]

    for ij, k, rows, cols in p.copies:
        win(ij, rows, cols).copy_(src_view(k, rows, cols))
    if p.sends or p.recvs:
        _p2p({peer: [src_view(*s) for s in v] for peer, v in p.sends},
             {peer: [win(*r) for r in v] for peer, v in p.recvs})
    return out


def extend_all(x: ShardedGrid, ext_r: int, ext_c: int = 0) -> dict:
    """{(i, j): block (i, j) with ``ext_r`` rows and ``ext_c`` columns of its
    ring neighbours on each side (0 beyond the grid)} over this process's
    blocks: the halo exchange of one pass, one batched exchange. For a
    volume, z block i with ``ext_r`` planes per side (key (i, 0))."""
    lay = x.layout
    if lay.dim == 3:
        return exchange(x, lay, lambda i, j: (lay.rows[i][0] - ext_r, lay.rows[i][1] + ext_r,
                                              0, lay.n))
    return exchange(x, lay, lambda i, j: (lay.rows[i][0] - ext_r, lay.rows[i][1] + ext_r,
                                          lay.cols[j][0] - ext_c, lay.cols[j][1] + ext_c))


def _one_process(x: Level, what: str) -> None:
    if isinstance(x, ShardedGrid) and not x.layout.one_process:
        raise ValueError(f"{what} reads blocks of other processes; use sharded.exchange "
                         f"(every process calls it)")


def gather(x: Level, device=None) -> torch.Tensor:
    """The global tensor of a level (a tensor comes back as it is). On a
    multi-process layout every process calls it and gets the whole level."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    dev = x.device if device is None else torch.device(device)
    lay = x.layout
    _count(x.n).add_gather(lay, x.dtype.itemsize)
    if lay.one_process:
        return torch.cat([torch.cat([b.to(dev) for b in row], dim=1) for row in x.blocks], dim=0)
    tail = (x.n,) if lay.dim == 3 else ()
    own = _rank_cells(lay)
    world = _dist().get_world_size()
    sizes = [own.get(r, 0) for r in range(world)]
    mine = torch.cat([b.reshape(-1) for _, _, b in x.local()])
    bufs = _all_gather_flat(mine, sizes)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    offs = [0] * world
    for i, j in lay.order():
        r = lay.owner(i, j)
        (r0, r1), (c0, c1) = lay.rows[i], lay.cols[j]
        shape = (r1 - r0, c1 - c0) + tail
        size = shape[0] * shape[1] * (tail[0] if tail else 1)
        out[r0:r1, c0:c1].copy_(bufs[r][offs[r]:offs[r] + size].view(shape))
        offs[r] += size
    return out


def window(x: Level, r_lo: int, r_hi: int, c_lo: int, c_hi: int,
           device=None) -> torch.Tensor:
    """Rows [r_lo, r_hi) x columns [c_lo, c_hi) of the global grid (0 outside
    it), assembled on ``device`` by a copy from each block that overlaps (one
    process; ``exchange`` is the collective form)."""
    _one_process(x, "window")
    n = x.shape[0]
    dev = (x.device if device is None else torch.device(device))
    out = _blank((r_hi - r_lo, c_hi - c_lo), r_lo, c_lo, n, x.dtype, dev)
    for _, _, (r0, r1), (c0, c1), b in _sources(x)[1]:
        a0, a1 = max(r0, r_lo), min(r1, r_hi)
        b0, b1 = max(c0, c_lo), min(c1, c_hi)
        if a0 < a1 and b0 < b1:
            out[a0 - r_lo:a1 - r_lo, b0 - c_lo:b1 - c_lo].copy_(
                b[a0 - r0:a1 - r0, b0 - c0:b1 - c0])
    return out


def planes(x: Level, z_lo: int, z_hi: int, device=None) -> torch.Tensor:
    """Planes [z_lo, z_hi) of a volume (0 outside it), assembled on
    ``device`` by a copy from each z block that overlaps (one process;
    ``exchange`` is the collective form)."""
    _one_process(x, "planes")
    n = x.shape[0]
    dev = (x.device if device is None else torch.device(device))
    out = _blank((z_hi - z_lo,) + tuple(x.shape[1:]), z_lo, 0, n, x.dtype, dev)
    for _, _, (z0, z1), _, b in _sources(x)[1]:
        a0, a1 = max(z0, z_lo), min(z1, z_hi)
        if a0 < a1:
            out[a0 - z_lo:a1 - z_lo].copy_(b[a0 - z0:a1 - z0])
    return out


def extend(x: ShardedGrid, i: int, j: int, ext_r: int, ext_c: int = 0) -> torch.Tensor:
    """Block (i, j) with ``ext_r`` rows and ``ext_c`` columns of its ring
    neighbours on each side (0 beyond the grid): the halo exchange of one
    block in one process (``extend_all`` is the collective form). For a
    volume, z block i with ``ext_r`` planes per side."""
    (r0, r1), (c0, c1) = x.layout.rows[i], x.layout.cols[j]
    if x.layout.dim == 3:
        return planes(x, r0 - ext_r, r1 + ext_r, x.layout.devices[i][j])
    return window(x, r0 - ext_r, r1 + ext_r, c0 - ext_c, c1 + ext_c,
                  x.layout.devices[i][j])


def psum(parts, x) -> torch.Tensor:
    """Σ of per-shard partials, added one at a time in shard order on the
    first one's device (every sharded path adds in this order). ``x``: the
    ShardedGrid or Layout the partials are of; the psum is counted at its
    level. On a multi-process layout ``parts`` are this process's partials in
    shard order, every shard's are gathered (an all_gather, never an
    all_reduce, whose order would change the bits) and every process adds
    them all."""
    lay = x.layout if isinstance(x, ShardedGrid) else x
    _count(lay.n).psums += 1
    if not lay.one_process:
        parts = _all_parts(lay, parts)
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def _all_parts(lay: Layout, parts) -> list:
    """Every shard's partial in shard order, on this process's first
    partial's device."""
    dev, one, k = parts[0].device, parts[0].shape, parts[0].numel()
    world = _dist().get_world_size()
    owners = [lay.owner(i, j) for i, j in lay.order()]
    bufs = _all_gather_flat(torch.stack([p.to(dev) for p in parts]),
                            [owners.count(r) * k for r in range(world)])
    offs, out = [0] * world, []
    for r in owners:
        out.append(bufs[r][offs[r]:offs[r] + k].view(one).to(dev))
        offs[r] += k
    return out


def as_level(x: Level, policy, n: int) -> Level:
    """Level n's array in the layout ``policy`` gives it: a ShardedGrid where
    the level is sharded (re-split if its blocks are laid out otherwise), the
    global tensor on this process's first mesh entry where it is
    replicated."""
    lay = layout_of(policy, n)
    if lay is None:
        return gather(x, home(policy, x.device))
    if isinstance(x, ShardedGrid) and x.layout == lay:
        return x
    return shard(gather(x), lay)
