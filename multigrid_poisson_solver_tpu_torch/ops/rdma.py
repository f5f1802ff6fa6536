"""The ring kernels: the halo exchange and the error all-to-all inside the
kernel, for row-sharded levels.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/pallas_rdma.py`` (2-D):

  * ``rdma_jacobi``: ``csrc/rdma_jacobi.cu``, replaces ``_rdma_jacobi_kernel``:
    one fused pass of k <= 8 Jacobi sweeps over every shard, each shard
    posting its edge rows to its neighbours, then from 1.5 M cells a launch
    kernel 17's wavefront pass over its block (a warp waits for a
    neighbour's post before a unit that reads its rows), below that the
    tile pipeline (interior tiles before its boundary tiles wait for theirs;
    ``forced_jacobi_route``); blocks not 16-byte aligned take the tiles;
  * ``rdma_trigger``: ``csrc/rdma_trigger.cu``, replaces
    ``_rdma_trigger_kernel``: the whole |err_k − err_{k−1}| > trigger loop
    over the ring as passes of up to 7 sweeps on kernel 1's wavefront
    (short ones first, as far as the stop is likely), the shards' error
    partials all-to-all once a pass and the stop rule replayed sweep by
    sweep, a pass that overshoots the stop redone from its input.

The JAX kernels run one program per chip and move rows by remote DMA; here
one launch spans the ring (every shard's blocks resident at once), and a
shard talks to the others only through buffers and flags it owns in a
workspace (``csrc/rdma.cuh``). The workspace lives per device, shard count
and width, zeroed once, and carries the tag counter its flags are compared
against: each launch takes tags above every earlier one, so no flag is ever
reset.

Inputs and outputs are ``parallel.sharded.ShardedGrid``s of a rows-only
layout. CPU blocks run the twins: ``rdma_jacobi_torch`` is the halo
exchange followed by the shard-mode twin of the smoother, and
``rdma_trigger_torch`` the loop of one-sweep shard-mode error passes with the
partials added in shard order, the loop ``tests/test_rdma.py`` holds JAX's
kernel to. CUDA blocks launch the kernels; a failure raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from ..parallel.sharded import ShardedGrid
from . import kernels as K

RING_HALO = 8     # rows a receive buffer holds (RING_HALO in csrc/rdma.cuh)
MAX_SHARDS = 16   # MAX_SHARDS in csrc/rdma.cuh
RING_VMEM = 112 * 1024 * 1024   # pallas_rdma.rdma_trigger_fits' budget


def rdma_trigger_fits(rows: int, cp: int, itemsize: int = 4) -> bool:
    """JAX's admission rule for the whole-loop ring kernel
    (``pallas_rdma.rdma_trigger_fits``): the shard's four halo-extended
    buffers and the sweep's temporaries in ~112 MiB of VMEM, on the padded
    shard shape (rows per device, padded lanes). Kept so a level takes the
    same route in both packages."""
    return 7 * (rows + 2 * RING_HALO) * cp * itemsize <= RING_VMEM


class _Workspace:
    """What the shards of one ring own (csrc/rdma.cuh): receive buffers,
    error slots (a pass's sweeps from each sender, by parity), flags and
    arrival counts, and the next free tag."""

    def __init__(self, device, shards: int, n: int):
        self.halo = torch.zeros(shards * 8 * RING_HALO * n, dtype=torch.float32, device=device)
        self.err = torch.zeros(shards * 2 * shards * K.MAX_FUSED_SWEEPS, dtype=torch.float32,
                               device=device)
        self.flags = torch.zeros(shards * shards, dtype=torch.int64, device=device)
        self.count = torch.zeros(2 * shards, dtype=torch.int32, device=device)
        self.tag = 1

    def take(self, count: int) -> int:
        """``count`` consecutive tags above every tag handed out before."""
        tag = self.tag
        self.tag += count
        return tag


_workspaces: dict = {}


def _workspace(device, shards: int, n: int) -> _Workspace:
    key = (device, shards, n)
    if key not in _workspaces:
        _workspaces[key] = _Workspace(device, shards, n)
    return _workspaces[key]


def _check_ring(u: ShardedGrid, f: ShardedGrid, min_rows: int):
    """Validate a ring launch; return (library, stream, device, row starts)."""
    from . import build

    lay = f.layout
    shards = len(lay.rows)
    if len(lay.cols) != 1:
        raise ValueError("the ring kernels take row-sharded levels; a block layout keeps the "
                         "exchange path")
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"the ring kernels take 1..{MAX_SHARDS} shards, got {shards}")
    if u.layout != lay:
        raise ValueError("u and f must share one layout")
    dev = f.device
    if any(d != dev for row in lay.devices for d in row):
        raise ValueError("one ring launch runs on one device: every shard must live there")
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"the ring kernels run on the current CUDA device, got {dev}")
    for i, (r0, r1) in enumerate(lay.rows):
        if r1 - r0 < min_rows:
            raise ValueError(f"shard {i} owns {r1 - r0} rows; the pass needs {min_rows}")
        for name, x in (("u", u), ("f", f)):
            K._check(f"{name}[{i}]", x.blocks[i][0], (r1 - r0, lay.n), dev)
    row0s = [r0 for r0, _ in lay.rows] + [lay.n]
    return build.load(), torch.cuda.current_stream(dev).cuda_stream, dev, row0s


def _ptrs(blocks):
    """The blocks' device addresses as a C array (0 for None)."""
    return K._c_array(ctypes.c_uint64, [0 if b is None else b.data_ptr() for b in blocks])


def _blocks(x: ShardedGrid):
    return [row[0] for row in x.blocks]


def _grid_of(x: ShardedGrid, blocks) -> ShardedGrid:
    return ShardedGrid(x.layout, [[b] for b in blocks])


def rdma_jacobi_torch(u: ShardedGrid, f: ShardedGrid, h: float, steps: int,
                      omega: float = 1.0, from_zero: bool = False) -> ShardedGrid:
    """Twin of ``rdma_jacobi``: the halo exchange, then the shard-mode twin
    of the smoother on every shard (``sharded_fused_jacobi`` on the twins)."""
    from ..parallel.kernel_shard import sharded_fused_jacobi_torch

    return sharded_fused_jacobi_torch(u, f, h, steps, omega, from_zero)


def rdma_jacobi(u: ShardedGrid, f: ShardedGrid, h: float, steps: int, omega: float = 1.0,
                from_zero: bool = False) -> ShardedGrid:
    """``steps`` <= 8 damped-Jacobi sweeps of a row-sharded level in one
    launch over the ring, the halos exchanged inside it (counterpart of
    ``_rdma_jacobi_shard_call`` on every shard). ``from_zero``: u ≡ 0 and is
    not read (u may be f). Owned cells are the exchange path's, bit for bit."""
    if not f.device.type == "cuda":
        return rdma_jacobi_torch(u, f, h, steps, omega, from_zero)
    K._check_steps(steps)
    lib, stream, dev, row0s = _check_ring(f if from_zero else u, f, steps)
    shards, n = len(row0s) - 1, f.n
    ws = _workspace(dev, shards, n)
    out = [torch.empty_like(b) for b in _blocks(f)]
    rc = lib.mg_rdma_jacobi(_ptrs(_blocks(f if from_zero else u)), _ptrs(_blocks(f)), _ptrs(out),
                            K._c_array(ctypes.c_int, row0s), shards, n, steps, int(from_zero),
                            ws.halo.data_ptr(), ws.flags.data_ptr(), ws.count.data_ptr(),
                            ws.take(1), h * h, omega, K._zero_coef(h, omega), stream)
    K._raise_on(lib, rc, "rdma_jacobi")
    K.launches["rdma_jacobi"] += 1
    return _grid_of(f, out)


_JACOBI_ROUTES = {"tile": 1, "wave": 2}


@contextlib.contextmanager
def forced_jacobi_route(route: str):
    """``rdma_jacobi``'s launches on one route, ``"tile"`` (legs.cuh's tile
    pipeline) or ``"wave"`` (kernel 17's wavefront pass), instead of the one
    its size rule picks (``RING_WAVE_CELLS`` in csrc/rdma_jacobi.cu): lets a
    check or a timing reach both at any size. Both are bit for bit the
    exchange path's."""
    from . import build

    lib = build.load()
    K._raise_on(lib, lib.mg_rdma_jacobi_force_route(_JACOBI_ROUTES[route]), "rdma_jacobi route")
    try:
        yield
    finally:
        lib.mg_rdma_jacobi_force_route(0)


def rdma_trigger_torch(u: ShardedGrid, f: ShardedGrid, h: float, omega: float = 1.0,
                       compat=True, trigger: float = 0.01, max_sweeps: int = 100_000):
    """Twin of ``rdma_trigger``: the loop of one-sweep sharded error passes
    on the shard-mode twins, partials added in shard order, with the
    reference's stop rule. Returns (u, err, sweeps)."""
    from ..parallel.kernel_shard import sharded_fused_jacobi_err_torch
    from ..solver import trigger_loop

    u, err, sweeps = trigger_loop(
        lambda v: sharded_fused_jacobi_err_torch(v, f, h, 1, omega, compat), u, trigger,
        max_sweeps)
    return u, err, torch.tensor(sweeps, dtype=torch.int32, device=f.device)


@contextlib.contextmanager
def forced_trigger_batch(batch: int):
    """``rdma_trigger``'s launches with passes of ``batch`` sweeps (1..8,
    still capped at 7 for the cpu and clean metrics and by the shards' rows)
    instead of the kernel's lengths: lets a check reach every pass length.
    The iterate, the stop sweep and the error do not depend on it."""
    from . import build

    lib = build.load()
    K._raise_on(lib, lib.mg_rdma_force_batch(batch), "rdma_trigger batch")
    try:
        yield
    finally:
        lib.mg_rdma_force_batch(0)


def rdma_trigger(u: ShardedGrid, f: ShardedGrid, h: float, omega: float = 1.0, compat=True,
                 trigger: float = 0.01, max_sweeps: int = 100_000):
    """The whole error-triggered loop of a row-sharded level in one launch
    over the ring (counterpart of ``_rdma_trigger_shard_call`` on every
    shard): one sweep at a time while |err_k − err_{k−1}| > trigger, at most
    ``max_sweeps``. Returns (u, err, sweeps), ``sweeps`` a 0-d int32 tensor;
    the iterate, the stop sweep and the error are those of the loop of
    one-sweep sharded error passes (``parallel.kernel_shard.
    sharded_fused_jacobi_err`` with steps=1), bit for bit."""
    if not f.device.type == "cuda":
        return rdma_trigger_torch(u, f, h, omega, compat, trigger, max_sweeps)
    if not 1 <= max_sweeps < 2 ** 31:
        raise ValueError(f"max_sweeps must lie in 1..2**31 − 1, got {max_sweeps}")
    mode = K.err_mode_of(compat)
    lib, stream, dev, row0s = _check_ring(u, f, 2)
    shards, n = len(row0s) - 1, f.n
    ws = _workspace(dev, shards, n)
    out = [torch.empty_like(b) for b in _blocks(f)]
    tmp = [torch.empty_like(b) for b in _blocks(f)]
    tiles = sum(lib.mg_num_tiles_block(r1 - r0, n) for r0, r1 in f.layout.rows)
    partials = torch.empty(K.MAX_FUSED_SWEEPS * tiles, dtype=torch.float32, device=dev)
    err = torch.empty(1, dtype=torch.float32, device=dev)
    sweeps = torch.empty(1, dtype=torch.int32, device=dev)
    # the passes copy rows of u and f in 16-byte chunks
    ub, fb = [K._aligned(b) for b in _blocks(u)], [K._aligned(b) for b in _blocks(f)]
    rc = lib.mg_rdma_trigger(_ptrs(ub), _ptrs(fb), _ptrs(out), _ptrs(tmp),
                             K._c_array(ctypes.c_int, row0s), shards, n, partials.data_ptr(),
                             ws.halo.data_ptr(), ws.err.data_ptr(), ws.flags.data_ptr(),
                             ws.count.data_ptr(), err.data_ptr(), sweeps.data_ptr(),
                             K._ERR_CODES[mode], h * h, omega, 1.0 / (h * h),
                             K.shard_err_scale(mode, n, h), trigger, max_sweeps,
                             ws.take(max_sweeps + 2), stream)
    K._raise_on(lib, rc, "rdma_trigger")
    K.launches["rdma_trigger"] += 1
    return _grid_of(f, out), err.reshape(()), sweeps.reshape(())
