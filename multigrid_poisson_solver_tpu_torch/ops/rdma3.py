"""The 3-D ring kernels: the plane-halo exchange and the error all-to-all
inside the kernel, for z-sharded levels.

PyTorch port of ``multigrid_poisson_solver_tpu/ops/pallas_rdma3.py``:

  * ``rdma_jacobi3``: ``csrc/rdma_jacobi3.cu``, replaces
    ``_rdma_jacobi3_kernel``: one fused pass of k <= 8 sweeps over every
    shard, plain, from zero, or with the clean or gpu error of the result;
  * ``rdma_descend3``: ``csrc/rdma_descend3.cu``, replaces
    ``_rdma_descend3_kernel``: the whole descend leg (sweeps, −r, its 2:1
    restriction, the clean error) over every shard;
  * ``rdma_ascend3``: ``csrc/rdma_ascend3.cu``, replaces
    ``_rdma_ascend3_kernel``: the whole ascend leg (prolongation, add,
    post-sweeps, optionally the clean error) over every shard;
  * ``rdma_trigger3``: ``csrc/rdma_trigger3.cu``, replaces
    ``_rdma_trigger3_kernel``: the whole |err_k − err_{k−1}| > trigger loop
    over the ring, the shards' raw error sums all-to-all per sweep.

The JAX kernels run one program per chip and move planes by remote DMA;
here one launch spans the ring (every shard's blocks resident at once), and
a shard talks to the others only through buffers and flags it owns in a
workspace (``csrc/rdma3.cuh``). The workspace lives per device, shard count
and n, zeroed once, apart from the 2-D rings' (``ops.rdma``), and carries
the tag counter its flags are compared against: each launch takes tags
above every earlier one, so no flag is ever reset. Per shard it holds
receive buffers of ``RING3_HALO`` (8) planes a side for u (two parities),
for f and for the ascend leg's coarse correction, float64 error slots per
parity and sender, 64-bit flags per sender and two arrival counts: at 513³
on 8 shards 8 planes of 513² floats are 8.4 MB a side and array, about
440 MB for the ring.

Every shard uses its shard-mode launch's tile plan (``ops.kernels3.plan3``
of its depth, ``err_plan3`` in the trigger loop), so its owned planes and
its raw float64 error sum are those of the exchange path
(``parallel.kernel_shard3``), bit for bit; the wrappers return the raw sums
per shard and the callers add them in shard order and scale them once.

Routing copies JAX's admission predicates (``rdma_*3_fits``) and the brick
geometry they call (``pallas3d._brick_geometry``): TPU VMEM arithmetic on
JAX's planes per device and padded (rp, cp), kept only so that a level
takes the same route in both packages. The kernels here do not use it.

Inputs and outputs are ``parallel.sharded.ShardedGrid``s of a z layout.
CPU blocks run the twins, the exchange path on the shard-mode twins
(``ops.kernels3.*_shard_torch`` on windows from ``sharded.extend``), which
is what JAX's tests hold its ring kernels to. CUDA blocks launch the
kernels; a failure raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models import poisson3d as p3
from ..parallel import halo3
from ..parallel.sharded import Layout, ShardedGrid, each_shard, extend, planes
from . import kernels as K
from . import kernels3 as K3
from .rdma import _blocks, _grid_of, _ptrs

RING3_HALO = 8     # planes a receive buffer holds a side (RING3_HALO in csrc/legs3.cuh)
MAX_SHARDS3 = 16   # MAX_SHARDS3 in csrc/rdma3.cuh

# pallas_rdma3's VMEM budgets (routing only)
RDMA3_BRICK_BUDGET = 40 * 1024 * 1024
RDMA3_DESCEND_BRICK_BUDGET = 56 * 1024 * 1024
MAX_RDMA3_BRICKS = 32
_MIB = 1024 * 1024


# --- JAX's admission predicates (routing only) ---------------------------------------

def padded_rc(n: int) -> tuple[int, int]:
    """JAX's padded (rp, cp) of an n³ level (``pallas3d.padded_shape3``),
    the shape its ring predicates take."""
    return K3._padded3(n)[1:]


def _brick_geometry(nz: int, rp: int, cp: int, itemsize: int, z_halo: int, num_bufs: float,
                    budget: int, orow_mult: int = 8, oz_even: bool = False, r_halo: int = 8,
                    zs_even: bool = False):
    """(zs, rs, oz, orow) of JAX's brick search (``pallas3d._brick_geometry``);
    ValueError when no brick fits."""
    best = None
    r_lo = max(3 * r_halo, 2 * orow_mult)
    for rs in range(r_lo, min(rp, 512) + 1, 8):
        if rs < rp and (rs - 2 * r_halo) % orow_mult:
            continue
        zs = min(int(budget // (num_bufs * rs * cp * itemsize)), nz)
        orow = rp if rs >= rp else rs - 2 * r_halo
        if zs >= nz:
            oz = nz
        else:
            if zs_even and zs % 2:
                zs -= 1
            oz = zs - 2 * z_halo
            if oz_even and oz % 2:
                zs -= 1
                oz -= 1
        if oz < 1 or orow < 8:
            continue
        cost = (zs * rs) / (oz * orow)
        if best is None or cost < best[0] - 1e-9:
            best = (cost, zs, rs, oz, orow)
    if best is None:
        raise ValueError(f"no 3-D brick fits VMEM for rp={rp} cp={cp} (grid too wide)")
    return best[1:]


def rdma_trigger3_fits(nl: int, rp: int, cp: int, itemsize: int = 4) -> bool:
    """``pallas_rdma3.rdma_trigger3_fits``: the shard's (nl + 2)-plane
    iterate, its nl-plane source and temporaries in ~112 MiB."""
    return (2 * nl + 2 + 6) * rp * cp * itemsize <= 112 * _MIB


def _rdma_jacobi3_geometry(nl: int, rp: int, cp: int, ext: int, itemsize: int = 4):
    nz_e = nl + 2 * ext
    zs, rs, oz, orow = _brick_geometry(nz_e, rp, cp, itemsize, ext, 6.0, RDMA3_BRICK_BUDGET)
    oz = nl if zs >= nz_e else min(oz, nl)
    num_zb = math.ceil(nl / oz) if zs < nz_e else 1
    num_rb = math.ceil(rp / orow) if rs < rp else 1
    return zs, rs, oz, orow, num_zb, num_rb


def rdma_jacobi3_fits(nl: int, rp: int, cp: int, steps: int, itemsize: int = 4,
                      err: bool = False) -> bool:
    """``pallas_rdma3.rdma_jacobi3_fits``: the ext-plane halos of u and f and
    the brick working set in VMEM, the brick schedule within 32 bricks;
    ``err`` (the clean metric) takes one more halo plane."""
    ext = steps + int(err)
    if ext > min(nl, 8) or steps < 1:
        return False
    try:
        zs, rs, _, _, num_zb, num_rb = _rdma_jacobi3_geometry(nl, rp, cp, ext, itemsize)
    except ValueError:
        return False
    total = 4 * ext * rp * cp * itemsize + 6 * zs * rs * cp * itemsize
    return num_zb * num_rb <= MAX_RDMA3_BRICKS and total + 16 * _MIB <= 126 * _MIB


def _rdma_descend3_geometry(nl: int, rp: int, cp: int, ext: int, itemsize: int = 4):
    nz_e = nl + 2 * ext
    zs, rs, oz, orow = _brick_geometry(nz_e, rp, cp, itemsize, ext, 6.6,
                                       RDMA3_DESCEND_BRICK_BUDGET, orow_mult=16, oz_even=True)
    oz = min(oz, nl - nl % 2) if zs < nz_e else nl
    num_zb = math.ceil(nl / oz) if zs < nz_e else 1
    num_rb = math.ceil(rp / orow) if rs < rp else 1
    ozc = nl // 2 if zs >= nz_e else oz // 2
    return zs, rs, oz, orow, num_zb, num_rb, ozc


def rdma_descend3_fits(nl: int, rp: int, cp: int, steps: int, from_zero: bool = True,
                       itemsize: int = 4, fw: bool = True) -> bool:
    """``pallas_rdma3.rdma_descend3_fits``: a (k_nb + 2)-plane (full
    weighting) or (k_nb + 1)-plane halo within min(nl, 8), nl even, and the
    brick working set with the decimation scratch in VMEM."""
    k_nb = steps - 1 if from_zero else steps
    ext = k_nb + (2 if fw else 1)
    if not (1 <= steps and 1 <= k_nb and ext <= min(nl, 8) and nl % 2 == 0):
        return False
    try:
        zs, rs, _, orow, num_zb, num_rb, ozc = _rdma_descend3_geometry(nl, rp, cp, ext, itemsize)
    except ValueError:
        return False
    total = (4 * ext * rp * cp * itemsize
             + (6 * zs * rs + rs + 2 * ozc * (orow // 2)) * cp * itemsize)
    return num_zb * num_rb <= MAX_RDMA3_BRICKS and total + 16 * _MIB <= 126 * _MIB


def _rdma_ascend3_geometry(nl: int, rp: int, cp: int, ext_z: int, itemsize: int = 4):
    nz_e = nl + 2 * ext_z
    zs, rs, oz, orow = _brick_geometry(nz_e, rp, cp, itemsize, ext_z, 6.6,
                                       RDMA3_DESCEND_BRICK_BUDGET, orow_mult=16, r_halo=16,
                                       zs_even=True)
    oz = nl if zs >= nz_e else min(oz, nl)
    num_zb = math.ceil(nl / oz) if zs < nz_e else 1
    num_rb = math.ceil(rp / orow) if rs < rp else 1
    czs = (nz_e // 2 + 1) if zs >= nz_e else zs // 2 + 1
    crs = min(rs // 2 + 8, rp // 2 + 8)
    return zs, rs, oz, orow, num_zb, num_rb, czs, crs


def rdma_ascend3_fits(nl: int, rp: int, cp: int, steps: int, err: bool = False,
                      itemsize: int = 4) -> bool:
    """``pallas_rdma3.rdma_ascend3_fits``: an even ext_z-plane fine halo and
    ext_c + 1 coarse planes within the shard, nl even, and the working set
    in VMEM."""
    z_halo = steps + int(err)
    ext_z = z_halo + z_halo % 2
    ext_c = ext_z // 2
    if not (1 <= steps <= 8 and ext_z <= min(nl, 8) and nl % 2 == 0 and ext_c + 1 <= nl // 2):
        return False
    cplane = (rp // 2 + 8) * cp * itemsize
    try:
        zs, rs, _, _, num_zb, num_rb, czs, crs = _rdma_ascend3_geometry(nl, rp, cp, ext_z,
                                                                        itemsize)
    except ValueError:
        return False
    total = (4 * ext_z * rp * cp * itemsize + (2 * ext_c + 1) * cplane
             + (6 * zs * rs + 2 * czs * crs) * cp * itemsize)
    return num_zb * num_rb <= MAX_RDMA3_BRICKS and total + 16 * _MIB <= 126 * _MIB


# --- the workspace -------------------------------------------------------------------

class _Workspace3:
    """What the shards of one 3-D ring own (csrc/rdma3.cuh): receive buffers
    of u (two parities), f and the coarse correction, float64 error slots,
    flags and arrival counts, and the next free tag."""

    def __init__(self, device, shards: int, n: int):
        m = (n + 1) // 2
        f32 = dict(dtype=torch.float32, device=device)
        self.ubuf = torch.zeros(shards * 4 * RING3_HALO * n * n, **f32)
        self.fbuf = torch.zeros(shards * 2 * RING3_HALO * n * n, **f32)
        self.cbuf = torch.zeros(shards * 2 * RING3_HALO * m * m, **f32)
        self.err = torch.zeros(shards * 2 * shards, dtype=torch.float64, device=device)
        self.flags = torch.zeros(shards * shards, dtype=torch.int64, device=device)
        self.count = torch.zeros(2 * shards, dtype=torch.int32, device=device)
        self.ptrs = K._c_array(ctypes.c_uint64, [t.data_ptr() for t in (
            self.ubuf, self.fbuf, self.cbuf, self.err, self.flags, self.count)])
        self.tag = 1

    def take(self, count: int) -> int:
        """``count`` consecutive tags above every tag handed out before."""
        tag = self.tag
        self.tag += count
        return tag


_workspaces: dict = {}


def _workspace(device, shards: int, n: int) -> _Workspace3:
    key = (device, shards, n)
    if key not in _workspaces:
        _workspaces[key] = _Workspace3(device, shards, n)
    return _workspaces[key]


# --- shared plumbing ---------------------------------------------------------------

def coarse_layout3(x: ShardedGrid) -> Layout:
    """The coarse planes each shard of x holds for a 2:1 leg: [z0 / 2,
    (z1 + 1) / 2) of its block [z0, z1) (``sharded_fused_descend3``'s coarse
    slabs; the ascend leg's coarse blocks)."""
    lay, m = x.layout, (x.n + 1) // 2
    half = tuple((a // 2, (b + 1) // 2) for a, b in lay.rows)
    return Layout(m, half, ((0, m),), lay.devices, 3)


def _check_ring3(u, f: ShardedGrid, even: bool = False):
    """Validate a ring launch; return (library, stream, device, z origins)."""
    from . import build

    lay = f.layout
    shards = len(lay.rows)
    if lay.dim != 3 or len(lay.cols) != 1:
        raise ValueError("the 3-D ring kernels take z-sharded volumes")
    if not 1 <= shards <= MAX_SHARDS3:
        raise ValueError(f"the 3-D ring kernels take 1..{MAX_SHARDS3} shards, got {shards}")
    if u is not None and u.layout != lay:
        raise ValueError("u and f must share one layout")
    dev = f.device
    if any(d != dev for row in lay.devices for d in row):
        raise ValueError("one ring launch runs on one device: every shard must live there")
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"the ring kernels run on the current CUDA device, got {dev}")
    n = lay.n
    for i, (z0, z1) in enumerate(lay.rows):
        if even and z0 % 2:
            raise ValueError(f"a 2:1 leg needs even shard origins, shard {i} starts at {z0}")
        for name, x in (("u", u), ("f", f)):
            if x is not None:
                K._check(f"{name}[{i}]", x.blocks[i][0], (z1 - z0, n, n), dev)
                if not x.blocks[i][0].is_contiguous():
                    raise ValueError(f"{name}[{i}] must be contiguous")
    z0s = [z0 for z0, _ in lay.rows] + [n]
    return build.load(), torch.cuda.current_stream(dev).cuda_stream, dev, z0s


def _plans(f: ShardedGrid, stages: int, halo: int, err_plan: bool = False):
    """Each shard's tile plan, its shard-mode launch's: ((ty, tx), [cz])."""
    plans = [K3.err_plan3(z1 - z0) if err_plan else K3.plan3(z1 - z0, stages, halo)
             for z0, z1 in f.layout.rows]
    if len({p[:2] for p in plans}) != 1:
        raise ValueError(f"the shards' tile plans differ in (ty, tx): {plans}")
    return plans[0][:2], [p[2] for p in plans]


def _partials(f: ShardedGrid, tile, czs, want: bool):
    """(float64 tile partials of every shard, raw sums (shards,)) or Nones."""
    if not want:
        return None, None
    rows = f.layout.rows
    count = sum(K3.blocks3(f.n, *tile, cz, nz=z1 - z0) for cz, (z0, z1) in zip(czs, rows))
    return (torch.empty(count, dtype=torch.float64, device=f.device),
            torch.empty(len(rows), dtype=torch.float64, device=f.device))


def _raws(raw):
    return None if raw is None else list(raw)


# --- kernel 20: the ring smoother ------------------------------------------------------

def rdma_jacobi3_torch(u, f: ShardedGrid, h: float, steps: int, omega: float = 6.0 / 7.0,
                       from_zero: bool = False, err_mode=None):
    """Twin of ``rdma_jacobi3``: the plane exchange (windows of the pass's
    halo), then the shard-mode twin of kernel 10 on every shard."""
    ext = steps - int(from_zero) + int(err_mode == "clean")
    res = each_shard(f, lambda i: K3.fused_jacobi3_shard_torch(
        None if from_zero else extend(u, i, 0, ext), extend(f, i, 0, ext),
        halo3.geo3(f, i, ext), h, steps, omega, from_zero, err_mode))
    return _grid_of(f, [b for b, _ in res]), (None if err_mode is None
                                              else [raw for _, raw in res])


def rdma_jacobi3(u, f: ShardedGrid, h: float, steps: int, omega: float = 6.0 / 7.0,
                 from_zero: bool = False, err_mode=None):
    """``steps`` <= 8 sweeps of a z-sharded level in one launch over the ring,
    the plane halos exchanged inside it (counterpart of
    ``_rdma_jacobi3_shard_call`` on every shard). ``from_zero``: u ≡ 0 and
    is not read (u may be None). ``err_mode`` None, "clean" (at most 7
    sweeps after the closed-form one) or "gpu". Returns (u, the shards' raw
    float64 error sums or None); owned planes and raw sums are the exchange
    path's, bit for bit."""
    if err_mode not in (None, "clean", "gpu"):
        raise ValueError(f"unknown err_mode {err_mode!r}; expected None, 'clean' or 'gpu'")
    K3._check_steps3(steps, K3.MAX_FUSED_SWEEPS_3D, "rdma_jacobi3")
    stages = steps - int(from_zero) + int(err_mode == "clean")
    if stages > K3.MAX_FUSED_SWEEPS_3D:
        raise ValueError("the fused clean error needs at most 7 neighbor-reading sweeps")
    if not f.device.type == "cuda":
        return rdma_jacobi3_torch(u, f, h, steps, omega, from_zero, err_mode)
    lib, stream, dev, z0s = _check_ring3(None if from_zero else u, f)
    shards, n = len(z0s) - 1, f.n
    tile, czs = _plans(f, stages, stages)
    partials, raw = _partials(f, tile, czs, err_mode is not None)
    ws = _workspace(dev, shards, n)
    out = [torch.empty_like(b) for b in _blocks(f)]
    rc = lib.mg3_rdma_jacobi(_ptrs(_blocks(f if from_zero else u)), _ptrs(_blocks(f)),
                             _ptrs(out), K._c_array(ctypes.c_int, z0s),
                             K._c_array(ctypes.c_int, czs), shards, n, steps, int(from_zero),
                             K3._ERR_CODES3[err_mode], *tile, K._ptr(partials), K._ptr(raw),
                             ws.ptrs, ws.take(1), h * h, omega / 6.0, 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "rdma_jacobi3")
    K.launches["rdma_jacobi3"] += 1
    return _grid_of(f, out), _raws(raw)


# --- kernel 21: the ring descend leg -----------------------------------------------------

def _check_descend3(steps: int, from_zero: bool, restriction: str, f: ShardedGrid):
    fw = restriction == "full_weighting"
    if not fw and restriction != "sampling":
        raise ValueError(f"unknown restriction mode {restriction!r}")
    cap = K3.MAX_DESCEND3_SWEEPS_FW if fw else K3.MAX_DESCEND3_SWEEPS_SAMPLING
    if steps < 1 or not 0 <= steps - int(from_zero) <= cap:
        raise ValueError(f"the {restriction} descend leg runs 1..{cap} neighbor-reading "
                         f"sweeps, got steps={steps}, from_zero={from_zero}")
    if f.n % 2 == 0:
        raise ValueError(f"a 2:1 leg needs an odd level, got {f.n}")
    return fw


def rdma_descend3_torch(u, f: ShardedGrid, h: float, steps: int, omega: float = 6.0 / 7.0,
                        from_zero: bool = False, restriction: str = "full_weighting",
                        want_err: bool = False):
    """Twin of ``rdma_descend3``: the plane exchange, then the shard-mode
    twin of kernel 11 on every shard."""
    fw = _check_descend3(steps, from_zero, restriction, f)
    ext = steps - int(from_zero) + 1 + int(fw)
    res = each_shard(f, lambda i: K3.fused_descend3_shard_torch(
        None if from_zero else extend(u, i, 0, ext), extend(f, i, 0, ext),
        halo3.geo3(f, i, ext), h, steps, omega, from_zero, restriction, want_err))
    fc = ShardedGrid(coarse_layout3(f), [[c] for _, c, _ in res])
    return _grid_of(f, [b for b, _, _ in res]), fc, ([raw for _, _, raw in res] if want_err
                                                     else None)


def rdma_descend3(u, f: ShardedGrid, h: float, steps: int, omega: float = 6.0 / 7.0,
                  from_zero: bool = False, restriction: str = "full_weighting",
                  want_err: bool = False):
    """The whole descend leg of an aligned z-sharded level n = 2m − 1 (even
    shard origins) in one launch over the ring, the plane halos exchanged
    inside it (counterpart of ``_rdma_descend3_shard_call`` on every shard):
    sweeps, −r and its restriction onto each shard's coarse planes, with the
    clean error when ``want_err``. Returns (u, the coarse right-hand side in
    ``coarse_layout3``, the shards' raw sums or None), the exchange path's
    bit for bit."""
    fw = _check_descend3(steps, from_zero, restriction, f)
    if not f.device.type == "cuda":
        return rdma_descend3_torch(u, f, h, steps, omega, from_zero, restriction, want_err)
    lib, stream, dev, z0s = _check_ring3(None if from_zero else u, f, even=True)
    shards, n, m = len(z0s) - 1, f.n, (f.n + 1) // 2
    stages = steps - int(from_zero) + 1
    tile, czs = _plans(f, stages, stages + int(fw))
    partials, raw = _partials(f, tile, czs, want_err)
    clay = coarse_layout3(f)
    fc = [torch.empty((k1 - k0, m, m), dtype=f.dtype, device=dev) for k0, k1 in clay.rows]
    ws = _workspace(dev, shards, n)
    out = [torch.empty_like(b) for b in _blocks(f)]
    rc = lib.mg3_rdma_descend(_ptrs(_blocks(f if from_zero else u)), _ptrs(_blocks(f)),
                              _ptrs(out), _ptrs(fc), K._c_array(ctypes.c_int, z0s),
                              K._c_array(ctypes.c_int, czs), shards, n, steps, int(from_zero),
                              int(fw), int(want_err), *tile, K._ptr(partials), K._ptr(raw),
                              ws.ptrs, ws.take(1), h * h, omega / 6.0, 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "rdma_descend3")
    K.launches["rdma_descend3"] += 1
    return _grid_of(f, out), ShardedGrid(clay, [[c] for c in fc]), _raws(raw)


# --- kernel 22: the ring ascend leg --------------------------------------------------------

def _coarse_blocks(child, f: ShardedGrid):
    """The coarse correction ``child`` ((m, m, m): a tensor or a ShardedGrid in
    any layout) as the blocks of ``coarse_layout3(f)``: views where it is one
    tensor on the device or already laid out so, else copies."""
    clay = coarse_layout3(f)
    if isinstance(child, ShardedGrid) and child.layout == clay:
        return _blocks(child)
    if isinstance(child, torch.Tensor) and child.device == f.device and child.is_contiguous():
        return [child[k0:k1] for k0, k1 in clay.rows]
    return [planes(child, k0, k1, f.device) for k0, k1 in clay.rows]


def rdma_ascend3_torch(u: ShardedGrid, f: ShardedGrid, child, h: float, steps: int,
                       omega: float = 6.0 / 7.0, want_err: bool = False):
    """Twin of ``rdma_ascend3``: the fine and coarse plane exchange, then the
    shard-mode twin of kernel 12 on every shard."""
    stages = steps + int(want_err)
    ext_c = (stages + 1) // 2

    def one(i):
        z0, z1 = f.layout.rows[i]
        cz0 = z0 // 2 - ext_c
        c_win = planes(child, cz0, (z1 + 1) // 2 + ext_c + 1, f.layout.devices[i][0])
        return K3.fused_ascend3_shard_torch(extend(u, i, 0, stages), extend(f, i, 0, stages),
                                            c_win, cz0, halo3.geo3(f, i, stages), h, steps,
                                            omega, want_err)

    res = each_shard(f, one)
    return _grid_of(f, [b for b, _ in res]), ([raw for _, raw in res] if want_err else None)


def rdma_ascend3(u: ShardedGrid, f: ShardedGrid, child, h: float, steps: int,
                 omega: float = 6.0 / 7.0, want_err: bool = False):
    """The whole ascend leg of an aligned z-sharded level n = 2m − 1 (even
    shard origins) in one launch over the ring (counterpart of
    ``_rdma_ascend3_shard_call`` on every shard): the correction ``child``
    ((m, m, m), a tensor or a ShardedGrid) prolonged and added, then
    ``steps`` <= 8 sweeps (7 with ``want_err``, the clean error). The fine
    and coarse halo planes move inside the launch. Returns (u, the shards'
    raw sums or None), the exchange path's bit for bit."""
    K3._check_steps3(steps, K3.MAX_FUSED_SWEEPS_3D - int(want_err), "rdma_ascend3")
    if f.n % 2 == 0:
        raise ValueError(f"a 2:1 leg needs an odd level, got {f.n}")
    if not f.device.type == "cuda":
        return rdma_ascend3_torch(u, f, child, h, steps, omega, want_err)
    lib, stream, dev, z0s = _check_ring3(u, f, even=True)
    shards, n, m = len(z0s) - 1, f.n, (f.n + 1) // 2
    stages = steps + int(want_err)
    tile, czs = _plans(f, stages, stages)
    cblocks = _coarse_blocks(child, f)
    for i, (c, (k0, k1)) in enumerate(zip(cblocks, coarse_layout3(f).rows)):
        K._check(f"child[{i}]", c, (k1 - k0, m, m), dev)
    partials, raw = _partials(f, tile, czs, want_err)
    ws = _workspace(dev, shards, n)
    out = [torch.empty_like(b) for b in _blocks(f)]
    rc = lib.mg3_rdma_ascend(_ptrs(_blocks(u)), _ptrs(_blocks(f)), _ptrs(cblocks), _ptrs(out),
                             K._c_array(ctypes.c_int, z0s), K._c_array(ctypes.c_int, czs),
                             shards, n, steps, K3._ERR_CODES3["clean" if want_err else None],
                             *tile, K._ptr(partials), K._ptr(raw), ws.ptrs, ws.take(1), h * h,
                             omega / 6.0, 1.0 / (h * h), stream)
    K._raise_on(lib, rc, "rdma_ascend3")
    K.launches["rdma_ascend3"] += 1
    return _grid_of(f, out), _raws(raw)


# --- kernel 19: the ring trigger loop --------------------------------------------------------

def rdma_trigger3_torch(u: ShardedGrid, f: ShardedGrid, h: float, omega: float = 6.0 / 7.0,
                        compat: str = "clean", trigger: float = 0.01,
                        max_sweeps: int = 100_000):
    """Twin of ``rdma_trigger3``: the loop of one-sweep sharded error passes
    on the shard-mode twins, raw sums added in shard order, with the
    reference's stop rule. Returns (u, err, sweeps)."""
    from ..solver import trigger_loop

    K3._check_compat3(compat)
    ext = 1 + int(compat == "clean")

    def step(v):
        res = each_shard(f, lambda i: K3.fused_jacobi3_shard_torch(
            extend(v, i, 0, ext), extend(f, i, 0, ext), halo3.geo3(f, i, ext), h, 1, omega,
            False, compat))
        return (_grid_of(f, [b for b, _ in res]),
                halo3.sum_err3([raw for _, raw in res], compat, f.n, h, f.dtype))

    u, err, sweeps = trigger_loop(step, u, trigger, max_sweeps)
    return u, err, torch.tensor(sweeps, dtype=torch.int32, device=f.device)


def rdma_trigger3(u: ShardedGrid, f: ShardedGrid, h: float, omega: float = 6.0 / 7.0,
                  compat: str = "clean", trigger: float = 0.01, max_sweeps: int = 100_000):
    """The whole error-triggered loop of a z-sharded level in one launch over
    the ring (counterpart of ``_rdma_trigger3_shard_call`` on every shard):
    one sweep at a time while |err_k − err_{k−1}| > trigger, at most
    ``max_sweeps``. Returns (u, err, sweeps), ``sweeps`` a 0-d int32 tensor;
    the iterate, the stop sweep and the error are those of the loop of
    one-sweep sharded error passes (``parallel.kernel_shard3.
    sharded_trigger_step3``), bit for bit."""
    K3._check_compat3(compat)
    if not f.device.type == "cuda":
        return rdma_trigger3_torch(u, f, h, omega, compat, trigger, max_sweeps)
    if not 1 <= max_sweeps < 2 ** 31:
        raise ValueError(f"max_sweeps must lie in 1..2**31 − 1, got {max_sweeps}")
    lib, stream, dev, z0s = _check_ring3(u, f)
    shards, n = len(z0s) - 1, f.n
    tile, czs = _plans(f, 0, 0, err_plan=True)
    partials, _ = _partials(f, tile, czs, True)
    ws = _workspace(dev, shards, n)
    out = [torch.empty_like(b) for b in _blocks(f)]
    tmp = [torch.empty_like(b) for b in _blocks(f)]
    err = torch.empty(1, dtype=torch.float32, device=dev)
    sweeps = torch.empty(1, dtype=torch.int32, device=dev)
    rc = lib.mg3_rdma_trigger(_ptrs(_blocks(u)), _ptrs(_blocks(f)), _ptrs(out), _ptrs(tmp),
                              K._c_array(ctypes.c_int, z0s), K._c_array(ctypes.c_int, czs),
                              shards, n, K3._ERR_CODES3[compat], *tile, partials.data_ptr(),
                              err.data_ptr(), sweeps.data_ptr(), ws.ptrs,
                              ws.take(max_sweeps + 1), h * h, omega / 6.0, 1.0 / (h * h),
                              p3.error_scale3(compat, n, h), trigger, max_sweeps, stream)
    K._raise_on(lib, rc, "rdma_trigger3")
    K.launches["rdma_trigger3"] += 1
    return _grid_of(f, out), err.reshape(()).to(f.dtype), sweeps.reshape(())
