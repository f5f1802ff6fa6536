"""Multi-process initialization and the meshes of a run over processes.

PyTorch port of ``multigrid_poisson_solver_tpu/parallel/multihost.py``. JAX
starts its processes with ``jax.distributed`` and lays hosts on the row axis
of a DCN × ICI mesh; here the processes are ``torch.distributed`` ranks (one
per card under NCCL, the way every multi-card and multi-node PyTorch run
works; CPU processes under gloo) and every rank runs the same calls:

    from multigrid_poisson_solver_tpu_torch.parallel import multihost
    multihost.initialize()                       # torch.distributed, every rank
    mesh = multihost.hybrid_block_mesh()          # processes × local entries
    policy = multihost.block_policy(mesh)
    cc = compile_program(program, problem, policy=policy)
    u, f = cc.init(); u, err = cc(u, f)           # each rank owns its blocks

Layout rationale (JAX's): the grid's row axis spans processes, whose halo
rows are the least frequent traffic, and the column axis stays inside a
process. Coarse levels drop to rows only, then to replicated levels that
every process computes (``BlockShardingPolicy``). ``z_mesh`` is the 3-D
counterpart: one z ring over every process's entries, for
``ZShardingPolicy3`` and ``v_cycle3_sharded``. The sharded layer
(``parallel.sharded``) moves the halos, psums and gathers between the
processes; results are those of one process on the same logical mesh, bit
for bit.

``spawn`` starts local processes for a function (a CPU run over gloo, or
several processes sharing one card), each with a process group of its own
and a deadline after which all are killed.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Callable, Optional, Sequence

import torch

from .mesh import COL_AXIS, ROW_AXIS, BlockShardingPolicy, Mesh, make_mesh, make_mesh_z


def _dist():
    import torch.distributed as dist

    return dist


def local_rank(rank: Optional[int] = None) -> int:
    """The process's index on its host: ``LOCAL_RANK`` (torchrun), else the
    rank modulo the host's CUDA devices."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    return rank % max(1, torch.cuda.device_count())


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """``torch.distributed.init_process_group`` once (a second call does
    nothing). ``backend``: NCCL (one process per card) where CUDA is
    available, else gloo; without ``init_method`` the torchrun environment
    (``env://``) is read. Under NCCL the process's card becomes current
    first."""
    dist = _dist()
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size, rank=rank)
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(backend, **kwargs)


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _local_devices(local_devices) -> list:
    if local_devices is not None:
        return [torch.device(d) for d in local_devices]
    if process_count() > 1:
        return [torch.device(f"cuda:{local_rank(_dist().get_rank())}")]
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def global_entries(local_devices: Optional[Sequence] = None) -> tuple[list, list]:
    """(devices, ranks) of every process's entries in rank order: each
    process names its own ``local_devices`` (default: its card under several
    processes, every CUDA device under one), all the same count."""
    local = _local_devices(local_devices)
    world = process_count()
    if world == 1:
        return local, [0] * len(local)
    names = [None] * world
    _dist().all_gather_object(names, [str(d) for d in local])
    if len({len(x) for x in names}) != 1:
        raise ValueError(f"every process must bring the same number of mesh entries, got "
                         f"{[len(x) for x in names]}")
    return ([torch.device(d) for x in names for d in x],
            [r for r, x in enumerate(names) for _ in x])


def hybrid_block_mesh(rows_parallelism: Optional[int] = None,
                      local_devices: Optional[Sequence] = None) -> Mesh:
    """A 2-D (rows × cols) mesh with processes on the row axis.

    One process: its entries factored into a near-square mesh (8 → 2×4),
    or ``rows_parallelism`` rows. Several: rows = processes, cols = each
    process's entries (default: its card, ``cuda:LOCAL_RANK``)."""
    devices, ranks = global_entries(local_devices)
    world = process_count()
    if world > 1:
        return Mesh(tuple(devices), (ROW_AXIS, COL_AXIS), (world, len(devices) // world),
                    tuple(ranks))
    total = len(devices)
    rows = rows_parallelism or _near_square_factor(total)
    return Mesh(tuple(devices), (ROW_AXIS, COL_AXIS), (rows, total // rows))


def row_mesh(local_devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D row mesh over every process's entries in rank order (a
    ``ShardingPolicy`` ring across processes)."""
    devices, ranks = global_entries(local_devices)
    return make_mesh(devices, ROW_AXIS, ranks if process_count() > 1 else None)


def z_mesh(local_devices: Optional[Sequence] = None) -> Mesh:
    """A z mesh over every process's entries in rank order, the ring of
    ``ZShardingPolicy3`` and ``v_cycle3_sharded`` across processes (JAX's
    ``make_mesh_z(jax.devices())``)."""
    devices, ranks = global_entries(local_devices)
    return make_mesh_z(devices, ranks=ranks if process_count() > 1 else None)


def block_policy(mesh: Mesh, threshold_rows: int = 32) -> BlockShardingPolicy:
    return BlockShardingPolicy(mesh, threshold_rows=threshold_rows)


def _near_square_factor(n: int) -> int:
    """Largest factor of n that is ≤ √n (8 → 2×4, 16 → 4×4, 6 → 2×3)."""
    best = 1
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best


# --- local processes ------------------------------------------------------------------

def _child(rank: int, world: int, init_method: str, backend: str, threads: Optional[int],
           fn: Callable, args: tuple, queue) -> None:
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        initialize(init_method, world, rank, backend)
        out = fn(rank, *args)
        if backend == "nccl":
            _dist().barrier(device_ids=[torch.cuda.current_device()])
        else:
            _dist().barrier()
        queue.put((rank, True, out))
    except Exception:   # a process's boundary: the parent reports it and fails
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if _dist().is_initialized():
            _dist().destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), init_file: Optional[str] = None,
          backend: str = "gloo", timeout: float = 120.0, threads: Optional[int] = None) -> list:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes joined by one
    process group (``file://init_file``: no port to race for) and return
    their results in rank order. ``fn`` must be importable by name and
    return picklable values. A process that fails, or a run that outlasts
    ``timeout`` seconds, kills every process and raises."""
    import queue as _queue
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    if init_file is None:
        init_file = os.path.join(tempfile.mkdtemp(prefix="mg_spawn_"), "init")
    q = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(r, nprocs, f"file://{init_file}", backend,
                                              threads, fn, args, q), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} processes of {fn.__name__} outlasted {timeout} s "
                                   f"({sorted(results)} done)")
            try:
                rank, ok, out = q.get(timeout=min(left, 1.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in results]
                if dead:
                    raise RuntimeError(f"process {dead[0]} of {fn.__name__} exited "
                                       f"{procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"process {rank} of {fn.__name__} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(nprocs)]
