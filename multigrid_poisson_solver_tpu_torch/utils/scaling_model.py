"""Communication model of the port's sharded 2-D cycles, and the scaling
tables built on it.

PyTorch port of ``multigrid_poisson_solver_tpu/utils/scaling_model.py``,
modelling the port's own exchanges, not JAX's: the JAX model charges its
padded halos (8 rows × 128-lane tiles, ``HALO = 8`` of a padded layout the
port does not have) and GSPMD's all-gathers. Here ``comm_report`` walks
``compile_program``'s routing under a policy on the kernel path
(``parallel.kernel_shard``: the fused legs per shard, the per-pass smoother,
the sharded residual, the agglomeration gathers) and counts, per level, what
``parallel.sharded`` counts when the program runs:

  * every batched exchange (``sharded.exchange``): its windows' pieces from
    one shard's block into another shard's window and their bytes, with the
    depths each call site uses (a pass's 8 rows, and 8 columns under a block
    policy; a residual's one row; the ascend leg's coarse window of
    ``COARSE_HALO`` coarse rows around each block's coarse points);
  * of those, the pieces and bytes between processes, and the messages (one
    per pair of processes a direction and exchange);
  * the psums of per-shard error partials and the gathers of sharded levels
    (with the bytes each assembles and the bytes each process receives).

A report's ``counts()`` equals ``sharded.counts()`` of one cold cycle of the
same program exactly (``tests/test_torch_scaling_model.py``), in one process
and across processes. JAX's ``hlo_collective_counts`` reads the collectives
from lowered HLO; the port has no HLO, and those counters take its role.

Counts are totals over the mesh, per cycle. Trigger nodes run data-dependent
sweep counts; the report charges ``trigger_sweeps`` one-sweep steps (default
10, JAX's figure) and is exact only for fixed-step programs. ``halo="rdma"``
moves halos inside the ring kernels and is not modelled.

Time: ``CommReport.t_comm`` prices the counts with the card's figures
(below) and per-event overheads measured on the card, and
``predicted_efficiency`` / ``scaling_table`` / ``multihost_scaling_table`` /
``tune_threshold`` turn them into weak- and strong-scaling predictions given
a compute time per cycle, which the caller measures (``chip_smoke.py``) or
takes from ``utils.profiling.cost_report``'s bound; there is no default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..ops import kernels as K
from ..parallel import mesh as M
from ..parallel.kernel_shard import COARSE_HALO, HALO
from ..parallel import sharded as S
from ..parallel.sharded import layout_of
from ..schedule import Ascend, CoarseSolve, CycleProgram, Descend

DTYPE_BYTES = 4

# Public NVIDIA H100 SXM5 figures (the H100 data sheet; the network: the DGX
# H100 system's one NDR NIC a GPU):
HBM_BW = 3.35e12          # HBM3, bytes/s
NVLINK_BW = 450e9         # NVLink 4, bytes/s a direction (900 GB/s both ways)
IB_BW = 400e9 / 8         # one 400 Gb/s NDR InfiniBand NIC a GPU, bytes/s a direction

# Host seconds measured on NVIDIA H100 80GB HBM3 cards at a 700.00 W power
# limit by ``examples/torch_multihost_cpu.py::overheads`` (a 257² row ring,
# one halo row an exchange):
#   PIECE_S: an exchange within one process over its pieces between shards
#     (2 a call, two entries on one card: the windows' allocation, fills and
#     copies included; chip_smoke.py phase L);
#   MESSAGE_S: a message between processes in a batched exchange, NCCL, one
#     process a card on four cards (examples/torch_multiproc_check.py: 383 µs
#     an exchange of 6 messages over 4 processes);
#   COLLECTIVE_S: a psum of one float64 partial a shard (an all_gather),
#     NCCL on the same four cards.
# Phase L's two gloo processes sharing one card, messages staged through
# host memory, took 1.66-1.77 ms a message and 2.33-2.69 ms a psum.
PIECE_S = 7.83e-5
MESSAGE_S = 2.55e-4
COLLECTIVE_S = 3.46e-4

LINKS = {"nvlink": NVLINK_BW, "ib": IB_BW}


@dataclasses.dataclass
class LevelComm:
    """One level's traffic per cycle, totals over the mesh (the fields of
    ``sharded.LevelCounts`` under the model's names)."""

    n: int
    sharded: bool
    exchange_bytes: int = 0      # bytes the exchanges copy between shards
    gather_bytes: int = 0        # bytes the gathers assemble (each process, each gather)
    events_exchange: int = 0     # batched exchanges that moved a piece
    events_psum: int = 0
    events_gather: int = 0
    pieces: int = 0
    pieces_xproc: int = 0        # pieces between processes
    bytes_xproc: int = 0         # exchange bytes between processes
    messages: int = 0            # messages between processes
    gather_bytes_xproc: int = 0  # gathered bytes received from other processes

    @property
    def events(self) -> int:
        return self.events_exchange + self.events_psum + self.events_gather

    @classmethod
    def of(cls, n: int, sharded: bool, c: S.LevelCounts) -> "LevelComm":
        """The level from ``sharded.LevelCounts``."""
        return cls(n, sharded, c.bytes, c.gather_bytes, c.exchanges, c.psums, c.gathers,
                   c.pieces, c.xproc_pieces, c.xproc_bytes, c.messages, c.gather_xproc_bytes)

    def as_counts(self) -> dict:
        """The level as ``sharded.counts()`` reports it."""
        return {"exchanges": self.events_exchange, "pieces": self.pieces,
                "bytes": self.exchange_bytes, "xproc_pieces": self.pieces_xproc,
                "xproc_bytes": self.bytes_xproc, "messages": self.messages,
                "psums": self.events_psum, "gathers": self.events_gather,
                "gather_bytes": self.gather_bytes, "gather_xproc_bytes": self.gather_bytes_xproc}


@dataclasses.dataclass
class CommReport:
    ndev: int
    levels: list
    processes: int = 1
    link: str = "nvlink"

    def _tot(self, attr: str) -> int:
        return sum(getattr(lc, attr) for lc in self.levels)

    def __getattr__(self, attr):
        if attr in LevelComm.__dataclass_fields__ and attr not in ("n", "sharded"):
            return self._tot(attr)
        raise AttributeError(attr)

    @property
    def events(self) -> int:
        return self._tot("events")

    def counts(self) -> dict:
        """{n: counters} of every level that moved data, as
        ``sharded.counts()`` returns them."""
        return {lc.n: lc.as_counts() for lc in self.levels if any(lc.as_counts().values())}

    def t_comm(self) -> float:
        """Seconds of communication a cycle, each process doing its share in
        parallel: the pieces within a process (a copy overhead each, read
        and write at the HBM rate), the messages and collectives between
        processes (their overheads, bytes at the report's link's rate)."""
        bw = LINKS[self.link]
        p = self.processes
        local_pieces = self.pieces - self.pieces_xproc
        local_bytes = self.exchange_bytes - self.bytes_xproc
        t = (local_pieces * PIECE_S + 2 * local_bytes / HBM_BW) / p
        if p > 1:
            t += (self.messages * MESSAGE_S + self.bytes_xproc / bw) / p
            t += (self.events_psum + self.events_gather) * COLLECTIVE_S
            t += self.gather_bytes_xproc / p / bw
        return t

    def t_wait(self) -> float:
        """The overheads alone (no byte moves): the floor if every byte
        moved under compute."""
        p = self.processes
        t = (self.pieces - self.pieces_xproc) * PIECE_S / p
        if p > 1:
            t += self.messages * MESSAGE_S / p
            t += (self.events_psum + self.events_gather) * COLLECTIVE_S
        return t

    def summary(self) -> str:
        lines = [f"{'level n':>8}{'sharded':>9}{'exchange KB':>13}{'gather KB':>11}"
                 f"{'x-proc KB':>11}{'events':>8}"]
        for lc in self.levels:
            lines.append(f"{lc.n:>8}{str(lc.sharded):>9}{lc.exchange_bytes / 1e3:>13.1f}"
                         f"{lc.gather_bytes / 1e3:>11.1f}"
                         f"{(lc.bytes_xproc + lc.gather_bytes_xproc) / 1e3:>11.1f}"
                         f"{lc.events:>8}")
        lines.append(f"total/cycle: {self.exchange_bytes / 1e3:.1f} KB exchanged, "
                     f"{self.gather_bytes / 1e3:.1f} KB gathered, {self.events} events, "
                     f"{self.messages} messages between {self.processes} processes")
        return "\n".join(lines)


def _ranks(ndev: int, processes: int) -> Optional[tuple]:
    """Each mesh entry's process: processes own contiguous runs of entries
    (row-major), the layout ``parallel.multihost`` builds."""
    if processes == 1:
        return None
    if ndev % processes:
        raise ValueError(f"{ndev} entries do not split over {processes} processes")
    return tuple(k // (ndev // processes) for k in range(ndev))


def make_policy(ndev: int, threshold_rows: int = 32, block_cols: int = 1,
                processes: int = 1):
    """The policy ``comm_report`` models: a row ring (block_cols=1) or a
    (ndev / block_cols) × block_cols block mesh, its entries split over
    ``processes`` (each a run of rows), on placeholder devices."""
    ranks = _ranks(ndev, processes)
    if block_cols == 1:
        return M.ShardingPolicy(M.make_mesh(["cpu"] * ndev, ranks=ranks),
                                threshold_rows=threshold_rows)
    return M.BlockShardingPolicy(M.make_mesh_2d((ndev // block_cols, block_cols),
                                                ["cpu"] * ndev, ranks=ranks),
                                 threshold_rows=threshold_rows)


class _Tally:
    """Per-level ``sharded.LevelCounts`` filled through the accounting
    ``parallel.sharded`` itself counts with (``plan``, ``LevelCounts.
    add_exchange`` / ``add_gather``): only the routing is walked here."""

    def __init__(self, sharded_of, item: int):
        self.levels: dict = {}
        self.sharded_of = sharded_of
        self.item = item

    def level(self, n: int) -> S.LevelCounts:
        if n not in self.levels:
            self.levels[n] = S.LevelCounts()
        return self.levels[n]

    def window(self, src, target, rect, tail: int = 1) -> None:
        """An exchange of ``target``'s windows ``rect(i, j)`` from the source
        layout ``src`` (None: a replicated source, nothing between shards;
        ``tail``: a source cell's elements)."""
        c = self.level(target.n)
        if src is not None:
            p = S.plan(src, target, [rect(i, j) for i, j in target.order()])
            c.add_exchange(p, tail * self.item)

    def extend(self, lay, ext_r: int, ext_c: int = 0) -> None:
        if lay.dim == 3:
            self.window(lay, lay, lambda i, j: (lay.rows[i][0] - ext_r, lay.rows[i][1] + ext_r,
                                                0, lay.n), lay.n)
        else:
            self.window(lay, lay, lambda i, j: (lay.rows[i][0] - ext_r, lay.rows[i][1] + ext_r,
                                                lay.cols[j][0] - ext_c, lay.cols[j][1] + ext_c))

    def psum(self, lay) -> None:
        self.level(lay.n).psums += 1

    def gather(self, lay) -> None:
        """A gather of a level laid out as ``lay`` (None: a tensor, free)."""
        if lay is not None:
            self.level(lay.n).add_gather(lay, self.item)

    def report(self, ndev: int, processes: int, link: str) -> CommReport:
        return CommReport(ndev, [LevelComm.of(n, self.sharded_of(n), c)
                                 for n, c in sorted(self.levels.items(), reverse=True)],
                          processes, link)


def _coarse_of(lay, m: int):
    """The coarse layout a fused descend leg returns (``kernel_shard.
    _coarse_layout``)."""
    half = tuple((a // 2, (b + 1) // 2) for a, b in lay.rows)
    halfc = tuple((a // 2, (b + 1) // 2) for a, b in lay.cols)
    return lay.coarse(m, half, halfc)


def comm_report(program: CycleProgram, ndev: int, threshold_rows: int = 32,
                block_cols: int = 1, processes: int = 1, config=None,
                trigger_sweeps: int = 10, link: str = "nvlink") -> CommReport:
    """The traffic of one cold cycle of ``program`` through
    ``compile_program(..., policy=make_policy(ndev, threshold_rows,
    block_cols, processes))`` on the kernel path, per level (see the module
    docstring). ``config``: the program's ``SolverConfig`` (default:
    ``SolverConfig()``); ``link``: what joins the processes ("nvlink" in one
    host, "ib" between hosts)."""
    from .. import compiled
    from ..solver import SolverConfig

    cfg = SolverConfig() if config is None else config
    if cfg.halo == "rdma":
        raise ValueError("halo='rdma' moves its halos inside the ring kernels; the model "
                         "covers the exchange path")
    policy = make_policy(ndev, threshold_rows, block_cols, processes)
    tally = _Tally(policy.is_sharded, DTYPE_BYTES)
    jacobi = cfg.smoother == "jacobi"
    cap = K.MAX_FUSED_SWEEPS if jacobi else K.MAX_FUSED_RBGS

    def ec(lay, k):
        return k if len(lay.cols) > 1 else 0

    def passes(lay, steps, from_zero, kmax):
        """``steps`` sweeps as passes of at most kmax, u read from the second
        on where from_zero; returns whether from_zero still holds."""
        first = True
        while steps > 0:
            if not (from_zero and first):
                tally.extend(lay, HALO, ec(lay, HALO))
            steps -= min(steps, kmax)
            first = False
        return from_zero and first

    def sweeps(lay, steps, from_zero):
        """``compiled._sweeps`` on the kernel path (one f exchange, a u
        exchange a pass)."""
        if steps <= 0:
            return
        tally.extend(lay, HALO, ec(lay, HALO))
        passes(lay, steps, from_zero, cap)

    def smooth(lay, steps, want_err, from_zero):
        """``compiled._smooth_sharded`` (and a trigger node's one-sweep
        steps)."""
        if steps == -1:
            for _ in range(trigger_sweeps):
                smooth(lay, 1, True, False)
            return
        fuse_err_ok = jacobi or cfg.compat_error != "gpu"
        if want_err and steps >= 1 and fuse_err_ok:
            last_cap = K.errs_sweep_cap(cfg.compat_error) if jacobi else (HALO - 1) // 2
            last = min(steps, last_cap)
            tally.extend(lay, HALO, ec(lay, HALO))
            fz = passes(lay, steps - last, from_zero, cap)
            if steps > last:
                fz = False
            if not fz:
                tally.extend(lay, HALO, ec(lay, HALO))
            tally.psum(lay)
            return
        if want_err and cfg.compat_error == "gpu" and steps >= 1:
            if steps > 1:
                sweeps(lay, steps - 1, from_zero)
            sweeps(lay, 1, from_zero and steps == 1)
            tally.psum(lay)
            return
        sweeps(lay, steps, from_zero)
        if want_err:
            tally.extend(lay, 1, 1)
            tally.extend(lay, 1, 1)
            tally.psum(lay)

    levels = []   # (n, layout or None, is_fmg) of the level stack
    for k, ins in enumerate(program.instructions):
        if k == 0:
            levels.append((program.n_max, layout_of(policy, program.n_max), False))
        n, lay, is_fmg = levels[-1]
        if isinstance(ins, Descend):
            finest = len(levels) == 1
            m = ins.next_n
            was_zeroed = not finest and not is_fmg
            mlay = layout_of(policy, m)
            if lay is None:
                levels.append((m, mlay, ins.steps == 0))
                continue
            if mlay is None:
                tally.level(m)     # the agglomeration's level (JAX's all-gather's)
            if ins.steps == 0:
                tally.gather(lay)
                levels.append((m, mlay, True))
                continue
            if compiled._fuse_descend_ok(cfg, True, n, m, ins.steps, policy):
                tally.extend(lay, HALO, ec(lay, HALO))
                if not was_zeroed:
                    tally.extend(lay, HALO, ec(lay, HALO))
                if finest:
                    tally.psum(lay)
                clay = _coarse_of(lay, m)
                if mlay is None or clay != mlay:
                    tally.gather(clay)
            else:
                smooth(lay, ins.steps, finest, was_zeroed)
                tally.extend(lay, 1, ec(lay, 1))
                tally.extend(lay, 1, ec(lay, 1))
                tally.gather(lay)
            levels.append((m, mlay, False))
        elif isinstance(ins, CoarseSolve):
            continue
        elif isinstance(ins, Ascend):
            m, clay, _ = levels.pop()
            n, lay, is_fmg = levels[-1]
            finest = len(levels) == 1
            if lay is None:
                continue
            if compiled._fuse_ascend_ok(cfg, True, n, m, ins.steps, finest, policy):
                tally.extend(lay, HALO, ec(lay, HALO))
                tally.extend(lay, HALO, ec(lay, HALO))
                ch = COARSE_HALO
                tally.window(clay, lay, lambda i, j: (
                    lay.rows[i][0] // 2 - ch, (lay.rows[i][1] + 1) // 2 + ch,
                    lay.cols[j][0] // 2 - ch, (lay.cols[j][1] + 1) // 2 + ch))
                if finest:
                    tally.psum(lay)
                continue
            tally.gather(clay)
            tally.gather(lay)
            if ins.steps != 0:
                smooth(lay, ins.steps, finest, False)
    return tally.report(ndev, processes, link)


def predicted_efficiency(report: CommReport, t_compute_s: float) -> dict:
    """Scaling efficiency of a mesh of ``report.ndev`` shards given the
    compute time of one cycle on each (weak scaling: constant per shard):
    the exchange path's communication in series with compute, and the bound
    if every byte moved under compute (only the overheads left)."""
    t_comm = report.t_comm()
    t_wait = report.t_wait()
    bw = LINKS[report.link]
    x = (report.bytes_xproc + report.gather_bytes_xproc) / max(1, report.processes) / bw
    return {
        "ndev": report.ndev,
        "processes": report.processes,
        "t_compute_ms": t_compute_s * 1e3,
        "t_comm_ms": t_comm * 1e3,
        "t_comm_xproc_ms": x * 1e3,
        "efficiency": t_compute_s / (t_compute_s + t_comm),
        "efficiency_overlap_bound": t_compute_s / (t_compute_s + t_wait),
    }


def _program(n: int, steps: int, coarsen: int, schedule: str):
    from ..schedule import fmg, v_cycle

    if schedule == "fmg":
        return fmg(n, n_min=8, steps=steps, coarsen=coarsen)
    return v_cycle(n, n_min=8, steps=steps, coarse_option=0, coarsen=coarsen)


def scaling_table(base_n: int, t1_s: float, ndevs=(2, 4, 8, 16), threshold_rows: int = 32,
                  steps: int = 3, coarsen: int = 3, block_cols: int = 1,
                  link: str = "nvlink") -> list:
    """Predicted weak scaling, one row per shard count c, one process (card)
    a shard as NCCL runs: n_c = (base_n − 1)·c + 1 (rows per shard
    constant, width ×c), compute t1_s·c a cycle. ``t1_s``: the measured
    seconds of one cycle at base_n on one card."""
    rows = []
    for c in ndevs:
        n = (base_n - 1) * c + 1
        rep = comm_report(_program(n, steps, coarsen, "v"), c, threshold_rows, block_cols, c,
                          link=link)
        row = predicted_efficiency(rep, t1_s * c)
        row["n"] = n
        rows.append(row)
    return rows


def multihost_scaling_table(t1_s: float, n: int = 16385, n_hosts=(2, 4, 8),
                            local_devices: int = 8, threshold_rows: int = 32, steps: int = 3,
                            coarsen: int = 3, schedule: str = "fmg",
                            mode: str = "strong") -> list:
    """Predicted efficiency of a hybrid block mesh (``multihost.
    hybrid_block_mesh``): hosts on the row axis joined by InfiniBand, each
    with ``local_devices`` cards. The model counts one process per host row
    (its entries inside one process); ``t1_s``: the measured seconds of one
    cycle of the program at ``n`` on one card. ``mode="strong"``: fixed n,
    compute t1_s / cards; ``"weak"``: n_h = (n − 1)·hosts + 1, compute
    t1_s · hosts / local_devices."""
    rows = []
    for hosts in n_hosts:
        ndev = hosts * local_devices
        n_h = n if mode == "strong" else (n - 1) * hosts + 1
        t_comp = t1_s / ndev if mode == "strong" else t1_s * hosts / local_devices
        rep = comm_report(_program(n_h, steps, coarsen, schedule), ndev, threshold_rows,
                          local_devices, hosts, link="ib")
        row = predicted_efficiency(rep, t_comp)
        row.update(n=n_h, hosts=hosts, local_devices=local_devices, schedule=schedule,
                   mode=mode)
        rows.append(row)
    return rows


def tune_threshold(n: int, t1_s: float, hosts: int = 2, local_devices: int = 4,
                   steps: int = 3, coarsen: int = 3, schedule: str = "fmg",
                   thresholds=(16, 32, 64, 128, 256, 512, 1024)) -> dict:
    """Sweep the agglomeration threshold of a hosts × local_devices block
    mesh and return the predicted-time-optimal row (JAX's
    ``tune_threshold``): raising it replicates coarse levels (their compute
    runs whole on every card) and deletes their events. Each row carries
    t_total_ms = compute + communication; compute splits t1_s by level
    visits (n² a visit), sharded levels over every card."""
    ndev = hosts * local_devices
    prog = _program(n, steps, coarsen, schedule)
    visits, stack = [], [prog.n_max]
    for ins in prog.instructions:
        if isinstance(ins, Descend):
            visits.append(stack[-1])
            stack.append(ins.next_n)
        elif isinstance(ins, Ascend):
            stack.pop()
            visits.append(stack[-1])
    total_w = sum(v * v for v in visits) or 1
    rows = []
    for th in thresholds:
        pol = make_policy(ndev, th, local_devices, hosts)
        repl_w = sum(v * v for v in visits if not pol.is_sharded(v))
        t_comp = t1_s * ((total_w - repl_w) / total_w / ndev + repl_w / total_w)
        rep = comm_report(prog, ndev, th, local_devices, hosts, link="ib")
        row = predicted_efficiency(rep, t_comp)
        row.update(threshold_rows=th, t_total_ms=row["t_compute_ms"] + row["t_comm_ms"])
        rows.append(row)
    best = min(rows, key=lambda r: r["t_total_ms"])
    return {"best": best, "rows": rows}


def trigger_loop_model(n: int, ndev: int, t1_sweep_s: Optional[float] = None,
                       processes: Optional[int] = None, link: str = "nvlink") -> dict:
    """Predicted cost of one sweep of a row-sharded trigger loop on the
    exchange path: a one-sweep pass per shard after two exchanges (u and f,
    8 rows) and one psum (``kernel_shard.sharded_fused_jacobi_err``), each
    shard on its own card (``processes`` = ndev by default). ``t1_sweep_s``
    defaults to the HBM bound of a sweep of one shard (u read, f read, u
    written). The ring kernel (``halo="rdma"``) has no counterpart across
    processes yet."""
    processes = ndev if processes is None else processes
    rows = n // ndev
    shard_bytes = rows * n * DTYPE_BYTES
    if t1_sweep_s is None:
        t1_sweep_s = 3 * shard_bytes / HBM_BW
    pol = make_policy(ndev, 1, 1, processes)
    lay = layout_of(pol, n)
    tally = _Tally(pol.is_sharded, DTYPE_BYTES)
    tally.extend(lay, HALO)
    tally.extend(lay, HALO)
    tally.psum(lay)
    rep = tally.report(ndev, processes, link)
    t_comm = rep.t_comm()
    return {"n": n, "ndev": ndev, "rows_per_shard": rows,
            "t_sweep_us": (t1_sweep_s + t_comm) * 1e6,
            "t_sweep_compute_us": t1_sweep_s * 1e6, "t_sweep_comm_us": t_comm * 1e6,
            "efficiency": t1_sweep_s / (t1_sweep_s + t_comm)}
