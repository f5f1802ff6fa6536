"""Profiling and observability helpers.

PyTorch port of ``multigrid_poisson_solver_tpu/utils/profiling.py``. The
reference's observability is two wall clocks and printf narration
(omp_get_wtime / cudaEvent around the whole cycle, MG_solver_CPU.cpp:156,
429-431). This module gives:

  * ``trace()``: a context manager around ``torch.profiler`` (CPU and CUDA
    activities) that writes a Chrome trace JSON into ``log_dir`` (JAX
    ``:32``, on ``jax.profiler``);
  * ``DeviceTimer``: the JAX package's timing protocol (``:47-118``) with
    its methods and units (seconds), timed by CUDA events on a CUDA device
    and by ``time.perf_counter`` on the CPU;
  * ``cost_report()``: a static per-instruction cost model of a schedule
    (bytes, FLOPs, roofline time per node, ``:124-210``), with the H100's
    3.35 TB/s, the port's plain (n, n) levels and its fused legs' bytes in
    place of the TPU's 819 GB/s, padded tiles and unfused transfers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from pathlib import Path
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike):
    """``with trace("prof") as prof: run(...)``: profile the block's CPU and
    CUDA activity (``torch.profiler``) and write ``<log_dir>/trace.json``,
    a Chrome trace (chrome://tracing, Perfetto). Yields the profiler, whose
    ``key_averages()`` sums the events by name.

    On a card, once a process has opened a profiler session and then gone
    90 s without one, later sessions (this one's too) have lost some or all
    of their device events, often every other session; no Kineto setting
    tried prevented it (PERF.md §7). Where a trace must hold the kernels,
    check it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def _first(x) -> torch.Tensor:
    while isinstance(x, (tuple, list)):
        x = x[0]
    return x


def sync(x) -> float:
    """Wait for everything ``x`` (a tensor, or a tuple or list whose first
    leaf is one) depends on: synchronise its device, then return its first
    element as a float (JAX ``:41``)."""
    t = _first(x)
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return float(t.reshape(-1)[0])


class DeviceTimer:
    """Times device work in seconds.

    On a CUDA device (the device of ``fn``'s output) every interval is
    measured by CUDA events recorded on the current stream around the
    calls, so host launch overheads that the device hides do not count; on
    the CPU by ``time.perf_counter`` around calls whose outputs are read.
    ``measure(fn, *args)`` runs ``fn`` once to warm up, then times one call;
    ``measure_differential(fn, *args)`` times ``reps`` and ``3·reps`` calls
    and returns the per-call time with the fixed costs cancelled.
    """

    def __init__(self):
        self._latency: Optional[float] = None

    def _interval(self, fn: Callable, args, calls: int, cuda: bool):
        """(seconds of ``calls`` calls of fn, the last output)."""
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                out = fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3, out
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        sync(out)
        return time.perf_counter() - t0, out

    @property
    def latency(self) -> float:
        """Seconds of one small host op and its read: the fixed cost that
        ``measure`` takes off a CPU timing (JAX's sync latency)."""
        if self._latency is None:
            x = torch.ones((8, 8))
            sync(x)
            t, _ = self._interval(lambda: x + 1.0, (), 3, False)
            self._latency = t / 3
        return self._latency

    def measure(self, fn: Callable, *args) -> float:
        """Seconds of one call of ``fn`` after a warm-up call; on the CPU
        less the sync latency, as JAX's (never below 5% of the raw time)."""
        out = fn(*args)
        cuda = _first(out).device.type == "cuda"
        sync(out)
        elapsed, _ = self._interval(fn, args, 1, cuda)
        if cuda:
            return elapsed
        return max(elapsed - self.latency, 0.05 * elapsed)

    def measure_differential(self, fn: Callable, *args, reps: int = 10) -> float:
        """Per-call seconds of ``fn`` via t(3k calls) − t(k calls), fixed costs
        cancelled. ``fn`` must be side-effect free (it is called repeatedly)."""
        out = fn(*args)
        cuda = _first(out).device.type == "cuda"
        sync(out)
        t1, _ = self._interval(fn, args, reps, cuda)
        t3, _ = self._interval(fn, args, 3 * reps, cuda)
        d = (t3 - t1) / (2 * reps)
        # noise floor: where fixed costs dominate the difference can go
        # negative; report ≥ 5% of the raw per-call mean instead
        return max(d, 0.05 * (t1 + t3) / (4 * reps))

    def measure_differential_median(self, fn: Callable, *args, reps: int = 4,
                                    k: int = 3):
        """Median of ``k`` independent differential measurements, with the
        min–max spread."""
        ts = sorted(self.measure_differential(fn, *args, reps=reps) for _ in range(k))
        return ts[k // 2], (ts[0], ts[-1])

    def measure_median(self, fn: Callable, *args, k: int = 3):
        """Median of ``k`` single measures (for one-shot calls too big to
        iterate), plus the min–max spread."""
        ts = sorted(self.measure(fn, *args) for _ in range(k))
        return ts[k // 2], (ts[0], ts[-1])


# --- static cost model --------------------------------------------------------

# H100 SXM: the data sheet's device memory rate
H100_HBM_BW = 3.35e12

# The bytes a node moves beside its smoothing chunks, in levels of its own
# size and of the coarse level's. Each ≤ 8-sweep smoothing chunk reads u and f
# and writes u, three levels times ``overhead``; the port's wavefront reads
# each input once, so 1.0. The fused legs (kernels 3 and 4) carry the
# residual, the restriction and the prolongation inside their chunk, so a
# descend adds the coarse f it writes and an ascend the coarse correction it
# reads, as PERF.md §6's bounds count them ("inputs and outputs once").
# Without sweeps, a descend reads f and writes the coarse f (the FMG
# restriction) and an ascend reads u and the correction and writes u. A
# level whose u is known to be zero (a correction level before its first
# sweep) is not read: ``zero_u`` levels come off.
_TRAFFIC = {
    "overhead": 1.0,
    "descend": (0, 1),
    "descend_no_sweeps": (1, 1),
    "ascend": (0, 1),
    "ascend_no_sweeps": (2, 1),
    "zero_u": 1,
}


@dataclasses.dataclass
class NodeCost:
    kind: str
    n: int
    hbm_bytes: int
    flops: int
    roofline_s: float


@dataclasses.dataclass
class CostReport:
    nodes: list[NodeCost]
    total_bytes: int
    total_flops: int
    roofline_s: float

    def summary(self) -> str:
        lines = [f"{'node':<14}{'N':>7}{'MB':>10}{'MFLOP':>10}{'us@roof':>10}"]
        for c in self.nodes:
            lines.append(f"{c.kind:<14}{c.n:>7}{c.hbm_bytes/1e6:>10.2f}"
                         f"{c.flops/1e6:>10.1f}{c.roofline_s*1e6:>10.1f}")
        lines.append(f"total: {self.total_bytes/1e6:.1f} MB, "
                     f"{self.total_flops/1e6:.1f} MFLOP, "
                     f"{self.roofline_s*1e3:.3f} ms at roofline")
        return "\n".join(lines)


def cost_report(program, config=None, hbm_bw: float = H100_HBM_BW,
                dtype_bytes: int = 4) -> CostReport:
    """Static memory-traffic and FLOP estimate per schedule instruction: the
    JAX package's instruction walk, 8-sweep chunks and FLOP counts, with the
    bytes of the port's fused legs (``_TRAFFIC``). Levels are plain (n, n)
    tensors of ``dtype_bytes`` a value. Coarse solves read f and write u, and
    count matmul FLOPs only. ``config`` is unused: it keeps JAX's call
    signature."""
    from ..schedule import Ascend, CoarseSolve, Descend

    max_fuse = 8
    t = _TRAFFIC
    nodes = []
    # [n, whether the level's u is known to be zero]
    stack = [[program.n_max, False]]

    def level_bytes(n):
        return n * n * dtype_bytes

    def smooth_cost(n, steps):
        if steps <= 0:
            steps = 10  # trigger mode: a nominal count
        chunks = math.ceil(steps / max_fuse)
        b = int(3 * level_bytes(n) * chunks * t["overhead"])
        fl = 8 * n * n * steps
        return b, fl

    def moved(n, n_coarse, key):
        fine, coarse = t[key]
        return fine * level_bytes(n) + coarse * level_bytes(n_coarse)

    for ins in program.instructions:
        n, zero = stack[-1]
        if isinstance(ins, Descend):
            if ins.steps == 0:
                b, fl = moved(n, ins.next_n, "descend_no_sweeps"), 0
            else:
                b, fl = smooth_cost(n, ins.steps)
                b += moved(n, ins.next_n, "descend") - zero * t["zero_u"] * level_bytes(n)
                stack[-1][1] = False
            fl += 7 * n * n + 6 * ins.next_n * ins.next_n
            nodes.append(NodeCost("descend", n, b, fl, b / hbm_bw))
            stack.append([ins.next_n, True])
        elif isinstance(ins, CoarseSolve):
            fl = 2 * (n * n) ** 2 if ins.option == 0 else 100 * 10 * n * n
            b = 2 * level_bytes(n)
            stack[-1][1] = False
            nodes.append(NodeCost("coarse", n, b, fl, b / hbm_bw))
        elif isinstance(ins, Ascend):
            n_coarse = stack.pop()[0]
            n, zero = stack[-1]
            fl = 6 * n * n
            if ins.steps != 0:
                b = moved(n, n_coarse, "ascend")
                sb, sf = smooth_cost(n, ins.steps)
                b += sb
                fl += sf
            else:
                b = moved(n, n_coarse, "ascend_no_sweeps")
            b -= zero * t["zero_u"] * level_bytes(n)
            stack[-1][1] = False
            nodes.append(NodeCost("ascend", n, b, fl, b / hbm_bw))

    tb = sum(c.hbm_bytes for c in nodes)
    tf = sum(c.flops for c in nodes)
    return CostReport(nodes=nodes, total_bytes=tb, total_flops=tf,
                      roofline_s=tb / hbm_bw)
