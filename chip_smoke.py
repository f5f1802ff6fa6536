#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (progress on stdout; the first failure exits non-zero):
  0. require a CUDA device; print the card's name and power limit;
  1. build the CUDA kernels from ops/csrc (twenty-two sources: nvcc,
     sm_90a, one process per source): nineteen single-device kernels and
     modes, the shard modes of kernels 1-4 and the two 2-D ring kernels, the
     shard modes of the 3-D kernels 10-13 with kernel 10's emit_residual
     mode, and the four 3-D ring kernels;
  2. hold each kernel against its plain PyTorch twin on the card: at
     n = 1025 and 1031 (several tiles per dimension, ragged last tiles),
     every sweep count, error mode and from_zero; and at the shapes the main
     paths give them (legs at 4097² and 2049², chains from 1025², smoother,
     residual and trigger loop at 256² down to 8², the multi-word residual
     and the per-sweep errors at 8193², the streamed trigger loop at 2305²
     and 4097², the rb-GS modes at 4097²); the 3-D kernels at n = 65, 129
     and 131 with tiles forced small (several tiles per dimension and z
     chunks, ragged last ones), every sweep count within each cap, from_zero,
     the clean and gpu errors and both restrictions, the per-sweep errors
     (every sweep count, both metrics), the two whole-loop trigger kernels
     (caps of 1-60 sweeps, a trigger of 0 and one that stops mid-loop; held
     to the loop of one-sweep launches bit for bit) and the multi-word
     residual (df32, tw32); and at the 3-D main paths' shapes (legs at 513³
     and 257³, smoother, residual, per-sweep errors and multi-word residual
     at 513³, the streamed trigger loop at 257³, the whole-loop one at 129³);
  3. the library path: 4097² V(3,3) (ω = 0.8, coarsen=3, dense coarse solve)
     through compile_program, one cold and five warm cycles, with the CUDA
     kernels and with plain PyTorch: the iterates after 1 and 6 cycles,
     the float64 relative residuals, ms/cycle;
  4. the CLI path: schedules/Vcycle.txt and schedules/VcycleTrigger.txt
     (compiled engine), each in a subprocess and in process;
  5. smoother throughput at 8193², 8 sweeps per launch;
  A. refinement to a tolerance: tw32 to 1e-10 at 8193² and df32 at 4097²
     (IterativeRefinementSolver), with the kernels and with kernels="torch";
     then the CLI --tol 1e-10 --state tw32 on schedules/Vcycle.txt;
  B. a trigger V-cycle at 8193² (ω = 0.8, coarsen=3, trigger_batch "auto"):
     its levels reach the batched loop (8193²), the streamed kernel (4097²)
     and the whole-loop kernel (2049² and below); held against the plain
     path with trigger_batch=1 and against the same two-phase loop driven
     through the twins;
  C. rb-GS V(2,2) with full weighting at 4097², cycles and refinement;
  D. 3-D at full width: the bench's v_cycle3 V(3,3) at 513³ (ω = 0.857,
     n_min 5) and compile_program3's V(3,3) at 513³ (coarsen=3, dense solve
     at 9³, ω = 6/7) with the clean and the gpu metric, each with the kernels
     and with plain PyTorch: the iterates after 1 and 4 cycles, the float64
     relative residuals, ms/cycle, a profile; then the CLI --dim 3 on
     schedules/Vcycle.txt, schedules/Wcycle.txt and
     schedules/VcycleTrigger.txt against the JAX CLI's Error;
  E. the 3-D trigger V-cycle at 513³ (ω = 6/7, coarsen=3, clean metric, at
     most 2000 sweeps a node): its levels reach the batched passes of the
     per-sweep errors (513³), the streamed whole-loop kernel (257³) and the
     whole-loop kernel (129³, 65³); with trigger_batch 7, "auto" and 1 on the
     kernels, 7 and "auto" through the twins, 1 on the plain path;
  F. 3-D refinement: tw32 to 1e-10 at 513³ (IterativeRefinement3) with the
     kernels and with kernels="torch"; then the CLI --dim 3 --tol 1e-10
     --state tw32 on schedules/Vcycle.txt;
  G. the 2-D multi-device path on rings of shards, every shard on cuda:0
     (one card: no scaling). G1: the shard modes of kernels 1-4 and the ring
     kernels 17 and 18 against their twins at 1025² and 1031² on rings of
     2, 3, 4 and 8 shards and a 2 x 4 block mesh (several tiles a shard,
     ragged last shards and tiles), steps 1-8 and 11, from_zero, every
     error mode, per_sweep, rb-GS, both restrictions; every shard mode's
     owned cells bit for bit against the unsharded kernel; kernel 17 with
     caps of 1-60 sweeps and a mid-loop trigger bit for bit against the loop
     of one-sweep sharded error launches. G2: at 4097² on 8 shards
     (threshold 16) through compile_program(policy=...) with halo ppermute
     and rdma, and the plain path: bench_scaling.py's program (coarsen=1)
     and the bench's V(3,3), one cold and five warm cycles each, against the
     unsharded kernel run, ms/cycle and profiles; the rb-GS V(2,2) FW.
     G3: the 8193² trigger V-cycle on 8 shards (threshold 32) with rdma,
     ppermute and the twins ("auto") and batch 7, equal stop sweeps per
     level, held against phase B's unsharded run; and a 4097² rb-GS
     trigger V-cycle with the gpu metric on 8 shards (the rb-GS shard mode
     one sweep at a time), kernels, twins and plain path with equal stop
     sweeps. The shard modes and ring kernels are also held against their
     plain versions at the timed main-path shapes.
  H. the 3-D multi-device path on rings of z-shards, every shard on cuda:0
     (one card: no scaling). H1: the shard modes of kernels 10-13 (kernel
     10 in every mode: plain, from_zero, clean and gpu errors, per_sweep) and
     kernel 10's emit_residual mode against their twins, bit for bit, and
     their owned planes against the unsharded kernels, at 65³ and 129³ with
     tiles forced small on rings of 2, 3, 4 and 8 z-shards (ragged last
     shards); each per-sweep error against the one-sweep sharded steps, bit
     for bit. H2: 513³ on 8 z-shards (threshold 8): v_cycle3_sharded V(3,3)
     and compile_program3(policy=...) V(3,3) with the clean and gpu metrics,
     on the kernels, the twins and the plain path, one cold and three warm
     cycles, the kernel iterates bit for bit against phase D's unsharded
     runs, launch counts per route (JAX's padded depths), ms/cycle and
     profiles. H3: the 513³ trigger V-cycle under the policy with
     trigger_batch "auto" and 1 (stop sweeps per level equal to phase E's)
     and 7 (kernels against twins; one exact sweep, then passes of 7, as
     JAX's sharded batch runs). The shard modes are also held against their
     plain versions at the timed main-path shapes.
  I. the 3-D ring kernels 19-22 (halo="rdma") on rings of z-shards of
     cuda:0 (one card: no scaling). I1: each against its twin and against
     the PR 6 shard-mode path (window copies, then kernels 10-12 per shard)
     at 65³ and 129³ with tiles forced small on rings of 2, 3, 4, 8 and 16
     z-shards: kernel 20 with 1, 3, 7 and 8 sweeps, plain, from_zero, clean
     and gpu; kernel 21 with both restrictions, from_zero on and off;
     kernel 22 with and without the error and the coarse correction in
     three layouts; kernel 19 with both metrics and a trigger that stops it
     after 50 sweeps or more, against the loop of one-sweep sharded error
     launches; bit for bit. I2: H2's three programs with halo="rdma", bit
     for bit against phase D's unsharded runs (which H2's ppermute runs
     equal), the ring launches per cycle by kernel, ms/cycle, a profile.
     I3: H3's trigger V-cycle with halo="rdma" ("auto", batch 1, batch 7):
     kernel 19 once per trigger node at 257³-65³ and never at 513³; "auto"
     and batch 1 stop where H3 stops, with its iterates; batch 7 at 513³ as
     H3's, below it as the exact loop. The ring kernels are timed beside
     their twins and the exchange path they replace on the same inputs.
Launch counts are set to 0 just before each main-path run and read just
after it. The line before the last is a JSON object describing each kernel;
the last line is the JSON device record. Without a CUDA device the script
exits 1 and prints no result.
"""

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Kernel-vs-twin tolerances: the kernels and twins run the same fp32
# operations, but the error reductions sum in another order.
U_RTOL = 1e-5      # max|Δ| of a grid output ≤ U_RTOL · max|twin output|
ERR_RTOL = 1e-4    # fused error scalars, relative
RES_RTOL = 1e-2    # main path: kernel vs plain float64 residuals, relative
# The CLI's deep solve against the JAX CLI's Error: the two packages' fp32
# problem data differ (torch's and XLA's fp32 exp disagree by an ulp at ~7%
# of points), which moves a 1e-10 solve's Error in its 5th digit; on shared
# data the port prints JAX's 6 digits (tests/test_torch_refine.py).
CLI_TOL_ERR, CLI_TOL_RTOL = 2.221316e-07, 2e-4

# H100 SXM data sheet: device memory rate and fp32 rate outside the tensor
# cores; a bound is the larger of bytes / HBM and operations / FP32.
HBM, FP32 = 3.35e12, 67e12
# fp32 operations per point, counted from the kernels' source
SWEEP_OPS = 10     # Jacobi point: 3 adds, 4u, −, h²f, −, ×¼, ×ω, +
RES_OPS = 7        # residual point: 3 adds, 4u, −, ×h⁻², −
ERR_OPS = 9        # residual point + |·| + accumulate
RBGS_OPS = 6       # half-update of a cell: 3 adds, h²f, −, ×¼
RBGS_ERR_OPS = 10  # the Jacobi Δ of a cell: 3 adds, 4u, −, h²f, −, ×¼, |·|, +
RES_MW_OPS = {2: 227, 3: 232}   # two dd chains, the exact product, the combination
# the 3-D kernels (legs3.cuh), per fine point unless noted
SWEEP3_OPS = 11    # 7-point sweep: 5 adds, 6u, −, h²f, −, ×ω/6, +
EXTRA3_OPS = 11    # the clean error of an iterate: 5 adds, 6u, −, ×h⁻², −, |·|, accumulate
RES3_OPS = 9       # residual: 5 adds, 6u, −, ×h⁻², −
GPU_ERR3_OPS = 3   # the gpu error of a point: −, |·|, accumulate
FW3_OPS = 65       # per coarse point: 9 z-combines (3×, 2+), 3 y-combines, 1 x-combine
PROLONG3_OPS = 5.75  # prolongation and add, averaged over the parities of (z, y, x)
RES_MW3_OPS = {2: 329, 3: 337}  # two 7-point dd chains, the exact product, the combination
# the JAX CLI's --dim 3 Error on the 256³ schedules (fp32, CPU, compiled engine;
# VcycleTrigger.txt measured once with the JAX package's CLI on the CPU)
CLI3_ERRORS = {"Vcycle.txt": 3.422244e-02, "Wcycle.txt": 3.339685e-03,
               "VcycleTrigger.txt": 8.048455e-04}
CLI3_RTOL = 1e-4
# VcycleTrigger.txt's 64³ trigger node (plain ops in both packages) stops on
# a near-tie: its slope at sweep 277 lies within the noise of an fp32 sum of
# the trigger, so the summation decides the stop (XLA's fp32 sum: 278
# sweeps; the port's float64 sum: 277), and one sweep moves Error by 3.0e-3
# relative (ROADMAP Queue 3, item 5)
CLI3_RTOL_OF = {"VcycleTrigger.txt": 5e-3}

PKG = "multigrid_poisson_solver_tpu_torch/ops/csrc/"
TPU = "multigrid_poisson_solver_tpu/ops/"
KERNELS = {  # name -> (CUDA source, TPU kernel it replaces, main-path run)
    "jacobi": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:161", "Vcycle.txt"),
    "residual": (PKG + "residual.cu", TPU + "pallas_kernels.py:1077", "Vcycle.txt"),
    "trigger": (PKG + "trigger.cu", TPU + "pallas_chain.py:501", "VcycleTrigger.txt"),
    "descend": (PKG + "descend.cu", TPU + "pallas_kernels.py:590", "library"),
    "ascend": (PKG + "ascend.cu", TPU + "pallas_kernels.py:852", "library"),
    "chain_descend": (PKG + "chain_descend.cu", TPU + "pallas_chain.py:228", "library"),
    "chain_ascend": (PKG + "chain_ascend.cu", TPU + "pallas_chain.py:292", "library"),
    "residual_mw": (PKG + "residual_mw.cu", TPU + "pallas_kernels.py:1474", "refine"),
    "jacobi_errs": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:161", "trigger8193"),
    "trigger_stream": (PKG + "trigger_stream.cu", TPU + "pallas_chain.py:636", "trigger8193"),
    "rbgs": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:161", "rbgs"),
    "jacobi3": (PKG + "jacobi3.cu", TPU + "pallas3d.py:237", "compiled3_gpu"),
    "descend3": (PKG + "descend3.cu", TPU + "pallas3d.py:746", "v_cycle3"),
    "ascend3": (PKG + "ascend3.cu", TPU + "pallas3d.py:1103", "v_cycle3"),
    "residual3": (PKG + "residual3.cu", TPU + "pallas3d.py:1420", "compiled3_gpu"),
    "jacobi3_errs": (PKG + "jacobi3.cu", TPU + "pallas3d.py:237", "trigger3_513"),
    "trigger3": (PKG + "trigger3.cu", TPU + "pallas3d.py:1804", "trigger3_513"),
    "trigger3_stream": (PKG + "trigger3_stream.cu", TPU + "pallas3d.py:1999", "trigger3_513"),
    "residual_mw3": (PKG + "residual_mw3.cu", TPU + "pallas3d.py:1588", "refine3"),
    # the shard modes of kernels 1-4 and the two ring kernels (phase G)
    "jacobi_shard": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:500", "sharded"),
    "jacobi_errs_shard": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:500", "sharded_trigger_b7"),
    "rbgs_shard": (PKG + "jacobi.cu", TPU + "pallas_kernels.py:500", "sharded_rbgs"),
    "residual_shard": (PKG + "residual.cu", TPU + "pallas_kernels.py:1166", "sharded"),
    "descend_shard": (PKG + "descend.cu", TPU + "pallas_kernels.py:1233", "sharded_legs"),
    "ascend_shard": (PKG + "ascend.cu", TPU + "pallas_kernels.py:1388", "sharded_legs"),
    "rdma_jacobi": (PKG + "rdma_jacobi.cu", TPU + "pallas_rdma.py:157", "sharded_rdma"),
    "rdma_trigger": (PKG + "rdma_trigger.cu", TPU + "pallas_rdma.py:396", "sharded_trigger_rdma"),
    # the shard modes of the 3-D kernels 10-13 and kernel 10's emit_residual
    # mode (phase H)
    "jacobi3_shard": (PKG + "jacobi3.cu", TPU + "pallas3d.py:586", "h_compiled3_gpu"),
    "jacobi3_errs_shard": (PKG + "jacobi3.cu", TPU + "pallas3d.py:586", "h_trigger3_b7"),
    "jacobi3_residual": (PKG + "jacobi3.cu", TPU + "pallas3d.py:682", "h_v_cycle3"),
    "descend3_shard": (PKG + "descend3.cu", TPU + "pallas3d.py:1007", "h_v_cycle3"),
    "ascend3_shard": (PKG + "ascend3.cu", TPU + "pallas3d.py:1321", "h_v_cycle3"),
    "residual3_shard": (PKG + "residual3.cu", TPU + "pallas3d.py:1530", "h_compiled3_gpu"),
    # the 3-D ring kernels 19-22 (phase I)
    "rdma_trigger3": (PKG + "rdma_trigger3.cu", TPU + "pallas_rdma3.py:66", "i_trigger3_auto"),
    "rdma_jacobi3": (PKG + "rdma_jacobi3.cu", TPU + "pallas_rdma3.py:422", "i_compiled3_gpu"),
    "rdma_descend3": (PKG + "rdma_descend3.cu", TPU + "pallas_rdma3.py:856", "i_compiled3"),
    "rdma_ascend3": (PKG + "rdma_ascend3.cu", TPU + "pallas_rdma3.py:1285", "i_compiled3"),
}


# the kernels every single-device path reaches (phase 2 holds them); then
# the 2-D shard modes and the ring kernels (phase G), the 3-D shard modes
# (phase H) and the 3-D ring kernels (phase I)
SINGLE_DEVICE = tuple(KERNELS)[:19]
PHASE_G = tuple(KERNELS)[19:27]
PHASE_H = tuple(KERNELS)[27:33]
PHASE_I = tuple(KERNELS)[33:]


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def say(*parts):
    print(*parts, flush=True)


def time_ms(fn, reps, rounds=5):
    """Median over ``rounds`` of the mean device time of ``reps`` chained calls
    (CUDA events; one warm-up call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def wall_ms(fn):
    """Host wall time of one call that ends in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def profile(label, fn, per=1):
    """Device time by kernel over one call of fn (torch.profiler), per
    ``per`` units of work, and the device's idle share of the wall time
    (the profiler slows the host, so the idle share is an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _ = wall_ms(fn)
    # the device's own events (kernels, copies, fills), not the host ops
    # that launched them, which carry the same device time again
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    say(f"[p] {label}: wall {wall / per:.3f} ms, device busy {busy / per:.3f} ms per unit, "
        f"idle {max(0.0, 1 - busy / wall):.1%} (under the profiler)")
    for key, ms, count in rows[:8]:
        say(f"[p]     {ms / per:8.3f} ms  {count / per:6.1f}×  {key[:90]}")


def bound(nbytes, ops):
    """(the least time the card could take in ms, what bounds it)."""
    tb, tf = nbytes / HBM * 1e3, ops / FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


class Compare:
    """Per-kernel record of kernel-vs-twin comparisons."""

    def __init__(self):
        self.max_abs = {k: 0.0 for k in KERNELS}
        self.bitwise = {k: True for k in KERNELS}
        self.cases = {k: 0 for k in KERNELS}

    def grid(self, kernel, what, got, want):
        import torch

        require(got.shape == want.shape, f"{kernel} {what}: shape {tuple(got.shape)} "
                f"vs twin {tuple(want.shape)}")
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        self.max_abs[kernel] = max(self.max_abs[kernel], diff)
        self.bitwise[kernel] &= bool(torch.equal(got, want))
        require(bool(torch.isfinite(got).all()), f"{kernel} {what}: non-finite output")
        require(diff <= U_RTOL * scale,
                f"{kernel} {what}: max|Δ| {diff:.3e} > {U_RTOL:g}·{scale:.3e}")

    def scalar(self, kernel, what, got, want):
        got, want = float(got), float(want)
        require(abs(got - want) <= ERR_RTOL * abs(want),
                f"{kernel} {what}: error {got:.9e} vs twin {want:.9e}")

    def grids(self, kernel, what, got, want):
        require(len(got) == len(want), f"{kernel} {what}: {len(got)} levels vs {len(want)}")
        for k, (g, w) in enumerate(zip(got, want)):
            self.grid(kernel, f"{what} level {k}", g, w)


def ladder(n0, n_min=9):
    sizes = [n0]
    while sizes[-1] > n_min:
        sizes.append((sizes[-1] + 1) // 2)
    return tuple(sizes)


def phase2(K, torch, cmp, problem, GridSpec):
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 0.8

    def legs(n, steps_list, modes, fzs, restrictions, ascend=True):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        m = (n + 1) // 2
        uc = rand(m, m)
        for steps in steps_list:
            for compat in modes:
                tag = f"n={n} steps={steps} err={compat}"
                mode = True if compat is None else compat
                for fz in fzs:
                    # from_zero: the kernel must not read u, so u stays random
                    for restriction in restrictions:
                        args = (h, steps, omega, restriction, mode, compat is not None, fz)
                        gu, gfc, ge = K.fused_descend(u, f, *args)
                        wu, wfc, we = K.fused_descend_torch(u, f, *args)
                        what = f"{tag} fz={fz} {restriction}"
                        cmp.grid("descend", what + " u", gu, wu)
                        cmp.grid("descend", what + " f_coarse", gfc, wfc)
                        if compat is not None:
                            cmp.scalar("descend", what, ge, we)
                        cmp.cases["descend"] += 1
                if ascend:
                    args = (h, steps, omega, mode, compat is not None)
                    gu, ge = K.fused_ascend(u, f, uc, *args)
                    wu, we = K.fused_ascend_torch(u, f, uc, *args)
                    cmp.grid("ascend", tag, gu, wu)
                    if compat is not None:
                        cmp.scalar("ascend", tag, ge, we)
                    cmp.cases["ascend"] += 1

    def smoother(n, steps_list, modes, fzs, negate=(False, True)):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for ng in negate:
            cmp.grid("residual", f"n={n} negate={ng}", K.residual(u, f, h, ng),
                     K.residual_torch(u, f, h, ng))
            cmp.cases["residual"] += 1
        for steps in steps_list:
            for compat in modes:
                for fz in fzs:
                    tag = f"n={n} steps={steps} err={compat} fz={fz}"
                    if compat is None:
                        cmp.grid("jacobi", tag, K.fused_jacobi(u, f, h, steps, omega, fz),
                                 K.fused_jacobi_torch(u, f, h, steps, omega, fz))
                    else:
                        gu, ge = K.fused_jacobi_err(u, f, h, steps, omega, compat, fz)
                        wu, we = K.fused_jacobi_err_torch(u, f, h, steps, omega, compat, fz)
                        cmp.grid("jacobi", tag, gu, wu)
                        cmp.scalar("jacobi", tag, ge, we)
                    cmp.cases["jacobi"] += 1

    def chains(sizes, pre, post, restriction, fz, compat, want_err):
        h0 = 1.0 / (sizes[0] - 1)
        n0, nc = sizes[0], sizes[-1]
        u0, f0 = rand(n0, n0), rand(n0, n0)
        args = (sizes, h0, pre, omega, restriction, fz)
        gu, gf = K.chain_descend(u0, f0, *args)
        wu, wf = K.chain_descend_torch(u0, f0, *args)
        what = f"{sizes[0]}..{nc} pre={pre} {restriction} fz={fz}"
        cmp.grids("chain_descend", what + " u", gu, wu)
        cmp.grids("chain_descend", what + " f", gf, wf)
        cmp.cases["chain_descend"] += 1
        uc = rand(nc, nc)
        args = (wu, [f0] + wf[:-1], uc, sizes, h0, post, omega, compat, want_err)
        gu, ge = K.chain_ascend(*args)
        wu, we = K.chain_ascend_torch(*args)
        what = f"{sizes[0]}..{nc} post={post} err={compat if want_err else None}"
        cmp.grid("chain_ascend", what, gu, wu)
        if want_err:
            cmp.scalar("chain_ascend", what, ge, we)
        cmp.cases["chain_ascend"] += 1

    def trigger(n, u, f, compat, trig, max_sweeps):
        h = 1.0 / (n - 1)
        gu, ge, gk = K.trigger_smooth(u, f, h, omega, compat, trig, max_sweeps)
        wu, we, wk = K.trigger_smooth_torch(u, f, h, omega, compat, trig, max_sweeps)
        what = f"n={n} err={compat} trigger={trig} max={max_sweeps}"
        require(int(gk) == int(wk), f"trigger {what}: {int(gk)} sweeps vs twin {int(wk)}")
        cmp.grid("trigger", f"{what} ({int(wk)} sweeps)", gu, wu)
        cmp.scalar("trigger", what, ge, we)
        cmp.cases["trigger"] += 1
        return int(wk)

    def stream(n, u, f, compat, trig, max_sweeps):
        """The streamed loop against the sweep-at-a-time loop of one-sweep
        kernel launches, which sums the same partials in the same order: the
        same stop sweep, iterate and error, bit for bit. Then against the
        twin run for that many sweeps: the twin's errors sum in another
        order, so near the threshold its own stop test can flip a few sweeps
        apart after thousands of sweeps."""
        h = 1.0 / (n - 1)
        gu, ge, gk = K.trigger_smooth_stream(u, f, h, omega, compat, trig, max_sweeps)
        ru, re_, rk = trigger_loop(lambda v: K.fused_jacobi_err(v, f, h, 1, omega, compat), u,
                                   trig, max_sweeps)
        what = f"n={n} err={compat} trigger={trig} max={max_sweeps}"
        require(int(gk) == rk and bool(torch.equal(gu, ru)) and bool(torch.equal(ge, re_)),
                f"trigger_stream {what}: {int(gk)} sweeps vs {rk} of the one-sweep launches")
        wu, we, _ = K.trigger_smooth_torch(u, f, h, omega, compat, 0.0, int(gk))
        cmp.grid("trigger_stream", f"{what} ({int(gk)} sweeps)", gu, wu)
        cmp.scalar("trigger_stream", what, ge, we)
        cmp.cases["trigger_stream"] += 1
        return int(gk)

    def residual_mw(n):
        h = 1.0 / (n - 1)
        u0 = rand(n, n)
        u1, u2, f = rand(n, n) * 1e-8, rand(n, n) * 1e-16, rand(n, n)
        cmp.grid("residual_mw", f"n={n} tw", K.residual_tw(u0, u1, u2, f, h),
                 K.residual_tw_torch(u0, u1, u2, f, h))
        cmp.grid("residual_mw", f"n={n} df", K.residual_df(u0, u1, f, h),
                 K.residual_df_torch(u0, u1, f, h))
        cmp.cases["residual_mw"] += 2

    def jacobi_errs(n):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for compat in (True, False, "gpu"):
            for steps in range(1, K.errs_sweep_cap(compat) + 1):
                gu, ge = K.fused_jacobi_errs(u, f, h, steps, omega, compat)
                wu, we = K.fused_jacobi_errs_torch(u, f, h, steps, omega, compat)
                what = f"n={n} err={compat} steps={steps}"
                cmp.grid("jacobi_errs", what, gu, wu)
                for s in range(steps):
                    cmp.scalar("jacobi_errs", f"{what} iterate {s + 1}", ge[s], we[s])
                cmp.cases["jacobi_errs"] += 1
            # errs[s − 1] is the error a launch of s sweeps reports, bit for bit
            for s in range(1, steps + 1):
                require(torch.equal(ge[s - 1], K.fused_jacobi_err(u, f, h, s, omega, compat)[1]),
                        f"jacobi_errs n={n} err={compat}: errs[{s - 1}] differs from the "
                        f"error of {s} sweeps")

    def rbgs(n):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        for steps in (1, 2, 3, 4):
            for fz in (False, True):
                what = f"n={n} steps={steps} fz={fz}"
                cmp.grid("rbgs", what, K.fused_rbgs(u, f, h, steps, fz),
                         K.fused_rbgs_torch(u, f, h, steps, fz))
                cmp.cases["rbgs"] += 1
                for compat in (True, False):
                    gu, ge = K.fused_rbgs_err(u, f, h, steps, compat, fz)
                    wu, we = K.fused_rbgs_err_torch(u, f, h, steps, compat, fz)
                    cmp.grid("rbgs", f"{what} err={compat}", gu, wu)
                    cmp.scalar("rbgs", f"{what} err={compat}", ge, we)
                    cmp.cases["rbgs"] += 1

    # several tiles per dimension, ragged last tiles; every mode
    for n in (1025, 1031):
        smoother(n, (1, 3, 7, 8), (None, True, False, "gpu"), (False, True))
        legs(n, (1, 3, 7, 8), (None, True, False, "gpu"), (False, True),
             ("sampling", "full_weighting"))
        for compat in (True, False, "gpu"):
            for max_sweeps in (50, 51):   # the final iterate in either buffer
                trigger(n, rand(n, n), rand(n, n), compat, 0.0, max_sweeps)
        residual_mw(n)
        jacobi_errs(n)
        rbgs(n)
    # the library path's legs: 3 sweeps, sampling, the finest level's cpu error
    for n in (4097, 2049):
        legs(n, (3,), (None, True), (False, True), ("sampling",))
    # the library path's chains (1025 → 9, from zero) and other ladders
    chains(ladder(1025), (3,) * 7, (3,) * 7, "sampling", True, True, False)
    chains(ladder(1025), (3,) * 7, (3,) * 7, "sampling", False, True, True)
    chains(ladder(1025, 3), (8, 1, 2, 3, 4, 5, 6, 7, 8), (8, 0, 1, 2, 3, 4, 5, 6, 7),
           "full_weighting", False, False, True)
    chains(ladder(257), (2,) * 5, (1,) * 5, "full_weighting", True, "gpu", True)
    chains((33, 17), (3,), (3,), "sampling", False, True, True)
    # the CLI path's even levels: trigger smoothing on the problem's own data,
    # single sweeps with and without the finest error, residuals
    sweeps = {}
    for n in (256, 128, 64, 32, 16, 8):
        smoother(n, (1,), (None, True), (False,))
        spec = GridSpec(n)
        u = problem.boundary_grid(spec, torch.float32, "cuda")
        f = problem.source_grid(spec, torch.float32, "cuda") + u
        for trig in (0.01, 1e-4):
            if n >= 16:
                sweeps[f"{n}@{trig:g}"] = trigger(n, u, f, True, trig, 100_000)
    say(f"[2] trigger sweeps on the problem's data (level@trigger): {sweeps}")
    # this slice's main-path shapes: the refinement's 8193² residual and the
    # trigger V-cycle's 8193² passes, its streamed 4097² level (and a ragged
    # 2305²), the rb-GS cycle's 4097² level
    residual_mw(8193)
    jacobi_errs(8193)
    rbgs(4097)
    stops, inside = {}, 0
    for n in (2305, 4097):
        for compat in (True, False, "gpu"):
            b = K.errs_sweep_cap(compat)
            # one pass (the iterate in out), two (in the scratch grid), a
            # short last pass, and a loop that ends inside a pass (the replay)
            for max_sweeps in (b, 2 * b, 2 * b + 3, b - 2):
                stream(n, rand(n, n), rand(n, n), compat, 0.0, max_sweeps)
            spec = GridSpec(n)
            u = rand(n, n) * 0.01
            f = problem.source_grid(spec, torch.float32, "cuda")
            for trig in (1e-2, 1e-3):
                k = stream(n, u, f, compat, trig, 100_000)
                stops[f"{n}@{trig:g}/{compat}"] = k
                inside += k % b != 0
    say(f"[2] streamed trigger stop sweeps (level@trigger/metric): {stops}")
    require(inside > 0, "no streamed trigger loop stopped inside a pass: the replay went "
            "unchecked")
    torch.cuda.synchronize()


@contextlib.contextmanager
def twins_in_place(K):
    """Every kernel entry point of ops.kernels replaced by its plain twin, so
    the engine's kernel routing runs its exact control flow on the twins."""
    names = ["fused_jacobi", "fused_jacobi_err", "fused_jacobi_errs", "fused_rbgs",
             "fused_rbgs_err", "residual", "fused_descend", "fused_ascend", "chain_descend",
             "chain_ascend", "trigger_smooth"]
    saved = {name: getattr(K, name) for name in names + ["trigger_smooth_stream",
                                                         "residual_df", "residual_tw"]}
    for name in names:
        setattr(K, name, getattr(K, name + "_torch"))
    K.trigger_smooth_stream = K.trigger_smooth_torch
    K.residual_df, K.residual_tw = K.residual_df_torch, K.residual_tw_torch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


@contextlib.contextmanager
def twins3_in_place(K3):
    """Every kernel entry point of ops.kernels3 replaced by its plain twin
    (both whole-loop trigger kernels by the one-sweep loop)."""
    names = ["fused_jacobi3", "fused_jacobi3_err", "fused_jacobi3_errs", "fused_descend3",
             "fused_ascend3", "residual3", "trigger_step3", "trigger_smooth3", "residual_df3",
             "residual_tw3"]
    saved = {name: getattr(K3, name) for name in names + ["trigger_smooth3_stream"]}
    for name in names:
        setattr(K3, name, getattr(K3, name + "_torch"))
    K3.trigger_smooth3_stream = K3.trigger_smooth3_torch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K3, name, fn)


def phase_refine(tmg, K, torch, run_counts):
    """Path A: refinement to a tolerance, kernels against kernels="torch"."""
    results = {}
    for n, state, tol in ((8193, "tw32", 1e-10), (4097, "df32", 1e-9)):
        for kernels in ("auto", "torch"):
            solver = tmg.IterativeRefinementSolver(
                tmg.REFERENCE_PROBLEM, n, config=tmg.SolverConfig(omega=0.8, kernels=kernels),
                max_cycles=30, state=state, device="cuda")
            K.reset_launch_counts()
            ms, rep = wall_ms(lambda: solver.solve(tol))
            counts = dict(K.launches)
            if kernels == "auto" and n == 8193:
                run_counts["refine"] = counts
            require(kernels == "auto" or not any(counts.values()),
                    f"the plain refinement launched {counts}")
            require(bool(torch.isfinite(rep.u).all()) and rep.u.shape == (n, n),
                    f"refinement {n}² {state}: non-finite or misshapen result")
            rate = rep.rel_residual ** (1.0 / max(rep.cycles, 1))
            say(f"[A] refine {n}² {state} to {tol:g} kernels={kernels}: {rep.cycles} cycles, "
                f"rel {rep.rel_residual:.6e}, error {rep.error_vs_analytic:.6e}, wall {ms:.1f} ms "
                f"({ms / max(rep.cycles, 1):.2f} ms/cycle), effective contraction {rate:.4f}")
            results[(n, kernels)] = rep
            if kernels == "auto" and n == 8193:
                profile(f"refine {n}² {state} per cycle", lambda: solver.solve(tol),
                        per=rep.cycles)
        k, t = results[(n, "auto")], results[(n, "torch")]
        require(k.cycles == t.cycles, f"refine {n}² {state}: {k.cycles} cycles with the kernels, "
                f"{t.cycles} plain")
        if state == "tw32":
            require(k.rel_residual <= tol, f"tw32 {n}²: rel {k.rel_residual:.3e} > {tol:g}")
        for what, got, want in (("u", k.u, t.u), ("u_lo", k.u_lo, t.u_lo)):
            diff, scale = float((got - want).abs().max()), float(want.abs().max())
            say(f"[A] {n}² {state} word {what}: max|kernel − plain| {diff:.3e} "
                f"(bit-identical: {bool(torch.equal(got, want))})")
            require(diff <= U_RTOL * scale, f"refine {n}² {state}: {what} differs")
    say(f"[A] launches over the 8193² tw32 kernel run: {run_counts['refine']}")


def phase_cli_tol(cli, K, run_counts):
    argv = ["1", "schedules/Vcycle.txt", "--tol", "1e-10", "--state", "tw32", "--quiet",
            "--no-output"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    require(proc.returncode == 0, f"CLI --tol failed:\n{proc.stdout}\n{proc.stderr}")
    m = re.search(r"RelRes = (\S+) after (\d+) cycles\n\s+Error = (\S+)\nTime Used = (\S+)",
                  proc.stdout)
    require(m is not None, f"CLI --tol printed no result:\n{proc.stdout}")
    err = float(m.group(3))
    say(f"[A] CLI --tol 1e-10 --state tw32 Vcycle.txt: RelRes = {m.group(1)} after "
        f"{m.group(2)} cycles, Error = {m.group(3)} (JAX CLI: 16 cycles, {CLI_TOL_ERR:.6e}), "
        f"solve {m.group(4)} ms, process {ms:.0f} ms")
    require(int(m.group(2)) == 16, "CLI --tol on Vcycle.txt: not 16 cycles")
    require(abs(err - CLI_TOL_ERR) <= CLI_TOL_RTOL * CLI_TOL_ERR,
            f"CLI --tol Error {err:.6e} vs {CLI_TOL_ERR:.6e}")
    K.reset_launch_counts()
    require(cli.main(argv + ["--device", "cuda"]) == 0, "in-process CLI --tol failed")
    run_counts["cli_tol"] = dict(K.launches)
    say(f"[A] launches over the in-process CLI --tol run: {run_counts['cli_tol']}")


def phase_trigger(tmg, K, torch, run_counts):
    """Path B: the trigger V-cycle at 8193² across all three trigger tiers.
    On the reference problem no 8193² trigger node outlasts the 2B exact
    sweeps "auto" starts with, so "auto" is the trigger_batch=1 loop there;
    the batched passes of the per-sweep error mode run with an integer
    trigger_batch, the main run."""
    n = 8193
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    cap = 2000
    out, profiled = {}, []

    def run(tag, batch, kernels="auto"):
        cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, kernels=kernels,
                               trigger_batch=batch, max_trigger_sweeps=cap)
        cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        require(bool(torch.isfinite(u).all()) and bool(torch.isfinite(err)),
                f"trigger V-cycle {tag}: non-finite result")
        say(f"[B] trigger V-cycle {n}² {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}")
        hit = [k for _, k in cc.trigger_sweeps if k >= cap]
        if hit:
            say(f"[B] {tag}: {len(hit)} trigger node(s) reached max_trigger_sweeps={cap}")
        out[tag] = (u, float(err), cc.trigger_sweeps, ms, counts)
        if batch == 7 and not profiled:
            profiled.append(tag)
            cc.trigger_sweeps = None
            profile(f"trigger V-cycle {n}² {tag}", lambda: cc(u0, f))
        return tag, counts

    main, run_counts["trigger8193"] = run("kernels, batch 7", 7)
    auto = run("kernels, auto", "auto")[0]
    batch1 = run("kernels, batch 1", 1)[0]
    with twins_in_place(K):
        twins = run("twins, batch 7", 7)[0]
        twins_auto = run("twins, auto", "auto")[0]
    plain = run("plain, batch 1", 1, kernels="torch")[0]
    for a, b in ((main, twins), (auto, twins_auto), (batch1, plain)):
        ua, ea, sa = out[a][:3]
        ub, eb, sb = out[b][:3]
        require(sa == sb, f"trigger V-cycle: stop points {sa} ({a}) vs {sb} ({b})")
        diff, scale = float((ua - ub).abs().max()), float(ub.abs().max())
        say(f"[B] {a} vs {b}: equal stop points, max|Δu| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(ua, ub))})")
        require(diff <= U_RTOL * scale, f"trigger V-cycle iterates differ: {a} vs {b}")
    counts = run_counts["trigger8193"]
    say(f"[B] launches over the batch-7 kernel run: {counts}; over the auto run: "
        f"{out[auto][4]}")
    for k in ("trigger", "trigger_stream", "jacobi_errs"):
        require(counts[k] > 0, f"the trigger V-cycle did not launch {k}")
    # the first node (8193² going down) starts where the exact run's does:
    # its batched passes overshoot the exact stop sweep by fewer than 7
    (m, k), (_, k1) = out[main][2][0], out[batch1][2][0]
    require(m == n and k % 7 == 0 and k1 <= k < k1 + 7,
            f"batch-7 {m}²: {k} sweeps against {k1} exact")
    return {tag: out[tag][3] for tag in out}, out[main][2], out[auto][2]


def phase_rbgs(tmg, K, torch, run_counts):
    """Path C: rb-GS V(2,2) with full weighting at 4097², cycles and refinement."""
    n = 4097
    program = tmg.v_cycle(n, n_min=8, steps=2, coarse_option=0, coarsen=3)
    results = {}
    for kernels in ("auto", "torch"):
        cfg = tmg.SolverConfig(smoother="rbgs", restriction="full_weighting",
                               collect_node_stats=False, kernels=kernels)
        cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
        warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
        u0, f = cold.init()
        K.reset_launch_counts()
        u1, _ = cold(u0, f)
        u = u1
        for _ in range(5):
            u, err = warm(u, f)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        if kernels == "auto":
            run_counts["rbgs"] = counts
        require(bool(torch.isfinite(u).all()) and bool(torch.isfinite(err)),
                f"rb-GS cycle kernels={kernels}: non-finite output")
        ms = time_ms(lambda: warm(u, f), reps=5, rounds=3)
        results[kernels] = (u1, u, ms)
        if kernels == "auto":
            profile(f"rb-GS V(2,2) FW {n}² per cycle",
                    lambda: [warm(u, f) for _ in range(3)], per=3)
        say(f"[C] rb-GS V(2,2) FW {n}² kernels={kernels}: {ms:.3f} ms/cycle, last error "
            f"{float(err):.6e}")
    for i, what in ((0, "1 cycle"), (1, "6 cycles")):
        got, want = results["auto"][i], results["torch"][i]
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[C] iterate after {what}: max|u_kernel − u_plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"rb-GS iterates differ after {what}")
    say(f"[C] launches over the kernel path's 6 cycles: {run_counts['rbgs']}")
    require(not run_counts["rbgs"]["descend"] and run_counts["rbgs"]["rbgs"] > 0
            and run_counts["rbgs"]["residual"] > 0, "the rb-GS cycle took the wrong kernels")
    reps = {}
    for kernels in ("auto", "torch"):
        cfg = tmg.SolverConfig(smoother="rbgs", restriction="full_weighting", kernels=kernels)
        solver = tmg.IterativeRefinementSolver(tmg.REFERENCE_PROBLEM, n, program=program,
                                               config=cfg, max_cycles=30, device="cuda")
        ms, reps[kernels] = wall_ms(lambda: solver.solve(1e-9))
        say(f"[C] refine rb-GS FW {n}² df32 to 1e-9 kernels={kernels}: {reps[kernels].cycles} "
            f"cycles, rel {reps[kernels].rel_residual:.6e}, wall {ms:.1f} ms")
    require(reps["auto"].cycles == reps["torch"].cycles, "rb-GS refinement: cycle counts differ")
    return results["auto"][2]


def phase2_3d(K3, torch, cmp, small=((65, (6, 10, 6)), (129, (8, 16, 10)), (131, (8, 16, 10))),
              legs=(513, 257), main=513):
    """The 3-D kernels against their twins: at the ``small`` sizes with the
    tile forced to (ty, tx, cz), every sweep count within each cap, from_zero,
    the clean and gpu errors, both restrictions, the per-sweep errors, the
    trigger loops and the multi-word residual; then with the planned tiles
    at the main paths' shapes."""
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 6.0 / 7.0

    def jacobi(n, u, f, h, steps, fz, modes):
        tag = f"n={n} steps={steps} fz={fz}"
        if None in modes:
            cmp.grid("jacobi3", tag, K3.fused_jacobi3(u, f, h, steps, omega, fz),
                     K3.fused_jacobi3_torch(u, f, h, steps, omega, fz))
            cmp.cases["jacobi3"] += 1
        for mode in modes:
            if mode is None or (mode == "clean" and steps - fz > 7):
                continue
            gu, ge = K3.fused_jacobi3_err(u, f, h, steps, omega, mode, fz)
            wu, we = K3.fused_jacobi3_err_torch(u, f, h, steps, omega, mode, fz)
            cmp.grid("jacobi3", f"{tag} err={mode}", gu, wu)
            cmp.scalar("jacobi3", f"{tag} err={mode}", ge, we)
            cmp.cases["jacobi3"] += 1

    def descend(n, u, f, h, steps, fz, restriction, want_err):
        tag = f"n={n} steps={steps} fz={fz} {restriction} err={want_err}"
        args = (h, steps, omega, fz, restriction, want_err)
        gu, gfc, ge = K3.fused_descend3(u, f, *args)
        wu, wfc, we = K3.fused_descend3_torch(u, f, *args)
        cmp.grid("descend3", tag + " u", gu, wu)
        cmp.grid("descend3", tag + " f_coarse", gfc, wfc)
        if want_err:
            cmp.scalar("descend3", tag, ge, we)
        cmp.cases["descend3"] += 1

    def ascend(n, u, f, uc, h, steps, want_err):
        tag = f"n={n} steps={steps} err={want_err}"
        gu, ge = K3.fused_ascend3(u, f, uc, h, steps, omega, want_err)
        wu, we = K3.fused_ascend3_torch(u, f, uc, h, steps, omega, want_err)
        cmp.grid("ascend3", tag, gu, wu)
        if want_err:
            cmp.scalar("ascend3", tag, ge, we)
        cmp.cases["ascend3"] += 1

    def residual(n, u, f, h):
        for ng in (False, True):
            cmp.grid("residual3", f"n={n} negate={ng}", K3.residual3(u, f, h, ng),
                     K3.residual3_torch(u, f, h, ng))
            cmp.cases["residual3"] += 1

    def errs(n, u, f, h, all_counts=True):
        """Every sweep count (or the cap), both metrics; errs[s − 1] is the
        error the s-th one-sweep step of a trigger loop reports, bit for bit."""
        for compat in ("clean", "gpu"):
            cap = K3.errs3_sweep_cap(compat)
            for steps in range(1 if all_counts else cap, cap + 1):
                gu, ge = K3.fused_jacobi3_errs(u, f, h, steps, omega, compat)
                wu, we = K3.fused_jacobi3_errs_torch(u, f, h, steps, omega, compat)
                what = f"n={n} {compat} steps={steps}"
                cmp.grid("jacobi3_errs", what, gu, wu)
                for s in range(steps):
                    cmp.scalar("jacobi3_errs", f"{what} iterate {s + 1}", ge[s], we[s])
                cmp.cases["jacobi3_errs"] += 1
            v = u
            for s in range(1, cap + 1):
                v, e = K3.trigger_step3(v, f, h, omega, compat)
                require(torch.equal(ge[s - 1], e),
                        f"jacobi3_errs n={n} {compat}: errs[{s - 1}] differs from the error "
                        f"of the {s}th one-sweep step")

    def mid_trigger(u, f, h, compat, k=30):
        """A trigger that ends the loop near sweep k: the slope the one-sweep
        loop takes there (data-dependent, so some stop lands inside a pass)."""
        v, prev = u, None
        for _ in range(k):
            v, e = K3.trigger_step3(v, f, h, omega, compat)
            slope, prev = (None if prev is None else abs(float(e) - prev)), float(e)
        return slope

    def trigger3(name, n, u, f, h, compat, trig, max_sweeps):
        """A whole-loop trigger kernel against the loop of one-sweep launches,
        which sum the same partials in the same order: the same stop sweep,
        iterate and error, bit for bit; then against the twin run for that
        many sweeps."""
        fn = K3.trigger_smooth3 if name == "trigger3" else K3.trigger_smooth3_stream
        gu, ge, gk = fn(u, f, h, omega, compat, trig, max_sweeps)
        ru, re_, rk = trigger_loop(lambda v: K3.trigger_step3(v, f, h, omega, compat), u, trig,
                                   max_sweeps)
        what = f"n={n} {compat} trigger={trig:.6g} max={max_sweeps}"
        require(int(gk) == rk and bool(torch.equal(gu, ru)) and bool(torch.equal(ge, re_)),
                f"{name} {what}: {int(gk)} sweeps vs {rk} of the one-sweep launches")
        wu, we, _ = K3.trigger_smooth3_torch(u, f, h, omega, compat, 0.0, int(gk))
        cmp.grid(name, f"{what} ({int(gk)} sweeps)", gu, wu)
        cmp.scalar(name, what, ge, we)
        cmp.cases[name] += 1
        return int(gk)

    stops = {}

    def loops(n, u, f, h, caps=(1, 20, 21, 9)):
        """Both trigger kernels, both metrics: a trigger of 0 to each cap (the
        final iterate in either buffer, a short last pass) and a trigger that
        stops mid-loop."""
        for compat in ("clean", "gpu"):
            trig = mid_trigger(u, f, h, compat)
            for name in ("trigger3", "trigger3_stream"):
                for cap in caps:
                    trigger3(name, n, u, f, h, compat, 0.0, cap)
                stops[f"{name} {n}/{compat}"] = trigger3(name, n, u, f, h, compat, trig, 60)

    def residual_mw(n):
        hh = 1.0 / (n - 1)
        w0, w1, w2, ff = rand(n, n, n), rand(n, n, n) * 1e-8, rand(n, n, n) * 1e-16, rand(n, n, n)
        cmp.grid("residual_mw3", f"n={n} tw", K3.residual_tw3(w0, w1, w2, ff, hh),
                 K3.residual_tw3_torch(w0, w1, w2, ff, hh))
        cmp.grid("residual_mw3", f"n={n} df", K3.residual_df3(w0, w1, ff, hh),
                 K3.residual_df3_torch(w0, w1, ff, hh))
        cmp.cases["residual_mw3"] += 2

    saved = K3.FORCE_TILE3
    try:
        for n, tile in small:
            K3.FORCE_TILE3 = tile
            h = 1.0 / (n - 1)
            u, f = rand(n, n, n), rand(n, n, n)
            m = (n + 1) // 2
            uc = rand(m, m, m)
            residual(n, u, f, h)
            for steps in range(1, 9):
                for fz in (False, True):
                    jacobi(n, u, f, h, steps, fz, (None, "clean", "gpu"))
                    for restriction, cap in (("full_weighting", 6), ("sampling", 7)):
                        if steps - fz <= cap:
                            for want_err in (False, True):
                                descend(n, u, f, h, steps, fz, restriction, want_err)
                ascend(n, u, f, uc, h, steps, False)
                if steps <= 7:
                    ascend(n, u, f, uc, h, steps, True)
            errs(n, u, f, h)
            loops(n, rand(n, n, n) * 0.01, f, h)
            residual_mw(n)    # 2^k + 1 grids (65, 129) and one that is not (131)
    finally:
        K3.FORCE_TILE3 = saved
    # the main path's shapes, planned tiles: 3 sweeps, both legs' variants
    for n in legs:
        h = 1.0 / (n - 1)
        u, f = rand(n, n, n), rand(n, n, n)
        m = (n + 1) // 2
        uc = rand(m, m, m)
        for fz, want_err in ((False, False), (False, True), (True, False), (True, True)):
            descend(n, u, f, h, 3, fz, "full_weighting", want_err)
        descend(n, u, f, h, 3, False, "sampling", True)
        ascend(n, u, f, uc, h, 3, False)
        ascend(n, u, f, uc, h, 3, True)
        del u, f, uc
    h = 1.0 / (main - 1)
    u, f = rand(main, main, main), rand(main, main, main)
    jacobi(main, u, f, h, 3, False, (None, "clean", "gpu"))
    jacobi(main, u, f, h, 3, True, ("clean",))
    jacobi(main, u, f, h, 8, False, (None,))
    residual(main, u, f, h)
    errs(main, u, f, h, all_counts=False)
    del u, f
    residual_mw(main)
    # the trigger loops at their main-path sizes, planned tiles
    for n, name in ((257, "trigger3_stream"), (129, "trigger3")):
        h = 1.0 / (n - 1)
        u, f = rand(n, n, n) * 0.01, rand(n, n, n)
        b = K3.errs3_sweep_cap("clean") if name == "trigger3_stream" else 1
        for compat in ("clean", "gpu"):
            for cap in (b, 2 * b, 2 * b + 3, 50):
                trigger3(name, n, u, f, h, compat, 0.0, cap)
            stops[f"{name} {n}/{compat}"] = trigger3(name, n, u, f, h, compat,
                                                     mid_trigger(u, f, h, compat), 60)
    say(f"[2] 3-D trigger stop sweeps at a mid-loop trigger (kernel size/metric): {stops}")
    inside = sum(k % 7 != 0 for key, k in stops.items() if "stream" in key and "clean" in key)
    require(inside > 0 and all(k < 60 for k in stops.values()),
            "no streamed 3-D trigger loop stopped inside a pass, or one ran to its cap")
    torch.cuda.synchronize()


def rel_res3(p3, u, f, h):
    """float64 ‖r‖₂ / ‖f‖₂ over the interior."""
    import torch

    r = p3.residual3(u.double(), f.double(), h)[1:-1, 1:-1, 1:-1]
    return float(torch.linalg.vector_norm(r)
                 / torch.linalg.vector_norm(f.double()[1:-1, 1:-1, 1:-1]))


def compare_paths(tag, results, torch):
    """Kernel path against plain: iterates after 1 and 4 cycles, float64
    residuals, and no launch on the plain path."""
    k, t = results["auto"], results["torch"]
    for i, what in ((0, "1 cycle"), (1, "4 cycles")):
        got, want = k["u"][i], t["u"][i]
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[D] {tag} iterate after {what}: max|u_kernel − u_plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"{tag}: kernel and plain iterates differ after {what}: "
                f"{diff:.3e} > {U_RTOL:g}·{scale:.3e}")
        rk, rt = k["res"][i], t["res"][i]
        require(abs(rk - rt) <= RES_RTOL * rt, f"{tag}: float64 residuals {rk:.6e} (kernels) "
                f"vs {rt:.6e} (plain) after {what}")
    require(not any(t["counts"].values()), f"{tag}: the plain path launched {t['counts']}")


def phase_3d(tmg, K, torch, run_counts, n=513):
    """Path D: 3-D at full width (513³)."""
    from multigrid_poisson_solver_tpu_torch import cli
    from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3

    h = 1.0 / (n - 1)
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cuda")
    f = prob.source_grid(n, torch.float32, "cuda") + u0
    out = {}

    def run(tag, step, kernels, counts_key=None, profile_it=False):
        """One cold cycle and three warm ones through step(u, warm)."""
        results = {}
        for k in ("auto", "torch") if kernels else ("torch",):
            K.reset_launch_counts()
            u1 = step(k, u0, False)
            u = u1
            for _ in range(3):
                u = step(k, u, True)
            torch.cuda.synchronize()
            counts = dict(K.launches)
            require(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all()),
                    f"{tag} kernels={k}: non-finite or misshapen iterate")
            r1, r4 = rel_res3(p3, u1, f, h), rel_res3(p3, u, f, h)
            ms = time_ms(lambda: step(k, u, True), reps=3 if k == "auto" else 1, rounds=3)
            results[k] = {"u": (u1, u), "res": (r1, r4), "ms": ms, "counts": counts}
            say(f"[D] {tag} kernels={k}: {ms:.3f} ms/cycle, float64 rel. residual "
                f"{r1:.6e} after 1 cycle, {r4:.6e} after 4 (per-cycle ratio "
                f"{(r4 / r1) ** (1 / 3):.4f})")
            if k == "auto":
                say(f"[D] {tag} launches over the kernel path's 4 cycles: {counts}")
                if counts_key:
                    run_counts[counts_key] = counts
                if profile_it:
                    profile(f"{tag} per cycle", lambda: [step(k, u, True) for _ in range(3)],
                            per=3)
        compare_paths(tag, results, torch)
        out[tag] = results

    # 1. the library V-cycle, as in the bench
    run("v_cycle3 513³ V(3,3)",
        lambda k, u, warm: tmg.v_cycle3(u, f, h, n_min=5, pre=3, post=3, omega=0.857,
                                        kernels=k), True, "v_cycle3", profile_it=True)
    # 2. the compiled engine, clean metric (fused legs) and gpu metric (no
    #    fused leg: smoother passes, the residual kernel, 2:1 transfers)
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    for compat, key in ((True, "compiled3"), ("gpu", "compiled3_gpu")):
        ccs = {k: tmg.compile_program3(program, prob, tmg.SolverConfig(
            omega=6.0 / 7.0, compat_error=compat, collect_node_stats=False, kernels=k),
            device="cuda") for k in ("auto", "torch")}
        run(f"compile_program3 513³ V(3,3) compat={compat}",
            lambda k, u, warm: ccs[k](u, f, warm=warm)[0], True, key,
            profile_it=compat is True)
    require(run_counts["compiled3"]["descend3"] > 0 and run_counts["compiled3"]["ascend3"] > 0,
            "the clean compiled3 cycle did not run the fused legs")
    require(run_counts["compiled3_gpu"]["descend3"] == 0
            and run_counts["compiled3_gpu"]["residual3"] > 0,
            "the gpu-metric compiled3 cycle did not take the non-fused legs")

    # 3. the CLI --dim 3 against the JAX CLI's Error
    for name, want in CLI3_ERRORS.items():
        argv = ["1", f"schedules/{name}", "--dim", "3", "--engine", "compiled", "--quiet",
                "--no-output"]
        proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch",
                               *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"CLI --dim 3 failed:\n{proc.stdout}\n{proc.stderr}")
        match = re.search(r"Error = ([0-9.eE+-]+)\nTime Used = (\S+)", proc.stdout)
        require(match is not None, f"CLI --dim 3 printed no error:\n{proc.stdout}")
        err = float(match.group(1))
        rtol = CLI3_RTOL_OF.get(name, CLI3_RTOL)
        say(f"[D] CLI --dim 3 {name}: Error = {match.group(1)} (JAX CLI {want:.6e}, "
            f"rel. diff {abs(err - want) / want:.2e}, bound {rtol:g}), solve {match.group(2)} ms")
        require(abs(err - want) <= rtol * want, f"CLI --dim 3 {name}: Error {err:.6e} "
                f"vs the JAX CLI's {want:.6e}")
        K.reset_launch_counts()
        require(cli.main(argv + ["--device", "cuda"]) == 0, f"in-process CLI --dim 3 {name}")
        run_counts[f"cli3 {name}"] = dict(K.launches)
        say(f"[D] launches over the in-process CLI --dim 3 run on {name}: "
            f"{run_counts[f'cli3 {name}']}")
    return {tag: (r["auto"]["ms"], r["torch"]["ms"]) for tag, r in out.items()}, out


def phase_trigger3(tmg, K, K3, torch, run_counts, n=513):
    """Path E: the 3-D trigger V-cycle at 513³ across all trigger tiers."""
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    prob = tmg.REFERENCE_PROBLEM_3D
    cap = 2000
    out = {}

    def run(tag, batch, kernels="auto", profile_it=False):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=False, collect_node_stats=False,
                               kernels=kernels, trigger_batch=batch, max_trigger_sweeps=cap)
        cc = tmg.compile_program3(program, prob, cfg, device="cuda")
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        require(tuple(u.shape) == (n, n, n) and bool(torch.isfinite(u).all())
                and bool(torch.isfinite(err)), f"3-D trigger V-cycle {tag}: non-finite result")
        require(kernels == "auto" or not any(counts.values()),
                f"3-D trigger V-cycle {tag}: the plain path launched {counts}")
        say(f"[E] trigger V-cycle {n}³ {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}")
        hit = [k for _, k in cc.trigger_sweeps if k >= cap]
        if hit:
            say(f"[E] {tag}: {len(hit)} trigger node(s) reached max_trigger_sweeps={cap}")
        out[tag] = (u, float(err), cc.trigger_sweeps, ms, counts)
        if profile_it:
            cc.trigger_sweeps = None
            profile(f"trigger V-cycle {n}³ {tag}", lambda: cc(u0, f))
        return tag

    main = run("kernels, batch 7", 7, profile_it=True)
    run_counts["trigger3_513"] = out[main][4]
    auto = run("kernels, auto", "auto")
    batch1 = run("kernels, batch 1", 1)
    with twins3_in_place(K3):
        twins = run("twins, batch 7", 7)
        twins_auto = run("twins, auto", "auto")
    plain = run("plain, batch 1", 1, kernels="torch")
    for a, b in ((main, twins), (auto, twins_auto), (batch1, plain)):
        ua, _, sa = out[a][:3]
        ub, _, sb = out[b][:3]
        require(sa == sb, f"3-D trigger V-cycle: stop points {sa} ({a}) vs {sb} ({b})")
        diff, scale = float((ua - ub).abs().max()), float(ub.abs().max())
        say(f"[E] {a} vs {b}: equal stop points, max|Δu| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(ua, ub))})")
        require(diff <= U_RTOL * scale, f"3-D trigger V-cycle iterates differ: {a} vs {b}")
    counts = run_counts["trigger3_513"]
    say(f"[E] launches over the batch-7 kernel run: {counts}; over the auto run: "
        f"{out[auto][4]}; over the batch-1 run: {out[batch1][4]}")
    for k in ("trigger3", "trigger3_stream", "jacobi3_errs"):
        require(counts[k] > 0, f"the 3-D trigger V-cycle did not launch {k}")
    # the first node (513³ going down) starts where the exact run's does: its
    # batched passes overshoot the exact stop sweep by fewer than 7
    (m, k), (_, k1) = out[main][2][0], out[batch1][2][0]
    require(m == n and k % 7 == 0 and k1 <= k < k1 + 7,
            f"batch-7 {m}³: {k} sweeps against {k1} exact")
    return {tag: out[tag][3] for tag in out}, out[main][2], out[auto][2], out[batch1][2]


def phase_refine3(tmg, K, torch, run_counts, cli, n=513, tol=1e-10):
    """Path F: 3-D refinement, tw32 to 1e-10 at 513³, kernels against
    kernels="torch"; then the CLI --dim 3 --tol on Vcycle.txt."""
    results = {}
    for kernels in ("auto", "torch"):
        solver = tmg.IterativeRefinement3(tmg.REFERENCE_PROBLEM_3D, n, max_cycles=25,
                                          state="tw32", kernels=kernels, device="cuda")
        K.reset_launch_counts()
        ms, rep = wall_ms(lambda: solver.solve(tol))
        counts = dict(K.launches)
        if kernels == "auto":
            run_counts["refine3"] = counts
        require(kernels == "auto" or not any(counts.values()),
                f"the plain 3-D refinement launched {counts}")
        require(bool(torch.isfinite(rep.u).all()) and rep.u.shape == (n, n, n),
                f"refine3 {n}³: non-finite or misshapen result")
        say(f"[F] refine3 {n}³ tw32 to {tol:g} kernels={kernels}: {rep.cycles} cycles, "
            f"rel {rep.rel_residual:.6e}, error {rep.error_vs_analytic:.6e}, wall {ms:.1f} ms "
            f"({ms / max(rep.cycles, 1):.2f} ms/cycle)")
        require(rep.rel_residual <= tol, f"refine3 {n}³ kernels={kernels}: rel "
                f"{rep.rel_residual:.3e} > {tol:g}")
        results[kernels] = rep
        if kernels == "auto":
            profile(f"refine3 {n}³ tw32 per cycle", lambda: solver.solve(tol), per=rep.cycles)
    k, t = results["auto"], results["torch"]
    require(k.cycles == t.cycles, f"refine3 {n}³: {k.cycles} cycles with the kernels, "
            f"{t.cycles} plain")
    for what, got, want in (("u", k.u, t.u), ("u_lo", k.u_lo, t.u_lo)):
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[F] {n}³ tw32 word {what}: max|kernel − plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"refine3 {n}³: {what} differs")
    say(f"[F] launches over the {n}³ tw32 kernel run: {run_counts['refine3']}")
    argv = ["1", "schedules/Vcycle.txt", "--dim", "3", "--tol", "1e-10", "--state", "tw32",
            "--quiet", "--no-output"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch", *argv],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    ms = (time.perf_counter() - t0) * 1e3
    require(proc.returncode == 0, f"CLI --dim 3 --tol failed:\n{proc.stdout}\n{proc.stderr}")
    m = re.search(r"Error = (\S+)\nRelative residual = (\S+) \((\d+) refinement cycles\)\n"
                  r"Time Used = (\S+)", proc.stdout)
    require(m is not None, f"CLI --dim 3 --tol printed no result:\n{proc.stdout}")
    require(math.isfinite(float(m.group(1))) and math.isfinite(float(m.group(2))),
            "CLI --dim 3 --tol: a non-finite result")
    say(f"[F] CLI --dim 3 --tol 1e-10 --state tw32 Vcycle.txt: Error = {m.group(1)}, relative "
        f"residual {m.group(2)} after {m.group(3)} cycles, solve {m.group(4)} ms, process "
        f"{ms:.0f} ms")
    K.reset_launch_counts()
    require(cli.main(argv + ["--device", "cuda"]) == 0, "in-process CLI --dim 3 --tol failed")
    run_counts["cli3_tol"] = dict(K.launches)
    say(f"[F] launches over the in-process CLI --dim 3 --tol run: {run_counts['cli3_tol']}")
    return {kern: (r.cycles, r.wall_time_s * 1e3) for kern, r in results.items()}


@contextlib.contextmanager
def sharded_twins_in_place(K, rdma):
    """Every shard-mode entry point of ops.kernels and both ring kernels of
    ops.rdma replaced by their plain twins (the sharded wrappers look them up
    at each call)."""
    names = ["fused_jacobi_shard", "fused_jacobi_errs_shard", "residual_shard",
             "fused_descend_shard", "fused_ascend_shard"]
    saved = {name: getattr(K, name) for name in names}
    saved_ring = (rdma.rdma_jacobi, rdma.rdma_trigger)
    for name in names:
        setattr(K, name, getattr(K, name + "_torch"))
    rdma.rdma_jacobi, rdma.rdma_trigger = rdma.rdma_jacobi_torch, rdma.rdma_trigger_torch
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)
        rdma.rdma_jacobi, rdma.rdma_trigger = saved_ring


def ring_policies(threshold=16):
    """Rings of 2, 3, 4 and 8 shards and a 2 × 4 block mesh, every shard on
    cuda:0."""
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    pols = {f"rows-{p}": M.ShardingPolicy(M.make_mesh(["cuda:0"] * p), threshold_rows=threshold)
            for p in (2, 3, 4, 8)}
    pols["block-2x4"] = M.BlockShardingPolicy(M.make_mesh_2d((2, 4), ["cuda:0"] * 8),
                                              threshold_rows=threshold)
    return pols


@contextlib.contextmanager
def sharded3_twins_in_place(K3):
    """Every 3-D shard-mode entry point of ops.kernels3, and the whole-grid
    emit_residual one, replaced by its plain twin (parallel.kernel_shard3
    looks them up at each call)."""
    names = ["fused_jacobi3_shard", "fused_jacobi3_errs_shard", "fused_jacobi3_residual_shard",
             "fused_descend3_shard", "fused_ascend3_shard", "residual3_shard",
             "fused_jacobi3_residual"]
    saved = {name: getattr(K3, name) for name in names}
    for name in names:
        setattr(K3, name, getattr(K3, name + "_torch"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K3, name, fn)


def z_policy(shards, threshold=8):
    """A ring of ``shards`` z-shards, every one on cuda:0."""
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    return M.ZShardingPolicy3(M.make_mesh_z(["cuda:0"] * shards), threshold_planes=threshold)


def phase_h1(K3, torch, cmp, sizes=((65, (6, 10, 6)), (129, (8, 16, 10))), rings=(2, 3, 4, 8)):
    """H1: the 3-D shard modes (kernel 10 in every mode, its emit_residual
    mode, kernels 11-13) against their twins, bit for bit, and their owned
    planes against the unsharded kernels', at 65³ and 129³ with tiles forced
    small (several tiles per dimension, several z blocks per shard), on
    rings of 2, 3, 4 and 8 z-shards (ragged last shards), from_zero at the
    cut planes; each per-sweep error against the error of the one-sweep
    sharded steps, bit for bit."""
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8765)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 6.0 / 7.0
    G = S.gather

    def twin(fn, *args, **kw):
        with sharded3_twins_in_place(K3):
            return fn(*args, **kw)

    def same(what, got, want):
        require(bool(torch.equal(got, want)), f"{what}: owned planes differ from the unsharded "
                f"kernel (max|Δ| {float((got - want).abs().max()):.3e})")

    def sweeps(u, f, h, steps, fz):
        """The unsharded kernel's passes of at most 8 sweeps."""
        first = True
        while steps > 0:
            k = min(steps, K3.MAX_FUSED_SWEEPS_3D)
            u = K3.fused_jacobi3(u, f, h, k, omega, fz and first)
            steps -= k
            first = False
        return u

    saved = K3.FORCE_TILE3
    try:
        for n, tile in sizes:
            K3.FORCE_TILE3 = tile
            h = 1.0 / (n - 1)
            u, f = rand(n, n, n), rand(n, n, n)
            m = (n + 1) // 2
            uc = rand(m, m, m)
            for p in rings:
                pol = z_policy(p)
                nl = pol.planes_per_device(n)
                lay = S.layout_of(pol, n)
                us, fs = S.shard(u, lay), S.shard(f, lay)
                what = f"n={n} {p} z-shards {lay.rows}"
                for steps in (1, 3, 8, 11):
                    for fz in (False, True):
                        w = f"{what} steps={steps} fz={fz}"
                        got = G(KS3.sharded_fused_jacobi3(us, fs, h, steps, omega, fz, nl))
                        cmp.grid("jacobi3_shard", w, got, G(twin(
                            KS3.sharded_fused_jacobi3, us, fs, h, steps, omega, fz, nl)))
                        cmp.cases["jacobi3_shard"] += 1
                        same(f"jacobi3_shard {w}", got, sweeps(u, f, h, steps, fz))
                for compat in ("clean", "gpu"):
                    for steps, fz in ((1, False), (3, False), (3, True), (8, False)):
                        w = f"{what} steps={steps} fz={fz} err={compat}"
                        gu, ge = KS3.sharded_fused_jacobi3_err(us, fs, h, steps, omega, compat,
                                                               fz, nl)
                        wu, we = twin(KS3.sharded_fused_jacobi3_err, us, fs, h, steps, omega,
                                      compat, fz, nl)
                        cmp.grid("jacobi3_shard", w, G(gu), G(wu))
                        cmp.scalar("jacobi3_shard", w, ge, we)
                        cmp.cases["jacobi3_shard"] += 1
                        same(f"jacobi3_shard {w}", G(gu), sweeps(u, f, h, steps, fz))
                        if not (compat == "clean" and steps - fz > 7):
                            ke = K3.fused_jacobi3_err(u, f, h, steps, omega, compat, fz)[1]
                            cmp.scalar("jacobi3_shard", f"{w} against the unsharded kernel", ge,
                                       ke)
                    cap = K3.errs3_sweep_cap(compat)
                    gu, ge = KS3.sharded_fused_jacobi3_errs(us, fs, h, cap, omega, compat, nl)
                    wu, we = twin(KS3.sharded_fused_jacobi3_errs, us, fs, h, cap, omega, compat,
                                  nl)
                    w = f"{what} per-sweep err={compat}"
                    cmp.grid("jacobi3_errs_shard", w, G(gu), G(wu))
                    ku, ke = K3.fused_jacobi3_errs(u, f, h, cap, omega, compat)
                    for s in range(cap):
                        cmp.scalar("jacobi3_errs_shard", f"{w} iterate {s + 1}", ge[s], we[s])
                        cmp.scalar("jacobi3_errs_shard", f"{w} iterate {s + 1} against the "
                                   f"unsharded kernel", ge[s], ke[s])
                    cmp.cases["jacobi3_errs_shard"] += 1
                    same(f"jacobi3_errs_shard {w}", G(gu), ku)
                    v = us
                    for s in range(1, cap + 1):
                        v, e = KS3.sharded_trigger_step3(v, fs, h, omega, compat, nl)
                        require(bool(torch.equal(ge[s - 1], e)),
                                f"jacobi3_errs_shard {w}: errs[{s - 1}] differs from the error "
                                f"of the {s}th one-sweep sharded step")
                for steps, fz, negate in ((3, False, True), (3, True, True), (1, True, False),
                                          (7, False, False)):
                    w = f"{what} emit_residual steps={steps} fz={fz} negate={negate}"
                    gu, gr = KS3.sharded_smooth_residual3(us, fs, h, steps, omega, fz, negate, nl)
                    wu, wr = twin(KS3.sharded_smooth_residual3, us, fs, h, steps, omega, fz,
                                  negate, nl)
                    cmp.grid("jacobi3_residual", w + " u", G(gu), G(wu))
                    cmp.grid("jacobi3_residual", w + " r", G(gr), G(wr))
                    cmp.cases["jacobi3_residual"] += 1
                    ku, kr = K3.fused_jacobi3_residual(u, f, h, steps, omega, fz, negate)
                    same(f"jacobi3_residual {w} u", G(gu), ku)
                    same(f"jacobi3_residual {w} r", G(gr), kr)
                    same(f"jacobi3_residual {w}: the whole-grid mode against the pair", kr,
                         K3.residual3(sweeps(u, f, h, steps, fz), f, h, negate))
                for negate in (False, True):
                    w = f"{what} negate={negate}"
                    got = G(KS3.sharded_residual3(us, fs, h, negate))
                    cmp.grid("residual3_shard", w, got, G(twin(KS3.sharded_residual3, us, fs, h,
                                                               negate)))
                    cmp.cases["residual3_shard"] += 1
                    same(f"residual3_shard {w}", got, K3.residual3(u, f, h, negate))
                for restriction in ("full_weighting", "sampling"):
                    for fz in (False, True):
                        for steps in (1, 3, 6):
                            w = f"{what} steps={steps} fz={fz} {restriction}"
                            args = (h, steps, omega, fz, restriction, True, nl)
                            gu, gfc, ge = KS3.sharded_fused_descend3(us, fs, *args)
                            wu, wfc, we = twin(KS3.sharded_fused_descend3, us, fs, *args)
                            cmp.grid("descend3_shard", w + " u", G(gu), G(wu))
                            cmp.grid("descend3_shard", w + " f_coarse", G(gfc), G(wfc))
                            cmp.scalar("descend3_shard", w, ge, we)
                            cmp.cases["descend3_shard"] += 1
                            ku, kfc, ke = K3.fused_descend3(u, f, h, steps, omega, fz,
                                                            restriction, True)
                            same(f"descend3_shard {w}", G(gu), ku)
                            same(f"descend3_shard {w} f_coarse", G(gfc), kfc)
                            cmp.scalar("descend3_shard", f"{w} against the unsharded kernel",
                                       ge, ke)
                child = S.as_level(uc, pol, m)
                for steps, want_err in ((1, False), (3, False), (3, True), (7, True), (8, False)):
                    ext_z, ext_c = KS3.ascend3_halo(steps, want_err)
                    if ext_z > nl or ext_c + 1 > nl // 2:
                        continue
                    w = f"{what} steps={steps} err={want_err}"
                    gu, ge = KS3.sharded_fused_ascend3(us, fs, child, h, steps, omega, want_err,
                                                       nl)
                    wu, we = twin(KS3.sharded_fused_ascend3, us, fs, child, h, steps, omega,
                                  want_err, nl)
                    cmp.grid("ascend3_shard", w, G(gu), G(wu))
                    ku, ke = K3.fused_ascend3(u, f, uc, h, steps, omega, want_err)
                    if want_err:
                        cmp.scalar("ascend3_shard", w, ge, we)
                        cmp.scalar("ascend3_shard", f"{w} against the unsharded kernel", ge, ke)
                    cmp.cases["ascend3_shard"] += 1
                    same(f"ascend3_shard {w}", G(gu), ku)
            del u, f, uc
            torch.cuda.synchronize()
    finally:
        K3.FORCE_TILE3 = saved


H_V_CYCLE = "v_cycle3 513³ V(3,3)"
H_COMPILED = {"clean": "compile_program3 513³ V(3,3) compat=True",
              "gpu": "compile_program3 513³ V(3,3) compat=gpu"}


def phase_h2(tmg, K, K3, torch, run_counts, unsharded, n=513):
    """H2: 513³ on 8 z-shards of cuda:0 (threshold 8): v_cycle3_sharded V(3,3)
    and compile_program3(policy=...) V(3,3) with the clean and gpu metrics,
    on the kernels, through the twins and on the plain path, one cold and
    three warm cycles each, against phase D's unsharded runs (``unsharded``:
    its iterates after 1 and 4 cycles); launch counts per route; ms/cycle and
    a profile."""
    from multigrid_poisson_solver_tpu_torch.models import poisson3d as p3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    h = 1.0 / (n - 1)
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cuda")
    f = prob.source_grid(n, torch.float32, "cuda") + u0
    pol = z_policy(8)
    mesh = pol.mesh
    fs = S.as_level(f, pol, n)
    times = {}

    def run(tag, step, key):
        """One cold cycle and three warm ones through step(kind, u, warm) on
        the kernels, the twins and the plain path."""
        res = {}
        for kind in ("kernels", "twins", "plain"):
            with contextlib.ExitStack() as stack:
                if kind == "twins":
                    stack.enter_context(twins3_in_place(K3))
                    stack.enter_context(sharded3_twins_in_place(K3))
                K.reset_launch_counts()
                u1 = step(kind, u0, False)
                u = u1
                for _ in range(3):
                    u = step(kind, u, True)
                torch.cuda.synchronize()
                counts = dict(K.launches)
                g1, g4 = S.gather(u1), S.gather(u)
                require(tuple(g4.shape) == (n, n, n) and bool(torch.isfinite(g4).all()),
                        f"[H2] {tag} {kind}: non-finite or misshapen iterate")
                ms = time_ms(lambda: step(kind, u, True), reps=1 if kind == "plain" else 3,
                             rounds=3)
            res[kind] = (g1, g4, counts, ms)
            times[f"{tag} {kind}"] = ms
            say(f"[H2] {tag} on 8 z-shards {kind}: {ms:.3f} ms/cycle (unsharded kernels "
                f"{unsharded[tag]['auto']['ms']:.3f}); launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if kind == "kernels":
                run_counts[key] = counts
                profile(f"{tag} on 8 z-shards per cycle",
                        lambda: [step(kind, u, True) for _ in range(3)], per=3)
        ref = unsharded[tag]
        for i, what in ((0, "1 cycle"), (1, "4 cycles")):
            got, want = res["kernels"][i], ref["auto"]["u"][i]
            require(bool(torch.equal(got, want)), f"[H2] {tag}: the sharded kernel iterate after "
                    f"{what} differs from phase D's unsharded one (max|Δ| "
                    f"{float((got - want).abs().max()):.3e})")
            for kind, base in (("twins", ref["auto"]["u"][i]), ("plain", ref["torch"]["u"][i])):
                g = res[kind][i]
                diff, scale = float((g - base).abs().max()), float(base.abs().max())
                say(f"[H2] {tag} {kind} after {what}: max|Δu| {diff:.3e} against phase D's "
                    f"{'kernel' if kind == 'twins' else 'plain'} run (bit-identical: "
                    f"{bool(torch.equal(g, base))})")
                require(diff <= U_RTOL * scale, f"[H2] {tag} {kind}: outside the phase D gate "
                        f"after {what}")
            rk = rel_res3(p3, res["kernels"][i], f, h)
            rt = rel_res3(p3, res["plain"][i], f, h)
            require(abs(rk - rt) <= RES_RTOL * rt, f"[H2] {tag}: float64 residuals {rk:.6e} "
                    f"(kernels) vs {rt:.6e} (plain) after {what}")
        say(f"[H2] {tag}: sharded kernel iterates bit-identical to phase D's unsharded run after "
            f"1 and 4 cycles")
        require(not any(res["plain"][2].values()), f"[H2] {tag}: the plain path launched a kernel")
        return res

    def vstep(kind, u, warm):
        return tmg.v_cycle3_sharded(u, fs, h, mesh, n_min=5, pre=3, post=3, omega=0.857,
                                    kernels="torch" if kind == "plain" else "auto")

    run(H_V_CYCLE, vstep, "h_v_cycle3")
    # trouble spot 1's routes: JAX's depths 528, 264, 136, 72 (nl 66, 33, 17,
    # 9): the legs per shard at 513³, emit_residual and prolong-add + the
    # shard smoother at 257³, 129³ and 65³; per cycle and shard
    c = run_counts["h_v_cycle3"]
    want = {"descend3_shard": 1, "ascend3_shard": 1, "jacobi3_residual": 3, "jacobi3_shard": 3}
    require(all(c[k] == 4 * 8 * v for k, v in want.items()) and not c["descend3"],
            f"[H2] v_cycle3_sharded took other routes than JAX's: {c}")
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    for compat, key in (("clean", "h_compiled3"), ("gpu", "h_compiled3_gpu")):
        cfgs = {kind: tmg.SolverConfig(omega=6.0 / 7.0, compat_error=True if compat == "clean"
                                       else "gpu", collect_node_stats=False,
                                       kernels="torch" if kind == "plain" else "auto")
                for kind in ("kernels", "plain")}
        ccs = {kind: tmg.compile_program3(program, prob, cfgs[kind], device="cuda", policy=pol)
               for kind in cfgs}
        ccs["twins"] = ccs["kernels"]
        res = run(H_COMPILED[compat], lambda kind, u, warm: ccs[kind](u, fs, warm=warm)[0], key)
        # the error of the last node against the unsharded engine's, on the
        # same iterate
        cc1 = tmg.compile_program3(program, prob, cfgs["kernels"], device="cuda", warm=True)
        _, e1 = cc1(res["kernels"][1], f)
        _, es = ccs["kernels"](res["kernels"][1], fs, warm=True)
        say(f"[H2] {H_COMPILED[compat]}: last error sharded {float(es):.9e}, unsharded "
            f"{float(e1):.9e}")
        require(abs(float(es) - float(e1)) <= 1e-6 * abs(float(e1)),
                f"[H2] {H_COMPILED[compat]}: errors differ beyond 1e-6 relative")
    c, g = run_counts["h_compiled3"], run_counts["h_compiled3_gpu"]
    # the policy's depths are all even (528, 272, 144, 80): the legs per shard
    # at every sharded level with the clean metric; smoother passes and the
    # sharded residual with the gpu metric
    require(c["descend3_shard"] == c["ascend3_shard"] == 4 * 4 * 8 and not c["descend3"]
            and g["jacobi3_shard"] == 4 * 8 * 8 and g["residual3_shard"] == 4 * 4 * 8
            and not g["descend3_shard"], f"[H2] compile_program3 under the policy took other "
            f"routes than JAX's: clean {c}, gpu {g}")
    return times


def phase_h3(tmg, K, K3, torch, run_counts, unsharded_levels, n=513):
    """H3: the 513³ trigger V-cycle (ω 6/7, clean, trigger 0.01) on 8
    z-shards of cuda:0 with trigger_batch "auto", 1 and 7, on the kernels and
    (batch 7) the twins; stop sweeps per level against phase E's unsharded
    runs (``unsharded_levels``: batch tag → levels). Returns the wall ms and
    the (iterate, stop sweeps) of each run."""
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    prob = tmg.REFERENCE_PROBLEM_3D
    pol = z_policy(8)
    cap = 2000
    out = {}

    def run(tag, batch, twins=False):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=False, collect_node_stats=False,
                               trigger_batch=batch, max_trigger_sweeps=cap)
        cc = tmg.compile_program3(program, prob, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twins:
                stack.enter_context(twins3_in_place(K3))
                stack.enter_context(sharded3_twins_in_place(K3))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[H3] sharded 3-D trigger V-cycle {tag}: non-finite result")
        say(f"[H3] trigger V-cycle {n}³ on 8 z-shards {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, ms, counts)
        if tag == "kernels, auto":
            cc.trigger_sweeps = None
            profile(f"sharded trigger V-cycle {n}³ {tag}", lambda: cc(u0, f))
        return tag

    auto = run("kernels, auto", "auto")
    b1 = run("kernels, batch 1", 1)
    b7 = run("kernels, batch 7", 7)
    tb7 = run("twins, batch 7", 7, twins=True)
    run_counts["h_trigger3_b7"] = out[b7][3]
    for tag, phase_e in ((auto, "auto"), (b1, "batch 1")):
        want = unsharded_levels[phase_e]
        require(out[tag][1] == want, f"[H3] stop sweeps {out[tag][1]} ({tag}) vs phase E's "
                f"unsharded {phase_e} run {want}")
    require(out[b7][1] == out[tb7][1], f"[H3] batch 7: stop sweeps {out[b7][1]} on the kernels "
            f"vs {out[tb7][1]} through the twins")
    diff = float((out[b7][0] - out[tb7][0]).abs().max())
    require(diff <= U_RTOL * float(out[tb7][0].abs().max()), "[H3] batch 7: kernel and twin "
            "iterates differ")
    # JAX's sharded explicit batch runs one exact sweep, then passes of 7 from
    # its error (its unsharded one starts batched): the first node stops 1 +
    # 7j sweeps in, within the 7 sweeps after the exact stop
    (m, k), (_, k1) = out[b7][1][0], unsharded_levels["batch 1"][0]
    require(m == n and k % 7 == 1 and k1 <= k < k1 + 7,
            f"[H3] batch 7 at {m}³: {k} sweeps against {k1} exact")
    require(out[b7][3]["jacobi3_errs_shard"] > 0 and out[auto][3]["jacobi3_shard"] > 0,
            "[H3] the sharded trigger loops did not launch the shard modes")
    say(f"[H3] stop sweeps per level equal phase E's unsharded auto and batch-1 runs; batch 7 "
        f"kernels = twins, first node {k} sweeps (exact {k1})")
    return {tag: v[2] for tag, v in out.items()}, {tag: v[:2] for tag, v in out.items()}


@contextlib.contextmanager
def ring3_twins_in_place(R3):
    """The whole-loop ring kernel 19 replaced by its twin, the loop of
    one-sweep sharded error passes (parallel.kernel_shard3 looks it up at
    each call)."""
    saved = R3.rdma_trigger3
    R3.rdma_trigger3 = R3.rdma_trigger3_torch
    try:
        yield
    finally:
        R3.rdma_trigger3 = saved


def phase_i1(K3, torch, cmp, sizes=((65, (6, 10, 6), (2, 3, 4, 8, 16)),
                                    (129, (8, 16, 10), (2, 3, 4, 8)))):
    """I1: the 3-D ring kernels 19-22 against their twins (the exchange path
    on the shard-mode twins) and against the PR 6 shard-mode path on the
    card (parallel.kernel_shard3's exchange and kernels 10-12 per shard), at
    65³ and 129³ with tiles forced small (several tiles and z chunks cross
    each cut), on rings of 2, 3, 4, 8 and (65³) 16 z-shards of cuda:0
    (ragged last shards; on 16 shards of 4 planes a window of up to 8 planes
    spans two neighbours' blocks). Owned planes, coarse slabs and errors bit
    for bit against the shard-mode path; against the twins the iterates bit
    for bit and the errors within ERR_RTOL; kernel 19's stop sweep against
    the loop of one-sweep sharded error launches, with a trigger that stops
    it after at least 50 sweeps."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
    from multigrid_poisson_solver_tpu_torch.parallel import halo3
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9876)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega, G = 6.0 / 7.0, S.gather
    nl = 16   # the shard-mode path's planes per device: one pass, every halo fits

    def same(what, got, want):
        require(bool(torch.equal(got, want)), f"{what}: differs from the shard-mode path "
                f"(max|Δ| {float((got - want).abs().max()):.3e})")

    def errs(name, what, got_raws, twin_raws, want, compat, n, h):
        got = halo3.sum_err3(got_raws, compat, n, h, torch.float32)
        same(f"{name} {what} error", got, want)
        cmp.scalar(name, what, got, halo3.sum_err3(twin_raws, compat, n, h, torch.float32))

    saved = K3.FORCE_TILE3
    try:
        for n, tile, rings in sizes:
            K3.FORCE_TILE3 = tile
            h, m = 1.0 / (n - 1), (n + 1) // 2
            u, f, uc = rand(n, n, n), rand(n, n, n), rand(m, m, m)
            for p in rings:
                lay = S.z_layout(n, ["cuda:0"] * p)
                us, fs = S.shard(u, lay), S.shard(f, lay)
                what = f"n={n} {p} z-shards {lay.rows}"
                for steps in (1, 3, 7, 8):
                    for fz in (False, True):
                        for mode in (None, "clean", "gpu"):
                            if mode == "clean" and steps - fz > 7:
                                continue
                            w = f"{what} steps={steps} fz={fz} err={mode}"
                            gu, graw = R3.rdma_jacobi3(us, fs, h, steps, omega, fz, mode)
                            tu, traw = R3.rdma_jacobi3_torch(us, fs, h, steps, omega, fz, mode)
                            cmp.grid("rdma_jacobi3", w, G(gu), G(tu))
                            if mode is None:
                                ref = KS3.sharded_fused_jacobi3(us, fs, h, steps, omega, fz, nl)
                            else:
                                ref, rerr = KS3.sharded_fused_jacobi3_err(us, fs, h, steps, omega,
                                                                          mode, fz, nl)
                                errs("rdma_jacobi3", w, graw, traw, rerr, mode, n, h)
                            same(f"rdma_jacobi3 {w}", G(gu), G(ref))
                            cmp.cases["rdma_jacobi3"] += 1
                for restriction in ("full_weighting", "sampling"):
                    for fz in (False, True):
                        for steps in (1, 3, 6):
                            w = f"{what} steps={steps} fz={fz} {restriction}"
                            args = (h, steps, omega, fz, restriction, True)
                            gu, gfc, graw = R3.rdma_descend3(us, fs, *args)
                            tu, tfc, traw = R3.rdma_descend3_torch(us, fs, *args)
                            ru, rfc, rerr = KS3.sharded_fused_descend3(us, fs, *args, nl)
                            cmp.grid("rdma_descend3", w + " u", G(gu), G(tu))
                            cmp.grid("rdma_descend3", w + " f_coarse", G(gfc), G(tfc))
                            same(f"rdma_descend3 {w} u", G(gu), G(ru))
                            same(f"rdma_descend3 {w} f_coarse", G(gfc), G(rfc))
                            errs("rdma_descend3", w, graw, traw, rerr, "clean", n, h)
                            cmp.cases["rdma_descend3"] += 1
                children = {"tensor": uc, "coarse blocks": S.shard(uc, R3.coarse_layout3(fs)),
                            "m split": S.shard(uc, S.z_layout(m, ["cuda:0"] * p))}
                for steps, want_err in ((1, False), (3, False), (3, True), (7, True), (8, False)):
                    for cname, child in children.items():
                        w = f"{what} steps={steps} err={want_err} child={cname}"
                        gu, graw = R3.rdma_ascend3(us, fs, child, h, steps, omega, want_err)
                        tu, traw = R3.rdma_ascend3_torch(us, fs, child, h, steps, omega, want_err)
                        ru, rerr = KS3.sharded_fused_ascend3(us, fs, child, h, steps, omega,
                                                             want_err, nl)
                        cmp.grid("rdma_ascend3", w, G(gu), G(tu))
                        same(f"rdma_ascend3 {w}", G(gu), G(ru))
                        if want_err:
                            errs("rdma_ascend3", w, graw, traw, rerr, "clean", n, h)
                        cmp.cases["rdma_ascend3"] += 1
                for compat in ("clean", "gpu"):
                    # a trigger at the 55th sweep's slope of the one-sweep loop
                    v, prev, slopes = us, None, []
                    for _ in range(55):
                        v, e = KS3.sharded_trigger_step3(v, fs, h, omega, compat, nl)
                        if prev is not None:
                            slopes.append(float(torch.abs(e - prev)))
                        prev = e
                    trig = slopes[-1]
                    w = f"{what} {compat} trigger {trig:.6e}"
                    ru, rerr, rk = trigger_loop(
                        lambda x: KS3.sharded_trigger_step3(x, fs, h, omega, compat, nl), us, trig,
                        200)
                    gu, gerr, gk = R3.rdma_trigger3(us, fs, h, omega, compat, trig, 200)
                    tu, terr, tk = R3.rdma_trigger3_torch(us, fs, h, omega, compat, trig, 200)
                    require(rk >= 50 and int(gk) == rk == int(tk),
                            f"rdma_trigger3 {w}: {int(gk)} sweeps, the one-sweep loop {rk}, the "
                            f"twin {int(tk)} (at least 50 wanted)")
                    same(f"rdma_trigger3 {w}", G(gu), G(ru))
                    same(f"rdma_trigger3 {w} error", gerr, rerr)
                    cmp.grid("rdma_trigger3", w, G(gu), G(tu))
                    cmp.scalar("rdma_trigger3", w, gerr, terr)
                    cmp.cases["rdma_trigger3"] += 1
                del us, fs, children
            del u, f, uc
            torch.cuda.synchronize()
    finally:
        K3.FORCE_TILE3 = saved


I_COUNTS = ("rdma_jacobi3", "rdma_descend3", "rdma_ascend3", "rdma_trigger3", "jacobi3_shard",
            "descend3_shard", "ascend3_shard", "jacobi3_residual", "residual3_shard",
            "jacobi3_errs_shard")


def phase_i2(tmg, K, torch, run_counts, unsharded, n=513):
    """I2: phase H2's programs with halo="rdma" (513³ on 8 z-shards of cuda:0,
    threshold 8): v_cycle3_sharded V(3,3) and compile_program3(policy=...)
    V(3,3) with the clean and gpu metrics, one cold and three warm cycles,
    the iterates after 1 and 4 cycles bit for bit against phase D's
    unsharded runs (``unsharded``), which H2 holds the ppermute runs to
    bit for bit; ring launches per cycle by kernel, ms/cycle and a profile."""
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    h = 1.0 / (n - 1)
    prob = tmg.REFERENCE_PROBLEM_3D
    u0 = prob.boundary_grid(n, torch.float32, "cuda")
    f = prob.source_grid(n, torch.float32, "cuda") + u0
    pol = z_policy(8)
    fs = S.as_level(f, pol, n)
    times, cycles = {}, 4

    def run(tag, step, key):
        K.reset_launch_counts()
        u1 = step(u0, False)
        u = u1
        for _ in range(cycles - 1):
            u = step(u, True)
        torch.cuda.synchronize()
        counts = dict(K.launches)
        run_counts[key] = counts
        for i, (got, what) in enumerate(((S.gather(u1), "1 cycle"), (S.gather(u), "4 cycles"))):
            want = unsharded[tag]["auto"]["u"][i]
            require(bool(torch.equal(got, want)), f"[I2] {tag} rdma: the iterate after {what} "
                    f"differs from phase D's unsharded one, which H2's ppermute run equals "
                    f"(max|Δ| {float((got - want).abs().max()):.3e})")
        ms = time_ms(lambda: step(u, True), reps=3, rounds=3)
        times[tag] = ms
        per = {k: counts[k] / cycles for k in I_COUNTS if counts[k]}
        say(f"[I2] {tag} on 8 z-shards, halo rdma: {ms:.3f} ms/cycle; bit-identical to phase D "
            f"(and so to H2's ppermute run) after 1 and 4 cycles; launches per cycle {per}")
        profile(f"{tag} on 8 z-shards, halo rdma, per cycle",
                lambda: [step(u, True) for _ in range(3)], per=3)
        return counts

    c = run(H_V_CYCLE, lambda u, warm: tmg.v_cycle3_sharded(
        u, fs, h, pol.mesh, n_min=5, pre=3, post=3, omega=0.857, halo="rdma"), "i_v_cycle3")
    # JAX's depths 528, 264, 136, 72 (nl 66, 33, 17, 9): the ring legs at
    # 513³; emit_residual, prolong-add and the ring smoother at 257³-65³
    want = {"rdma_descend3": 1, "rdma_ascend3": 1, "rdma_jacobi3": 3, "jacobi3_residual": 24,
            "descend3_shard": 0, "ascend3_shard": 0, "jacobi3_shard": 0}
    require(all(c[k] == cycles * v for k, v in want.items()),
            f"[I2] v_cycle3_sharded halo rdma took other routes than JAX's: {c}")
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    for compat, key in (("clean", "i_compiled3"), ("gpu", "i_compiled3_gpu")):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=True if compat == "clean" else "gpu",
                               collect_node_stats=False, halo="rdma")
        cc = tmg.compile_program3(program, prob, cfg, device="cuda", policy=pol)
        run(H_COMPILED[compat], lambda u, warm: cc(u, fs, warm=warm)[0], key)
    c, g = run_counts["i_compiled3"], run_counts["i_compiled3_gpu"]
    # depths ×16 (nl 66, 34, 18, 10): the ring legs at every sharded level
    # (clean); ring smoother passes and the sharded residual (gpu)
    require(c["rdma_descend3"] == c["rdma_ascend3"] == cycles * 4 and not c["descend3_shard"]
            and not c["ascend3_shard"] and g["rdma_jacobi3"] == cycles * 8
            and not g["jacobi3_shard"] and g["residual3_shard"] == cycles * 4 * 8,
            f"[I2] compile_program3 halo rdma took other routes than JAX's: clean {c}, gpu {g}")
    return times


def phase_i3(tmg, K, torch, run_counts, h3_runs, n=513):
    """I3: phase H3's trigger V-cycle with halo="rdma" ("auto", batch 1,
    batch 7): kernel 19 runs every trigger node at 257³-65³ (where JAX's
    rdma_trigger3_fits admits the shard), before any batching, and none at
    513³ (which it refuses). "auto" and batch 1 stop where H3's runs stop
    and give its iterates bit for bit; batch 7's 513³ nodes stop where H3's
    batch 7 does, and its ring levels where the exact loop does on the same
    inputs (kernel 19 replaced by its twin)."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3

    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    prob = tmg.REFERENCE_PROBLEM_3D
    pol = z_policy(8)
    out = {}

    def run(tag, batch, twin=False):
        cfg = tmg.SolverConfig(omega=6.0 / 7.0, compat_error=False, collect_node_stats=False,
                               trigger_batch=batch, max_trigger_sweeps=2000, halo="rdma")
        cc = tmg.compile_program3(program, prob, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twin:
                stack.enter_context(ring3_twins_in_place(R3))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[I3] {tag}: non-finite result")
        ring_nodes = sum(1 for m, _ in cc.trigger_sweeps if m < n and pol.is_sharded(m))
        require(counts["rdma_trigger3"] == (0 if twin else ring_nodes),
                f"[I3] {tag}: {counts['rdma_trigger3']} ring trigger launches for {ring_nodes} "
                f"trigger nodes on sharded levels below {n}³")
        say(f"[I3] trigger V-cycle {n}³ on 8 z-shards, halo rdma, {tag}: {ms:.1f} ms, sweeps per "
            f"level {cc.trigger_sweeps}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, ms, counts)
        if tag == "auto":
            cc.trigger_sweeps = None
            profile(f"sharded trigger V-cycle {n}³ halo rdma {tag}", lambda: cc(u0, f))

    twin7 = "batch 7, kernel 19's twin"
    for tag, batch in (("auto", "auto"), ("batch 1", 1), ("batch 7", 7)):
        run(tag, batch)
    run(twin7, 7, twin=True)
    run_counts["i_trigger3_auto"] = out["auto"][3]
    for tag in ("auto", "batch 1"):
        g, sweeps = h3_runs[f"kernels, {tag}"]
        require(out[tag][1] == sweeps and bool(torch.equal(out[tag][0], g)),
                f"[I3] {tag}: stop sweeps {out[tag][1]} against H3's {sweeps}, or iterates differ")
    top = [s for s in out["batch 7"][1] if s[0] == n]
    require(top == [s for s in h3_runs["kernels, batch 7"][1] if s[0] == n]
            and out["batch 7"][1] == out[twin7][1],
            f"[I3] batch 7: {out['batch 7'][1]} against H3's {n}³ nodes and the exact loop's "
            f"{out[twin7][1]}")
    say(f"[I3] stop sweeps per level: auto and batch 1 equal H3's (phase E's) and their iterates "
        f"bit for bit; batch 7 at {n}³ as H3's batch 7, below it the exact loop's")
    return {tag: v[2] for tag, v in out.items()}


def phase_g1(K, torch, cmp):
    """G1: the shard modes of kernels 1-4 and kernels 17 and 18 against their
    twins at 1025² and 1031² (several 32 x 128 tiles per shard; ragged last
    shards and tiles), on rings of 2, 3, 4 and 8 shards and a 2 x 4 block
    mesh; every shard mode's owned cells against the unsharded kernel, bit
    for bit; the ring trigger against the loop of one-sweep sharded error
    launches, bit for bit."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5678)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32)

    omega = 0.8
    G = S.gather

    def twin(fn, *args, **kw):
        """fn on the shard-mode twins (the wrappers look the kernels up at
        each call)."""
        with sharded_twins_in_place(K, rdma):
            return fn(*args, **kw)

    def same(what, got, want):
        require(bool(torch.equal(got, want)), f"{what}: owned cells differ from the unsharded "
                f"kernel (max|Δ| {float((got - want).abs().max()):.3e})")

    stops = {}
    for n in (1025, 1031):
        h = 1.0 / (n - 1)
        u, f = rand(n, n), rand(n, n)
        m = (n + 1) // 2
        uc = rand(m, m)
        for tag, pol in ring_policies().items():
            lay = S.layout_of(pol, n)
            us, fs = S.shard(u, lay), S.shard(f, lay)
            ring = len(lay.cols) == 1
            what = f"n={n} {tag}"
            for steps in ((1, 2, 3, 4, 5, 6, 7, 8, 11) if n == 1025 else (1, 5, 8, 11)):
                for fz in (False, True):
                    w = f"{what} steps={steps} fz={fz}"
                    got = G(KS.sharded_fused_jacobi(us, fs, h, steps, omega, fz))
                    cmp.grid("jacobi_shard", w, got,
                             G(twin(KS.sharded_fused_jacobi, us, fs, h, steps, omega, fz)))
                    cmp.cases["jacobi_shard"] += 1
                    same(f"jacobi_shard {w}", got, K.fused_jacobi(u, f, h, steps, omega, fz))
                    if ring:
                        ring_u = G(KS.rdma_fused_jacobi(us, fs, h, steps, omega, fz))
                        same(f"rdma_jacobi {w}", ring_u, got)
                        cmp.grid("rdma_jacobi", w, ring_u,
                                 G(rdma.rdma_jacobi_torch(us, fs, h, steps, omega, fz)))
                        cmp.cases["rdma_jacobi"] += 1
            for compat in (True, False, "gpu"):
                for steps in (1, 7, 11):
                    w = f"{what} steps={steps} err={compat}"
                    gu, ge = KS.sharded_fused_jacobi_err(us, fs, h, steps, omega, compat)
                    wu, we = twin(KS.sharded_fused_jacobi_err, us, fs, h, steps, omega,
                                  compat)
                    cmp.grid("jacobi_shard", w, G(gu), G(wu))
                    cmp.scalar("jacobi_shard", w, ge, we)
                    cmp.cases["jacobi_shard"] += 1
                    ku, ke = K.fused_jacobi_err(u, f, h, steps, omega, compat)
                    same(f"jacobi_shard {w}", G(gu), ku)
                    cmp.scalar("jacobi_shard", f"{w} against the unsharded kernel", ge, ke)
                cap = K.errs_sweep_cap(compat)
                gu, ge = KS.sharded_fused_jacobi_errs(us, fs, h, cap, omega, compat)
                wu, we = twin(KS.sharded_fused_jacobi_errs, us, fs, h, cap, omega, compat)
                w = f"{what} per-sweep err={compat}"
                cmp.grid("jacobi_errs_shard", w, G(gu), G(wu))
                for s in range(cap):
                    cmp.scalar("jacobi_errs_shard", f"{w} iterate {s + 1}", ge[s], we[s])
                cmp.cases["jacobi_errs_shard"] += 1
                same(f"jacobi_errs_shard {w}", G(gu), K.fused_jacobi(u, f, h, cap, omega))
                for s in (1, cap):
                    require(torch.equal(ge[s - 1], KS.sharded_fused_jacobi_err(
                        us, fs, h, s, omega, compat)[1]),
                        f"jacobi_errs_shard {w}: errs[{s - 1}] differs from the error of {s} "
                        f"sweeps")
            for steps in (1, 2, 3, 4):
                w = f"{what} rb-GS steps={steps}"
                got = G(KS.sharded_fused_jacobi(us, fs, h, steps, 1.0, smoother="rbgs"))
                cmp.grid("rbgs_shard", w, got, G(twin(
                    KS.sharded_fused_jacobi, us, fs, h, steps, 1.0, smoother="rbgs")))
                same(f"rbgs_shard {w}", got, K.fused_rbgs(u, f, h, steps))
                cmp.cases["rbgs_shard"] += 1
                for compat in ((True, False) if steps <= 3 else ()):
                    gu, ge = KS.sharded_fused_jacobi_err(us, fs, h, steps, 1.0, compat,
                                                         smoother="rbgs")
                    wu, we = twin(KS.sharded_fused_jacobi_err, us, fs, h, steps, 1.0,
                                  compat, smoother="rbgs")
                    cmp.grid("rbgs_shard", f"{w} err={compat}", G(gu), G(wu))
                    cmp.scalar("rbgs_shard", f"{w} err={compat}", ge, we)
                    cmp.cases["rbgs_shard"] += 1
            for negate in (False, True):
                got = G(KS.sharded_residual(us, fs, h, negate))
                cmp.grid("residual_shard", f"{what} negate={negate}", got,
                         G(twin(KS.sharded_residual, us, fs, h, negate)))
                same(f"residual_shard {what}", got, K.residual(u, f, h, negate))
                cmp.cases["residual_shard"] += 1
            if n % 2:
                for restriction in ("sampling", "full_weighting"):
                    for fz in (False, True):
                        for steps in (1, 3, 6):
                            w = f"{what} steps={steps} fz={fz} {restriction}"
                            args = (h, steps, omega, restriction, "cpu", fz)
                            gu, gfc, ge = KS.sharded_fused_descend(us, fs, *args)
                            wu, wfc, we = twin(KS.sharded_fused_descend, us, fs, *args)
                            cmp.grid("descend_shard", w + " u", G(gu), G(wu))
                            cmp.grid("descend_shard", w + " f_coarse", G(gfc), G(wfc))
                            cmp.scalar("descend_shard", w, ge, we)
                            cmp.cases["descend_shard"] += 1
                            ku, kfc, _ = K.fused_descend(u, f, h, steps, omega, restriction,
                                                         True, True, fz)
                            same(f"descend_shard {w}", G(gu), ku)
                            same(f"descend_shard {w} f_coarse", G(gfc), kfc)
                child = S.as_level(uc, pol, m)
                for steps, mode in ((1, None), (3, "cpu"), (7, "clean"), (8, "gpu")):
                    w = f"{what} steps={steps} err={mode}"
                    gu, ge = KS.sharded_fused_ascend(us, fs, child, h, steps, omega, mode)
                    wu, we = twin(KS.sharded_fused_ascend, us, fs, child, h, steps, omega,
                                  mode)
                    cmp.grid("ascend_shard", w, G(gu), G(wu))
                    if mode is not None:
                        cmp.scalar("ascend_shard", w, ge, we)
                    cmp.cases["ascend_shard"] += 1
                    compat = {None: True, "cpu": True, "clean": False, "gpu": "gpu"}[mode]
                    same(f"ascend_shard {w}", G(gu),
                         K.fused_ascend(u, f, uc, h, steps, omega, compat, mode is not None)[0])
            if not ring:
                continue
            v0 = S.shard(u * 0.01, lay)
            for compat in (True, False, "gpu"):
                def one(v):
                    return KS.sharded_fused_jacobi_err(v, fs, h, 1, omega, compat)

                v, prev, slope = v0, None, None
                for _ in range(20):    # a trigger that stops the loop near sweep 20
                    v, e = one(v)
                    slope, prev = (None if prev is None else abs(float(e) - prev)), float(e)
                for trig, max_sweeps in ((0.0, 1), (0.0, 2), (0.0, 37), (slope, 60)):
                    w = f"{what} err={compat} trigger={trig:.6g} max={max_sweeps}"
                    gu, ge, gk = KS.rdma_fused_trigger(v0, fs, h, trig, omega, compat,
                                                       max_sweeps)
                    ru, re_, rk = trigger_loop(one, v0, trig, max_sweeps)
                    require(int(gk) == rk and bool(torch.equal(G(gu), G(ru)))
                            and bool(torch.equal(ge, re_)),
                            f"rdma_trigger {w}: {int(gk)} sweeps vs {rk} of the one-sweep "
                            f"sharded launches, or another iterate or error")
                    if max_sweeps in (37, 60):
                        wu, we, _ = rdma.rdma_trigger_torch(v0, fs, h, omega, compat, 0.0,
                                                            int(gk))
                        cmp.grid("rdma_trigger", f"{w} ({int(gk)} sweeps)", G(gu), G(wu))
                        cmp.scalar("rdma_trigger", w, ge, we)
                    cmp.cases["rdma_trigger"] += 1
                    if max_sweeps == 60:
                        stops[f"{n} {tag} {compat}"] = int(gk)
        torch.cuda.synchronize()
    say(f"[G1] ring trigger stop sweeps at a mid-loop trigger: {stops}")
    require(all(k < 60 for k in stops.values()), "a mid-loop ring trigger ran to its cap")


def phase_g2(tmg, K, torch, run_counts):
    """G2: two V-cycles at 4097² on a ring of 8 shards on one card, through
    compile_program(policy=...) with halo="ppermute" and "rdma" and on the
    plain path, against the unsharded kernel run; and the rb-GS V(2,2)."""
    from multigrid_poisson_solver_tpu_torch.ops.transfers import relative_residual_norm
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    n = 4097
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=16)
    programs = {
        # bench_scaling.py's program: non-2:1 levels, separate sweeps
        "bench_scaling coarsen=1": (tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0,
                                                coarsen=1), {}),
        # the bench's V(3,3): fused legs per shard, the chains below
        "V(3,3) coarsen=3": (tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3),
                             {"omega": 0.8}),
        "rb-GS V(2,2) FW": (tmg.v_cycle(n, n_min=8, steps=2, coarse_option=0, coarsen=3),
                            {"smoother": "rbgs", "restriction": "full_weighting"}),
    }
    keys = {("bench_scaling coarsen=1", "ppermute"): "sharded",
            ("bench_scaling coarsen=1", "rdma"): "sharded_rdma",
            ("V(3,3) coarsen=3", "ppermute"): "sharded_legs",
            ("rb-GS V(2,2) FW", "ppermute"): "sharded_rbgs"}
    times = {}
    for name, (program, kw) in programs.items():
        runs = {}
        variants = [("unsharded", None, {}), ("ppermute", pol, {}), ("rdma", pol, {"halo": "rdma"}),
                    ("plain", pol, {"kernels": "torch"})]
        if "rb-GS" in name:   # the ring kernels smooth Jacobi only
            variants = [v for v in variants if v[0] != "rdma"]
        for tag, policy, extra in variants:
            cfg = tmg.SolverConfig(collect_node_stats=False, **kw, **extra)
            cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                                       policy=policy)
            warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                                       warm=True, policy=policy)
            u0, f = cold.init()
            K.reset_launch_counts()
            ms_cold, (u1, err) = wall_ms(lambda: cold(u0, f))
            u = u1
            for _ in range(5):
                u, err = warm(u, f)
            torch.cuda.synchronize()
            counts = dict(K.launches)
            if (name, tag) in keys:
                run_counts[keys[(name, tag)]] = counts
            g1, g6, fg = cold.unpad(u1), cold.unpad(u), S.gather(f)
            require(tuple(g6.shape) == (n, n) and bool(torch.isfinite(g6).all())
                    and bool(torch.isfinite(err)), f"[G2] {name} {tag}: non-finite output")
            h = cold.finest_spec.h
            r1 = float(relative_residual_norm(g1.double(), fg.double(), h))
            r6 = float(relative_residual_norm(g6.double(), fg.double(), h))
            ms = time_ms(lambda: warm(u, f), reps=1 if tag == "plain" else 3, rounds=3)
            runs[tag] = (g1, g6, r1, r6, counts)
            times[f"{name} {tag}"] = ms
            say(f"[G2] {n}² {name} {tag}: {ms:.3f} ms/cycle (cold cycle {ms_cold:.1f} ms wall), "
                f"float64 rel. residual {r1:.6e} after 1 cycle, {r6:.6e} after 6; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            if tag in ("ppermute", "rdma") and "rb-GS" not in name:
                profile(f"{n}² {name} {tag} per cycle",
                        lambda: [warm(u, f) for _ in range(3)], per=3)
        if "rdma" in runs:
            for i, what in ((0, "1 cycle"), (1, "6 cycles")):
                require(bool(torch.equal(runs["rdma"][i], runs["ppermute"][i])),
                        f"[G2] {name}: rdma and ppermute iterates differ after {what}")
            say(f"[G2] {name}: rdma and ppermute iterates bit-identical after 1 and 6 cycles")
        want = runs["unsharded"]
        for tag, got in runs.items():
            if tag == "unsharded":
                continue
            for i, j, what in ((0, 2, "1 cycle"), (1, 3, "6 cycles")):
                diff = float((got[i] - want[i]).abs().max())
                scale = float(want[i].abs().max())
                say(f"[G2] {name} {tag} against unsharded after {what}: max|Δu| {diff:.3e} "
                    f"(bit-identical: {bool(torch.equal(got[i], want[i]))}), residual "
                    f"{got[j]:.6e} vs {want[j]:.6e}")
                require(diff <= U_RTOL * scale and abs(got[j] - want[j]) <= RES_RTOL * want[j],
                        f"[G2] {name} {tag}: outside the phase 3 gate after {what}")
        if "plain" in runs:
            require(not any(runs["plain"][4].values()),
                    f"[G2] {name}: the plain sharded path launched a kernel")
    return times


def phase_g3(tmg, K, torch, run_counts, unsharded_levels):
    """G3: the 8193² trigger V-cycle on a ring of 8 shards (threshold 32):
    the sharded levels take the batched per-sweep passes (8193²) and the ring
    trigger kernel or the one-sweep sharded loop (4097²-257²); 129² and
    below are the single-device tiers."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    n, cap = 8193, 2000
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=32)
    out = {}

    def run(tag, batch, halo, twins=False):
        cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, trigger_batch=batch,
                               max_trigger_sweeps=cap, halo=halo)
        cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twins:
                stack.enter_context(twins_in_place(K))
                stack.enter_context(sharded_twins_in_place(K, rdma))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[G3] sharded trigger V-cycle {tag}: non-finite result")
        say(f"[G3] sharded trigger V-cycle {n}² {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, ms, counts)
        if tag == "rdma, auto":
            cc.trigger_sweeps = None
            profile(f"sharded trigger V-cycle {n}² {tag}", lambda: cc(u0, f))
        return tag

    rd = run("rdma, auto", "auto", "rdma")
    pp = run("ppermute, auto", "auto", "ppermute")
    tw = run("twins, auto", "auto", "ppermute", twins=True)
    b7 = run("rdma, batch 7", 7, "rdma")
    tb7 = run("twins, batch 7", 7, "rdma", twins=True)
    run_counts["sharded_trigger_rdma"] = out[rd][3]
    run_counts["sharded_trigger_b7"] = out[b7][3]
    for a, b in ((rd, pp), (rd, tw), (b7, tb7)):
        require(out[a][1] == out[b][1], f"[G3] stop sweeps {out[a][1]} ({a}) vs {out[b][1]} ({b})")
    require(bool(torch.equal(out[rd][0], out[pp][0])),
            "[G3] the finest iterate differs between rdma and ppermute")
    for a, b in ((rd, tw), (b7, tb7)):
        diff = float((out[a][0] - out[b][0]).abs().max())
        require(diff <= U_RTOL * float(out[b][0].abs().max()), f"[G3] {a} vs {b}: iterates differ")
    say("[G3] equal stop sweeps per level among rdma, ppermute and the twins; rdma and ppermute "
        "finest iterates bit-identical")
    require(out[rd][3]["rdma_trigger"] > 0 and out[b7][3]["jacobi_errs_shard"] > 0,
            "[G3] the ring trigger or the sharded per-sweep passes were not launched")
    # against phase B's unsharded "auto" run: the sharded error is the shards'
    # partials added in shard order, another order than the unsharded
    # kernels' one reduction, so a stop may move by a sweep at a near tie
    ours, theirs = out[rd][1], unsharded_levels
    require(len(ours) == len(theirs) and [a for a, _ in ours] == [a for a, _ in theirs],
            "[G3] the sharded and unsharded trigger V-cycles visit other levels")
    moved = [(m, k, kk) for (m, k), (_, kk) in zip(ours, theirs) if k != kk]
    say(f"[G3] stop sweeps per level, sharded rdma auto {ours}; unsharded (phase B, auto) "
        f"{theirs}; levels that differ (n, sharded, unsharded): {moved or 'none'}")
    require(all(abs(k - kk) <= 1 for _, k, kk in moved),
            "[G3] a stop sweep moved by more than one sweep against the unsharded run")
    for m, k, kk in moved:
        say(f"[G3] near tie at {m}²: the slope crosses the trigger within the rounding of the "
            f"two error sums (sharded stop {k}, unsharded {kk})")
    return {tag: v[2] for tag, v in out.items()}, ours


def phase_g3_rbgs(tmg, K, torch, run_counts):
    """G3, rb-GS: a trigger V-cycle at 4097² with rb-GS and the gpu metric on
    8 shards (threshold 32): its sharded levels (4097²-257²) smooth one
    sweep at a time through the rb-GS shard mode and add the shards' gpu
    error partials; on the kernels, through the twins and on the plain
    path."""
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M

    n, cap = 4097, 200
    program = tmg.v_cycle(n, n_min=8, steps=-1, coarse_option=0, coarsen=3)
    pol = M.ShardingPolicy(M.make_mesh(["cuda:0"] * 8), threshold_rows=32)
    out = {}
    for tag, kernels, twins in (("kernels", "auto", False), ("twins", "auto", True),
                                ("plain", "torch", False)):
        cfg = tmg.SolverConfig(smoother="rbgs", compat_error="gpu", collect_node_stats=False,
                               max_trigger_sweeps=cap, kernels=kernels)
        cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", policy=pol)
        cc.trigger_sweeps = []
        u0, f = cc.init()
        K.reset_launch_counts()
        with contextlib.ExitStack() as stack:
            if twins:
                stack.enter_context(twins_in_place(K))
                stack.enter_context(sharded_twins_in_place(K, rdma))
            ms, (u, err) = wall_ms(lambda: cc(u0, f))
        counts = dict(K.launches)
        g = cc.unpad(u)
        require(bool(torch.isfinite(g).all()) and bool(torch.isfinite(err)),
                f"[G3] rb-GS gpu trigger V-cycle {tag}: non-finite result")
        say(f"[G3] rb-GS gpu-metric trigger V-cycle {n}² {tag}: {ms:.1f} ms, sweeps per level "
            f"{cc.trigger_sweeps}, last error {float(err):.6e}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        out[tag] = (g, cc.trigger_sweeps, counts)
    run_counts["sharded_rbgs_trigger"] = out["kernels"][2]
    require(out["kernels"][2]["rbgs_shard"] > 0,
            "[G3] the rb-GS gpu trigger V-cycle did not launch the rb-GS shard mode")
    require(not any(out["plain"][2].values()), "[G3] the plain rb-GS path launched a kernel")
    want = out["twins"]
    for tag in ("kernels", "plain"):
        got = out[tag]
        require(got[1] == want[1], f"[G3] rb-GS stop sweeps {got[1]} ({tag}) vs {want[1]} (twins)")
        diff = float((got[0] - want[0]).abs().max())
        require(diff <= U_RTOL * float(want[0].abs().max()),
                f"[G3] rb-GS {tag} vs twins: iterates differ by {diff:.3e}")
        say(f"[G3] rb-GS {tag} against the twins: equal stop sweeps, max|Δu| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got[0], want[0]))})")


def main():
    import torch

    # -- phase 0: the card ----------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import multigrid_poisson_solver_tpu_torch as tmg
    from multigrid_poisson_solver_tpu_torch import cli
    from multigrid_poisson_solver_tpu_torch.ops import build
    from multigrid_poisson_solver_tpu_torch.ops import kernels as K
    from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3
    from multigrid_poisson_solver_tpu_torch.ops.transfers import relative_residual_norm

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    say(smi)
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmuls are on: the dense coarse solve must run in full fp32")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- phase 1: build -------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    say(f"[1] built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Function properties" in line or "Used" in line or "spill" in line:
                say("    " + line.strip())

    # -- phase 2: kernels against their twins ----------------------------------
    t0 = time.perf_counter()
    cmp = Compare()
    phase2(K, torch, cmp, tmg.REFERENCE_PROBLEM, tmg.GridSpec)
    phase2_3d(K3, torch, cmp)
    for k in SINGLE_DEVICE:
        say(f"[2] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
    say(f"[2] done in {time.perf_counter() - t0:.1f} s "
        f"(tolerances: grids {U_RTOL:g}·max|twin|, errors {ERR_RTOL:g} relative)")

    # -- phase 3: the library path, 4097² V(3,3) ---------------------------------
    n = 4097
    program = tmg.v_cycle(n, n_min=8, steps=3, coarse_option=0, coarsen=3)
    results, counts = {}, {}
    for kernels in ("auto", "torch"):
        cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False, kernels=kernels)
        cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda")
        warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda",
                                   warm=True)
        u0, f = cold.init()
        h = cold.finest_spec.h
        K.reset_launch_counts()
        u1, err = cold(u0, f)
        u = u1
        for _ in range(5):
            u, err = warm(u, f)
        torch.cuda.synchronize()
        counts[kernels] = dict(K.launches)
        r1 = float(relative_residual_norm(u1.double(), f.double(), h))
        r6 = float(relative_residual_norm(u.double(), f.double(), h))
        require(tuple(u.shape) == (n, n) and bool(torch.isfinite(u).all())
                and bool(torch.isfinite(err)), f"{kernels}: non-finite cycle output")
        ms = time_ms(lambda: warm(u, f), reps=5, rounds=3)
        results[kernels] = (ms, r1, r6, float(err), u1, u)
        say(f"[3] V(3,3) {n}² kernels={kernels}: {ms:.3f} ms/cycle, float64 rel. "
            f"residual {r1:.6e} after 1 cycle, {r6:.6e} after 6, last error {float(err):.6e}")
    (_, r1k, r6k, ek, u1k, u6k), (_, r1t, r6t, et, u1t, u6t) = (results["auto"],
                                                              results["torch"])
    for what, got, want in (("1 cycle", u1k, u1t), ("6 cycles", u6k, u6t)):
        diff, scale = float((got - want).abs().max()), float(want.abs().max())
        say(f"[3] iterate after {what}: max|u_kernel − u_plain| {diff:.3e} "
            f"(bit-identical: {bool(torch.equal(got, want))})")
        require(diff <= U_RTOL * scale, f"kernel and plain iterates differ after {what}: "
                f"{diff:.3e} > {U_RTOL:g}·{scale:.3e}")
    require(abs(r1k - r1t) <= RES_RTOL * r1t and abs(r6k - r6t) <= RES_RTOL * r6t,
            "kernel and plain main paths disagree on the float64 residuals")
    lib_counts = counts["auto"]
    say(f"[3] launches over the kernel path's 6 cycles: {lib_counts}")
    require(not any(counts["torch"].values()), f"the plain path launched {counts['torch']}")
    # the same cycle with the chain kernels switched off, for comparison
    cfg = tmg.SolverConfig(omega=0.8, collect_node_stats=False)
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device="cuda", warm=True)
    chain_root, K.CHAIN_MAX_ROOT = K.CHAIN_MAX_ROOT, 0
    ms_legs = time_ms(lambda: warm(u6k, f), reps=5, rounds=3)
    K.CHAIN_MAX_ROOT = chain_root
    say(f"[3] the same cycle with per-level legs instead of the chains: {ms_legs:.3f} ms/cycle")

    # -- phase 4: the CLI path ------------------------------------------------------
    run_counts = {"library": lib_counts}
    # the reference binary's printed errors (tests/test_reference_parity.py)
    for name, want in (("Vcycle.txt", "0.000876"), ("VcycleTrigger.txt", "0.000784")):
        argv = ["1", f"schedules/{name}", "--engine", "compiled", "--quiet", "--no-output"]
        proc = subprocess.run([sys.executable, "-m", "multigrid_poisson_solver_tpu_torch",
                               *argv], cwd=ROOT, capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"CLI failed:\n{proc.stdout}\n{proc.stderr}")
        match = re.search(r"Error = ([0-9.eE+-]+)", proc.stdout)
        require(match is not None, f"CLI printed no error:\n{proc.stdout}")
        cli_err = float(match.group(1))
        say(f"[4] CLI {name}: Error = {match.group(1)} ({cli_err:.6f}; reference {want})")
        require(f"{cli_err:.6f}" == want, f"CLI error on {name} differs from the reference")
        K.reset_launch_counts()
        require(cli.main(argv + ["--device", "cuda"]) == 0, f"in-process CLI on {name} failed")
        run_counts[name] = dict(K.launches)
        say(f"[4] launches over the in-process CLI run on {name}: {run_counts[name]}")
    vprog = tmg.parse_cycle_path(ROOT / "schedules" / "VcycleTrigger.txt")
    for label, fits in (("whole-loop trigger kernel", K.trigger_fits),
                        ("per-sweep trigger loop", lambda n: False)):
        saved, K.trigger_fits = K.trigger_fits, fits
        cc = tmg.compile_program(vprog, tmg.REFERENCE_PROBLEM, device="cuda")
        ui, fi = cc.init()
        ms_cli = time_ms(lambda: cc(ui, fi), reps=3, rounds=3)
        K.trigger_fits = saved
        say(f"[4] VcycleTrigger.txt compiled solve, {label}: {ms_cli:.3f} ms")

    # -- paths A, B, C ----------------------------------------------------------------
    phase_refine(tmg, K, torch, run_counts)
    phase_cli_tol(cli, K, run_counts)
    ms_trigger, trigger_levels, auto_levels = phase_trigger(tmg, K, torch, run_counts)
    ms_rbgs = phase_rbgs(tmg, K, torch, run_counts)
    ms_3d, runs_3d = phase_3d(tmg, K, torch, run_counts)
    ms_trigger3, trigger3_levels, auto3_levels, exact3_levels = phase_trigger3(
        tmg, K, K3, torch, run_counts)
    refine3_runs = phase_refine3(tmg, K, torch, run_counts, cli)

    # -- phase G: the 2-D multi-device path on a ring of shards on one card ------
    t0 = time.perf_counter()
    phase_g1(K, torch, cmp)
    for k in PHASE_G:
        say(f"[G1] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
    say(f"[G1] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_g2 = phase_g2(tmg, K, torch, run_counts)
    say(f"[G2] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_g3, g3_levels = phase_g3(tmg, K, torch, run_counts, auto_levels)
    phase_g3_rbgs(tmg, K, torch, run_counts)
    say(f"[G3] done in {time.perf_counter() - t0:.1f} s")

    # -- phase H: the 3-D multi-device path on a ring of z-shards on one card ----
    t0 = time.perf_counter()
    phase_h1(K3, torch, cmp)
    for k in PHASE_H:
        say(f"[H1] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
        require(cmp.bitwise[k], f"[H1] {k}: not bit-identical to its twin")
    say(f"[H1] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_h2 = phase_h2(tmg, K, K3, torch, run_counts, runs_3d)
    say(f"[H2] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_h3, h3_runs = phase_h3(tmg, K, K3, torch, run_counts, {"auto": auto3_levels,
                                                               "batch 1": exact3_levels})
    say(f"[H3] done in {time.perf_counter() - t0:.1f} s")

    # -- phase I: the 3-D ring kernels on a ring of z-shards on one card ---------
    t0 = time.perf_counter()
    phase_i1(K3, torch, cmp)
    for k in PHASE_I:
        say(f"[I1] {k}: {cmp.cases[k]} cases ok, max|Δ| {cmp.max_abs[k]:.3e}, "
            f"bit-identical to the twin: {cmp.bitwise[k]}")
        require(cmp.bitwise[k], f"[I1] {k}: not bit-identical to its twin")
    say(f"[I1] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ms_i2 = phase_i2(tmg, K, torch, run_counts, runs_3d)
    say(f"[I2] done in {time.perf_counter() - t0:.1f} s")
    del runs_3d
    t0 = time.perf_counter()
    ms_i3 = phase_i3(tmg, K, torch, run_counts, h3_runs)
    del h3_runs
    say(f"[I3] done in {time.perf_counter() - t0:.1f} s")
    for k, (_, _, run) in KERNELS.items():
        require(run_counts[run][k] > 0, f"the {run} run did not launch {k}")

    # -- timings at the main paths' shapes -------------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)

    def rnd(m, scale=1.0):
        return torch.randn(m, m, generator=gen, device="cuda") * scale

    u, f, uc = rnd(n), rnd(n), rnd((n + 1) // 2)
    h = 1.0 / (n - 1)
    sizes = ladder(1025)
    hc = 1.0 / 1024
    uq, fq = rnd(1025), rnd(1025)
    c_args = (sizes, hc, (3,) * 7, 0.8, "sampling", True)
    u_list, f_list = K.chain_descend(uq, fq, *c_args)
    a_args = (u_list, [fq] + f_list[:-1], rnd(9), sizes, hc, (3,) * 7, 0.8, True, False)
    ut, ft = rnd(256), rnd(256)
    t_args = (1.0 / 255, 0.8, True, 0.0, 100)
    n8 = 8193
    h8 = 1.0 / (n8 - 1)
    w0, w1, w2, f8 = rnd(n8), rnd(n8, 1e-8), rnd(n8, 1e-16), rnd(n8)
    s_sweeps = 98   # 14 passes of 7 sweeps
    s_args = (h, 0.8, True, 0.0, s_sweeps)
    g2 = 4 * n * n            # bytes of one 4097² grid
    g8 = 4 * n8 * n8
    pts, pts8 = n * n, n8 * n8
    ladder_pts = sum(s * s for s in sizes)
    calls = {  # name -> (shape, kernel call, plain call, bytes, operations)
        "jacobi": (f"{n}², 3 sweeps + cpu error",
                   lambda: K.fused_jacobi_err(u, f, h, 3, 0.8, True),
                   lambda: K.fused_jacobi_err_torch(u, f, h, 3, 0.8, True),
                   3 * g2, (3 * SWEEP_OPS + ERR_OPS) * pts),
        "residual": (f"{n}²", lambda: K.residual(u, f, h), lambda: K.residual_torch(u, f, h),
                     3 * g2, RES_OPS * pts),
        "trigger": ("256², 100 sweeps (trigger 0), cpu error",
                    lambda: K.trigger_smooth(ut, ft, *t_args),
                    lambda: K.trigger_smooth_torch(ut, ft, *t_args),
                    3 * 4 * 256 * 256, 100 * (SWEEP_OPS + ERR_OPS) * 256 * 256),
        "descend": (f"{n}², 3 sweeps, sampling, cpu error",
                    lambda: K.fused_descend(u, f, h, 3, 0.8, "sampling", True, True),
                    lambda: K.fused_descend_torch(u, f, h, 3, 0.8, "sampling", True, True),
                    3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + RES_OPS) * pts),
        "ascend": (f"{n}², 3 sweeps, cpu error",
                   lambda: K.fused_ascend(u, f, uc, h, 3, 0.8, True, True),
                   lambda: K.fused_ascend_torch(u, f, uc, h, 3, 0.8, True, True),
                   3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + 3) * pts),
        "chain_descend": ("1025² → 9², 3 sweeps, sampling, from zero",
                          lambda: K.chain_descend(uq, fq, *c_args),
                          lambda: K.chain_descend_torch(uq, fq, *c_args),
                          4 * (1025 * 1025 + 2 * ladder_pts - 1025 * 1025 - 81),
                          (3 * SWEEP_OPS + RES_OPS) * (ladder_pts - 81)),
        "chain_ascend": ("9² → 1025², 3 sweeps",
                         lambda: K.chain_ascend(*a_args), lambda: K.chain_ascend_torch(*a_args),
                         4 * (2 * (ladder_pts - 81) + 81 + 1025 * 1025),
                         (3 * SWEEP_OPS + 3) * (ladder_pts - 81)),
        "residual_mw": (f"{n8}², tw32 (3 words)",
                        lambda: K.residual_tw(w0, w1, w2, f8, h8),
                        lambda: K.residual_tw_torch(w0, w1, w2, f8, h8),
                        5 * g8, RES_MW_OPS[3] * pts8),
        "jacobi_errs": (f"{n8}², 7 sweeps, cpu error of every iterate",
                        lambda: K.fused_jacobi_errs(f8, w0, h8, 7, 0.8, True),
                        lambda: K.fused_jacobi_errs_torch(f8, w0, h8, 7, 0.8, True),
                        3 * g8, 7 * (SWEEP_OPS + ERR_OPS) * pts8),
        "trigger_stream": (f"{n}², {s_sweeps} sweeps (trigger 0), cpu error",
                           lambda: K.trigger_smooth_stream(u, f, *s_args),
                           lambda: K.trigger_smooth_torch(u, f, *s_args),
                           3 * g2, s_sweeps * (SWEEP_OPS + ERR_OPS) * pts),
        "rbgs": (f"{n}², 2 sweeps + cpu error",
                 lambda: K.fused_rbgs_err(u, f, h, 2, True),
                 lambda: K.fused_rbgs_err_torch(u, f, h, 2, True),
                 3 * g2, (2 * RBGS_OPS + RBGS_ERR_OPS) * pts),
    }
    n3, w3 = 513, 6.0 / 7.0
    h3, m3 = 1.0 / (n3 - 1), (n3 + 1) // 2
    u3 = torch.randn(n3, n3, n3, generator=gen, device="cuda")
    f3 = torch.randn(n3, n3, n3, generator=gen, device="cuda")
    c3 = torch.randn(m3, m3, m3, generator=gen, device="cuda")
    c4 = torch.randn(n3, n3, n3, generator=gen, device="cuda") * 1e-8   # the lower words
    c5 = torch.randn(n3, n3, n3, generator=gen, device="cuda") * 1e-16
    g3, pts3 = 4 * n3 ** 3, n3 ** 3
    calls.update({
        "jacobi3": (f"{n3}³, 3 sweeps + clean error",
                    lambda: K3.fused_jacobi3_err(u3, f3, h3, 3, w3, "clean"),
                    lambda: K3.fused_jacobi3_err_torch(u3, f3, h3, 3, w3, "clean"),
                    3 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS) * pts3),
        "descend3": (f"{n3}³, 3 sweeps, full weighting, clean error",
                     lambda: K3.fused_descend3(u3, f3, h3, 3, w3, want_err=True),
                     lambda: K3.fused_descend3_torch(u3, f3, h3, 3, w3, want_err=True),
                     3.125 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS + 1) * pts3 + FW3_OPS * m3 ** 3),
        "ascend3": (f"{n3}³, 3 sweeps",
                    lambda: K3.fused_ascend3(u3, f3, c3, h3, 3, w3),
                    lambda: K3.fused_ascend3_torch(u3, f3, c3, h3, 3, w3),
                    3.125 * g3, (3 * SWEEP3_OPS + PROLONG3_OPS) * pts3),
        "residual3": (f"{n3}³, negated", lambda: K3.residual3(u3, f3, h3, True),
                      lambda: K3.residual3_torch(u3, f3, h3, True), 3 * g3, RES3_OPS * pts3),
        "jacobi3_errs": (f"{n3}³, 7 sweeps, clean error of every iterate",
                         lambda: K3.fused_jacobi3_errs(u3, f3, h3, 7, w3, "clean"),
                         lambda: K3.fused_jacobi3_errs_torch(u3, f3, h3, 7, w3, "clean"),
                         3 * g3, 7 * (SWEEP3_OPS + EXTRA3_OPS) * pts3),
        "residual_mw3": (f"{n3}³, tw32 (3 words)",
                         lambda: K3.residual_tw3(u3, c4, c5, f3, h3),
                         lambda: K3.residual_tw3_torch(u3, c4, c5, f3, h3),
                         5 * g3, RES_MW3_OPS[3] * pts3),
    })
    # the whole-loop trigger kernels at their main-path sizes, a trigger of 0
    # and a fixed sweep count; a trigger loop's bound counts its sweeps'
    # operations and its grids once
    n16, n15, t_sweeps = 129, 257, 98   # 14 passes of 7 sweeps
    u16, f16 = (torch.randn(n16, n16, n16, generator=gen, device="cuda") for _ in range(2))
    u15, f15 = (torch.randn(n15, n15, n15, generator=gen, device="cuda") for _ in range(2))
    t16 = (1.0 / (n16 - 1), w3, "clean", 0.0, t_sweeps)
    t15 = (1.0 / (n15 - 1), w3, "clean", 0.0, t_sweeps)
    calls.update({
        "trigger3": (f"{n16}³, {t_sweeps} sweeps (trigger 0), clean error",
                     lambda: K3.trigger_smooth3(u16, f16, *t16),
                     lambda: K3.trigger_smooth3_torch(u16, f16, *t16),
                     3 * 4 * n16 ** 3, t_sweeps * (SWEEP3_OPS + EXTRA3_OPS) * n16 ** 3),
        "trigger3_stream": (f"{n15}³, {t_sweeps} sweeps (trigger 0), clean error",
                            lambda: K3.trigger_smooth3_stream(u15, f15, *t15),
                            lambda: K3.trigger_smooth3_torch(u15, f15, *t15),
                            3 * 4 * n15 ** 3, t_sweeps * (SWEEP3_OPS + EXTRA3_OPS) * n15 ** 3),
    })
    # the shard modes and the ring kernels at the sharded main paths' shapes:
    # a level split over a ring of 8 shards on the card; the shard modes
    # launched on every shard's window (the exchange done beforehand), the
    # ring kernels with their exchange inside
    from multigrid_poisson_solver_tpu_torch.ops import rdma
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard as KS
    from multigrid_poisson_solver_tpu_torch.parallel import kernel_shard3 as KS3
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    ring8 = ring_policies()["rows-8"]
    ch = KS.COARSE_HALO

    def ring_windows(level, a, b):
        lay = S.layout_of(ring8, level)
        xs, ys = S.shard(a, lay), S.shard(b, lay)
        ext = [(S.extend(xs, i, 0, KS.HALO, 0), S.extend(ys, i, 0, KS.HALO, 0))
               for i in range(len(lay.rows))]
        geos = [K.ShardGeo(level, r0, 0, r1 - r0, level, KS.HALO, 0) for r0, r1 in lay.rows]
        return lay, xs, ys, ext, geos

    lay2, us2, fs2, ext2, geo2 = ring_windows(n, u, f)
    _, _, _, ext8, geo8 = ring_windows(n8, f8, w0)
    cw2 = [S.window(uc, r0 // 2 - ch, (r1 + 1) // 2 + ch, -ch, (n + 1) // 2 + ch)
           for r0, r1 in lay2.rows]

    def shards(fn, ext, geos):
        return lambda: [fn(ue, fe, g) for (ue, fe), g in zip(ext, geos)]

    def both(fn, plain_fn, ext=ext2, geos=geo2):
        return shards(fn, ext, geos), shards(plain_fn, ext, geos)

    on8 = f"{n}² on 8 shards"
    calls.update({
        "jacobi_shard": (f"{on8}, 3 sweeps + cpu error",
                         *both(lambda ue, fe, g: K.fused_jacobi_shard(ue, fe, g, h, 3, 0.8, False,
                                                                      "cpu"),
                               lambda ue, fe, g: K.fused_jacobi_shard_torch(ue, fe, g, h, 3, 0.8,
                                                                            False, "cpu")),
                         3 * g2, (3 * SWEEP_OPS + ERR_OPS) * pts),
        "jacobi_errs_shard": (f"{n8}² on 8 shards, 7 sweeps, cpu error of every iterate",
                              *both(lambda ue, fe, g: K.fused_jacobi_errs_shard(ue, fe, g, h8, 7,
                                                                                0.8, "cpu"),
                                    lambda ue, fe, g: K.fused_jacobi_errs_shard_torch(
                                        ue, fe, g, h8, 7, 0.8, "cpu"), ext8, geo8),
                              3 * g8, 7 * (SWEEP_OPS + ERR_OPS) * pts8),
        "rbgs_shard": (f"{on8}, 2 rb-GS sweeps + cpu error",
                       *both(lambda ue, fe, g: K.fused_jacobi_shard(ue, fe, g, h, 2, 1.0, False,
                                                                    "cpu", "rbgs"),
                             lambda ue, fe, g: K.fused_jacobi_shard_torch(ue, fe, g, h, 2, 1.0,
                                                                          False, "cpu", "rbgs")),
                       3 * g2, (2 * RBGS_OPS + RBGS_ERR_OPS) * pts),
        "residual_shard": (on8, *both(lambda ue, fe, g: K.residual_shard(ue, fe, g, h),
                                      lambda ue, fe, g: K.residual_shard_torch(ue, fe, g, h)),
                           3 * g2, RES_OPS * pts),
        "descend_shard": (f"{on8}, 3 sweeps, sampling, cpu error",
                          *both(lambda ue, fe, g: K.fused_descend_shard(ue, fe, g, h, 3, 0.8,
                                                                        "sampling", "cpu"),
                                lambda ue, fe, g: K.fused_descend_shard_torch(
                                    ue, fe, g, h, 3, 0.8, "sampling", "cpu")),
                          3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + RES_OPS) * pts),
        "ascend_shard": (f"{on8}, 3 sweeps, cpu error",
                         lambda: [K.fused_ascend_shard(ue, fe, c, g.row0 // 2 - ch, -ch, g, h, 3,
                                                       0.8, "cpu")
                                  for (ue, fe), g, c in zip(ext2, geo2, cw2)],
                         lambda: [K.fused_ascend_shard_torch(ue, fe, c, g.row0 // 2 - ch, -ch, g,
                                                             h, 3, 0.8, "cpu")
                                  for (ue, fe), g, c in zip(ext2, geo2, cw2)],
                         3.25 * g2, (3 * SWEEP_OPS + ERR_OPS + 3) * pts),
        "rdma_jacobi": (f"{on8}, 8 sweeps, the exchange inside",
                        lambda: rdma.rdma_jacobi(us2, fs2, h, 8, 0.8),
                        lambda: rdma.rdma_jacobi_torch(us2, fs2, h, 8, 0.8),
                        3 * g2, 8 * SWEEP_OPS * pts),
        "rdma_trigger": (f"{on8}, {s_sweeps} sweeps (trigger 0), cpu error",
                         lambda: rdma.rdma_trigger(us2, fs2, h, 0.8, True, 0.0, s_sweeps),
                         lambda: rdma.rdma_trigger_torch(us2, fs2, h, 0.8, True, 0.0, s_sweeps),
                         3 * g2, s_sweeps * (SWEEP_OPS + ERR_OPS) * pts),
    })
    # the 3-D shard modes at the sharded main paths' shapes: 513³ (257³ for
    # emit_residual, v_cycle3_sharded's odd-depth levels) on 8 z-shards of
    # the card, launched on every shard's windows (exchanged beforehand)
    zring = z_policy(8)

    def z_windows(level, ext, *vols):
        lay = S.layout_of(zring, level)
        geos = [K3.ShardGeo3(level, z0, z1 - z0, ext) for z0, z1 in lay.rows]
        return geos, [[S.planes(v, z0 - ext, z1 + ext) for v in vols] for z0, z1 in lay.rows]

    def on_shards(fn, geos, wins):
        return lambda: [fn(g, *w) for g, w in zip(geos, wins)]

    def both3(fn, plain_fn, geos, wins):
        return on_shards(fn, geos, wins), on_shards(plain_fn, geos, wins)

    geo3_3, win3_3 = z_windows(n3, 3, u3, f3)      # 3 sweeps, gpu error; residual; ascend
    geo3_5, win3_5 = z_windows(n3, 5, u3, f3)      # descend: 3 sweeps + −r + FW ring
    geo3_8, win3_8 = z_windows(n3, 8, u3, f3)      # 7 sweeps, clean error of each
    h15 = 1.0 / (n15 - 1)
    geo15, win15 = z_windows(n15, 3, f15)           # emit_residual from zero, 3 sweeps
    ext_c = KS3.ascend3_halo(3, False)[1]
    cwin3 = [S.planes(c3, g.z0 // 2 - ext_c, (g.z0 + g.nz + 1) // 2 + ext_c + 1) for g in geo3_3]
    pts15 = n15 ** 3
    zon8 = f"{n3}³ on 8 z-shards"
    calls.update({
        "jacobi3_shard": (f"{zon8}, 3 sweeps + gpu error",
                          *both3(lambda g, ue, fe: K3.fused_jacobi3_shard(ue, fe, g, h3, 3, w3,
                                                                          False, "gpu"),
                                 lambda g, ue, fe: K3.fused_jacobi3_shard_torch(ue, fe, g, h3, 3,
                                                                                w3, False, "gpu"),
                                 geo3_3, win3_3),
                          3 * g3, (3 * SWEEP3_OPS + GPU_ERR3_OPS) * pts3),
        "jacobi3_errs_shard": (f"{zon8}, 7 sweeps, clean error of every iterate",
                               *both3(lambda g, ue, fe: K3.fused_jacobi3_errs_shard(
                                   ue, fe, g, h3, 7, w3, "clean"),
                                   lambda g, ue, fe: K3.fused_jacobi3_errs_shard_torch(
                                       ue, fe, g, h3, 7, w3, "clean"), geo3_8, win3_8),
                               3 * g3, 7 * (SWEEP3_OPS + EXTRA3_OPS) * pts3),
        "jacobi3_residual": (f"{n15}³ on 8 z-shards, 3 sweeps from zero, negated residual",
                             *both3(lambda g, fe: K3.fused_jacobi3_residual_shard(
                                 None, fe, g, h15, 3, w3, True, True),
                                 lambda g, fe: K3.fused_jacobi3_residual_shard_torch(
                                     None, fe, g, h15, 3, w3, True, True), geo15, win15),
                             3 * 4 * pts15, (2 * SWEEP3_OPS + 3 + RES3_OPS) * pts15),
        "descend3_shard": (f"{zon8}, 3 sweeps, full weighting, clean error",
                           *both3(lambda g, ue, fe: K3.fused_descend3_shard(
                               ue, fe, g, h3, 3, w3, False, "full_weighting", True),
                               lambda g, ue, fe: K3.fused_descend3_shard_torch(
                                   ue, fe, g, h3, 3, w3, False, "full_weighting", True),
                               geo3_5, win3_5),
                           3.125 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS + 1) * pts3 + FW3_OPS * m3 ** 3),
        "ascend3_shard": (f"{zon8}, 3 sweeps",
                          lambda: [K3.fused_ascend3_shard(ue, fe, c, g.z0 // 2 - ext_c, g, h3, 3,
                                                          w3)
                                   for g, (ue, fe), c in zip(geo3_3, win3_3, cwin3)],
                          lambda: [K3.fused_ascend3_shard_torch(ue, fe, c, g.z0 // 2 - ext_c, g,
                                                                h3, 3, w3)
                                   for g, (ue, fe), c in zip(geo3_3, win3_3, cwin3)],
                          3.125 * g3, (3 * SWEEP3_OPS + PROLONG3_OPS) * pts3),
        "residual3_shard": (f"{zon8}, negated",
                            *both3(lambda g, ue, fe: K3.residual3_shard(ue, fe, g, h3, True),
                                   lambda g, ue, fe: K3.residual3_shard_torch(ue, fe, g, h3,
                                                                              True),
                                   geo3_3, win3_3),
                            3 * g3, RES3_OPS * pts3),
    })
    # the 3-D ring kernels at the sharded main paths' shapes: 513³ on 8
    # z-shards of the card (the trigger loop at 257³, its largest ring
    # level), the exchange inside the launch
    from multigrid_poisson_solver_tpu_torch.ops import rdma3 as R3
    from multigrid_poisson_solver_tpu_torch.solver import trigger_loop

    zu3, zf3 = (S.shard(v, S.layout_of(zring, n3)) for v in (u3, f3))
    zc3 = S.shard(c3, R3.coarse_layout3(zf3))
    zu15, zf15 = (S.shard(v, S.layout_of(zring, n15)) for v in (u15, f15))
    d3 = (h3, 3, w3, False, "full_weighting", True)
    calls.update({
        "rdma_trigger3": (f"{n15}³ on 8 z-shards, {t_sweeps} sweeps (trigger 0), clean error",
                          lambda: R3.rdma_trigger3(zu15, zf15, *t15),
                          lambda: R3.rdma_trigger3_torch(zu15, zf15, *t15),
                          3 * 4 * n15 ** 3, t_sweeps * (SWEEP3_OPS + EXTRA3_OPS) * n15 ** 3),
        "rdma_jacobi3": (f"{zon8}, 3 sweeps + gpu error",
                         lambda: R3.rdma_jacobi3(zu3, zf3, h3, 3, w3, False, "gpu"),
                         lambda: R3.rdma_jacobi3_torch(zu3, zf3, h3, 3, w3, False, "gpu"),
                         3 * g3, (3 * SWEEP3_OPS + GPU_ERR3_OPS) * pts3),
        "rdma_descend3": (f"{zon8}, 3 sweeps, full weighting, clean error",
                          lambda: R3.rdma_descend3(zu3, zf3, *d3),
                          lambda: R3.rdma_descend3_torch(zu3, zf3, *d3),
                          3.125 * g3, (3 * SWEEP3_OPS + EXTRA3_OPS + 1) * pts3 + FW3_OPS * m3 ** 3),
        "rdma_ascend3": (f"{zon8}, 3 sweeps",
                         lambda: R3.rdma_ascend3(zu3, zf3, zc3, h3, 3, w3),
                         lambda: R3.rdma_ascend3_torch(zu3, zf3, zc3, h3, 3, w3),
                         3.125 * g3, (3 * SWEEP3_OPS + PROLONG3_OPS) * pts3),
    })
    # what each ring kernel replaces on the same inputs: the PR 6 exchange
    # path (window copies, then a shard-mode launch per shard; the trigger
    # loop as one-sweep sharded error steps with a host read each)
    nl3, nl15 = zring.planes_per_device(n3), zring.planes_per_device(n15)
    exchange = {
        "rdma_trigger3": lambda: trigger_loop(lambda v: KS3.sharded_trigger_step3(
            v, zf15, t15[0], w3, "clean", nl15), zu15, 0.0, t_sweeps),
        "rdma_jacobi3": lambda: KS3.sharded_fused_jacobi3_err(zu3, zf3, h3, 3, w3, "gpu",
                                                              nl=nl3),
        "rdma_descend3": lambda: KS3.sharded_fused_descend3(zu3, zf3, *d3, nl3),
        "rdma_ascend3": lambda: KS3.sharded_fused_ascend3(zu3, zf3, zc3, h3, 3, w3, nl=nl3),
    }
    times = {}
    for k, (shape, kern, plain, nbytes, ops) in calls.items():
        bound_ms, bound_by = bound(nbytes, ops)
        times[k] = (time_ms(kern, reps=10), time_ms(plain, reps=2, rounds=3), bound_ms, bound_by)
        say(f"[t] {k} at {shape}: kernel {times[k][0]:.4f} ms, plain {times[k][1]:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    def outputs(x):
        """The tensors of a call's result, in order (sharded grids gathered)."""
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, S.ShardedGrid):
            return [S.gather(x)]
        if isinstance(x, (tuple, list)):
            return [t for y in x for t in outputs(y)]
        return []

    for k in KERNELS:
        if k in SINGLE_DEVICE:
            continue
        shape, kern, plain = calls[k][:3]
        got, want = outputs(kern()), outputs(plain())
        require(len(got) == len(want), f"{k} at {shape}: {len(got)} outputs vs {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            what = f"at {shape}, output {i}"
            if not a.is_floating_point():
                require(bool(torch.equal(a, b)), f"{k} {what}: {a.tolist()} vs {b.tolist()}")
            elif a.dim() <= 1:
                for x, y in zip(a.reshape(-1), b.reshape(-1)):
                    cmp.scalar(k, what, x, y)
            else:
                cmp.grid(k, what, a, b)
        cmp.cases[k] += 1
        say(f"[t] {k} at {shape}: held against its plain version, max|Δ| so far "
            f"{cmp.max_abs[k]:.3e}, bit-identical: {cmp.bitwise[k]}")
    for k, fn in exchange.items():
        ms = time_ms(fn, reps=1 if k == "rdma_trigger3" else 3)
        say(f"[t] {k} at {calls[k][0]}: ring kernel {times[k][0]:.4f} ms; the exchange path "
            f"(window copies and a shard-mode launch per shard) {ms:.4f} ms")
    ms_ex = time_ms(lambda: KS.sharded_fused_jacobi(us2, fs2, h, 8, 0.8), reps=5)
    ms_un = time_ms(lambda: K.fused_jacobi(u, f, h, 8, 0.8), reps=5)
    say(f"[t] 8 sweeps at {n}²: unsharded kernel {ms_un:.4f} ms; 8 shards through the exchange "
        f"path (halo copies + a launch a shard) {ms_ex:.4f} ms; through the ring kernel "
        f"{times['rdma_jacobi'][0]:.4f} ms")
    say(f"[t] ring trigger loop at {n}² on 8 shards: {times['rdma_trigger'][0] / s_sweeps:.4f} "
        f"ms per sweep; the unsharded streamed loop {times['trigger_stream'][0] / s_sweeps:.4f} "
        f"ms per sweep")
    say(f"[t] streamed trigger loop at {n}²: {times['trigger_stream'][0] / s_sweeps:.4f} ms "
        f"per sweep (12 B per point per sweep unblocked: "
        f"{12 * pts / HBM * 1e3:.4f} ms)")
    for k, m in (("trigger3", n16), ("trigger3_stream", n15)):
        say(f"[t] {k} at {m}³: {times[k][0] / t_sweeps:.4f} ms per sweep, plain "
            f"{times[k][1] / t_sweeps:.4f}; per-sweep bounds: operations "
            f"{(SWEEP3_OPS + EXTRA3_OPS) * m ** 3 / FP32 * 1e3:.4f} ms, 12 B per point unblocked "
            f"{12 * m ** 3 / HBM * 1e3:.4f} ms")

    # -- phase 5: smoother throughput at 8193² -------------------------------------
    u, f = rnd(n8), rnd(n8)
    dofs = (n8 - 2) ** 2 * 8
    ms_k = time_ms(lambda: K.fused_jacobi(u, f, h8, 8, 0.8), reps=10)
    ms_p = time_ms(lambda: K.fused_jacobi_torch(u, f, h8, 8, 0.8), reps=2, rounds=3)
    say(f"[5] smoothing {n8}², 8 sweeps per launch: kernel {dofs / ms_k / 1e6:.2f} GDoF/s "
        f"({ms_k / 8:.4f} ms/sweep), plain {dofs / ms_p / 1e6:.2f} GDoF/s "
        f"({ms_p / 8:.4f} ms/sweep)")
    say(f"[end] trigger V-cycle {n8}² wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_trigger.items()))
    say(f"[end] sweeps per level, batch 7: {trigger_levels}; auto: {auto_levels}")
    say(f"[end] rb-GS V(2,2) {n}² {ms_rbgs:.3f} ms/cycle")
    say("[end] 3-D ms/cycle (kernels, plain): "
        + "; ".join(f"{tag} {a:.3f}, {b:.3f}" for tag, (a, b) in ms_3d.items()))
    say(f"[end] 3-D trigger V-cycle 513³ wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_trigger3.items()))
    say(f"[end] 3-D sweeps per level, batch 7: {trigger3_levels}; auto: {auto3_levels}; "
        f"exact: {exact3_levels}")
    say("[end] refine3 513³ tw32 to 1e-10 (cycles, wall ms): "
        + "; ".join(f"{k} {c}, {ms:.1f}" for k, (c, ms) in refine3_runs.items()))
    say("[end] G2 ms/cycle at 4097² on 8 shards of one card (no scaling: one card): "
        + "; ".join(f"{tag} {ms:.3f}" for tag, ms in ms_g2.items()))
    say("[end] G3 sharded trigger V-cycle 8193² wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_g3.items())
        + f"; sweeps per level, rdma auto: {g3_levels}")
    say("[end] H2 ms/cycle at 513³ on 8 z-shards of one card (no scaling: one card): "
        + "; ".join(f"{tag} {ms:.3f}" for tag, ms in ms_h2.items()))
    say("[end] H3 sharded 3-D trigger V-cycle 513³ wall ms: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_h3.items()))
    say("[end] I2 ms/cycle at 513³ on 8 z-shards of one card, halo rdma (H2's ppermute beside): "
        + "; ".join(f"{tag} {ms:.3f} ({ms_h2[tag + ' kernels']:.3f})"
                    for tag, ms in ms_i2.items()))
    say("[end] I3 sharded 3-D trigger V-cycle 513³ wall ms, halo rdma: "
        + ", ".join(f"{tag} {ms:.1f}" for tag, ms in ms_i3.items()))
    say(f"[end] chip_smoke ran {time.perf_counter() - t_start:.0f} s")

    # no single PyTorch call computes any of these functions: library_ms is null
    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": run_counts[run][k], "run": run, "max_abs_err": cmp.max_abs[k],
         "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": times[k][2],
         "bound_by": times[k][3], "library_ms": None}
        for k, (src, tpu, run) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
