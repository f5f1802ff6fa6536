#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (progress on stdout; the first failure exits non-zero):
  0. require a CUDA device; print the card's name and power limit;
  1. build the eleven CUDA kernels from ops/csrc (nvcc, sm_90a, one process
     per source);
  2. hold each kernel against its plain PyTorch twin on the card: at
     n = 1025 and 1031 (several tiles per dimension, ragged last tiles),
     every sweep count, error mode and from_zero; and at the shapes the main
     paths give them (legs at 4097² and 2049², chains from 1025², smoother,
     residual and trigger loop at 256² down to 8², the multi-word residual
     and the per-sweep errors at 8193², the streamed trigger loop at 2305²
     and 4097², the rb-GS modes at 4097²);
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
  C. rb-GS V(2,2) with full weighting at 4097², cycles and refinement.
Launch counts are set to 0 just before each main-path run and read just
after it. The line before the last is a JSON object describing each kernel;
the last line is the JSON device record. Without a CUDA device the script
exits 1 and prints no result.
"""

import contextlib
import json
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
}


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
    for k in KERNELS:
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
    times = {}
    for k, (shape, kern, plain, nbytes, ops) in calls.items():
        bound_ms, bound_by = bound(nbytes, ops)
        times[k] = (time_ms(kern, reps=10), time_ms(plain, reps=2, rounds=3), bound_ms, bound_by)
        say(f"[t] {k} at {shape}: kernel {times[k][0]:.4f} ms, plain {times[k][1]:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    say(f"[t] streamed trigger loop at {n}²: {times['trigger_stream'][0] / s_sweeps:.4f} ms "
        f"per sweep (12 B per point per sweep unblocked: "
        f"{12 * pts / HBM * 1e3:.4f} ms)")

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
    say(f"[end] rb-GS V(2,2) {n}² {ms_rbgs:.3f} ms/cycle; chip_smoke ran "
        f"{time.perf_counter() - t_start:.0f} s")

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
