#!/usr/bin/env python3
"""Drive the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (progress on stdout; the first failure exits non-zero):
  0. require a CUDA device; print the card's name and power limit;
  1. build the seven CUDA kernels from ops/csrc (nvcc, sm_90a);
  2. hold each kernel against its plain PyTorch twin on the card: at
     n = 1025 and 1031 (several tiles per dimension, ragged last tiles),
     steps 1/3/7/8, every error mode, from_zero, both restrictions; and at
     the shapes the main paths give them (legs at 4097² and 2049², chains
     from 1025², smoother, residual and trigger loop at 256² down to 8²);
  3. the library path: 4097² V(3,3) (ω = 0.8, coarsen=3, dense coarse solve)
     through compile_program, one cold and five warm cycles, with the CUDA
     kernels and with plain PyTorch: the iterates after 1 and 6 cycles,
     the float64 relative residuals, ms/cycle;
  4. the CLI path: schedules/Vcycle.txt and schedules/VcycleTrigger.txt
     (compiled engine), each in a subprocess and in process;
  5. smoother throughput at 8193², 8 sweeps per launch.
Launch counts are set to 0 just before each main-path run and read just
after it. The line before the last is a JSON object describing each kernel;
the last line is the JSON device record. Without a CUDA device the script
exits 1 and prints no result.
"""

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

    # several tiles per dimension, ragged last tiles; every mode
    for n in (1025, 1031):
        smoother(n, (1, 3, 7, 8), (None, True, False, "gpu"), (False, True))
        legs(n, (1, 3, 7, 8), (None, True, False, "gpu"), (False, True),
             ("sampling", "full_weighting"))
        for compat in (True, False, "gpu"):
            for max_sweeps in (50, 51):   # the final iterate in either buffer
                trigger(n, rand(n, n), rand(n, n), compat, 0.0, max_sweeps)
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
    torch.cuda.synchronize()


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
        ms = time_ms(lambda: warm(u, f), reps=10)
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
    ms_legs = time_ms(lambda: warm(u6k, f), reps=10)
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
    for k, (_, _, run) in KERNELS.items():
        require(run_counts[run][k] > 0, f"the {run} run did not launch {k}")
    vprog = tmg.parse_cycle_path(ROOT / "schedules" / "VcycleTrigger.txt")
    for label, fits in (("whole-loop trigger kernel", K.trigger_fits),
                        ("per-sweep trigger loop", lambda n: False)):
        saved, K.trigger_fits = K.trigger_fits, fits
        cc = tmg.compile_program(vprog, tmg.REFERENCE_PROBLEM, device="cuda")
        ui, fi = cc.init()
        ms_cli = time_ms(lambda: cc(ui, fi), reps=3, rounds=3)
        K.trigger_fits = saved
        say(f"[4] VcycleTrigger.txt compiled solve, {label}: {ms_cli:.3f} ms")

    # -- timings at the main paths' shapes -------------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    u = torch.randn(n, n, generator=gen, device="cuda")
    f = torch.randn(n, n, generator=gen, device="cuda")
    uc = torch.randn((n + 1) // 2, (n + 1) // 2, generator=gen, device="cuda")
    h = 1.0 / (n - 1)
    sizes = ladder(1025)
    hc = 1.0 / 1024
    uq = torch.randn(1025, 1025, generator=gen, device="cuda")
    fq = torch.randn(1025, 1025, generator=gen, device="cuda")
    c_args = (sizes, hc, (3,) * 7, 0.8, "sampling", True)
    u_list, f_list = K.chain_descend(uq, fq, *c_args)
    a_args = (u_list, [fq] + f_list[:-1], torch.randn(9, 9, generator=gen, device="cuda"),
              sizes, hc, (3,) * 7, 0.8, True, False)
    ut = torch.randn(256, 256, generator=gen, device="cuda")
    ft = torch.randn(256, 256, generator=gen, device="cuda")
    t_args = (1.0 / 255, 0.8, True, 0.0, 100)
    calls = {  # name -> (shape, kernel call, plain call)
        "jacobi": (f"{n}², 3 sweeps + cpu error",
                   lambda: K.fused_jacobi_err(u, f, h, 3, 0.8, True),
                   lambda: K.fused_jacobi_err_torch(u, f, h, 3, 0.8, True)),
        "residual": (f"{n}²", lambda: K.residual(u, f, h), lambda: K.residual_torch(u, f, h)),
        "trigger": ("256², 100 sweeps (trigger 0), cpu error",
                    lambda: K.trigger_smooth(ut, ft, *t_args),
                    lambda: K.trigger_smooth_torch(ut, ft, *t_args)),
        "descend": (f"{n}², 3 sweeps, sampling, cpu error",
                    lambda: K.fused_descend(u, f, h, 3, 0.8, "sampling", True, True),
                    lambda: K.fused_descend_torch(u, f, h, 3, 0.8, "sampling", True, True)),
        "ascend": (f"{n}², 3 sweeps, cpu error",
                   lambda: K.fused_ascend(u, f, uc, h, 3, 0.8, True, True),
                   lambda: K.fused_ascend_torch(u, f, uc, h, 3, 0.8, True, True)),
        "chain_descend": ("1025² → 9², 3 sweeps, sampling, from zero",
                          lambda: K.chain_descend(uq, fq, *c_args),
                          lambda: K.chain_descend_torch(uq, fq, *c_args)),
        "chain_ascend": ("9² → 1025², 3 sweeps",
                         lambda: K.chain_ascend(*a_args), lambda: K.chain_ascend_torch(*a_args)),
    }
    times = {}
    for k, (shape, kern, plain) in calls.items():
        times[k] = (time_ms(kern, reps=20), time_ms(plain, reps=3))
        say(f"[t] {k} at {shape}: kernel {times[k][0]:.4f} ms, plain {times[k][1]:.4f} ms")

    # -- phase 5: smoother throughput at 8193² -------------------------------------
    n5 = 8193
    u = torch.randn(n5, n5, generator=gen, device="cuda")
    f = torch.randn(n5, n5, generator=gen, device="cuda")
    h = 1.0 / (n5 - 1)
    dofs = (n5 - 2) ** 2 * 8
    ms_k = time_ms(lambda: K.fused_jacobi(u, f, h, 8, 0.8), reps=10)
    ms_p = time_ms(lambda: K.fused_jacobi_torch(u, f, h, 8, 0.8), reps=2, rounds=3)
    say(f"[5] smoothing {n5}², 8 sweeps per launch: kernel {dofs / ms_k / 1e6:.2f} GDoF/s "
        f"({ms_k / 8:.4f} ms/sweep), plain {dofs / ms_p / 1e6:.2f} GDoF/s "
        f"({ms_p / 8:.4f} ms/sweep)")

    say(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": tpu,
         "launches": run_counts[run][k], "run": run, "max_abs_err": cmp.max_abs[k],
         "ms": times[k][0], "plain_ms": times[k][1]}
        for k, (src, tpu, run) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
