"""Kernel events of consecutive torch.profiler sessions in one process.

Each configuration runs in a fresh process: first none, one or a hundred
CUDA graphs of one ``fused_jacobi`` launch at 1025² (a hundred: each
captured, replayed 20 times and freed, as ``chip_smoke.graph_us`` times a
kernel), then eight profiler sessions in a row, each around the same work,
exported as a Chrome trace: four ``add_`` kernels on a 1024² tensor, one
warm V(3,3) cycle at 4097² on the port's kernels, or an ``rfft2`` and an
``add_``. Five configurations first open two profiler sessions, before the
port's kernel library or torch's FFT kernels are first used, before one
subprocess runs, before the kernel library is built afresh (nvcc
subprocesses) and loaded, or before a 90 s sleep (a negative ``pre``). It
prints, per
configuration, the kernel events each session's trace holds (equal in every
session when nothing is lost) and one JSON line with them all.

    python examples/torch_profiler_sessions.py [--only TEXT ...]

Configurations: the environment as it comes, or with Kineto's
``TEARDOWN_CUPTI=0`` (CUPTI stays set up between sessions) or
``DISABLE_CUPTI_LAZY_REINIT=1``; the sessions as bare ``torch.profiler``
blocks or as ``utils.profiling.trace()``. Needs a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SESSIONS = 8
CONFIGS = {
    "add: bare": ({}, 0, "bare", "add", 0),
    "V(3,3): bare": ({}, 0, "bare", "vcycle", 0),
    "V(3,3): bare after a graph": ({}, 1, "bare", "vcycle", 0),
    "V(3,3): bare after 100 graphs": ({}, 100, "bare", "vcycle", 0),
    "V(3,3): bare after 100 graphs, TEARDOWN_CUPTI=0": ({"TEARDOWN_CUPTI": "0"}, 100, "bare",
                                                        "vcycle", 0),
    "V(3,3): bare after 100 graphs, DISABLE_CUPTI_LAZY_REINIT=1": (
        {"DISABLE_CUPTI_LAZY_REINIT": "1"}, 100, "bare", "vcycle", 0),
    "V(3,3): trace() after 100 graphs": ({}, 100, "trace", "vcycle", 0),
    "V(3,3): bare, 2 sessions before the kernel library's first use": (
        {}, 0, "bare", "vcycle", 2),
    "fft: bare, 2 sessions before torch's FFT kernels' first use": ({}, 0, "bare", "fft", 2),
    "add: bare, 2 sessions before a subprocess": ({}, 0, "bare", "add", -2),
    "V(3,3): bare, 2 sessions before the library's build (nvcc subprocesses)": (
        {}, 0, "bare", "build", -2),
    "V(3,3): bare, 2 sessions before a 90 s sleep": ({}, 0, "bare", "sleep", -2),
    "V(3,3): bare, 2 sessions before a 90 s sleep, TEARDOWN_CUPTI=0": (
        {"TEARDOWN_CUPTI": "0"}, 0, "bare", "sleep", -2),
    "V(3,3): bare, 2 sessions before a 90 s sleep, DISABLE_CUPTI_LAZY_REINIT=1": (
        {"DISABLE_CUPTI_LAZY_REINIT": "1"}, 0, "bare", "sleep", -2),
}


def child(graphs: int, how: str, workload: str, pre: int) -> list:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT))
    import multigrid_poisson_solver_tpu_torch as mg
    from multigrid_poisson_solver_tpu_torch.ops import kernels as K
    from multigrid_poisson_solver_tpu_torch.utils import profiling

    x = torch.zeros((1024, 1024), device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    for _ in range(abs(pre)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            x.add_(1.0)
            torch.cuda.synchronize()
    if pre < 0 and workload == "add":
        subprocess.run([sys.executable, "-c", "pass"], check=True)
    if workload == "sleep":
        time.sleep(90)          # as long as the build takes
        workload = "vcycle"
    if workload == "build":
        from multigrid_poisson_solver_tpu_torch.ops import build

        # a build of its own, kept on disk: nvcc runs in this process
        build.BUILD_DIR = Path(tempfile.mkdtemp(dir=build.BUILD_DIR.parent))
        build.build()
        build.load()
        workload = "vcycle"
    if workload == "add":
        def work():
            for _ in range(4):
                x.add_(1.0)

        def step():
            x.add_(1.0)
    elif workload == "fft":
        def work():
            torch.fft.rfft2(x)
            x.add_(1.0)

        def step():
            x.add_(1.0)
    else:
        program = mg.v_cycle(4097, n_min=8, steps=3, coarse_option=0, coarsen=3)
        warm = mg.compile_program(program, mg.REFERENCE_PROBLEM, device="cuda", warm=True)
        u, f = warm.init()
        u = warm(u, f)[0]
        g1, g2 = torch.rand((1025, 1025), device="cuda"), torch.rand((1025, 1025), device="cuda")

        def work():
            warm(u, f)

        def step():
            K.fused_jacobi(g1, g2, 1.0 / 1024, 3, 0.8)
    step()
    torch.cuda.synchronize()
    kept = []
    for i in range(graphs):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            step()
        for _ in range(1 if graphs == 1 else 20):
            g.replay()
        torch.cuda.synchronize()
        if i == 0:
            kept.append(g)
        del g
    torch.cuda.synchronize()
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(SESSIONS):
            path = Path(tmp) / f"s{i}"
            if how == "trace":
                with profiling.trace(path):
                    work()
            else:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    work()
                    torch.cuda.synchronize()
                path.mkdir()
                prof.export_chrome_trace(str(path / "trace.json"))
            events = json.loads((path / "trace.json").read_text())["traceEvents"]
            counts.append(sum(e.get("cat") == "kernel" for e in events))
    return counts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--child", choices=sorted(CONFIGS), help=argparse.SUPPRESS)
    p.add_argument("--only", action="append", default=[],
                   help="run the configurations whose name holds this text (repeatable)")
    args = p.parse_args(argv)
    if args.child:
        _, graphs, how, workload, pre = CONFIGS[args.child]
        print(json.dumps(child(graphs, how, workload, pre)))
        return 0
    out = {}
    for name, (env, *_) in CONFIGS.items():
        if args.only and not any(text in name for text in args.only):
            continue
        proc = subprocess.run([sys.executable, __file__, "--child", name], capture_output=True,
                              text=True, env={**os.environ, **env}, timeout=600)
        if proc.returncode != 0:
            print(f"{name}: exited {proc.returncode}\n{proc.stderr[-2000:]}", file=sys.stderr)
            return 1
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"{name}: kernel events per session {out[name]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
