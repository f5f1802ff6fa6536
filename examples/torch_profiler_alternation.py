"""Where, in chip_smoke.py, torch.profiler sessions start to come back empty.

Runs ``chip_smoke.main()`` with its two helpers that touch the profiler or
CUDA graphs wrapped: after each call of ``device_events`` (one profiler
session) or ``graph_us`` (a CUDA graph captured, replayed and freed), two bare
profiler sessions around four ``add_`` kernels each, and a line
``[probe] <i> after <helper>: a, b`` with their kernel events (4, 4 while no
session loses its device events), the card's free and PyTorch's reserved
memory, then ``torch.cuda.empty_cache()`` and two more sessions. Prints the
first probe that lost one, and exits with chip_smoke's code, or after
``--probes`` probes (chip_smoke stopped there). ``--phases`` instead runs
chip_smoke's first steps one by one with a probe after each: the kernels'
build and load, phase 2's 2-D and 3-D kernel checks, warm 4097² V(3,3)
cycles, one ``device_events`` session of that cycle.

    python examples/torch_profiler_alternation.py [--probes N | --phases]    (a card)
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

probes = []


class Enough(Exception):
    pass


LIMIT = [0]


def sessions(x, n):
    import torch
    from torch.profiler import ProfilerActivity, profile

    got = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(n):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    x.add_(1.0)
                torch.cuda.synchronize()
            prof.export_chrome_trace(f"{tmp}/t.json")
            events = json.loads(Path(f"{tmp}/t.json").read_text())["traceEvents"]
            got.append(sum(e.get("cat") == "kernel" for e in events))
    return got


def probe(tag):
    import torch

    x = torch.zeros((1024, 1024), device="cuda")
    got = sessions(x, 2)
    free, total = torch.cuda.mem_get_info()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    free_after = torch.cuda.mem_get_info()[0]
    after = sessions(x, 2)
    probes.append((tag, got, after))
    print(f"[probe] {len(probes) - 1} after {tag}: {got[0]}, {got[1]}; free "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB, reserved {reserved / 2**30:.2f} GiB; "
          f"after empty_cache free {free_after / 2**30:.2f} GiB: {after[0]}, {after[1]}",
          flush=True)
    if LIMIT[0] and len(probes) >= LIMIT[0]:
        raise Enough


def wrapped(name):
    inner = getattr(cs, name)

    def call(*args, **kwargs):
        out = inner(*args, **kwargs)
        probe(name)
        return out

    return call


def phases():
    import torch

    import multigrid_poisson_solver_tpu_torch as tmg
    from multigrid_poisson_solver_tpu_torch.ops import build
    from multigrid_poisson_solver_tpu_torch.ops import kernels as K
    from multigrid_poisson_solver_tpu_torch.ops import kernels3 as K3

    build.build()
    build.load()
    probe("build and load")
    cmp = cs.Compare()
    cs.phase2(K, torch, cmp, tmg.REFERENCE_PROBLEM, tmg.GridSpec)
    probe("phase 2, 2-D kernels")
    cs.phase2_3d(K3, torch, cmp)
    probe("phase 2, 3-D kernels")
    program = tmg.v_cycle(4097, n_min=8, steps=3, coarse_option=0, coarsen=3)
    warm = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, device="cuda", warm=True)
    u, f = warm.init()
    for _ in range(5):
        u = warm(u, f)[0]
    torch.cuda.synchronize()
    probe("V(3,3) 4097², 5 cycles")
    cs.device_events(lambda: warm(u, f))
    probe("device_events")
    return 0


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probes", type=int, default=0,
                   help="stop chip_smoke after this many probes (0: run it to its end)")
    p.add_argument("--phases", action="store_true",
                   help="chip_smoke's first steps one by one, a probe after each")
    args = p.parse_args(argv)
    LIMIT[0] = args.probes
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    probe("start")
    if args.phases:
        return phases()
    cs.device_events = wrapped("device_events")
    cs.graph_us = wrapped("graph_us")
    try:
        rc = cs.main()
    except Enough:
        rc = 0
    lost = [i for i, (_, got, _) in enumerate(probes) if got != [4, 4]]
    kept = [i for i, (_, _, after) in enumerate(probes) if after == [4, 4]]
    print(f"[probe] {len(probes)} probes; the first with a lost session: "
          f"{lost[0] if lost else None} ({probes[lost[0]][0] if lost else '-'}); "
          f"with a loss: {len(lost)}; whole after empty_cache: {len(kept)}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
