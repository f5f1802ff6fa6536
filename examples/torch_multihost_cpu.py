"""Run the port's sharded cycles over several processes and hold them bit for
bit to one process on the same logical mesh.

The counterpart of ``examples/exp_multihost_cpu.py``. The launcher runs the
same programs twice: as 1 process with 4 mesh entries (the one-process
branch of ``multihost.hybrid_block_mesh``: a 2×2 mesh) and as 2 gloo
processes with 2 entries each (processes on the row axis: the same 2×2
mesh), then compares every owned block (SHA-256), the errors and the trigger
stop sweeps:

  * ``block2d``: JAX's example's block-sharded V(3,3) at 129²
    (``v_cycle(129, n_min=8, steps=3, coarse_target=1e-7)``,
    ``block_policy(mesh, threshold_rows=8)``);
  * ``trigger2d``: a trigger V-cycle on a row ring over the 4 entries;
  * ``compiled3``: ``compile_program3`` V(3,3) at 65³ (coarsen=3, ω 6/7) on a
    z ring of the 4 entries across both processes (``ZShardingPolicy3``,
    threshold 8);
  * ``vcycle3``: ``v_cycle3_sharded`` on the same z ring.

Usage:
  python examples/torch_multihost_cpu.py [--device cpu] [--twins]

``--twins`` routes the engines through the shard-mode kernels' CPU twins
(the kernels' data path: their windows, legs and psums) instead of the plain
per-shard ops. This module is also the runner other checks import
(``run_programs``, ``worker``, ``compare``): the tests, the four-card NCCL
check (``examples/torch_multiproc_check.py``) and the card's smoke test.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the CPU example's sizes (JAX's example: 129² and 65³)
CPU_SPECS = {
    "block2d": {"kind": "block2d", "n": 129, "threshold": 8, "cycles": 1,
                "program": {"n_min": 8, "steps": 3, "coarse_target": 1e-7}, "config": {}},
    "trigger2d": {"kind": "trigger2d", "n": 129, "threshold": 8, "cycles": 1,
                  "program": {"n_min": 8, "steps": -1, "coarse_option": 0, "coarsen": 3},
                  "config": {"omega": 0.8, "trigger": 1e-3, "max_trigger_sweeps": 200}},
    "compiled3": {"kind": "compiled3", "n": 65, "threshold": 8, "cycles": 1,
                  "program": {"n_min": 5, "steps": 3, "coarse_target": 1e-8, "coarsen": 3},
                  "config": {"omega": 6.0 / 7.0}},
    "vcycle3": {"kind": "vcycle3", "n": 65, "threshold": 8, "cycles": 1},
}


@contextlib.contextmanager
def kernel_twins():
    """Route the engines through the kernel path on CPU tensors, where every
    shard-mode kernel runs its plain twin (``ops.kernels``)."""
    from multigrid_poisson_solver_tpu_torch import compiled, compiled3
    from multigrid_poisson_solver_tpu_torch.ops import kernels as K

    saved = compiled._use_kernels, compiled3._use_kernels, K.use_kernels
    compiled._use_kernels = compiled3._use_kernels = lambda cfg, device: cfg.kernels != "torch"
    K.use_kernels = lambda kernels, device: kernels != "torch"
    try:
        yield
    finally:
        compiled._use_kernels, compiled3._use_kernels, K.use_kernels = saved


def _digest(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _blocks(x) -> dict:
    """{"i,j": SHA-256} of this process's blocks of a level (a replicated
    tensor is one block "0,0")."""
    from multigrid_poisson_solver_tpu_torch.parallel.sharded import ShardedGrid

    if not isinstance(x, ShardedGrid):
        return {"0,0": _digest(x)}
    return {f"{i},{j}": _digest(b) for i, j, b in x.local()}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run_one(spec: dict, local_devices, keep: bool, time_it: bool) -> dict:
    import torch

    import multigrid_poisson_solver_tpu_torch as tmg
    from multigrid_poisson_solver_tpu_torch.ops import kernels as K
    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
    from multigrid_poisson_solver_tpu_torch.parallel import multihost
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    kind, n, cycles = spec["kind"], spec["n"], spec.get("cycles", 1)
    cfg_kw = dict(spec.get("config", {}))
    if kind == "refine2d":
        return _refine(spec, local_devices)
    if kind in ("compiled3", "vcycle3"):
        mesh = multihost.z_mesh(local_devices)
        policy = M.ZShardingPolicy3(mesh, threshold_planes=spec["threshold"])
    elif kind in ("trigger2d", "rows2d"):
        mesh = multihost.row_mesh(local_devices)
        policy = M.ShardingPolicy(mesh, threshold_rows=spec["threshold"])
    else:
        mesh = multihost.hybrid_block_mesh(spec.get("rows"), local_devices)
        policy = multihost.block_policy(mesh, threshold_rows=spec["threshold"])
    dev = S.home(policy)
    sweeps: list = []
    if kind == "vcycle3":
        h = 1.0 / (n - 1)
        prob = tmg.REFERENCE_PROBLEM_3D
        u0 = prob.boundary_grid(n, torch.float32, dev)
        f = S.as_level(prob.source_grid(n, torch.float32, dev) + u0, policy, n)
        u0 = S.as_level(u0, policy, n)

        def cycle(u, warm):
            return tmg.v_cycle3_sharded(u, f, h, mesh, n_min=5, pre=3, post=3,
                                        omega=6.0 / 7.0,
                                        threshold_planes=spec["threshold"]), None
    else:
        program = tmg.v_cycle(n, **spec["program"])
        cfg = tmg.SolverConfig(collect_node_stats=False, **cfg_kw)
        if kind == "compiled3":
            cold = tmg.compile_program3(program, tmg.REFERENCE_PROBLEM_3D, cfg, device=dev,
                                        policy=policy)
        else:
            cold = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device=dev,
                                       policy=policy)
            warm_cc = tmg.compile_program(program, tmg.REFERENCE_PROBLEM, cfg, device=dev,
                                          warm=True, policy=policy)
            warm_cc.trigger_sweeps = sweeps
        cold.trigger_sweeps = sweeps
        u0, f = cold.init()

        def cycle(u, warm):
            if kind == "compiled3":
                return cold(u, f, warm=warm)
            return (warm_cc if warm else cold)(u, f)

    K.reset_launch_counts()
    S.reset_counts()
    u, err = cycle(u0, False)
    first_counts = S.counts()
    errs = [None if err is None else float(err)]
    for _ in range(cycles - 1):
        u, err = cycle(u, True)
        errs.append(None if err is None else float(err))
    _sync(dev)
    out = {"mesh": dict(mesh.shape), "processes": multihost.process_count(),
           "blocks": _blocks(u), "errs": errs, "sweeps": [list(s) for s in sweeps],
           "counts": first_counts, "launches": {k: v for k, v in K.launches.items() if v},
           "dtype_bytes": torch.finfo(torch.float32).bits // 8}
    if time_it:
        # warm cycles: CUDA events on a card (the host clock elsewhere)
        reps, cuda = spec.get("reps", 3), dev.type == "cuda"
        if cuda:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        _sync(dev)
        t0 = time.perf_counter()
        if cuda:
            events[0].record()
        v = u
        for _ in range(reps):
            v, _ = cycle(v, True)
        if cuda:
            events[1].record()
        _sync(dev)
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        out["ms"] = events[0].elapsed_time(events[1]) / reps if cuda else out["wall_ms"]
    if keep:
        out["u"] = S.gather(u, "cpu").numpy()
    return out


def _refine(spec: dict, local_devices) -> dict:
    """Refinement to a tolerance under a block policy: the state lives
    whole on every process, the correction cycles on the mesh."""
    import multigrid_poisson_solver_tpu_torch as tmg
    from multigrid_poisson_solver_tpu_torch.parallel import multihost
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    mesh = multihost.hybrid_block_mesh(local_devices=local_devices)
    policy = multihost.block_policy(mesh, threshold_rows=spec["threshold"])
    S.reset_counts()
    rep = tmg.solve_to_tolerance(tmg.REFERENCE_PROBLEM, spec["n"], tol=spec["tol"],
                                 state=spec.get("state", "tw32"), device=S.home(policy),
                                 policy=policy)
    return {"mesh": dict(mesh.shape), "processes": multihost.process_count(),
            "blocks": {"u": _digest(rep.u), "u_lo": _digest(rep.u_lo)},
            "errs": [rep.rel_residual], "sweeps": [rep.cycles], "counts": S.counts(),
            "launches": {}}


def run_programs(specs: dict, local_devices, twins: bool = False, keep: bool = False,
                 time_it: bool = False) -> dict:
    """{name: result} of every program of ``specs`` on this process's
    ``local_devices`` (under a process group every process calls it with
    its own entries; a spec's "twins" routes that program through the
    kernels' twins). A result holds the SHA-256 of this process's blocks
    of the last iterate, the errors, the trigger stop sweeps, the sharded
    layer's counters of the first cycle and the kernel launches; ``keep``
    adds the gathered iterate, ``time_it`` the ms of a warm cycle (CUDA
    events)."""
    out = {}
    for name, spec in specs.items():
        with kernel_twins() if twins or spec.get("twins") else contextlib.nullcontext():
            out[name] = _run_one(spec, local_devices, keep, time_it)
    return out


def overheads(local_devices, n: int = 257, reps: int = 50) -> dict:
    """Host seconds of the sharded layer's events on a row ring of
    ``local_devices`` entries a process (one process: the copies alone; several: one
    message a process and direction): an exchange of one halo row, and a
    psum of one float64 partial a shard; with the pieces and messages an
    exchange moves (``utils.scaling_model``'s PIECE_S, MESSAGE_S and
    COLLECTIVE_S come from these)."""
    import torch

    from multigrid_poisson_solver_tpu_torch.parallel import mesh as M
    from multigrid_poisson_solver_tpu_torch.parallel import multihost
    from multigrid_poisson_solver_tpu_torch.parallel import sharded as S

    pol = M.ShardingPolicy(multihost.row_mesh(local_devices), threshold_rows=1)
    lay = S.layout_of(pol, n)
    x = S.shard(torch.ones(n, n, device=S.home(pol)), lay)
    parts = [torch.ones((), dtype=torch.float64, device=b.device) for _, _, b in x.local()]
    dev = S.home(pol)

    def timed(fn):
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(dev)
        return (time.perf_counter() - t0) / reps

    S.reset_counts()
    S.extend_all(x, 1)
    c = S.counts()[n]
    return {"exchange_s": timed(lambda: S.extend_all(x, 1)), "pieces": c["pieces"],
            "messages": c["messages"], "psum_s": timed(lambda: float(S.psum(parts, x)))}


def worker(rank: int, specs: dict, entries: int, device: str, twins: bool = False,
           keep: bool = False, time_it: bool = False, measure: bool = False) -> dict:
    """One process of a multi-process run (``multihost.spawn``'s fn): its
    ``entries`` mesh entries all on ``device`` ("{rank}" in it is the
    process's rank: "cuda:{rank}" for a card a process). ``measure`` adds
    ``overheads`` on one entry a process under "overheads"."""
    device = device.format(rank=rank)
    out = run_programs(specs, [device] * entries, twins, keep, time_it)
    if measure:
        out["overheads"] = overheads([device])
    return out


def merge(per_process: list) -> dict:
    """The processes' results as one: every process's blocks together, the
    errors, sweeps and counters of process 0 (checked equal on every one)."""
    out = {}
    for name in per_process[0]:
        if name == "overheads":
            continue
        rs = [p[name] for p in per_process]
        first = dict(rs[0])
        first["blocks"] = {k: v for r in rs for k, v in r["blocks"].items()}
        for key in ("errs", "sweeps", "counts"):
            if any(r[key] != rs[0][key] for r in rs):
                raise AssertionError(f"{name}: the processes disagree on {key}")
        first["launches_each"] = [r["launches"] for r in rs]
        out[name] = first
    return out


# the counters every process layout shares (the rest split the same traffic
# by process)
SHARED_COUNTS = ("exchanges", "pieces", "bytes", "psums", "gathers", "gather_bytes")


def _shared(counts: dict) -> dict:
    return {n: {k: c[k] for k in SHARED_COUNTS} for n, c in counts.items()}


def compare(one: dict, multi: dict) -> dict:
    """{name: [differences]} between a one-process run and a merged
    multi-process run (empty lists: bit for bit)."""
    report = {}
    for name, a in one.items():
        b = multi[name]
        diffs = []
        differ = sorted(k for k in a["blocks"] if a["blocks"][k] != b["blocks"].get(k))
        if differ or a["blocks"] != b["blocks"]:
            diffs.append(f"blocks {differ}")
        for key in ("errs", "sweeps", "mesh"):
            if a[key] != b[key]:
                diffs.append(f"{key}: {a[key]} != {b[key]}")
        if _shared(a["counts"]) != _shared(b["counts"]):
            diffs.append(f"counts: {a['counts']} != {b['counts']}")
        report[name] = diffs
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--twins", action="store_true")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args()
    import torch

    from multigrid_poisson_solver_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    print("[launcher] 1 process x 4 entries (one-process 2x2 mesh)...", flush=True)
    one = run_programs(CPU_SPECS, [a.device] * 4, a.twins)
    print("[launcher] 2 processes x 2 entries (processes on the row axis)...", flush=True)
    multi = merge(multihost.spawn(worker, 2, (CPU_SPECS, 2, a.device, a.twins),
                                  timeout=a.timeout, threads=1))
    report = compare(one, multi)
    print(json.dumps({name: {"bit_identical": not d, "errs": multi[name]["errs"],
                             "sweeps": multi[name]["sweeps"], "differences": d}
                      for name, d in report.items()}), flush=True)
    if any(report.values()):
        raise SystemExit("[launcher] the multi-process run differs from the one-process run")
    print("[launcher] MULTI-PROCESS RUN BIT-MATCHES SINGLE-PROCESS", flush=True)


if __name__ == "__main__":
    main()
