"""Run the port's sharded cycles with one process per card under NCCL and
hold them bit for bit to one process driving the same cards.

    python3 examples/torch_multiproc_check.py [--cards 4] [--small]

One process over the cards (``make_mesh(["cuda:0", ..., "cuda:3"])``, each
shard launched with its card current), then ``--cards`` processes joined by
NCCL, process r on ``cuda:r`` with one mesh entry (``multihost``'s meshes:
processes on the row axis, and a z ring over every process). The programs:

  * the bench's V(3,3) at 4097² (coarsen=3, ω 0.8) under ``block_policy`` on
    the cards × 1 mesh (1 cold + 3 warm cycles);
  * a trigger V-cycle at 2049² on a row ring of the cards;
  * ``compile_program3`` V(3,3) at 513³ (clean metric, 2 cycles) and
    ``v_cycle3_sharded`` at 513³ on a z ring of the cards.

Every owned block (SHA-256), error and stop sweep must agree, every process
must launch the shard-mode kernels, and the sharded layer's counters must
equal ``utils.scaling_model``'s prediction. Prints ms/cycle (CUDA events)
of both runs and the layer's host overheads under NCCL (one entry a
process), the per-message and per-collective figures of the model;
``--small`` runs 513², 257² and 65³ instead. Exits non-zero on any
difference.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch_multihost_cpu as runner  # noqa: E402

LAUNCHES = {"block2d": ("descend_shard", "ascend_shard"),
            "trigger2d": ("jacobi_shard", "residual_shard"),
            "compiled3": ("descend3_shard", "ascend3_shard"),
            "vcycle3": ("descend3_shard", "ascend3_shard")}


def specs(cards: int, small: bool) -> dict:
    n2, nt, n3 = (513, 257, 65) if small else (4097, 2049, 513)
    return {
        "block2d": {"kind": "block2d", "n": n2, "threshold": 32, "cycles": 4, "reps": 3,
                    "rows": cards, "program": {"n_min": 8, "steps": 3, "coarse_option": 0,
                                               "coarsen": 3}, "config": {"omega": 0.8}},
        "trigger2d": {"kind": "trigger2d", "n": nt, "threshold": 32, "cycles": 1, "reps": 1,
                      "program": {"n_min": 8, "steps": -1, "coarse_option": 0, "coarsen": 3},
                      "config": {"omega": 0.8, "max_trigger_sweeps": 2000}},
        "compiled3": {"kind": "compiled3", "n": n3, "threshold": 8, "cycles": 2, "reps": 2,
                      "program": {"n_min": 8, "steps": 3, "coarse_option": 0, "coarsen": 3},
                      "config": {"omega": 6.0 / 7.0, "compat_error": True}},
        "vcycle3": {"kind": "vcycle3", "n": n3, "threshold": 8, "cycles": 2, "reps": 2},
    }


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < a.cards:
        print(f"needs {a.cards} CUDA devices", file=sys.stderr)
        return 1
    import multigrid_poisson_solver_tpu_torch as tmg
    from multigrid_poisson_solver_tpu_torch.ops import build
    from multigrid_poisson_solver_tpu_torch.parallel import multihost
    from multigrid_poisson_solver_tpu_torch.utils import scaling_model as sm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    build.load()
    print(f"built the kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    sp = specs(a.cards, a.small)
    cards = [f"cuda:{i}" for i in range(a.cards)]
    t0 = time.perf_counter()
    one = runner.run_programs(sp, cards, time_it=True)
    one_over = runner.overheads(cards)
    print(f"one process over {a.cards} cards: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    each = multihost.spawn(runner.worker, a.cards, (sp, 1, "cuda:{rank}", False, False, True,
                                                    True), backend="nccl", timeout=a.timeout)
    print(f"{a.cards} NCCL processes: {time.perf_counter() - t0:.1f} s with their start",
          flush=True)
    multi = runner.merge(each)
    report = runner.compare(one, multi)
    ok = True
    for name, diffs in report.items():
        launched = [{k: v for k, v in w[name]["launches"].items() if v} for w in each]
        shard_modes = all(all(w.get(k, 0) > 0 for k in LAUNCHES[sp[name]["kind"]])
                          for w in launched)
        ok &= not diffs and shard_modes
        print(json.dumps({"program": name, "n": sp[name]["n"], "bit_identical": not diffs,
                          "differences": diffs, "errs": multi[name]["errs"],
                          "sweeps": multi[name]["sweeps"],
                          "ms_one_process": one[name]["ms"],
                          "ms_each_process": [w[name]["ms"] for w in each],
                          "wall_ms_one_process": one[name]["wall_ms"],
                          "wall_ms_each_process": [w[name]["wall_ms"] for w in each],
                          "launches_each_process": launched,
                          "shard_modes_launched": shard_modes}), flush=True)
    spec = sp["block2d"]
    model = sm.comm_report(tmg.v_cycle(spec["n"], **spec["program"]), a.cards,
                           spec["threshold"], 1, a.cards,
                           tmg.SolverConfig(collect_node_stats=False, **spec["config"]))
    counters_ok = model.counts() == multi["block2d"]["counts"]
    ok &= counters_ok
    w = each[0]["overheads"]
    print(json.dumps({"counters_equal_model": counters_ok,
                      "nccl_exchange_s": w["exchange_s"], "nccl_messages": w["messages"],
                      "nccl_psum_s": w["psum_s"],
                      "one_process_exchange_s": one_over["exchange_s"],
                      "one_process_pieces": one_over["pieces"]}), flush=True)
    print("MULTI-PROCESS RUN BIT-MATCHES SINGLE-PROCESS" if ok else "MISMATCH", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
